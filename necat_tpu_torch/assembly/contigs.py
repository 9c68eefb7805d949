"""Contig construction from path-graph paths (the port's copy of
necat_tpu/assembly/contigs.py).

Rebuild of fsa Assembly (src/fsa/assembly.cpp): CreateStringGraph (:92-117) →
CreatePathGraph (:119-155) → SaveContigs (:168-347). Each identified path
becomes a contig; compound (bubble) edges contribute their best-scoring simple
chain to the primary sequence, and sufficiently dissimilar alternate branches
are emitted as bubble sequences (identity <= 96 or coverage < 97 on >=2 kb
branches, assembly.cpp:289-297, assembly.hpp:22-23). Also emits contig *tiles*
(read placements: contig_tiles), consumed by the polish stage's filter_m4.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from necat_tpu_torch.assembly.overlap_filter import FilterOptions, filter_overlaps
from necat_tpu_torch.assembly.path_graph import (PathGraph, best_chain_through,
                                           sequence_similarity)
from necat_tpu_torch.assembly.string_graph import Arc, StringGraph
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.m4 import M4Records

MIN_BUBBLE_BRANCH = 2000       # assembly.cpp:289: only branches >= 2 kb compared
MAX_BUBBLE_IDENTITY = 96.0     # assembly.hpp:22
MAX_BUBBLE_COVERAGE = 97.0     # assembly.hpp:23
# branches longer than this keep the best chain (the host O(nm) merge DP is
# quadratic; beyond read scale the branches are structural anyway)
CNS_BRANCH_MAX = 30000


@dataclasses.dataclass
class Tile:
    read: int
    orient: int     # 0 fwd / 1 rev
    ctg_start: int  # placement of the read's contributed segment on the contig
    ctg_end: int


@dataclasses.dataclass
class AssemblyResult:
    contigs: ReadStore
    tiles: List[List[Tile]]          # per contig
    bubbles: ReadStore               # alternate bubble branches (bubbles.fasta)
    bubble_tiles: List[List[Tile]]
    n_paths: int
    min_identity: float
    max_overhang: int
    # ol_filter's per-read statistics (readinfos/coverage dumps,
    # overlap_filter.hpp:162-167), consumed by the bridge stage's auto params
    read_ident: np.ndarray | None = None
    read_cov: np.ndarray | None = None


@dataclasses.dataclass
class LiteralPart:
    """A pre-computed contig segment (the consensus of similar compound-path
    branches) walked like an arc: trim_u applies to the PRECEDING parts, then
    seq is appended and the relative tiles are shifted into place."""
    seq: np.ndarray
    tiles_rel: List["Tile"]
    trim_u: int
    u: int           # entry vertex (path continuity bookkeeping)
    v: int


def path_to_contig(path: List, store: ReadStore,
                   circular: bool = False) -> Tuple[np.ndarray, List[Tile]]:
    """Concatenate the path's oriented reads into a contig sequence + tiles.
    `path` items are Arcs or LiteralParts (consensus-merged compound edges).

    At each join, the previous read's unaligned tail (arc.trim_u, the overhang
    that end-clamping forgave) is dropped before appending the next read's
    post-overlap segment, so junctions are exact.

    `circular` (path closes on its start node): the first node's WHOLE read is
    NOT prepended — the cycle's edge extension segments already sum to exactly
    the cycle length, so prepending would duplicate the first read's span
    (Assembly::ConstructContig start rule: the whole read is added only at
    InDegree()==0 linear starts, src/fsa/assembly.cpp:367-379)."""
    if circular:
        seq_parts: List[np.ndarray] = []
        tiles: List[Tile] = []
        pos = 0
    else:
        first = path[0].u
        rid, orient = first // 2, first % 2
        seq_parts = [store.get(rid, rc=bool(orient))]
        tiles = [Tile(rid, orient, 0, len(seq_parts[0]))]
        pos = len(seq_parts[0])
    for a in path:
        if a.trim_u > 0:
            drop = a.trim_u
            while drop > 0 and seq_parts:
                last = seq_parts[-1]
                if len(last) > drop:
                    seq_parts[-1] = last[:-drop]
                    drop = 0
                else:
                    drop -= len(last)
                    seq_parts.pop()
            pos -= a.trim_u - drop
        if isinstance(a, LiteralPart):
            seq_parts.append(a.seq)
            for t in a.tiles_rel:
                tiles.append(Tile(t.read, t.orient, pos + t.ctg_start,
                                  pos + t.ctg_end))
            pos += len(a.seq)
            continue
        rid, orient = a.v // 2, a.v % 2
        seg = store.get(rid, rc=bool(orient))[a.seg_start:a.seg_end]
        seq_parts.append(seg)
        tiles.append(Tile(rid, orient, pos, pos + len(seg)))
        pos += len(seg)
    return np.concatenate(seq_parts), tiles


def _branch_body(arcs: List[Arc], store: ReadStore):
    """Branch body with INTRA-branch trims applied (the first arc's trim_u is
    the caller's: it trims whatever precedes the branch). Returns
    (seq, relative tiles)."""
    parts: List[np.ndarray] = []
    tiles: List[Tile] = []
    pos = 0
    for i, a in enumerate(arcs):
        if i > 0 and a.trim_u > 0:
            drop = a.trim_u
            while drop > 0 and parts:
                last = parts[-1]
                if len(last) > drop:
                    parts[-1] = last[:-drop]
                    drop = 0
                else:
                    drop -= len(last)
                    parts.pop()
            pos -= a.trim_u - drop
        seg = store.get(a.v // 2, rc=bool(a.v % 2))[a.seg_start:a.seg_end]
        parts.append(seg)
        tiles.append(Tile(a.v // 2, a.v % 2, pos, pos + len(seg)))
        pos += len(seg)
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return seq, tiles


def merge_similar_branches(backbone: np.ndarray,
                           alts: List[np.ndarray],
                           splice_out: list | None = None) -> np.ndarray:
    """Consensus of similar compound-path branches (ConstructContig1 role,
    src/fsa/assembly.cpp:229-547): branch bodies that pass the similarity
    check vote out each other's sequencing errors instead of the contig
    inheriting the best chain's errors verbatim. Align every alt to the
    backbone, feed the alignment tags plus the backbone's own identity
    alignment into the reference link DP (cns_aux.c:127-217), splice the
    consensus over the covered range."""
    from necat_tpu_torch.consensus.linkdp import (consensus_linkdp, host_edit_ops,
                                            tags_from_ops)
    n = len(backbone)
    all_tags = list(tags_from_ops(np.zeros(n, np.uint8), n, backbone,
                                  qoff=0, toff=0, weight=1.0,
                                  max_delta=65535) or [])
    n_in = 1
    for alt in alts:
        ops, qs, qe = host_edit_ops(alt, backbone)
        if qe - qs < n // 2:
            continue
        tg = tags_from_ops(ops, len(ops), alt, qoff=qs, toff=0, weight=1.0,
                           max_delta=65535)
        if tg:
            all_tags.extend(tg)
            n_in += 1
    if n_in < 2:
        return backbone
    S, cf, ct = consensus_linkdp(all_tags, n)
    if len(S) < (ct - cf) // 2:
        return backbone
    if splice_out is not None:
        splice_out[:] = [cf, ct, len(S)]
    return np.concatenate([backbone[:cf], S, backbone[ct:]])


def _branch_seq(arcs: List[Arc], store: ReadStore) -> np.ndarray:
    """Sequence contributed by a bubble branch (appended segments only,
    Assembly::ConstructContigStraight role)."""
    parts = [store.get(a.v // 2, rc=bool(a.v % 2))[a.seg_start:a.seg_end]
             for a in arcs]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def trim_circular_overlap(seq: np.ndarray, k: int = 15, window: int = 50000,
                          min_votes: int = 40) -> np.ndarray:
    """Trim the terminal self-overlap of a circular contig.

    A contig walking a circular genome re-traverses its start: the tail
    duplicates the head. Detected by 15-mer anchor voting between the head and
    tail windows (offset histogram, 100 b bins); the dominant wrap offset is
    accepted when enough anchors agree, and the duplicated tail is cut.
    (The reference's string graph reaches the same result through its
    contained/duplicate path handling, fsa/path_graph.cpp.)"""
    n = len(seq)
    w = min(window, n // 3)
    if w < 2000:
        return seq
    head = seq[:w]
    tail = seq[n - w:]
    hk = {}
    hh = np.zeros(len(head) - k + 1, np.int64)
    for j in range(k):
        hh = (hh << 2) | head[j:j + len(hh)]
    for i in range(0, len(hh), 3):
        hk.setdefault(int(hh[i]), i)
    th = np.zeros(len(tail) - k + 1, np.int64)
    for j in range(k):
        th = (th << 2) | tail[j:j + len(th)]
    votes: dict = {}
    for i in range(0, len(th), 3):
        hpos = hk.get(int(th[i]))
        if hpos is not None:
            # wrap length = how much of the tail repeats the head:
            # tail pos (n - w + i) aligns head pos hpos
            wrap = n - (n - w + i) + hpos
            votes.setdefault(wrap // 100, []).append(wrap)
    if not votes:
        return seq
    best = max(votes, key=lambda b: len(votes[b]))
    wraps = sorted(votes.get(best - 1, []) + votes[best] + votes.get(best + 1, []))
    wrap = wraps[len(wraps) // 2]
    if len(wraps) < min_votes or wrap <= 0 or wrap >= n // 2:
        return seq
    return seq[:n - wrap]


@dataclasses.dataclass(frozen=True)
class AssembleOptions:
    """fsa_assemble's own knobs (assembly.cpp:60-73 AddNamedOption)."""
    min_contig_length: int = 500
    max_spur_length: int = 50000
    select_branch: str = "no"

    @classmethod
    def from_string(cls, s: str,
                    base: "AssembleOptions | None" = None) -> "AssembleOptions":
        """Parse an FSA_ASSEMBLE_OPTIONS string (fsa_assemble ArgumentParser
        names). Unsupported names warn loudly."""
        from necat_tpu_torch.utils.args import apply_named, parse_named
        mapping = {
            "min_contig_length": ("min_contig_length", int),
            "max_spur_length": ("max_spur_length", int),
            "select_branch": ("select_branch", str),
        }
        return apply_named(parse_named(s), mapping, base or cls(),
                           "fsa_assemble")


def assemble(
    store: ReadStore,
    m4: M4Records,
    filter_opts: FilterOptions = FilterOptions(),
    min_contig_length: int = 500,
    max_spur_length: int = 50000,
    select_branch: str = "no",
    dump_dir: str | None = None,
) -> AssemblyResult:
    """Overlap filter -> string graph -> path graph -> contigs
    (fsa_ol_filter + fsa_assemble). `dump_dir` writes inspection snapshots
    like the reference's `fsa_assemble --dump` path_graph_{0..3}.txt
    (assembly.cpp:126-146) and fsa_ol_filter's filtered-reads dump
    (overlap_filter.hpp:162-167)."""
    fres = filter_overlaps(m4, store.n_reads, filter_opts)
    if dump_dir:
        import os as _os

        _os.makedirs(dump_dir, exist_ok=True)
        with open(_os.path.join(dump_dir, "filtered_reads.txt"), "w") as f:
            for r in np.flatnonzero(fres.filtered_reads):
                f.write(f"{r}\n")
    g = StringGraph.from_overlaps(fres.m4, store.lengths, max_overhang=fres.max_overhang)

    def _dump_graph(tag):
        if not dump_dir:
            return
        import os as _os

        with open(_os.path.join(dump_dir, f"string_graph_{tag}.txt"), "w") as f:
            for (u, v), a in sorted(g.arcs.items()):
                f.write(f"{u}\t{v}\t{a.reduced or 'active'}\n")

    _dump_graph(0)
    g.mark_transitive_edges()
    _dump_graph(1)
    g.mark_spur_edges()
    g.mark_best_overlap()
    _dump_graph(2)
    g.mark_spur_edges()
    _dump_graph(3)
    pg = PathGraph.from_string_graph(g)
    paths = pg.run_passes(max_spur_length=max_spur_length,
                          select_branch=select_branch)

    built = []           # (seq, tiles, bubble list)
    for path in paths:
        arcs: List = []      # Arcs and LiteralParts (consensus-merged bubbles)
        bubbles: List[List[Arc]] = []
        for pe in path:
            if pe.kind == "simple":
                arcs.extend(pe.arcs)
                continue
            primary, alts = best_chain_through(pe.subedges, pe.u, pe.v)
            parcs = [a for se in primary for a in se.arcs]
            pseq = _branch_seq(parcs, store)
            sim_seqs: List[np.ndarray] = []
            for alt in alts:
                alt_arcs = [a for se in alt for a in se.arcs]
                aseq = _branch_seq(alt_arcs, store)
                if len(aseq) < MIN_BUBBLE_BRANCH or len(pseq) < MIN_BUBBLE_BRANCH:
                    continue
                cov, ident = sequence_similarity(aseq, pseq)
                if ident * 100 <= MAX_BUBBLE_IDENTITY or cov * 100 < MAX_BUBBLE_COVERAGE:
                    bubbles.append(alt_arcs)
                elif len(pseq) <= CNS_BRANCH_MAX and len(aseq) <= CNS_BRANCH_MAX:
                    # similar branches merge by consensus instead of the
                    # primary chain winning outright (ConstructContig1,
                    # assembly.cpp:229-547)
                    sim_seqs.append(aseq)
            if sim_seqs and parcs:
                body, rel_tiles = _branch_body(parcs, store)
                splice: list = []
                merged = merge_similar_branches(body, sim_seqs,
                                                splice_out=splice)
                if splice:
                    # the consensus splice replaced body[cf:ct) with a
                    # len(S) segment: shift tile coords past cf by the
                    # length delta and clip to the merged sequence
                    # (advisor r4, low)
                    cf, ct, sl = splice
                    delta = sl - (ct - cf)
                    rel_tiles = [
                        Tile(t.read, t.orient,
                             min(t.ctg_start + (delta if t.ctg_start >= cf
                                                else 0), len(merged)),
                             min(t.ctg_end + (delta if t.ctg_end > ct
                                              else 0), len(merged)))
                        for t in rel_tiles]
                arcs.append(LiteralPart(seq=merged, tiles_rel=rel_tiles,
                                        trim_u=parcs[0].trim_u,
                                        u=parcs[0].u, v=parcs[-1].v))
            else:
                arcs.extend(parcs)
        if not arcs:
            continue
        # circular path: the walk closed back on its start vertex
        # (path_graph.cpp:979 ctg_circular; assembly.cpp:240)
        circular = len(arcs) > 1 and arcs[-1].v == arcs[0].u
        seq, tiles = path_to_contig(arcs, store, circular=circular)
        built.append((seq, tiles, bubbles, circular))

    built.sort(key=lambda t: -len(t[0]))
    seqs, names, all_tiles = [], [], []
    bseqs, bnames, btiles = [], [], []
    for seq, tiles, bubbles, circular in built:
        if len(seq) < min_contig_length:
            continue
        if not circular:
            # fallback for cycles the graph walk did not close cleanly
            seq = trim_circular_overlap(seq)
        ci = len(seqs)
        names.append(f"ctg{ci}")
        seqs.append(seq)
        all_tiles.append(tiles)
        for bi, barcs in enumerate(bubbles):
            bseq = _branch_seq(barcs, store)
            bt = []
            pos = 0
            for a in barcs:
                bt.append(Tile(a.v // 2, a.v % 2, pos, pos + (a.seg_end - a.seg_start)))
                pos += a.seg_end - a.seg_start
            bnames.append(f"ctg{ci}-bubble{bi}")
            bseqs.append(bseq)
            btiles.append(bt)
    contigs = ReadStore.from_seqs(seqs, names)
    bub = ReadStore.from_seqs(bseqs, bnames)
    return AssemblyResult(contigs=contigs, tiles=all_tiles, bubbles=bub,
                          bubble_tiles=btiles, n_paths=len(paths),
                          min_identity=fres.min_identity,
                          max_overhang=fres.max_overhang,
                          read_ident=fres.read_ident, read_cov=fres.read_cov)
