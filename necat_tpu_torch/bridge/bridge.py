"""Contig bridging with raw reads (the port's copy of
necat_tpu/bridge/bridge.py; the mappings run on a device the caller names).

Rebuild of fsa_ctg_bridge (src/fsa/contig_bridge.cpp + contig_link_store.cpp):
raw reads are mapped to contigs; a read whose placements exit one contig's
end and enter another's end supports a directed link between those oriented
contig ends; links are scored by support, and the best non-conflicting links
join contigs into chains, filling the junction with the bridging reads'
sequence (SaveBridgedContigs). Contig ends that overlap each other directly
(the ctg<->ctg channel) add links of their own.

bridge_contigs fills `stats` with the seconds of its parts (map: reads to
contigs and the identity cut; c2c: contigs to contigs; graph: links, graph
passes and path walk; junction: the junction fills), the contig-to-contig
candidates extended and the directed edges of the contig graph before and
after the support cut.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np

from necat_tpu_torch.consensus.linkdp import consensus_linkdp, host_edit_ops, tags_from_ops
from necat_tpu_torch.io import seqio
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import (extend_candidates, find_all_candidates,
                                                map_reads_to_reference)
from necat_tpu_torch.utils.args import apply_named, parse_named

# the last bridge_contigs call's parts: map_s, c2c_s, graph_s, junction_s,
# c2c_pairs, links and links_kept (directed edges before and after drop_weak)
stats: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class BridgeOptions:
    end_window: int = 1000      # how close to a contig end a placement must reach
    min_support: int = 2        # reads required to accept a link
    min_ident: float = -1.0     # auto from the mapping identities when < 0
                                # (contig_bridge.cpp:197-290 AutoSelectParams)
    min_align_size: int = 2000
    # path-walk branching policy (IdentifyPaths method, contig_graph.cpp:255-
    # 450): "no" joins only strictly linear joints, "one" (reference default,
    # contig_bridge.hpp:55) additionally resolves at most one mutual-best
    # branch per chain, "best" follows every mutual-best edge
    select_branch: str = "one"
    # ctg<->ctg direct-overlap evidence (LoadC2cFile role,
    # contig_link_store.cpp:61-138): end-dovetail contig overlaps add links
    use_c2c: bool = True
    c2c_min_len: int = 2000
    c2c_support: int = 3        # support credited to a c2c link
    # junction gap fill: consensus over all supporting reads' gap sequences
    # (vs the reference's best single group)
    junction_consensus: bool = True

    @classmethod
    def from_string(cls, s: str,
                    base: "BridgeOptions | None" = None) -> "BridgeOptions":
        """Parse an FSA_CTG_BRIDGE_OPTIONS string (fsa_ctg_bridge
        ArgumentParser names, contig_bridge.cpp:14-30). Unsupported names
        warn loudly."""
        mapping = {
            "read2ctg_min_identity": ("min_ident", float),
            "read2ctg_min_aligned_length": ("min_align_size", int),
            "read2ctg_min_coverage": ("min_support", int),
            "ctg2ctg_min_aligned_length": ("c2c_min_len", int),
            "window_size": ("end_window", int),
            "select_branch": ("select_branch", str),
        }
        return apply_named(parse_named(s), mapping, base or cls(),
                           "fsa_ctg_bridge")


def _read_placements(m4: M4Records) -> Dict[int, List[int]]:
    by_read: Dict[int, List[int]] = defaultdict(list)
    for i in range(len(m4)):
        by_read[int(m4.qid[i])].append(i)
    return by_read


def find_links(m4: M4Records, contig_lengths: np.ndarray, opts: BridgeOptions):
    """Collect (A, dA, B, dB) link evidence from read placements.

    Every ordered pair of a read's placements is considered, not only
    consecutive ones (the reference links every contig pair sharing a read,
    contig_link_store.cpp:75-90): a read spanning A, n, B supports A->n,
    n->B and the direct A->B, the shared-read evidence RemoveCoveredEdges
    keys on. Orientation d is the strand of the contig along the read's
    forward axis. Returns dict link -> list of (read, read_gap_start,
    read_gap_end)."""
    qoff_f, qend_f = m4.fwd_query_range()
    links: Dict[Tuple[int, int, int, int], List[Tuple[int, int, int]]] = defaultdict(list)
    for rid, idxs in _read_placements(m4).items():
        if len(idxs) < 2:
            continue
        order = sorted(idxs, key=lambda i: qoff_f[i])
        for ai in range(len(order) - 1):
            for bi in range(ai + 1, len(order)):
                a, b = order[ai], order[bi]
                A, B = int(m4.sid[a]), int(m4.sid[b])
                if A == B:
                    continue
                dA, dB = int(m4.qdir[a]), int(m4.qdir[b])
                w = opts.end_window
                # read exits A to the right: A tail (fwd) or A head (rev)
                exit_ok = (contig_lengths[A] - m4.send[a] <= w) if dA == 0 else (m4.soff[a] <= w)
                entry_ok = (m4.soff[b] <= w) if dB == 0 else (contig_lengths[B] - m4.send[b] <= w)
                if not (exit_ok and entry_ok):
                    continue
                gap_s, gap_e = int(qend_f[a]), int(qoff_f[b])
                links[(A, dA, B, dB)].append((rid, gap_s, gap_e))
    return links


def _junction_seq(reads: ReadStore, ev: list, opts: BridgeOptions):
    """Junction filler for one accepted link: int -> trim the next contig by
    that many bases (overlapping junction / c2c evidence); ndarray -> insert
    this gap sequence. With junction_consensus, the gap is the link-DP
    consensus over all supporting reads' gap segments (a single raw-read
    junction caps polished identity) instead of the reference's best single
    group (contig_link.cpp Best())."""
    ev_sorted = sorted(ev, key=lambda t: t[0][2] - t[0][1])
    (rid, gs, ge), flipped = ev_sorted[len(ev_sorted) // 2]
    if ge <= gs:
        return int(gs - ge)
    segs = []
    if opts.junction_consensus:
        for (r, s, e), fl in ev_sorted:
            if e - s < max(1, (ge - gs) // 3) or r < 0:
                continue
            g = reads.get(r)[s:e]
            if fl:
                g = seqio.revcomp(g)
            segs.append((g, 1.0))
    if len(segs) >= 3:
        segs.sort(key=lambda s: len(s[0]))
        backbone = segs[len(segs) // 2][0]
        if len(backbone) <= 60000:
            all_tags = []
            for (sg, w) in segs:
                ops, q_start, _ = host_edit_ops(sg, backbone)
                tg = tags_from_ops(ops, len(ops), sg, qoff=q_start, toff=0,
                                   weight=w, max_delta=65535)
                if tg:
                    all_tags.extend(tg)
            S, _, _ = consensus_linkdp(all_tags, len(backbone))
            if len(S) >= (ge - gs) // 2:
                return S
    gap = reads.get(rid)[gs:ge]
    return seqio.revcomp(gap) if flipped else gap


def _add_c2c_links(links, contigs: ReadStore, map_opts: MapOptions,
                   opts: BridgeOptions, device) -> None:
    """ctg<->ctg end-dovetail overlaps as link evidence (the jobCtg2ctg
    channel, necat.pl:1267-1293 + contig_link_store.cpp:61-138 LoadC2cFile):
    two contigs whose ends overlap directly support a join with a negative
    gap (the next contig is trimmed by the consumed prefix). The search and
    the extension (band 256, its rescue ladder) run on `device`."""
    if contigs.n_reads < 2:
        return
    cands = find_all_candidates(contigs, contigs, map_opts, pairwise=True, device=device)
    stats["c2c_pairs"] += len(cands)
    if len(cands) == 0:
        return
    c2c = extend_candidates(cands, contigs, contigs, device=device,
                            min_align_size=opts.c2c_min_len,
                            min_ident=80.0, band_width=256)
    w = opts.end_window
    for i in range(len(c2c)):
        A, B = int(c2c.qid[i]), int(c2c.sid[i])
        if A == B:
            continue
        dA = int(c2c.qdir[i])
        qo, qe = int(c2c.qoff[i]), int(c2c.qend[i])
        so, se = int(c2c.soff[i]), int(c2c.send[i])
        qs, ss = int(c2c.qsize[i]), int(c2c.ssize[i])
        if qs - qe <= w and so <= w:
            # A(dA) suffix overlaps B prefix: A(dA) -> B(fwd), trim B to se
            links[(A, dA, B, 0)].extend([(-1, se, 0)] * opts.c2c_support)
        elif qo <= w and ss - se <= w:
            # B suffix overlaps A(dA) prefix: B(fwd) -> A(dA), trim A to qe
            links[(B, 0, A, dA)].extend([(-1, qe, 0)] * opts.c2c_support)


class _CEdge:
    """Directed edge between oriented contigs (ContigEdge,
    contig_graph.hpp:40-90). A covered edge expands into its two sub-edges at
    emission time (GetSeqArea covered_ recursion), so the skipped middle
    contig still appears in the chain."""

    __slots__ = ("u", "v", "ev", "removed", "covered")

    def __init__(self, u, v):
        self.u = u
        self.v = v
        self.ev: List = []
        self.removed = False
        self.covered = None          # (edge_a, edge_b) when a macro-edge

    @property
    def support(self) -> int:
        return len(self.ev)

    def med_gap(self) -> int:
        gaps = sorted(e[2] - e[1] for (e, _) in self.ev)
        return gaps[len(gaps) // 2] if gaps else 0

    def reads(self) -> set:
        return {e[0] for (e, _) in self.ev}


class ContigGraph:
    """Oriented-contig-end graph (ContigGraph, contig_graph.cpp:39-473):
    nodes are (contig, dir); every link adds the edge and its reverse
    complement; passes: covered-edge removal, mutual-best path identification
    (CalucateBest + IdentifyPaths)."""

    def __init__(self, opts: BridgeOptions):
        self.opts = opts
        self.edges: Dict[Tuple, _CEdge] = {}
        self.out_e: Dict[Tuple[int, int], List[_CEdge]] = defaultdict(list)
        self.in_e: Dict[Tuple[int, int], List[_CEdge]] = defaultdict(list)

    def _edge(self, u, v) -> _CEdge:
        e = self.edges.get((u, v))
        if e is None:
            e = _CEdge(u, v)
            self.edges[(u, v)] = e
            self.out_e[u].append(e)
            self.in_e[v].append(e)
        return e

    def add_link(self, key, ev) -> None:
        """ev: list of ((read, gap_s, gap_e), flipped)."""
        A, dA, B, dB = key
        self._edge((A, dA), (B, dB)).ev.extend(ev)
        rev = [((r, s, e), not fl) for ((r, s, e), fl) in ev]
        self._edge((B, 1 - dB), (A, 1 - dA)).ev.extend(rev)

    def drop_weak(self, min_support: int) -> None:
        for e in self.edges.values():
            if e.support < min_support:
                e.removed = True

    def _live_out(self, u):
        return [e for e in self.out_e[u] if not e.removed]

    def _live_in(self, v):
        return [e for e in self.in_e[v] if not e.removed]

    def remove_covered_edges(self) -> None:
        """RemoveCoveredEdges (contig_graph.cpp:135-204): for X -> n -> Y with
        a direct X -> Y whose gap matches the two-step gap (within 2 windows)
        and shares a supporting read with both steps, drop the two-step edges;
        the direct edge becomes a macro-edge emitting X, n, Y."""
        w = self.opts.end_window
        to_remove = []
        for n in list(self.out_e.keys()):
            for ea in self._live_in(n):
                for eb in self._live_out(n):
                    direct = self.edges.get((ea.u, eb.v))
                    if direct is None or direct.removed or direct in (ea, eb):
                        continue
                    glen = ea.med_gap() + eb.med_gap() - direct.med_gap()
                    if abs(glen) > 2 * w:
                        continue
                    dr = direct.reads()
                    if dr & ea.reads() and dr & eb.reads():
                        direct.covered = (ea, eb)
                        to_remove.extend((ea, eb))
        for e in to_remove:
            e.removed = True

    def identify_paths(self, method: str | None = None) -> List[List]:
        """Path walk (CalucateBest contig_graph.cpp:473-498 + IdentifyPaths/
        ExtendPath :255-450): from every unvisited node, extend forward then
        backward; a node and its reverse complement are visited together so
        each contig is emitted once. Methods (select_branch):
          no   — extend only through strictly linear joints (degree 1 on both
                 sides);
          one  — linear joints freely, plus at most one mutual-best branching
                 step per path (the reference default: one repeat boundary
                 may be resolved per chain);
          best — every mutual-best step.
        Returns paths as lists of (node, entry_edge|None)."""
        method = method or self.opts.select_branch

        def best(edges):
            if not edges:
                return None
            return max(edges, key=lambda e: (e.support, -abs(e.med_gap()),
                                             e.v, e.u))

        best_out = {u: best(self._live_out(u)) for u in self.out_e}
        best_in = {v: best(self._live_in(v)) for v in self.in_e}
        rev = lambda n: (n[0], 1 - n[1])
        visited = set()
        paths = []
        all_nodes = sorted(set(list(self.out_e) + list(self.in_e)))

        def step(cur, fwd, visited, count):
            e = best_out.get(cur) if fwd else best_in.get(cur)
            if e is None or e.removed:
                return None
            nxt = e.v if fwd else e.u
            mutual = (best_in.get(e.v) is e) and (best_out.get(e.u) is e)
            if not mutual or nxt in visited:
                return None
            linear = (len(self._live_out(e.u)) == 1
                      and len(self._live_in(e.v)) == 1)
            if linear:
                return e
            if method == "no":
                return None
            if method == "one":
                if count[0] == 0:
                    count[0] += 1
                    return e
                return None
            return e                     # "best"

        for n0 in all_nodes:
            if n0 in visited:
                continue
            visited.add(n0)
            visited.add(rev(n0))
            path = [(n0, None)]
            count = [0]                  # per-path branching allowance ("one")
            cur = n0
            while True:
                e = step(cur, True, visited, count)
                if e is None:
                    break
                path.append((e.v, e))
                visited.add(e.v)
                visited.add(rev(e.v))
                cur = e.v
            cur = n0
            while True:
                e = step(cur, False, visited, count)
                if e is None:
                    break
                path.insert(0, (e.u, None))
                path[1] = (path[1][0], e)
                visited.add(e.u)
                visited.add(rev(e.u))
                cur = e.u
            paths.append(path)
        return paths


def bridge_contigs(contigs: ReadStore, reads: ReadStore, map_opts: MapOptions | None = None,
                   opts: BridgeOptions = BridgeOptions(), m4: M4Records | None = None,
                   readinfos: dict | None = None, *, device="cuda") -> ReadStore:
    """Join contigs via read bridges; returns the bridged contig store. The
    reads are mapped to the contigs (band 256 and its rescue ladder), and
    the contigs to each other, on `device`.

    `readinfos` (optional) carries the assemble stage's per-read statistics
    (ol_filter's readinfos dump, overlap_filter.hpp:162-167): its
    min_identity upper-clamps the auto identity cutoff
    (contig_bridge.cpp:197-290)."""
    stats.clear()
    if contigs.n_reads <= 1:
        return contigs
    if map_opts is None:
        map_opts = MapOptions(scan_window=5, ncan=20, block_score_cutoff=2,
                              max_hits=1 << 20, max_pairs=8192)
    t0 = time.perf_counter()
    if m4 is None:
        m4 = map_reads_to_reference(reads, contigs, map_opts, device=device,
                                    min_align_size=opts.min_align_size,
                                    min_ident=max(opts.min_ident, 0.0), band_width=256)
    min_ident = opts.min_ident
    if min_ident < 0 and len(m4):
        # auto identity cutoff from this mapping's identity distribution
        # (AutoSelectRead2ctgMinIdentity, contig_bridge.cpp:197-290:
        # median - 3 * 1.4826 * MAD)
        mi = m4.ident.astype(np.float64)
        med = float(np.median(mi))
        mad = float(np.median(np.abs(mi - med)))
        min_ident = float(np.clip(med - 3.0 * 1.4826 * mad, 70.0, 100.0))
        if readinfos and readinfos.get("min_identity", 0) > 0:
            # the assemble stage's (corrected-read) cutoff only upper-clamps:
            # raw-read mapping identities run lower, and a high corrected
            # cutoff must not strip nearly all bridge evidence
            min_ident = min(min_ident,
                            max(70.0, float(readinfos["min_identity"]) - 10.0))
        m4 = m4.take(np.flatnonzero(m4.ident >= min_ident))
    t1 = time.perf_counter()
    stats["map_s"] += t1 - t0
    links = find_links(m4, contigs.lengths, opts)
    t2 = time.perf_counter()

    if opts.use_c2c:
        _add_c2c_links(links, contigs, map_opts, opts, device)
    t3 = time.perf_counter()
    stats["c2c_s"] += t3 - t2

    g = ContigGraph(opts)
    for key, ev in links.items():
        if key[0] == key[2]:
            continue
        g.add_link(key, [(e, False) for e in ev])
    stats["links"] += len(g.edges)
    g.drop_weak(opts.min_support)
    stats["links_kept"] += sum(not e.removed for e in g.edges.values())
    g.remove_covered_edges()
    paths = g.identify_paths()

    emitted: set[int] = set()
    out_seqs, out_names = [], []

    def expand(edge) -> List:
        """A covered macro-edge emits its two sub-edges (and the middle
        contig) in its place."""
        if edge.covered is None:
            return [edge]
        ea, eb = edge.covered
        return expand(ea) + expand(eb)

    # Every path is expanded first, so that the middle contigs of covered
    # macro-edges are known before any emission: a middle's own edges were
    # removed by remove_covered_edges, so it also forms a singleton path,
    # which must not be emitted beside the chain that holds it. Chains own
    # every contig they expand to; a path touching an already-emitted contig
    # is skipped whole (its leftovers fall through to the singleton sweep).
    path_joins: List[List] = []
    for path in paths:
        joins: List = []
        for (node, edge) in path[1:]:
            joins.extend(expand(edge))
        path_joins.append(joins)
    chain_contigs: set[int] = set()
    for path, joins in zip(paths, path_joins):
        if joins:
            chain_contigs.add(path[0][0][0])
            chain_contigs.update(e.v[0] for e in joins)

    junction_s = 0.0
    for path, joins in zip(paths, path_joins):
        cset = [path[0][0][0]] + [e.v[0] for e in joins]
        if any(c in emitted for c in cset):
            continue
        if not joins and cset[0] in chain_contigs:
            continue                 # a chain emits this contig in place
        parts = [contigs.get(path[0][0][0], rc=bool(path[0][0][1]))]
        for e in joins:
            B, dB = e.v
            nxt_seq = contigs.get(B, rc=bool(dB))
            tj = time.perf_counter()
            gap = _junction_seq(reads, e.ev, opts)
            junction_s += time.perf_counter() - tj
            if isinstance(gap, int):
                parts.append(nxt_seq[min(gap, len(nxt_seq)):])
            else:
                parts.append(gap)
                parts.append(nxt_seq)
        emitted.update(cset)
        out_seqs.append(np.concatenate(parts))
        out_names.append(f"bctg{len(out_seqs) - 1}")

    # remaining contigs (cycles the walk never started cleanly, singletons)
    for c in range(contigs.n_reads):
        if c not in emitted:
            emitted.add(c)
            out_seqs.append(contigs.get(c))
            out_names.append(f"bctg{len(out_seqs) - 1}")
    stats["junction_s"] += junction_s
    stats["graph_s"] += time.perf_counter() - t3 - junction_s + (t2 - t1)
    return ReadStore.from_seqs(out_seqs, out_names)
