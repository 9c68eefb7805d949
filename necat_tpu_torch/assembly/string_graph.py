"""String graph assembly core (host-side; the port's copy of
necat_tpu/assembly/string_graph.py).

Rebuild of fsa's StringGraph (src/fsa/string_graph.cpp): vertices are oriented
reads (miniasm-style, equivalent to the B/E end-node formulation), arcs mean
"suffix of u dovetails prefix of v"; every arc has a reverse twin
rev(v) -> rev(u). Passes: Myers transitive reduction with FUZZ=500
(string_graph.cpp:233-303), spur removal (:305), best-overlap selection
(:480-511), simple-path extraction (:564). Bubble-aware path selection of the
reference's PathGraph is approximated by best-overlap pruning; compound-path
consensus is future work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from necat_tpu_torch.overlap.m4 import M4Records

FUZZ = 500  # string_graph.cpp:235


def vertex(read: int, orient: int) -> int:
    return 2 * read + orient


def rev_vertex(v: int) -> int:
    return v ^ 1


@dataclasses.dataclass
class Arc:
    u: int          # source vertex (oriented read)
    v: int          # target vertex
    length: int     # bases appended when traversing (prefix of v before overlap end)
    score: int      # aligned length (bigger = better)
    identity: float
    # appended segment on v's oriented coords: v_seq[seg_start:seg_end]
    seg_start: int
    seg_end: int
    # unaligned tail of u (past the true alignment end) to drop at the join —
    # the overhang that ModifyEnd clamped; without this every join would
    # duplicate those bases
    trim_u: int = 0
    reduced: Optional[str] = None  # None=active, else reason


class StringGraph:
    def __init__(self, read_lengths: np.ndarray):
        self.read_lengths = read_lengths
        self.arcs: Dict[Tuple[int, int], Arc] = {}
        self.out_adj: Dict[int, List[Arc]] = {}
        self.in_adj: Dict[int, List[Arc]] = {}

    # ------------------------------------------------------------ construction
    def add_arc(self, u, v, length, score, identity, seg_start, seg_end, trim_u=0):
        if (u, v) in self.arcs:
            return
        a = Arc(u, v, length, score, identity, seg_start, seg_end, trim_u)
        self.arcs[(u, v)] = a
        self.out_adj.setdefault(u, []).append(a)
        self.in_adj.setdefault(v, []).append(a)
        self.out_adj.setdefault(v, [])
        self.in_adj.setdefault(u, [])

    @classmethod
    def from_overlaps(cls, m4: M4Records, read_lengths: np.ndarray,
                      max_overhang: int = 1000) -> "StringGraph":
        """Build from filtered overlaps with ORIGINAL (unclamped) coordinates.

        Overlap frame: A = read qid on strand qdir, B = read sid forward.
        Dovetail case 1 (A suffix -> B prefix): arc A->B and rev(B)->rev(A).
        Dovetail case 2 (B suffix -> A prefix): arc B->A and rev(A)->rev(B).
        (string_graph.cpp:92-152 AddOverlap, in oriented-read form.)
        Hangs <= max_overhang count as reaching the end (ModifyEnd) but the true
        alignment ends are kept so joins drop the unaligned tails exactly.
        """
        g = cls(read_lengths)
        alen = np.maximum(m4.qend - m4.qoff, m4.send - m4.soff)
        for i in range(len(m4)):
            qid, sid = int(m4.qid[i]), int(m4.sid[i])
            if qid == sid:
                continue
            qd = int(m4.qdir[i])
            qoff, qend, qsize = int(m4.qoff[i]), int(m4.qend[i]), int(m4.qsize[i])
            soff, send, ssize = int(m4.soff[i]), int(m4.send[i]), int(m4.ssize[i])
            a_l0 = qoff <= max_overhang          # A left end reached
            a_r0 = qsize - qend <= max_overhang  # A right end reached
            b_l0 = soff <= max_overhang
            b_r0 = ssize - send <= max_overhang
            A = vertex(qid, qd)
            B = vertex(sid, 0)
            sc = int(alen[i])
            ident = float(m4.ident[i])
            if (a_l0 and a_r0) or (b_l0 and b_r0):
                continue  # containment
            if not a_l0 and a_r0 and b_l0 and not b_r0:
                # A suffix overlaps B prefix: contig ...A[:qend] + B[send:]
                g.add_arc(A, B, ssize - send, sc, ident, send, ssize,
                          trim_u=qsize - qend)
                g.add_arc(rev_vertex(B), rev_vertex(A), qoff, sc, ident,
                          qsize - qoff, qsize, trim_u=soff)
            elif not b_l0 and b_r0 and a_l0 and not a_r0:
                # B suffix overlaps A prefix: contig ...B[:send] + A[qend:]
                g.add_arc(B, A, qsize - qend, sc, ident, qend, qsize,
                          trim_u=ssize - send)
                g.add_arc(rev_vertex(A), rev_vertex(B), soff, sc, ident,
                          ssize - soff, ssize, trim_u=qoff)
            # improper overlaps are skipped (filtered upstream)
        return g

    # --------------------------------------------------------------- utilities
    def active_out(self, v) -> List[Arc]:
        return [a for a in self.out_adj.get(v, []) if a.reduced is None]

    def active_in(self, v) -> List[Arc]:
        return [a for a in self.in_adj.get(v, []) if a.reduced is None]

    def reduce_arc(self, a: Arc, reason: str, with_reverse: bool = True):
        if a.reduced is None:
            a.reduced = reason
        if with_reverse:
            r = self.arcs.get((rev_vertex(a.v), rev_vertex(a.u)))
            if r is not None and r.reduced is None:
                r.reduced = reason

    def n_active(self) -> int:
        return sum(1 for a in self.arcs.values() if a.reduced is None)

    # ------------------------------------------------------- transitive reduce
    def mark_transitive_edges(self):
        """Myers 2005 linear-expected transitive reduction (string_graph.cpp:233-303)."""
        mark: Dict[int, str] = {}
        for v in self.out_adj:
            mark[v] = "V"
        for v in list(self.out_adj.keys()):
            out_edges = self.active_out(v)
            if not out_edges:
                continue
            out_edges.sort(key=lambda a: a.length)
            for e in out_edges:
                mark[e.v] = "I"
            max_len = out_edges[-1].length + FUZZ
            for e in out_edges:
                w = e.v
                if mark.get(w) == "I":
                    w_out = sorted(self.active_out(w), key=lambda a: a.length)
                    for e2 in w_out:
                        if e2.length + e.length < max_len and mark.get(e2.v) == "I":
                            mark[e2.v] = "E"
            for e in out_edges:
                w_out = sorted(self.active_out(e.v), key=lambda a: a.length)
                if w_out and mark.get(w_out[0].v) == "I":
                    mark[w_out[0].v] = "E"
                for e2 in w_out:
                    if e2.length < FUZZ and mark.get(e2.v) == "I":
                        mark[e2.v] = "E"
            for e in out_edges:
                if mark.get(e.v) == "E":
                    self.reduce_arc(e, "transitive")
                mark[e.v] = "V"

    # -------------------------------------------------------------------- spur
    def mark_spur_edges(self, max_spur_nodes: int = 5):
        """Remove short dead-end branches hanging off branching nodes."""
        changed = True
        while changed:
            changed = False
            for v in list(self.out_adj.keys()):
                outs = self.active_out(v)
                if len(outs) <= 1:
                    continue
                for e in outs:
                    # walk forward from e.v; if it dead-ends quickly and nothing
                    # else enters the branch, cut it
                    path = [e]
                    cur = e.v
                    dead = False
                    for _ in range(max_spur_nodes):
                        nxt = self.active_out(cur)
                        ins = self.active_in(cur)
                        if len(ins) > 1:
                            break
                        if not nxt:
                            dead = True
                            break
                        if len(nxt) > 1:
                            break
                        path.append(nxt[0])
                        cur = nxt[0].v
                    if dead and len(self.active_out(v)) > 1:
                        for a in path:
                            self.reduce_arc(a, "spur")
                        changed = True

    # ------------------------------------------------------------ best overlap
    def mark_best_overlap(self):
        """Keep the union of per-vertex best in/out arcs (string_graph.cpp:480-511)."""
        best = set()
        for v in self.out_adj:
            outs = self.active_out(v)
            if outs:
                best.add(id(max(outs, key=lambda a: a.score)))
            ins = self.active_in(v)
            if ins:
                best.add(id(max(ins, key=lambda a: a.score)))
        for a in self.arcs.values():
            if a.reduced is None and id(a) not in best:
                self.reduce_arc(a, "no_best")

    # ------------------------------------------------------------ simple paths
    def extract_simple_paths(self) -> List[List[Arc]]:
        """Maximal unbranched arc chains (string_graph.cpp:564 IdentifySimplePaths)."""
        visited = set()
        paths = []
        for key, e in self.arcs.items():
            if e.reduced is not None or id(e) in visited:
                continue
            path = [e]
            visited.add(id(e))
            # extend forward
            cur = e.v
            while True:
                outs = self.active_out(cur)
                ins = self.active_in(cur)
                if len(outs) != 1 or len(ins) != 1:
                    break
                nxt = outs[0]
                if id(nxt) in visited:
                    break
                path.append(nxt)
                visited.add(id(nxt))
                cur = nxt.v
            # extend backward
            cur = e.u
            while True:
                ins = self.active_in(cur)
                outs = self.active_out(cur)
                if len(ins) != 1 or len(outs) != 1:
                    break
                prv = ins[0]
                if id(prv) in visited:
                    break
                path.insert(0, prv)
                visited.add(id(prv))
                cur = prv.u
            # mark the reverse-twin path visited so we emit only one strand
            for a in path:
                r = self.arcs.get((rev_vertex(a.v), rev_vertex(a.u)))
                if r is not None:
                    visited.add(id(r))
            paths.append(path)
        return paths

    def assemble(self, max_spur_nodes: int = 5) -> List[List[Arc]]:
        self.mark_transitive_edges()
        self.mark_spur_edges(max_spur_nodes)
        self.mark_best_overlap()
        self.mark_spur_edges(max_spur_nodes)
        return self.extract_simple_paths()
