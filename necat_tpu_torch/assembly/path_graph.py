"""Path graph over string-graph simple paths (host-side; the port's copy
of necat_tpu/assembly/path_graph.py).

Rebuild of fsa's PathGraph (src/fsa/path_graph.cpp): vertices are the string
graph's path endpoints, edges are maximal simple paths; passes are
  IdentifyPathSpur (path_graph.cpp:174-231, depth 10, max_spur_length default
  50000 assembly.hpp:35), RemoveDuplicateSimplePath (:235-281),
  ConstructCompoundPaths/FindBundle (:408-535,542-654: BFS bubble detection,
  tips<6, depth<=48, width<=16, length<=500000 path_graph.hpp:212),
  MarkRepeatBridge (:656-705, threshold 60000 path_graph.hpp:215), and
  IdentifyPaths with select_branch no|best (:707-870).

Contig emission follows Assembly::SaveContigs (assembly.cpp:168-288): a path's
compound edges contribute their best-scoring simple chain to the primary
contig; remaining bubble branches become alternate "bubble" sequences when
sufficiently dissimilar (identity <= 96 or coverage < 97, assembly.cpp:297,
assembly.hpp:22-23).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from necat_tpu_torch.assembly.string_graph import Arc, StringGraph, rev_vertex


@dataclasses.dataclass
class PathEdge:
    kind: str                 # "simple" | "compound"
    u: int                    # source vertex (oriented read)
    v: int                    # target vertex
    arcs: List[Arc]           # simple: the underlying string-graph chain
    subedges: List["PathEdge"]  # compound: bundled simple edges
    length: int               # appended bases when traversed
    score: int
    key: int                  # unique id; twin has key ^ 1
    reduced: Optional[str] = None

    @property
    def n_arcs(self) -> int:
        if self.kind == "simple":
            return len(self.arcs)
        return sum(e.n_arcs for e in self.subedges)


class PathGraph:
    def __init__(self, sg: StringGraph):
        self.sg = sg
        self.edges: Dict[int, PathEdge] = {}
        self.out_adj: Dict[int, List[PathEdge]] = {}
        self.in_adj: Dict[int, List[PathEdge]] = {}
        self._next_key = 0

    # ------------------------------------------------------------ construction
    def _twin_arcs(self, arcs: List[Arc]) -> Optional[List[Arc]]:
        out = []
        for a in reversed(arcs):
            t = self.sg.arcs.get((rev_vertex(a.v), rev_vertex(a.u)))
            if t is None:
                return None
            out.append(t)
        return out

    def _add_edge(self, e: PathEdge):
        self.edges[e.key] = e
        self.out_adj.setdefault(e.u, []).append(e)
        self.in_adj.setdefault(e.v, []).append(e)
        self.out_adj.setdefault(e.v, [])
        self.in_adj.setdefault(e.u, [])

    def add_simple_path(self, arcs: List[Arc]) -> None:
        """Register one simple path AND its reverse twin (PathGraph::AddEdge)."""
        twin = self._twin_arcs(arcs)
        if twin is None:
            twin = []  # tolerate asymmetric graphs; forward edge still usable
        length = sum(a.length for a in arcs)
        score = sum(a.score for a in arcs)
        k = self._next_key
        self._next_key += 2
        fwd = PathEdge("simple", arcs[0].u, arcs[-1].v, arcs, [], length, score, k)
        self._add_edge(fwd)
        if twin:
            rev = PathEdge("simple", twin[0].u, twin[-1].v, twin, [],
                           sum(a.length for a in twin), score, k ^ 1)
            self._add_edge(rev)

    @classmethod
    def from_string_graph(cls, sg: StringGraph) -> "PathGraph":
        g = cls(sg)
        seen: Set[int] = set()
        for path in sg.extract_simple_paths():
            ids = frozenset(id(a) for a in path)
            if ids & seen:
                continue
            seen |= ids
            twin = g._twin_arcs(path)
            if twin is not None:
                seen |= {id(a) for a in twin}
            g.add_simple_path(path)
        return g

    # --------------------------------------------------------------- utilities
    def twin(self, e: PathEdge) -> Optional[PathEdge]:
        return self.edges.get(e.key ^ 1)

    def active_out(self, v: int) -> List[PathEdge]:
        return [e for e in self.out_adj.get(v, []) if e.reduced is None]

    def active_in(self, v: int) -> List[PathEdge]:
        return [e for e in self.in_adj.get(v, []) if e.reduced is None]

    def reduce(self, e: PathEdge, reason: str, with_twin: bool = True):
        if e.reduced is None:
            e.reduced = reason
        if with_twin:
            t = self.twin(e)
            if t is not None and t.reduced is None:
                t.reduced = reason

    def nodes(self) -> List[int]:
        return list(self.out_adj.keys())

    # ---------------------------------------------------------------- ego/spur
    def _ego_nodes(self, start: int, depth: int, max_length: Optional[int] = None
                   ) -> List[int]:
        """BFS forward closure limited by depth (and path length), incl. start
        (PathGraph::GetEgoNodes)."""
        order = [start]
        dist = {start: 0}
        frontier = [start]
        for _ in range(depth):
            nxt = []
            for n in frontier:
                for e in self.active_out(n):
                    if e.v not in dist:
                        d = dist[n] + e.length
                        if max_length is not None and d > max_length:
                            continue
                        dist[e.v] = d
                        order.append(e.v)
                        nxt.append(e.v)
            if not nxt:
                break
            frontier = nxt
        return order

    def _shortest_path(self, src: int, dst: int, allowed: Set[int]
                       ) -> List[PathEdge]:
        """Fewest-hops path src->dst through `allowed` nodes (BFS)."""
        if src == dst:
            return []
        prev: Dict[int, PathEdge] = {}
        frontier = [src]
        seen = {src}
        while frontier:
            nxt = []
            for n in frontier:
                for e in self.active_out(n):
                    if e.v in seen or e.v not in allowed:
                        continue
                    prev[e.v] = e
                    if e.v == dst:
                        path = []
                        cur = dst
                        while cur != src:
                            path.append(prev[cur])
                            cur = prev[cur].u
                        return path[::-1]
                    seen.add(e.v)
                    nxt.append(e.v)
            frontier = nxt
        return []

    def identify_path_spur(self, depth: int = 10, max_spur_length: int = 50000):
        """Cut short branches that merge into externally-supported nodes
        (PathGraph::IdentifyPathSpur, path_graph.cpp:174-231)."""
        candidates = {n for n in self.nodes()
                      if not self.active_in(n) and self.active_out(n)}
        while candidates:
            n = next(iter(candidates))
            found = False
            ego = self._ego_nodes(n, depth, max_spur_length * 10)
            ego_set = set(ego)
            for b in ego:
                ins = self.active_in(b)
                if len(ins) <= 1:
                    continue
                if all(e.u in ego_set for e in ins):
                    continue
                sp = self._shortest_path(n, b, ego_set)
                if not sp:
                    continue
                length = sum(e.length for e in sp)
                vlen = sum((self.twin(e).length if self.twin(e) else e.length)
                           for e in sp)
                if length < max_spur_length or vlen < max_spur_length:
                    for e in sp:
                        self.reduce(e, "spur:2")
                    for e in sp:
                        if not self.active_in(e.v) and self.active_out(e.v):
                            candidates.add(e.v)
                    found = True
                    break
            if not found:
                candidates.discard(n)

    # ------------------------------------------------------------- duplicates
    def remove_duplicate_simple_path(self):
        """Keep one of multiple short (<3 arcs) parallel simple paths
        (PathGraph::RemoveDuplicateSimplePath, path_graph.cpp:235-281)."""
        groups: Dict[Tuple[int, int], List[PathEdge]] = {}
        for e in self.edges.values():
            if e.kind == "simple" and e.reduced is None and len(e.arcs) < 3:
                groups.setdefault((e.u, e.v), []).append(e)
        done: Set[int] = set()
        for (u, v), es in groups.items():
            if len(es) <= 1:
                continue
            es.sort(key=lambda e: e.key)
            if es[0].key in done:
                continue
            done.add(es[0].key)
            done.add(es[0].key ^ 1)
            for e in es[1:]:
                self.reduce(e, "simple_dup")

    # ---------------------------------------------------------------- bubbles
    def _find_bundle(self, start: int, depth_cutoff: int = 48,
                     width_cutoff: int = 16, length_cutoff: int = 500000
                     ) -> Optional[Tuple[int, List[PathEdge], int, int]]:
        """BFS bubble search from a branching node (PathGraph::FindBundle,
        path_graph.cpp:408-535). Returns (end_node, bundle_edges, length, score)."""
        local = set(self._ego_nodes(start, depth_cutoff))
        # visited: node -> (length, score) of best arrival
        visited: Dict[int, Tuple[int, int]] = {start: (0, 0)}
        tips: Set[int] = set()
        bundle: List[PathEdge] = []
        for e in self.active_out(start):
            if e.v not in local:
                return None
            tips.add(e.v)
            bundle.append(e)
        if len(tips) < 1:
            return None

        depth = 0
        width = 1.0
        length = 0
        end_node = None
        loop = err = spur = False

        while True:
            new_visited: Dict[int, PathEdge] = {}
            newtips: Set[int] = set()
            oldtips: Set[int] = set()
            for n in tips:
                best_in = None
                ok = True
                for e in self.active_in(n):
                    if e.u in local:
                        if e.u in visited:
                            if best_in is None or best_in.score < e.score:
                                best_in = e
                        else:
                            ok = False
                            break
                if not ok or best_in is None:
                    oldtips.add(n)
                    continue
                new_visited[n] = best_in
                if len(tips) > 1:
                    outs = self.active_out(n)
                    for e in outs:
                        if e.v in visited or e.v in new_visited:
                            loop = True
                            break
                        rv = rev_vertex(e.v)
                        if e.v in local and rv not in visited and rv not in new_visited:
                            if e.v not in tips:
                                newtips.add(e.v)
                            bundle.append(e)
                        else:
                            err = True
                            break
                    if loop or err:
                        break
                    if not outs:
                        spur = True
                        break
                else:
                    end_node = n
            if loop or err or spur:
                break
            for n, e in new_visited.items():
                pl, ps = visited[e.u]
                visited[n] = (pl + e.length, ps + e.score)
                length = max(length, pl + e.length)
            depth += 1
            width = len(bundle) / depth
            tips = newtips | oldtips
            if not (1 <= len(tips) < 6) or depth > depth_cutoff or \
                    length > length_cutoff or (depth > 10 and width > width_cutoff):
                break
            if end_node is not None and not tips:
                break
            if not new_visited and tips == oldtips:
                break  # no progress

        if end_node is not None and not (loop or err or spur) and \
                depth <= depth_cutoff and length <= length_cutoff and \
                (depth <= 10 or width <= width_cutoff):
            lv, sv = visited.get(end_node, (0, 0))
            return end_node, bundle, lv, sv
        return None

    def construct_compound_paths(self):
        """Find bubbles at every branching node, dedupe, install compound edges
        (PathGraph::ConstructCompoundPaths, path_graph.cpp:542-654)."""
        found = []
        for n in self.nodes():
            if len(self.active_out(n)) > 1:
                r = self._find_bundle(n)
                if r is not None:
                    found.append((n, *r))
        # prefer larger bundles (reference sorts by simple_paths_.size() desc)
        found.sort(key=lambda t: -len(t[2]))
        edge_used: Set[int] = set()
        for start, end, bundle, length, score in found:
            keys = {e.key for e in bundle}
            if keys & edge_used:
                continue
            twin_keys = {k ^ 1 for k in keys}
            if twin_keys & edge_used:
                continue
            twins = [self.twin(e) for e in bundle]
            if any(t is None for t in twins):
                continue  # mirror must exist (compound_path1->2 check)
            if any(e.reduced is not None for e in bundle):
                continue
            edge_used |= keys | twin_keys
            k = self._next_key
            self._next_key += 2
            fwd = PathEdge("compound", start, end, [], list(bundle),
                           length, score, k)
            rev = PathEdge("compound", rev_vertex(end), rev_vertex(start), [],
                           twins, length, score, k ^ 1)
            for e in bundle:
                self.reduce(e, "contained")
            self._add_edge(fwd)
            self._add_edge(rev)

    # ----------------------------------------------------------- repeat bridge
    def mark_repeat_bridge(self, length_threshold: int = 60000):
        """Cut short chains that enter at a branch fan-out and exit at a fan-in
        (PathGraph::MarkRepeatBridge, path_graph.cpp:656-705)."""
        removed: List[PathEdge] = []
        for e in list(self.edges.values()):
            if e.reduced is not None:
                continue
            if len(self.active_in(e.u)) == 1 and len(self.active_out(e.u)) >= 2:
                chain = [e]
                tot = e.length
                vtot = (self.twin(e).length if self.twin(e) else e.length)
                while tot < length_threshold or vtot < length_threshold:
                    last = chain[-1]
                    n_in = len(self.active_in(last.v))
                    outs = self.active_out(last.v)
                    if n_in >= 2 and len(outs) == 1:
                        removed.append(chain[0])
                        removed.append(chain[-1])
                        break
                    elif n_in == 1 and len(outs) == 1:
                        chain.append(outs[0])
                        tot += outs[0].length
                        t = self.twin(outs[0])
                        vtot += t.length if t else outs[0].length
                    else:
                        break
        for e in removed:
            if e.reduced is None:
                self.reduce(e, "repeat_bridge")

    # ------------------------------------------------------------------ paths
    def _best_out(self, v: int) -> Optional[PathEdge]:
        outs = self.active_out(v)
        return max(outs, key=lambda e: e.score) if outs else None

    def _best_in(self, v: int) -> Optional[PathEdge]:
        ins = self.active_in(v)
        return max(ins, key=lambda e: e.score) if ins else None

    def _extend(self, e: PathEdge, visited: Set[int], method: str
                ) -> List[PathEdge]:
        """ExtendPathWithMethod (path_graph.cpp:778-870)."""
        path = [e]
        visited.add(e.key)
        visited.add(e.key ^ 1)
        rnodes = {rev_vertex(e.u), rev_vertex(e.v)}

        def get_out(last: PathEdge) -> Optional[PathEdge]:
            outs = self.active_out(last.v)
            if method == "no":
                if len(outs) == 1 and len(self.active_in(last.v)) == 1 and \
                        outs[0].key not in visited:
                    return outs[0]
            else:  # best
                if len(outs) == 1 and self._best_in(last.v) is last and \
                        outs[0].key not in visited:
                    return outs[0]
            return None

        def get_in(first: PathEdge) -> Optional[PathEdge]:
            ins = self.active_in(first.u)
            if method == "no":
                if len(ins) == 1 and len(self.active_out(first.u)) == 1 and \
                        ins[0].key not in visited:
                    return ins[0]
            else:
                if len(ins) == 1 and self._best_out(first.u) is first and \
                        ins[0].key not in visited:
                    return ins[0]
            return None

        nxt = get_out(path[-1])
        while nxt is not None and nxt.v not in rnodes:
            path.append(nxt)
            visited.add(nxt.key)
            visited.add(nxt.key ^ 1)
            rnodes.add(rev_vertex(nxt.v))
            nxt = get_out(path[-1])
        prv = get_in(path[0])
        while prv is not None and prv.u not in rnodes:
            path.insert(0, prv)
            visited.add(prv.key)
            visited.add(prv.key ^ 1)
            rnodes.add(rev_vertex(prv.u))
            prv = get_in(path[0])
        return path

    def identify_paths(self, method: str = "no") -> List[List[PathEdge]]:
        """Extract one path per twin pair (PathGraph::IdentifyPaths)."""
        visited: Set[int] = set()
        paths = []
        for e in sorted(self.edges.values(), key=lambda e: -e.length):
            if e.reduced is not None or e.key in visited:
                continue
            paths.append(self._extend(e, visited, method))
        return paths

    # -------------------------------------------------------------- all passes
    def run_passes(self, max_spur_length: int = 50000,
                   select_branch: str = "no") -> List[List[PathEdge]]:
        """CreatePathGraph pass order (assembly.cpp:119-155)."""
        self.identify_path_spur(10, max_spur_length)
        self.remove_duplicate_simple_path()
        self.construct_compound_paths()
        self.mark_repeat_bridge()
        self.identify_path_spur(10, max_spur_length)
        return self.identify_paths(select_branch)


# ------------------------------------------------------------------- bubbles
def best_chain_through(bundle: List[PathEdge], u: int, v: int
                       ) -> Tuple[List[PathEdge], List[List[PathEdge]]]:
    """Best-scoring simple-edge chain u->v inside a bundle, plus the remaining
    alternate chains (Assembly::SaveContigs compound handling,
    assembly.cpp:183-216: weighted shortest path, then peel paths until the
    edge set is exhausted)."""
    avail: Set[int] = {e.key for e in bundle}
    by_key = {e.key: e for e in bundle}

    def best_path() -> List[PathEdge]:
        # Dijkstra-style max-score path over remaining edges
        best: Dict[int, Tuple[int, List[PathEdge]]] = {u: (0, [])}
        frontier = [u]
        while frontier:
            nxt = []
            for n in frontier:
                sc, pth = best[n]
                for k in list(avail):
                    e = by_key[k]
                    if e.u != n:
                        continue
                    cand = (sc + e.score, pth + [e])
                    if e.v not in best or best[e.v][0] < cand[0]:
                        best[e.v] = cand
                        if e.v != v:
                            nxt.append(e.v)
            frontier = nxt
        return best.get(v, (0, []))[1]

    primary = best_path()
    alts = []
    for e in primary:
        avail.discard(e.key)
    while True:
        p = best_path()
        if not p:
            break
        alts.append(p)
        for e in p:
            avail.discard(e.key)
    return primary, alts


def sequence_similarity(a: np.ndarray, b: np.ndarray, band_frac: float = 0.2
                        ) -> Tuple[float, float]:
    """(coverage, identity) of two base arrays via banded global edit distance
    (Assembly::ComputeSequenceSimilarity / simple_align.cpp role).

    Band coordinates: column d = j - i + W for row i (over `a`), so the
    diagonal move stays at the same column, deletion (consume a only) comes
    from column d+1 of the previous row, insertion (consume b only) from
    column d-1 of the current row."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0, 0.0
    cov = min(la, lb) / max(la, lb)
    if max(la, lb) > 100_000:
        # banded DP would be quadratic-ish here; estimate identity from shared
        # k-mer fraction instead (bubble classification only needs a coarse
        # call). Packed-int k-mers, NOT hash(): str hash is salted per process
        # (PYTHONHASHSEED) and would make multi-process runs non-deterministic.
        k = 16

        def kmers(s):
            v = np.lib.stride_tricks.sliding_window_view(
                s.astype(np.int64), k)[::4]
            return set((v * (4 ** np.arange(k, dtype=np.int64))).sum(1).tolist())

        ka = kmers(a)
        kb = kmers(b)
        if not ka or not kb:
            return cov, 0.0
        jac = len(ka & kb) / max(len(ka), len(kb))
        # invert the expected k-mer survival rate (1-e)^k ~= jac
        ident = jac ** (1.0 / k)
        return cov, ident
    W = max(abs(la - lb) + 16, int(max(la, lb) * band_frac))
    INF = 1 << 30
    prev = np.full(2 * W + 2, INF, np.int64)  # one slack slot at the end
    prev[W:W + min(W, lb) + 1] = np.arange(min(W, lb) + 1)
    ramp = np.arange(2 * W + 2, dtype=np.int64)
    for i in range(1, la + 1):
        cur = np.full(2 * W + 2, INF, np.int64)
        if i <= W:
            cur[W - i] = i  # column j=0: delete the whole a[:i] prefix
        lo = max(1, i - W)
        hi = min(lb, i + W)
        if lo > hi:
            break
        js = np.arange(lo, hi + 1)
        idx = js - i + W
        diag = prev[idx] + (a[i - 1] != b[js - 1])
        up = prev[idx + 1] + 1
        vals = np.minimum(diag, up)
        # insertion move = min-plus prefix scan: cur[t] = min_{s<=t}(vals[s]+(t-s))
        boundary = cur[idx[0] - 1] if idx[0] >= 1 else INF
        seed = np.minimum(vals - ramp[: len(vals)], boundary - (-1))
        runmin = np.minimum.accumulate(seed)
        cur[idx] = runmin + ramp[: len(vals)]
        prev = cur
    d = int(prev[lb - la + W]) if 0 <= lb - la + W <= 2 * W else max(la, lb)
    ident = 1.0 - d / max(la, lb)
    return cov, max(ident, 0.0)
