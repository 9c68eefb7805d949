"""Reference-faithful FALCON-sense link DP on the host (the port's copy of
necat_tpu/consensus/linkdp.py).

A direct Python port of the reference's alignment-tag DAG consensus:
  * tag generation     — get_cns_tags (src/tasc/align_tags.c:23-71): one tag
    per alignment column carrying (t_pos, delta, q_base) AND the previous
    column's (p_t_pos, p_delta, p_q_base);
  * backbone build     — build_backbone/build_base_links (src/tasc/
    cns_aux.c:21-126): tags grouped per (t_pos, delta, base) node, predecessor
    links grouped per distinct (p_t_pos, p_delta, p_base) with summed weights;
  * link DP + backtrack — consensus_backbone_segment (cns_aux.c:127-217):
    node score = max over links of (link_weight - 0.2*coverage[t] +
    predecessor score), global best node, walk best_p pointers, emit non-gap
    bases in reverse.

The port uses it where the JAX package does: the polish stage's hotspot
repair (consensus/correct.py _bucket_hot_overrides) and the merge of similar
bubble branches (assembly/contigs.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

GAP = 4  # gap code (reference uses '-')


def tags_from_ops(ops: np.ndarray, n_ops: int, qbases: np.ndarray,
                  qoff: int, toff: int, weight: float, max_delta: int = 255):
    """get_cns_tags equivalent over our op encoding (0=DIAG 1=DEL 2=INS).

    qbases: query codes on the alignment strand; qoff = first consumed query
    index; toff = template position of the first column - the alignment must
    start with a template-consuming op (anchor convention).
    Returns list of tag tuples (t, d, b, pt, pd, pb, w), or None when any
    insertion run reaches max_delta (the reference drops the whole alignment,
    align_tags.c:40-44 — u8 in correction, u16 in ctg polish).
    """
    from necat_tpu_torch.align.banded_kernels import OP_DEL, OP_INS
    tags = []
    jj = 0
    j = toff - 1
    p_j, p_jj, p_b = -1, 0, GAP
    q = qoff
    for i in range(n_ops):
        op = int(ops[i])
        if op != OP_DEL:
            b = int(qbases[q])
            q += 1
            jj += 1
        else:
            b = GAP
        if op != OP_INS:
            j += 1
            jj = 0
        if jj >= max_delta or p_jj >= max_delta:
            return None
        tags.append((j, jj, b, p_j, p_jj, p_b, weight))
        p_j, p_jj, p_b = j, jj, b
    return tags


def host_edit_ops(q: np.ndarray, t: np.ndarray, band: int | None = None):
    """Query-semiglobal edit-distance alignment of q vs t on the host: the
    full template window must be consumed, query overhangs on both sides are
    free. Returns (ops, q_start, q_end) — the op string (banded.OP_*
    encoding, forward order) covering q[q_start:q_end] vs all of t.
    Row-vectorized numpy DP (the in-row insertion chain resolved with the
    same cummin trick as the device kernel).

    Beyond ~4 Mcells the DP runs BANDED around the rescaled diagonal
    (j in [i*m/n - band, i*m/n + band]): hotspot/junction windows are
    high-identity local alignments whose paths hug the diagonal, and the full
    O(nm) matrix was the round-3 4 kb region cap (VERDICT #10). Cells outside
    the band read as +INF; the free-lead column 0 stays free only while in
    band (true starts sit near diagonal 0)."""
    from necat_tpu_torch.align.banded_kernels import OP_DEL, OP_DIAG, OP_INS
    n, m = len(q), len(t)
    if n == 0 or m == 0:
        return np.full(m, OP_DEL, np.uint8), 0, 0
    if band is None and n * m > (1 << 22):
        band = max(256, abs(n - m) + 256 + min(n, m) // 16)
    if band is not None and band * 2 + 1 < m:
        return _host_edit_ops_banded(q, t, band)
    D = np.zeros((n + 1, m + 1), np.int32)
    D[0] = np.arange(m + 1)
    ar = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        prev = D[i - 1]
        sub = (t != q[i - 1]).astype(np.int32)
        base = np.minimum(prev[:-1] + sub, prev[1:] + 1)
        full = np.concatenate(([np.int32(0)], base))   # D[i][0]=0: free lead
        D[i] = np.minimum.accumulate(full - ar) + ar
    i = int(np.argmin(D[:, m]))                        # free trailing query
    j = m
    q_end = i
    ops = []
    while j > 0:
        if i > 0 and D[i, j] == D[i - 1, j - 1] + (q[i - 1] != t[j - 1]):
            ops.append(OP_DIAG)
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append(OP_INS)
            i -= 1
        else:
            ops.append(OP_DEL)
            j -= 1
    return np.array(ops[::-1], np.uint8), i, q_end


def _host_edit_ops_banded(q: np.ndarray, t: np.ndarray, band: int):
    """Banded form of host_edit_ops: row i covers template columns
    [c_i - band, c_i + band] with c_i = i*m//n. Identical output when the
    optimal path stays inside the band."""
    from necat_tpu_torch.align.banded_kernels import OP_DEL, OP_DIAG, OP_INS
    INF = np.int32(1 << 28)
    n, m = len(q), len(t)
    W = 2 * band + 1
    lo = np.minimum(np.maximum((np.arange(n + 1, dtype=np.int64) * m) // n
                               - band, 0), max(m - W + 1, 0)).astype(np.int64)
    D = np.full((n + 1, W), INF, np.int32)
    j0 = np.arange(W, dtype=np.int32)
    D[0] = np.where(lo[0] + j0 <= m, (lo[0] + j0).astype(np.int32), INF)
    ar = np.arange(W, dtype=np.int32)
    for i in range(1, n + 1):
        s = int(lo[i] - lo[i - 1])          # band shift vs previous row
        prev = D[i - 1]
        # previous-row values aligned to THIS row's band positions
        if s > 0:
            al = np.concatenate([prev[s:], np.full(s, INF, np.int32)])
        else:
            al = prev
        # diag neighbor (i-1, j-1) = aligned position p-1; up (i-1, j) = p
        diag = np.concatenate(([INF], al[:-1]))
        j_here = lo[i] + j0
        sub = np.where(j_here >= 1,
                       (t[np.minimum(j_here - 1, m - 1)] != q[i - 1]), 1
                       ).astype(np.int32)
        base = np.minimum(np.minimum(diag + sub, INF), np.minimum(al + 1, INF))
        base = np.where(j_here == 0, 0, base)          # free lead column
        base = np.where(j_here > m, INF, base)
        row = np.minimum.accumulate(base - ar) + ar
        D[i] = np.minimum(row, INF)
    pm = m - lo
    valid = (pm >= 0) & (pm < W)
    endcol = np.where(valid, D[np.arange(n + 1), np.clip(pm, 0, W - 1)], INF)
    i = int(np.argmin(endcol))
    j = m
    q_end = i
    ops = []
    while j > 0:
        p = j - int(lo[i])
        here = D[i, p] if 0 <= p < W else INF
        pd = j - 1 - int(lo[i - 1]) if i > 0 else -1
        pu = j - int(lo[i - 1]) if i > 0 else -1
        dv = D[i - 1, pd] if i > 0 and 0 <= pd < W else INF
        uv = D[i - 1, pu] if i > 0 and 0 <= pu < W else INF
        pl = j - 1 - int(lo[i])
        lv = D[i, pl] if 0 <= pl < W else INF
        if i > 0 and here == dv + (q[i - 1] != t[j - 1]):
            ops.append(OP_DIAG)
            i -= 1
            j -= 1
        elif i > 0 and here == uv + 1:
            ops.append(OP_INS)
            i -= 1
        else:
            ops.append(OP_DEL)
            j -= 1
            if lv >= INF and here >= INF:
                # out-of-band walk (path escaped the band): emit DELs home
                ops.extend([OP_DEL] * j)
                j = 0
    return np.array(ops[::-1], np.uint8), i, q_end


def consensus_linkdp_path(all_tags: List[tuple], template_size: int,
                          seg_from: int = 0, seg_to: int | None = None):
    """Like consensus_linkdp but returns the best path as a forward-ordered
    list of (t, delta, base) nodes (gap nodes included) — the hotspot splice
    needs per-position emissions."""
    seq, cns_from, cns_to, path = _linkdp(all_tags, template_size, seg_from,
                                          seg_to)
    return path, cns_from, cns_to


def consensus_linkdp(all_tags: List[tuple], template_size: int,
                     seg_from: int = 0, seg_to: int | None = None
                     ) -> Tuple[np.ndarray, int, int]:
    """build_backbone + consensus_backbone_segment. Returns (seq codes,
    cns_from, cns_to)."""
    seq, cns_from, cns_to, _ = _linkdp(all_tags, template_size, seg_from,
                                       seg_to)
    return seq, cns_from, cns_to


def _linkdp(all_tags: List[tuple], template_size: int,
            seg_from: int = 0, seg_to: int | None = None):
    if seg_to is None:
        seg_to = template_size
    # backbone: nodes[(t, d, b)] = dict link(p_t,p_d,p_b) -> [count, weight]
    nodes: dict = {}
    coverage = np.zeros(template_size, np.int64)
    for (t, d, b, pt, pd, pb, w) in all_tags:
        key = (t, d, b)
        links = nodes.get(key)
        if links is None:
            links = {}
            nodes[key] = links
        lk = (pt, pd, pb)
        e = links.get(lk)
        if e is None:
            links[lk] = [1, w]
        else:
            e[0] += 1
            e[1] += w
        if d == 0:
            coverage[t] += 1

    # DP in (t asc, delta asc, base asc) order (cns_aux.c:152-186)
    score: dict = {}
    best_p: dict = {}
    g_best = (-1.0, None)
    # link iteration order matches the reference's tag sort (AlignTag_LT with
    # '-' < 'ACGT' as chars): gap sorts BEFORE the bases
    def _lkey(lk):
        pt, pd, pb = lk
        return (pt, pd, -1 if pb == GAP else pb)

    for key in sorted(k for k in nodes.keys() if seg_from <= k[0] < seg_to):
        t, d, b = key
        links = nodes[key]
        bs, bp = -1.0, None
        for lk in sorted(links.keys(), key=_lkey):
            pt, pd, pb = lk
            cnt, w = links[lk]
            s = w - 0.4 * 0.5 * coverage[t]
            if pt != -1:
                s += score.get((pt, pd, pb), 0.0)
            if s > bs:
                bs, bp = s, (pt, pd, pb)
        score[key] = bs
        best_p[key] = bp
        if bs > g_best[0]:
            g_best = (bs, key)

    if g_best[1] is None:
        return np.zeros(0, np.uint8), 0, 0, []
    # backtrack (cns_aux.c:189-211): every path node emits its base except
    # the origin (whose best predecessor is the -1 sentinel)
    out = []
    path = []
    key = g_best[1]
    cns_to = key[0] + 1
    cns_from = 0
    while True:
        bb = key[2]
        p = best_p.get(key)
        if p is None or p[0] == -1:
            cns_from = key[0]
            break
        cns_from = p[0]
        path.append(key)
        if bb != GAP:
            out.append(bb)
        key = p
    return np.array(out[::-1], np.uint8), cns_from, cns_to, path[::-1]
