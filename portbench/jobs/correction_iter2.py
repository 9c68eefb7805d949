"""Read correction of the whole read set in the second iteration, as one
correction process runs the last of NUM_ITER=2 iterations
(pipeline/stages.py run_correct with one process): set-up makes the raw
reads, runs iteration 1 on the card (the configuration's it1 options,
whole reads kept), stores its records sorted by (tid, left) as the reads of
iteration 2, one volume on the card, and finds their pairwise candidates
with iteration 2's overlap options; every unit is then correct_reads over
all templates with iteration 2's consensus options (the rescue ladder on,
broken consensus).

Traffic keys: check_templates (templates drawn from the seed after the
window and held to the reference, portbench/reference/correct_rescue.py,
from iteration 2's reads), warm_every (set-up corrects every warm_every-th
template once, so the kernels and buffers of the window's sizes are
ready). Counter: template_bases, the bases of all templates of iteration 2.

Each unit also records, from its own correct_reads call, the pairs that
fused.dispatch_wave extends at a band above band_width, as (template,
query, band), and each template's votes summed as the consensus call
reads them (correct.consensus_stream's float32 weights, added in float64
per bucket row; the rows named by _run_supergroup's buckets). The check
compares, in every unit and on the sample alone: records_differ, the
records; bands_differ, the (template, query, band) extensions above
band_width that differ in number; vote_weight_ppm, the largest
|program - reference| / reference of a template's summed votes, in parts
per million (float32 pair weights summed exactly: 0 when every pair
weight is the reference's). The reference corrects a pool of POOL x
check_templates templates drawn from the seed, and up to half of the
sample are templates of the pool on which a pair climbed a rung: on 8
templates drawn at random a pair climbed on 0-3 of them, and the ladder
changes a record too rarely to be seen there, so the bands are what see it.

The controls (control()): the reference with its ladder off (-r 0) in the
program's place, and the reference with bfloat16 pair weights.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np

from portbench import inputs
from portbench.jobs import correction as it1


def setup(ctx) -> dict:
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates

    config, dev, log = ctx["config"], ctx["device"], ctx["log"]

    def both_roles(store, opts):
        cands = find_all_candidates(store, store, MapOptions.from_string(opts),
                                    pairwise=True, device=dev)
        return Candidates.concat([cands, cands.swap_roles()]), len(cands)

    reads = inputs.raw_reads(config, ctx["seed"])
    log.write(inputs.stamp("reads"))
    store1 = ReadStore.from_seqs(reads)
    both1, _ = both_roles(store1, config["it1_ovlp_options"])
    log.write(inputs.stamp("iteration-1-candidates"))
    recs = correct_reads(store1, both1, CnsOptions.from_string(config["it1_cns_options"]),
                         device=dev)
    del store1, both1, reads
    log.write(inputs.stamp("iteration-1"))
    recs.sort(key=lambda r: (r.tid, r.left))
    reads2 = [r.seq for r in recs]
    store = ReadStore.from_seqs(reads2, [f"{r.tid}_{r.left}_{r.right}_{r.org_size}"
                                         for r in recs])
    del recs
    copts = CnsOptions.from_string(config["cns_options"])
    both, n_cands = both_roles(store, config["ovlp_options"])
    log.write(inputs.stamp("candidates"))
    warm = np.arange(0, store.n_reads, int(ctx["traffic"]["warm_every"]))
    correct_reads(store, both, copts, device=dev, template_ids=warm)
    log.write(inputs.stamp("warm-up"))
    log.write(f"reads {store.n_reads}, bases {store.total_bases}, candidates {n_cands}\n")
    return {"ctx": ctx, "reads": reads2, "store": store, "both": both, "copts": copts,
            "units": [], "seen": [], "n_reads": store.n_reads,
            "correct_reads": correct_reads}


POOL = 3
# vote_weight_ppm's limit (PERF.md §2: the sound and the bfloat16 readings
# at the cell's size)
VOTE_PPM_LIMIT = 10.0


@contextlib.contextmanager
def _recording(st: dict):
    """Record what one unit's correct_reads extends above band_width and
    votes (the module docstring): yields a dict that holds, once the block
    ends, "bands" (Counter of (template, query, band)) and "votes"
    (template -> summed votes)."""
    import torch

    from necat_tpu_torch.consensus import correct, fused
    w0, offsets = st["copts"].band_width, st["store"].offsets
    dispatch, stream, run_sg = fused.dispatch_wave, correct.consensus_stream, \
        correct._run_supergroup
    calls, sums, rows = [], [], []

    def dispatch_wave(*args, **kw):
        if kw["W"] > w0:
            calls.append((np.searchsorted(offsets, kw["tg_base"]), np.asarray(kw["qids"]),
                          int(kw["W"])))
        return dispatch(*args, **kw)

    def consensus_stream(w, *args, **kw):
        sums.append(w.sum(dim=tuple(range(1, w.dim())), dtype=torch.float64))
        return stream(w, *args, **kw)

    def run_supergroup(*args, **kw):
        buckets, tpls = run_sg(*args, **kw)
        rows.extend(b.ids[:b.n_real] for b in buckets)
        return buckets, tpls

    seen: dict = {}
    fused.dispatch_wave, correct.consensus_stream = dispatch_wave, consensus_stream
    correct._run_supergroup = run_supergroup
    try:
        yield seen
    finally:
        fused.dispatch_wave, correct.consensus_stream = dispatch, stream
        correct._run_supergroup = run_sg
    if len(sums) != len(rows):
        raise RuntimeError(f"{len(sums)} consensus calls for {len(rows)} buckets")
    seen["bands"] = Counter((int(t), int(q), W) for tids, qids, W in calls
                            for t, q in zip(tids, qids))
    seen["votes"] = {int(t): float(v) for ids, s in zip(rows, sums)
                     for t, v in zip(ids, s[:len(ids)].cpu().numpy())}


def unit(st: dict, i: int) -> dict:
    with _recording(st) as seen:
        out = it1.unit(st, i)
    st["seen"].append(seen)
    return out


def release(st: dict) -> None:
    for k in ("store", "both", "correct_reads"):
        st.pop(k, None)


def _reference(st: dict):
    """(the reference's volume of iteration 2's reads, map options, consensus
    options), the volume built once."""
    from portbench.reference import correct_rescue as R, search as S
    cfg = st["ctx"]["config"]
    mo = S.parse_map_options(cfg["ovlp_options"])
    if "ref_volume" not in st:
        st["ref_volume"] = S.Volume(st["reads"], mo["k"], st["ctx"]["device"])
    return st["ref_volume"], mo, R.parse_cns_options(cfg["cns_options"])


def reference(st: dict, tids, *, ladder: bool = True, weight_dtype=None) -> dict:
    """The reference's answers for templates tids from iteration 2's reads
    (without ladder, with -r 0 in place of the configuration's -r 1):
    records, climbed (template -> pairs that climbed a rung, once a rung),
    bands and votes as a unit records them."""
    from portbench.reference import correct_rescue as R
    vol, mo, o = _reference(st)
    o["rescue"] = o["rescue"] and ladder
    out = {"climbed": {}, "bands": Counter(), "votes": {}}
    out["records"] = R.correct(vol, tids, mo, o, st["ctx"]["device"],
                               weight_dtype=weight_dtype, **out)
    return out


def sample(st: dict, rng):
    """(check_templates template ids, the reference's answers for them, the
    climbers among them): a pool of POOL x check_templates templates drawn
    from rng and corrected by the reference (once a pool), then up to half
    of the sample from the pool's templates on which a pair climbed a rung,
    the rest from the others, each in pool order."""
    n = st["n_reads"]
    k = min(int(st["ctx"]["traffic"]["check_templates"]), n)
    pool = rng.choice(n, size=min(POOL * k, n), replace=False)
    cache = st.setdefault("pools", {})
    if tuple(pool) not in cache:
        cache[tuple(pool)] = reference(st, pool)
    ref = cache[tuple(pool)]
    up = [int(t) for t in pool if ref["climbed"].get(int(t))][:k // 2]
    tids = np.sort(np.array(up + [int(t) for t in pool if int(t) not in up][:k - len(up)],
                            np.int64))
    return tids, _restrict(ref, tids), len(up)


def _restrict(ans: dict, tids) -> dict:
    """The answers (records, bands, votes) of templates tids alone."""
    want = set(int(t) for t in tids)
    return {"records": [r for r in ans["records"] if int(r.tid) in want],
            "bands": Counter({k: n for k, n in ans["bands"].items() if k[0] in want}),
            "votes": {t: v for t, v in ans["votes"].items() if t in want}}


def _differ(st: dict, got: dict, want: dict, tids) -> dict:
    """records_differ, bands_differ and vote_weight_ppm of answers got
    against want, on templates tids. bands_differ counts the bands above
    band_width only: which pairs climb is the ladder's, while round 0
    extending its lanes at band_width a second time is the program's way of
    scattering them."""
    got = _restrict(got, tids)
    w0 = _reference(st)[2]["band_width"]
    d = got["bands"].copy()
    d.subtract(want["bands"])
    ppm = max((1e6 * abs(got["votes"].get(int(t), 0.0) - want["votes"].get(int(t), 0.0))
               / max(want["votes"].get(int(t), 0.0), 1.0) for t in tids), default=0.0)
    return {"records_differ": inputs.records_differ(got["records"], want["records"]),
            "bands_differ": sum(abs(n) for k, n in d.items() if k[2] > w0),
            "vote_weight_ppm": ppm}


def check(st: dict, rng) -> dict:
    tids, ref, _ = sample(st, rng)
    per_unit = [_differ(st, {"records": u, **seen}, ref, tids)
                for u, seen in zip(st["units"], st["seen"])]
    n = sum(r["records_differ"] for r in per_unit)
    nb = sum(r["bands_differ"] for r in per_unit)
    ppm = max(r["vote_weight_ppm"] for r in per_unit)
    st["failed"] = n + nb + int(ppm > VOTE_PPM_LIMIT)
    return {"records_differ": (n, 0), "bands_differ": (nb, 0),
            "vote_weight_ppm": (ppm, VOTE_PPM_LIMIT)}


def control(st: dict, rng) -> dict:
    """The controls' readings on the sample a check draws, each a reference
    in the program's place: with its ladder off, records_differ,
    bands_differ and vote_weight_ppm; with bfloat16 pair weights, the same
    with _bf16 after the name; climbed, the templates of the sample on which
    a pair climbed a rung."""
    import torch
    tids, ref, up = sample(st, rng)
    out = {"climbed": up}
    for tag, kw in (("", dict(ladder=False)), ("_bf16", dict(weight_dtype=torch.bfloat16))):
        for k, v in _differ(st, reference(st, tids, **kw), ref, tids).items():
            out[k + tag] = v
    return out
