#!/usr/bin/env python
"""Place a difference between the port's and the JAX package's correction
in the adaptive band (NECAT_TPU_NO_PALLAS) at one template: both packages
correct the given templates alone on the CPU, from the same candidates, and
the script prints the first three consensus columns where their calls
differ with the tag weights each package called them from. With --compare
legacy it holds the port's legacy two-program flow (fused=False) against
the port's fused flow instead, and imports nothing of the JAX package.

    JAX_PLATFORMS=cpu python scripts/adaptive_tie_probe.py [--templates 199]
        [--options pipeline-it1|main] [--compare jax|legacy]

The reads are the bench set (gen_benchmark_reads(200_000, 20, seed=7));
--options picks the correction's options: `main` the defaults
(chip_smoke.py's phase 20), `pipeline-it1` the first iteration of `cli
correct` with the config template (OVLP_SENSITIVE_OPTIONS,
CNS_SENSITIVE_OPTIONS -r 0, full consensus), the iteration whose template
199 carries into phase 21's cns_final. The candidates are the port's
(find_all_candidates on the CPU; they equal the JAX package's, phase 20).
The weights are those each package hands its consensus call: the port's
float64 sums rounded once to float32, the JAX package's float32 sums. The
two flows' weights are both the port's float64 sums; their pair weights
come from the identity in float64 on the host (legacy) or in float32 on
the device (fused). Prints one JSON line per differing template ("port" is
the fused flow, "other" the JAX package or the legacy flow).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _spy(module, calls):
    """Record each consensus call's weights, coverage and packed calls. The
    port's correct_reads calls consensus_stream: its packed form is
    computed beside it, from the same arguments."""
    name = "consensus_packed" if hasattr(module, "consensus_packed") else "consensus_stream"
    fn = getattr(module, name)

    def spy(w, cov, *args):
        out = fn(w, cov, *args)
        if name == "consensus_packed":
            packed = out
        else:
            from necat_tpu_torch.consensus.backbone import consensus_packed
            packed = consensus_packed(w, cov, *args)
        calls.append((np.asarray(w), np.asarray(cov), np.asarray(packed)))
        return out
    setattr(module, name, spy)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--templates", type=int, nargs="+", default=[199])
    ap.add_argument("--options", choices=("pipeline-it1", "main"), default="pipeline-it1")
    ap.add_argument("--compare", choices=("jax", "legacy"), default="jax")
    args = ap.parse_args()
    os.environ["NECAT_TPU_NO_PALLAS"] = "1"
    from necat_tpu_torch.consensus import correct
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.pipeline import config as config_mod
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    _, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    if args.options == "main":
        mopts, copts = MapOptions(), CnsOptions()
    else:
        tmpl = dict(line.split("=", 1) for line in config_mod.CONFIG_TEMPLATE.splitlines()
                    if "=" in line)
        mopts = MapOptions.from_string(tmpl["OVLP_SENSITIVE_OPTIONS"])
        copts = dataclasses.replace(
            CnsOptions.from_string(tmpl["CNS_SENSITIVE_OPTIONS"] + " -r 0"),
            full_consensus=True)
    cands = find_all_candidates(store, store, mopts, pairwise=True, device="cpu")
    call = Candidates.concat([cands, cands.swap_roles()])
    calls = {"port": [], "other": []}
    _spy(correct, calls["port"])
    recs = correct.correct_reads(store, call, copts, device="cpu",
                                 template_ids=args.templates)
    if args.compare == "legacy":
        _spy(correct, calls["other"])
        jrecs = correct.correct_reads(store, call, dataclasses.replace(copts, fused=False),
                                      device="cpu", template_ids=args.templates)
    else:
        from necat_tpu.consensus import correct as jcorrect
        from necat_tpu.consensus.options import CnsOptions as JaxCnsOptions
        from necat_tpu.io.readstore import ReadStore as JaxReadStore
        from necat_tpu.overlap.candidates import Candidates as JaxCandidates
        jstore = JaxReadStore.from_seqs([store.get(i) for i in range(store.n_reads)])
        jcall = JaxCandidates(**{f.name: getattr(call, f.name)
                                 for f in dataclasses.fields(Candidates)})
        _spy(jcorrect, calls["other"])
        jrecs = jcorrect.correct_reads(jstore, jcall,
                                       JaxCnsOptions(**dataclasses.asdict(copts)),
                                       template_ids=args.templates)
    key = lambda r: (r.tid, r.left)                                     # noqa: E731
    recs, jrecs = sorted(recs, key=key), sorted(jrecs, key=key)
    differ = sorted({r.tid for r, j in zip(recs, jrecs)
                     if (r.left, r.right, r.corrected) != (j.left, j.right, j.corrected)
                     or not np.array_equal(r.seq, j.seq)} | (
        set() if len(recs) == len(jrecs) else {r.tid for r in recs + jrecs}))
    (w, cov, packed), (jw, jcov, jpacked) = calls["port"][0], calls["other"][0]
    TB, L = (min(x, y) for x, y in zip(packed.shape, jpacked.shape))
    rows, cols = np.nonzero(packed[:TB, :L] != jpacked[:TB, :L])
    for tid in differ:
        rec = [r for r in recs if r.tid == tid]
        jrec = [r for r in jrecs if r.tid == tid]
        out = {"options": args.options, "compare": args.compare, "template": tid,
               "port": [(r.left, r.right, len(r.seq)) for r in rec],
               "other": [(r.left, r.right, len(r.seq)) for r in jrec],
               "columns": []}
        for row, col in list(zip(rows.tolist(), cols.tolist()))[:3]:
            out["columns"].append({
                "row": row, "column": col, "coverage": [int(cov[row, col]),
                                                        int(jcov[row, col])],
                # delta 0's weights of A, C, G, T and the gap
                "port_delta0": [float(x) for x in w[row, 0, :, col]],
                "other_delta0": [float(x) for x in jw[row, 0, :, col]],
                "port_call": int(packed[row, col]) & 7,
                "other_call": int(jpacked[row, col]) & 7})
        print(json.dumps(out), flush=True)
    if not differ:
        print(json.dumps({"options": args.options, "compare": args.compare,
                          "templates": args.templates, "differ": []}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
