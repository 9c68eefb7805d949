#!/usr/bin/env python
"""How far apart the two correction flows' pair weights are: the legacy
flow computes a pair's identity and weight in float64 on the host and
rounds the weight once to float32; the fused flow computes both in
float32 on the device. For simulated pairs (n_cols uniform in [2000,
16000), identity uniform in [80, 95) %) the script prints the share of
pairs whose two weights differ and the count at each distance in float32
ulps, as one JSON line.

    python scripts/legacy_weight_ulps.py [--pairs 100000] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from necat_tpu_torch.consensus.fused import calc_cns_weight
    rng = np.random.default_rng(args.seed)
    n_cols = rng.integers(2000, 16000, args.pairs)
    n_match = (n_cols * rng.uniform(0.8, 0.95, args.pairs)).astype(np.int64)
    # the fused flow: extend_batch's float32 identity, then the weight in float32
    nc, nm = torch.from_numpy(n_cols).int(), torch.from_numpy(n_match).int()
    w32 = calc_cns_weight(100.0 * nm / nc.clamp(min=1)).numpy()
    # the legacy flow: collect_stats' float64 identity, the weight rounded once
    w64 = calc_cns_weight(torch.from_numpy(100.0 * n_match / n_cols)).numpy()
    ulps = np.abs(w32.view(np.int32).astype(np.int64) - w64.view(np.int32))
    print(json.dumps({"pairs": args.pairs, "share_differing": float((ulps > 0).mean()),
                      "pairs_by_ulps": np.bincount(ulps).tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
