"""Read correction of the whole read set, as one correction process runs
the first iteration (pipeline/stages.py run_correct with one process): the
raw reads on the card as one volume, their pairwise candidates found once
in set-up with the configuration's overlap options, then in every unit
correct_reads over all templates with its consensus options.

Traffic keys: check_templates (templates drawn from the seed after the
window and corrected again by the reference, in every unit's records),
warm_every (set-up corrects every warm_every-th template once, so the
kernels and buffers of the window's sizes are ready). Counter:
template_bases, the raw bases of all templates.
"""

from __future__ import annotations

import numpy as np

from portbench import inputs


def setup(ctx) -> dict:
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates

    config, dev, log = ctx["config"], ctx["device"], ctx["log"]
    reads = inputs.raw_reads(config, ctx["seed"])
    log.write(inputs.stamp("reads"))
    store = ReadStore.from_seqs(reads)
    mopts = MapOptions.from_string(config["ovlp_options"])
    copts = CnsOptions.from_string(config["cns_options"])
    cands = find_all_candidates(store, store, mopts, pairwise=True, device=dev)
    both = Candidates.concat([cands, cands.swap_roles()])
    log.write(inputs.stamp("candidates"))
    warm = np.arange(0, store.n_reads, int(ctx["traffic"]["warm_every"]))
    correct_reads(store, both, copts, device=dev, template_ids=warm)
    log.write(inputs.stamp("warm-up"))
    log.write(f"reads {store.n_reads}, bases {store.total_bases}, candidates {len(cands)}\n")
    return {"ctx": ctx, "reads": reads, "store": store, "both": both, "copts": copts,
            "units": [], "n_reads": store.n_reads, "correct_reads": correct_reads}


def unit(st: dict, i: int) -> dict:
    store = st["store"]
    st["units"].append(st["correct_reads"](store, st["both"], st["copts"],
                                           device=st["ctx"]["device"]))
    return {"template_bases": int(store.total_bases)}


def release(st: dict) -> None:
    for k in ("store", "both", "correct_reads"):
        st.pop(k, None)


def sample(st: dict, rng) -> np.ndarray:
    """check_templates template ids drawn from rng."""
    k = min(int(st["ctx"]["traffic"]["check_templates"]), st["n_reads"])
    return np.sort(rng.choice(st["n_reads"], size=k, replace=False))


def reference_records(st: dict, tids, control: bool = False) -> list:
    """The reference's records of templates tids, from the same reads; with
    control, its pair weights rounded to bfloat16."""
    import torch

    from portbench.reference import correct as C, search as S
    cfg, dev = st["ctx"]["config"], st["ctx"]["device"]
    mo = S.parse_map_options(cfg["ovlp_options"])
    if "ref_volume" not in st:
        st["ref_volume"] = S.Volume(st["reads"], mo["k"], dev)
    return C.correct(st["ref_volume"], tids, mo, C.parse_cns_options(cfg["cns_options"]), dev,
                     weight_dtype=torch.bfloat16 if control else None)


def _program_records(recs: list, tids) -> list:
    want = set(int(t) for t in tids)
    return [r for r in recs if int(r.tid) in want]


def check(st: dict, rng) -> dict:
    tids = sample(st, rng)
    ref = reference_records(st, tids)
    n = sum(inputs.records_differ(_program_records(u, tids), ref) for u in st["units"])
    st["failed"] = n
    return {"records_differ": (n, 0)}


def control(st: dict, rng) -> dict:
    """The control's reading on the sample a check draws: the reference
    with bfloat16 pair weights in the program's place."""
    tids = sample(st, rng)
    return {"records_differ": inputs.records_differ(reference_records(st, tids, True),
                                                    reference_records(st, tids))}
