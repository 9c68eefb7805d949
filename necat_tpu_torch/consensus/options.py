"""Consensus (correction) options (the port's copy of
necat_tpu/consensus/options.py).

Defaults mirror src/consensus/cns_options.c:10-22: min_align_size=400, min_cov=4,
max_cov=12, min_size=500, mapping_ratio=0.8, error=0.5. Wave/estimation constants
from consensus_one_read.c / error_estimate.c / consensus_aux.h.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CnsOptions:
    min_align_size: int = 400
    min_cov: int = 4
    max_cov: int = 12
    min_size: int = 500
    mapping_ratio: float = 0.8
    error: float = 0.5
    full_consensus: bool = False
    use_fixed_ident_cutoff: bool = False
    # wave machinery (consensus_one_read.c:317-372, error_estimate.c)
    max_examined: int = 300        # MAX_EXAMINED_CAN (consensus_aux.h:15)
    wave_size: int = 50
    n_ident: int = 15              # overlaps used for the identity estimate
    good_end_margin: int = 200     # is_good_overlap M (error_estimate.c:19)
    # consensus tensor shape / calling
    max_delta: int = 8             # insertion states kept per template position
    ins_frac: float = 0.2          # insertion threshold slope: weight >= ins_frac*cov + ins_offset
    ins_offset: float = 1.0        # absolute floor of the insertion threshold (calibrated:
                                   # suppresses spurious homopolymer inserts at low coverage
                                   # without dropping real inserts, whose support is ~0.7*cov)
    raw_min_gap: int = 1000        # uncorrected interval passthrough (get_raw_intvs)
    # batching: more templates per bucket => fuller pair chunks + fewer
    # dispatches (chunk purity is per bucket: a wave split over 4 buckets ran
    # 60%-full lanes; one 256-template bucket runs tier-mix-only chunks).
    # Weights tensor is (TB+1)*max_delta*5*Lt f32 — ~1.7 GB at TB=256,
    # Lt=40960; fits v5e HBM alongside the 2 GB extension buffers.
    templates_per_batch: int = 256
    # buckets whose waves share one dispatch stream. None (default) = one
    # bucket per correction device (buckets are the unit of multi-chip data
    # parallelism — each bucket's tensors and programs pin to one device);
    # single-chip runs get exactly one bucket per supergroup.
    buckets_per_supergroup: int | None = None
    pairs_per_chunk: int = 1024
    band_width: int = 128
    # long-indel rescue: re-extend hanging pairs with iteratively doubled
    # bands (scale, 2*scale, ... max_scale) until the alignment reaches the
    # chain-predicted range — the TPU stand-in for the unbounded DALIGNER
    # O(nd) cascade (oc2cns -r, cns_options.c:19 default 0; align.c:382)
    rescue_long_indels: bool = False
    rescue_band_scale: int = 4
    rescue_band_max_scale: int = 32
    # SMALL_MEMORY (oc2cns -s, read_id_pool.h:29-63): upload only the reads a
    # template supergroup touches instead of the whole store. Auto-enabled
    # when the read set exceeds the device store's 2^31-base limit.
    small_memory: bool = False
    # fused single-dispatch correction (consensus/fused.py): None = default
    # on (every backend); False selects the legacy two-program oracle flow.
    fused: bool | None = None

    @classmethod
    def from_string(cls, s: str, base: "CnsOptions | None" = None) -> "CnsOptions":
        """Merge a NECAT CNS option string over defaults (parse_CnsOptions,
        cns_options.c:43-90: -a min_align_size, -x min_cov, -y max_cov,
        -l min_size, -f full_consensus, -e error, -p mapping_ratio,
        -r rescue_long_indels, -u use_fixed_ident_cutoff; -t threads and
        -s small_memory are runtime concerns handled elsewhere)."""
        from necat_tpu_torch.overlap.options import _parse_flags
        f = _parse_flags(s)
        b = base or cls()
        return dataclasses.replace(
            b,
            min_align_size=int(f.get("a", b.min_align_size)),
            min_cov=int(f.get("x", b.min_cov)),
            max_cov=int(f.get("y", b.max_cov)),
            min_size=int(f.get("l", b.min_size)),
            full_consensus=bool(int(f.get("f", int(b.full_consensus)))),
            error=float(f.get("e", b.error)),
            mapping_ratio=float(f.get("p", b.mapping_ratio)),
            rescue_long_indels=bool(int(f.get("r", int(b.rescue_long_indels)))),
            use_fixed_ident_cutoff=bool(
                int(f.get("u", int(b.use_fixed_ident_cutoff)))),
        )
