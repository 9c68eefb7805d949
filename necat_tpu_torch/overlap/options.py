"""Mapping / candidate-detection options (the port's copy of
necat_tpu/overlap/options.py).

Defaults mirror the reference getopt defaults (src/common/map_options.c:12-46):
pairwise-mapping {k=15, scan_window=10, occ_cutoff=500, block_score_cutoff=3,
ncan=500, align_size_cutoff=500}; reference-mapping {scan_window=5, ncan=20};
assembly overlapper caps candidates at 100 (src/asm_pm/asm_pm_common.c:26).
Chain-DP constants from src/word_finder/chain_dp.c:161-181.
"""

from __future__ import annotations

import dataclasses


def _parse_flags(s: str) -> dict:
    """Parse a getopt-style option string ('-n 500 -z 20 ...') into a dict."""
    toks = s.split()
    out = {}
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.startswith("-") and len(t) == 2 and i + 1 < len(toks):
            out[t[1]] = toks[i + 1]
            i += 2
        else:
            i += 1
    return out


@dataclasses.dataclass(frozen=True)
class MapOptions:
    kmer_size: int = 15
    scan_window: int = 10
    occ_cutoff: int = 500
    block_score_cutoff: int = 3     # chain min seed count (min_cnt)
    ncan: int = 500                 # max candidates kept per query
    align_size_cutoff: int = 500    # min candidate span
    # chain-DP (chain_dp.c:161-181)
    chain_max_dist: int = 5000
    chain_bw: int = 500
    chain_min_score: int = 30
    # batching caps (TPU static shapes). max_hits is the STARTING hit-buffer
    # size; a saturated pass is re-dispatched with a 4x larger buffer up to
    # max_hits_ceiling (no silent candidate loss — the reference has no cap at
    # all, word_finder.c collects every in-cutoff hit).
    max_hits: int = 1 << 19         # hit slots per (batch, strand) pass
    # ceiling sized for HIGH-IDENTITY read sets (correction iteration 2 maps
    # corrected reads: nearly every sampled k-mer hits ~coverage positions —
    # ~12M hits per 256-read batch at 30x; the old 2^23 ceiling silently
    # dropped ~30% of iteration-2 candidates)
    max_hits_ceiling: int = 1 << 24
    max_pairs: int = 8192           # (query, subject) pair segments per pass
    # pairs actually CHAINED per pass: pairs with fewer than
    # block_score_cutoff hits can never pass the post-chain seed filter
    # (stats_to_candidates), so they are compacted away before the seed
    # gather + chain DP — at 40x coverage ~3/4 of pair segments are 1-2-hit
    # noise and chaining them dominated the candidate stage at scale
    max_chain_pairs: int = 4096
    max_seeds_per_pair: int = 64    # seeds fed to chain DP per pair (subsampled beyond)
    # candidates emitted per (query, subject) pair: chains after the first
    # re-run the DP with the previous chain's subject span masked — the role
    # of the reference's one-candidate-per-scoring-block output
    # (word_finder.c:183-359); split alignments need 2
    n_chains_per_pair: int = 1

    @classmethod
    def from_string(cls, s: str, base: "MapOptions | None" = None) -> "MapOptions":
        """Merge a NECAT option string over defaults (the role of
        mergeOptionString + parse_MapOptions, necat.pl:20 / map_options.c:90+).

        Recognized flags (map_options.c argn_list "k:z:q:b:s:n:a:d:e:m:t:j:u:i:"):
        -k kmer_size, -z scan_window, -q occ_cutoff, -s block_score_cutoff,
        -n ncan, -a align_size_cutoff. Flags whose mechanism does not exist in
        this design are accepted and ignored: -b block_size / -d ddfs (the
        two-level block-scoring heuristic is replaced by full chain DP),
        -e error, -m num_output, -t threads, -j job, -u binary, -i hdr-as-id
        (handled by the stage/driver layer)."""
        f = _parse_flags(s)
        b = base or cls()
        return dataclasses.replace(
            b,
            kmer_size=int(f.get("k", b.kmer_size)),
            scan_window=int(f.get("z", b.scan_window)),
            occ_cutoff=int(f.get("q", b.occ_cutoff)),
            block_score_cutoff=int(f.get("s", b.block_score_cutoff)),
            ncan=int(f.get("n", b.ncan)),
            align_size_cutoff=int(f.get("a", b.align_size_cutoff)),
        )


CORRECTION_MAP_OPTIONS = MapOptions()
# trim/assembly overlaps keep both loci of split alignments: oc2lcr's
# chimera detection needs to see each piece (largest_cover_range.c)
ASSEMBLY_MAP_OPTIONS = MapOptions(ncan=100, scan_window=10, n_chains_per_pair=2)
REFMAP_OPTIONS = MapOptions(scan_window=5, ncan=20, block_score_cutoff=2)
