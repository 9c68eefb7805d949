"""Static shape tiers (the port's copy of necat_tpu/utils/shapes.py).

Reads and target windows are padded to one of a few length tiers, and an
extension chunk holds a bounded number of pairs. The values are the JAX
package's, so that both packages cut the same chunks and the tests can
compare them chunk for chunk. The rescue tests patch MAX_BAND in both
packages; the port reads it at call time.
"""

from __future__ import annotations

# sequence-length tiers (reads 3 kb - 40 kb + polish windows), power-of-two
# spaced; all are multiples of 2048
LENGTH_TIERS = (2048, 4096, 8192, 16384, 32768, 40960, 65536, 131072, 262144)

# dirs-buffer budget of one extension chunk: PB * L * W bytes
EXTENSION_BYTES = 2 << 30
BAND_W_DEFAULT = 128
# absolute band ceiling of the rescue ladder
MAX_BAND = 4096
# bases a DeviceReadStore may hold (its row descriptors are int32). Read sets
# at or past it correct in SMALL_MEMORY mode over subject volumes, with the
# candidate queries gathered on the host. Read at call time, so that a test
# can lower it.
DEVICE_STORE_MAX_BASES = 1 << 31
# bases of a subject volume whose k-mer index is built on the card
# (KmerIndex.build_on_device) rather than by the native radix sort on the
# host: the JAX package's gate (necat_tpu/overlap/overlapper.py:33). Read at
# call time.
DEVICE_INDEX_MAX_BASES = int(3e8)


def length_tier(x: int) -> int:
    for t in LENGTH_TIERS:
        if x <= t:
            return t
    # beyond the largest tier: next power of two
    t = LENGTH_TIERS[-1]
    while t < x:
        t *= 2
    return t


def tier_below(L: int) -> int:
    """The next tier below L (L itself for the smallest tier)."""
    i = LENGTH_TIERS.index(L) if L in LENGTH_TIERS else None
    if i is None or i == 0:
        return L if i == 0 else L // 2
    return LENGTH_TIERS[i - 1]


def pairs_per_chunk(L: int, W: int = BAND_W_DEFAULT, cap: int = 1024) -> int:
    """Pair-batch bound for one extension chunk at tier L: EXTENSION_BYTES
    over L * W, between 8 and cap, floored to a power of two."""
    raw = max(8, min(cap, EXTENSION_BYTES // (L * W)))
    p = 8
    while p * 2 <= raw:
        p *= 2
    return p
