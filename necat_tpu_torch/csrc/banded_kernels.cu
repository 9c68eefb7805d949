// Banded alignment kernels for Hopper (sm_90a), bound to PyTorch with ctypes
// through the plain C entry points at the end of this file.
//
// K1, K2 and K3 (the static band) work in the DIAGONAL coordinates: lane l
// of target column j holds query row i = j + l - ctr, with the per-pair
// centre ctr = W/2 - floor((la - lb) / 2). The extension clamps
// |la - lb| <= W/4, so both alignment end points sit near the middle lane.
// K1a and K3a (the adaptive band, NECAT_TPU_NO_PALLAS) work in ROW
// coordinates: lane s of column j holds query row offs[j] + s, the band
// moving 0-2 rows a column; their dirs byte is the op alone.
//
// Byte encodings (shared with necat_tpu_torch/align/banded_kernels.py):
//   ENC  = mismatch | qbase << 1            (query base 0..3, pad 127)
//   dirs = op | mismatch << 2 | qbase << 3  (op: 0 diag, 1 del, 2 ins, 3 pad)
//   cols = op | match << 2 | qbase << 3 | k << 5   (k = insertion run length)
//
// Each entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0. Kernels allocate nothing and launch on the
// stream they are given.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Widths from which K1 (forward) and K3 (backtrack) run one thread block per
// pair instead of one warp, from same-call measurements on an H100 80GB
// HBM3 at 700 W (PERF.md): K1 at W = 512 took 8.44 ms with a block per pair
// against 9.24 ms with a warp; K3 at 512 took 2.00 ms with a warp against
// 2.69 ms with a block.
constexpr int K1_WIDE_MIN = 512;
constexpr int K3_WIDE_MIN = 1024;
// Columns of K1's loop unrolled together (within a 32-column tile), so that
// one column's output encoding can issue beside the next column's chain: 2
// with a block per pair (4.31 against 5.19 ms at W = 512), 1 with a warp per
// pair (2.04 against 2.24 ms at W = 128).
constexpr int K1_UNROLL_WARP = 1, K1_UNROLL_BLOCK = 2;

constexpr int INF = 1 << 20;
constexpr int OP_DIAG = 0, OP_DEL = 1, OP_INS = 2, OP_PAD = 3;
constexpr int PAD_BASE = 127;     // query padding: never equals a target base
constexpr int PAD_TARGET = 255;   // target padding past b's width
constexpr int N_INSB = 7;         // inserted bases per insb word and end
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t D_BITS = 21;   // 0 <= D <= INF < 2^21: D and a byte share a word

// floor(a / b) for b > 0. C's `/` truncates toward zero, which would put odd
// negative length differences one lane off the JAX reference.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int band_centre(int W, int la, int lb) {
  return W / 2 - floor_div(la - lb, 2);
}

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ------------------------------------------------------- V bytes in registers
// A thread's V consecutive band lanes t*V .. t*V+V-1, byte s of the row at
// bits 8*(s%4) of word s/4.
template <int V>
struct Bytes {
  static constexpr int N = (V + 3) / 4;
  uint32_t w[N];

  __device__ __forceinline__ int get(int s) const { return (w[s >> 2] >> (8 * (s & 3))) & 0xff; }

  // Drop byte 0 and append nb as byte V-1 (the query window slides one lane
  // per column). Bytes past V-1 in the last word stay 0.
  __device__ __forceinline__ void shift_in(uint32_t nb) {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) w[k] = __funnelshift_r(w[k], w[k + 1], 8);
    w[N - 1] = (w[N - 1] >> 8) | (nb << (8 * ((V - 1) & 3)));
  }

  __device__ __forceinline__ void load(const uint8_t* __restrict__ src) {
    if constexpr (V % 16 == 0) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const uint4 x = reinterpret_cast<const uint4*>(src)[k];
        w[4 * k] = x.x; w[4 * k + 1] = x.y; w[4 * k + 2] = x.z; w[4 * k + 3] = x.w;
      }
    } else if constexpr (V == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (V == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    } else {
      w[0] = 0;
#pragma unroll
      for (int s = 0; s < V; ++s) w[0] |= (uint32_t)src[s] << (8 * s);
    }
  }

  __device__ __forceinline__ void store(uint8_t* __restrict__ dst) const {
    if constexpr (V % 16 == 0) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k)
        reinterpret_cast<uint4*>(dst)[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else {
#pragma unroll
      for (int s = 0; s < V; ++s) dst[s] = (uint8_t)get(s);
    }
  }
};

// Per byte of x: 1 where it differs from y's byte, else 0.
__device__ __forceinline__ uint32_t bytes_ne(uint32_t x, uint32_t y) {
  const uint32_t d = x ^ y;
  return ((((d & 0x7f7f7f7fu) + 0x7f7f7f7fu) | d) >> 7) & 0x01010101u;
}

// ------------------------------------------------------- cp.async (sm_80+)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------- K2: ENC
// Replaces _diag_kernel / _diag_sub_matrix_pallas
// (necat_tpu/align/pallas_banded.py:146 / :172). ENC[p, jc, l] compares
// query base a[p, jc + l - ctr_p] (PAD_BASE outside [0, La)) with target
// base b[p, jc] (PAD_TARGET past Lb). Since K1 computes ENC itself, K2 is
// the standalone entry point only; the main path never runs it.
//
// Bound: device-memory bandwidth. It writes PB*MC*W bytes and reads each
// row once. Its first version (a thread per 4 output bytes: a run-time
// division, the band centre, and five scalar loads with their bounds checks
// per word) was bound by instructions issued: 23-25 % of the byte bound.
// This design issues about a quarter of the instructions per output byte:
//  - a block takes one pair (blockIdx.x, so PB is not capped at 65535) and a
//    tile of K2_TILE_BYTES of output: TC whole columns of W lanes (lanes are
//    tiled too only for a run-time W above K2_LANE_TILE); the pair's band
//    centre, row pointers and padding are worked out once per tile;
//  - the tile's query span a[jc0 + l_lo - ctr ...] (TC + LT bytes, PAD_BASE
//    outside the row) and its TC target bases (PAD_TARGET past Lb) are staged
//    into shared memory a word at a time: aligned 4-byte loads and a funnel
//    shift, byte by byte only at the row's ends;
//  - a thread builds NB lanes of one column (16 for the widths of
//    KERNEL_WIDTHS, 4 for a run-time W) from NB/4 + 1 staged words
//    funnel-shifted by 8 * (column % 4) bits; each word's ENC is K1's
//    bytes_ne | (q & 0x03030303) << 1;
//  - neighbouring threads build neighbouring NB bytes, so a warp's store is
//    32 * NB contiguous bytes, and it is a streaming store (st.global.cs):
//    the output is written once and is far larger than the L2.
// Measured in one call (L = 8192, PB = pairs_per_chunk; H100 80GB HBM3,
// 700.00 W; scripts/torch_kernel_ab.py): the first version 1.329 ms at
// W = 128 and 2.63-2.66 ms at 256-4096, this one 0.384 ms (85 % of the
// bound) and 0.68-0.74 ms (88-94 %). Tiles of 64-256 KB and 128 threads a
// block moved it by < 1.5 %, plain stores were 1-4 % slower, 4 consecutive
// columns a thread (one window, 4 shifts) 5 % slower at W = 64 and 128.
constexpr int K2_THREADS = 256;
constexpr int K2_TILE_BYTES = 1 << 17;   // output bytes a block builds per tile
constexpr int K2_LANE_TILE = 4096;       // lanes per tile of a run-time W

// Bytes q .. q+3 of a row of n bytes as a little-endian word, pad outside
// [0, n): aligned 4-byte loads inside the row (the row need not be aligned).
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row, int q,
                                              int n, uint32_t pad) {
  if (q >= 0 && q <= n - 4) {
    const uintptr_t addr = (uintptr_t)(row + q);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~(uintptr_t)3);
    const uint32_t sh = 8 * (uint32_t)(addr & 3);
    const uint32_t lo = __ldg(w);
    return sh ? __funnelshift_r(lo, __ldg(w + 1), sh) : lo;   // w + 1 holds byte q + 3
  }
  uint32_t x = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    x |= (q + s >= 0 && q + s < n ? (uint32_t)row[q + s] : pad) << (8 * s);
  return x;
}

// Lanes and columns of a K2 tile: all W lanes up to K2_LANE_TILE, and as
// many columns (a multiple of 4, 4 to 2048) as fill K2_TILE_BYTES.
__host__ __device__ __forceinline__ int k2_lane_tile(int W) {
  return W < K2_LANE_TILE ? W : K2_LANE_TILE;
}
__host__ __device__ __forceinline__ int k2_tile_cols(int LT) {
  return clampi((K2_TILE_BYTES / LT) & ~3, 4, 2048);
}

// WT: the band width, or 0 for a run-time W (W_rt). A tile is TC columns
// from jc0 by LT lanes from l_lo.
template <int WT>
__global__ void __launch_bounds__(K2_THREADS)
diag_sub_matrix_kernel(const uint8_t* __restrict__ a, int La, const uint8_t* __restrict__ b,
                       int Lb, const int* __restrict__ la_, const int* __restrict__ lb_,
                       uint8_t* __restrict__ out, int MC, int W_rt) {
  constexpr int NB = WT > 0 ? 16 : 4;                    // lanes a thread builds
  constexpr int NW = NB / 4 + 1;                         // shared words it reads
  const int W = WT > 0 ? WT : W_rt;
  const int LT = k2_lane_tile(W), TC = k2_tile_cols(LT);
  extern __shared__ uint32_t k2_smem[];
  uint32_t* tgt = k2_smem;                               // TC / 4 words
  uint32_t* span = k2_smem + TC / 4;                     // (TC + LT) / 4 words
  const int p = blockIdx.x;
  const int ctr = band_centre(W, la_[p], lb_[p]);
  const uint8_t* ap = a + (size_t)p * La;
  const uint8_t* bp = b + (size_t)p * Lb;
  const int n_lane_tiles = (W + LT - 1) / LT;
  const int n_tiles = (MC + TC - 1) / TC * n_lane_tiles;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int jc0 = tile / n_lane_tiles * TC;
    const int l_lo = tile % n_lane_tiles * LT;
    const int lt = W - l_lo < LT ? W - l_lo : LT;        // this tile's lanes
    const int nc = MC - jc0 < TC ? MC - jc0 : TC;        // this tile's columns
    const int q0 = jc0 + l_lo - ctr;                     // query index of span byte 0
    __syncthreads();                                     // the last tile's reads are done
    for (int k = threadIdx.x; k < (TC + lt) / 4; k += K2_THREADS)
      span[k] = load_word(ap, q0 + 4 * k, La, PAD_BASE);
    for (int k = threadIdx.x; k < TC / 4; k += K2_THREADS)
      tgt[k] = load_word(bp, jc0 + 4 * k, Lb, PAD_TARGET);
    __syncthreads();
    // item i: column i / G, lanes l_lo + NB*(i % G) ..; a warp's store covers
    // 32 * NB contiguous bytes
    const int G = lt / NB;
    const int items = nc * G;
    const uint8_t* tgtb = reinterpret_cast<const uint8_t*>(tgt);
    for (int i = threadIdx.x; i < items; i += K2_THREADS) {
      const int c = i / G, g = i - c * G;
      const int w0 = (c >> 2) + g * (NB / 4);
      const uint32_t sh = 8 * (c & 3);
      uint32_t w[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = span[w0 + k];
      const uint32_t tc4 = tgtb[c] * 0x01010101u;
      uint32_t e[NB / 4];
#pragma unroll
      for (int k = 0; k < NB / 4; ++k) {
        const uint32_t q = __funnelshift_r(w[k], w[k + 1], sh);
        e[k] = bytes_ne(q, tc4) | ((q & 0x03030303u) << 1);
      }
      uint8_t* op = out + ((size_t)p * MC + jc0 + c) * W + l_lo + NB * g;
      if constexpr (NB == 16)
        __stcs(reinterpret_cast<uint4*>(op), make_uint4(e[0], e[1], e[2], e[3]));
      else
        __stcs(reinterpret_cast<unsigned int*>(op), e[0]);
    }
  }
}

// ------------------------------------------------- K1 and K3: pair tiling
// K1 and K3 hold a pair's band row in registers: thread t of the pair owns
// the V consecutive lanes t*V .. t*V+V-1. Below WIDE_MIN one warp runs a pair
// (V = W/32, WARPS_PER_BLOCK pairs per block); from WIDE_MIN one thread block
// of NW warps runs a pair, V_WIDE lanes per thread, and the steps that cross
// a warp boundary go through shared memory (the `if constexpr (NW > 1)`
// parts). A warp per pair walks V lanes serially per column, which sets the
// column time at large V (K1 took 2.68 us per column at V = 32, W = 1024).
constexpr int WARPS_PER_BLOCK = 4;
constexpr int V_WIDE = 8;

template <int W, int WIDE_MIN>
struct Tiling {
  static constexpr int V = W < WIDE_MIN ? W / 32 : V_WIDE;   // lanes per thread
  static constexpr int NW = W / V / 32;                     // warps per pair
  static constexpr int PAIRS = NW > 1 ? 1 : WARPS_PER_BLOCK; // pairs per block
  static constexpr int THREADS = 32 * NW * PAIRS;
  static int blocks(int PB) { return (PB + PAIRS - 1) / PAIRS; }
};

// This thread's pair p and its rank t within the pair; false for the warps of
// the last block that have no pair (whole warps only).
template <class T>
__device__ __forceinline__ bool pair_thread(int PB, int& p, int& t) {
  if constexpr (T::NW > 1) {
    p = blockIdx.x;
    t = threadIdx.x;
  } else {
    p = blockIdx.x * T::PAIRS + (threadIdx.x >> 5);
    t = threadIdx.x & 31;
  }
  return p < PB;
}

// Columns at or past ncol of a pair are OP_PAD bytes: one contiguous range of
// dirs, written 16 bytes a thread.
__device__ __forceinline__ void fill_pad(uint8_t* __restrict__ dp, int ncol, int MC,
                                         int W, int t, int nthreads) {
  const uint4 pad = make_uint4(0x03030303u, 0x03030303u, 0x03030303u, 0x03030303u);
  const size_t end = (size_t)MC * W;
  for (size_t o = (size_t)ncol * W + 16 * (size_t)t; o < end; o += 16 * (size_t)nthreads)
    *reinterpret_cast<uint4*>(dp + o) = pad;
}

// ------------------------------------------------------------ K1: forward
// Replaces _forward_kernel / banded_forward_pallas, and with it the work of
// _diag_kernel (necat_tpu/align/pallas_banded.py): static-band edit-distance
// DP of a[0:la] against b[0:lb], computing each cell's mismatch and query
// base itself from the pair's query and target rows, so that no [PB, MC, W]
// ENC buffer exists. Output: dirs bytes and the cost at (la, lb).
//
// Bound: the chain of up to 40960 dependent columns of one pair (a launch
// holds at most 1024 pairs, 8 warps per SM), so the design keeps every load
// from device memory off that chain:
//  - the thread's V query bases slide one lane per column; they live in
//    registers (Bytes<V>), and the one new base comes from the next thread
//    in the same __shfl_down_sync that brings the left neighbour's D
//    (D < 2^21, so D and the byte share one word);
//  - the bases that enter at each warp's last lane (the query byte one past
//    the warp's lanes) and the target base of the column are loaded for 32
//    columns at a time, one byte a lane, a tile ahead into registers, and
//    reach the column as one __shfl_sync;
//  - dirs rows are stored as V-byte vectors, neighbouring threads on
//    neighbouring bytes; columns past lb are one contiguous OP_PAD range.
// Per column the insertion chain (a prefix minimum over lanes) is a
// thread-local scan, a 5-step __shfl_up_sync warp scan and, with a block per
// pair, a __reduce_min_sync over the per-warp totals in shared memory. The
// block tiling needs one __syncthreads per column: the per-warp totals and
// first-lane x values sit in a double buffer (by column parity), and a
// warp's last lane rebuilds the next warp's first-lane D from them
// (D[l0] = min(prefix-min of x over lanes <= l0 + l0, INF)), so no second
// exchange is needed before the next column reads it.
template <int W>
__global__ void __launch_bounds__(Tiling<W, K1_WIDE_MIN>::THREADS)
banded_forward_kernel(const uint8_t* __restrict__ a, int La,
                      const uint8_t* __restrict__ b, int Lb,
                      const int* __restrict__ la_, const int* __restrict__ lb_,
                      uint8_t* __restrict__ dirs, int* __restrict__ cost, int PB, int MC) {
  using T = Tiling<W, K1_WIDE_MIN>;
  constexpr int V = T::V, NW = T::NW, NWD = Bytes<V>::N;
  constexpr int UNROLL = NW > 1 ? K1_UNROLL_BLOCK : K1_UNROLL_WARP;
  __shared__ int wtot[2][NW];     // inclusive insertion-scan total of each warp
  __shared__ int xfirst[2][NW];   // x of each warp's first lane
  int p, t;
  if (!pair_thread<T>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  const int la = la_[p], lb = lb_[p];
  const int ctr = band_centre(W, la, lb);
  const uint8_t* ap = a + (size_t)p * La;
  const uint8_t* bp = b + (size_t)p * Lb;
  uint8_t* dp = dirs + (size_t)p * MC * W;
  // query index of the byte that enters this warp's last lane at column jc
  // is edge0 + jc; the last warp's is the band's edge
  const int edge0 = (wp + 1) * 32 * V - 1 - ctr;
  auto qbyte = [&](int i) -> uint32_t { return (i >= 0 && i < La) ? ap[i] : PAD_BASE; };
  // lane k of the warp: target base and entering query base of column j0+k
  auto tile = [&](int j0) -> uint32_t {
    const int jc = j0 + lt;
    return (jc < Lb ? bp[jc] : PAD_TARGET) | (qbyte(edge0 + jc) << 8);
  };

  int D[V];
  Bytes<V> q;                     // query bases of this thread's lanes, column 0
#pragma unroll
  for (int k = 0; k < NWD; ++k) q.w[k] = 0;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int i0 = t * V + s - ctr;
    D[s] = (i0 >= 0 && i0 <= la) ? i0 : INF;
    q.w[s >> 2] |= qbyte(i0 - 1) << (8 * (s & 3));
  }
  const int l0 = (wp + 1) * 32 * V;   // first lane of the next warp
  int rnext = (l0 - ctr >= 0 && l0 - ctr <= la) ? l0 - ctr : INF;
  const int ncol = lb < MC ? lb : MC;
  uint32_t tq_next = tile(0);
  for (int j0 = 0; j0 < ncol; j0 += 32) {            // a tile of 32 columns
    const uint32_t tq_cur = tq_next;
    tq_next = tile(j0 + 32);
    const int nc = ncol - j0 < 32 ? ncol - j0 : 32;
#pragma unroll (UNROLL)
    for (int c = 0; c < nc; ++c) {
      const int j = j0 + c + 1;
      const uint32_t tq = __shfl_sync(FULL, tq_cur, c);
      const uint32_t pk = __shfl_down_sync(
          FULL, (uint32_t)D[0] | ((uint32_t)q.get(0) << D_BITS), 1);
      int right = pk & ((1u << D_BITS) - 1);          // D of lane t*V+V, last column
      uint32_t nb = pk >> D_BITS;                     // its query base
      if (lt == 31) {
        right = (NW > 1 && wp < NW - 1) ? rnext : INF;
        nb = tq >> 8;
      }
      q.shift_in(nb);
      uint32_t enc[NWD];                              // ENC bytes of this column
      const uint32_t tc4 = (tq & 0xff) * 0x01010101u;
#pragma unroll
      for (int k = 0; k < NWD; ++k)
        enc[k] = bytes_ne(q.w[k], tc4) | ((q.w[k] & 0x03030303u) << 1);

      int diag[V], left[V], x[V];
      bool outside[V];
      const int row = j - ctr + t * V;                // query row of lane t*V
#pragma unroll
      for (int s = 0; s < V; ++s) {
        const int i = row + s;
        diag[s] = D[s] + ((enc[s >> 2] >> (8 * (s & 3))) & 1);
        left[s] = (s < V - 1 ? D[s + 1] : right) + 1;
        int A = min(diag[s], left[s]);
        if (i == 0) A = j;                   // row 0: the all-deletion path
        outside[s] = (unsigned)i > (unsigned)la;      // i < 0 or i > la
        if (outside[s]) A = INF;
        x[s] = A - (t * V + s);
      }
      const int x0 = x[0];
      // insertion chain: D[l] = min_{m <= l} (A[m] + l - m) = lane + prefix-min(x)
#pragma unroll
      for (int s = 1; s < V; ++s) x[s] = min(x[s], x[s - 1]);
      int tot = x[V - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)          // lanes below off get their own
        tot = min(tot, __shfl_up_sync(FULL, tot, off));
      int before = __shfl_up_sync(FULL, tot, 1);      // min of x over lanes < t*V
      if (lt == 0) before = INF;
      if constexpr (NW > 1) {
        const int par = j & 1;
        if (lt == 31) wtot[par][wp] = tot;
        if (lt == 0) xfirst[par][wp] = x0;
        __syncthreads();
        const int cross = __reduce_min_sync(FULL, lt < wp ? wtot[par][lt] : INF);
        before = min(before, cross);
        if (lt == 31 && wp < NW - 1) {                  // D of lane l0, this column
          const int i = j - ctr + l0;
          rnext = (i < 0 || i > la) ? INF
                : min(min(min(cross, tot), xfirst[par][wp + 1]) + l0, INF);
        }
      }
      int Dn[V];
#pragma unroll
      for (int s = 0; s < V; ++s)
        Dn[s] = outside[s] ? INF : min(min(x[s], before) + t * V + s, INF);
      int up;                                           // Dn of lane t*V-1
      if constexpr (NW > 1) {                           // from `before`: no exchange
        const bool out = t == 0 || (unsigned)(row - 1) > (unsigned)la;  // lane t*V-1
        up = out ? INF : min(before + t * V - 1, INF);
      } else {
        up = __shfl_up_sync(FULL, Dn[V - 1], 1);
        if (t == 0) up = INF;
      }
      Bytes<V> out;
#pragma unroll
      for (int k = 0; k < NWD; ++k) out.w[k] = enc[k] << 2;
#pragma unroll
      for (int s = 0; s < V; ++s) {
        const int upv = (s == 0 ? up : Dn[s - 1]) + 1;
        // diag before ins before del, as selects (nested ?: compiled to branches)
        uint32_t op = Dn[s] == left[s] ? OP_DEL : OP_PAD;
        op = Dn[s] == upv ? OP_INS : op;
        op = Dn[s] == diag[s] ? OP_DIAG : op;
        out.w[s >> 2] |= op << (8 * (s & 3));
        D[s] = Dn[s];
      }
      out.store(dp + (size_t)(j - 1) * W + t * V);
    }
  }
  fill_pad(dp, ncol > 0 ? ncol : 0, MC, W, t, 32 * NW);

  const int l_end = clampi(la - lb + ctr, 0, W - 1);
#pragma unroll
  for (int s = 0; s < V; ++s)
    if (t * V + s == l_end) cost[p] = D[s];
}

// ---------------------------------------------------------- K3: backtrack
// Replaces _backtrack_kernel / banded_backtrack_cols
// (necat_tpu/align/pallas_banded.py): walks from (la, lb) back one target
// column per step and emits the per-column encoding and insb words.
// Bound: latency. Every step depends on the previous step's slot `cur`, so
// the design keeps the step short:
//  - the dirs rows of the columns ahead (their addresses do not depend on
//    the walk) stream into a shared-memory ring of 2 x H rows per pair with
//    cp.async, one half in flight while the other is walked; a thread's V
//    bytes of the next row are read from the ring one step ahead;
//  - the run of insertions under `cur` ends at sel, the highest non-INS lane
//    at or below it; each thread packs (its candidate lane + 1) << 8 | its
//    byte there, so one __reduce_max_sync (and with a block per pair a
//    second one over the warps' maxima in a parity double buffer, one
//    __syncthreads per step) gives both sel and the byte at sel, with no
//    dependent load;
//  - the inserted bases of the run are read from the ring row by lanes 0..20
//    of one warp (rank d+1 from the run start, rank d from its end) and
//    packed with one __reduce_or_sync per insb word;
//  - lane s%32 keeps step s's cols and insb words, and each 32 steps the
//    warp stores them as one coalesced 128-byte store per output.
template <int W>
__global__ void __launch_bounds__(Tiling<W, K3_WIDE_MIN>::THREADS)
banded_backtrack_kernel(const uint8_t* __restrict__ dirs, const int* __restrict__ la_,
                        const int* __restrict__ lb_, int* __restrict__ cols,
                        int* __restrict__ insb, int* __restrict__ lead, int PB,
                        int MC, int words) {
  using T = Tiling<W, K3_WIDE_MIN>;
  constexpr int V = T::V, NW = T::NW;
  constexpr int H = 16384 / (W * T::PAIRS) < 16 ? 16384 / (W * T::PAIRS) : 16;
  constexpr int RING = 2 * H;                      // rows: <= 32 KB of ring a block
  constexpr int PIECES = H * W / 16;               // 16-byte copies per half
  __shared__ __align__(16) uint8_t ring_all[T::PAIRS][RING][W];
  __shared__ int wkey[2][NW];
  int p, t;
  if (!pair_thread<T>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  uint8_t (*ring)[W] = ring_all[NW > 1 ? 0 : (threadIdx.x >> 5)];
  const int la = la_[p], lb = lb_[p];
  const int ctr = band_centre(W, la, lb);
  const uint8_t* dp = dirs + (size_t)p * MC * W;
  int* cp = cols + (size_t)p * MC;
  const int ncol = lb < MC ? lb : MC;
  for (int jc = (ncol > 0 ? ncol : 0) + t; jc < MC; jc += 32 * NW) {
    cp[jc] = OP_PAD;
    for (int w = 0; w < words; ++w) insb[((size_t)w * PB + p) * MC + jc] = 0;
  }
  auto sync = [&] {
    if constexpr (NW > 1) __syncthreads(); else __syncwarp();
  };
  // walk steps chunk*H .. chunk*H+H-1 (rows ncol-1-step) into ring half chunk%2
  auto fetch = [&](int chunk) {
    for (int k = t; k < PIECES; k += 32 * NW) {
      const int i = k / (W / 16), off = (k % (W / 16)) * 16;
      const int s = chunk * H + i, r = ncol - 1 - s;
      if (r >= 0) cp_async16(&ring[s % RING][off], dp + (size_t)r * W + off);
    }
    cp_async_commit();
  };

  int cur = clampi(la - lb + ctr, 0, W - 1);
  Bytes<V> vn;
  if (ncol > 0) {
    fetch(0);
    fetch(1);
    cp_async_wait_one_pending();
    sync();
    vn.load(&ring[0][t * V]);
  }
  const bool emits = NW == 1 || wp == 0;          // the warp that writes cols/insb
  int colv = 0, insv0 = 0, insv1 = 0, insv2 = 0;  // lane s%32 keeps step s
  for (int s = 0; s < ncol; ++s) {
    const int j = ncol - s;                         // 1-based column
    const Bytes<V> v = vn;
    const bool boundary = s + 1 < ncol && (s + 1) % H == 0;
    if (s + 1 < ncol && !boundary) vn.load(&ring[(s + 1) % RING][t * V]);
    int key = 0;                                    // (lane + 1) << 8 | byte
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int lane = t * V + u, byte = v.get(u);
      if (lane <= cur && (byte & 3) != OP_INS) key = ((lane + 1) << 8) | byte;
    }
    key = __reduce_max_sync(FULL, key);
    if constexpr (NW > 1) {
      const int par = s & 1;
      if (lt == 0) wkey[par][wp] = key;
      __syncthreads();
      key = __reduce_max_sync(FULL, lt < NW ? wkey[par][lt] : 0);
    }
    const int sel = (key >> 8) - 1, vsel = key & 0xff;   // sel -1: all INS
    const int k = cur - sel;
    int o = vsel & 3;
    if (j - ctr + sel <= 0) o = OP_DEL;              // row 0: all-deletion border
    if (emits) {
      const int match = o == OP_DIAG ? 1 - ((vsel >> 2) & 1) : 0;
      const int qbase = o == OP_DIAG ? (vsel >> 3) & 3 : 0;
      const int c = s & 31;
      if (lt == c) colv = (k << 5) | (qbase << 3) | (match << 2) | o;
      // lane d: run rank d+1 from the start (lane sel+d+1) and rank d from
      // the end (lane cur-d), both into word d/7
      const int kc = min(k, N_INSB * words);
      const uint8_t* row = ring[s % RING];
      unsigned bits = 0;
      if (lt < kc) {
        const int d = lt % N_INSB;
        bits = ((row[sel + 1 + lt] >> 3) & 3u) << (2 * d)
             | ((row[cur - lt] >> 3) & 3u) << (14 + 2 * d);
      }
      const int wd = lt / N_INSB;
      const unsigned b0 = __reduce_or_sync(FULL, wd == 0 ? bits : 0u);
      if (lt == c) insv0 = (int)b0;
      if (words > 1) {
        const unsigned b1 = __reduce_or_sync(FULL, wd == 1 ? bits : 0u);
        if (lt == c) insv1 = (int)b1;
      }
      if (words > 2) {
        const unsigned b2 = __reduce_or_sync(FULL, wd == 2 ? bits : 0u);
        if (lt == c) insv2 = (int)b2;
      }
      if (c == 31 || s == ncol - 1) {                // the tile's columns, one store each
        if (lt <= c) {
          const int jc = ncol - 1 - (s - c + lt);
          cp[jc] = colv;
          insb[(size_t)p * MC + jc] = insv0;
          if (words > 1) insb[((size_t)PB + p) * MC + jc] = insv1;
          if (words > 2) insb[((size_t)2 * PB + p) * MC + jc] = insv2;
        }
      }
    }
    cur = clampi(o == OP_DIAG ? sel : sel + 1, 0, W - 1);
    if (boundary) {                                   // next half landed; refill this one
      cp_async_wait_all();
      sync();
      fetch((s + 1) / H + 1);
      vn.load(&ring[(s + 1) % RING][t * V]);
    }
  }
  if (t == 0) lead[p] = clampi(cur - ctr, 0, la);
}

// ------------------------------------------- K1a: adaptive-band forward
// Replaces the scan of necat_tpu/align/banded.py:banded_forward (:48), the
// JAX package's extension without Pallas (NECAT_TPU_NO_PALLAS): XLA code, no
// pallas_call. ROW coordinates: lane s of column j holds query row
// offs[j] + s. Before column j the band moves d = 0, 1 or 2 rows toward the
// argmin third of column j-1 (d = 0 at column 1), off = clip(off + d, 0,
// max(la, 0)); columns past lb are OP_PAD and freeze S and off. Output: dirs
// bytes (the op alone), offs[0..MC], the last column's S, and the cost at
// (la, lb). The arithmetic is the JAX scan's: INF = 2^20, neighbours outside
// [0, W) read INF (so INF + 1 reaches the op compares), the chain clamped to
// INF, rows past la set to INF, ties DIAG, then INS, then DEL, else PAD.
//
// Bound: as K1's, the chain of up to MC dependent columns of one pair, at
// about 8 warps per SM (a launch holds at most 1024 pairs); the roofline
// (dirs written once: bytes) is about 10 times below it. A first version
// had four things on that chain that K1's lacks: the last column's S
// through a shared-memory row and a __syncwarp, a dependent two-step argmin,
// a global query load a lane after it, and two barriers a column with a
// block per pair. This design keeps K1's tiling and chain (a warp per
// pair below K1_WIDE_MIN, a block of W/8 threads from it; thread t holds
// lanes l0 = t*V .. l0+V-1) and puts the band's shift beside the chain:
//  - the last column's neighbours come by shuffles: the shift d is the same
//    for the whole pair, so lane l0+s reads the last column at l0+s+d (left)
//    and l0+s+d-1 (diagonal), i.e. the thread's own V values, the value of
//    lane l0-1 (rebuilt from the chain's `before`, no exchange) and the
//    first two of thread t+1 (two __shfl_down_sync at the top of the
//    column, which do not wait for d), picked by d with two selects each;
//  - the band decision, not the argmin: d is the third (0, 1, 2 for lanes
//    [0, W/3], (W/3, 2W/3], (2W/3, W)) of the first argmin m of S. Lane l's
//    "local" value, its thread's prefix-min of x + l, is at least S[l] (or,
//    past la, above a smaller value of an earlier lane) and equals S[m] at m,
//    and an earlier lane's is above S[m]. So the least of min(local, INF)
//    << 2 | third over the lanes carries m's third in its two low bits: one
//    multiply-add and one min a lane, then one __reduce_min_sync, issued
//    before the scan and needing nothing of it (the first version took two
//    dependent reductions for the value and the first lane). With a block
//    per pair each warp publishes its key in the same parity-buffered shared
//    write as its chain total and its first two prefix values: one
//    __syncthreads per column (the first version: two);
//  - the query bases stay off the chain: a thread's V bases slide by d in
//    registers (a funnel shift), those of thread t+1 come by one more
//    shuffle, and those entering a warp's last lane from a window of the
//    query row past the warp, a byte pair a lane, read with one __shfl_sync
//    a column; it moves 16 bytes at a time and its next pairs are loaded 8
//    or more columns ahead (a load in the column stalled the warp every
//    column: 0.7 of 3.6 ms at W = 128, L = 8192 on an H100 80GB HBM3 at
//    700 W, scripts/torch_kernel_ab.py). Across a warp boundary the last lane
//    rebuilds the next warp's first two S values from the published values,
//    as K1 does; offs are stored 32 columns at a time.
// Where the window moves is set per tiling, as measured (ptxas schedules the
// column differently): with a warp per pair right after the shift, with a
// block at the end of the column (PERF.md).
constexpr int K1A_BIG = 1 << 30;   // identity of the minima: above every x (<= INF + 1)

template <int W>
__global__ void __launch_bounds__(Tiling<W, K1_WIDE_MIN>::THREADS)
banded_forward_adaptive_kernel(const uint8_t* __restrict__ a, int La,
                               const uint8_t* __restrict__ b, int Lb,
                               const int* __restrict__ la_, const int* __restrict__ lb_,
                               uint8_t* __restrict__ dirs, int* __restrict__ offs,
                               int* __restrict__ sfin, int* __restrict__ cost, int PB,
                               int MC) {
  using T = Tiling<W, K1_WIDE_MIN>;
  constexpr int V = T::V, NW = T::NW, NWD = Bytes<V>::N;
  constexpr int UNROLL = NW > 1 ? K1_UNROLL_BLOCK : K1_UNROLL_WARP;
  constexpr int R1 = W / 3 + 1, R2 = (2 * W) / 3 + 1;   // first lanes of thirds 1 and 2
  static_assert(V >= 2, "lanes l0 + V and l0 + V + 1 are thread t+1's");
  __shared__ int wtot[2][NW];        // inclusive chain total of each warp
  __shared__ int xfirst[2][2][NW];   // prefix-min of x at each warp's first two lanes
  __shared__ int wkey[2][NW];        // each warp's band-decision key
  int p, t;
  if (!pair_thread<T>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  const int la = la_[p], lb = lb_[p];
  const int off_hi = la > 0 ? la : 0;
  const uint8_t* ap = a + (size_t)p * La;
  const uint8_t* bp = b + (size_t)p * Lb;
  uint8_t* dp = dirs + (size_t)p * MC * W;
  int* offp = offs + (size_t)p * (MC + 1);
  const int l0 = t * V;                         // this thread's first lane
  const int l_end = (wp + 1) * 32 * V;          // the first lane past this warp
  const bool inner = NW > 1 && wp < NW - 1;     // a warp with another after it
  // query base a[i], clipped to [0, La) as the JAX scan clips it (lane l of a
  // column holds row off + l and compares a[off + l - 1])
  auto qa = [&](int i) -> uint32_t { return __ldg(ap + clampi(i, 0, La - 1)); };
  // lane k of the warp: the target base of column j0 + k + 1, clipped
  auto tile = [&](int j0) -> int { return __ldg(bp + clampi(j0 + lt, 0, Lb - 1)); };
  // the band decision: lane l0 + s's key, min(local value, INF) << 2 | its
  // third, is min(4 * x[s] + kc[s], 4 * INF + third); over the thread the
  // clamp is kinf, its first lane's
  int kc[V];
#pragma unroll
  for (int s = 0; s < V; ++s) kc[s] = 4 * (l0 + s) + (l0 + s >= R1) + (l0 + s >= R2);
  const int kinf = 4 * INF + (l0 >= R1) + (l0 >= R2);

  int D[V];                        // S of the last column
  Bytes<V> q;                      // q[s] = a[off + l0 + s - 1]
#pragma unroll
  for (int k = 0; k < NWD; ++k) q.w[k] = 0;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    D[s] = l0 + s <= la ? l0 + s : INF;
    q.w[s >> 2] |= qa(l0 + s - 1) << (8 * (s & 3));
  }
  int sup = (t == 0 || l0 - 1 > la) ? INF : l0 - 1;          // S of lane l0 - 1
  int rn0 = inner && l_end <= la ? l_end : INF;              // S of lanes l_end and
  int rn1 = inner && l_end + 1 <= la ? l_end + 1 : INF;      // l_end + 1 (lane 31)
  // the bases entering the warp's last lane, a[off + l_end - 1 + e] for e = 0,
  // 1, come from a window of the query row past the warp's lanes: lane k
  // holds a[wb + k] | a[wb + k + 1] << 8; the window moves 16 bytes at a
  // time, and the pairs of its next 16 are loaded 8 or more columns before
  // they are read
  int wb = l_end - 1;                                        // the window's first byte
  uint32_t win = qa(wb + lt) | qa(wb + lt + 1) << 8;
  uint32_t nx0 = qa(wb + 16 + lt) | qa(wb + 17 + lt) << 8;  // the next 16
  int dkey = 0;                    // the last column's band-decision key (d = 0 first)
  int off = 0, off_kept = 0;       // lane c keeps column j0 + c + 1's off
  if (t == 0) offp[0] = 0;
  // after column j0 + c + 1's shift: keep its off, move the window (the
  // same for the whole warp) once off has gone 16 rows past its start
  auto move_window = [&](int c) {
    if (lt == c) off_kept = off;
    if (off + l_end - 1 - wb >= 16) {
      wb += 16;
      win = nx0;
      nx0 = qa(wb + 16 + lt) | qa(wb + 17 + lt) << 8;
    }
  };
  const int ncol = lb < MC ? (lb > 0 ? lb : 0) : MC;
  int tb_next = tile(0);
  for (int j0 = 0; j0 < ncol; j0 += 32) {            // a tile of 32 columns
    const int tb_cur = tb_next;
    tb_next = tile(j0 + 32);
    const int nc = ncol - j0 < 32 ? ncol - j0 : 32;
#pragma unroll (UNROLL)
    for (int c = 0; c < nc; ++c) {
      const int j = j0 + c + 1;
      const uint32_t tb4 = (uint32_t)__shfl_sync(FULL, tb_cur, c) * 0x01010101u;
      // lanes l0 + V and l0 + V + 1 of the last column (S) and their bases
      int n0 = __shfl_down_sync(FULL, D[0], 1);
      int n1 = __shfl_down_sync(FULL, D[1], 1);
      uint32_t nb = __shfl_down_sync(FULL, q.w[0], 1);        // bytes 0 and 1
      const uint32_t enter = __shfl_sync(FULL, win, off + l_end - 1 - wb);
      if (lt == 31) {
        n0 = rn0;
        n1 = rn1;
        nb = enter;
      }
      // the shift toward the argmin third of the last column
      const int dd = dkey & 3;
      const int off_n = min(off + dd, off_hi);
      const int d = off_n - off;
      off = off_n;
      if constexpr (NW == 1) move_window(c);         // here with a warp: faster
      {                                               // slide the bases by d
        uint32_t ext[NWD + 1];
#pragma unroll
        for (int k = 0; k < NWD; ++k) ext[k] = q.w[k];
        if constexpr (V % 4 == 0) {
          ext[NWD] = nb;
        } else {
          ext[NWD - 1] |= nb << (8 * (V % 4));
          ext[NWD] = 0;
        }
#pragma unroll
        for (int k = 0; k < NWD; ++k) q.w[k] = __funnelshift_r(ext[k], ext[k + 1], 8 * d);
        if constexpr (V % 4 != 0) q.w[NWD - 1] &= (1u << (8 * (V % 4))) - 1;
      }
      int Sd[V + 1];                                  // S of lane l0 + i + d - 1, last column
      {
        int Sx[V + 3];                                // lanes l0 - 1 .. l0 + V + 1
        Sx[0] = sup;
#pragma unroll
        for (int s = 0; s < V; ++s) Sx[s + 1] = D[s];
        Sx[V + 1] = n0;
        Sx[V + 2] = n1;
#pragma unroll
        for (int i = 0; i <= V; ++i) Sd[i] = d == 0 ? Sx[i] : (d == 1 ? Sx[i + 1] : Sx[i + 2]);
      }
      uint32_t ne[NWD];                               // 1 per query byte != target
#pragma unroll
      for (int k = 0; k < NWD; ++k) ne[k] = bytes_ne(q.w[k], tb4);
      int diag[V], left[V], x[V];
      bool outside[V];
      const int last_in = la - off;                   // lanes past it are rows past la
#pragma unroll
      for (int s = 0; s < V; ++s) {
        left[s] = Sd[s + 1] + 1;
        diag[s] = Sd[s] + (int)((ne[s >> 2] >> (8 * (s & 3))) & 1);
        if (s == 0 && off + l0 == 0) diag[s] = INF;  // row 0
        int A = min(left[s], diag[s]);
        outside[s] = l0 + s > last_in;
        if (outside[s]) A = INF;
        x[s] = A - (l0 + s);
      }
      // insertion chain: S[l] = min(lane + prefix-min of x, INF)
#pragma unroll
      for (int s = 1; s < V; ++s) x[s] = min(x[s], x[s - 1]);
      const int xt = x[V - 1];
      // the band decision's key: the least of the lanes' keys, whose low two
      // bits are the third of the column's first argmin
      int key = kinf;
#pragma unroll
      for (int s = 0; s < V; ++s) key = min(key, 4 * x[s] + kc[s]);
      dkey = __reduce_min_sync(FULL, key);
      int tot = xt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) tot = min(tot, __shfl_up_sync(FULL, tot, o));
      int before = __shfl_up_sync(FULL, tot, 1);      // min of x over lanes < l0
      if (lt == 0) before = K1A_BIG;
      if constexpr (NW > 1) {
        const int par = j & 1;
        if (lt == 31) wtot[par][wp] = tot;
        if (lt == 0) {
          xfirst[par][0][wp] = x[0];
          xfirst[par][1][wp] = x[1];
          wkey[par][wp] = dkey;
        }
        __syncthreads();
        const int cross = __reduce_min_sync(FULL, lt < wp ? wtot[par][lt] : K1A_BIG);
        dkey = __reduce_min_sync(FULL, lt < NW ? wkey[par][lt] : K1A_BIG);
        before = min(before, cross);
        if (lt == 31 && inner) {                      // lanes l_end, l_end + 1, this column
          const int C = min(cross, tot);
          rn0 = off + l_end > la ? INF : min(min(C, xfirst[par][0][wp + 1]) + l_end, INF);
          rn1 = off + l_end + 1 > la ? INF
              : min(min(C, xfirst[par][1][wp + 1]) + l_end + 1, INF);
        }
      }
      int Sn[V];
#pragma unroll
      for (int s = 0; s < V; ++s)
        Sn[s] = outside[s] ? INF : min(min(x[s], before) + l0 + s, INF);
      // S of lane l0 - 1 (its prefix is `before`); lane 0's up is INF itself
      sup = (t == 0 || l0 - 1 > last_in) ? INF : min(before + l0 - 1, INF);
      const int up0 = t == 0 ? INF : sup + 1;
      Bytes<V> out;
#pragma unroll
      for (int k = 0; k < NWD; ++k) out.w[k] = 0;
#pragma unroll
      for (int s = 0; s < V; ++s) {
        const int up = s == 0 ? up0 : Sn[s - 1] + 1;
        uint32_t op = Sn[s] == left[s] ? OP_DEL : OP_PAD;
        op = Sn[s] == up ? OP_INS : op;
        op = Sn[s] == diag[s] ? OP_DIAG : op;
        out.w[s >> 2] |= op << (8 * (s & 3));
        D[s] = Sn[s];
      }
      out.store(dp + (size_t)(j - 1) * W + l0);
      if constexpr (NW > 1) move_window(c);          // here with a block: faster
    }
    if (t < nc) offp[j0 + 1 + t] = off_kept;
  }
  for (int j = ncol + 1 + t; j <= MC; j += 32 * NW) offp[j] = off;
  fill_pad(dp, ncol, MC, W, t, 32 * NW);
  const int slot = clampi(la - off, 0, W - 1);
#pragma unroll
  for (int s = 0; s < V; ++s) {
    sfin[(size_t)p * W + l0 + s] = D[s];
    if (l0 + s == slot) cost[p] = D[s];
  }
}

// -------------------------------------- K3a: adaptive-band column backtrack
// Replaces banded_traceback (:112) + ops_to_cols (:181) of
// necat_tpu/align/banded.py (XLA code, no pallas_call): walks K1a's dirs and
// offs from (la, lb) back to (0, 0) and writes the per-column encoding
// directly: cols = op | match << 2 | qbase << 3 | k << 5, 1-3 insb words,
// lead. The op walk it stands for reads slot clip(r - offs[j], 0, W-1) of
// column j, forces DEL on row 0 and INS on column 0, and stops for good on
// an OP_PAD byte; ops_to_cols then counts columns and query rows from the
// start of the op string, i.e. from where the walk stopped. So the kernel
// walks twice only when a walk stops on OP_PAD before (0, 0): the second
// walk numbers columns and rows from that stop.
//
// Bound: as K3's, latency: each step depends on the last step's row, at
// about 8 warps per SM; the roofline (live dirs rows read once: bytes) is
// about 10 times below it. A first version loaded the DIAG's query
// base and two query bytes a lane for the insertion run on every step and
// fed them to 1-3 __reduce_or_sync, so each step waited on a load. This
// design runs K3's loop: one step per target column, the dirs rows streamed
// into K3's shared-memory ring (cp.async, a half ahead), and a step does
// only what decides the walk. The column's insertion run under the entry
// row r ends at the highest "stop" lane <= clip(r - off, 0, W-1), a lane
// whose op is not INS or that holds row 0; one __reduce_max_sync of (lane +
// 1) << 8 | byte finds it (with a block per pair a second over the warps'
// maxima, one __syncthreads a step). The clipped slot is read as the op walk
// reads it: a stop at the clipped slot itself is the consumer at row r. The
// step leaves its (op, consumer row, entry row) in the registers of lane
// s % 32. The steps run in tiles of 32, as K1's columns do: offs come a tile
// ahead, a lane each, and after a tile (or a stop) each lane builds its own
// column's cols word and insb words from a and b (adaptive dirs carry the op
// alone): match, the query base and up to 7 * words bases from each end of
// its run, its loads in flight with those of the other 31 lanes and no warp
// reduction, then stores them coalesced. (Built inside the step loop, the
// stores' addresses were computed on every step.)
template <int W>
__global__ void __launch_bounds__(Tiling<W, K3_WIDE_MIN>::THREADS)
adaptive_backtrack_kernel(const uint8_t* __restrict__ dirs, const int* __restrict__ offs,
                          const uint8_t* __restrict__ a, int La,
                          const uint8_t* __restrict__ b, int Lb,
                          const int* __restrict__ la_, const int* __restrict__ lb_,
                          int* __restrict__ cols, int* __restrict__ insb,
                          int* __restrict__ lead, int PB, int MC, int words) {
  using T = Tiling<W, K3_WIDE_MIN>;
  constexpr int V = T::V, NW = T::NW;
  constexpr int H = 16384 / (W * T::PAIRS) < 16 ? 16384 / (W * T::PAIRS) : 16;
  constexpr int RING = 2 * H;
  constexpr int PIECES = H * W / 16;
  constexpr int ROW_BITS = 28;                    // a kept step: row | op << ROW_BITS
  __shared__ __align__(16) uint8_t ring_all[T::PAIRS][RING][W];
  __shared__ int wkey[2][NW];
  int p, t;
  if (!pair_thread<T>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  uint8_t (*ring)[W] = ring_all[NW > 1 ? 0 : (threadIdx.x >> 5)];
  const int la = la_[p], lb = lb_[p];
  const uint8_t* dp = dirs + (size_t)p * MC * W;
  const int* offp = offs + (size_t)p * (MC + 1);
  const uint8_t* ap = a + (size_t)p * La;
  const uint8_t* bp = b + (size_t)p * Lb;
  int* cp = cols + (size_t)p * MC;
  const int ncol = lb < MC ? (lb > 0 ? lb : 0) : MC;
  const int l0 = t * V;
  auto sync = [&] {
    if constexpr (NW > 1) __syncthreads(); else __syncwarp();
  };
  auto fill = [&](int from) {            // columns from `from` on: OP_PAD, no bases
    for (int jc = from + t; jc < MC; jc += 32 * NW) {
      cp[jc] = OP_PAD;
      for (int w = 0; w < words; ++w) insb[((size_t)w * PB + p) * MC + jc] = 0;
    }
  };
  auto fetch = [&](int chunk) {          // steps chunk*H .. into ring half chunk%2
    for (int k = t; k < PIECES; k += 32 * NW) {
      const int i = k / (W / 16), o = (k % (W / 16)) * 16;
      const int s = chunk * H + i, row = ncol - 1 - s;
      if (row >= 0) cp_async16(&ring[s % RING][o], dp + (size_t)row * W + o);
    }
    cp_async_commit();
  };
  const bool emits = NW == 1 || wp == 0;   // the warp that writes cols and insb
  fill(ncol);
  int r0 = 0, j0 = 0;                      // where column and row numbering start
  int r0_next = 0, j0_next = 0;            // ... from a stop on, in the second walk
  int lead_v = 0;
  // the query base of walk row i + 1 (rows counted from r0), clipped
  auto qa = [&](int i) -> uint32_t { return __ldg(ap + clampi(i - r0, 0, La - 1)); };
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {                       // renumber from the stop: start afresh
      sync();
      fill(0);
      sync();
    }
    Bytes<V> vn;
    if (ncol > 0) {
      fetch(0);
      fetch(1);
      cp_async_wait_one_pending();
      sync();
      vn.load(&ring[0][l0]);
    }
    int r = la;
    bool stopped = false;
    int kept_row = 0, kept_r = 0;          // lane s%32: step s's row | op << 28, entry row
    int tile_next = offp[ncol - lt > 0 ? ncol - lt : 0];   // offs of steps lt, lt + 32, ..
    for (int s0 = 0; s0 < ncol && !stopped; s0 += 32) {     // a tile of 32 steps
      const int tile_off = tile_next;
      const int jn = ncol - s0 - 32 - lt;
      tile_next = offp[jn > 0 ? jn : 0];
      const int nc = ncol - s0 < 32 ? ncol - s0 : 32;
      int kept = nc;                                   // steps of this tile to store
      for (int c = 0; c < nc; ++c) {
        const int s = s0 + c, j = ncol - s;            // j: the 1-based column
        const Bytes<V> v = vn;
        const bool boundary = s + 1 < ncol && (s + 1) % H == 0;
        if (s + 1 < ncol && !boundary) vn.load(&ring[(s + 1) % RING][l0]);
        const int off = __shfl_sync(FULL, tile_off, c);
        const int cur = clampi(r - off, 0, W - 1);
        int key = 0;                                   // (lane + 1) << 8 | byte
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int lane = l0 + u, byte = v.get(u);
          bool stop = (byte & 3) != OP_INS;
          if (u == 0) stop = stop || (l0 == 0 && off == 0);   // row 0
          if (lane <= cur && stop) key = ((lane + 1) << 8) | byte;
        }
        key = __reduce_max_sync(FULL, key);
        if constexpr (NW > 1) {
          const int par = s & 1;
          if (lt == 0) wkey[par][wp] = key;
          __syncthreads();
          key = __reduce_max_sync(FULL, lt < NW ? wkey[par][lt] : 0);
        }
        const int sel = (key >> 8) - 1;
        // the consumer's row: the stop lane's, row r for a stop where the
        // walk reads, row 0 past the run's bottom or at r = 0 (then DEL)
        int row = sel >= 0 ? off + sel : 0;
        if (sel == cur) row = r;
        if (r == 0) row = 0;
        const int o = row == 0 ? OP_DEL : (key & 3);
        if (o == OP_PAD) {                             // the op walk stops here
          kept = c;
          lead_v = r - row;
          r0_next = row;
          j0_next = j;
          stopped = true;
          break;
        }
        if (lt == c) {
          kept_row = row | (o << ROW_BITS);
          kept_r = r;
        }
        r = o == OP_DIAG ? row - 1 : row;
        if (boundary) {                                // next half landed; refill this one
          cp_async_wait_all();
          sync();
          fetch((s + 1) / H + 1);
          vn.load(&ring[(s + 1) % RING][l0]);
        }
      }
      if (emits && lt < kept) {                        // this tile's columns, lane c step s0 + c
        const int o = kept_row >> ROW_BITS, row = kept_row & ((1 << ROW_BITS) - 1);
        const int k = kept_r - row;                    // the run: rows row+1 .. kept_r
        const int jc = ncol - 1 - (s0 + lt) - j0;
        int match = 0, qbase = 0;
        if (o == OP_DIAG) {
          qbase = (int)qa(row - 1);
          match = qbase == (int)__ldg(bp + clampi(jc, 0, Lb - 1));
        }
        cp[jc] = (k << 5) | (qbase << 3) | (match << 2) | o;
        // run rank i+1 from the start (row + i + 1) and from the end (kept_r - i)
        unsigned ins[3] = {0u, 0u, 0u};
#pragma unroll
        for (int w = 0; w < 3; ++w) {
#pragma unroll
          for (int d = 0; d < N_INSB; ++d) {
            const int i = N_INSB * w + d;
            if (w < words && i < k)
              ins[w] |= qa(row + i) << (2 * d) | qa(kept_r - i - 1) << (14 + 2 * d);
          }
        }
        insb[(size_t)p * MC + jc] = (int)ins[0];
        if (words > 1) insb[((size_t)PB + p) * MC + jc] = (int)ins[1];
        if (words > 2) insb[((size_t)2 * PB + p) * MC + jc] = (int)ins[2];
      }
    }
    cp_async_wait_all();
    if (!stopped) {
      lead_v = r - r0;                                 // INS on column 0
      break;
    }
    if (pass == 1) break;
    r0 = r0_next;
    j0 = j0_next;
  }
  if (t == 0) lead[p] = lead_v;
}

// Launch<W>::run for a width of KERNEL_WIDTHS; any other width runs
// Launch<0> where the launcher has one, else is refused.
template <template <int> class Launch, typename... Args>
int dispatch_width(int W, Args... args) {
  switch (W) {
    case 64: Launch<64>::run(args...); break;
    case 128: Launch<128>::run(args...); break;
    case 256: Launch<256>::run(args...); break;
    case 512: Launch<512>::run(args...); break;
    case 1024: Launch<1024>::run(args...); break;
    case 2048: Launch<2048>::run(args...); break;
    case 4096: Launch<4096>::run(args...); break;
    default:
      if constexpr (Launch<0>::ANY_WIDTH) Launch<0>::run(args...);
      else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2: a block per (pair, tile); pairs on gridDim.x, tiles on gridDim.y (a
// block walks tiles gridDim.y apart when there are more than 65535).
template <int WT>
struct DiagLaunch {
  static constexpr bool ANY_WIDTH = true;
  static void run(const uint8_t* a, int La, const uint8_t* b, int Lb, const int* la,
                  const int* lb, uint8_t* out, int PB, int MC, int W, cudaStream_t s) {
    const int LT = k2_lane_tile(W), TC = k2_tile_cols(LT);
    const long long tiles = (long long)((MC + TC - 1) / TC) * ((W + LT - 1) / LT);
    const dim3 grid(PB, (unsigned)(tiles < 65535 ? tiles : 65535));
    const size_t smem = (size_t)(2 * TC + LT);               // targets and query span
    diag_sub_matrix_kernel<WT><<<grid, K2_THREADS, smem, s>>>(a, La, b, Lb, la, lb, out,
                                                               MC, W);
  }
};

template <int W>
struct ForwardLaunch {
  static constexpr bool ANY_WIDTH = false;
  static void run(const uint8_t* a, int La, const uint8_t* b, int Lb, const int* la,
                  const int* lb, uint8_t* dirs, int* cost, int PB, int MC, cudaStream_t s) {
    using T = Tiling<W, K1_WIDE_MIN>;
    banded_forward_kernel<W><<<T::blocks(PB), T::THREADS, 0, s>>>(
        a, La, b, Lb, la, lb, dirs, cost, PB, MC);
  }
};

template <int W>
struct BacktrackLaunch {
  static constexpr bool ANY_WIDTH = false;
  static void run(const uint8_t* dirs, const int* la, const int* lb, int* cols,
                  int* insb, int* lead, int PB, int MC, int words, cudaStream_t s) {
    using T = Tiling<W, K3_WIDE_MIN>;
    banded_backtrack_kernel<W><<<T::blocks(PB), T::THREADS, 0, s>>>(
        dirs, la, lb, cols, insb, lead, PB, MC, words);
  }
};

template <int W>
struct ForwardAdaptiveLaunch {
  static constexpr bool ANY_WIDTH = false;
  static void run(const uint8_t* a, int La, const uint8_t* b, int Lb, const int* la,
                  const int* lb, uint8_t* dirs, int* offs, int* sfin, int* cost, int PB,
                  int MC, cudaStream_t s) {
    using T = Tiling<W, K1_WIDE_MIN>;
    banded_forward_adaptive_kernel<W><<<T::blocks(PB), T::THREADS, 0, s>>>(
        a, La, b, Lb, la, lb, dirs, offs, sfin, cost, PB, MC);
  }
};

template <int W>
struct AdaptiveBacktrackLaunch {
  static constexpr bool ANY_WIDTH = false;
  static void run(const uint8_t* dirs, const int* offs, const uint8_t* a, int La,
                  const uint8_t* b, int Lb, const int* la, const int* lb, int* cols,
                  int* insb, int* lead, int PB, int MC, int words, cudaStream_t s) {
    using T = Tiling<W, K3_WIDE_MIN>;
    adaptive_backtrack_kernel<W><<<T::blocks(PB), T::THREADS, 0, s>>>(
        dirs, offs, a, La, b, Lb, la, lb, cols, insb, lead, PB, MC, words);
  }
};

}  // namespace

extern "C" {

int necat_diag_sub_matrix(const void* a, int La, const void* b, int Lb,
                          const void* la, const void* lb, void* out, int PB,
                          int MC, int W, void* stream) {
  // column and lane indices within a pair are ints
  if (W % 4 != 0 || PB < 0 || MC < 0 || (long long)MC * (W / 4) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)PB * MC * W == 0) return 0;
  return dispatch_width<DiagLaunch>(W, (const uint8_t*)a, La, (const uint8_t*)b, Lb,
                                    (const int*)la, (const int*)lb, (uint8_t*)out, PB, MC, W,
                                    (cudaStream_t)stream);
}

int necat_banded_forward(const void* a, int La, const void* b, int Lb, const void* la,
                         const void* lb, void* dirs, void* cost, int PB, int MC, int W,
                         void* stream) {
  return dispatch_width<ForwardLaunch>(
      W, (const uint8_t*)a, La, (const uint8_t*)b, Lb, (const int*)la, (const int*)lb,
      (uint8_t*)dirs, (int*)cost, PB, MC, (cudaStream_t)stream);
}

int necat_banded_backtrack(const void* dirs, const void* la, const void* lb,
                           void* cols, void* insb, void* lead, int PB, int MC,
                           int W, int words, void* stream) {
  if (words < 1 || words > 3) return (int)cudaErrorInvalidValue;
  return dispatch_width<BacktrackLaunch>(
      W, (const uint8_t*)dirs, (const int*)la, (const int*)lb, (int*)cols,
      (int*)insb, (int*)lead, PB, MC, words, (cudaStream_t)stream);
}

int necat_banded_forward_adaptive(const void* a, int La, const void* b, int Lb,
                                  const void* la, const void* lb, void* dirs, void* offs,
                                  void* sfin, void* cost, int PB, int MC, int W,
                                  void* stream) {
  if (La < 1 || Lb < 1) return (int)cudaErrorInvalidValue;
  return dispatch_width<ForwardAdaptiveLaunch>(
      W, (const uint8_t*)a, La, (const uint8_t*)b, Lb, (const int*)la, (const int*)lb,
      (uint8_t*)dirs, (int*)offs, (int*)sfin, (int*)cost, PB, MC, (cudaStream_t)stream);
}

int necat_adaptive_backtrack(const void* dirs, const void* offs, const void* a, int La,
                             const void* b, int Lb, const void* la, const void* lb,
                             void* cols, void* insb, void* lead, int PB, int MC, int W,
                             int words, void* stream) {
  if (words < 1 || words > 3 || La < 1 || Lb < 1) return (int)cudaErrorInvalidValue;
  return dispatch_width<AdaptiveBacktrackLaunch>(
      W, (const uint8_t*)dirs, (const int*)offs, (const uint8_t*)a, La, (const uint8_t*)b,
      Lb, (const int*)la, (const int*)lb, (int*)cols, (int*)insb, (int*)lead, PB, MC, words,
      (cudaStream_t)stream);
}

}  // extern "C"
