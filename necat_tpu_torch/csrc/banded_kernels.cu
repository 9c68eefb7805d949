// Static-band alignment kernels for Hopper (sm_90a), bound to PyTorch with
// ctypes through the plain C entry points at the end of this file.
//
// All three kernels work in the DIAGONAL coordinates of the static band:
// lane l of target column j holds query row i = j + l - ctr, with the
// per-pair centre ctr = W/2 - floor((la - lb) / 2). The extension clamps
// |la - lb| <= W/4, so both alignment end points sit near the middle lane.
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

constexpr int INF = 1 << 20;
constexpr int OP_DIAG = 0, OP_DEL = 1, OP_INS = 2, OP_PAD = 3;
constexpr int PAD_BASE = 127;     // query padding: never equals a target base
constexpr int PAD_TARGET = 255;   // target padding past b's width
constexpr int N_INSB = 7;         // inserted bases per insb word and end
constexpr unsigned FULL = 0xffffffffu;

// floor(a / b) for b > 0. C's `/` truncates toward zero, which would put odd
// negative length differences one lane off the JAX reference.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int band_centre(int W, int la, int lb) {
  return W / 2 - floor_div(la - lb, 2);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// V consecutive bytes of one band row, lanes t*V .. t*V+V-1.
template <int V>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row, int t,
                                         int (&v)[V]) {
  if constexpr (V % 4 == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row + t * V);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      uint32_t x = w[q];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[4 * q + s] = (x >> (8 * s)) & 0xff;
    }
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s) v[s] = row[t * V + s];
  }
}

template <int V>
__device__ __forceinline__ void store_row(uint8_t* __restrict__ row, int t,
                                          const int (&v)[V]) {
  if constexpr (V % 4 == 0) {
    uint32_t* w = reinterpret_cast<uint32_t*>(row + t * V);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) x |= (uint32_t)(v[4 * q + s] & 0xff) << (8 * s);
      w[q] = x;
    }
  } else {
#pragma unroll
    for (int s = 0; s < V; ++s) row[t * V + s] = (uint8_t)v[s];
  }
}

// ---------------------------------------------------------------- K2: ENC
// Replaces _diag_kernel / _diag_sub_matrix_pallas
// (necat_tpu/align/pallas_banded.py). ENC[p, jc, l] compares query base
// a[p, jc + l - ctr_p] with target base b[p, jc].
// Bound: device-memory bandwidth. It writes PB*MC*W bytes and reads each
// query byte about once from L1/L2, so the design is one thread per four
// output bytes with 4-byte stores, neighbouring threads on neighbouring
// words, one grid row (blockIdx.y) per pair.
__global__ void diag_sub_matrix_kernel(const uint8_t* __restrict__ a, int La,
                                       const uint8_t* __restrict__ b, int Lb,
                                       const int* __restrict__ la_,
                                       const int* __restrict__ lb_,
                                       uint32_t* __restrict__ out, int MC, int W) {
  const int p = blockIdx.y;
  const int w4 = W / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // word within the pair
  if (idx >= MC * w4) return;
  const int jc = idx / w4;
  const int l0 = (idx - jc * w4) * 4;
  const int ctr = band_centre(W, la_[p], lb_[p]);
  const int tc = jc < Lb ? b[(size_t)p * Lb + jc] : PAD_TARGET;
  const uint8_t* ap = a + (size_t)p * La;
  uint32_t word = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int src = jc + l0 + s - ctr;
    const int aq = (src >= 0 && src < La) ? ap[src] : PAD_BASE;
    word |= (uint32_t)((aq != tc) | ((aq & 3) << 1)) << (8 * s);
  }
  out[(size_t)p * MC * w4 + idx] = word;
}

// ------------------------------------------------- K1 and K3: pair tiling
// K1 and K3 hold a pair's band row in registers: thread t of the pair owns
// the V consecutive lanes t*V .. t*V+V-1. Up to W = 1024 one warp runs a pair
// (V = W/32, WARPS_PER_BLOCK pairs per block). The rescue ladder climbs to
// W = 4096 (necat_tpu/utils/shapes.py MAX_BAND), where a warp per pair would
// hold 128 lanes per thread (K1 needs 222 registers at W = 1024 already), so
// from WIDE_MIN one thread block of NW warps runs a pair, V_WIDE lanes per
// thread, and the steps that cross a warp boundary go through shared memory
// (the `if constexpr (NW > 1)` parts of the kernels). Widths this large run
// only in the rescue ladder, a few pairs per chunk.
constexpr int WARPS_PER_BLOCK = 4;
constexpr int V_WIDE = 8;
constexpr int WIDE_MIN = 2048;            // widths from here on take a block per pair

template <int W>
struct Tiling {
  static constexpr int V = W < WIDE_MIN ? W / 32 : V_WIDE;   // lanes per thread
  static constexpr int NW = W / V / 32;                     // warps per pair
  static constexpr int THREADS = NW > 1 ? 32 * NW : 32 * WARPS_PER_BLOCK;
  static int blocks(int PB) {
    return NW > 1 ? PB : (PB + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  }
};

// This thread's pair p and its rank t within the pair; false for the warps of
// the last block that have no pair (whole warps only).
template <int W>
__device__ __forceinline__ bool pair_thread(int PB, int& p, int& t) {
  if constexpr (Tiling<W>::NW > 1) {
    p = blockIdx.x;
    t = threadIdx.x;
  } else {
    p = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    t = threadIdx.x & 31;
  }
  return p < PB;
}

// ------------------------------------------------------------ K1: forward
// Replaces _forward_kernel / banded_forward_pallas
// (necat_tpu/align/pallas_banded.py): static-band edit-distance DP.
// Bound: the chain of up to 40960 dependent columns of one pair, plus two
// bytes of traffic per cell (ENC in, dirs out). The column loop runs inside
// the kernel, pairs in parallel. Per column, the left neighbour (lane l+1)
// is one __shfl_down_sync and, for a warp's last thread, the first lane of
// the next warp from shared memory (first[]); the insertion chain (a prefix
// minimum over lanes) is a thread-local scan, a 5-step __shfl_up_sync warp
// scan and a scan of the per-warp totals (wtot[]) in shared memory. The up
// neighbour of a thread's first lane is one __shfl_up_sync with a warp per
// pair; with a block per pair it is Dn[l-1] = min(prefix-min over lanes
// < l + (l-1), INF), the thread's exclusive prefix `before` shifted, which
// needs no third barrier. __syncthreads per column: none with a warp per pair,
// 2 with a block per pair (the warp totals must be visible before the
// cross-warp scan; first[] must be rewritten before the next column reads
// it). Columns past lb are written as OP_PAD without any DP.
template <int W>
__global__ void __launch_bounds__(Tiling<W>::THREADS)
banded_forward_kernel(const uint8_t* __restrict__ enc, const int* __restrict__ la_,
                      const int* __restrict__ lb_, uint8_t* __restrict__ dirs,
                      int* __restrict__ cost, int PB, int MC) {
  constexpr int V = Tiling<W>::V, NW = Tiling<W>::NW;
  __shared__ int wtot[NW];        // inclusive insertion-scan total of each warp
  __shared__ int first[NW + 1];   // D of each warp's first lane; first[NW] = INF
  int p, t;
  if (!pair_thread<W>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  const int la = la_[p], lb = lb_[p];
  const int ctr = band_centre(W, la, lb);
  const uint8_t* ep = enc + (size_t)p * MC * W;
  uint8_t* dp = dirs + (size_t)p * MC * W;

  int D[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int i0 = t * V + s - ctr;
    D[s] = (i0 >= 0 && i0 <= la) ? i0 : INF;
  }
  if constexpr (NW > 1) {
    if (lt == 0) first[wp] = D[0];
    if (t == 0) first[NW] = INF;
    __syncthreads();
  }
  const int ncol = lb < MC ? lb : MC;
  for (int j = 1; j <= ncol; ++j) {
    int e[V];
    load_row<V>(ep + (size_t)(j - 1) * W, t, e);
    int right = __shfl_down_sync(FULL, D[0], 1);   // lane t*V+V of this column
    if (lt == 31) right = NW > 1 ? first[wp + 1] : INF;
    int diag[V], left[V], x[V];
    bool outside[V];
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int lane = t * V + s;
      const int i = j - ctr + lane;
      diag[s] = D[s] + (e[s] & 1);
      left[s] = (s < V - 1 ? D[s + 1] : right) + 1;
      int A = min(diag[s], left[s]);
      if (i == 0) A = j;                   // row 0: the all-deletion path
      outside[s] = i < 0 || i > la;
      if (outside[s]) A = INF;
      x[s] = A - lane;
    }
    // insertion chain: D[l] = min_{m <= l} (A[m] + l - m) = lane + prefix-min(x)
#pragma unroll
    for (int s = 1; s < V; ++s) x[s] = min(x[s], x[s - 1]);
    int tot = x[V - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, tot, off);
      if (lt >= off) tot = min(tot, y);
    }
    int before = __shfl_up_sync(FULL, tot, 1);      // min of x over lanes < t*V
    if (lt == 0) before = INF;
    if constexpr (NW > 1) {
      if (lt == 31) wtot[wp] = tot;
      __syncthreads();                                // sync 1 of 2
      for (int u = 0; u < wp; ++u) before = min(before, wtot[u]);
    }
    int Dn[V];
#pragma unroll
    for (int s = 0; s < V; ++s) {
      Dn[s] = min(min(x[s], before) + t * V + s, INF);
      if (outside[s]) Dn[s] = INF;
    }
    int up;                                           // Dn of lane t*V-1
    if constexpr (NW > 1) {                           // from `before`: no exchange
      const int iu = j - ctr + t * V - 1;             // query row of lane t*V-1
      up = (t == 0 || iu < 0 || iu > la) ? INF : min(before + t * V - 1, INF);
    } else {
      up = __shfl_up_sync(FULL, Dn[V - 1], 1);
      if (t == 0) up = INF;
    }
    int out[V];
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int upv = (s == 0 ? up : Dn[s - 1]) + 1;
      const int op = Dn[s] == diag[s] ? OP_DIAG
                   : Dn[s] == upv     ? OP_INS
                   : Dn[s] == left[s] ? OP_DEL
                                      : OP_PAD;
      out[s] = op | (e[s] << 2);
      D[s] = Dn[s];
    }
    store_row<V>(dp + (size_t)(j - 1) * W, t, out);
    if constexpr (NW > 1) {
      if (lt == 0) first[wp] = D[0];
      __syncthreads();                                // sync 2 of 2
    }
  }
  int pad[V];
#pragma unroll
  for (int s = 0; s < V; ++s) pad[s] = OP_PAD;
  for (int jc = ncol; jc < MC; ++jc) store_row<V>(dp + (size_t)jc * W, t, pad);

  const int l_end = clampi(la - lb + ctr, 0, W - 1);
#pragma unroll
  for (int s = 0; s < V; ++s)
    if (t * V + s == l_end) cost[p] = D[s];
}

// ---------------------------------------------------------- K3: backtrack
// Replaces _backtrack_kernel / banded_backtrack_cols
// (necat_tpu/align/pallas_banded.py): walks from (la, lb) back one target
// column per step and emits the per-column encoding and insb words.
// Bound: latency. Every step depends on the previous step's slot, and each
// step reads one dirs row. Per column, the run of insertions under the
// current slot `cur` ends at sel, the highest non-insertion lane at or below
// it: a __reduce_max_sync in each warp, then a max over the warps' results
// in shared memory (wmax[]) that every thread takes, so `cur`, which follows
// from sel, is the same in every thread. The inserted bases of the run are
// packed with one __reduce_or_sync per insb word (their bit fields are
// disjoint), then an OR over the warps in shared memory (wor[]) by thread 0,
// which writes the column. __syncthreads per column: none with a warp per
// pair, 2 with a block per pair (after the warps' maxima, after the warps'
// insb words).
template <int W>
__global__ void __launch_bounds__(Tiling<W>::THREADS)
banded_backtrack_kernel(const uint8_t* __restrict__ dirs, const int* __restrict__ la_,
                        const int* __restrict__ lb_, int* __restrict__ cols,
                        int* __restrict__ insb, int* __restrict__ lead, int PB,
                        int MC, int words) {
  constexpr int V = Tiling<W>::V, NW = Tiling<W>::NW;
  __shared__ int wmax[NW];
  __shared__ unsigned wor[3][NW];
  int p, t;
  if (!pair_thread<W>(PB, p, t)) return;
  const int lt = t & 31, wp = t >> 5;
  const int la = la_[p], lb = lb_[p];
  const int ctr = band_centre(W, la, lb);
  const uint8_t* dp = dirs + (size_t)p * MC * W;
  int* cp = cols + (size_t)p * MC;
  const int ncol = lb < MC ? lb : MC;
  for (int jc = ncol + t; jc < MC; jc += 32 * NW) {
    cp[jc] = OP_PAD;
    for (int w = 0; w < words; ++w) insb[((size_t)w * PB + p) * MC + jc] = 0;
  }
  int cur = clampi(la - lb + ctr, 0, W - 1);
  for (int j = ncol; j >= 1; --j) {
    const uint8_t* row = dp + (size_t)(j - 1) * W;
    int v[V];
    load_row<V>(row, t, v);
    int best = -1;
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int lane = t * V + s;
      if (lane <= cur && (v[s] & 3) != OP_INS) best = lane;
    }
    int sel = __reduce_max_sync(FULL, best);         // -1: insertions down to lane 0
    if constexpr (NW > 1) {
      if (lt == 0) wmax[wp] = sel;
      __syncthreads();                                // sync 1 of 2
#pragma unroll
      for (int u = 0; u < NW; ++u) sel = max(sel, wmax[u]);
    }
    const int k = cur - sel;
    const int vsel = sel >= 0 ? row[sel] : 0;
    int o = vsel & 3;
    if (j - ctr + sel <= 0) o = OP_DEL;              // row 0: all-deletion border
    const int match = o == OP_DIAG ? 1 - ((vsel >> 2) & 1) : 0;
    const int qbase = o == OP_DIAG ? (vsel >> 3) & 3 : 0;
    const int kc = min(k, N_INSB * words);
    for (int w = 0; w < words; ++w) {
      const int d0 = N_INSB * w;
      const int hi = min(kc, d0 + N_INSB);
      unsigned bits = 0;
#pragma unroll
      for (int s = 0; s < V; ++s) {
        const int lane = t * V + s;
        const unsigned qb = (v[s] >> 3) & 3;
        const int df = lane - sel;                   // 1-based rank from the run start
        const int db = cur - lane;                   // 0-based rank from the run end
        if (df >= d0 + 1 && df <= hi) bits |= qb << (2 * (df - 1 - d0));
        if (db >= d0 && db < hi) bits |= qb << (14 + 2 * (db - d0));
      }
      bits = __reduce_or_sync(FULL, bits);
      if constexpr (NW > 1) {
        if (lt == 0) wor[w][wp] = bits;
      } else {
        if (t == 0) insb[((size_t)w * PB + p) * MC + (j - 1)] = (int)bits;
      }
    }
    if constexpr (NW > 1) {
      __syncthreads();                                // sync 2 of 2
      if (t == 0) {
        for (int w = 0; w < words; ++w) {
          unsigned bits = 0;
          for (int u = 0; u < NW; ++u) bits |= wor[w][u];
          insb[((size_t)w * PB + p) * MC + (j - 1)] = (int)bits;
        }
      }
    }
    if (t == 0) cp[j - 1] = (k << 5) | (qbase << 3) | (match << 2) | o;
    cur = clampi(o == OP_DIAG ? sel : sel + 1, 0, W - 1);
  }
  if (t == 0) lead[p] = clampi(cur - ctr, 0, la);
}

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
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int W>
struct ForwardLaunch {
  static void run(const uint8_t* enc, const int* la, const int* lb, uint8_t* dirs,
                  int* cost, int PB, int MC, cudaStream_t s) {
    banded_forward_kernel<W><<<Tiling<W>::blocks(PB), Tiling<W>::THREADS, 0, s>>>(
        enc, la, lb, dirs, cost, PB, MC);
  }
};

template <int W>
struct BacktrackLaunch {
  static void run(const uint8_t* dirs, const int* la, const int* lb, int* cols,
                  int* insb, int* lead, int PB, int MC, int words, cudaStream_t s) {
    banded_backtrack_kernel<W><<<Tiling<W>::blocks(PB), Tiling<W>::THREADS, 0, s>>>(
        dirs, la, lb, cols, insb, lead, PB, MC, words);
  }
};

}  // namespace

extern "C" {

int necat_diag_sub_matrix(const void* a, int La, const void* b, int Lb,
                          const void* la, const void* lb, void* out, int PB,
                          int MC, int W, void* stream) {
  // the word index within a pair is an int
  if (W % 4 != 0 || PB > 65535 || (long long)MC * (W / 4) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((MC * (W / 4) + threads - 1) / threads, PB);
  diag_sub_matrix_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, La, (const uint8_t*)b, Lb, (const int*)la,
      (const int*)lb, (uint32_t*)out, MC, W);
  return (int)cudaGetLastError();
}

int necat_banded_forward(const void* enc, const void* la, const void* lb,
                         void* dirs, void* cost, int PB, int MC, int W,
                         void* stream) {
  return dispatch_width<ForwardLaunch>(
      W, (const uint8_t*)enc, (const int*)la, (const int*)lb, (uint8_t*)dirs,
      (int*)cost, PB, MC, (cudaStream_t)stream);
}

int necat_banded_backtrack(const void* dirs, const void* la, const void* lb,
                           void* cols, void* insb, void* lead, int PB, int MC,
                           int W, int words, void* stream) {
  return dispatch_width<BacktrackLaunch>(
      W, (const uint8_t*)dirs, (const int*)la, (const int*)lb, (int*)cols,
      (int*)insb, (int*)lead, PB, MC, words, (cudaStream_t)stream);
}

}  // extern "C"
