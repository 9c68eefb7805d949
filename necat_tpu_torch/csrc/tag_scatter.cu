// Weighted tag scatter of one extension pass into the consensus tensors, for
// Hopper (sm_90a), bound to PyTorch with ctypes through the plain C entry
// point at the end of this file.
//
// The CUDA form of necat_tpu_torch/consensus/tags.py:_scatter_pass, which
// stays the plain version: the same tags land in the same cells of
//
//   weights f64[TB+1, D, 5, Lt] at [row, delta, base, t]   (base 4 = gap)
//   coverage i32[TB+1, Lt]      at [row, t]                (delta-0 tags)
//
// A block takes one pair and its threads the pair's columns j = 1 .. jc (no
// tag lands past the clip), so a dropped pair (row outside [0, TB), a third
// of the lanes of a chunk) costs one load. Column j of the forward pass sits
// at t = at + j - 1, of the reversed pass at t = at - j. Each tag is one
// atomicAdd of the pair's float32 weight in float64: those sums are exact,
// so the order of the additions cannot change a bit and the result equals
// the plain version's. A masked cell is skipped by a branch, never added as
// a 0. The entry point returns cudaGetLastError() after its launch; the
// kernel allocates nothing and launches on the stream it is given.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCATTER_THREADS = 256;
constexpr int OP_DEL = 1, OP_PAD = 3;
constexpr int GAP_CODE = 4;
constexpr int N_INSB = 7;         // inserted bases per insb word and run end

// cols = op | match << 2 | qbase << 3 | k << 5 (k = insertion run length
// after the column). insb word w holds the run's first N_INSB bases at bits
// 2d (the forward pass reads them) and its last N_INSB at bits 14 + 2d (the
// reversed pass). nd = min(D - 1, N_INSB * words) insertion planes; leadb
// holds the leading run's bases (before column 1), delta d + 1 at d.
__global__ void __launch_bounds__(SCATTER_THREADS)
tag_scatter_kernel(double* __restrict__ weights, int* __restrict__ coverage, int TB, int D,
                   int Lt, const int* __restrict__ cols, const int* __restrict__ insb0,
                   const int* __restrict__ insb1, const int* __restrict__ insb2, int nd,
                   const int* __restrict__ lead, const uint8_t* __restrict__ leadb,
                   int leadb_w, const int* __restrict__ jc, const int* __restrict__ at,
                   const int* __restrict__ pair_row, const float* __restrict__ pair_w,
                   const int* __restrict__ tsize, int MC, int reversed) {
  const int p = blockIdx.x;
  const int row = pair_row[p];
  const int jcp = jc[p];
  // no column tag without j <= jc, no leading insertion without jc > 0
  if (row < 0 || row >= TB || jcp <= 0) return;
  const int a = at[p];
  const int ts_full = tsize[p];
  const int ts = min(ts_full, Lt);
  const double w = (double)pair_w[p];
  double* __restrict__ wrow = weights + (long long)row * D * 5 * Lt;   // [D, 5, Lt]
  int* __restrict__ crow = coverage + (long long)row * Lt;

  // leading insertions at t = at - 1 (either pass). t < Lt and a base of
  // at most 4 hold for every real chunk (tsize <= Lt, leadb holds query
  // bases); they keep a malformed one inside the pair's row
  const int tl = a - 1;
  if (tl >= 0 && tl < ts_full && tl < Lt) {
    const int nl = min(lead[p], nd);
    for (int d = threadIdx.x; d < nl; d += blockDim.x) {
      const int base = leadb[(long long)p * leadb_w + d];
      if (base < 5) atomicAdd(wrow + ((long long)(d + 1) * 5 + base) * Lt + tl, w);
    }
  }

  const int sh0 = reversed ? 14 : 0;
  const int ncols = min(jcp, MC);
  const long long p0 = (long long)p * MC;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int v = cols[p0 + c];
    const int op = v & 3;
    if (op == OP_PAD) continue;
    const int j = c + 1;
    const int t = reversed ? a - j : a + j - 1;
    // delta-0 tag: the query base for DIAG, a gap for DEL
    if (t >= 0 && t < ts) {
      const int base = op == OP_DEL ? GAP_CODE : (v >> 3) & 3;
      atomicAdd(wrow + (long long)base * Lt + t, w);
      atomicAdd(crow + t, 1);
    }
    // the insertions after column j (j < jc): forward runs at the column's
    // own t, reversed runs one position further left
    const int k = min(v >> 5, nd);
    const int ti = reversed ? t - 1 : t;
    if (k <= 0 || j >= jcp || ti < 0 || ti >= ts) continue;
    int bits = 0;
    for (int d = 0; d < k; ++d) {
      const int dl = d % N_INSB;
      if (dl == 0) bits = (d < N_INSB ? insb0 : d < 2 * N_INSB ? insb1 : insb2)[p0 + c];
      const int base = (bits >> (sh0 + 2 * dl)) & 3;
      atomicAdd(wrow + ((long long)(d + 1) * 5 + base) * Lt + ti, w);
    }
  }
}

}  // namespace

extern "C" {

int necat_tag_scatter(void* weights, void* coverage, int TB, int D, int Lt, const void* cols,
                      const void* insb0, const void* insb1, const void* insb2, int nd,
                      const void* lead, const void* leadb, int leadb_w, const void* jc,
                      const void* at, const void* pair_row, const void* pair_w,
                      const void* tsize, int P, int MC, int reversed, void* stream) {
  // an insb word for every N_INSB insertion planes, leadb as wide as nd
  if (P < 0 || MC < 0 || TB < 0 || D < 1 || Lt < 0 || nd < 0 || nd > D - 1 ||
      nd > 3 * N_INSB || leadb_w < nd || (nd > 0 && insb0 == nullptr) ||
      (nd > N_INSB && insb1 == nullptr) || (nd > 2 * N_INSB && insb2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  tag_scatter_kernel<<<P, SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
      (double*)weights, (int*)coverage, TB, D, Lt, (const int*)cols, (const int*)insb0,
      (const int*)insb1, (const int*)insb2, nd, (const int*)lead, (const uint8_t*)leadb,
      leadb_w, (const int*)jc, (const int*)at, (const int*)pair_row, (const float*)pair_w,
      (const int*)tsize, MC, reversed);
  return (int)cudaGetLastError();
}

}  // extern "C"
