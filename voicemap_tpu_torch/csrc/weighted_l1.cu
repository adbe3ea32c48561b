// B9: the weighted-L1 score matrix of the siamese verification head,
//
//   out[t, i, j] = sum_d |q[t, i, d] - s[t, j, d]| * w[d] + b,
//
// without the (nq, ns, D) difference tensor in device memory.
//
// Replaces voicemap_tpu/ops/pallas_distance.py :: _l1_kernel (wrapper
// pallas_weighted_l1). The JAX package kept that kernel off its paths: on the
// TPU the XLA broadcast won at n-shot sizes (pallas_distance.py:15-20). That
// was the TPU's verdict; the port puts B9 on its scoring paths (n-shot head
// scores, verification pairs, score_support) and measures it on the card.
//
// What bounds it on the H100: operations. The work has no matrix-product
// form (the abs sits between the subtract and the multiply), so it runs on
// the f32 CUDA cores, not the tensor cores: at least two instructions a term
// (a subtract, then an FMA of |diff| * w into the sum; the abs is an operand
// modifier), at 132 SMs x 128 lanes a clock. At (1, 4096, 4096, 64) that is
// 2.1 G instructions, 0.064 ms, against 0.021 ms for its 69 MB of bytes.
//
// Design. The summation order is pinned so that the kernel and its plain
// version (ops/cuda_distance.py :: weighted_l1_reference) agree bit for bit:
// each output is a sum in d order of __fmul_rn(fabsf(__fsub_rn(q, s)), w),
// added with __fadd_rn from 0, then + b last. No FMA: the pinned order
// costs a third instruction a term.
// - nq > 1: one CTA owns a 64 x 64 output tile of one t. Its 256 threads
//   each keep a 4 x 4 register micro-tile, strided by 16 so that a
//   half-warp writes 16 neighbouring outputs of a row. q and s rows are
//   staged in shared memory 32 dims at a time, transposed (d-major, one
//   column of padding, so the staging stores miss no bank), with w's 32
//   values beside them. Ragged edges are masked in the kernel; nothing is
//   padded in device memory (the TPU's _pad_to was a BlockSpec workaround).
// - nq == 1 (the n-shot (T, 1, P) and verification (P, 1, 1) forms): a
//   64 x 64 tile would be one row and mostly empty, so one thread owns one
//   output (t, j) and walks d itself, w staged whole in shared memory.
// Any T, nq, ns >= 1 (T and the tile rows under 65536 in the tiled form)
// and 1 <= D <= kMaxD = 1024, the w that the row-vector form stages.
// Register blocking deeper than 4 x 4, vector loads and coalesced s reads in
// the row-vector form are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // output rows and columns of a CTA (nq > 1)
constexpr int kChunk = 32;       // embedding dims staged at a time
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kVecThreads = 128;  // row-vector form: one output a thread
constexpr int kMaxD = 1024;

__device__ __forceinline__ float term(float acc, float qv, float sv, float wv) {
  return __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(qv, sv)), wv));
}

__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ q, const float* __restrict__ s,
            const float* __restrict__ w, const float* __restrict__ b,
            float* __restrict__ out, int nq, int ns, int D) {
  __shared__ float qs[kChunk][kTile + 1];
  __shared__ float ss[kChunk][kTile + 1];
  __shared__ float ws[kChunk];
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* qt = q + (long long)t * nq * D;
  const float* st = s + (long long)t * ns * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int kc = min(kChunk, D - d0);
    // A warp reads 32 neighbouring dims of one row: 128 contiguous bytes.
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, dd = e % kChunk;
      const bool in_d = dd < kc;
      qs[dd][r] = (in_d && i0 + r < nq) ? qt[(long long)(i0 + r) * D + d0 + dd] : 0.f;
      ss[dd][r] = (in_d && j0 + r < ns) ? st[(long long)(j0 + r) * D + d0 + dd] : 0.f;
    }
    if (threadIdx.x < kChunk) ws[threadIdx.x] = threadIdx.x < kc ? w[d0 + threadIdx.x] : 0.f;
    __syncthreads();
    for (int dd = 0; dd < kc; ++dd) {
      const float wv = ws[dd];
      float qv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = qs[dd][ty + 16 * a];
        sv[a] = ss[dd][tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = term(acc[a][c], qv[a], sv[c], wv);
    }
    __syncthreads();
  }
  const float bias = *b;
  float* ot = out + (long long)t * nq * ns;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= nq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < ns) ot[(long long)i * ns + j] = __fadd_rn(acc[a][c], bias);
    }
  }
}

// nq == 1: output o = t * ns + j, one a thread.
__global__ void __launch_bounds__(kVecThreads)
row_kernel(const float* __restrict__ q, const float* __restrict__ s,
           const float* __restrict__ w, const float* __restrict__ b,
           float* __restrict__ out, long long n_out, int ns, int D) {
  __shared__ float ws[kMaxD];
  for (int d = threadIdx.x; d < D; d += kVecThreads) ws[d] = w[d];
  __syncthreads();
  const long long o = (long long)blockIdx.x * kVecThreads + threadIdx.x;
  if (o >= n_out) return;
  const float* qr = q + (o / ns) * D;
  const float* sr = s + o * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = term(acc, qr[d], sr[d], ws[d]);
  out[o] = __fadd_rn(acc, *b);
}

}  // namespace

// q (T, nq, D), s (T, ns, D), w (D,), b (1,), all f32 and contiguous;
// out (T, nq, ns) f32.
extern "C" int vm_weighted_l1(const void* q, const void* s, const void* w, const void* b,
                              void* out, int T, int nq, int ns, int D, void* stream) {
  if (T < 1 || nq < 1 || ns < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* sf = (const float*)s;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  if (nq == 1) {
    const long long n_out = (long long)T * ns;
    const long long blocks = (n_out + kVecThreads - 1) / kVecThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_kernel<<<(unsigned)blocks, kVecThreads, 0, st>>>(qf, sf, wf, bf, (float*)out, n_out,
                                                         ns, D);
  } else {
    const int gx = (ns + kTile - 1) / kTile, gy = (nq + kTile - 1) / kTile;
    if (gy > 65535 || T > 65535) return (int)cudaErrorInvalidValue;
    tile_kernel<<<dim3(gx, gy, T), kThreads, 0, st>>>(qf, sf, wf, bf, (float*)out, nq, ns, D);
  }
  return (int)cudaGetLastError();
}
