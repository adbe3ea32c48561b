// B7: the max-pool and BatchNorm passes of the blocks-1+ train op, one pass
// over the full-rate activation in each direction.
//
// Replaces voicemap_tpu/ops/pallas_routing.py :: _pool_fwd_kernel (wrapper
// pallas_pool_fwd) and _route_bwd_kernel (wrapper pallas_route_bwd). The
// layout is channel-first, (B, C, T), the layout cuDNN's conv1d writes and
// reads, so no transpose of the full-rate tensor is added around it; the
// TPU's lane view (B, T/pool, pool*C) was Mosaic's.
//
// Forward, for row (b, c) and pooled position p, s = sign(gamma[c]):
//   a_sel[b, c, p] = s * max_j(s * a[b, c, p*pool + j])   (a value of a, exact)
//   sum a, sum a^2 over every position, per channel, in f32.
// Backward: route g[b, c, p] (in a's dtype, as the TPU wrapper casts it) to
// the first phase j whose value equals a_sel (value ties are selection ties,
// so first-match is XLA's first-maximal routing), then
//   dz = a > 0 ? (c0*g_j + c1) + c2*a : 0      (f32, op by op, no FMA)
// written in the output dtype, and sum dz (the bias gradient) in f32.
//
// What bounds them on the H100: bytes. Config #1's block 1 at B=32 reads
// 49 MB of bf16 activation; the forward writes half that again, the
// backward reads a_sel and g (half each) and writes dz (the same size).
// Design: one CTA per (b, c) row, its threads striding over pooled positions
// so that a warp's loads are contiguous; each CTA reduces its sums in a
// fixed tree and writes one partial row, and fold.cuh sums the B rows of
// each channel in a fixed order, so the sums repeat run to run. Any B, any
// C, any pool; T % pool == 0 (the op's callers fall back otherwise).
// Vectorised loads and a row of several channels per CTA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the CTA in a fixed order: warp butterflies, then warps 0..7.
__device__ float block_sum(float v, float* scratch) {
  for (int s = 16; s > 0; s >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) total = __fadd_rn(total, scratch[i]);
  __syncthreads();
  return total;
}

template <typename AT, typename ST>
__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const AT* __restrict__ a, const float* __restrict__ sgn,
                ST* __restrict__ sel, float* __restrict__ part, int C, int T, int pool) {
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const int tp = T / pool;
  const long long row = (long long)b * C + c;
  const AT* ar = a + row * T;
  ST* sr = sel + row * tp;
  const float sc = sgn[c];
  float s1 = 0.f, s2 = 0.f;
  for (int p = threadIdx.x; p < tp; p += kThreads) {
    float best = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < pool; ++j) {
      const float v = to_f(ar[(long long)p * pool + j]);
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
      best = fmaxf(best, __fmul_rn(v, sc));
    }
    sr[p] = from_f<ST>(__fmul_rn(best, sc));
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    part[(long long)b * 2 * C + c] = s1;
    part[(long long)b * 2 * C + C + c] = s2;
  }
}

template <typename AT, typename OT>
__global__ void __launch_bounds__(kThreads)
route_bwd_kernel(const AT* __restrict__ a, const AT* __restrict__ asel,
                 const AT* __restrict__ g, const float* __restrict__ cc,
                 OT* __restrict__ dz, float* __restrict__ part, int C, int T, int pool) {
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const int tp = T / pool;
  const long long row = (long long)b * C + c;
  const AT* ar = a + row * T;
  OT* dr = dz + row * T;
  const float c0 = cc[c], c1 = cc[C + c], c2 = cc[2 * C + c];
  float sdz = 0.f;
  for (int p = threadIdx.x; p < tp; p += kThreads) {
    const float s = to_f(asel[row * tp + p]);
    const float gv = to_f(g[row * tp + p]);
    bool taken = false;
    for (int j = 0; j < pool; ++j) {
      const long long t = (long long)p * pool + j;
      const float v = to_f(ar[t]);
      const bool eq = !taken && v == s;
      taken = taken || eq;
      const float gj = eq ? gv : 0.f;
      const float d = v > 0.f
          ? __fadd_rn(__fadd_rn(__fmul_rn(c0, gj), c1), __fmul_rn(c2, v)) : 0.f;
      dr[t] = from_f<OT>(d);
      sdz = __fadd_rn(sdz, d);
    }
  }
  sdz = block_sum(sdz, scratch);
  if (threadIdx.x == 0) part[(long long)b * C + c] = sdz;
}

int check_shape(int B, int C, int T, int pool) {
  if (B < 1 || B > 65535 || C < 1 || pool < 1 || T < pool || T % pool)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// a (B, C, T) f32 or bf16; sgn (C,) f32; sel (B, C, T/pool) f32 or bf16;
// part (B, 2, C) f32 scratch; stats (2, C) f32 out: sum a, sum a^2.
extern "C" int vm_pool_fwd(const void* a, const void* sgn, void* sel, void* part,
                           void* stats, int B, int C, int T, int pool, int a_bf16,
                           int sel_bf16, void* stream) {
  if (int err = check_shape(B, C, T, pool)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(C, B);
  const float* sf = (const float*)sgn;
  float* pf = (float*)part;
  using bf = __nv_bfloat16;
  if (a_bf16 && sel_bf16)
    pool_fwd_kernel<bf, bf><<<grid, kThreads, 0, s>>>((const bf*)a, sf, (bf*)sel, pf, C, T, pool);
  else if (a_bf16)
    pool_fwd_kernel<bf, float><<<grid, kThreads, 0, s>>>((const bf*)a, sf, (float*)sel, pf, C, T,
                                                         pool);
  else if (sel_bf16)
    pool_fwd_kernel<float, bf><<<grid, kThreads, 0, s>>>((const float*)a, sf, (bf*)sel, pf, C, T,
                                                         pool);
  else
    pool_fwd_kernel<float, float><<<grid, kThreads, 0, s>>>((const float*)a, sf, (float*)sel, pf,
                                                            C, T, pool);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, B, 2 * C, (float*)stats, s);
  return (int)cudaGetLastError();
}

// a (B, C, T), a_sel and g (B, C, T/pool), all in one dtype (f32 or bf16);
// cc (3, C) f32: c0, c1, c2; dz (B, C, T) f32 or bf16; part (B, C) f32
// scratch; db (C,) f32 out.
extern "C" int vm_route_bwd(const void* a, const void* asel, const void* g, const void* cc,
                            void* dz, void* part, void* db, int B, int C, int T, int pool,
                            int a_bf16, int out_bf16, void* stream) {
  if (int err = check_shape(B, C, T, pool)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(C, B);
  const float* cf = (const float*)cc;
  float* pf = (float*)part;
  using bf = __nv_bfloat16;
  if (a_bf16 && out_bf16)
    route_bwd_kernel<bf, bf><<<grid, kThreads, 0, s>>>((const bf*)a, (const bf*)asel,
                                                       (const bf*)g, cf, (bf*)dz, pf, C, T, pool);
  else if (a_bf16)
    route_bwd_kernel<bf, float><<<grid, kThreads, 0, s>>>((const bf*)a, (const bf*)asel,
                                                          (const bf*)g, cf, (float*)dz, pf, C, T,
                                                          pool);
  else if (out_bf16)
    route_bwd_kernel<float, bf><<<grid, kThreads, 0, s>>>((const float*)a, (const float*)asel,
                                                          (const float*)g, cf, (bf*)dz, pf, C, T,
                                                          pool);
  else
    route_bwd_kernel<float, float><<<grid, kThreads, 0, s>>>((const float*)a, (const float*)asel,
                                                             (const float*)g, cf, (float*)dz, pf,
                                                             C, T, pool);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, B, C, (float*)db, s);
  return (int)cudaGetLastError();
}
