// ASP: the reductions over time of ECAPA-TDNN's attentive statistics
// pooling (models/ecapa.py attentive_stats and global_stats), one pass that
// reads each byte of h, and of the attention logits, once and writes only the
// per-utterance statistics.
//
// Replaces no TPU kernel: ECAPA-TDNN is the port's own configuration, which
// the JAX package does not have. Eager PyTorch ran these reductions as a
// softmax over time, its f32 cast, two f32 products and two f32 sums over
// the whole (B, T, C) tensor (about 75 GB of device traffic a 2,048 batch at
// C = 3072, T = 298), and the global mean and std as two reductions over h.
//
// Two modes of one reduction over (B, T, C) contiguous memory, per
// utterance b and channel c:
// - weighted (attentive_stats): an online softmax over t of the logits x in
//   f32, i.e. a running max m and, under it, s = sum e, s1 = sum e*h and
//   s2 = sum e*h^2 with e = exp(x - m), each rescaled by exp(m_old - m_new)
//   when m rises; then mean = s1 / s, var = s2 / s - mean^2;
// - unweighted (global_stats): s1 = sum h, s2 = sum h^2; mean = s1 / T,
//   var = s2 / T - mean^2;
// and std = sqrt(max(var, eps)): the plain versions' formula, clamp and f32.
// The weighted mode writes [mean, std] into one (B, 2C) row (ld = 2C), the
// unweighted one into two (B, C) tensors (ld = C).
//
// What bounds it on the H100: bytes. At B = 2048, T = 298, C = 3072 the
// weighted mode reads 7.5 GB of bf16 (2.24 ms at 3.35 TB/s) and the
// unweighted one 3.75 GB, at a few f32 operations an element. Design: one
// CTA owns one utterance and a slice of kVecs 16-byte vectors of channels
// (256 channels in bf16, 128 in f32): lane i of each warp loads vector i of
// a row, so a warp reads 512 neighbouring bytes, and the kGroups warps split
// the rows, each loading kUnroll rows of h (and of the logits) before it uses
// any. Within those kUnroll rows a thread takes the max of its logits first
// and rescales its sums at most once, so an element costs one expf. The warps
// then merge their states through shared memory in a fixed order (warp 0
// takes warps 1, 2, ... in turn): no atomics, so two launches agree bit for
// bit. expf is CUDA's full-accuracy expf (no fast-math intrinsic).
// Any B, T >= 1; C a multiple of 8; every pointer 16-byte aligned.
//
// Training (models/ecapa.py train_forward, through ops/cuda_asp.py's
// autograd functions) adds two things:
// - a forward instantiation of the weighted mode that also writes the
//   softmax's max m and sum s of each (b, c) (vm_asp_stats_train); the
//   inference instantiation above is not changed by it;
// - the backward of both modes, one pass that reads h (and the logits) once
//   and writes dh (and dlogits) once, in h's dtype. With a_t the softmax
//   weight exp(x_t - m) / s (1/T unweighted), mu the mean, sigma the std,
//   v = sigma^2 and g_v = g_sigma / (2 sigma) where v > eps (else 0):
//     dh_t     = a_t * (g_mu + 2 g_v (h_t - mu))
//     dlogit_t = a_t * (g_mu (h_t - mu) + g_v ((h_t - mu)^2 - v)).
//   It is bound by bytes as the forward is (twice its traffic: the
//   gradients are written at h's size), at the same CTA layout: one
//   utterance and a slice of 16-byte channel vectors, the warps over rows.
//   The per-channel constants are read once a thread; each element costs
//   one expf (weighted) and a few FMAs. No reduction: nothing is merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kVecs = 32;    // 16-byte vectors of channels a CTA: one a lane
constexpr int kGroups = 8;   // warps, each a share of the rows
constexpr int kUnroll = 4;   // rows a thread loads before it uses them
constexpr int kCtasPerSm = 2;

// The W channels of one 16-byte vector as f32: 8 bf16 or 4 f32.
template <bool BF>
struct Elem {
  static constexpr int kW = BF ? 8 : 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&x)[kW]) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (BF) {  // the element at the lower address is the low half
        x[2 * i] = __uint_as_float(u[i] << 16);
        x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        x[i] = __uint_as_float(u[i]);
      }
    }
  }
};

// Read once: no reuse, so evict first.
__device__ __forceinline__ uint4 load(const void* base, long long byte) {
  return __ldcs(reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(base) + byte));
}

template <bool BF, bool WEIGHTED, bool SAVE>
__global__ void __launch_bounds__(kVecs * kGroups, kCtasPerSm)
asp_stats_kernel(const void* __restrict__ h, const void* __restrict__ logits,
                 float* __restrict__ mean, float* __restrict__ stdv, int T, int C, int ld,
                 float eps, float* __restrict__ mx, float* __restrict__ sum) {
  using E = Elem<BF>;
  constexpr int W = E::kW;
  constexpr int NS = WEIGHTED ? 4 : 2;  // m, s, s1, s2; or s1, s2
  // warps 1.. hand their states to warp 0: [warp - 1][state][channel k][lane]
  __shared__ float red[kGroups - 1][NS][W][kVecs];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int b = blockIdx.x;
  const int v = blockIdx.y * kVecs + lane;  // this thread's vector of channels
  const bool active = v < C / W;

  float m[W], s[W], s1[W], s2[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    m[k] = -INFINITY;
    s[k] = s1[k] = s2[k] = 0.f;
  }
  if (active) {
    const long long esize = BF ? 2 : 4;
    const long long row_bytes = (long long)C * esize;
    const long long base = (long long)b * T * row_bytes + (long long)v * 16;
    for (int t0 = g; t0 < T; t0 += kGroups * kUnroll) {
      uint4 hv[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kGroups;
        if (t < T) {
          hv[u] = load(h, base + t * row_bytes);
          if constexpr (WEIGHTED) xv[u] = load(logits, base + t * row_bytes);
        }
      }
      if constexpr (WEIGHTED) {
        float x[kUnroll][W];
        float cm[W];
#pragma unroll
        for (int k = 0; k < W; ++k) cm[k] = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * kGroups < T) {
            E::unpack(xv[u], x[u]);
#pragma unroll
            for (int k = 0; k < W; ++k) cm[k] = fmaxf(cm[k], x[u][k]);
          }
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (cm[k] > m[k]) {  // the max rose: rescale the sums once
            const float a = expf(m[k] - cm[k]);
            s[k] *= a;
            s1[k] *= a;
            s2[k] *= a;
            m[k] = cm[k];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * kGroups < T) {
            float hx[W];
            E::unpack(hv[u], hx);
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const float e = expf(x[u][k] - m[k]);
              s[k] += e;
              s1[k] = fmaf(e, hx[k], s1[k]);
              s2[k] = fmaf(e, hx[k] * hx[k], s2[k]);
            }
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * kGroups < T) {
            float hx[W];
            E::unpack(hv[u], hx);
#pragma unroll
            for (int k = 0; k < W; ++k) {
              s1[k] += hx[k];
              s2[k] = fmaf(hx[k], hx[k], s2[k]);
            }
          }
        }
      }
    }
  }

  if (g > 0) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (WEIGHTED) {
        red[g - 1][0][k][lane] = m[k];
        red[g - 1][1][k][lane] = s[k];
        red[g - 1][2][k][lane] = s1[k];
        red[g - 1][3][k][lane] = s2[k];
      } else {
        red[g - 1][0][k][lane] = s1[k];
        red[g - 1][1][k][lane] = s2[k];
      }
    }
  }
  __syncthreads();
  if (g > 0 || !active) return;
  for (int i = 0; i < kGroups - 1; ++i) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (WEIGHTED) {
        // warp 0 always holds row 0, so its max is finite and so is mx
        const float mi = red[i][0][k][lane];
        const float mx = fmaxf(m[k], mi);
        const float a = expf(m[k] - mx), ai = expf(mi - mx);  // a warp with no rows: 0
        s[k] = fmaf(red[i][1][k][lane], ai, s[k] * a);
        s1[k] = fmaf(red[i][2][k][lane], ai, s1[k] * a);
        s2[k] = fmaf(red[i][3][k][lane], ai, s2[k] * a);
        m[k] = mx;
      } else {
        s1[k] += red[i][0][k][lane];
        s2[k] += red[i][1][k][lane];
      }
    }
  }
  float mu[W], sd[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float n = WEIGHTED ? s[k] : (float)T;
    mu[k] = __fdiv_rn(s1[k], n);
    const float var = __fsub_rn(__fdiv_rn(s2[k], n), __fmul_rn(mu[k], mu[k]));
    sd[k] = __fsqrt_rn(fmaxf(var, eps));
  }
  const long long at = (long long)b * ld + (long long)v * W;
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    *reinterpret_cast<float4*>(mean + at + k) = make_float4(mu[k], mu[k + 1], mu[k + 2],
                                                            mu[k + 3]);
    *reinterpret_cast<float4*>(stdv + at + k) = make_float4(sd[k], sd[k + 1], sd[k + 2],
                                                            sd[k + 3]);
  }
  if constexpr (SAVE) {  // the softmax's max and sum, rows of C
    const long long c0 = (long long)b * C + (long long)v * W;
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      *reinterpret_cast<float4*>(mx + c0 + k) = make_float4(m[k], m[k + 1], m[k + 2], m[k + 3]);
      *reinterpret_cast<float4*>(sum + c0 + k) = make_float4(s[k], s[k + 1], s[k + 2], s[k + 3]);
    }
  }
}

// Round to bf16, nearest even, and pack two into 32 bits (low half first).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

template <bool BF>
__device__ __forceinline__ uint4 pack(const float (&x)[Elem<BF>::kW]) {
  if constexpr (BF) {
    return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                      pack_bf16(x[6], x[7]));
  } else {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
}

__device__ __forceinline__ void store(void* base, long long byte, const uint4& v) {
  __stcs(reinterpret_cast<uint4*>(reinterpret_cast<char*>(base) + byte), v);
}

// The backward of both modes (see the head of this file). mean and stdv are
// the forward's outputs (row b at b * ld), gmean and gstd their gradients
// (row b at b * ldg; NULL: zero); mx and sum the softmax's max and sum
// (rows of C), weighted mode only.
template <bool BF, bool WEIGHTED>
__global__ void __launch_bounds__(kVecs * kGroups, kCtasPerSm)
asp_stats_bwd_kernel(const void* __restrict__ h, const void* __restrict__ logits,
                     const float* __restrict__ mean, const float* __restrict__ stdv,
                     const float* __restrict__ mx, const float* __restrict__ sum,
                     const float* __restrict__ gmean, const float* __restrict__ gstd,
                     void* __restrict__ dh, void* __restrict__ dlogits, int T, int C, int ld,
                     int ldg, float eps) {
  using E = Elem<BF>;
  constexpr int W = E::kW;
  const int lane = threadIdx.x, g = threadIdx.y;
  const int b = blockIdx.x;
  const int v = blockIdx.y * kVecs + lane;
  if (v >= C / W) return;

  // per channel: mu, v = sigma^2, g_mu, g_v, the softmax's max, 1 / its sum.
  // The forward wrote sigma = sqrt(max(v, eps)): sigma above sqrt(eps) is a
  // variance above eps, the one that carries a gradient.
  const float floor_sd = __fsqrt_rn(eps);
  float mu[W], var[W], gm[W], gv[W], m[W], inv[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const long long at = (long long)b * ld + (long long)v * W + k;
    const long long ag = (long long)b * ldg + (long long)v * W + k;
    const float sd = stdv[at];
    mu[k] = mean[at];
    var[k] = sd * sd;
    gm[k] = gmean ? gmean[ag] : 0.f;
    const float gs = gstd ? gstd[ag] : 0.f;
    gv[k] = sd > floor_sd ? gs / (2.f * sd) : 0.f;
    if constexpr (WEIGHTED) {
      const long long c = (long long)b * C + (long long)v * W + k;
      m[k] = mx[c];
      inv[k] = 1.f / sum[c];
    } else {
      m[k] = 0.f;
      inv[k] = 1.f / (float)T;
    }
  }

  const long long esize = BF ? 2 : 4;
  const long long row_bytes = (long long)C * esize;
  const long long base = (long long)b * T * row_bytes + (long long)v * 16;
  for (int t0 = g; t0 < T; t0 += kGroups * kUnroll) {
    uint4 hv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kGroups;
      if (t < T) {
        hv[u] = load(h, base + t * row_bytes);
        if constexpr (WEIGHTED) xv[u] = load(logits, base + t * row_bytes);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kGroups;
      if (t < T) {
        float hx[W], dhx[W];
        E::unpack(hv[u], hx);
        if constexpr (WEIGHTED) {
          float x[W], dxx[W];
          E::unpack(xv[u], x);
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const float a = expf(x[k] - m[k]) * inv[k];
            const float d = hx[k] - mu[k];
            dhx[k] = a * fmaf(2.f * gv[k], d, gm[k]);
            dxx[k] = a * fmaf(gm[k], d, gv[k] * fmaf(d, d, -var[k]));
          }
          store(dlogits, base + t * row_bytes, pack<BF>(dxx));
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) dhx[k] = inv[k] * fmaf(2.f * gv[k], hx[k] - mu[k], gm[k]);
        }
        store(dh, base + t * row_bytes, pack<BF>(dhx));
      }
    }
  }
}

template <bool BF>
void launch(dim3 grid, cudaStream_t s, const void* h, const void* logits, float* mean,
            float* stdv, int T, int C, int ld, float eps) {
  const dim3 block(kVecs, kGroups);
  if (logits)
    asp_stats_kernel<BF, true, false><<<grid, block, 0, s>>>(h, logits, mean, stdv, T, C, ld, eps,
                                                             nullptr, nullptr);
  else
    asp_stats_kernel<BF, false, false><<<grid, block, 0, s>>>(h, nullptr, mean, stdv, T, C, ld,
                                                              eps, nullptr, nullptr);
}

template <bool BF>
void launch_bwd(dim3 grid, cudaStream_t s, const void* h, const void* logits, const float* mean,
                const float* stdv, const float* mx, const float* sum, const float* gmean,
                const float* gstd, void* dh, void* dlogits, int T, int C, int ld, int ldg,
                float eps) {
  const dim3 block(kVecs, kGroups);
  if (logits)
    asp_stats_bwd_kernel<BF, true><<<grid, block, 0, s>>>(h, logits, mean, stdv, mx, sum, gmean,
                                                          gstd, dh, dlogits, T, C, ld, ldg, eps);
  else
    asp_stats_bwd_kernel<BF, false><<<grid, block, 0, s>>>(h, nullptr, mean, stdv, nullptr,
                                                           nullptr, gmean, gstd, dh, nullptr, T,
                                                           C, ld, ldg, eps);
}

bool bad_shape(int B, int T, int C, int ld) {
  return B < 1 || T < 1 || C < 8 || C % 8 != 0 || ld < C || ld % 4 != 0;
}

}  // namespace

// h (B, T, C) bf16 or f32 contiguous; logits likewise in h's dtype, or NULL
// for the unweighted mode; mean, stdv f32 out, row b at b * ld (the
// weighted mode: stdv = mean + C in one (B, 2C) tensor, ld = 2C; the
// unweighted: two (B, C) tensors, ld = C); bf16: 1 for bf16, 0 for f32.
extern "C" int vm_asp_stats(const void* h, const void* logits, void* mean, void* stdv, int B,
                            int T, int C, int ld, int bf16, float eps, void* stream) {
  if (bad_shape(B, T, C, ld)) return (int)cudaErrorInvalidValue;
  const int nvec = C / (bf16 ? 8 : 4);
  const dim3 grid(B, (nvec + kVecs - 1) / kVecs);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<true>(grid, s, h, logits, (float*)mean, (float*)stdv, T, C, ld, eps);
  else
    launch<false>(grid, s, h, logits, (float*)mean, (float*)stdv, T, C, ld, eps);
  return (int)cudaGetLastError();
}

// The weighted mode for training: vm_asp_stats's outputs, and the softmax's
// max and sum of each (b, c) into mx and sum, each (B, C) f32.
extern "C" int vm_asp_stats_train(const void* h, const void* logits, void* mean, void* stdv,
                                  void* mx, void* sum, int B, int T, int C, int ld, int bf16,
                                  float eps, void* stream) {
  if (bad_shape(B, T, C, ld) || !logits) return (int)cudaErrorInvalidValue;
  const int nvec = C / (bf16 ? 8 : 4);
  const dim3 grid(B, (nvec + kVecs - 1) / kVecs), block(kVecs, kGroups);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    asp_stats_kernel<true, true, true><<<grid, block, 0, s>>>(
        h, logits, (float*)mean, (float*)stdv, T, C, ld, eps, (float*)mx, (float*)sum);
  else
    asp_stats_kernel<false, true, true><<<grid, block, 0, s>>>(
        h, logits, (float*)mean, (float*)stdv, T, C, ld, eps, (float*)mx, (float*)sum);
  return (int)cudaGetLastError();
}

// The backward of either mode: h (and logits, or NULL for the unweighted
// mode) as the forward took them; mean, stdv its outputs (row b at b * ld);
// mx, sum the softmax's max and sum from vm_asp_stats_train (weighted only);
// gmean, gstd the outputs' gradients (row b at b * ldg; either may be NULL
// for zero); dh (and dlogits) written in h's dtype, h's shape.
extern "C" int vm_asp_stats_bwd(const void* h, const void* logits, const void* mean,
                                const void* stdv, const void* mx, const void* sum,
                                const void* gmean, const void* gstd, void* dh, void* dlogits,
                                int B, int T, int C, int ld, int ldg, int bf16, float eps,
                                void* stream) {
  if (bad_shape(B, T, C, ld) || ldg < C || (logits && (!mx || !sum || !dlogits)))
    return (int)cudaErrorInvalidValue;
  const int nvec = C / (bf16 ? 8 : 4);
  const dim3 grid(B, (nvec + kVecs - 1) / kVecs);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fm = (const float*)mean, *fs = (const float*)stdv, *fx = (const float*)mx,
              *fu = (const float*)sum, *gm = (const float*)gmean, *gs = (const float*)gstd;
  if (bf16)
    launch_bwd<true>(grid, s, h, logits, fm, fs, fx, fu, gm, gs, dh, dlogits, T, C, ld, ldg, eps);
  else
    launch_bwd<false>(grid, s, h, logits, fm, fs, fx, fu, gm, gs, dh, dlogits, T, C, ld, ldg,
                      eps);
  return (int)cudaGetLastError();
}
