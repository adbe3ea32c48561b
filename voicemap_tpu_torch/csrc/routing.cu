// B7: the max-pool and BatchNorm passes of the blocks-1+ train op, one pass
// over the conv's raw output in each direction, channels last.
//
// Replaces voicemap_tpu/ops/pallas_routing.py :: _pool_fwd_kernel (wrapper
// pallas_pool_fwd) and _route_bwd_kernel (wrapper pallas_route_bwd), with the
// conv's bias and relu folded in (voicemap_tpu/ops/conv_train.py, routing
// "pallas": relu(conv + b.astype(dtype)) before the pool kernel). The layout
// is (B, T, C), the JAX package's own and cuDNN's NHWC: the pool's phases of
// a position are neighbouring rows of C channels.
//
// z is the conv's output without its bias, in the activation dtype; with
// round() to that dtype and, per channel c,
//   a = relu(round(z + round(bias[c]))),
// Forward, s = sgn[c]:
//   a_sel[b, p, c] = s * max_j(s * a[b, p*pool + j, c])   (a value of a, exact)
//   sum a, sum a^2 over every position, per channel, in f32.
// a is never written: the backward recomputes it from z bit for bit.
// Backward: g (f32) rounded to a's dtype (as the TPU wrapper casts it),
// routed to the first phase j whose a equals a_sel (value ties are
// selection ties, so first-match is XLA's first-maximal routing), then
//   dz = a > 0 ? (c0*g_j + c1) + c2*a : 0      (f32, op by op, no FMA)
// written in the output dtype, and sum dz (the bias gradient) in f32.
//
// The phase-index mode (the pool-rate-residual variant of the op,
// voicemap_tpu/ops/conv_train.py make_fused_blockn_train(save_act=False)):
// the forward also writes idx[b, p, c] (int8), the first phase j whose s * a
// is the strict max (strict > from -inf, the rule the value mode's
// first-match routing follows), and the backward reads idx in place of a_sel
// and routes g to phase idx. The backward there recomputes a from another
// conv than the forward's (bf16 against f32), so routing by value could miss.
// Each mode is its own template instance; the value mode's code is unchanged.
//
// What bounds them on the H100: bytes, at a few operations an element.
// Config #1's block 1 at B=32 reads 49 MB of bf16 z; the forward writes
// a_sel (half that), the backward reads a_sel and g (f32) and writes dz.
// Design: each thread owns W consecutive channels, 16 bytes of z (8 bf16 or
// 4 f32; one channel where C or an address does not allow the vector), and
// loads a position's `pool` phases as `pool` vector loads, for kUnroll
// positions before it uses any. A CTA covers a strip of pooled positions of
// one batch row over up to kThreads vectors of channels; each thread keeps
// its channels' sums in registers over the strip, the CTA folds its
// threads' sums in shared memory in a fixed order and writes one partial
// row, and fold.cuh sums the partial rows in a fixed order: every sum
// repeats bit for bit from run to run, with no atomics. The host
// (ops/cuda_routing.launch_plan) sizes the strips so that the CTAs fill the
// card once at B=32 as well as at 2048.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // positions a thread loads before it uses them
// CTAs an SM holds at once (registers capped to allow it): the host's
// launch_plan sizes the strips to fill the card once at these.
constexpr int kFwdCtasPerSm = 3;
constexpr int kBwdCtasPerSm = 2;

struct F32 {
  static constexpr int kSize = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
};
struct BF16 {
  static constexpr int kSize = 2;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// W elements of type E as raw 32-bit words (one 16-bit half for a lone bf16),
// moved as 16-, 8-, 4- or 2-byte accesses.
template <typename E, int W>
struct Vec {
  static constexpr int kBytes = E::kSize * W;
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  unsigned w[kWords];

  __device__ __forceinline__ void load(const void* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ void store(void* p) const {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  }

  __device__ __forceinline__ float get(int k) const {
    if constexpr (E::kSize == 4) {
      return __uint_as_float(w[k]);
    } else {
      return __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u) : (w[k >> 1] << 16));
    }
  }

  // Elements are set in order 0, 1, ...: an even one starts its word.
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (E::kSize == 4) {
      w[k] = __float_as_uint(v);
    } else {
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      if (k & 1)
        w[k >> 1] |= h << 16;
      else
        w[k >> 1] = h;
    }
  }
};

// W phase indices, one byte each, moved as 8-, 4- or 1-byte accesses.
template <int W>
struct IdxVec {
  static constexpr int kWords = W >= 4 ? W / 4 : 1;
  unsigned w[kWords];

  __device__ __forceinline__ void load(const void* p) {
    if constexpr (W == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (W == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      static_assert(W == 1, "IdxVec: 1, 4 or 8 indices");
      w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
    }
  }

  __device__ __forceinline__ void store(void* p) const {
    if constexpr (W == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (W == 4) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned char*>(p) = (unsigned char)w[0];
    }
  }

  __device__ __forceinline__ int get(int k) const { return (w[k >> 2] >> (8 * (k & 3))) & 0xff; }

  // Indices are set in order 0, 1, ...: every fourth one starts its word.
  __device__ __forceinline__ void set(int k, int j) {
    if (k & 3)
      w[k >> 2] |= (unsigned)j << (8 * (k & 3));
    else
      w[k >> 2] = (unsigned)j;
  }
};

struct I8 {
  static constexpr int kSize = 1;
};

template <typename E>
__device__ __forceinline__ const char* at(const void* base, long long elem) {
  return reinterpret_cast<const char*>(base) + elem * E::kSize;
}
template <typename E>
__device__ __forceinline__ char* at(void* base, long long elem) {
  return reinterpret_cast<char*>(base) + elem * E::kSize;
}

// relu that keeps a NaN, as torch.relu does, and turns -0 into +0.
__device__ __forceinline__ float relu(float v) { return !(v <= 0.f) ? v : 0.f; }

// Where a CTA works: batch row, strip of pooled positions, vector columns.
struct Tile {
  int b, p_begin, p_end, col0, ncols, rows, col, r, c;
  __device__ Tile(int C, int W, int tp, int strips, int span) {
    b = blockIdx.x / strips;
    const int strip = blockIdx.x % strips;
    p_begin = strip * span;
    p_end = min(tp, p_begin + span);
    col0 = blockIdx.y * kThreads;
    ncols = min(C / W - col0, kThreads);
    rows = kThreads / ncols;  // positions a pass of the CTA covers
    col = threadIdx.x % ncols;
    r = threadIdx.x / ncols;
    c = (col0 + col) * W;
  }
};

// Each thread's W sums (NSUM of them) into shared memory, then one partial row
// of the CTA: column ch summed over the CTA's position rows 0, 1, ... in order.
template <int W, int NSUM>
__device__ __forceinline__ void fold_cta(const Tile& t, const float (&sums)[NSUM][W],
                                         float* red, float* part_row, int C) {
  const int nch = t.ncols * W;
  if (t.r < t.rows) {
#pragma unroll
    for (int s = 0; s < NSUM; ++s)
#pragma unroll
      for (int k = 0; k < W; ++k) red[s * kThreads * W + threadIdx.x * W + k] = sums[s][k];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < nch; ch += kThreads) {
#pragma unroll
    for (int s = 0; s < NSUM; ++s) {
      float total = 0.f;
      for (int i = 0; i < t.rows; ++i)
        total = __fadd_rn(total, red[s * kThreads * W + i * nch + ch]);
      part_row[s * C + t.col0 * W + ch] = total;
    }
  }
}

template <typename AE, typename SE, int W, bool IDX>
struct FwdState {
  float sums[2][W];  // sum a, sum a^2
  float sg[W], bq[W];

  __device__ void init(const float* bias, const float* sgn, int c) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      sums[0][k] = 0.f;
      sums[1][k] = 0.f;
      sg[k] = sgn[c + k];
      bq[k] = AE::round(bias[c + k]);
    }
  }

  // One position: its phases v[0..pool), then a_sel stored at `out` (and,
  // in the index mode, the selected phase at `idx_out`).
  template <int POOL>
  __device__ __forceinline__ void position(const Vec<AE, W>* v, int pool, void* out,
                                           void* idx_out) {
    float best[W];
    int first[W];  // the index mode's: the first phase of the strict max
#pragma unroll
    for (int k = 0; k < W; ++k) {
      best[k] = __int_as_float(0xff800000);  // -inf
      if constexpr (IDX) first[k] = 0;
    }
    const int n = POOL > 0 ? POOL : pool;  // a constant where POOL is: unrolled
#pragma unroll
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float a = relu(AE::round(__fadd_rn(v[j].get(k), bq[k])));
        sums[0][k] = __fadd_rn(sums[0][k], a);
        sums[1][k] = __fadd_rn(sums[1][k], __fmul_rn(a, a));
        if constexpr (IDX) {
          const float s = __fmul_rn(a, sg[k]);
          if (s > best[k]) first[k] = j;
          best[k] = fmaxf(best[k], s);
        } else {
          best[k] = fmaxf(best[k], __fmul_rn(a, sg[k]));
        }
      }
    }
    Vec<SE, W> o;
#pragma unroll
    for (int k = 0; k < W; ++k) o.set(k, __fmul_rn(best[k], sg[k]));
    o.store(out);
    if constexpr (IDX) {
      IdxVec<W> q;
#pragma unroll
      for (int k = 0; k < W; ++k) q.set(k, first[k]);
      q.store(idx_out);
    }
  }
};

// POOL > 0: the pool as a constant, kUnroll positions' loads in flight;
// POOL == 0: any pool, one position at a time (at most kMaxPool phases held).
constexpr int kMaxPool = 8;

template <typename AE, typename SE, int W, int POOL, bool IDX>
__global__ void __launch_bounds__(kThreads, kFwdCtasPerSm)
pool_fwd_kernel(const void* __restrict__ z, const float* __restrict__ bias,
                const float* __restrict__ sgn, void* __restrict__ sel, void* __restrict__ idx,
                float* __restrict__ part, int C, int T, int pool_rt, int strips, int span) {
  __shared__ float red[2 * kThreads * W];
  const int pool = POOL ? POOL : pool_rt;
  const int tp = T / pool;
  const Tile t(C, W, tp, strips, span);
  FwdState<AE, SE, W, IDX> st;
  if (t.r < t.rows) {
    st.init(bias, sgn, t.c);
    const long long zrow = (long long)t.b * T, srow = (long long)t.b * tp;
    if constexpr (POOL > 0) {
      for (int p = t.p_begin + t.r; p < t.p_end; p += kUnroll * t.rows) {
        Vec<AE, W> v[kUnroll][POOL];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * t.rows;
          if (u == 0 || q < t.p_end) {
#pragma unroll
            for (int j = 0; j < POOL; ++j)
              v[u][j].load(at<AE>(z, (zrow + (long long)q * POOL + j) * C + t.c));
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * t.rows;
          if (u == 0 || q < t.p_end)
            st.template position<POOL>(v[u], POOL, at<SE>(sel, (srow + q) * C + t.c),
                                       at<I8>(idx, (srow + q) * C + t.c));
        }
      }
    } else {
      for (int p = t.p_begin + t.r; p < t.p_end; p += t.rows) {
        Vec<AE, W> v[kMaxPool];
        for (int j = 0; j < pool; ++j)
          v[j].load(at<AE>(z, (zrow + (long long)p * pool + j) * C + t.c));
        st.template position<0>(v, pool, at<SE>(sel, (srow + p) * C + t.c),
                                at<I8>(idx, (srow + p) * C + t.c));
      }
    }
  }
  fold_cta<W, 2>(t, st.sums, red, part + (long long)blockIdx.x * 2 * C, C);
}

// The dz constants, (C,) each.
struct Consts {
  const float *c0, *c1, *c2;
};

template <typename AE, typename OE, int W, bool IDX>
struct BwdState {
  float sums[1][W];  // sum dz
  float bq[W], c0[W], c1[W], c2[W];

  __device__ void init(const float* bias, const Consts& cc, int c) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      sums[0][k] = 0.f;
      bq[k] = AE::round(bias[c + k]);
      c0[k] = cc.c0[c + k];
      c1[k] = cc.c1[c + k];
      c2[k] = cc.c2[c + k];
    }
  }

  // One position: a_sel (the index mode: idx), g and the phases
  // v[0..pool); dz of phase j at out[j].
  template <int POOL, class SV>
  __device__ __forceinline__ void position(const SV& sv, const Vec<F32, W>& gv,
                                           const Vec<AE, W>* v, int pool, void* out,
                                           long long phase_stride) {
    float s[W], gq[W];
    int want[W];
    bool taken[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (IDX)
        want[k] = sv.get(k);
      else
        s[k] = sv.get(k);
      gq[k] = AE::round(gv.get(k));
      taken[k] = false;
    }
    const int n = POOL > 0 ? POOL : pool;  // a constant where POOL is: unrolled
#pragma unroll
    for (int j = 0; j < n; ++j) {
      Vec<OE, W> o;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float a = relu(AE::round(__fadd_rn(v[j].get(k), bq[k])));
        bool eq;
        if constexpr (IDX) {
          eq = j == want[k];
        } else {
          eq = !taken[k] && a == s[k];
          taken[k] = taken[k] || eq;
        }
        const float gj = eq ? gq[k] : 0.f;
        const float d = a > 0.f
            ? __fadd_rn(__fadd_rn(__fmul_rn(c0[k], gj), c1[k]), __fmul_rn(c2[k], a)) : 0.f;
        sums[0][k] = __fadd_rn(sums[0][k], d);
        o.set(k, d);
      }
      o.store(reinterpret_cast<char*>(out) + j * phase_stride);
    }
  }
};

// asel: a_sel in a's dtype, or in the index mode idx (int8).
template <typename AE, typename OE, int W, int POOL, bool IDX>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
route_bwd_kernel(const void* __restrict__ z, const float* __restrict__ bias,
                 const void* __restrict__ asel, const float* __restrict__ g,
                 const Consts cc, void* __restrict__ dz,
                 float* __restrict__ part, int C, int T, int pool_rt, int strips, int span) {
  using SelE = std::conditional_t<IDX, I8, AE>;
  using SelV = std::conditional_t<IDX, IdxVec<W>, Vec<AE, W>>;
  __shared__ float red[kThreads * W];
  const int pool = POOL ? POOL : pool_rt;
  const int tp = T / pool;
  const Tile t(C, W, tp, strips, span);
  BwdState<AE, OE, W, IDX> st;
  const long long dz_phase = (long long)C * OE::kSize;
  if (t.r < t.rows) {
    st.init(bias, cc, t.c);
    const long long zrow = (long long)t.b * T, srow = (long long)t.b * tp;
    if constexpr (POOL > 0) {
      for (int p = t.p_begin + t.r; p < t.p_end; p += kUnroll * t.rows) {
        SelV sv[kUnroll];
        Vec<AE, W> v[kUnroll][POOL];
        Vec<F32, W> gv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * t.rows;
          if (u == 0 || q < t.p_end) {
            sv[u].load(at<SelE>(asel, (srow + q) * C + t.c));
            gv[u].load(at<F32>(g, (srow + q) * C + t.c));
#pragma unroll
            for (int j = 0; j < POOL; ++j)
              v[u][j].load(at<AE>(z, (zrow + (long long)q * POOL + j) * C + t.c));
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = p + u * t.rows;
          if (u == 0 || q < t.p_end)
            st.template position<POOL>(sv[u], gv[u], v[u], POOL,
                                       at<OE>(dz, (zrow + (long long)q * POOL) * C + t.c),
                                       dz_phase);
        }
      }
    } else {
      for (int p = t.p_begin + t.r; p < t.p_end; p += t.rows) {
        SelV sv;
        Vec<AE, W> v[kMaxPool];
        Vec<F32, W> gv;
        sv.load(at<SelE>(asel, (srow + p) * C + t.c));
        gv.load(at<F32>(g, (srow + p) * C + t.c));
        for (int j = 0; j < pool; ++j)
          v[j].load(at<AE>(z, (zrow + (long long)p * pool + j) * C + t.c));
        st.template position<0>(sv, gv, v, pool, at<OE>(dz, (zrow + (long long)p * pool) * C + t.c),
                                dz_phase);
      }
    }
  }
  fold_cta<W, 1>(t, st.sums, red, part + (long long)blockIdx.x * C, C);
}

int check_plan(int B, int C, int T, int pool, int vec, int max_vec, int strips, int span) {
  if (B < 1 || C < 1 || pool < 1 || pool > kMaxPool || T < pool || T % pool ||
      (vec != 1 && vec != max_vec) || C % vec || strips < 1 || span < 1)
    return (int)cudaErrorInvalidValue;
  const int tp = T / pool;
  if ((long long)strips * span < tp || (long long)(strips - 1) * span >= tp ||
      (long long)B * strips > 0x7fffffffLL || (C / vec + kThreads - 1) / kThreads > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(int B, int C, int vec, int strips) {
  return dim3(B * strips, (C / vec + kThreads - 1) / kThreads);
}

template <typename AE, typename SE, int W, bool IDX>
void launch_fwd(dim3 grid, cudaStream_t s, const void* z, const float* bias, const float* sgn,
                void* sel, void* idx, float* part, int C, int T, int pool, int strips,
                int span) {
  if constexpr (W > 1) {
    if (pool == 2)
      return pool_fwd_kernel<AE, SE, W, 2, IDX><<<grid, kThreads, 0, s>>>(
          z, bias, sgn, sel, idx, part, C, T, pool, strips, span);
    if (pool == 4)
      return pool_fwd_kernel<AE, SE, W, 4, IDX><<<grid, kThreads, 0, s>>>(
          z, bias, sgn, sel, idx, part, C, T, pool, strips, span);
  }
  pool_fwd_kernel<AE, SE, W, 0, IDX><<<grid, kThreads, 0, s>>>(z, bias, sgn, sel, idx, part, C,
                                                               T, pool, strips, span);
}

template <typename AE, typename SE, bool IDX>
void launch_fwd_w(int vec, dim3 grid, cudaStream_t s, const void* z, const float* bias,
                  const float* sgn, void* sel, void* idx, float* part, int C, int T, int pool,
                  int strips, int span) {
  if (vec > 1)
    launch_fwd<AE, SE, 16 / AE::kSize, IDX>(grid, s, z, bias, sgn, sel, idx, part, C, T, pool,
                                            strips, span);
  else
    launch_fwd<AE, SE, 1, IDX>(grid, s, z, bias, sgn, sel, idx, part, C, T, pool, strips, span);
}

template <typename AE, typename SE>
void launch_fwd_mode(int vec, dim3 grid, cudaStream_t s, const void* z, const float* bias,
                     const float* sgn, void* sel, void* idx, float* part, int C, int T, int pool,
                     int strips, int span) {
  if (idx)
    launch_fwd_w<AE, SE, true>(vec, grid, s, z, bias, sgn, sel, idx, part, C, T, pool, strips,
                               span);
  else
    launch_fwd_w<AE, SE, false>(vec, grid, s, z, bias, sgn, sel, idx, part, C, T, pool, strips,
                                span);
}

template <typename AE, typename OE, int W, bool IDX>
void launch_bwd(dim3 grid, cudaStream_t s, const void* z, const float* bias, const void* asel,
                const float* g, const Consts cc, void* dz, float* part, int C, int T, int pool,
                int strips, int span) {
  if constexpr (W > 1) {
    if (pool == 2)
      return route_bwd_kernel<AE, OE, W, 2, IDX><<<grid, kThreads, 0, s>>>(
          z, bias, asel, g, cc, dz, part, C, T, pool, strips, span);
    if (pool == 4)
      return route_bwd_kernel<AE, OE, W, 4, IDX><<<grid, kThreads, 0, s>>>(
          z, bias, asel, g, cc, dz, part, C, T, pool, strips, span);
  }
  route_bwd_kernel<AE, OE, W, 0, IDX><<<grid, kThreads, 0, s>>>(z, bias, asel, g, cc, dz, part,
                                                                C, T, pool, strips, span);
}

template <typename AE, typename OE, bool IDX>
void launch_bwd_w(int vec, dim3 grid, cudaStream_t s, const void* z, const float* bias,
                  const void* asel, const float* g, const Consts cc, void* dz, float* part,
                  int C, int T, int pool, int strips, int span) {
  if (vec > 1)
    launch_bwd<AE, OE, 16 / AE::kSize, IDX>(grid, s, z, bias, asel, g, cc, dz, part, C, T, pool,
                                            strips, span);
  else
    launch_bwd<AE, OE, 1, IDX>(grid, s, z, bias, asel, g, cc, dz, part, C, T, pool, strips,
                               span);
}

template <typename AE, typename OE>
void launch_bwd_mode(bool by_idx, int vec, dim3 grid, cudaStream_t s, const void* z,
                     const float* bias, const void* asel, const float* g, const Consts cc,
                     void* dz, float* part, int C, int T, int pool, int strips, int span) {
  if (by_idx)
    launch_bwd_w<AE, OE, true>(vec, grid, s, z, bias, asel, g, cc, dz, part, C, T, pool, strips,
                               span);
  else
    launch_bwd_w<AE, OE, false>(vec, grid, s, z, bias, asel, g, cc, dz, part, C, T, pool,
                                strips, span);
}

}  // namespace

// z (B, T, C) f32 or bf16; bias, sgn (C,) f32; sel (B, T/pool, C) f32 or
// bf16; idx (B, T/pool, C) int8 out, or NULL for the value mode (no index
// written); part (B*strips, 2, C) f32 scratch; stats (2, C) f32 out: sum a,
// sum a^2. vec: 1, or 16 bytes of z a thread (every pointer 16-byte
// aligned, C a multiple of it); strips * span covers T/pool once.
extern "C" int vm_pool_fwd(const void* z, const void* bias, const void* sgn, void* sel,
                           void* idx, void* part, void* stats, int B, int C, int T, int pool,
                           int vec, int strips, int span, int a_bf16, int sel_bf16,
                           void* stream) {
  if (int err = check_plan(B, C, T, pool, vec, a_bf16 ? 8 : 4, strips, span)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(B, C, vec, strips);
  const float* bf = (const float*)bias;
  const float* sf = (const float*)sgn;
  float* pf = (float*)part;
  if (a_bf16 && sel_bf16)
    launch_fwd_mode<BF16, BF16>(vec, grid, s, z, bf, sf, sel, idx, pf, C, T, pool, strips, span);
  else if (a_bf16)
    launch_fwd_mode<BF16, F32>(vec, grid, s, z, bf, sf, sel, idx, pf, C, T, pool, strips, span);
  else if (sel_bf16)
    launch_fwd_mode<F32, BF16>(vec, grid, s, z, bf, sf, sel, idx, pf, C, T, pool, strips, span);
  else
    launch_fwd_mode<F32, F32>(vec, grid, s, z, bf, sf, sel, idx, pf, C, T, pool, strips, span);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, B * strips, 2 * C, (float*)stats, s);
  return (int)cudaGetLastError();
}

// z (B, T, C) and a_sel (B, T/pool, C) in one dtype (f32 or bf16), or with
// by_idx the forward's idx (B, T/pool, C) int8 in a_sel's place; bias (C,)
// f32; g (B, T/pool, C) f32; c0, c1, c2 (C,) f32; dz (B, T, C) f32 or
// bf16; part (B*strips, C) f32 scratch; db (C,) f32 out. vec, strips and
// span as for vm_pool_fwd.
extern "C" int vm_route_bwd(const void* z, const void* bias, const void* asel, const void* g,
                            const void* c0, const void* c1, const void* c2, void* dz, void* part,
                            void* db, int B, int C, int T, int pool, int vec, int strips,
                            int span, int a_bf16, int out_bf16, int by_idx, void* stream) {
  if (int err = check_plan(B, C, T, pool, vec, a_bf16 ? 8 : 4, strips, span)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(B, C, vec, strips);
  const float* bf = (const float*)bias;
  const float* gf = (const float*)g;
  const Consts cf{(const float*)c0, (const float*)c1, (const float*)c2};
  float* pf = (float*)part;
  const bool ix = by_idx != 0;
  if (a_bf16 && out_bf16)
    launch_bwd_mode<BF16, BF16>(ix, vec, grid, s, z, bf, asel, gf, cf, dz, pf, C, T, pool,
                                strips, span);
  else if (a_bf16)
    launch_bwd_mode<BF16, F32>(ix, vec, grid, s, z, bf, asel, gf, cf, dz, pf, C, T, pool,
                               strips, span);
  else if (out_bf16)
    launch_bwd_mode<F32, BF16>(ix, vec, grid, s, z, bf, asel, gf, cf, dz, pf, C, T, pool,
                               strips, span);
  else
    launch_bwd_mode<F32, F32>(ix, vec, grid, s, z, bf, asel, gf, cf, dz, pf, C, T, pool,
                              strips, span);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  vm_fold::fold_rows(pf, B * strips, C, (float*)db, s);
  return (int)cudaGetLastError();
}
