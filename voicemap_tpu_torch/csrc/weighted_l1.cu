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
// the f32 CUDA cores: at least two instructions a term, at 132 SMs x 128
// lanes a clock. At (1, 4096, 4096, 64) that is 2.1 G instructions, 0.064
// ms, against 0.021 ms for its 69 MB of bytes.
//
// The order, pinned so that the kernel and its plain version
// (ops/cuda_distance.py :: weighted_l1_reference) agree bit for bit:
// |q - s|·w_d = sign(w_d)·|q·|w_d| - s·|w_d||, so each operand is scaled by
// |w_d| once, rounded, when it is staged (q' = q·|w_d|, s' = s·|w_d|), and a
// term is one rounded subtract and one rounded add of its magnitude, with the
// sign of w_d: acc = acc ± |q' - s'| (the abs and the sign are operand
// modifiers of the add), in d order from 0, then + b last. The sign is one
// per dim, the same for a whole CTA, so the branch on it costs nothing a
// term. That is the two instructions a term that the bound counts.
// - nq > 1: one CTA owns a 128 x 128 output tile of one t; its 256 threads
//   each keep an 8 x 8 register micro-tile (rows 4ty..4ty+3 and 64 + the
//   same, columns likewise by tx), so a half-warp writes 16 x 16
//   neighbouring bytes of a row. q' and s' are staged 16 dims at a time,
//   dim-major, and read with 16-byte shared loads: four a dim for 64 terms.
//   The next chunk's loads are issued into registers before this chunk is
//   summed and stored (scaled) into the other of two buffers after it, so no
//   warp waits on its staging; one barrier a chunk.
// - nq == 1 (the n-shot (T, 1, P) and verification (P, 1, 1) forms): one
//   thread owns one output (t, j); a CTA's 128 consecutive s rows (and their
//   q rows) are read by warps along the dims, coalesced, and staged
//   transposed, 32 dims at a time, so each thread then reads its own column.
// Ragged edges are masked in the kernel; nothing is padded in device memory.
// Any T, nq, ns >= 1 (T and the tile rows under 65536 in the tiled form) and
// 1 <= D <= kMaxD = 1024.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // output rows and columns of a CTA (nq > 1)
constexpr int kMicro = 8;      // a thread's outputs along each axis
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kChunk = 16;     // dims a chunk (tiled form)
constexpr int kPitch = kTile + 4;  // a staged dim's row: 16-byte aligned, stores off by 4 banks
constexpr int kLoads = kTile * kChunk / kThreads;  // a thread's loads of an operand a chunk
constexpr int kRowThreads = 128;  // row form: one output a thread
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowsPerWarp = kRowThreads / kRowWarps;  // rows a warp stages a chunk
constexpr int kRowChunk = 32;     // dims a chunk (row form): a warp's lanes
constexpr int kMaxD = 1024;

// acc ± |q' - s'|, rounded: the pinned term.
template <bool NEG>
__device__ __forceinline__ float term(float acc, float qv, float sv) {
  const float d = fabsf(__fsub_rn(qv, sv));
  return NEG ? __fsub_rn(acc, d) : __fadd_rn(acc, d);
}

template <bool NEG>
__device__ __forceinline__ void outer(float (&acc)[kMicro][kMicro], const float (&qv)[kMicro],
                                      const float (&sv)[kMicro]) {
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[a][c] = term<NEG>(acc[a][c], qv[a], sv[c]);
}

__device__ __forceinline__ void unpack(float (&v)[kMicro], const float* row, int k) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * k);
  const float4 hi = *reinterpret_cast<const float4*>(row + kTile / 2 + 4 * k);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const float* __restrict__ q, const float* __restrict__ s,
            const float* __restrict__ w, const float* __restrict__ b,
            float* __restrict__ out, int nq, int ns, int D) {
  __shared__ __align__(16) float qs[2][kChunk][kPitch];
  __shared__ __align__(16) float ss[2][kChunk][kPitch];
  __shared__ bool neg[2][kChunk];
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* qt = q + (long long)t * nq * D;
  const float* st = s + (long long)t * ns * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Staging: a thread loads dim dd of rows r0, r0 + 16, ... of both operands.
  const int dd = threadIdx.x % kChunk, r0 = threadIdx.x / kChunk;
  float rq[kLoads], rs[kLoads], rw = 0.f;
  auto load = [&](int d0) {
    const int d = d0 + dd;
    const bool in_d = d < D;
    rw = in_d ? w[d] : 0.f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int r = r0 + k * (kThreads / kChunk);
      rq[k] = (in_d && i0 + r < nq) ? qt[(long long)(i0 + r) * D + d] : 0.f;
      rs[k] = (in_d && j0 + r < ns) ? st[(long long)(j0 + r) * D + d] : 0.f;
    }
  };
  auto store = [&](int buf) {
    const float wa = fabsf(rw);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int r = r0 + k * (kThreads / kChunk);
      qs[buf][dd][r] = __fmul_rn(rq[k], wa);
      ss[buf][dd][r] = __fmul_rn(rs[k], wa);
    }
    if (r0 == 0) neg[buf][dd] = rw < 0.f;
  };

  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[a][c] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const bool more = d0 + kChunk < D;
    if (more) load(d0 + kChunk);  // in flight while this chunk is summed
    const int kc = min(kChunk, D - d0);
    for (int k = 0; k < kc; ++k) {
      float qv[kMicro], sv[kMicro];
      unpack(qv, qs[buf][k], ty);
      unpack(sv, ss[buf][k], tx);
      if (neg[buf][k])
        outer<true>(acc, qv, sv);
      else
        outer<false>(acc, qv, sv);
    }
    // The other buffer's last readers passed the previous barrier.
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const float bias = *b;
  float* ot = out + (long long)t * nq * ns;
  const bool vec = (ns & 3) == 0;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + (a < 4 ? 4 * ty + a : kTile / 2 + 4 * ty + a - 4);
    if (i >= nq) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * kTile / 2 + 4 * tx;
      float* o = ot + (long long)i * ns + j;
      const float v[4] = {__fadd_rn(acc[a][4 * h], bias), __fadd_rn(acc[a][4 * h + 1], bias),
                          __fadd_rn(acc[a][4 * h + 2], bias), __fadd_rn(acc[a][4 * h + 3], bias)};
      if (vec && j + 3 < ns) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < ns) o[c] = v[c];
      }
    }
  }
}

// nq == 1: output o = t * ns + j, one a thread; s row o, q row t.
__global__ void __launch_bounds__(kRowThreads)
row_kernel(const float* __restrict__ q, const float* __restrict__ s,
           const float* __restrict__ w, const float* __restrict__ b,
           float* __restrict__ out, long long n_out, int ns, int D) {
  __shared__ float qs[kRowChunk][kRowThreads + 1];
  __shared__ float ss[kRowChunk][kRowThreads + 1];
  __shared__ long long qrow[kRowThreads];
  __shared__ bool neg[kRowChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long o0 = (long long)blockIdx.x * kRowThreads;
  const long long o = o0 + threadIdx.x;
  qrow[threadIdx.x] = o < n_out ? o / ns : -1;
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += kRowChunk) {
    const int kc = min(kRowChunk, D - d0);
    const bool in_d = lane < kc;
    const float wv = in_d ? w[d0 + lane] : 0.f;
    const float wa = fabsf(wv);
    __syncthreads();  // qrow is written (first chunk); the last chunk's readers are done
    if (warp == 0) neg[lane] = wv < 0.f;
    // A warp reads one row's run of dims at a time (coalesced), rows r =
    // warp, warp + 4, ..., every load issued before the first store, and
    // stores each run as a column.
    float qv[kRowsPerWarp], sv[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + k * kRowWarps;
      const long long qr = qrow[r];
      qv[k] = sv[k] = 0.f;
      if (in_d && qr >= 0) {
        qv[k] = q[qr * D + d0 + lane];
        sv[k] = s[(o0 + r) * D + d0 + lane];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + k * kRowWarps;
      qs[lane][r] = __fmul_rn(qv[k], wa);
      ss[lane][r] = __fmul_rn(sv[k], wa);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k)
      acc = neg[k] ? term<true>(acc, qs[k][threadIdx.x], ss[k][threadIdx.x])
                   : term<false>(acc, qs[k][threadIdx.x], ss[k][threadIdx.x]);
  }
  if (o < n_out) out[o] = __fadd_rn(acc, *b);
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
    const long long blocks = (n_out + kRowThreads - 1) / kRowThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_kernel<<<(unsigned)blocks, kRowThreads, 0, st>>>(qf, sf, wf, bf, (float*)out, n_out,
                                                         ns, D);
  } else {
    const int gx = (ns + kTile - 1) / kTile, gy = (nq + kTile - 1) / kTile;
    if (gy > 65535 || T > 65535) return (int)cudaErrorInvalidValue;
    tile_kernel<<<dim3(gx, gy, T), kThreads, 0, st>>>(qf, sf, wf, bf, (float*)out, nq, ns, D);
  }
  return (int)cudaGetLastError();
}
