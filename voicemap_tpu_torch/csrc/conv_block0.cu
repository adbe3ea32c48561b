// B2: the encoder's block 0 fused: SAME conv (Cin=1, k=32) + bias -> relu ->
// BatchNorm inference affine -> max-pool 4, writing only the pool-rate output.
//
// Replaces voicemap_tpu/ops/pallas_conv.py :: _kernel (wrapper
// pallas_conv_block0). For row b, pooled position p and channel c:
//   y_j   = sum_k x[4p + j + k - 15] * w[k, c]     (x = 0 outside [0, T))
//   out   = max_j ( relu(y_j + bias[c]) * mul[c] + add[c] ),  j = 0..3
// mul = gamma * rsqrt(var + eps) and add = beta - mean * mul come from the
// wrapper in f32. The affine is applied before the max: mul can be negative.
// x and w arrive rounded to the GEMM dtype; products are summed in f32, the
// epilogue is f32 op by op, and the output is rounded once, at the store: to
// f32, to bf16, or, on the int8 serving path, requantized from the f32
// pooled value as
//   q = clamp(round_half_even(out * inv_s0[c]), -127, 127)
// (pallas_conv.py's requant epilogue; inv_s0 = 1 / s0 from the wrapper, a
// multiply by the reciprocal as there, not a division). A tail of
// T % 4 samples is dropped (floor pooling); the conv still sees it as input.
//
// What bounds it on the H100: bytes. At B=2048, T=12000, C=128 it reads
// 98 MB and writes 1.57 GB in bf16 (0.79 GB in int8): 0.50 / 0.26 ms at
// 3.35 TB/s. Its 201 GFLOP take 0.20 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, but 3.0 ms at the f32 CUDA-core peak of 67.
//
// conv_block0_tc_kernel, the route of every call with a bf16 GEMM (the
// serving paths in bf16 and int8): the TPU kernel's own idea, a product on
// the matrix unit, as mma.sync m16n8k16 bf16 -> f32 in the direct form
// (ops/block0_tc.py): M = full-rate conv rows, K = the 32 taps (two k16
// steps), N = the channels. Every product of two bf16 values is exact in
// f32, so the tensor cores compute the function the plain version does; only
// the f32 summation order differs (chip_smoke.py states the bound). The
// TPU's form, K = 35 window samples x N = 4 phases x C, would cost 1.5x the
// products; the direct form instead orders the M rows so that the 4 pool
// phases of one pooled position land in one thread's accumulators: rows g
// and g + 8 of a warp's first m16 tile are phases 0 and 1 of position g,
// of its second phases 2 and 3. Then:
// - A is the window's Hankel matrix, never materialised: the CTA's window
//   sits in shared memory twice in bf16, as read and shifted by one sample,
//   so every fragment register (two consecutive samples) is one aligned
//   32-bit load whatever the phase's parity;
// - the packed weights (C rows of 32 taps, padded to 40 so that the B
//   fragment loads miss each other's banks) and the epilogue's rows stay in
//   shared memory for the CTA's life;
// - a warp's unit is 8 pooled positions x 32 channels: 16 mma, then the
//   epilogue in registers into the item's output tile in shared memory
//   (rows padded by 16 bytes: the epilogue's writes miss each other's
//   banks). The epilogue pools first, by the sign of mul, over the thread's
//   4 phases (max where mul >= 0, min where not), then runs + bias, relu,
//   x mul, + add once: bit for bit the affine-then-max, as B8 does. A warp
//   takes a contiguous run of units, slice-major, the same each item, so
//   its slice's B fragments and epilogue rows stay in registers;
// - the tile's rows are one contiguous run of the (B, T/4, C) output, stored
//   in 16-byte vectors while the CTA's warps, or the SM's other CTAs, go on
//   with products; the next item's window is fetched into registers while
//   this item's products run;
// - what holds the kernel is latency, not issue or bytes (PERF.md): each
//   CTA waits at two barriers an item and on the ld.shared -> mma ->
//   epilogue chain, so CTAs are small (4 warps) and many (the launch bounds
//   hold five an SM), and the SM's other CTAs fill one CTA's waits;
// - a persistent grid of (SMs x resident CTAs) walks (row, tile) items,
//   the tile 64 pooled positions, or narrower where that leaves SMs idle
//   (B = 1: 188 items of 16), so B is not capped by the grid.
//
// conv_block0_kernel, the route of gemm_dtype float32 (TF32 would not
// compute its function): the conv in f32 FMAs on the CUDA cores, taps
// summed in order k = 0..31, bit for bit the plain version. One CTA per
// (row, tile of kTile pooled outputs), one thread per channel; the tile's
// input window in shared memory, a broadcast to every thread of a warp;
// each thread keeps its channel's 32 taps and its 4 phases' sums in
// registers. Stores are channel-contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTile = 128;  // pooled outputs per CTA

enum OutKind { kF32 = 0, kBF16 = 1, kInt8 = 2 };

template <int K, int POOL, int OUT>
__global__ void conv_block0_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ aff,
                                   const float* __restrict__ inv_s0,
                                   void* __restrict__ out, int T, int C,
                                   int round_x) {
  constexpr int kPadL = (K - 1) / 2;
  constexpr int kWin = POOL * kTile + K - 1;
  __shared__ float xs[kWin];

  const int b = blockIdx.y;
  const int t_out = T / POOL;
  const int p0 = blockIdx.x * kTile;
  const long long t0 = (long long)p0 * POOL - kPadL;
  const float* xrow = x + (long long)b * T;
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) {
    const long long t = t0 + i;
    float v = (t >= 0 && t < T) ? xrow[t] : 0.f;
    if (round_x) v = __bfloat162float(__float2bfloat16(v));
    xs[i] = v;
  }
  __syncthreads();

  const int n_p = min(kTile, t_out - p0);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float wr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wr[k] = w[k * C + c];
    const float bias = aff[c], mul = aff[C + c], add = aff[2 * C + c];
    const float inv = OUT == kInt8 ? inv_s0[c] : 0.f;
    const long long obase = ((long long)b * t_out + p0) * C + c;
    for (int p = 0; p < n_p; ++p) {
      float xr[POOL + K - 1];
#pragma unroll
      for (int i = 0; i < POOL + K - 1; ++i) xr[i] = xs[p * POOL + i];
      float best = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < POOL; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(xr[j + k], wr[k], acc);
        // Rounded op by op, never contracted into an FMA, so the epilogue
        // matches the plain version's bit for bit.
        const float h = __fmul_rn(fmaxf(__fadd_rn(acc, bias), 0.f), mul);
        best = fmaxf(best, __fadd_rn(h, add));
      }
      const long long o = obase + (long long)p * C;
      if (OUT == kInt8) {
        // Half to even, as jnp.round; roundf would round halves away.
        const int q = __float2int_rn(__fmul_rn(best, inv));
        static_cast<int8_t*>(out)[o] = (int8_t)min(max(q, -127), 127);
      } else if (OUT == kBF16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(best);
      } else {
        static_cast<float*>(out)[o] = best;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route (gemm_dtype bf16): mma.sync m16n8k16, bf16 -> f32
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTaps = 32;
constexpr int kPadL = (kTaps - 1) / 2;
constexpr int kWRow = 40;   // bf16 taps a channel row: 32 + 8 of padding
constexpr int kSlice = 32;  // channels of a warp's unit
constexpr int kGroup = 8;   // pooled positions of a warp's unit

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMaxTile = 64;
constexpr int kPrefetch = (4 * kMaxTile + kTaps + 1 + kTcThreads - 1) / kTcThreads;

// A thread's share of an item's window (4·tile + 33 samples, zeros outside
// [0, T)) into registers, issued one item ahead so its latency passes
// under the current item's products.
__device__ __forceinline__ void fetch_window(float* pre, const float* __restrict__ x, int item,
                                             int n_tiles, int tile, int T, int window) {
  const int b = item / n_tiles;
  const long long t0 = 4LL * (item - b * n_tiles) * tile - kPadL;
  const float* xrow = x + (long long)b * T;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int i = threadIdx.x + k * kTcThreads;
    const long long t = t0 + i;
    pre[k] = (i <= window && t >= 0 && t < T) ? xrow[t] : 0.f;
  }
}

__device__ __forceinline__ float block0_affine(float y, float bias, float mul, float add) {
  // Rounded op by op, never contracted into an FMA, as the plain version.
  return __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(y, bias), 0.f), mul), add);
}

// One CTA of a persistent grid walks items (row b, tile of `tile` pooled
// positions), item = blockIdx.x + i·gridDim.x (ops/block0_tc.schedule).
// Shared memory: the packed weights (c_pad, kWRow) bf16 and the epilogue's
// rows [bias | mul | add | inv_s0] (c_pad each) for the CTA's life; per item
// the window of 4·tile + 32 samples in bf16 twice, as read (xe) and shifted
// by one sample (xo), so that every pair of consecutive samples an A
// fragment takes is one aligned 32-bit load; and the output tile, row
// stride `row_bytes`.
template <int OUT>
__global__ void __launch_bounds__(kTcThreads, 5)
conv_block0_tc_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                      const float* __restrict__ aff, const float* __restrict__ inv_s0,
                      void* __restrict__ out, int T, int C, int c_pad, int tile, int n_tiles,
                      int n_items, int row_bytes) {
  constexpr int kOutBytes = OUT == kF32 ? 4 : (OUT == kBF16 ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);  // pairs of taps
  float* affs = reinterpret_cast<float*>(smem + c_pad * kWRow * 2);
  const int window = 4 * tile + kTaps;
  __nv_bfloat16* xe = reinterpret_cast<__nv_bfloat16*>(affs + 4 * c_pad);
  __nv_bfloat16* xo = xe + window;
  unsigned char* stage = reinterpret_cast<unsigned char*>(xo + window);
  const uint32_t* xe32 = reinterpret_cast<const uint32_t*>(xe);
  const uint32_t* xo32 = reinterpret_cast<const uint32_t*>(xo);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t_out = T / 4;
  const int n_slices = c_pad / kSlice;

  const uint32_t* wsrc = reinterpret_cast<const uint32_t*>(wp);
  for (int i = threadIdx.x; i < c_pad * kWRow / 2; i += kTcThreads) ws[i] = wsrc[i];
  for (int i = threadIdx.x; i < 4 * c_pad; i += kTcThreads) {
    const int row = i / c_pad, c = i - row * c_pad;
    float v = 0.f;
    if (c < C) v = row < 3 ? aff[row * C + c] : (OUT == kInt8 ? inv_s0[c] : 0.f);
    affs[i] = v;
  }

  __syncthreads();

  // The B fragments and the epilogue rows [bias, mul, add, inv_s0] of the
  // warp's current slice, channels (nt, 2tq + e).
  int cur = -1;
  uint32_t bw[4][2][2];
  float ep[4][2][4];
  float pre[kPrefetch];
  if (blockIdx.x < n_items) fetch_window(pre, x, blockIdx.x, n_tiles, tile, T, window);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int p0 = (item - b * n_tiles) * tile;
    const int n_p = min(tile, t_out - p0);
    // The window, rounded to bf16 once, as the plain version rounds x; the
    // sync below also orders the last item's stores before this item's
    // writes to the output tile.
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int i = threadIdx.x + k * kTcThreads;
      if (i <= window) {
        const __nv_bfloat16 v = __float2bfloat16(pre[k]);
        if (i < window) xe[i] = v;
        if (i > 0) xo[i - 1] = v;
      }
    }
    __syncthreads();
    if (item + (int)gridDim.x < n_items)
      fetch_window(pre, x, item + gridDim.x, n_tiles, tile, T, window);

    // A warp's units: a contiguous run of (slice, group) pairs, slice-major,
    // the same run every item, so its slice changes at most a few times (at
    // C = 128 never) and the slice's B fragments and epilogue rows stay in
    // registers.
    const int n_groups = tile / kGroup;
    const int units = n_groups * n_slices;
    const int chunk = (units + kTcWarps - 1) / kTcWarps;
    const int u_end = min(units, (warp + 1) * chunk);
    for (int u = warp * chunk; u < u_end; ++u) {
      const int slice = u / n_groups, grp = u - slice * n_groups;
      if (grp * kGroup >= n_p) continue;  // warp-uniform
      if (slice != cur) {
        cur = slice;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = slice * kSlice + nt * 8 + g;  // B column: channel n
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int wd = (n * kWRow + 16 * s + 2 * tq) >> 1;
            bw[nt][s][0] = ws[wd];
            bw[nt][s][1] = ws[wd + 4];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = slice * kSlice + nt * 8 + 2 * tq + e;
            ep[nt][e][0] = affs[c];
            ep[nt][e][1] = affs[c_pad + c];
            ep[nt][e][2] = affs[2 * c_pad + c];
            ep[nt][e][3] = affs[3 * c_pad + c];
          }
        }
      }
      const int lp = grp * kGroup + g;  // this thread's pooled position
      // A: rows g and g + 8 of m-tile mt are phases 2mt and 2mt + 1 of
      // position lp (ops/block0_tc.phase_rows); element (row, k) is window
      // sample 4·lp + j + k. Phase 2mt starts even (xe), 2mt + 1 odd, read
      // from xo one sample earlier.
      uint32_t a[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int e = (4 * lp + 2 * mt + 16 * s + 2 * tq) >> 1;  // word of the even phase
          a[mt][s][0] = xe32[e];
          a[mt][s][1] = xo32[e];
          a[mt][s][2] = xe32[e + 4];
          a[mt][s][3] = xo32[e + 4];
        }
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma_bf16(acc[0][nt], a[0][s], bw[nt][s][0], bw[nt][s][1]);
          mma_bf16(acc[1][nt], a[1][s], bw[nt][s][0], bw[nt][s][1]);
        }
      // Epilogue in registers: accumulator (row g | g + 8, column 2tq + e)
      // of m-tile mt is phase 2mt | 2mt + 1 of channel 2tq + e. Pool first,
      // by the sign of mul: each rounded op of the affine is monotone in y
      // (nondecreasing, or nonincreasing where mul < 0), so the affine of
      // the max (or of the min) is bit for bit the max of the affines.
      unsigned char* srow = stage + lp * row_bytes;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = slice * kSlice + nt * 8 + 2 * tq;
        float best[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y0 = acc[0][nt][e], y1 = acc[0][nt][2 + e];
          const float y2 = acc[1][nt][e], y3 = acc[1][nt][2 + e];
          const float y = ep[nt][e][1] >= 0.f ? fmaxf(fmaxf(y0, y1), fmaxf(y2, y3))
                                              : fminf(fminf(y0, y1), fminf(y2, y3));
          best[e] = block0_affine(y, ep[nt][e][0], ep[nt][e][1], ep[nt][e][2]);
        }
        if (c >= C) continue;
        const bool pair = c + 1 < C;
        if (OUT == kInt8) {
          // Half to even, as torch.round; a multiply by the reciprocal.
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = __float2int_rn(__fmul_rn(best[e], ep[nt][e][3]));
            q[e] = (int8_t)min(max(r, -127), 127);
          }
          int8_t* d = reinterpret_cast<int8_t*>(srow) + c;
          if (pair) {
            char2 v2;
            v2.x = q[0];
            v2.y = q[1];
            *reinterpret_cast<char2*>(d) = v2;
          } else {
            d[0] = q[0];
          }
        } else if (OUT == kBF16) {
          __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(srow) + c;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(best[0], best[1]);
          } else {
            d[0] = __float2bfloat16(best[0]);
          }
        } else {
          float* d = reinterpret_cast<float*>(srow) + c;
          if (pair) {
            *reinterpret_cast<float2*>(d) = make_float2(best[0], best[1]);
          } else {
            d[0] = best[0];
          }
        }
      }
    }
    __syncthreads();

    // The tile's n_p rows are one contiguous run of the output (B, t_out, C):
    // 16-byte vectors where a row is whole vectors, else element by element.
    unsigned char* gout = static_cast<unsigned char*>(out) +
                          ((long long)b * t_out + p0) * C * kOutBytes;
    const int rb = C * kOutBytes;
    if (rb % 16 == 0) {
      const int ch = rb / 16;
      for (int i = threadIdx.x; i < n_p * ch; i += kTcThreads) {
        const int p = i / ch, v = i - p * ch;
        reinterpret_cast<uint4*>(gout)[i] =
            *reinterpret_cast<const uint4*>(stage + p * row_bytes + 16 * v);
      }
    } else {
      for (int i = threadIdx.x; i < n_p * C; i += kTcThreads) {
        const int p = i / C, c = i - p * C;
        const unsigned char* src = stage + p * row_bytes + c * kOutBytes;
#pragma unroll
        for (int k = 0; k < kOutBytes; ++k) gout[(long long)i * kOutBytes + k] = src[k];
      }
    }
  }
}

template <int OUT>
int launch_tc(const void* x, const void* wp, const void* aff, const void* inv_s0, void* out,
              int B, int T, int C, int tile, cudaStream_t stream) {
  constexpr int kOutBytes = OUT == kF32 ? 4 : (OUT == kBF16 ? 2 : 1);
  const int c_pad = (C + kSlice - 1) / kSlice * kSlice;
  const int window = 4 * tile + kTaps;
  const int row_bytes = (C * kOutBytes + 15) / 16 * 16 + 16;
  const size_t smem = (size_t)c_pad * kWRow * 2 + 4 * (size_t)c_pad * 4 + 2 * (size_t)window * 2 +
                      (size_t)tile * row_bytes;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_block0_tc_kernel<OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_block0_tc_kernel<OUT>,
                                                           kTcThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (T / 4 + tile - 1) / tile;
  const long long items = (long long)B * n_tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_ctas = (int)std::min<long long>(items, (long long)sms * per_sm);
  conv_block0_tc_kernel<OUT><<<n_ctas, kTcThreads, smem, stream>>>(
      (const float*)x, (const __nv_bfloat16*)wp, (const float*)aff, (const float*)inv_s0, out, T,
      C, c_pad, tile, n_tiles, (int)items, row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// inv_s0: NULL, or the (C,) f32 reciprocal requant scales, which make the
// output int8 (out_bf16 is then not read).
extern "C" int vm_conv_block0(const void* x, const void* w, const void* aff,
                              const void* inv_s0, void* out, int B, int T,
                              int C, int K, int pool, int round_x,
                              int out_bf16, void* stream) {
  if (K != 32 || pool != 4) return (int)cudaErrorInvalidValue;
  const int t_out = T / pool;
  if (B == 0 || t_out == 0) return 0;
  const dim3 grid((t_out + kTile - 1) / kTile, B);
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* af = (const float*)aff;
  const float* inv = (const float*)inv_s0;
  if (inv)
    conv_block0_kernel<32, 4, kInt8><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                              round_x);
  else if (out_bf16)
    conv_block0_kernel<32, 4, kBF16><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                              round_x);
  else
    conv_block0_kernel<32, 4, kF32><<<grid, threads, 0, s>>>(xf, wf, af, inv, out, T, C,
                                                             round_x);
  return (int)cudaGetLastError();
}

// The tensor-core route. x (B, T) f32; wp (C_pad, 40) bf16, the packed
// weights (ops/block0_tc.pack_weights); aff (3, C) f32 [bias | mul | add];
// inv_s0: NULL, or the (C,) f32 reciprocal requant scales (out_kind 2);
// out (B, T / 4, C) of out_kind 0 f32, 1 bf16, 2 int8; tile: the pooled
// positions of a work item (ops/block0_tc.pick_tile). A CTA that does not
// fit shared memory (ops/block0_tc.smem_bytes) returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int vm_conv_block0_tc(const void* x, const void* wp, const void* aff,
                                 const void* inv_s0, void* out, int B, int T, int C,
                                 int out_kind, int tile, void* stream) {
  if (tile < kGroup || tile % kGroup || tile > kMaxTile || C < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T / 4 == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kInt8) {
    if (!inv_s0) return (int)cudaErrorInvalidValue;
    return launch_tc<kInt8>(x, wp, aff, inv_s0, out, B, T, C, tile, s);
  }
  if (out_kind == kBF16) return launch_tc<kBF16>(x, wp, aff, inv_s0, out, B, T, C, tile, s);
  if (out_kind == kF32) return launch_tc<kF32>(x, wp, aff, inv_s0, out, B, T, C, tile, s);
  return (int)cudaErrorInvalidValue;
}
