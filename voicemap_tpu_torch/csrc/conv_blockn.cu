// B8: a bf16 encoder block 1+ fused: SAME conv (k odd) + bias -> relu ->
// BatchNorm inference affine -> max-pool 2, writing only the pool-rate output.
//
// Replaces voicemap_tpu/ops/pallas_conv.py :: _kernel_chan (wrapper
// pallas_conv_blockn) and _kernel_chan_streamed (wrapper
// pallas_conv_blockn_streamed). The two TPU kernels compute the same
// function; the streamed one only changes when the input is copied in. Their
// pair-merged input and phase-stacked (k+1)*Cin x 2*Cout weights kept Mosaic's
// slices lane-aligned at the cost of 4/3 of the conv's multiply-adds; this
// kernel does the direct conv. For row b, time t and output channel c
// (x = 0 outside [0, T), h = (k - 1) / 2):
//   y[t]   = sum_{j, ci} x[t + j - h, ci] * w[j, ci, c]        in f32
//   z[t]   = relu(y[t] + bias[c]) * mul[c] + add[c]             in f32
//   out[u] = max(z[2u], z[2u + 1]), rounded once to bf16 (or kept in f32)
// mul = gamma * rsqrt(var + eps) and add = beta - mean * mul come from the
// wrapper in f32; the affine comes before the max because mul can be
// negative. x and w are bf16, so every product is exact in f32; the tensor
// cores' order of the f32 sums is theirs, so the result agrees with the
// plain version (ops/cuda_conv.py :: conv_blockn_reference) to a bound, not
// bit for bit. The epilogue is rounded op by op (__fadd_rn, __fmul_rn), so
// nvcc cannot contract it into an FMA. An odd T drops its last step from the
// pool; the conv still reads it.
//
// What bounds it on the H100: operations. At config #1 and B=2048, blocks
// 1-3 (128 -> 256 at T 3000, 256 -> 384 at 1500, 384 -> 512 at 750) are
// 1.21, 1.81 and 1.81 TFLOP of direct conv: 1.22, 1.83 and 1.83 ms at the
// 989 TFLOP/s bf16 tensor-core peak, above their bytes (3.15, 2.75, 1.97 GB
// with the bf16 output: 0.94, 0.82, 0.59 ms at 3.35 TB/s).
//
// Design: an implicit GEMM with M = time, N = Cout and K = k * Cin. In
// channels-last memory the A row of time t is the k consecutive input rows
// around t, so a CTA of 8 warps stages the kTileT + k - 1 input rows of one
// (batch row, time tile) in shared memory once, and every tap reads them
// there. The products run on the tensor cores with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, fragments loaded from shared
// memory; each warp computes 32 time rows x 32 channels. The mma row of each
// fragment is mapped so that fragment rows g and g + 8 are times 2u and
// 2u + 1: both pooling partners land in the same thread's registers and the
// max needs no exchange. The CTA walks over Cout in passes of kTileN
// channels; the weights stream through two shared-memory slabs of
// kTileN x kSlab (one tap, a run of up to 128 input channels) with cp.async,
// the next slab loading while the current one is multiplied, one barrier a
// slab. The weights of a whole pass do not fit beside the input: at block 3
// a 64-channel slab of K = 3 * 384 is 147 KB, and the input tile is 101 KB.
// On an H100 80GB HBM3 at 700 W, slabs of 128 were faster at all three
// blocks than slabs of 64 (with one or two barriers a slab, and with three
// buffers); slabs of 256 won at block 3 and lost at blocks 1 and 2: a slab
// is the run of mma between two barriers. The shared memory a CTA takes is
// (kTileT + k - 1) * (Cin + 4) * 2 + 2 * 64 * 136 * 2 bytes: 69,136 at
// block 1, 102,416 at block 2 and 135,696 at block 3. Rows are
// padded (4 and 8 bf16) so that a warp's fragment loads hit 32 distinct
// banks. Masking, not padding in memory, handles the edges: input rows
// outside [0, T) are zero-filled by cp.async, channels past Cout are zero
// weights and are not stored, pooled rows past T / 2 are not stored, and a
// Cin that is a multiple of 8 but not 16 zeroes the second half of its last
// k-step. The full-rate activation never leaves the registers. wgmma, TMA,
// ldmatrix and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileT = 128;  // conv output rows (time) per tile; even
constexpr int kTileN = 64;   // output channels per pass
constexpr int kSlab = 128;   // K elements of a weight slab: one tap, a run of Cin
constexpr int kWarpsM = 4;   // warps along time, 32 rows each
constexpr int kWarpsN = 2;   // warps along channels, 32 each
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kXPad = 4;                  // bf16 after each input row in shared memory
constexpr int kWStride = kSlab + 8;       // bf16 per weight-slab row in shared memory
constexpr int kSlabElems = kTileN * kWStride;

enum OutKind { kBF16 = 1, kF32 = 2 };

__host__ __device__ constexpr int x_stride(int cin) { return cin + kXPad; }

size_t smem_bytes(int cin, int k) {
  return 2 * (size_t)kSlabElems * 2 + (size_t)(kTileT + k - 1) * x_stride(cin) * 2;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 or 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int OUT>
__device__ __forceinline__ void store(void* out, long long o, float z) {
  if (OUT == kBF16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(z);
  } else {
    static_cast<float*>(out)[o] = z;
  }
}

// x: (B, T, Cin) bf16; w: (Cout, k * Cin) bf16, K index j * Cin + ci;
// aff: (3, Cout) f32 rows bias, mul, add; out: (B, T / 2, Cout). One CTA per
// (batch row, tile of kTileT conv rows).
template <int OUT>
__global__ void __launch_bounds__(kThreads)
conv_blockn_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ aff, void* __restrict__ out, int T, int Cin,
                   int Cout, int k, int tiles_per_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // two weight slabs
  __nv_bfloat16* xt = wbuf + 2 * kSlabElems;                     // the input tile
  const int xs = x_stride(Cin);
  const int rows = kTileT + k - 1;
  const int K = k * Cin;

  const long long b = blockIdx.x / tiles_per_row;
  const int t0 = (int)(blockIdx.x % tiles_per_row) * kTileT;
  const int t_out = T / 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m_base = (warp / kWarpsN) * 32;  // first conv row of the warp
  const int n_base = (warp % kWarpsN) * 32;  // first channel of the warp in the pass

  // The slabs in order: passes over Cout, within a pass taps j, within a tap
  // runs of kSlab input channels.
  const int chunks = (Cin + kSlab - 1) / kSlab;
  const int slabs = k * chunks;
  const int steps = ((Cout + kTileN - 1) / kTileN) * slabs;

  // Input rows t0 - h ... t0 + kTileT - 1 + h of batch row b; zeros outside [0, T).
  {
    const __nv_bfloat16* xrow = x + b * T * (long long)Cin;
    const int h = (k - 1) / 2, c4 = Cin / 4;
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int r = i / c4, c = i % c4;
      const int t = t0 - h + r;
      const bool valid = t >= 0 && t < T;
      cp_async8(xt + r * xs + c * 4, valid ? xrow + (long long)t * Cin + c * 4 : x, valid);
    }
  }
  // kTileN weight rows of one slab; rows past Cout and channels past Cin are zero.
  auto load_slab = [&](int s, __nv_bfloat16* dst) {
    const int n0 = (s / slabs) * kTileN, r = s % slabs;
    const int j = r / chunks, c0 = (r % chunks) * kSlab;
    for (int i = threadIdx.x; i < kTileN * (kSlab / 8); i += kThreads) {
      const int row = i / (kSlab / 8), q = i % (kSlab / 8);
      const int n = n0 + row, ci = c0 + q * 8;
      const bool valid = n < Cout && ci < Cin;
      cp_async16(dst + row * kWStride + q * 8,
                 valid ? w + (long long)n * K + j * Cin + ci : w, valid);
    }
  };

  load_slab(0, wbuf);
  cp_async_commit();  // the input tile and the first slab

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int s = 0; s < steps; ++s) {
    // Slab s has landed and, past the barrier, every warp is done with slab
    // s - 1, whose buffer the load of slab s + 1 then refills while slab s
    // is multiplied.
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) load_slab(s + 1, wbuf + ((s + 1) & 1) * kSlabElems);
    cp_async_commit();
    const __nv_bfloat16* ws = wbuf + (s & 1) * kSlabElems;
    const int r = s % slabs;
    const int j = r / chunks, c0 = (r % chunks) * kSlab;
    const int kc_end = min(kSlab, Cin - c0);
#pragma unroll
    for (int ks = 0; ks < kSlab / 16; ++ks) {
      const int kc = ks * 16;
      if (kc >= kc_end) break;
      const bool hi = kc + 8 < kc_end;  // the k-step's second half lies within Cin
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // Fragment row g is conv row 2g of the m16 tile, row g + 8 is 2g + 1;
        // conv row i reads shared row i + j at tap j.
        const __nv_bfloat16* p0 = xt + (m_base + mt * 16 + 2 * g + j) * xs + c0 + kc + 2 * tig;
        const __nv_bfloat16* p1 = p0 + xs;
        a[mt][0] = lds32(p0);
        a[mt][1] = lds32(p1);
        a[mt][2] = hi ? lds32(p0 + 8) : 0u;
        a[mt][3] = hi ? lds32(p1 + 8) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* q = ws + (n_base + nt * 8 + g) * kWStride + kc + 2 * tig;
        bf[nt][0] = lds32(q);
        bf[nt][1] = hi ? lds32(q + 8) : 0u;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
    }

    if (r == slabs - 1) {
      // The pass is summed. Epilogue at pool rate: acc[..][e] is time 2u,
      // acc[..][2 + e] time 2u + 1, channel 2 * tig + e of the n8 tile.
      const int n0 = (s / slabs) * kTileN + n_base;
      float bias[4][2], mul[4][2], add[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + nt * 8 + 2 * tig + e;
          const bool ok = c < Cout;
          bias[nt][e] = ok ? aff[c] : 0.f;
          mul[nt][e] = ok ? aff[Cout + c] : 0.f;
          add[nt][e] = ok ? aff[2 * Cout + c] : 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int u = (t0 + m_base + mt * 16) / 2 + g;
        const long long orow = (b * t_out + u) * (long long)Cout;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + nt * 8 + 2 * tig + e;
            if (u < t_out && c < Cout) {
              const float h0 = fmaxf(__fadd_rn(acc[mt][nt][e], bias[nt][e]), 0.f);
              const float h1 = fmaxf(__fadd_rn(acc[mt][nt][2 + e], bias[nt][e]), 0.f);
              const float z0 = __fadd_rn(__fmul_rn(h0, mul[nt][e]), add[nt][e]);
              const float z1 = __fadd_rn(__fmul_rn(h1, mul[nt][e]), add[nt][e]);
              store<OUT>(out, orow + c, fmaxf(z0, z1));
            }
            acc[mt][nt][e] = 0.f;
            acc[mt][nt][2 + e] = 0.f;
          }
      }
    }
  }
}

template <int OUT>
cudaError_t launch(const void* x, const void* w, const void* aff, void* out, int B, int T,
                   int Cin, int Cout, int k, cudaStream_t s) {
  const int t_even = (T / 2) * 2;
  const int tiles_per_row = (t_even + kTileT - 1) / kTileT;
  const long long n_tiles = (long long)B * tiles_per_row;
  if (n_tiles > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Cin, k);
  cudaError_t err = cudaFuncSetAttribute(conv_blockn_kernel<OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_blockn_kernel<OUT><<<(unsigned)n_tiles, kThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)aff, out, T, Cin, Cout,
      k, tiles_per_row);
  return cudaGetLastError();
}

}  // namespace

// out_kind: 1 bf16, 2 f32. k odd, Cin a multiple of 8 (an 8-element half of
// an mma k-step stays within one tap) and narrow enough that the input tile
// and two weight slabs fit the CTA's shared memory (Cin <= 752 at k = 3); x
// 16-byte aligned. Returns cudaErrorInvalidValue, launching nothing, for
// anything else.
extern "C" int vm_conv_blockn(const void* x, const void* w, const void* aff, void* out, int B,
                              int T, int Cin, int Cout, int k, int out_kind, void* stream) {
  if (Cin <= 0 || Cin % 8 != 0 || k < 1 || k % 2 == 0 || smem_bytes(Cin, k) > 232448 ||
      (out_kind != kBF16 && out_kind != kF32))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < 2 || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kBF16) return (int)launch<kBF16>(x, w, aff, out, B, T, Cin, Cout, k, s);
  return (int)launch<kF32>(x, w, aff, out, B, T, Cin, Cout, k, s);
}
