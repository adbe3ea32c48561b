// B3: the int8 mid block of the encoder's serving path (blocks 1+): SAME conv
// (k=3) in s8 x s8 -> s32, max-pool 2, and the folded epilogue, in one pass.
//
// Replaces voicemap_tpu/ops/pallas_quant_block.py :: _kernel, _kernel_xk3 and
// _kernel_xk (wrapper pallas_quant_block); the three TPU variants are three
// ways of laying the same GEMM out on the MXU, and one Hopper kernel covers
// them. For row b, time t and output channel co:
//   acc[t] = sum_{j, ci} x[t + j - 1, ci] * w[j, ci, co]   (x = 0 outside [0, T))
//   sel[u] = alpha[co] > 0 ? max(acc[2u], acc[2u + 1]) : min(acc[2u], acc[2u + 1])
//   z[u]   = relu(float(sel[u]) + beta[co]) * alpha[co] + gamma[co]
//   out[u] = clamp(round_half_even(z[u]), -127, 127) as int8, or z[u] rounded
//            to bf16 (or kept in f32) for the last block.
// Pooling the raw accumulator before the epilogue, by the sign of alpha, is
// what the TPU kernel does, and equals models/quant_infer.py :: _quant_block
// (epilogue, requantize, then pool) bit for bit: the epilogue and its
// roundings are monotone in acc, nondecreasing for alpha > 0 and
// nonincreasing for alpha < 0. The int32 sums are exact in any order; the
// epilogue is rounded op by op (__fadd_rn, __fmul_rn), so nvcc cannot
// contract it into an FMA, and the output equals the plain version exactly.
// An odd T drops the last step from the pool; the conv still reads it.
//
// The conv is a GEMM with M = time, N = Cout and K = 3 * Cin: in
// channels-last int8 the A row of time t, [x[t-1] | x[t] | x[t+1]], is three
// consecutive input rows. A CTA keeps kTileT + 2 input rows of one batch row
// in shared memory and every tap reads them there.
//
// What bounds it on the H100: operations. At config #1 and B=2048, block 1
// (128 -> 256, T 3000) is 1.21 TOP against 1.57 GB, block 2 (256 -> 384,
// T 1500) 1.81 TOP against 1.38 GB, block 3 (384 -> 512, T 750, bf16 out)
// 1.81 TOP against 1.38 GB: 0.61, 0.92 and 0.92 ms at the 1,979 TOP/s int8
// tensor-core peak, above the bytes' 0.47, 0.41 and 0.41 ms at 3.35 TB/s.
// Design: the products run on the tensor cores with
// mma.sync.m16n8k32.s8.s8.s32, fragments loaded from shared memory. A CTA of
// 8 warps owns kTileN output channels, keeps their packed weights
// (Cout, 3 * Cin) in shared memory for its whole life, and walks over a run
// of (row, time tile) tiles; the next tile's input rows stream in with
// cp.async while the current one is multiplied (two buffers). Each warp
// computes 32 time rows x 32 channels. The mma row of each fragment is
// mapped so that fragment rows g and g + 8 are times 2u and 2u + 1: both
// pooling partners land in the same thread's registers and the pair max/min
// needs no exchange. Shared-memory rows are padded (Cin + 8 and 3 * Cin + 16
// bytes) so the fragment loads of a warp hit 32 distinct banks. The full-rate
// int32 accumulator never leaves the registers; only the pool-rate output is
// written. wgmma, TMA and ldmatrix are later work.
//
// B10, the stage prefixes that attribute this kernel's time, are the same
// kernel cut short by its STAGE template parameter. They replace
// benchmarks/bench_qblock_attrib.py :: _kernel_staged and _kernel_xk, whose
// stages 1-2 (a (t+2, Cin) @ (Cin, 3 * Cout) product, then the shifted tap
// adds) have no separate form here: the taps are already inside K = 3 * Cin,
// the layout of _kernel_xk. Unlike the TPU prefixes, each writes a defined
// output, so it can be held against a plain version:
//   kStageMma:  the tile loads and the mma over K; writes acc[2u] as int32;
//   kStagePool: + the pair select by the sign of alpha; writes sel[u] int32;
//   kStageFull: + the epilogue and requantization: B3 itself, which every
//               B3 launch runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileT = 128;  // conv output rows (time) per tile; even
constexpr int kTileN = 64;   // output channels per CTA
constexpr int kWarpsM = 4;   // warps along time, 32 rows each
constexpr int kWarpsN = 2;   // warps along channels, 32 each
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kXPad = 8;   // bytes after each input row in shared memory
constexpr int kWPad = 16;  // bytes after each weight row in shared memory
constexpr int kCtasPerSm = 16;  // grid size target, in CTAs per SM

enum OutKind { kInt8 = 0, kBF16 = 1, kF32 = 2 };
enum Stage { kStageMma = 0, kStagePool = 1, kStageFull = 2 };

__host__ __device__ constexpr int x_stride(int cin) { return cin + kXPad; }
__host__ __device__ constexpr int w_stride(int cin) { return 3 * cin + kWPad; }

size_t smem_bytes(int cin) {
  return (size_t)kTileN * w_stride(cin) + 2 * (size_t)(kTileT + 2) * x_stride(cin);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int OUT>
__device__ __forceinline__ void store(void* out, long long o, float z) {
  if (OUT == kInt8) {
    const int q = __float2int_rn(z);  // half to even, as jnp.round
    static_cast<int8_t*>(out)[o] = (int8_t)min(max(q, -127), 127);
  } else if (OUT == kBF16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(z);
  } else {
    static_cast<float*>(out)[o] = z;
  }
}

// x: (B, T, Cin) int8; w: (Cout, 3 * Cin) int8, K index j * Cin + ci;
// aff: (3, Cout) f32 rows alpha, beta, gamma; out: (B, T / 2, Cout), int32
// for the mma and pool stages.
template <int OUT, int STAGE>
__global__ void __launch_bounds__(kThreads)
quant_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ aff, void* __restrict__ out, int T,
                   int Cin, int Cout, int tiles_per_row, long long n_tiles,
                   long long tiles_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = x_stride(Cin), wsd = w_stride(Cin), k3 = 3 * Cin;
  int8_t* ws = reinterpret_cast<int8_t*>(smem);
  int8_t* xbuf = ws + kTileN * wsd;
  const int xbuf_size = (kTileT + 2) * xs;

  const int n0 = blockIdx.x * kTileN;
  const long long first = (long long)blockIdx.y * tiles_per_cta;
  const long long last = min(first + tiles_per_cta, n_tiles);
  const int t_out = T / 2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m_base = (warp / kWarpsN) * 32;  // first conv row of the warp
  const int n_base = (warp % kWarpsN) * 32;  // first channel of the warp

  // This CTA's weights, once; rows past Cout are zero.
  for (int i = threadIdx.x; i < kTileN * (k3 / 16); i += kThreads) {
    const int r = i / (k3 / 16), c = i % (k3 / 16);
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + r < Cout)
      v = *reinterpret_cast<const int4*>(w + (long long)(n0 + r) * k3 + c * 16);
    *reinterpret_cast<int4*>(ws + r * wsd + c * 16) = v;
  }
  // The epilogue vectors of this thread's 8 channels.
  float alpha[4][2], beta[4][2], gamma[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + n_base + nt * 8 + 2 * tig + e;
      const bool ok = c < Cout;
      alpha[nt][e] = ok ? aff[c] : 0.f;
      beta[nt][e] = ok ? aff[Cout + c] : 0.f;
      gamma[nt][e] = ok ? aff[2 * Cout + c] : 0.f;
    }

  // Rows t0 - 1 ... t0 + kTileT of batch row b into a buffer; zeros outside [0, T).
  auto load_tile = [&](long long tile, int8_t* dst) {
    const long long b = tile / tiles_per_row;
    const int t0 = (int)(tile % tiles_per_row) * kTileT;
    const int8_t* xrow = x + b * T * (long long)Cin;
    const int chunks = Cin / 8;
    for (int i = threadIdx.x; i < (kTileT + 2) * chunks; i += kThreads) {
      const int r = i / chunks, c = i % chunks;
      const int t = t0 - 1 + r;
      const bool valid = t >= 0 && t < T;
      cp_async8(dst + r * xs + c * 8, valid ? xrow + (long long)t * Cin + c * 8 : x, valid);
    }
  };

  if (first < last) load_tile(first, xbuf);
  cp_async_commit();
  int buf = 0;
  for (long long tile = first; tile < last; ++tile, buf ^= 1) {
    if (tile + 1 < last) load_tile(tile + 1, xbuf + (buf ^ 1) * xbuf_size);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int8_t* xt = xbuf + buf * xbuf_size;

    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

    for (int j = 0; j < 3; ++j) {
      for (int kc = 0; kc < Cin; kc += 32) {
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // Fragment row g is conv row 2g of the m16 tile, row g + 8 is 2g + 1;
          // conv row i reads shared rows i + j, j = 0, 1, 2.
          const int8_t* p0 = xt + (m_base + mt * 16 + 2 * g + j) * xs + kc + 4 * tig;
          const int8_t* p1 = p0 + xs;
          a[mt][0] = lds32(p0);
          a[mt][1] = lds32(p1);
          a[mt][2] = lds32(p0 + 16);
          a[mt][3] = lds32(p1 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* q = ws + (n_base + nt * 8 + g) * wsd + j * Cin + kc + 4 * tig;
          bf[nt][0] = lds32(q);
          bf[nt][1] = lds32(q + 16);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], bf[nt]);
      }
    }

    // Epilogue at pool rate: acc[..][e] is time 2u, acc[..][2 + e] time 2u + 1.
    const long long b = tile / tiles_per_row;
    const int t0 = (int)(tile % tiles_per_row) * kTileT;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int u = (t0 + m_base + mt * 16) / 2 + g;
      if (u >= t_out) continue;
      const long long orow = (b * t_out + u) * (long long)Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + n_base + nt * 8 + 2 * tig + e;
          if (c >= Cout) continue;
          const int a0 = acc[mt][nt][e], a1 = acc[mt][nt][2 + e];
          if (STAGE == kStageMma) {
            static_cast<int*>(out)[orow + c] = a0;
            continue;
          }
          const float al = alpha[nt][e];
          const int sel = al > 0.f ? max(a0, a1) : min(a0, a1);
          if (STAGE == kStagePool) {
            static_cast<int*>(out)[orow + c] = sel;
            continue;
          }
          const float h = fmaxf(__fadd_rn(__int2float_rn(sel), beta[nt][e]), 0.f);
          store<OUT>(out, orow + c, __fadd_rn(__fmul_rn(h, al), gamma[nt][e]));
        }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

template <int OUT, int STAGE>
cudaError_t launch(const void* x, const void* w, const void* aff, void* out, int B,
                   int T, int Cin, int Cout, cudaStream_t s) {
  const int t_even = (T / 2) * 2;
  const int tiles_per_row = (t_even + kTileT - 1) / kTileT;
  const long long n_tiles = (long long)B * tiles_per_row;
  const int n_ch = (Cout + kTileN - 1) / kTileN;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // About kCtasPerSm CTAs per SM in all, each over a run of tiles, so that the
  // weights are loaded once per run and the last wave is short.
  const long long want = (long long)sms * kCtasPerSm / n_ch;
  const long long per_ch = want > 0 ? want : 1;
  const long long tiles_per_cta = (n_tiles + per_ch - 1) / per_ch;
  const dim3 grid(n_ch, (unsigned)((n_tiles + tiles_per_cta - 1) / tiles_per_cta));
  const size_t smem = smem_bytes(Cin);
  err = cudaFuncSetAttribute(quant_block_kernel<OUT, STAGE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  quant_block_kernel<OUT, STAGE><<<grid, kThreads, smem, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)aff, out, T, Cin, Cout,
      tiles_per_row, n_tiles, tiles_per_cta);
  return cudaGetLastError();
}

}  // namespace

// out_kind: 0 int8 (requantized), 1 bf16, 2 f32 (dequantized, last block).
// Cin must be a multiple of 32 (one mma k-step stays within one tap) and at
// most 480 (the CTA's shared memory: weights and two input buffers); x and w
// 16-byte aligned.
extern "C" int vm_quant_block(const void* x, const void* w, const void* aff,
                              void* out, int B, int T, int Cin, int Cout,
                              int out_kind, void* stream) {
  if (Cin % 32 != 0 || smem_bytes(Cin) > 232448 || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < 2 || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == kInt8)
    return (int)launch<kInt8, kStageFull>(x, w, aff, out, B, T, Cin, Cout, s);
  if (out_kind == kBF16)
    return (int)launch<kBF16, kStageFull>(x, w, aff, out, B, T, Cin, Cout, s);
  return (int)launch<kF32, kStageFull>(x, w, aff, out, B, T, Cin, Cout, s);
}

// B10. stage: 0 mma (out int32, acc[2u]), 1 pool (out int32, sel[u]), 2 full
// (out int8, the mid block's requantized output). The same limits as above.
extern "C" int vm_quant_block_stage(const void* x, const void* w, const void* aff,
                                    void* out, int B, int T, int Cin, int Cout,
                                    int stage, void* stream) {
  if (Cin % 32 != 0 || smem_bytes(Cin) > 232448 || stage < 0 || stage > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T < 2 || Cout == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == kStageMma)
    return (int)launch<kInt8, kStageMma>(x, w, aff, out, B, T, Cin, Cout, s);
  if (stage == kStagePool)
    return (int)launch<kInt8, kStagePool>(x, w, aff, out, B, T, Cin, Cout, s);
  return (int)launch<kInt8, kStageFull>(x, w, aff, out, B, T, Cin, Cout, s);
}
