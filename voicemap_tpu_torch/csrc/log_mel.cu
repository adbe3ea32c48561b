// B6: fused framing + window + spectrum + power + mel + log, one pass over
// the waveform, by two kernels chosen by n_fft.
//
// Replaces voicemap_tpu/ops/pallas_melspec.py :: _fused_kernel and
// _preframed_kernel (core _dft_mel; wrapper pallas_log_mel). It computes the
// wrapper's function, not its blocks:
//   out[b, f, m] = log(sum_k |X_f[k]|^2 · fb[k, m] + eps)
// where X_f is the spectrum of frame f = x[b, f·hop .. f·hop + win) under the
// periodic Hann window, zero-padded to n_fft, k = 0 .. n_fft/2, and fb the
// Slaney mel filterbank (K = n_fft/2 + 1, M). f32 in, f32 out.
//
// What bounds the function on the H100: bytes. At config #4 (B=2048,
// T=48000, hop 128, win 384, n_fft 512, M 64; 373 frames) it reads 393 MB
// and writes 196 MB, 0.18 ms at the H100 SXM's published 3.35 TB/s; by a
// real FFT it needs 10.5 GFLOP (window, 512-point real FFT, power, mel
// bands, log), 0.16 ms at the f32 CUDA-core rate of 67 TFLOP/s (700 W).
//
// The TPU kernel computes the DFT as a matmul against cos/sin bases, 302
// GFLOP at config #4: right for a machine with a matrix unit and no FFT,
// 29x the work here. TF32 on the tensor cores keeps about three digits, as
// much error on the power as the 1e-3 the log-mel is held to, so the
// tensor cores are no way out; this card's CUDA cores run an FFT.
//
// log_mel_fft_kernel, for n_fft a power of two in [64, 1024] (config #4):
// - one CTA owns one row and a tile of 64 frames; it reads the waveform
//   span of its frames into shared memory once (33 KB at hop 128, win 384:
//   each sample belongs to win/hop = 3 frames), with the tables;
// - each of its 8 warps takes 8 frames in turn; a frame's real FFT of N
//   points is a complex FFT of nc = N/2 points, z[n] = x[2n] + i·x[2n+1]
//   (windowed on the load, zero past win), by Stockham passes of radix 8,
//   8, 4 at nc = 256 (mel_fft.plan): each lane holds the R points of its
//   butterflies in registers, twiddles them from its pass's table (a
//   lane's R - 1 twiddles adjacent, so the lanes' reads miss each other's
//   banks), transforms them, and writes them to the warp's buffer, one
//   pad slot after every 8 complex values so that the strided reads and
//   writes of the exchanges fall on distinct banks;
// - the split pass X[k] = ½(Z[k] + Z*[nc−k]) − ½·i·W_N^k·(Z[k] − Z*[nc−k])
//   gives bins 0 .. nc (both ends real), then the power re² + im² lands over
//   the spent buffer, each filter's band of nonzero bins is summed in bin
//   order against its packed weights, and the log is stored, each frame's
//   M floats contiguous. Neither frames nor spectra reach device memory.
// The FFT's rounding error grows as O(log N) ulps of the frame's energy,
// the DFT's as O(win): far inside the 1e-3 on the log-mel. The twiddles come
// from float64 rounded once (the wrapper's tables). Sum orders: the
// butterflies' as written, the bands in bin order; no bit-exactness with the
// plain version (a DFT matmul) is claimed.
//
// log_mel_kernel, the DFT route, for any other n_fft <= 574 (the librosa
// n_fft 400, for one): the DFT as a matmul in f32 FMAs on the CUDA cores.
// One CTA owns one row and a tile of 64 frames:
// - it stages the waveform span of its frames in shared memory, read once
//   from device memory, so the frames are never materialised and any hop,
//   any win <= n_fft and any T >= win are taken;
// - the interleaved bases [C row | S row] (K padded with zero columns to
//   288) stream through shared memory in slabs of 16 window rows, double
//   buffered with cp.async; L2 holds the bases for every CTA;
// - each of the 8 warps owns 8 frames, each lane 9 frequency columns
//   (lane + 32j), so a thread keeps 8 x 9 re and 8 x 9 im sums in registers
//   and every x value is a shared-memory broadcast;
// - the (64 x 288) power tile then lands in shared memory over the spent
//   slabs, and the mel product walks each filter's nonzero band of bins
//   only, followed by log. Sum orders: window rows in order, each band in
//   order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kFrameTile = kWarps * kFramesPerWarp;  // 64 frames a CTA
constexpr int kCols = 9;                              // columns a lane
constexpr int kKPad = 32 * kCols;                     // 288 >= K
constexpr int kSlabRows = 16;                         // window rows a slab
constexpr int kSlabFloats = kSlabRows * 2 * kKPad;
constexpr int kTileFloats = 2 * kSlabFloats;          // two slabs, or the power tile
static_assert(kFrameTile * kKPad <= kTileFloats, "the power tile must fit over the slabs");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [n0, n0 + rows) of the interleaved bases into a slab buffer.
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ cs, int n0,
                                          int rows) {
  const float* src = cs + (long long)n0 * 2 * kKPad;
  const int n4 = rows * 2 * kKPad / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
log_mel_kernel(const float* __restrict__ x, const float* __restrict__ cs,
               const float* __restrict__ fbt, const int32_t* __restrict__ bands,
               float* __restrict__ out, int T, int n_frames, int n_tiles, int win, int hop,
               int M, int K, float log_eps) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                 // two basis slabs, later the power tile
  float* xs = smem + kTileFloats;     // the waveform span of the frame tile

  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * kFrameTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_slabs = (win + kSlabRows - 1) / kSlabRows;

  load_slab(tile, cs, 0, min(kSlabRows, win));

  // The span read once; samples past the row (frames past n_frames) are 0.
  const float* row = x + (long long)b * T;
  const long long start = (long long)f0 * hop;
  const int span = (kFrameTile - 1) * hop + win;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long p = start + i;
    xs[i] = p < T ? row[p] : 0.f;
  }

  float re[kFramesPerWarp][kCols], im[kFramesPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) re[i][j] = im[i][j] = 0.f;

  const float* xw = xs + warp * kFramesPerWarp * hop;
  for (int s = 0; s < n_slabs; ++s) {
    const int n0 = s * kSlabRows;
    if (s + 1 < n_slabs) {
      load_slab(tile + ((s + 1) & 1) * kSlabFloats, cs, n0 + kSlabRows,
                min(kSlabRows, win - n0 - kSlabRows));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* slab = tile + (s & 1) * kSlabFloats + lane;
    const int rows = min(kSlabRows, win - n0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float xv[kFramesPerWarp], cv[kCols], sv[kCols];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) xv[i] = xw[i * hop + n0 + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        cv[j] = slab[r * 2 * kKPad + 32 * j];
        sv[j] = slab[r * 2 * kKPad + kKPad + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
          im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
        }
    }
    __syncthreads();  // the next iteration refills the buffer read here
  }

  // Power over the spent slabs: re^2 + im^2, rounded op by op as the plain
  // version computes it.
  float* power = tile;
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      power[(warp * kFramesPerWarp + i) * kKPad + lane + 32 * j] =
          __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
  __syncthreads();

  // Mel over each filter's band of nonzero bins, then log; the tile's rows
  // are contiguous in the output, so consecutive threads store consecutively.
  const int valid = min(kFrameTile, n_frames - f0);
  float* dst = out + ((long long)b * n_frames + f0) * M;
  for (int idx = threadIdx.x; idx < valid * M; idx += kThreads) {
    const int f = idx / M, m = idx - f * M;
    const int lo = bands[m], hi = bands[M + m];
    const float* p = power + f * kKPad;
    const float* w = fbt + (long long)m * K;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(p[k], __ldg(w + k), acc);
    dst[idx] = logf(acc + log_eps);
  }
}

// ---------------------------------------------------------------------------
// The FFT route
// ---------------------------------------------------------------------------

constexpr int kFftFramesPerWarp = 8;
constexpr int kFftTile = kWarps * kFftFramesPerWarp;  // frames a CTA (mel_fft.FRAME_TILE)

__device__ __forceinline__ int padded(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// R-point DFTs in registers, v[k] <- sum_r v[r] W_R^{rk}, op for op as
// mel_fft._butterfly: radix 8 as two radix-4s (even, odd points) and a W_8
// stage.
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
  const float2 a2 = cadd(v1, v3), a3 = mul_neg_i(csub(v1, v3));
  v0 = cadd(a0, a2);
  v1 = cadd(a1, a3);
  v2 = csub(a0, a2);
  v3 = csub(a1, a3);
}
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    const float r = 0.70710678118654752f;
    o1 = make_float2((o1.x + o1.y) * r, (o1.y - o1.x) * r);   // W_8
    o2 = mul_neg_i(o2);                                        // W_8^2 = -i
    o3 = make_float2((o3.y - o3.x) * r, -(o3.x + o3.y) * r);  // W_8^3
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// One Stockham pass of radix R over an NC-point complex FFT, NS points
// already combined: butterfly j reads points j + r·NC/R, twiddles point r
// by W_{NS·R}^{(j % NS)·r}, the pass's own table at (j % NS)·(R − 1) + r − 1
// (a lane's R − 1 twiddles adjacent, so the lanes' reads spread over the
// banks), transforms, and writes (j / NS)·NS·R + j % NS + r·NS. The first
// pass reads the frame from the waveform span, windowed and zero past win,
// not the buffer.
template <int NC, int R, int NS, bool FIRST>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw, const float2* wpair,
                                         const float* xf, int win, bool even_hop, int lane) {
  constexpr int kBf = NC / R;
  constexpr int kPer = (kBf + 31) / 32;
  float2 v[kPer][R];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = lane + 32 * q;
    if (kBf % 32 != 0 && j >= kBf) break;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * kBf;
      if constexpr (FIRST) {
        const int s = 2 * n;
        float2 z = make_float2(0.f, 0.f);
        if (s + 1 < win) {
          const float2 xv = even_hop ? *reinterpret_cast<const float2*>(xf + s)
                                     : make_float2(xf[s], xf[s + 1]);
          const float2 w = wpair[n];
          z = make_float2(xv.x * w.x, xv.y * w.y);
        } else if (s < win) {
          z.x = xf[s] * wpair[n].x;
        }
        v[q][r] = z;
      } else {
        v[q][r] = buf[padded(n)];
      }
    }
    if constexpr (NS > 1) {
      const int t = j % NS;
#pragma unroll
      for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], tw[t * (R - 1) + r - 1]);
    }
    dft<R>(v[q]);
  }
  __syncwarp();  // every lane has read before any lane writes
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = lane + 32 * q;
    if (kBf % 32 != 0 && j >= kBf) break;
    const int dst = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[padded(dst + r * NS)] = v[q][r];
  }
  __syncwarp();
}

// Entries of the passes' twiddle tables, NS·(R − 1) a pass after the first
// (mel_fft.fft_tables).
__host__ __device__ constexpr int twiddle_entries(int nc) {
  return nc == 32 ? 24 : nc == 64 ? 56 : nc == 128 ? 120 : nc == 256 ? 248 : 504;
}

// The passes of mel_fft.plan(NC); tw holds their twiddle tables in order.
template <int NC>
__device__ __forceinline__ void fft(float2* buf, const float2* tw, const float2* wpair,
                                    const float* xf, int win, bool even_hop, int lane) {
  if constexpr (NC == 32) {
    fft_pass<32, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<32, 4, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 64) {
    fft_pass<64, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<64, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 128) {
    fft_pass<128, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<128, 4, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<128, 4, 32, false>(buf, tw + 8 * 3, wpair, xf, win, even_hop, lane);
  } else if constexpr (NC == 256) {
    fft_pass<256, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<256, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<256, 4, 64, false>(buf, tw + 8 * 7, wpair, xf, win, even_hop, lane);
  } else {
    static_assert(NC == 512, "nc must be a power of two in [32, 512]");
    fft_pass<512, 8, 1, true>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<512, 8, 8, false>(buf, tw, wpair, xf, win, even_hop, lane);
    fft_pass<512, 8, 64, false>(buf, tw + 8 * 7, wpair, xf, win, even_hop, lane);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
log_mel_fft_kernel(const float* __restrict__ x, const float2* __restrict__ tables,
                   const float* __restrict__ weights, const int32_t* __restrict__ bands,
                   float* __restrict__ out, int T, int n_frames, int n_tiles, int win,
                   int hop, int M, int n_weights, float log_eps) {
  constexpr int kTw = twiddle_entries(NC);
  constexpr int kTab = 2 * NC + 1 + kTw;
  constexpr int kBuf = NC + NC / 8;  // padded(NC)
  extern __shared__ __align__(16) float smem[];
  float2* tab = reinterpret_cast<float2*>(smem);  // window pairs | passes | W_N^k
  float2* bufs = tab + kTab;                       // one padded buffer a warp
  float* xs = reinterpret_cast<float*>(bufs + kWarps * kBuf);
  const int span = (kFftTile - 1) * hop + win;
  float* wts = xs + span + (span & 1);
  int* bnd = reinterpret_cast<int*>(wts + n_weights);

  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * kFftTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kTab; i += kThreads) tab[i] = tables[i];
  for (int i = threadIdx.x; i < n_weights; i += kThreads) wts[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M; i += kThreads) bnd[i] = bands[i];
  // The span read once; samples past the row (frames past n_frames) are 0.
  const float* row = x + (long long)b * T;
  const long long start = (long long)f0 * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long p = start + i;
    xs[i] = p < T ? row[p] : 0.f;
  }
  __syncthreads();

  const float2* wpair = tab;
  const float2* tw = tab + NC;
  const float2* split = tab + NC + kTw;
  float2* buf = bufs + warp * kBuf;
  float* power = reinterpret_cast<float*>(buf);
  const bool even_hop = (hop & 1) == 0;
  constexpr int kBins = NC / 32 + 1;  // bins k = lane + 32q <= NC of a lane

  for (int i = 0; i < kFftFramesPerWarp; ++i) {
    const int lf = warp * kFftFramesPerWarp + i;
    const int f = f0 + lf;
    if (f >= n_frames) break;  // warp-uniform
    fft<NC>(buf, tw, wpair, xs + lf * hop, win, even_hop, lane);

    // The split pass and the power; Z[NC] = Z[0], so bins 0 and NC are real.
    float pw[kBins];
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      const int k = lane + 32 * q;
      pw[q] = 0.f;
      if (k <= NC) {
        const float2 a = buf[padded(k & (NC - 1))];
        const float2 c = buf[padded((NC - k) & (NC - 1))];
        const float2 bc = make_float2(c.x, -c.y);  // Z*[NC - k]
        const float2 fe = make_float2((a.x + bc.x) * 0.5f, (a.y + bc.y) * 0.5f);
        const float2 fo = mul_neg_i(make_float2((a.x - bc.x) * 0.5f, (a.y - bc.y) * 0.5f));
        const float2 X = cadd(fe, cmul(split[k], fo));
        pw[q] = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      const int k = lane + 32 * q;
      if (k <= NC) power[k] = pw[q];
    }
    __syncwarp();

    // Each filter's band in bin order, then the log; the frame's M floats
    // are contiguous in the output.
    float* dst = out + ((long long)b * n_frames + f) * M;
    for (int m = lane; m < M; m += 32) {
      const int lo = bnd[m], hi = bnd[M + m];
      const float* w = wts + bnd[2 * M + m] - lo;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(power[k], w[k], acc);
      dst[m] = logf(acc + log_eps);
    }
    __syncwarp();  // the next frame's first pass overwrites the power
  }
}

template <int NC>
int launch_fft(const void* x, const void* tables, const void* weights, const void* bands,
               void* out, int B, int T, int n_frames, int win, int hop, int M, int n_weights,
               float log_eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fft_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_frames + kFftTile - 1) / kFftTile;
  log_mel_fft_kernel<NC><<<(unsigned)B * n_tiles, kThreads, smem, stream>>>(
      (const float*)x, (const float2*)tables, (const float*)weights, (const int32_t*)bands,
      (float*)out, T, n_frames, n_tiles, win, hop, M, n_weights, log_eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T) f32; cs (win, 2, 288) f32, [C row | S row] with zero columns past
// K; fbt (M, K) f32, the filterbank transposed; bands (2, M) int32, each
// filter's first and one-past-last nonzero bin; out (B, n_frames, M) f32.
// K > 288, or a hop and win whose waveform span does not fit a CTA's shared
// memory next to the slabs, returns cudaErrorInvalidValue and launches nothing.
extern "C" int vm_log_mel(const void* x, const void* cs, const void* fbt, const void* bands,
                          void* out, int B, int T, int n_frames, int win, int hop, int M,
                          int K, float log_eps, void* stream) {
  if (B == 0 || n_frames <= 0) return 0;
  if (K > kKPad) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_frames + kFrameTile - 1) / kFrameTile;
  const size_t smem = (size_t)(kTileFloats + (kFrameTile - 1) * hop + win) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_kernel<<<(unsigned)B * n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)cs, (const float*)fbt, (const int32_t*)bands,
      (float*)out, T, n_frames, n_tiles, win, hop, M, K, log_eps);
  return (int)cudaGetLastError();
}

// x (B, T) f32; tables (2·nc + 1 + twiddle_entries(nc), 2) f32: the window
// pairs (w[2n], w[2n+1]) with zeros past win, each pass's twiddles
// W_{NS·R}^{t·r} at t·(R − 1) + r − 1, W_N^k for k <= nc (nc = n_fft / 2 =
// 1 << log_nc); weights: the filters' nonzero runs concatenated; bands
// (3, M) int32: each filter's first and one-past-last nonzero bin and the
// offset of its run; out (B, n_frames, M) f32. An nc with no instance here,
// or a geometry whose CTA does not fit shared memory (the rule of
// ops/mel_fft.smem_bytes), returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int vm_log_mel_fft(const void* x, const void* tables, const void* weights,
                              const void* bands, void* out, int B, int T, int n_frames, int win,
                              int hop, int M, int n_weights, int log_nc, float log_eps,
                              void* stream) {
  if (B == 0 || n_frames <= 0) return 0;
  if (log_nc < 5 || log_nc > 9 || win > (2 << log_nc)) return (int)cudaErrorInvalidValue;
  const int nc = 1 << log_nc;
  const int span = (kFftTile - 1) * hop + win;
  const size_t smem = 8 * (size_t)(2 * nc + 1 + twiddle_entries(nc)) +
                      8 * (size_t)kWarps * (nc + nc / 8) +
                      4 * (size_t)(span + (span & 1)) + 4 * (size_t)n_weights + 12 * (size_t)M;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_nc) {
    case 5:
      return launch_fft<32>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                            n_weights, log_eps, smem, s);
    case 6:
      return launch_fft<64>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                            n_weights, log_eps, smem, s);
    case 7:
      return launch_fft<128>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
    case 8:
      return launch_fft<256>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
    default:
      return launch_fft<512>(x, tables, weights, bands, out, B, T, n_frames, win, hop, M,
                             n_weights, log_eps, smem, s);
  }
}
