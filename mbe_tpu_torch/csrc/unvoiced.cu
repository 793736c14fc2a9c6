// Unvoiced synthesis (windowed-noise FFT, band scaling, inverse FFT, WOLA)
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mbe_tpu/ops/pallas/unvoiced.py:_kernel
// (entry unvoiced_wola), the whole of mbe_unvoiced_fft.c:714-761 for every
// channel c:
//
//   x[n]    = noise[n][c] * win256[n]                       n = 0..255
//   X[k]    = sum_n x[n] e^{-2 pi i n k / 256}              k = 0..127
//   band[k] = the reference's ceil-edge band of bin k under mult = 256 w0 / 2 pi
//             (bin 128 never carries a band: b_max is clamped to 128)
//   E[l]    = sum of |X[k]|^2 over the bins a_min[l] .. b_max[l]-1 of band l,
//             ascending k
//   s[l]    = 146.17696 Ml[l] / sqrt(E[l] / count[l]) where 1 <= l <= L,
//             Vl[l] == 0, count[l] > 0 and E[l] > 1e-10; else 0
//   uw[n]   = real inverse DFT of X[k] s[band[k]]           n = 0..255
//   add[n]  = (w_prev[n] prev_uw[n] + w_curr[n] uw[n-32]) / denom[n]  n = 0..159
//             (prev_uw[n] = 0 for n >= 128, uw[n-32] = 0 for n < 32,
//              add = 0 where denom <= 1e-10)
//   new_uw  = uw[128..255]
//
// What bounds it on this card: bytes. The function reads 788 words and
// writes 288 of them per channel (3,152 B; 103 MB at C = 32768), about
// 0.031 ms at 3.35 TB/s, while the two real FFTs and the band logic are
// ~12k FP32 ops per channel (~0.012 ms).
//
// What the design does about it:
// - One block of 256 threads per 32 channels; lane = channel in every
//   phase, so every shared-memory row access is conflict-free and every
//   HBM row a coalesced 128-byte line. The [256, 32] noise tile comes in
//   by cp.async; the previousUw tile [128, 32] is fetched by cp.async while
//   the inverse FFT runs. HBM sees only the function's inputs and outputs.
// - Both transforms are 128-point complex FFTs in shared memory on the
//   tile itself: the forward one of z[m] = x[2m] + i x[2m+1] (complex
//   element m in tile rows 2m and 2m+1), decimation in frequency (natural
//   order in, bit-reversed out), then the split into bins 0..127; the
//   inverse one of the Hermitian pack of the scaled half spectrum,
//   decimation in time (bit-reversed in, natural out), so the tile ends
//   as uw[0..255] in row order. Each transform is two passes of radix-2
//   stages fused in registers (4 stages on 16 elements, then 3 on 8), with
//   twiddles from the 256-entry cosine table. A thread owns (channel,
//   element group) pairs, not a 32-channel accumulator array.
// - Band energies by (channel, band) pairs over all threads, each summing
//   its bins in ascending order (mbe_unvoiced_fft.c:643-661):
//   deterministic, unlike float atomics.
// - Band ids use IEEE division, floorf and ceilf (no fast math): kf / mult
//   and the ceil edges decide band membership bit for bit. Lanes with
//   mult <= 0 (AMBE erasure frames carry w0 = 0) give every bin no band
//   and empty band ranges, so their spectrum is scaled to zero without a
//   division by zero.
// - Bins whose band is above 56 take scalor 0 (the spare row 57). The tail
//   of C is masked, so any channel count runs.
// - Per-block constants sit in shared memory: the twiddles as (cos, sin)
//   pairs (one 8-byte read each), the window, and the WOLA weights with
//   1/denom, so the WOLA multiplies where the reference divides (within
//   an ulp or two).
// - __launch_bounds__(256, 4) holds ptxas to 64 registers: four blocks
//   (54 KB of shared memory each) per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kN = 256;          // real transform length
constexpr int kBins = 128;       // complex FFT length; bins that can carry a band
constexpr int kBands = 57;       // bands 0..56; row 57 is the spare (scalor 0)
constexpr int kFrame = 160;
constexpr int kUw = 128;
constexpr int kCB = 32;          // channels per block: one lane each
constexpr int kWarps = 8;
constexpr int kThreads = kCB * kWarps;
constexpr float kM256Over2Pi = 40.74366543152521f;  // float32(256 / 2 pi)
constexpr float kScaleCoeff = 146.17696f;

// Dynamic shared memory (floats):
//   tile [256][32]: x, then Z / X in bit-reversed element order, then the
//                   packed inverse input, then uw[0..255] in row order
//   side [128][32]: band scalors [58][32] (times 1/256), then previousUw
//   tw   [256] x 2: (cos, sin)(2 pi i / 256)
//   win  [256]:     the 256-tap window
//   wola [3][160]:  w_prev, w_curr and 1/denom (0 where denom <= 1e-10)
//   mult [32]
constexpr int kTile = kN * kCB;
constexpr int kSide = kUw * kCB;
constexpr size_t kSmemBytes = sizeof(float) * (kTile + kSide + 2 * kN + kN + 3 * kFrame + kCB);

__device__ __forceinline__ int band_of_bin(float kf, float m) {
  if (!(m > 0.0f)) return kBands;
  float b = floorf(kf / m + 0.5f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lo = ceilf((b - 0.5f) * m);
    const float hi = ceilf((b + 0.5f) * m);
    b = (b + (kf >= hi ? 1.0f : 0.0f)) - (kf < lo ? 1.0f : 0.0f);
  }
  return (b >= 0.0f && b <= 56.0f) ? static_cast<int>(b) : kBands;
}

__device__ __forceinline__ int bitrev7(int k) { return static_cast<int>(__brev(k) >> 25); }

// e^{sign * 2 pi i idx / 256}: one 8-byte read of the (cos, sin) table
__device__ __forceinline__ void twiddle(const float2* tw, int idx, float sign, float& wr,
                                        float& wi) {
  const float2 w = tw[idx & (kN - 1)];
  wr = w.x;
  wi = sign * w.y;
}

// Complex element e of this lane's channel: rows 2e (re) and 2e+1 (im).
__device__ __forceinline__ float& re_of(float* tile, int e, int lane) {
  return tile[(2 * e) * kCB + lane];
}
__device__ __forceinline__ float& im_of(float* tile, int e, int lane) {
  return tile[(2 * e + 1) * kCB + lane];
}

// S fused radix-2 stages on the group of 2^S elements b + j + m*D (m < 2^S)
// of this lane's channel: decimation in frequency (half-sizes D*2^(S-1)
// down to D, forward twiddles) or in time (D up to D*2^(S-1), inverse
// twiddles). An element at offset p < h in its block of 2h pairs with the
// one at p + h under the twiddle e^{-+2 pi i p / 2h} = table index p*128/h.
// `win`, when given, windows the elements as they are loaded.
template <int S, int D, bool kDif>
__device__ __forceinline__ void fft_group(float* tile, const float2* tw, int lane, int b, int j,
                                          const float* win) {
  constexpr int M = 1 << S;
  float re[M], im[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int e = b + j + m * D;
    re[m] = re_of(tile, e, lane);
    im[m] = im_of(tile, e, lane);
    if (win != nullptr) {
      re[m] *= win[2 * e];
      im[m] *= win[2 * e + 1];
    }
  }
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int s = kDif ? S - 1 - t : t;
    const int h = D << s;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & (1 << s)) continue;
      const int m2 = m + (1 << s);
      float wr, wi;
      twiddle(tw, (j + (m & ((1 << s) - 1)) * D) * (kBins / h), kDif ? -1.0f : 1.0f, wr, wi);
      if (kDif) {
        const float vr = re[m] - re[m2], vi = im[m] - im[m2];
        re[m] += re[m2];
        im[m] += im[m2];
        re[m2] = vr * wr - vi * wi;
        im[m2] = vr * wi + vi * wr;
      } else {
        const float vr = re[m2] * wr - im[m2] * wi;
        const float vi = re[m2] * wi + im[m2] * wr;
        re[m2] = re[m] - vr;
        im[m2] = im[m] - vi;
        re[m] += vr;
        im[m] += vi;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int e = b + j + m * D;
    re_of(tile, e, lane) = re[m];
    im_of(tile, e, lane) = im[m];
  }
}

// Bin k of the 256-point real transform from the 128-point complex one:
// X[k] = A - i W^k B, A = (Z[k] + conj Z[k'])/2, B = (Z[k] - conj Z[k'])/2,
// W = e^{-2 pi i / 256}, Z[k'] the partner Z[128 - k] (Z[0] for k = 0).
__device__ __forceinline__ void split_bin(const float2* tw, int k, float zr, float zi, float pr,
                                          float pi, float& xr, float& xi) {
  const float ar = 0.5f * (zr + pr), ai = 0.5f * (zi - pi);
  const float br = 0.5f * (zr - pr), bi = 0.5f * (zi + pi);
  float wr, wi;
  twiddle(tw, k, -1.0f, wr, wi);
  const float tr = wr * br - wi * bi, ti = wr * bi + wi * br;
  xr = ar + ti;
  xi = ai - tr;
}

// Element k of the 128-point inverse input for the real inverse transform:
// (Y[k] + conj Y[k']) + i e^{2 pi i k / 256} (Y[k] - conj Y[k']), Y[k'] the
// partner Y[128 - k] (0 for k = 0: bin 128 carries no band).
__device__ __forceinline__ void pack_bin(const float2* tw, int k, float yr, float yi, float pr,
                                         float pi, float& zr, float& zi) {
  const float qr = yr - pr, qi = yi + pi;
  float vr, vi;
  twiddle(tw, k, 1.0f, vr, vi);
  const float ur = vr * qr - vi * qi, ui = vr * qi + vi * qr;
  zr = (yr + pr) - ui;
  zi = (yi - pi) + ur;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// rows x [kCB] of a [rows, C] array from channel c0 on, into dst [rows][kCB];
// lanes past C are zero. 16-byte copies when every row start is aligned.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int C, int c0) {
  const int t = threadIdx.x;
  if (c0 + kCB <= C && C % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = t; i < rows * (kCB / 4); i += kThreads) {
      const int n = i / (kCB / 4), q = 4 * (i % (kCB / 4));
      cp_async16(dst + n * kCB + q, src + static_cast<size_t>(n) * C + c0 + q);
    }
  } else {
    const int lane = t % kCB;
    const bool valid = c0 + lane < C;
    for (int n = t / kCB; n < rows; n += kWarps)
      cp_async4(dst + n * kCB + lane,
                src + static_cast<size_t>(n) * C + (valid ? c0 + lane : c0), valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_tiles() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__global__ void __launch_bounds__(kThreads, 4)
unvoiced_wola_kernel(const float* __restrict__ w0, const int* __restrict__ L,
                     const float* __restrict__ Ml, const int* __restrict__ Vl,
                     const float* __restrict__ prev_uw, const float* __restrict__ noise,
                     const float* __restrict__ cos_tab, const float* __restrict__ win256,
                     const float* __restrict__ w_prev, const float* __restrict__ w_curr,
                     const float* __restrict__ denom, float* __restrict__ add,
                     float* __restrict__ new_uw, int C) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* side = smem + kTile;
  float2* tw = reinterpret_cast<float2*>(side + kSide);
  float* win = side + kSide + 2 * kN;
  float* wola = win + kN;
  float* mult = wola + 3 * kFrame;

  const int t = threadIdx.x;
  const int lane = t % kCB;
  const int warp = t / kCB;
  const int c0 = blockIdx.x * kCB;
  const int c = c0 + lane;
  const bool live = c < C;

  load_tile(tile, noise, kN, C, c0);
  for (int i = t; i < kN; i += kThreads) {
    tw[i] = make_float2(cos_tab[i], cos_tab[(i + 192) & (kN - 1)]);  // sin x = cos(x - pi/2)
    win[i] = win256[i];
  }
  for (int n = t; n < kFrame; n += kThreads) {
    wola[n] = w_prev[n];
    wola[kFrame + n] = w_curr[n];
    wola[2 * kFrame + n] = denom[n] > 1e-10f ? 1.0f / denom[n] : 0.0f;
  }
  if (t < kCB) mult[t] = live ? kM256Over2Pi * w0[c] : 0.0f;
  wait_tiles();
  __syncthreads();

  // ---- forward FFT of the windowed z[m] (DIF): stages 64..8, then 4..1 ----
  fft_group<4, 8, true>(tile, tw, lane, 0, warp, win);
  __syncthreads();
#pragma unroll 1
  for (int g = warp; g < kBins / 8; g += kWarps) fft_group<3, 1, true>(tile, tw, lane, 8 * g, 0, nullptr);
  __syncthreads();

  // ---- split into X[k], k = 0..127, in place (slot bitrev7(k)); task k
  // takes the pair (k, 128 - k), task 0 the lone bins 0 and 64 ----
#pragma unroll 1
  for (int k = warp; k < kBins / 2; k += kWarps) {
    const int ka = k, kb = k ? kBins - k : kBins / 2;
    const int sa = bitrev7(ka), sb = bitrev7(kb);
    const float ar = re_of(tile, sa, lane), ai = im_of(tile, sa, lane);
    const float br = re_of(tile, sb, lane), bi = im_of(tile, sb, lane);
    float xr, xi, yr, yi;
    split_bin(tw, ka, ar, ai, k ? br : ar, k ? bi : ai, xr, xi);
    split_bin(tw, kb, br, bi, k ? ar : br, k ? ai : bi, yr, yi);
    re_of(tile, sa, lane) = xr;
    im_of(tile, sa, lane) = xi;
    re_of(tile, sb, lane) = yr;
    im_of(tile, sb, lane) = yi;
  }
  __syncthreads();

  // ---- band energies and scalors: (band 1..56, channel) pairs, each
  // summing its bins in ascending order; scalors carry the inverse's 1/256 ----
  float* scal = side;
  {
    const float m = mult[lane];
    const int Lc = live ? L[c] : 0;
#pragma unroll 1
    for (int l = 1 + warp; l < kBands; l += kWarps) {
      const float lf = static_cast<float>(l);
      const float a_min = fmaxf(ceilf((lf - 0.5f) * m), 0.0f);
      const float b_max = fminf(ceilf((lf + 0.5f) * m), static_cast<float>(kBins));
      const float count = b_max - a_min;
      float e = 0.0f;
      for (int k = static_cast<int>(a_min); k < static_cast<int>(b_max); ++k) {
        const int sk = bitrev7(k);
        const float xr = re_of(tile, sk, lane), xi = im_of(tile, sk, lane);
        e += xr * xr + xi * xi;
      }
      float s = 0.0f;
      if (live && l <= Lc && Vl[static_cast<size_t>(l) * C + c] == 0 && count > 0.0f &&
          e > 1e-10f) {
        const float mean = e / count;
        s = kScaleCoeff * Ml[static_cast<size_t>(l) * C + c] / sqrtf(mean > 0.0f ? mean : 1.0f);
      }
      scal[l * kCB + lane] = s * (1.0f / kN);
    }
    if (warp == 0) scal[lane] = scal[kBands * kCB + lane] = 0.0f;
  }
  __syncthreads();

  // ---- scale each bin by its band's scalor and pack the inverse input in
  // place (slot bitrev7(k) holds element k) ----
  {
    const float m = mult[lane];
#pragma unroll 1
    for (int k = warp; k < kBins / 2; k += kWarps) {
      const int ka = k, kb = k ? kBins - k : kBins / 2;
      const int sa = bitrev7(ka), sb = bitrev7(kb);
      const float fa = scal[band_of_bin(static_cast<float>(ka), m) * kCB + lane];
      const float fb = scal[band_of_bin(static_cast<float>(kb), m) * kCB + lane];
      const float ar = re_of(tile, sa, lane) * fa;
      const float ai = k ? im_of(tile, sa, lane) * fa : 0.0f;  // bin 0 is real
      const float br = re_of(tile, sb, lane) * fb, bi = im_of(tile, sb, lane) * fb;
      float zr, zi, yr, yi;
      pack_bin(tw, ka, ar, ai, k ? br : 0.0f, k ? bi : 0.0f, zr, zi);
      pack_bin(tw, kb, br, bi, k ? ar : br, k ? ai : bi, yr, yi);
      re_of(tile, sa, lane) = zr;
      im_of(tile, sa, lane) = zi;
      re_of(tile, sb, lane) = yr;
      im_of(tile, sb, lane) = yi;
    }
  }
  __syncthreads();  // the scalors are dead: previousUw comes into `side`
  load_tile(side, prev_uw, kUw, C, c0);

  // ---- inverse FFT (DIT): stages 1..4, then 8..64; element m of the
  // result is uw[2m] + i uw[2m+1], so tile row n holds uw[n] ----
#pragma unroll 1
  for (int g = warp; g < kBins / 8; g += kWarps) fft_group<3, 1, false>(tile, tw, lane, 8 * g, 0, nullptr);
  __syncthreads();
  fft_group<4, 8, false>(tile, tw, lane, 0, warp, nullptr);
  wait_tiles();
  __syncthreads();

  // ---- WOLA and the new previousUw, coalesced rows ----
  if (!live) return;
  for (int n = warp; n < kFrame; n += kWarps) {
    const float pp = n < kUw ? side[n * kCB + lane] : 0.0f;
    const float cp = n >= 32 ? tile[(n - 32) * kCB + lane] : 0.0f;
    add[static_cast<size_t>(n) * C + c] =
        (wola[n] * pp + wola[kFrame + n] * cp) * wola[2 * kFrame + n];
  }
  for (int n = warp; n < kUw; n += kWarps)
    new_uw[static_cast<size_t>(n) * C + c] = tile[(kUw + n) * kCB + lane];
}

// Per device: whether the kernel's dynamic shared-memory limit is raised there.
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_raised[kMaxDevices];

// Raises the kernel's shared-memory limit on the current device, once: later
// calls only read the flag, so a launch inside a CUDA graph capture sets no
// attribute (as softecc.cu's device_sms).
cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_smem_raised[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(unvoiced_wola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) g_smem_raised[dev].store(true, std::memory_order_relaxed);
  return err;
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error of
// the set-up or of the launch: 0 when the launch was accepted.
extern "C" int mbe_unvoiced_wola(const float* w0, const int* L, const float* Ml, const int* Vl,
                                 const float* prev_uw, const float* noise, const float* cos_tab,
                                 const float* win256, const float* w_prev, const float* w_curr,
                                 const float* denom, float* add, float* new_uw, int C,
                                 void* stream) {
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kCB - 1) / kCB);
  unvoiced_wola_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      w0, L, Ml, Vl, prev_uw, noise, cos_tab, win256, w_prev, w_curr, denom, add, new_uw, C);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of unvoiced_wola_kernel the runtime keeps resident per SM.
extern "C" int mbe_unvoiced_wola_blocks_per_sm() {
  int n = 0;
  if (raise_smem_limit() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, unvoiced_wola_kernel, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}
