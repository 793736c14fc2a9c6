// Unvoiced synthesis (windowed-noise DFT, band scaling, inverse DFT, WOLA)
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
//   E[l]    = sum of |X[k]|^2 over the bins of band l, ascending k
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
// 0.031 ms at 3.35 TB/s, while two 256-point real FFTs and the band logic
// are ~13k FP32 flops per channel (~0.006 ms at 67 TFLOP/s).
//
// What the design does about it (a simple, exact first form):
// - One block of 128 threads per 32 channels. The [256, 32] noise tile is
//   read with coalesced 128-byte rows into shared memory; every
//   intermediate (spectrum, band ids, energies, scalors, the new Uw) stays
//   on chip, so HBM sees only the function's own inputs and outputs.
// - The DFTs are direct sums against a 256-entry cosine table in shared
//   memory, after one radix-2 split (x[n] +- x[n+128] for even / odd bins
//   forward, uw[n] and uw[n+128] from the even / odd bin sums inverse):
//   65,536 FMAs per channel, an FP32 floor of ~0.064 ms at C = 32768, 2x
//   the byte bound. A full FFT would reach the bound; that is later work.
//   Each thread owns one bin (forward) or one sample pair (inverse) for all
//   32 channels, so every shared-memory row read is a broadcast float4 and
//   feeds 8 FMAs.
// - Band energies are sequential per channel over ascending bins (one
//   thread per channel), which is deterministic, unlike float atomics.
// - Band ids use IEEE division, floorf and ceilf (no fast math): kf / mult
//   and the ceil edges decide band membership bit for bit. Lanes with
//   mult <= 0 (AMBE erasure frames carry w0 = 0) give every bin no band,
//   so their spectrum is scaled to zero without a division by zero.
// - Bins whose band is above 56 take scalor 0 (the spare row 57). The tail
//   of C is masked, so any channel count runs.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 256;         // DFT length
constexpr int kBins = 128;      // bins that can carry a band
constexpr int kBands = 57;      // bands 0..56; row 57 is the spare (scalor 0)
constexpr int kFrame = 160;
constexpr int kCB = 32;         // channels per block
constexpr int kThreads = 128;
constexpr int kRows = kThreads / kCB;  // rows per pass of the row-wise loops
constexpr int kS = 36;          // padded row stride (floats) of the [*, 32] tiles
constexpr int kSS = 33;         // row stride of the scalor table
constexpr float kM256Over2Pi = 40.74366543152521f;  // float32(256 / 2 pi)
constexpr float kScaleCoeff = 146.17696f;

// Shared buffer, reused phase by phase (floats):
//   noise tile [256][32] (rows 0..127 become x[n]+x[n+128], 128..255 x[n]-x[n+128])
//   -> |X|^2 [128][kS] at 0 and band energies / scalors [58][kSS] at kBins*kS
//   -> Y re [128][kS] at 0 and Y im [128][kS] at kBins*kS
//   -> uw [256][kS]
constexpr int kBuf = kN * kS;

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

// acc[j] += yre[j] cos(2 pi idx / 256) - yim[j] sin(2 pi idx / 256), j < 32
__device__ __forceinline__ void inverse_terms(float (&acc)[kCB], const float* yre,
                                              const float* yim, const float* tab, int idx) {
  const float cr = tab[idx];
  const float ci = tab[(idx + 64) & (kN - 1)];  // -sin
  const float4* rr = reinterpret_cast<const float4*>(yre);
  const float4* ri = reinterpret_cast<const float4*>(yim);
#pragma unroll
  for (int q = 0; q < kCB / 4; ++q) {
    const float4 a = rr[q];
    const float4 b = ri[q];
    acc[4 * q + 0] = fmaf(b.x, ci, fmaf(a.x, cr, acc[4 * q + 0]));
    acc[4 * q + 1] = fmaf(b.y, ci, fmaf(a.y, cr, acc[4 * q + 1]));
    acc[4 * q + 2] = fmaf(b.z, ci, fmaf(a.z, cr, acc[4 * q + 2]));
    acc[4 * q + 3] = fmaf(b.w, ci, fmaf(a.w, cr, acc[4 * q + 3]));
  }
}

__global__ void __launch_bounds__(kThreads)
unvoiced_wola_kernel(const float* __restrict__ w0, const int* __restrict__ L,
                     const float* __restrict__ Ml, const int* __restrict__ Vl,
                     const float* __restrict__ prev_uw, const float* __restrict__ noise,
                     const float* __restrict__ cos_tab, const float* __restrict__ win256,
                     const float* __restrict__ w_prev, const float* __restrict__ w_curr,
                     const float* __restrict__ denom, float* __restrict__ add,
                     float* __restrict__ new_uw, int C) {
  __shared__ __align__(16) float buf[kBuf];
  __shared__ signed char band[kBins * kS];
  __shared__ float tab[kN];
  __shared__ float mult[kCB];

  const int t = threadIdx.x;
  const int lane = t % kCB;   // channel of the block in the row-wise passes
  const int row0 = t / kCB;
  const int c = blockIdx.x * kCB + lane;
  const bool live = c < C;

  for (int i = t; i < kN; i += kThreads) tab[i] = cos_tab[i];
  if (t < kCB) mult[t] = live ? kM256Over2Pi * w0[c] : 0.0f;
  for (int n = row0; n < kN; n += kRows)
    buf[n * kCB + lane] = live ? noise[static_cast<size_t>(n) * C + c] * win256[n] : 0.0f;
  __syncthreads();
  for (int i = t; i < kBins * kCB; i += kThreads) {
    const float a = buf[i], b = buf[i + kBins * kCB];
    buf[i] = a + b;
    buf[i + kBins * kCB] = a - b;
  }
  __syncthreads();

  // ---- forward DFT: warps 0-1 take the even bins, 2-3 the odd ones, so a
  // warp reads one tile row at a time (a broadcast) ----
  const int k = 2 * (t % 64) + t / 64;
  float re[kCB], im[kCB];
#pragma unroll
  for (int j = 0; j < kCB; ++j) re[j] = im[j] = 0.0f;
  {
    const float* src = buf + (k & 1) * kBins * kCB;
#pragma unroll 2
    for (int n = 0; n < kBins; ++n) {
      const int idx = (n * k) & (kN - 1);
      const float cr = tab[idx];
      const float ci = tab[(idx + 64) & (kN - 1)];  // -sin
      const float4* row = reinterpret_cast<const float4*>(src + n * kCB);
#pragma unroll
      for (int q = 0; q < kCB / 4; ++q) {
        const float4 v = row[q];
        re[4 * q + 0] = fmaf(v.x, cr, re[4 * q + 0]);
        im[4 * q + 0] = fmaf(v.x, ci, im[4 * q + 0]);
        re[4 * q + 1] = fmaf(v.y, cr, re[4 * q + 1]);
        im[4 * q + 1] = fmaf(v.y, ci, im[4 * q + 1]);
        re[4 * q + 2] = fmaf(v.z, cr, re[4 * q + 2]);
        im[4 * q + 2] = fmaf(v.z, ci, im[4 * q + 2]);
        re[4 * q + 3] = fmaf(v.w, cr, re[4 * q + 3]);
        im[4 * q + 3] = fmaf(v.w, ci, im[4 * q + 3]);
      }
    }
  }
  __syncthreads();  // the tile is dead

  // ---- |X|^2 and band ids of bin k; energies zeroed ----
  float* mag2 = buf;
  float* scal = buf + kBins * kS;
  {
    const float kf = static_cast<float>(k);
#pragma unroll
    for (int j = 0; j < kCB; ++j) {
      mag2[k * kS + j] = re[j] * re[j] + im[j] * im[j];
      band[k * kS + j] = static_cast<signed char>(band_of_bin(kf, mult[j]));
    }
  }
  for (int i = t; i < (kBands + 1) * kSS; i += kThreads) scal[i] = 0.0f;
  __syncthreads();

  // ---- band energies: one thread per channel, ascending bins ----
  if (t < kCB) {
#pragma unroll 4
    for (int kk = 0; kk < kBins; ++kk) {
      const int b = band[kk * kS + t];
      if (b < kBands) scal[b * kSS + t] += mag2[kk * kS + t];
    }
  }
  __syncthreads();

  // ---- band scalors, (band, channel) pairs over all threads ----
  {
    const float m = mult[lane];
    const int Lc = live ? L[c] : 0;
    for (int l = row0; l < kBands; l += kRows) {
      const float e = scal[l * kSS + lane];
      const float lf = static_cast<float>(l);
      const float a_min = fmaxf(ceilf((lf - 0.5f) * m), 0.0f);
      const float b_max = fminf(ceilf((lf + 0.5f) * m), static_cast<float>(kBins));
      const float count = b_max - a_min;
      float s = 0.0f;
      if (live && l >= 1 && l <= Lc && Vl[static_cast<size_t>(l) * C + c] == 0 &&
          count > 0.0f && e > 1e-10f) {
        const float mean = e / count;
        s = kScaleCoeff * Ml[static_cast<size_t>(l) * C + c] /
            sqrtf(mean > 0.0f ? mean : 1.0f);
      }
      scal[l * kSS + lane] = s;
    }
  }
  __syncthreads();

  // ---- scaled spectrum, with the inverse DFT's 1/256 and 2/256 weights ----
  {
    const float wk = (k == 0 ? 1.0f : 2.0f) / static_cast<float>(kN);
#pragma unroll
    for (int j = 0; j < kCB; ++j) {
      const float f = scal[band[k * kS + j] * kSS + j] * wk;
      re[j] *= f;
      im[j] *= f;
    }
  }
  __syncthreads();  // the scalors are dead
  float* yre = buf;
  float* yim = buf + kBins * kS;
#pragma unroll
  for (int j = 0; j < kCB; ++j) {
    yre[k * kS + j] = re[j];
    yim[k * kS + j] = im[j];
  }
  __syncthreads();

  // ---- inverse DFT: thread t forms uw[t] and uw[t+128] from the even-bin
  // sum E and the odd-bin sum O: uw[t] = E + O, uw[t+128] = E - O ----
  float ev[kCB], od[kCB];
#pragma unroll
  for (int j = 0; j < kCB; ++j) ev[j] = od[j] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < kBins; kk += 2) {
    inverse_terms(ev, yre + kk * kS, yim + kk * kS, tab, (t * kk) & (kN - 1));
    inverse_terms(od, yre + (kk + 1) * kS, yim + (kk + 1) * kS, tab, (t * (kk + 1)) & (kN - 1));
  }
  __syncthreads();  // the spectrum is dead
  float* uw = buf;
#pragma unroll
  for (int j = 0; j < kCB; ++j) {
    uw[t * kS + j] = ev[j] + od[j];
    uw[(t + kBins) * kS + j] = ev[j] - od[j];
  }
  __syncthreads();

  // ---- WOLA and the new previousUw, coalesced rows ----
  if (!live) return;
  for (int n = row0; n < kFrame; n += kRows) {
    const float pp = n < kBins ? prev_uw[static_cast<size_t>(n) * C + c] : 0.0f;
    const float cp = n >= 32 ? uw[(n - 32) * kS + lane] : 0.0f;
    const float dn = denom[n];
    add[static_cast<size_t>(n) * C + c] =
        dn > 1e-10f ? (w_prev[n] * pp + w_curr[n] * cp) / dn : 0.0f;
  }
  for (int n = row0; n < kBins; n += kRows)
    new_uw[static_cast<size_t>(n) * C + c] = uw[(n + kBins) * kS + lane];
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted.
extern "C" int mbe_unvoiced_wola(const float* w0, const int* L, const float* Ml, const int* Vl,
                                 const float* prev_uw, const float* noise, const float* cos_tab,
                                 const float* win256, const float* w_prev, const float* w_curr,
                                 const float* denom, float* add, float* new_uw, int C,
                                 void* stream) {
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((C + kCB - 1) / kCB);
  unvoiced_wola_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w0, L, Ml, Vl, prev_uw, noise, cos_tab, win256, w_prev, w_curr, denom, add, new_uw, C);
  return static_cast<int>(cudaGetLastError());
}
