// Voiced oscillator bank for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mbe_tpu/ops/pallas/voiced.py:_make_kernel
// (entry voiced_sums). For every channel c and sample n = 0..159:
//
//   out[n][c] = w_prev[n] * sum_{l<56} g_prev[l][c] * cos(phi_prev[l][c] + n*s_prev[l][c])
//             + w_cur[n]  * sum_{l<56} g_cur[l][c]  * cos(phi_cur0[l][c] + n*s_cur[l][c])
//             + sum_{l<7} (a0[l][c] + n*da[l][c]) * cos(phi0[l][c] + alpha[l][c]*n + q[l][c]*n*n)
//
// What bounds it on this card: FP32 operations. The function reads ~49 MB
// and writes ~21 MB at C = 32768 (0.021 ms at 3.35 TB/s), while even the
// cheapest exact form needs ~36k FP32 ops per channel for the two banks'
// per-sample sums alone.
//
// What the design does about it (seed once per harmonic, rotate to each span):
// - One block per 32 channels, 320 threads: lane = channel, warp = one
//   16-sample span. Every [56, C] row read and every [160, C] row written
//   is a coalesced 128-byte row.
// - Seeds, once per (channel, harmonic): precise sincosf of phi and of the
//   step s, then the rotor (cos 16s, sin 16s) by four squarings of
//   (cos s, sin s). Walking g*e^{i phi} by that rotor gives each span's
//   start g*e^{i(phi + n0 s)} by exact rotation: the angle error grows by
//   a few ulp per squaring and per span, and is not amplified by 1/sin s.
//   8 harmonics at a time are seeded by warps 0-7 into shared memory
//   (t0 = g cos(phi + n0 s) and t1 = g cos(phi + (n0+1) s) per span, and
//   2 cos s): 21.5 KB, each row read back as one 128-byte row.
// - Within a span, the Chebyshev recurrence t[n+1] = 2cos(s) t[n] - t[n-1]
//   with the gain folded into t: one FMA and one add per harmonic-sample.
//   Spans stay 16 samples long: as s -> 0 the recurrence's sensitivity to
//   the rounding of 2cos(s) grows as n^2/2 (~1.5e-5 g at n = 16).
// - The interpolated path (7 harmonics) runs the TPU kernel's double rotor
//   (voiced.py:117-119): the oscillator rotates by delta(n), delta(n) by
//   the constant 2q. Each span seeds it with precise sincosf of theta(n0),
//   delta(n0) = alpha + q(2 n0 + 1) and 2q.
// - Precise math only (no --use_fast_math): phases reach hundreds of
//   radians, where the fast approximations lose digits.
// - Each bank's window multiplies its summed span once per sample (the
//   windows do not depend on l). The tail of C is masked, so any channel
//   count runs.

#include <cuda_runtime.h>

namespace {

constexpr int kHarm = 56;
constexpr int kInterp = 7;
constexpr int kFrame = 160;
constexpr int kSpan = 16;                  // samples per thread; the recurrence restarts here
constexpr int kSpans = kFrame / kSpan;     // 10: one warp each
constexpr int kCB = 32;                    // channels per block: one lane each
constexpr int kThreads = kCB * kSpans;     // 320
constexpr int kChunk = 8;                  // harmonics seeded per pass, one warp each
constexpr int kSeedRows = 2 * kSpans + 1;  // t0 and t1 of every span, then 2cos(s)
static_assert(kHarm % kChunk == 0 && kChunk <= kSpans, "seeding warps");

// (re, im) *= (br, bi)
__device__ __forceinline__ void rotate(float& re, float& im, float br, float bi) {
  const float r = re * br - im * bi;
  im = re * bi + im * br;
  re = r;
}

// The span seeds of harmonic l of one bank for the channel of this lane.
__device__ __forceinline__ void seed_harmonic(const float* __restrict__ gain,
                                              const float* __restrict__ phi,
                                              const float* __restrict__ step, int l, int c,
                                              bool live, int C, float (*seed)[kCB], int lane) {
  float g = 0.0f, p = 0.0f, s = 0.0f;
  if (live) {
    const size_t i = static_cast<size_t>(l) * C + c;
    g = gain[i];
    p = phi[i];
    s = step[i];
  }
  float sp, cp, ss, cs;
  sincosf(p, &sp, &cp);
  sincosf(s, &ss, &cs);
  float rr = cs, ri = ss;  // (cos s, sin s) -> (cos 16s, sin 16s)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float r2 = rr * rr - ri * ri;
    ri = 2.0f * rr * ri;
    rr = r2;
  }
  float zr = g * cp, zi = g * sp;  // g e^{i(phi + n0 s)}, n0 = 16 j
#pragma unroll
  for (int j = 0; j < kSpans; ++j) {
    seed[2 * j][lane] = zr;
    seed[2 * j + 1][lane] = zr * cs - zi * ss;
    rotate(zr, zi, rr, ri);
  }
  seed[2 * kSpans][lane] = 2.0f * cs;
}

__global__ void __launch_bounds__(kThreads)
voiced_sums_kernel(const float* __restrict__ gain_prev, const float* __restrict__ phi_prev,
                   const float* __restrict__ step_prev, const float* __restrict__ gain_cur,
                   const float* __restrict__ phi_cur0, const float* __restrict__ step_cur,
                   const float* __restrict__ amp0, const float* __restrict__ damp,
                   const float* __restrict__ phi0, const float* __restrict__ alpha,
                   const float* __restrict__ q, const float* __restrict__ w_prev,
                   const float* __restrict__ w_cur, float* __restrict__ out, int C) {
  __shared__ float seed[kChunk][kSeedRows][kCB];

  const int lane = threadIdx.x % kCB;
  const int span = threadIdx.x / kCB;  // also the harmonic a warp seeds
  const int c = blockIdx.x * kCB + lane;
  const bool live = c < C;
  const int n0 = span * kSpan;

  float acc[kSpan], bank[kSpan];
#pragma unroll
  for (int k = 0; k < kSpan; ++k) acc[k] = bank[k] = 0.0f;

#pragma unroll 1
  for (int b = 0; b < 2; ++b) {
    const float* gain = b ? gain_cur : gain_prev;
    const float* phi = b ? phi_cur0 : phi_prev;
    const float* step = b ? step_cur : step_prev;
#pragma unroll 1
    for (int l0 = 0; l0 < kHarm; l0 += kChunk) {
      if (span < kChunk) seed_harmonic(gain, phi, step, l0 + span, c, live, C, seed[span], lane);
      __syncthreads();
#pragma unroll 2
      for (int h = 0; h < kChunk; ++h) {
        float t0 = seed[h][2 * span][lane];
        float t1 = seed[h][2 * span + 1][lane];
        const float c2 = seed[h][2 * kSpans][lane];
        bank[0] += t0;
        bank[1] += t1;
#pragma unroll
        for (int k = 2; k < kSpan; ++k) {
          const float t2 = c2 * t1 - t0;
          bank[k] += t2;
          t0 = t1;
          t1 = t2;
        }
      }
      __syncthreads();
    }
    const float* w = b ? w_cur : w_prev;
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      acc[k] = fmaf(w[n0 + k], bank[k], acc[k]);
      bank[k] = 0.0f;
    }
  }

  const float nf0 = static_cast<float>(n0);
#pragma unroll 1
  for (int l = 0; l < kInterp; ++l) {
    float a = 0.0f, da = 0.0f, p = 0.0f, al = 0.0f, qq = 0.0f;
    if (live) {
      const size_t i = static_cast<size_t>(l) * C + c;
      a = amp0[i];
      da = damp[i];
      p = phi0[i];
      al = alpha[i];
      qq = q[i];
    }
    float os, oc, ds, dc, rs, rc;
    sincosf(p + al * nf0 + qq * nf0 * nf0, &os, &oc);  // theta(n0)
    sincosf(al + qq * (2.0f * nf0 + 1.0f), &ds, &dc);  // theta(n0 + 1) - theta(n0)
    sincosf(2.0f * qq, &rs, &rc);
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      acc[k] = fmaf(a + (nf0 + static_cast<float>(k)) * da, oc, acc[k]);
      rotate(oc, os, dc, ds);
      rotate(dc, ds, rc, rs);
    }
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < kSpan; ++k) out[static_cast<size_t>(n0 + k) * C + c] = acc[k];
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted.
extern "C" int mbe_voiced_sums(const float* gain_prev, const float* phi_prev,
                               const float* step_prev, const float* gain_cur,
                               const float* phi_cur0, const float* step_cur,
                               const float* amp0, const float* damp, const float* phi0,
                               const float* alpha, const float* q, const float* w_prev,
                               const float* w_cur, float* out, int C, void* stream) {
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((C + kCB - 1) / kCB);
  voiced_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gain_prev, phi_prev, step_prev, gain_cur, phi_cur0, step_cur, amp0, damp, phi0,
      alpha, q, w_prev, w_cur, out, C);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of voiced_sums_kernel the runtime keeps resident per SM.
extern "C" int mbe_voiced_sums_blocks_per_sm() {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, voiced_sums_kernel, kThreads, 0) ==
                 cudaSuccess
             ? n
             : -1;
}
