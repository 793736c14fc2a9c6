// Voiced oscillator bank for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mbe_tpu/ops/pallas/voiced.py:_make_kernel
// (entry voiced_sums). For every channel c and sample n = 0..159:
//
//   out[n][c] = w_prev[n] * sum_{l<56} g_prev[l][c] * cos(phi_prev[l][c] + n*s_prev[l][c])
//             + w_cur[n]  * sum_{l<56} g_cur[l][c]  * cos(phi_cur0[l][c] + n*s_cur[l][c])
//             + sum_{l<7} (a0[l][c] + n*da[l][c]) * cos(phi0[l][c] + alpha[l][c]*n + q[l][c]*n*n)
//
// What bounds it on this card: the cosines. Evaluated directly that is
// 56*2*160 + 7*160 = 19,040 precise cosf per channel-frame (~620M at
// C = 32768), against ~21 MB written and ~49 MB read, so the kernel is
// bound by the FP32 pipes, not by HBM.
//
// What the design does about it:
// - The two windowed banks run the Chebyshev three-term recurrence
//   t[n+1] = 2cos(s)*t[n] - t[n-1] with the gain folded into t (t[n] =
//   g*cos(phi + n*s)): one FMA per harmonic-sample. Each block of 16
//   samples restarts it from two precise cosf, so the drift of the
//   recurrence (a step-k error grows as sin((n-k)s)/sin(s) <= n-k) stays
//   below ~16^2/2 ulp; 3 cosf per harmonic and block instead of 16.
// - The interpolated path (7 harmonics) evaluates its quadratic phase
//   directly with cosf per sample.
// - Precise cosf only (no --use_fast_math, no __cosf): phase arguments
//   reach hundreds of radians, where the fast approximations lose digits.
// - One thread per (channel, block of 16 samples): threadIdx.x walks the
//   channels, so every [56, C] row read and every [160, C] row written is
//   coalesced; blockIdx.y picks the sample block, which gives 10x the
//   threads of one-thread-per-channel and keeps the SMs full at any C.
//   The tail of C is masked, so any channel count runs.
// - The windows multiply the summed banks once per sample at the end
//   (they do not depend on l).

#include <cuda_runtime.h>

namespace {

constexpr int kHarm = 56;
constexpr int kInterp = 7;
constexpr int kFrame = 160;
constexpr int kSpan = 16;  // samples per thread; the recurrence restarts here
constexpr int kThreads = 128;

__device__ __forceinline__ void oscillator_bank(const float* __restrict__ gain,
                                                const float* __restrict__ phi,
                                                const float* __restrict__ step,
                                                int C, int c, int n0,
                                                float (&acc)[kSpan]) {
#pragma unroll 1
  for (int l = 0; l < kHarm; ++l) {
    const size_t i = static_cast<size_t>(l) * C + c;
    const float g = gain[i];
    const float p = phi[i];
    const float s = step[i];
    float t0 = g * cosf(p + static_cast<float>(n0) * s);
    float t1 = g * cosf(p + static_cast<float>(n0 + 1) * s);
    const float c2 = 2.0f * cosf(s);
    acc[0] += t0;
    acc[1] += t1;
#pragma unroll
    for (int k = 2; k < kSpan; ++k) {
      const float t2 = c2 * t1 - t0;
      acc[k] += t2;
      t0 = t1;
      t1 = t2;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
voiced_sums_kernel(const float* __restrict__ gain_prev, const float* __restrict__ phi_prev,
                   const float* __restrict__ step_prev, const float* __restrict__ gain_cur,
                   const float* __restrict__ phi_cur0, const float* __restrict__ step_cur,
                   const float* __restrict__ amp0, const float* __restrict__ damp,
                   const float* __restrict__ phi0, const float* __restrict__ alpha,
                   const float* __restrict__ q, const float* __restrict__ w_prev,
                   const float* __restrict__ w_cur, float* __restrict__ out, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int n0 = blockIdx.y * kSpan;

  float sum_prev[kSpan], sum_cur[kSpan], sum_interp[kSpan];
#pragma unroll
  for (int k = 0; k < kSpan; ++k) {
    sum_prev[k] = 0.0f;
    sum_cur[k] = 0.0f;
    sum_interp[k] = 0.0f;
  }
  oscillator_bank(gain_prev, phi_prev, step_prev, C, c, n0, sum_prev);
  oscillator_bank(gain_cur, phi_cur0, step_cur, C, c, n0, sum_cur);

#pragma unroll 1
  for (int l = 0; l < kInterp; ++l) {
    const size_t i = static_cast<size_t>(l) * C + c;
    const float a = amp0[i], da = damp[i], p = phi0[i], al = alpha[i], qq = q[i];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const float n = static_cast<float>(n0 + k);
      sum_interp[k] += (a + n * da) * cosf(p + al * n + qq * n * n);
    }
  }

#pragma unroll
  for (int k = 0; k < kSpan; ++k) {
    const int n = n0 + k;
    out[static_cast<size_t>(n) * C + c] =
        w_prev[n] * sum_prev[k] + w_cur[n] * sum_cur[k] + sum_interp[k];
  }
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
  const dim3 grid((C + kThreads - 1) / kThreads, kFrame / kSpan);
  voiced_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gain_prev, phi_prev, step_prev, gain_cur, phi_cur0, step_cur, amp0, damp, phi0,
      alpha, q, w_prev, w_cur, out, C);
  return static_cast<int>(cudaGetLastError());
}
