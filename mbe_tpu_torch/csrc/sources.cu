// Noise and tone sources of the synthesis layer for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces no TPU kernel: the reference computes these three streams with
// XLA's elementwise ops, and the port did so with plain PyTorch (ops/noise.py,
// ops/synth.py), building each as int64 tensors of 160 or 256 rows, one op at
// a time. Three entry points, one launch each:
//   mbe_comfort_noise  java.util.Random comfort noise (mbe_adaptive.c:117-131):
//                      the 48-bit LCG, samples [n, C] and the state after n steps
//                      as 16-bit limbs [3, C];
//   mbe_lcg_buffer     the unvoiced noise buffer (mbe_unvoiced_fft.c:305-341):
//                      96 overlap samples re-expanded from the previous seed,
//                      then 160 from the current one, x' = (171x + 11213) mod
//                      53125; buffer [256, C] and the two seeds;
//   mbe_tone_render    a tone (mbelib.c:707-736): one or two uint32 phase
//                      accumulators and a sine per sample; samples [160, C] and
//                      the two phases.
//
// Every output equals the plain form's bit for bit. The integers are exact by
// construction. The float chains repeat the plain form's IEEE operations in
// its order, written with __fmul_rn / __fadd_rn / __fsub_rn so that nvcc's
// default FMA contraction cannot merge them; the sine is the precise sinf.
//
// What bounds it on this card: the stores. At C = 32768 the outputs are 21 MB
// (comfort), 34 MB (buffer) and 21 MB (tone) against a few hundred kB of
// reads: 0.017 ms (IMBE, two launches) or 0.023 ms (AMBE, three) at 3.35 TB/s.
// Design: a block of 128 threads takes 128 consecutive channels of one span of
// sample rows (blockIdx.y), so each warp stores 128 contiguous bytes of a row.
// A thread seeds its span's first state from the jump tables (state_k =
// A_k*s + B_k) and steps the generator sequentially from there; splitting the
// rows into spans puts several threads on each channel and keeps more stores
// in flight than one thread per channel would (about 8 warps per SM at C =
// 32768). The tone's samples are independent: a span is just rows. Any C, the
// ragged block masked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kFrame = 160;
constexpr int kBuffer = 256;
constexpr int kOverlap = 96;      // buffer rows 0..95: samples 64..159 of the previous seed
constexpr int kOverlapFrom = 64;
constexpr uint32_t kLcgMod = 53125;
constexpr uint32_t kLcgMul = 171;
constexpr uint32_t kLcgAdd = 11213;
constexpr uint64_t kJavaMul = 0x5DEECE66DULL;
constexpr uint64_t kJavaAdd = 0xBULL;
constexpr uint64_t kMask48 = (1ULL << 48) - 1;
constexpr uint64_t kMask32 = 0xFFFFFFFFULL;

// limbs [3, C] int64 (16-bit limbs s0 + s1 2^16 + s2 2^32); jump_a/jump_b
// [160] int64: the state after k + 1 steps is jump_a[k]*s + jump_b[k] mod
// 2^48. samples [rows, C] f32; new_limbs [3, C] int64: the state after rows
// steps.
__global__ void __launch_bounds__(kThreads)
comfort_noise_kernel(const long long* __restrict__ limbs, const long long* __restrict__ jump_a,
                     const long long* __restrict__ jump_b, float gain, int rows, int span,
                     float* __restrict__ samples, long long* __restrict__ new_limbs, int c) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const int n0 = blockIdx.y * span;
  const int n1 = min(n0 + span, rows);
  const uint64_t s = (static_cast<uint64_t>(limbs[ch])
                      + (static_cast<uint64_t>(limbs[c + ch]) << 16)
                      + (static_cast<uint64_t>(limbs[2 * c + ch]) << 32)) & kMask48;
  uint64_t x = (static_cast<uint64_t>(jump_a[n0]) * s + static_cast<uint64_t>(jump_b[n0])) & kMask48;
  for (int n = n0; n < n1; ++n) {
    if (n > n0) x = (x * kJavaMul + kJavaAdd) & kMask48;
    // next(24): the top 24 bits; ((float)val / 2^24) * 2 - 1, then the gain
    const float val = static_cast<float>(static_cast<uint32_t>(x >> 24));
    const float u = __fsub_rn(__fmul_rn(__fdiv_rn(val, 16777216.0f), 2.0f), 1.0f);
    samples[static_cast<size_t>(n) * c + ch] = __fmul_rn(u, gain);
  }
  if (n1 == rows) {
    new_limbs[ch] = static_cast<long long>(x & 0xFFFF);
    new_limbs[c + ch] = static_cast<long long>((x >> 16) & 0xFFFF);
    new_limbs[2 * c + ch] = static_cast<long long>(x >> 32);
  }
}

// seed, prev_seed, prime [C] f32; lcg_a/lcg_b [161] int64: state_k =
// (lcg_a[k]*s + lcg_b[k]) mod 53125. buffer [256, C] f32; new_seed,
// new_prev_seed [C] f32.
__global__ void __launch_bounds__(kThreads)
lcg_buffer_kernel(const float* __restrict__ seed, const float* __restrict__ prev_seed,
                  const float* __restrict__ prime, const long long* __restrict__ lcg_a,
                  const long long* __restrict__ lcg_b, int span, float* __restrict__ buffer,
                  float* __restrict__ new_seed, float* __restrict__ new_prev_seed, int c) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const int r0 = blockIdx.y * span;
  const int r1 = min(r0 + span, kBuffer);
  const float sd = seed[ch];
  if (sd < 0.0f) {  // cold start: zeros, and the seed is primed
    for (int r = r0; r < r1; ++r) buffer[static_cast<size_t>(r) * c + ch] = 0.0f;
    if (r1 == kBuffer) {
      new_seed[ch] = prime[ch];
      new_prev_seed[ch] = -1.0f;
    }
    return;
  }
  // the plain form's casts: int32 for the seed, int64 for the clamped
  // previous seed, then a non-negative remainder
  int si = static_cast<int>(sd) % static_cast<int>(kLcgMod);
  if (si < 0) si += kLcgMod;
  const float ps = prev_seed[ch];
  const bool no_overlap = ps < 0.0f;
  const uint32_t prev = static_cast<uint32_t>(
      static_cast<long long>(no_overlap ? 0.0f : ps) % static_cast<long long>(kLcgMod));
  const uint32_t cur = static_cast<uint32_t>(si);
  uint32_t x = 0;
  for (int r = r0; r < r1; ++r) {
    if (r == r0 || r == kOverlap) {  // seed from the jump tables
      const int k = r < kOverlap ? kOverlapFrom + r : r - kOverlap;
      const uint64_t base = r < kOverlap ? prev : cur;
      x = static_cast<uint32_t>((static_cast<uint64_t>(lcg_a[k]) * base
                                 + static_cast<uint64_t>(lcg_b[k])) % kLcgMod);
    } else {
      x = (kLcgMul * x + kLcgAdd) % kLcgMod;
    }
    buffer[static_cast<size_t>(r) * c + ch] =
        (r < kOverlap && no_overlap) ? 0.0f : static_cast<float>(x);
  }
  if (r1 == kBuffer) {
    new_seed[ch] = static_cast<float>((kLcgMul * x + kLcgAdd) % kLcgMod);
    new_prev_seed[ch] = sd;
  }
}

// sin(phase * rad - half_pi) of the uint32 phase, as the plain form rounds it
__device__ __forceinline__ float tone_osc(uint32_t phase, float rad, float half_pi) {
  return sinf(__fsub_rn(__fmul_rn(__uint2float_rn(phase), rad), half_pi));
}

// tone_id, amplitude_id [C] int32; swn, tone_phase [C] int64 (uint32
// values); step1/step2 [256] int64 and active/dual [256] bool per tone id.
// samples [160, C] f32; new_swn, new_tone_phase [C] int64.
__global__ void __launch_bounds__(kThreads)
tone_render_kernel(const int* __restrict__ tone_id, const int* __restrict__ amplitude_id,
                   const long long* __restrict__ swn, const long long* __restrict__ tone_phase,
                   const long long* __restrict__ step1_t, const long long* __restrict__ step2_t,
                   const bool* __restrict__ active_t, const bool* __restrict__ dual_t,
                   float soft_clip, float inv127, float rad, float half_pi, int span,
                   float* __restrict__ samples, long long* __restrict__ new_swn,
                   long long* __restrict__ new_tone_phase, int c) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const int n0 = blockIdx.y * span;
  const int n1 = min(n0 + span, kFrame);
  const int tid = min(max(tone_id[ch], 0), 255);
  const uint64_t step1 = static_cast<uint64_t>(step1_t[tid]);
  const uint64_t step2 = static_cast<uint64_t>(step2_t[tid]);
  const bool active = active_t[tid];
  const bool dual = dual_t[tid];
  // (amplitude / 127) * SOFT_CLIP; PyTorch's CUDA division of a tensor by a
  // Python number multiplies by the float reciprocal
  const float gain = __fmul_rn(__fmul_rn(static_cast<float>(max(amplitude_id[ch], 0)), inv127),
                               soft_clip);
  const float half = __fmul_rn(0.5f, gain);
  const float g1 = active ? (dual ? half : gain) : 0.0f;
  const float g2 = dual ? half : 0.0f;
  const long long sw = swn[ch];
  const long long tp = tone_phase[ch];
  const uint32_t p1 = static_cast<uint32_t>(sw);
  const uint32_t p2 = static_cast<uint32_t>(tp);
  const uint32_t s1 = static_cast<uint32_t>(step1);
  const uint32_t s2 = static_cast<uint32_t>(step2);
  // a zero step holds the phase, so its sine is taken once
  const float o1_fixed = s1 == 0 ? tone_osc(p1, rad, half_pi) : 0.0f;
  const float o2_fixed = s2 == 0 ? tone_osc(p2, rad, half_pi) : 0.0f;
  for (int n = n0; n < n1; ++n) {
    const uint32_t k = static_cast<uint32_t>(n + 1);
    const float o1 = s1 == 0 ? o1_fixed : tone_osc(p1 + s1 * k, rad, half_pi);
    const float o2 = s2 == 0 ? o2_fixed : tone_osc(p2 + s2 * k, rad, half_pi);
    samples[static_cast<size_t>(n) * c + ch] = __fadd_rn(__fmul_rn(g1, o1), __fmul_rn(g2, o2));
  }
  if (n1 == kFrame) {
    new_swn[ch] = active ? static_cast<long long>((static_cast<uint64_t>(sw) + step1 * kFrame)
                                                  & kMask32) : sw;
    new_tone_phase[ch] = dual ? static_cast<long long>((static_cast<uint64_t>(tp) + step2 * kFrame)
                                                       & kMask32) : tp;
  }
}

dim3 grid(int c, int rows, int span) {
  return dim3((c + kThreads - 1) / kThreads, (rows + span - 1) / span);
}

}  // namespace

// Each entry launches its kernel on `stream` (a cudaStream_t) over c channels
// with `span` rows per thread, and returns cudaGetLastError(): 0 when the
// launch was accepted. c = 0 launches nothing.

extern "C" int mbe_comfort_noise(const void* limbs, const void* jump_a, const void* jump_b,
                                 float gain, int rows, void* samples, void* new_limbs, int c,
                                 int span, void* stream) {
  if (c <= 0) return 0;
  comfort_noise_kernel<<<grid(c, rows, span), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(limbs), static_cast<const long long*>(jump_a),
      static_cast<const long long*>(jump_b), gain, rows, span, static_cast<float*>(samples),
      static_cast<long long*>(new_limbs), c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbe_lcg_buffer(const void* seed, const void* prev_seed, const void* prime,
                              const void* lcg_a, const void* lcg_b, void* buffer, void* new_seed,
                              void* new_prev_seed, int c, int span, void* stream) {
  if (c <= 0) return 0;
  lcg_buffer_kernel<<<grid(c, kBuffer, span), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), static_cast<const float*>(prev_seed),
      static_cast<const float*>(prime), static_cast<const long long*>(lcg_a),
      static_cast<const long long*>(lcg_b), span, static_cast<float*>(buffer),
      static_cast<float*>(new_seed), static_cast<float*>(new_prev_seed), c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbe_tone_render(const void* tone_id, const void* amplitude_id, const void* swn,
                               const void* tone_phase, const void* step1, const void* step2,
                               const void* active, const void* dual, float soft_clip, float inv127,
                               float rad, float half_pi, void* samples, void* new_swn,
                               void* new_tone_phase, int c, int span, void* stream) {
  if (c <= 0) return 0;
  tone_render_kernel<<<grid(c, kFrame, span), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tone_id), static_cast<const int*>(amplitude_id),
      static_cast<const long long*>(swn), static_cast<const long long*>(tone_phase),
      static_cast<const long long*>(step1), static_cast<const long long*>(step2),
      static_cast<const bool*>(active), static_cast<const bool*>(dual), soft_clip, inv127, rad,
      half_pi, span, static_cast<float*>(samples), static_cast<long long*>(new_swn),
      static_cast<long long*>(new_tone_phase), c);
  return static_cast<int>(cudaGetLastError());
}
