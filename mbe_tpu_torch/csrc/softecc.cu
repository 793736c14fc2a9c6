// Soft-decision maximum-likelihood decode of Golay(23,12) and Hamming(15,11)
// blocks for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel mbe_tpu/ops/pallas/softecc.py:_soft_decode_pallas
// (entries golay2312_soft_keys and hamming1511_soft_keys). For every row r, with
// hard bits b[r][i], reliabilities rel[r][i] in 0..255 and the codeword index of
// the row's hard decode idx_hard[r], it writes the smallest key over all codewords:
//
//   key(c) = (score << s_score) | ((c != idx_hard) << s_match) | (diffs << s_diff) | c
//   score  = sum_i rel_i * [b_i != cw_i],   diffs = popcount(b ^ cw) over bits data_lo..n-1
//
// Golay: n = 23, data_lo = 11, shifts 17/16/12, 4096 codewords. Hamming: n = 15,
// data_lo = 0, shifts 16/15/11, 2048 codewords. The key is the reference's
// tie-break (ecc.c:54-67): score, then matches-hard, then diffs, then index.
//
// What bounds it on this card: arithmetic. Every row meets every codeword:
// at C = 32768 one soft imbe7200 step is 131,072 Golay rows x 4,096 codewords
// and 98,304 Hamming rows x 2,048 codewords (~738M row-codeword pairs), against
// ~37 MB of int32 bits and reliabilities read and 0.9 MB of keys written.
//
// What the design does about it:
// - Both shifts factor the same way: key = v << s_diff | c with
//   v = 32*score + 16*nomatch + diffs (< 2^18). v is affine in the codeword's
//   bits, so one dot product per (row, codeword) gives it:
//     64*v + (c % 64) = C_r + sum_i a_ri * cw_i + (64*cwdsum(c) + c % 64),
//     a_ri = 64*(32*rel_i*(1 - 2*b_i) - 2*b_i*[i >= data_lo]),
//     C_r  = 64*(32*sum_i rel_i*b_i + sum_{i>=data_lo} b_i + 16)   (nomatch = 1).
//   Every term and partial sum is an integer below 2^24 in magnitude, so FP32
//   FMAs are exact, and the low 6 bits carry the codeword's place in its tile
//   of 64: one fminf per codeword keeps (v, c) in lexicographic order, and the
//   int key is formed once per tile. n + 1 FMAs and one min per pair.
// - The codebook, as n + 1 floats per codeword (bits, then 64*cwdsum + c % 64),
//   is staged through shared memory in chunks of 256 codewords; every thread
//   reads the same codeword at once (a broadcast), and each read feeds the dot
//   products of kRows rows held by the thread.
// - The matches-hard bit: the loop assumes nomatch = 1 everywhere; the hard
//   candidate's exact key (nomatch = 0) is computed once per row in integers and
//   min-ed in at the end, so the loop has no compare against idx_hard.
// - Integer-valued FP32 on the CUDA cores only. The same product, with
//   operands <= 255, products <= 8160 and sums < 2^18, is exact in bf16 with
//   FP32 accumulation, so a later kernel can put it on wgmma.
// - Any number of rows: the tail of the last block is masked.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRows = 2;     // rows per thread
constexpr int kChunk = 256;  // codewords per shared-memory chunk
constexpr int kTile = 64;    // codewords per fminf run: 64*v + (c % 64) < 2^24

template <int N, int NCW, int DATA_LO, int SHIFT_DIFF>
__global__ void __launch_bounds__(kThreads)
soft_decode_kernel(const int* __restrict__ bits, const int* __restrict__ rel,
                   const int* __restrict__ idx_hard, const float* __restrict__ table,
                   const int* __restrict__ packed, int* __restrict__ key_out, int R) {
  constexpr int NP = N + 1;  // floats per codeword: n bits, then the constant
  static_assert(NP % 4 == 0, "codeword rows are read as float4");
  static_assert(NCW % kChunk == 0 && kChunk % kTile == 0, "tiles divide the codebook");
  __shared__ float4 tab[kChunk * NP / 4];

  float coef[kRows][NP];
  int row_const[kRows], bword[kRows], best[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = (blockIdx.x * kRows + k) * kThreads + threadIdx.x;
    const bool valid = r < R;
    int base = 0, hsum = 0, bw = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const size_t at = static_cast<size_t>(r) * N + i;
      const int b = valid ? bits[at] : 0;
      const int w = valid ? rel[at] : 0;
      const int h = i >= DATA_LO ? b : 0;
      coef[k][i] = static_cast<float>(64 * (32 * w * (1 - 2 * b) - 2 * h));
      base += w * b;
      hsum += h;
      bw |= (b & 1) << i;
    }
    coef[k][N] = 1.0f;
    row_const[k] = 64 * (32 * base + hsum + 16);
    bword[k] = bw;
    best[k] = INT_MAX;
  }

  const float4* src = reinterpret_cast<const float4*>(table);
#pragma unroll 1
  for (int chunk = 0; chunk < NCW; chunk += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * NP / 4; i += kThreads) {
      tab[i] = src[chunk * (NP / 4) + i];
    }
    __syncthreads();
#pragma unroll 1
    for (int tile = 0; tile < kChunk; tile += kTile) {
      float m[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) m[k] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 2
      for (int j = 0; j < kTile; ++j) {
        float cw[NP];
#pragma unroll
        for (int q = 0; q < NP / 4; ++q) {
          const float4 v = tab[(tile + j) * (NP / 4) + q];
          cw[4 * q] = v.x;
          cw[4 * q + 1] = v.y;
          cw[4 * q + 2] = v.z;
          cw[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          float d = 0.0f;
#pragma unroll
          for (int i = 0; i < NP; ++i) d = fmaf(coef[k][i], cw[i], d);
          m[k] = fminf(m[k], d);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int t = __float2int_rn(m[k]) + row_const[k];  // 64*v + (c % 64), exact
        best[k] = min(best[k], ((t >> 6) << SHIFT_DIFF) | (chunk + tile + (t & 63)));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = (blockIdx.x * kRows + k) * kThreads + threadIdx.x;
    if (r >= R) continue;
    const int ih = idx_hard[r];
    int key = best[k];
    if (ih >= 0 && ih < NCW) {  // the hard candidate, with nomatch = 0
      const int mism = bword[k] ^ packed[ih];
      int score = 0;
      for (int i = 0; i < N; ++i) {
        if ((mism >> i) & 1) score += rel[static_cast<size_t>(r) * N + i];
      }
      const int diffs = __popc(mism >> DATA_LO);
      key = min(key, ((32 * score + diffs) << SHIFT_DIFF) | ih);
    }
    key_out[r] = key;
  }
}

}  // namespace

// code 0: Golay(23,12), rows of 23; code 1: Hamming(15,11), rows of 15 (the
// table and packed codewords pick the generator). Launches on `stream` (a
// cudaStream_t) and returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int mbe_soft_decode_keys(const int* bits, const int* rel, const int* idx_hard,
                                    const float* table, const int* packed, int* key,
                                    int R, int code, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((R + kThreads * kRows - 1) / (kThreads * kRows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code == 0) {
    soft_decode_kernel<23, 4096, 11, 12><<<grid, kThreads, 0, s>>>(
        bits, rel, idx_hard, table, packed, key, R);
  } else if (code == 1) {
    soft_decode_kernel<15, 2048, 0, 11><<<grid, kThreads, 0, s>>>(
        bits, rel, idx_hard, table, packed, key, R);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
