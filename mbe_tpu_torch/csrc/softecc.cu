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
// What bounds it on this card: arithmetic. Every row meets every codeword: at
// C = 32768 one soft imbe7200 step is 131,072 Golay rows x 4,096 codewords and
// 98,304 Hamming rows x 2,048 codewords (~738M row-codeword pairs), against
// ~37 MB of int32 bits and reliabilities read and 0.9 MB of keys written.
//
// What the design does about it:
// - The product on the tensor cores (wgmma, bf16 in, FP32 accumulate). Both
//   shifts factor as key = v << s_diff | c with v = 32*score + 16*nomatch + diffs,
//   and v is affine in the codeword's bits, so one product per (row, codeword)
//   gives 64*v + (c % 64) less a row constant:
//     A[r] = [q_0..q_{n-1} | h_lo..h_{n-1} | 1 | 1 | 0...],  q_i = rel_i*(1 - 2*b_i),
//            h_j = b_j, zero-padded to K (48 Golay, 32 Hamming);
//     B[c] = [2048*cw_i | -128*cw_j (j >= lo) | 64*cwdsum(c) | c % 64 | 0...];
//     row constant 64*(32*sum_i rel_i*b_i + sum_{j>=lo} b_j + 16)   (nomatch = 1).
//   Every A and B value is exact in bf16 (|q| <= 255, powers of two, 64*k for
//   k <= 15, and c % 64 < 64), and every product and partial sum is an integer
//   below 2^24 in magnitude (at most 23*255*2048 + 12*128 + 768 + 63 =
//   12,013,887 for Golay), so FP32 accumulation is exact in any order. The
//   wrapper lays B out on the host in the byte order of the wgmma descriptor
//   (K-major, no swizzle: 8-codeword groups of 8x8 core matrices). Each thread
//   builds its own A fragments (registers) from the int32 inputs of the two rows
//   its accumulators hold.
// - One fminf per (row, codeword) on the CUDA cores. The low 6 bits carry the
//   codeword's place in its group of 64, so a float min over one group keeps
//   (v, c) in lexicographic order. In the m64n128 accumulator a thread holds, for
//   each of its two rows, 16 columns of each 64-column group, with distinct
//   c % 64: 15 fminf, then the int key once per group and an int min. Never a
//   float min across groups: their low bits do not order c.
// - The epilogue overlaps the next product: two accumulator sets; chunk j+1's
//   wgmma is in flight while chunk j's accumulator is reduced.
// - The codebook stays in shared memory. A block holds a slice of 2048
//   codewords (Golay: 2 slices of 192 KB; Hamming: the whole 128 KB codebook),
//   copied once per launch. One block per SM, two warpgroups each walking
//   their own 64-row tiles. Work items are (row tile, slice); slices of one row
//   merge by integer atomicMin into keys preset to 0x7f7f7f7f (above every key),
//   which is exact and the same in any order. A one-slice code stores directly.
//   (A block that copies and walks both slices in turn needs no preset and no
//   atomics, but copies the codebook twice: 1.8 us slower per Golay launch at
//   32768 rows on an H100, PERF.md.)
// - The matches-hard bit: the loop assumes nomatch = 1 everywhere; the hard
//   candidate's exact key (nomatch = 0) is computed per row in integers and
//   min-ed in, so the loop has no compare against idx_hard.
// - Any number of rows: rows past R get zero A rows and store nothing.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpgroups = 2;  // per block; each walks its own row tiles
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileRows = 64;   // wgmma M
constexpr int kN = 128;         // wgmma N: codewords per chunk
constexpr int kSlice = 2048;    // codewords a block holds in shared memory

template <int N_, int NCW_, int LO_, int SD_>
struct Code {
  static constexpr int N = N_, NCW = NCW_, LO = LO_, SD = SD_;
  static constexpr int D = N - LO;
  static constexpr int K = (N + D + 2 + 15) / 16 * 16;  // A/B columns, padded to k16
  static constexpr int KSTEPS = K / 16;
  static constexpr int NSLICES = NCW / kSlice;
  static constexpr int SLICE_BYTES = kSlice * K * 2;
  static_assert(NCW % kSlice == 0 && kSlice % kN == 0, "slices divide the codebook");
};
using Golay = Code<23, 4096, 11, 12>;
using Hamming = Code<15, 2048, 0, 11>;

// wgmma descriptor of a K-major operand with no swizzle (sm_90 matrix
// descriptor: start address, leading byte offset = stride between the two
// core matrices along K, stride byte offset = stride between 8-row groups;
// all in 16-byte units, 14 bits each; layout type 0).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Orders the compiler's reads and writes of the accumulator against the
// asynchronous wgmma: an empty volatile asm that claims to rewrite each register.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A * B for one k16 step: m64n128k16, A from registers, B by descriptor.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// One chunk of kN codewords: the K/16 steps into `d`, as one commit group.
template <class C>
__device__ __forceinline__ void mma_chunk(float (&d)[64], const uint32_t (&a)[C::KSTEPS][4],
                                            uint64_t desc) {
  fence_acc(d);
  wg_fence();
#pragma unroll
  for (int s = 0; s < C::KSTEPS; ++s) {
    wgmma_m64n128k16(d, a[s], desc + 16 * s, s > 0);  // + 256 B: the next two core matrices
  }
  wg_commit();
}

// The int key of one row's 16 accumulator columns of one 64-codeword group:
// a float min (the low 6 bits order c inside the group), then
// t = 64*v + (c % 64) with the row constant, exact.
template <int SD>
__device__ __forceinline__ int group_key(const float (&d)[64], int g, int rr, int rc, int cw) {
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = fminf(d[32 * g + 4 * j + 2 * rr], d[32 * g + 4 * j + 2 * rr + 1]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fminf(m[j], m[j + w]);
  }
  const int t = __float2int_rn(m[0]) + rc;
  return ((t >> 6) << SD) | (cw + (t & 63));
}

// Accumulator register i of m64n128: 8-column block i / 4, row r0 (i % 4 < 2)
// or r0 + 8, column 8*(i/4) + 2*(lane % 4) + (i % 2); so registers 32g..32g+31
// are the thread's columns of codeword group g (codewords cw0 + 64g ...).
template <class C>
__device__ __forceinline__ void reduce_chunk(const float (&d)[64], int cw0, const int (&rc)[2],
                                             int (&best)[2]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      best[rr] = min(best[rr], group_key<C::SD>(d, g, rr, rc[rr], cw0 + 64 * g));
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(int v) {  // exact: |v| <= 255
  return __float_as_uint(static_cast<float>(v)) >> 16;
}

// The A fragments of this thread's rows r0 and r0 + 8 (the wgmma register
// layout: register 2h + rr of k-step s holds columns 16s + 8h + 2*(lane % 4)
// + {0, 1} of row r0 + 8*rr, lower column in the low half), the row constants
// and the exact key of the hard candidate (INT_MAX if idx_hard is out of range).
// The four lanes of a quad own disjoint columns and sum the row terms by shuffles.
template <class C>
__device__ __forceinline__ void load_rows(const int* __restrict__ bits, const int* __restrict__ rel,
                                          const int* __restrict__ idx_hard,
                                          const int* __restrict__ packed, int r0, int R,
                                          uint32_t (&a)[C::KSTEPS][4], int (&rc)[2],
                                          int (&hard)[2]) {
  const int lq = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const bool valid = r < R;
    const int* brow = bits + static_cast<size_t>(r) * C::N;
    const int* wrow = rel + static_cast<size_t>(r) * C::N;
    int base = 0, hs = 0, bw = 0;
    int wk[C::KSTEPS][4];
#pragma unroll
    for (int s = 0; s < C::KSTEPS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 16 * s + 8 * h + 2 * lq + e;
          // column k: q_k (k < n), h (k < n + d), a one (k < n + d + 2), zero;
          // selects, not branches, so the warp stays converged for wgmma
          const bool is_q = valid && k < C::N;
          const bool is_h = valid && !is_q && k < C::N + C::D;
          const int b = is_q || is_h ? brow[is_q ? k : C::LO + k - C::N] : 0;
          const int w = is_q ? wrow[k] : 0;
          const int v = is_q ? w * (1 - 2 * b) : (is_h ? b : (valid && k < C::N + C::D + 2));
          base += w * b;
          hs += is_h ? b : 0;
          bw |= is_q ? (b & 1) << k : 0;
          wk[s][2 * h + e] = w;
          word |= bf16_bits(v) << (16 * e);
        }
        a[s][2 * h + rr] = word;
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      base += __shfl_xor_sync(0xffffffffu, base, x);
      hs += __shfl_xor_sync(0xffffffffu, hs, x);
      bw |= __shfl_xor_sync(0xffffffffu, bw, x);
    }
    rc[rr] = 64 * (32 * base + hs + 16);

    const int ih = valid ? idx_hard[r] : -1;
    const bool has = ih >= 0 && ih < C::NCW;
    const int mism = has ? bw ^ packed[ih] : 0;
    int score = 0;
#pragma unroll
    for (int s = 0; s < C::KSTEPS; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 16 * s + 8 * (j >> 1) + 2 * lq + (j & 1);
        if (k < C::N) score += wk[s][j] * ((mism >> k) & 1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) score += __shfl_xor_sync(0xffffffffu, score, x);
    hard[rr] = has ? ((32 * score + __popc(mism >> C::LO)) << C::SD) | ih : INT_MAX;
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
soft_decode_kernel(const int* __restrict__ bits, const int* __restrict__ rel,
                   const int* __restrict__ idx_hard, const int4* __restrict__ table,
                   const int* __restrict__ packed, int* __restrict__ key_out, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slice = blockIdx.x % C::NSLICES;
  const int blocks_per_slice = gridDim.x / C::NSLICES;

  // the block's codebook slice, already in descriptor byte order
  const int4* src = table + static_cast<size_t>(slice) * (C::SLICE_BYTES / 16);
  int4* dst = reinterpret_cast<int4*>(smem);
  for (int i = threadIdx.x; i < C::SLICE_BYTES / 16; i += kThreads) dst[i] = src[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // B of chunk 0: 8-codeword groups of 16*K bytes (SBO), core matrices along K 128 B apart (LBO)
  const uint64_t desc0 = smem_desc(smem_addr, 128, 16 * C::K);
  constexpr uint64_t kChunkStep = kN / 8 * C::K;  // one chunk, in 16-byte units
  constexpr int kChunks = kSlice / kN;
  const int cw_slice = slice * kSlice;

  // broadcast from lane 0, so the compiler knows the tile loop is warp-uniform
  // (a wgmma in a path it thinks divergent is serialized)
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0) % 4;
  const int lane = threadIdx.x % 32;
  const int tiles = (R + kTileRows - 1) / kTileRows;

#pragma unroll 1
  for (int tile = (blockIdx.x / C::NSLICES) * kWarpgroups + warpgroup; tile < tiles;
       tile += blocks_per_slice * kWarpgroups) {
    const int r0 = tile * kTileRows + 16 * warp + lane / 4;
    uint32_t a[C::KSTEPS][4];
    int rc[2], best[2];
    load_rows<C>(bits, rel, idx_hard, packed, r0, R, a, rc, best);
    __syncwarp();

    // chunk j+1's product is in flight while chunk j is reduced. Fully
    // unrolled: ptxas serializes every wgmma when a group is still pending
    // across a loop's back edge.
    float acc0[64], acc1[64];
    mma_chunk<C>(acc0, a, desc0);
#pragma unroll
    for (int j = 0; j < kChunks; j += 2) {
      mma_chunk<C>(acc1, a, desc0 + (j + 1) * kChunkStep);
      wg_wait<1>();
      fence_acc(acc0);
      reduce_chunk<C>(acc0, cw_slice + j * kN, rc, best);
      if (j + 2 < kChunks) {
        mma_chunk<C>(acc0, a, desc0 + (j + 2) * kChunkStep);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_acc(acc1);
      reduce_chunk<C>(acc1, cw_slice + (j + 1) * kN, rc, best);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      int b = best[rr];
      b = min(b, __shfl_xor_sync(0xffffffffu, b, 1));
      b = min(b, __shfl_xor_sync(0xffffffffu, b, 2));
      const int r = r0 + 8 * rr;
      if ((lane & 3) == rr && r < R) {
        if constexpr (C::NSLICES == 1) {
          key_out[r] = b;
        } else {
          atomicMin(key_out + r, b);
        }
      }
    }
  }
}

// Per device: its SM count, stored once both kernels' dynamic shared-memory
// limit is raised there (0: not yet).
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];

// The current device's SM count. The first call on a device also raises the
// kernels' shared-memory limit; later calls only read the stored count.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((*sms = g_sms[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(soft_decode_kernel<Golay>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Golay::SLICE_BYTES);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(soft_decode_kernel<Hamming>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Hamming::SLICE_BYTES);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) g_sms[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

template <class C>
int launch(const int* bits, const int* rel, const int* idx_hard, const void* table,
           const int* packed, int* key, int R, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err == cudaSuccess && C::NSLICES > 1) {
    err = cudaMemsetAsync(key, 0x7f, static_cast<size_t>(R) * sizeof(int), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (R + kTileRows - 1) / kTileRows;
  const int per_slice = min((sms + C::NSLICES - 1) / C::NSLICES,
                            (tiles + kWarpgroups - 1) / kWarpgroups);
  soft_decode_kernel<C><<<per_slice * C::NSLICES, kThreads, C::SLICE_BYTES, s>>>(
      bits, rel, idx_hard, static_cast<const int4*>(table), packed, key, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// code 0: Golay(23,12), rows of 23; code 1: Hamming(15,11), rows of 15 (the
// table and packed codewords pick the generator). `table` is the wrapper's
// bf16 B operand in descriptor byte order (ops/cuda/softecc.py:_kernel_tables).
// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when
// the launch was accepted.
extern "C" int mbe_soft_decode_keys(const int* bits, const int* rel, const int* idx_hard,
                                    const void* table, const int* packed, int* key, int R,
                                    int code, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code == 0) return launch<Golay>(bits, rel, idx_hard, table, packed, key, R, s);
  if (code == 1) return launch<Hamming>(bits, rel, idx_hard, table, packed, key, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the Golay kernel at its launch shape (for the A/B tool).
extern "C" int mbe_soft_decode_keys_blocks_per_sm() {
  int sms = 0, n = 0;
  if (device_sms(&sms) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, soft_decode_kernel<Golay>, kThreads,
                                                    Golay::SLICE_BYTES) != cudaSuccess) {
    return -1;
  }
  return n;
}
