// Lane select of the FSM's state for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces no TPU kernel: the reference commits every frame-type branch of its
// process FSMs with lane-wise selects that XLA fuses, and the port did them
// with plain PyTorch (models/state.py select_many_reference): per leaf and case
// a broadcast torch.where that reads both its sides in full and writes the
// whole leaf, and the default, headroom and erasure parameter sets built as
// [57, C] and [128, C] tensors only for a where to read the constants back.
//
// One launch writes up to three outputs of up to 21 leaves each ([C], [57, C]
// or [128, C]; float32, int32, or int64 holding uint32), each output a
// first-match-wins select over up to three cases and a default:
//   - per lane, the index of the first case whose [C] bool mask is set (else
//     the default's) is found once per output and kept in registers, two bits
//     an output;
//   - each leaf of each output is then written once, reading only the lane's
//     chosen source. A constant leaf is written from its immediate. A case
//     that is an earlier output of the same launch resolves, per lane, to the
//     source that output chose there: an output is never read back.
// A select copies bits, so every output equals the plain form's bit for bit.
//
// What bounds it on this card: bytes. Each output leaf is written once and
// one source read per lane (nothing for a constant). At C = 32768 an AMBE
// step's prepare, case and commit launches move about 0.8 GB, 0.24 ms at
// 3.35 TB/s (0.9 GB and 0.27 ms with its speech-path select); an IMBE step's
// one launch about 115 MB, 0.034 ms.
// Design: a thread takes 4 consecutive channels (16-byte accesses, when C % 4
// == 0 and every pointer is 16-byte aligned; else 1 channel) of `span`
// consecutive rows of the flattened (output, leaf, row) space (blockIdx.y),
// so a warp moves 512 contiguous bytes of a row and enough blocks are in
// flight to keep the memory busy. Where a thread's 4 lanes chose one source, a
// row is one vector load (or the constant) and one vector store; else each
// lane loads its own word and the row is still one vector store. The
// arguments (pointers, constants, the case and segment tables) go by value in
// one __grid_constant__ struct under 4 KB, so a CUDA graph captures them with
// the launch and no device table is built from host data. Any C, the ragged
// block masked.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOutputs = 3;
constexpr int kMaxCases = 3;
constexpr int kSources = kMaxCases + 1;  // the cases in order, then the default
constexpr int kMaxLeaves = 21;
constexpr int kMaxSegments = kMaxOutputs * kMaxLeaves;
// a source's kind (0: a tensor)
constexpr unsigned char kConstant = 1;
constexpr unsigned char kOutput = 2;

// The launch's arguments (ops/cuda/select.py `Args` mirrors this layout, and
// checks it against mbe_lane_select_layout). src[o][j][k]: by kind[o][j][k],
// a pointer to source j's leaf k, a constant's bits (a float32's bits or an
// int32 sign-extended, or an int64), or the index of an earlier output whose
// choice on the lane stands in. out[o][k] is null for a leaf not written.
// Segment s is leaf seg_leaf[s] of output seg_out[s], rows seg_start[s] ..
// seg_start[s + 1] of the flattened space of `rows` rows.
struct Args {
  long long src[kMaxOutputs][kSources][kMaxLeaves];
  void* out[kMaxOutputs][kMaxLeaves];
  const void* mask[kMaxOutputs][kMaxCases];
  unsigned char kind[kMaxOutputs][kSources][kMaxLeaves];
  int n_cases[kMaxOutputs];
  int leaf_bytes[kMaxLeaves];
  int seg_start[kMaxSegments + 1];
  unsigned char seg_out[kMaxSegments];
  unsigned char seg_leaf[kMaxSegments];
  int n_outputs;
  int n_segments;
  int rows;
  int c;
  int span;
};
static_assert(sizeof(Args) <= 4096, "a kernel's parameters are limited to 4 KB");

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

// pick[v]: two bits per output o, the source lane lane0 + v takes there
template <int V>
__device__ __forceinline__ void pick_sources(const Args& a, int lane0, uint32_t (&pick)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) pick[v] = 0;
  for (int o = 0; o < a.n_outputs; ++o) {
    uint32_t j[V];
#pragma unroll
    for (int v = 0; v < V; ++v) j[v] = a.n_cases[o];
    for (int q = a.n_cases[o] - 1; q >= 0; --q) {  // the first set mask wins
      const auto* m = static_cast<const Vec<unsigned char, V>*>(a.mask[o][q]) + lane0 / V;
      const Vec<unsigned char, V> set = *m;
#pragma unroll
      for (int v = 0; v < V; ++v) j[v] = set.x[v] ? q : j[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) pick[v] |= j[v] << (2 * o);
  }
}

// the source of output o's leaf k on a lane with choices `pick`: a tensor's
// pointer or a constant's bits, through earlier outputs' choices
__device__ __forceinline__ void resolve(const Args& a, int o, int k, uint32_t pick,
                                        unsigned char& kind, long long& bits) {
  int j = (pick >> (2 * o)) & 3;
  kind = a.kind[o][j][k];
  bits = a.src[o][j][k];
  while (kind == kOutput) {  // an earlier output: its choice on this lane
    o = static_cast<int>(bits);
    j = (pick >> (2 * o)) & 3;
    kind = a.kind[o][j][k];
    bits = a.src[o][j][k];
  }
}

// rows r0 .. r1 of one leaf, lanes lane0 .. lane0 + V - 1, each from its source
template <typename T, int V>
__device__ __forceinline__ void copy_rows(T* out, const unsigned char (&kind)[V],
                                          const long long (&bits)[V], int r0, int r1, int lane0,
                                          size_t c) {
  using W = Vec<T, V>;
  bool uniform = true;
#pragma unroll
  for (int v = 1; v < V; ++v) uniform = uniform && kind[v] == kind[0] && bits[v] == bits[0];
  if (uniform && kind[0] == kConstant) {
    W val;
#pragma unroll
    for (int v = 0; v < V; ++v) val.x[v] = static_cast<T>(bits[0]);
    for (int r = r0; r < r1; ++r) *reinterpret_cast<W*>(out + r * c + lane0) = val;
  } else if (uniform) {
    const T* src = reinterpret_cast<const T*>(bits[0]);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      *reinterpret_cast<W*>(out + r * c + lane0) =
          *reinterpret_cast<const W*>(src + r * c + lane0);
    }
  } else {
#pragma unroll 2
    for (int r = r0; r < r1; ++r) {
      W val;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        val.x[v] = kind[v] == kConstant ? static_cast<T>(bits[v])
                                        : reinterpret_cast<const T*>(bits[v])[r * c + lane0 + v];
      }
      *reinterpret_cast<W*>(out + r * c + lane0) = val;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
lane_select_kernel(const __grid_constant__ Args a) {
  const int lane0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (lane0 >= a.c) return;
  uint32_t pick[V];
  pick_sources<V>(a, lane0, pick);
  const int g0 = blockIdx.y * a.span;
  const int g1 = min(g0 + a.span, a.rows);
  for (int s = 0; s < a.n_segments; ++s) {
    const int s0 = a.seg_start[s];
    const int s1 = a.seg_start[s + 1];
    if (s1 <= g0) continue;
    if (s0 >= g1) break;
    const int o = a.seg_out[s];
    const int k = a.seg_leaf[s];
    unsigned char kind[V];
    long long bits[V];
#pragma unroll
    for (int v = 0; v < V; ++v) resolve(a, o, k, pick[v], kind[v], bits[v]);
    const int r0 = max(g0, s0) - s0;
    const int r1 = min(g1, s1) - s0;
    if (a.leaf_bytes[k] == 4) {
      copy_rows<uint32_t, V>(static_cast<uint32_t*>(a.out[o][k]), kind, bits, r0, r1, lane0,
                             a.c);
    } else {
      copy_rows<unsigned long long, V>(static_cast<unsigned long long*>(a.out[o][k]), kind,
                                       bits, r0, r1, lane0, a.c);
    }
  }
}

}  // namespace

// Launches the select described by `args` (a host `Args`, copied into the
// launch) on `stream` (a cudaStream_t): 4 channels a thread when `vec`, else
// 1. Returns cudaGetLastError(): 0 when the launch was accepted. Nothing to
// write (c or rows 0) launches nothing.
extern "C" int mbe_lane_select(const void* args, int vec, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.c <= 0 || a.rows <= 0) return 0;
  const int lanes = kThreads * (vec ? 4 : 1);
  const dim3 grid((a.c + lanes - 1) / lanes, (a.rows + a.span - 1) / a.span);
  if (vec) {
    lane_select_kernel<4><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    lane_select_kernel<1><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: sizeof(Args), then the offset of each field in order. Returns the count.
extern "C" int mbe_lane_select_layout(long long* out) {
  int n = 0;
  out[n++] = sizeof(Args);
  out[n++] = offsetof(Args, src);
  out[n++] = offsetof(Args, out);
  out[n++] = offsetof(Args, mask);
  out[n++] = offsetof(Args, kind);
  out[n++] = offsetof(Args, n_cases);
  out[n++] = offsetof(Args, leaf_bytes);
  out[n++] = offsetof(Args, seg_start);
  out[n++] = offsetof(Args, seg_out);
  out[n++] = offsetof(Args, seg_leaf);
  out[n++] = offsetof(Args, n_outputs);
  out[n++] = offsetof(Args, n_segments);
  out[n++] = offsetof(Args, rows);
  out[n++] = offsetof(Args, c);
  out[n++] = offsetof(Args, span);
  return n;
}
