// Region marks for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel. A CUDA graph carries no ranges, so a device trace
// of a graphed step is one flat run of ~1,400 nodes. A mark is an empty
// kernel with the region's name, launched <<<1, 1>>> on the step's stream
// in program order, captured into the graph like any other launch: in a
// device trace every op after mbe_region_<r> and before the next mark
// belongs to region r. mbe_region_end closes the step; what follows it
// (the stream's copies, a sequence's per-frame copies) is outside the step.
//
// What bounds it on this card: nothing but the launch itself, one node of
// a graph (~1-2 us of device time); 5 to 7 marks per step.

#include <cuda_runtime.h>

extern "C" __global__ void mbe_region_bit_domain() {}
extern "C" __global__ void mbe_region_fsm() {}
extern "C" __global__ void mbe_region_synthesis() {}
extern "C" __global__ void mbe_region_commit() {}
extern "C" __global__ void mbe_region_end() {}

// Launches region `region`'s mark (0 bit_domain, 1 fsm, 2 synthesis,
// 3 commit, 4 end) on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int mbe_region_mark(int region, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (region) {
    case 0: mbe_region_bit_domain<<<1, 1, 0, s>>>(); break;
    case 1: mbe_region_fsm<<<1, 1, 0, s>>>(); break;
    case 2: mbe_region_synthesis<<<1, 1, 0, s>>>(); break;
    case 3: mbe_region_commit<<<1, 1, 0, s>>>(); break;
    case 4: mbe_region_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
