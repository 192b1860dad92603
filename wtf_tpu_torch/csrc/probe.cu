// The availability probe: o[0] = i[0] + 1 in one thread.
//
// Replaces the inner `probe` kernel of wtf_tpu/interp/pstep.py
// fused_available (pstep.py:141-148), which tells the JAX package whether
// its build can launch a Pallas kernel.  Here it tells the port that the
// kernels of this repository built for this card and launch: pstep.py
// fused_available() returns True only when this returns 1, and
// `--fused-step on` raises otherwise.  It moves 8 bytes; its time is the
// launch latency.
//
// `empty_kernel` does nothing: its time is the launch floor, the least
// time any kernel launch takes on the card (the honest bound for the
// probe, whose 8 bytes take picoseconds at the memory rate).

#include <cstdint>
#include <cuda_runtime.h>

__global__ void probe_kernel(const int32_t* in, int32_t* out) {
  out[0] = in[0] + 1;
}

extern "C" int wtf_probe(const void* in, void* out, void* stream) {
  probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)in,
                                                  (int32_t*)out);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

extern "C" int wtf_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
