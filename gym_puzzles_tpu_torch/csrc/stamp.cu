// The device stamp of a traced span (gym_puzzles_tpu_torch/utils/profiling.py).
//
// Replaces no TPU kernel: the JAX package has no span tracing on the device.
// One thread takes the next slot of a ring in device memory with an atomic
// and writes (code, %globaltimer) there: the span's site and edge, and the
// card's nanosecond clock when the stream reached the stamp.  Launched on the
// caller's stream, so a stamp captured into a CUDA graph runs at every replay
// and keeps each replay's time; the ring is read back once, when the spans
// are written out.  A slot past the ring's end is counted and not written.
// Bound by its launch (one thread, 24 bytes), ~2-3 us in a graph.

#include <cuda_runtime.h>

__global__ void gpt_stamp_kernel(unsigned long long* ring, unsigned long long* count,
                                 unsigned long long capacity, long long code) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(count, 1ULL);
  if (slot < capacity) {
    ring[2 * slot] = (unsigned long long)code;
    ring[2 * slot + 1] = now;
  }
}

extern "C" int gpt_stamp(void* ring, void* count, unsigned long long capacity, long long code,
                         void* stream) {
  gpt_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, (unsigned long long*)count, capacity, code);
  return (int)cudaGetLastError();
}
