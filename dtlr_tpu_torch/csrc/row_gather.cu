// Dynamic row gather for Hopper (sm_90a). Port of the Pallas probe kernel
// `kernel` in main() of scripts/pallas_probe.py (the deformable sampler's
// per-query row gather):
//
//   out[q, c] = val[idx[q], c] * 2      val (S, C) f32, idx (Q,) int32 in [0, S)
//
// What bounds it on this card: at the probe's shapes (S=1024, C=64, Q=128)
// it moves 66,048 bytes (the 128 rows read, the indices, the output) and
// does 8,192 multiplies, 0.02 us at 3.35 TB/s; a launch costs microseconds,
// so the launch bounds it and nothing in the kernel moves that. The design
// is the plain one: one thread per output element, neighbouring threads on
// neighbouring columns of one row, so each warp reads 128 contiguous bytes
// of a gathered row and writes 128 contiguous bytes of the output.
// Indices are not clamped: an index outside [0, S) fails a device-side
// assert, as index_select's does, so the check costs the host nothing and
// never waits for the device. The assert traps the kernel and leaves the
// CUDA context unusable; the next synchronizing call reports it.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#undef NDEBUG
#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const float* __restrict__ val, const int* __restrict__ idx,
                  float* __restrict__ out, int S, int C, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const long long q = t / C;
  const int c = (int)(t - q * C);
  const int row = idx[q];
  assert(row >= 0 && row < S && "row_gather index out of range");
  out[t] = val[(long long)row * C + c] * 2.f;
}

}  // namespace

extern "C" int dtlr_row_gather(const void* val, const void* idx, void* out,
                               int S, int C, int Q, void* stream) {
  if (S < 1 || C < 1 || Q < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)Q * C;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  row_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)val, (const int*)idx, (float*)out, S, C, n);
  return (int)cudaGetLastError();
}
