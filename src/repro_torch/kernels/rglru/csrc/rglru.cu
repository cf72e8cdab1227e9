// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over the time axis of (B, T, D) fp32, with h_{-1} = 0.
//
// Replaces the TPU kernel rglru_scan_kernel of
// src/repro/kernels/rglru/kernel.py (body _rglru_kernel), the recurrentgemma
// prefill hot loop: the reference carries h across time blocks in VMEM
// scratch and runs a fori_loop over the rows of each block. Here blocks run
// in parallel and in no order, so nothing is carried between them: one
// thread owns one (b, d) channel and keeps h in a register for the whole T
// loop.
//
// Bound on the H100: bytes. Each element is read twice (a, b) and written
// once, 12 bytes against 2 operations, far below the ~20 fp32 operations
// per byte where the CUDA cores would be the limit. What the design does
// about it:
//   * neighbouring threads own neighbouring d, so every load and store of a
//     warp is one coalesced 128-byte row segment;
//   * the T loop is unrolled by kUnroll: the loads of kUnroll steps are
//     issued before the dependent chain of updates that consumes them, so
//     each thread keeps 2 * kUnroll loads in flight;
//   * 64-thread blocks spread the B * D channels over as many SMs as
//     possible.
// At the serving shape (B 8, D 2560) there are only 20,480 channels, fewer
// loads in flight than the memory system needs to reach its full rate; the
// time axis stays sequential by design (a chunked scan across blocks is
// later work).
//
// The update is a rounded multiply, then a rounded add (no fused
// multiply-add), which is the plain version's arithmetic: the kernel and a
// sequential loop in PyTorch agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = static_cast<long long>(blockIdx.y) * T * D + d;
  float state = 0.f;
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + static_cast<long long>(t0 + u) * D;
      const bool in = t0 + u < T;
      av[u] = in ? a[off] : 0.f;
      bv[u] = in ? b[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T) {
        state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
        h[base + static_cast<long long>(t0 + u) * D] = state;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b, h contiguous (B, T, D) fp32; h is written whole.
int repro_rglru_scan(const void* a, const void* b, void* h, int B, int T,
                     int D, void* stream) {
  if (B == 0 || T == 0 || D == 0) return cudaSuccess;
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), T, D);
  return cudaGetLastError();
}

}  // extern "C"
