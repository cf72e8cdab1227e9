// Block-scaled int8 matmul for Hopper (sm_90a): the Proteus arithmetic
// engine. out (M, N) fp32 = x (M, K) fp32 or bf16 @ codes (K, N) int8,
// where column n of k-block kb carries the fp32 scale scales[kb, n].
//
// Replaces the TPU kernel quant_matmul_kernel of
// src/repro/kernels/quant_matmul/kernel.py (body _qmm_kernel), with its
// arithmetic order: per k-block an fp32 partial product of x and the raw
// codes (x widened to fp32 on load, codes widened to fp32), then
// acc += partial * scale[kb, n]. The scale multiplies the partial, not each
// code, so the kernel stays within summation-order noise of the reference.
// The TPU kernel walks k-blocks as a sequential grid axis with the
// accumulator in VMEM scratch; here one block owns a 64 x 64 output tile and
// loops over all of K itself, the accumulator in registers.
//
// Bound on the H100: operations at prefill shapes (M 4096: ~20 fp32 FMA per
// byte of codes), bytes at decode shapes (M 8: every code is read for 8
// rows). This first kernel runs on the CUDA cores in fp32, as the reference
// computes:
//   * a 64 x 64 output tile per block of 256 threads, each thread a 4 x 4
//     register micro-tile (16 fp32 FMA per shared-memory row step);
//   * x and code tiles of depth 32 staged in shared memory, codes widened
//     to fp32 as they are stored; x rows padded to 33 floats so the
//     transposing reads do not collide on a bank;
//   * loads coalesced along K (x) and along N (codes); M, N and the end of
//     a k-block are guarded, so any block_k that divides K works.
// Tensor cores (wgmma on bf16 or int8 operands) and TMA are later work: they
// change the numerics and the tolerance against the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kKT = 32;
constexpr int kThreads = 256;   // 16 x 16, a 4 x 4 micro-tile each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int M, int N, int K, int bk) {
  __shared__ float xs[kBM][kKT + 1];
  __shared__ __align__(16) float ws[kKT][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int xr = tid / kKT, xk = tid % kKT;     // x tile loader
  const int wk = tid / kBN, wn = tid % kBN;     // code tile loader
  float acc[4][4] = {};
  for (int kb0 = 0; kb0 < K; kb0 += bk) {
    const int kb1 = kb0 + bk;
    float part[4][4] = {};
    for (int k0 = kb0; k0 < kb1; k0 += kKT) {
#pragma unroll
      for (int i = 0; i < kBM / (kThreads / kKT); ++i) {
        const int r = xr + i * (kThreads / kKT), k = k0 + xk;
        xs[r][xk] = (m0 + r < M && k < kb1)
            ? widen(x[static_cast<long long>(m0 + r) * K + k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kKT / (kThreads / kBN); ++i) {
        const int kk = wk + i * (kThreads / kBN), k = k0 + kk;
        ws[kk][wn] = (n0 + wn < N && k < kb1)
            ? static_cast<float>(codes[static_cast<long long>(k) * N + n0 + wn])
            : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[i][0] = fmaf(a[i], b.x, part[i][0]);
          part[i][1] = fmaf(a[i], b.y, part[i][1]);
          part[i][2] = fmaf(a[i], b.z, part[i][2]);
          part[i][3] = fmaf(a[i], b.w, part[i][3]);
        }
      }
      __syncthreads();
    }
    const float* srow = scales + static_cast<long long>(kb0 / bk) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      const float s = n < N ? srow[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += part[i][j] * s;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) fp32 (x_bf16 = 0) or bf16 (1), codes (K, N) int8, scales
// (K / bk, N) fp32, out (M, N) fp32; all contiguous, K % bk == 0.
int repro_quant_matmul(const void* x, const void* codes, const void* scales,
                       void* out, int M, int N, int K, int bk, int x_bf16,
                       void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int8_t*>(codes);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
  if (x_bf16)
    quant_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), c, sc, o, M, N, K, bk);
  else
    quant_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), c, sc, o, M, N, K, bk);
  return cudaGetLastError();
}

}  // extern "C"
