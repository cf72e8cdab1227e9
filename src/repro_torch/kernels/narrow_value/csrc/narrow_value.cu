// Narrow-value detection and int4 nibble packing for Hopper (sm_90a): the
// Proteus runtime's dynamic bit-precision engine and its int4 wire format.
//
// Replaces three TPU kernels of src/repro/kernels/narrow_value/kernel.py:
//   * required_bits_kernel (body _bits_kernel): per block of int32, the
//     width the reference's fp32 formula ceil(log2(float(max|x|) + 1)) + 1
//     gives (1 for an all-zero block);
//   * pack_int4_kernel (_pack4_kernel): int8 codes, the even element into
//     the low nibble and the odd one into the high nibble of one byte;
//   * unpack_int4_kernel (_unpack4_kernel): the inverse, sign-extended.
// The TPU grid walks one block per step; here every block is independent.
//
// Bound on the H100: bytes. Each kernel reads its input once and writes its
// output once with a handful of integer operations per byte, so 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses,
// are the whole design:
//   * required_bits: one warp per block; a lane loads 16 bytes at a time
//     (blocks whose length is a multiple of 4 on a 16-byte aligned base;
//     4-byte loads otherwise), the warp reduces max |x| with one
//     __reduce_max_sync, and lane 0 writes the width;
//   * pack_int4: a thread turns 16 codes (one 16-byte load) into 8 bytes;
//   * unpack_int4: a thread turns 8 packed bytes into 16 codes (one 16-byte
//     store).
// Tails shorter than a vector, and bases that are not 16-byte aligned, take
// a scalar path in the same launch.
//
// The width is an integer function of m = float(max|x|). The reference's
// rounded log2 comes out one short just above 2^k for k >= 21, in windows
// that depend on the log2 evaluating it; kShort[k] holds the reference's
// windows (repro_torch/kernels/narrow_value/ref.py REFERENCE_SHORT), so the
// kernel computes no log2 and equals the plain version on every input.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// k -> largest m - 2^k that the reference gives k + 1 bits, -1 = none
__constant__ int kShort[32] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, 1, 1, 7, 16, 48, 0, 64, 256, 768, 0, 0};

__device__ __forceinline__ unsigned magnitude(int v) {
  // |v| as unsigned, exact for INT32_MIN
  return v < 0 ? 0u - static_cast<unsigned>(v) : static_cast<unsigned>(v);
}

__device__ __forceinline__ int width_of(unsigned umax) {
  // float(max|x|) == max float(|x|): rounding to nearest is monotone and
  // symmetric. The float is an integer <= 2^31, so it converts back exactly.
  const unsigned m = __float2uint_rn(__uint2float_rn(umax));
  if (m == 0) return 1;
  const int k = 31 - __clz(m);
  const int over = static_cast<int>(m - (1u << k));
  return over <= kShort[k] ? k + 1 : k + 2;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
required_bits_kernel(const int* __restrict__ x, int* __restrict__ out,
                     long long n_blocks, int block) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= n_blocks) return;
  const int* row = x + b * block;
  unsigned umax = 0;
  if (kVec) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (int i = lane; i < block / 4; i += 32) {
      const int4 v = __ldg(row4 + i);
      umax = max(umax, max(max(magnitude(v.x), magnitude(v.y)),
                           max(magnitude(v.z), magnitude(v.w))));
    }
  } else {
    for (int i = lane; i < block; i += 32) umax = max(umax, magnitude(row[i]));
  }
  umax = __reduce_max_sync(0xffffffffu, umax);
  if (lane == 0) out[b] = width_of(umax);
}

__device__ __forceinline__ unsigned pack_word(unsigned w) {
  // bytes c0 c1 c2 c3 -> 16 bits (c0 & 15 | c1 << 4), (c2 & 15 | c3 << 4)
  const unsigned t = (w & 0x000F000Fu) | ((w >> 4) & 0x00F000F0u);
  return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

// v: n int8 codes (n even); p: n / 2 bytes. Thread i owns codes
// [16 i, 16 i + 16).
__global__ void __launch_bounds__(kThreads)
pack_int4_kernel(const int8_t* __restrict__ v, int8_t* __restrict__ p,
                 long long n, int aligned) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lo = i * 16;
  if (lo >= n) return;
  if (aligned && lo + 16 <= n) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(v + lo));
    uint2 o;
    o.x = pack_word(w.x) | (pack_word(w.y) << 16);
    o.y = pack_word(w.z) | (pack_word(w.w) << 16);
    *reinterpret_cast<uint2*>(p + lo / 2) = o;
    return;
  }
  const long long hi = lo + 16 < n ? lo + 16 : n;
  for (long long j = lo; j < hi; j += 2) {
    const unsigned c = (static_cast<unsigned>(static_cast<uint8_t>(v[j])) & 15u)
        | ((static_cast<unsigned>(static_cast<uint8_t>(v[j + 1])) & 15u) << 4);
    p[j / 2] = static_cast<int8_t>(c);
  }
}

__device__ __forceinline__ unsigned sext_nibble(unsigned u) {
  // nibble 0..15 -> the byte of its int8 value in [-8, 7]
  return ((u ^ 8u) - 8u) & 0xFFu;
}

__device__ __forceinline__ uint2 unpack_word(unsigned w) {
  // 4 packed bytes -> 8 codes: byte j gives codes 2j (low) and 2j + 1 (high)
  uint2 o;
  o.x = sext_nibble(w & 15u) | (sext_nibble((w >> 4) & 15u) << 8)
      | (sext_nibble((w >> 8) & 15u) << 16) | (sext_nibble((w >> 12) & 15u) << 24);
  o.y = sext_nibble((w >> 16) & 15u) | (sext_nibble((w >> 20) & 15u) << 8)
      | (sext_nibble((w >> 24) & 15u) << 16) | (sext_nibble((w >> 28) & 15u) << 24);
  return o;
}

// p: n packed bytes; v: 2 n codes. Thread i owns bytes [8 i, 8 i + 8).
__global__ void __launch_bounds__(kThreads)
unpack_int4_kernel(const int8_t* __restrict__ p, int8_t* __restrict__ v,
                   long long n, int aligned) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lo = i * 8;
  if (lo >= n) return;
  if (aligned && lo + 8 <= n) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p + lo));
    const uint2 a = unpack_word(w.x), b = unpack_word(w.y);
    *reinterpret_cast<uint4*>(v + 2 * lo) = make_uint4(a.x, a.y, b.x, b.y);
    return;
  }
  const long long hi = lo + 8 < n ? lo + 8 : n;
  for (long long j = lo; j < hi; ++j) {
    const unsigned u = static_cast<uint8_t>(p[j]);
    v[2 * j] = static_cast<int8_t>(sext_nibble(u & 15u));
    v[2 * j + 1] = static_cast<int8_t>(sext_nibble(u >> 4));
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n_blocks * block int32; out: n_blocks int32. vec: x is 16-byte aligned
// and block % 4 == 0.
int repro_required_bits(const void* x, void* out, long long n_blocks,
                        int block, int vec, void* stream) {
  if (n_blocks == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(ceil_div(n_blocks, kWarps));
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    required_bits_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(x), static_cast<int*>(out), n_blocks, block);
  else
    required_bits_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(x), static_cast<int*>(out), n_blocks, block);
  return cudaGetLastError();
}

// v: n int8 (n even) -> p: n / 2 int8. aligned: both bases 16-byte aligned.
int repro_pack_int4(const void* v, void* p, long long n, int aligned,
                    void* stream) {
  if (n == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(ceil_div(ceil_div(n, 16), kThreads));
  pack_int4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(v), static_cast<int8_t*>(p), n, aligned);
  return cudaGetLastError();
}

// p: n int8 -> v: 2 n int8. aligned: both bases 16-byte aligned.
int repro_unpack_int4(const void* p, void* v, long long n, int aligned,
                      void* stream) {
  if (n == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(ceil_div(ceil_div(n, 8), kThreads));
  unpack_int4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(p), static_cast<int8_t*>(v), n, aligned);
  return cudaGetLastError();
}

}  // extern "C"
