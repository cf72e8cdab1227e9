// Block-scaled int8 matmul for Hopper (sm_90a) on the tensor cores: the
// Proteus arithmetic engine. out (M, N) fp32 = x (M, K) fp32 or bf16 @
// codes (K, N) int8, where column n of k-block kb carries the fp32 scale
// scales[kb, n].
//
// Replaces the TPU kernel quant_matmul_kernel of
// src/repro/kernels/quant_matmul/kernel.py (body _qmm_kernel), with its
// arithmetic order: per k-block of bk rows a fresh fp32 partial product of
// x and the raw codes, then acc += partial * scales[kb, n] (a rounded
// multiply, then a rounded add). The TPU kernel walks k-blocks as a
// sequential grid axis with the accumulator in VMEM scratch; here a block
// loops over its k-blocks itself, partial and acc in registers.
//
// Numerics: the products run on bf16 operands with fp32 accumulation
// (wgmma), and are exact:
//   * every int8 code is exact in bf16 (8 significant bits);
//   * an fp32 x splits exactly into three bf16 parts, hi = bf16(x),
//     mid = bf16(x - hi), lo = bf16(x - hi - mid), hi + mid + lo == x
//     (ref.split_bf16 states the range: |x| from 2^-110 up, below the
//     point where bf16(x) overflows);
//   * so each part x code is exact in fp32, and three passes (hi, mid, lo)
//     into the same partial depart from the fp32 product by the order of
//     the sums only, as the fp32 reference kernel does. A bf16 x is one
//     pass. ref.quant_matmul_route_ref emulates this in plain PyTorch.
//
// Bound on the H100: the tensor work of the route (three bf16 passes for an
// fp32 x, one for a bf16 x, at 989 TFLOP/s) at prefill shapes (M 4096:
// 0.0586 ms at 4096 x 768 x 3072 fp32 x), the bytes at decode shapes (M 8:
// the 19.7 MB of codes at 8 x 2560 x 7680, 0.0062 ms). Two routes, picked
// by kernel.py's plan() from M:
//
// Wide (M > 64): two launches.
//   * A pre-pass splits x into its bf16 parts (an fp32 x; a bf16 x is
//     copied, or read as it is where bk % 64 == 0 and it is 16-byte
//     aligned) and widens the codes to bf16, once per call, into buffers
//     the wrapper allocates: (parts, M, kp) and (kp, np), each k-block
//     padded with zeros to a multiple of KT = 64 rows and N to a multiple
//     of 8, so every row is 16-byte aligned and no stage crosses a k-block.
//     Splitting inside the product instead re-split the same x rows in each
//     of the N / 128 blocks of a row of tiles, and the split, not the
//     products, took the time: 0.2247 ms at pimref's shape with x split in
//     registers for wgmma's register-A form, 0.2192 with it split by a
//     producer warpgroup fed by TMA, 0.1434 with the pre-pass
//     (chip_smoke.py on an H100).
//   * The product: a block owns a 128 x 128 output tile and all of K. One
//     producer thread asks the Tensor Memory Accelerator for each stage (KT
//     rows: x's parts, 128 x 64 boxes, and the codes, two 64 x 64 boxes),
//     written 128-byte swizzled as wgmma reads them (the codes N-major,
//     through the descriptor's transpose bit, as V in flash_prefill.cu), in
//     a ring of 3 stages (fp32 x; 5 for bf16 x) with a full and an empty
//     mbarrier each; zeros past M. (Copies made by the threads themselves
//     were limited by how many each thread keeps in flight.)
//   * Two consumer warpgroups, 64 rows each, run only the products: per
//     stage 4 k16 slices x parts x two 64-column halves of m64n64k16 wgmma,
//     both operands in shared memory, into an fp32 partial; at the
//     k-block's last stage acc += partial * scale (64 + 64 registers).
//   * The output tile goes back through shared memory as 16-byte stores.
//   What holds it back: the stages run at about half the tensor cores'
//   rate, and a bf16 x, a third of the tensor work, still takes 66% of the
//   fp32 time (chip_smoke.py on an H100). Neither one m64n128k16 in place
//   of two m64n64k16 nor a stage's products kept in flight across the next
//   one helped (throwaway variants). Bytes pulled into the SMs per stage
//   (64 KiB for 128 x 128 x 64 x 3 parts) are the suspect: next, a cluster
//   of two blocks sharing x's parts by TMA multicast.
//
// Narrow (M <= 64, decode): the operands swap, out^T = codes^T x^T, so N is
// the 64-row side of wgmma and M (padded to MP = 8, 16, 32 or 64) its n
// side: no tensor work on padding rows beyond MP.
//   * a block of 128 threads owns 64 output columns and one run of k-blocks
//     (a split): plan() cuts K on k-block boundaries into n_split runs so
//     that >= 264 blocks (two an SM) stream the codes; the splits' fp32
//     results land in scratch and a second launch sums them in split order
//     (no atomics: the same inputs give the same bits on every run);
//   * an 8-stage ring (4 at MP 32 / 64) of raw code and x tiles, filled by
//     TMA boxes that one thread asks for (zeros past N and M); per stage the
//     codes are widened to bf16 (A, M-major: the transpose bit of A) and x
//     is split into its bf16 parts (B, K-major) in shared memory. TMA in
//     place of every thread's 16-byte cp.async: 0.0299 -> 0.0266 ms at 8 x
//     2560 x 7680 (chip_smoke.py on an H100). What holds it back: one
//     warpgroup runs a stage's wait, widening, split and products one after
//     another, two barriers a stage; next, a producer warp and the
//     conversion beside the products.
//   * TMA needs k-blocks that are a multiple of 64 and 16-byte aligned
//     pointers and rows (N % 16 == 0): any other call copies its stages
//     element by element with plain guarded loads, in the same kernel
//     (any k-block size works: the tail of a stage is zero-filled). The
//     wide route's pre-pass reads any stride.
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKT = 64;            // k rows a stage
constexpr int kWideBM = 128, kWideBN = 128;
constexpr int kNarrowBN = 64, kNarrowThreads = 128;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use (227 KB)

// ---------------------------------------------------------------------------
// primitives (as in flash_prefill.cu)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (c0, c1) of a 2-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// make this thread's generic-proxy writes to shared memory visible to
// wgmma's async-proxy reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wgmma shared-memory descriptor, 128B swizzle; strides in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (x parts: A of the wide route, B of the narrow one):
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}
// MN-major operand (the codes, through the transpose bit): one 64-column
// block, 8-row groups along K 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_sw128(addr, 1024, 1024);
}
// 16-byte chunk c of 128-byte row r of a swizzled region
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
#define ACC32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x MP fp32) += A (64 x 16, shared, M-major: transposed) * B (16 x MP,
// shared, K-major)
template <int MP>
struct WgmmaT;
template <>
struct WgmmaT<8> {
  __device__ static void ss(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaT<16> {
  __device__ static void ss(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaT<32> {
  __device__ static void ss(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaT<64> {
  __device__ static void ss(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", %32, %33, p, 1, 1, 1, 0;\n}\n"
        : ACC32(d)
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two fp32 values -> their hi, mid and lo bf16 parts, packed in pairs (the
// first value in the low half); hi + mid + lo == the value, exactly
__device__ __forceinline__ void split_pair(float2 v, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(v.x, hf.x), ry = __fsub_rn(v.y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}
// eight int8 codes -> eight bf16 (exact), as one 16-byte chunk
__device__ __forceinline__ uint4 widen8(uint2 w) {
  auto c = [](uint32_t word, int j) {
    return static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xff));
  };
  uint4 o;
  o.x = bits(__floats2bfloat162_rn(c(w.x, 0), c(w.x, 1)));
  o.y = bits(__floats2bfloat162_rn(c(w.x, 2), c(w.x, 3)));
  o.z = bits(__floats2bfloat162_rn(c(w.y, 0), c(w.y, 1)));
  o.w = bits(__floats2bfloat162_rn(c(w.y, 2), c(w.y, 3)));
  return o;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16_rn(0.f);
}

struct Args {
  const void* x;
  const int8_t* codes;
  const float* scales;
  float* out;        // (M, N), or the scratch (n_split, M, N)
  int M, N, K, bk;
  int spk;           // stages a k-block: ceil(bk / kKT)
  int n_split;
  bool tma;          // narrow route: TMA boxes for the codes and x
};

// The k range [k0, kend) of stage s (kb = s / spk) of a block.
__device__ __forceinline__ void stage_range(const Args& p, int s, int& kb,
                                            int& k0, int& kend) {
  kb = s / p.spk;
  k0 = kb * p.bk + (s % p.spk) * kKT;
  kend = min(k0 + kKT, (kb + 1) * p.bk);
}

// Copy rows r < ROWS (x rows r < M) x columns k0 .. k0 + kKT - 1 (k <
// kend) of x into shared memory at dst, row stride rs bytes; zeros
// elsewhere. Plain loads: the narrow route's copy where TMA cannot go.
template <typename TX, int ROWS, int THREADS>
__device__ __forceinline__ void load_x(const Args& p, int k0, int kend,
                                       unsigned char* dst, int rs) {
  const TX* x = static_cast<const TX*>(p.x);
  for (int i = threadIdx.x; i < ROWS * kKT; i += THREADS) {
    const int r = i / kKT, c = i % kKT;
    const int k = k0 + c;
    *reinterpret_cast<TX*>(dst + r * rs + c * sizeof(TX)) =
        (r < p.M && k < kend) ? x[static_cast<long long>(r) * p.K + k]
                              : zero_of<TX>();
  }
}

// Copy code rows k0 .. k0 + kKT - 1 (k < kend) x columns n0 .. n0 + COLS - 1
// (n < N) into shared memory at dst, COLS bytes a row; zeros elsewhere.
template <int COLS, int THREADS>
__device__ __forceinline__ void load_codes(const Args& p, int n0, int k0,
                                           int kend, unsigned char* dst) {
  for (int i = threadIdx.x; i < kKT * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const int k = k0 + r, n = n0 + c;
    dst[r * COLS + c] =
        (k < kend && n < p.N)
            ? static_cast<unsigned char>(
                  p.codes[static_cast<long long>(k) * p.N + n])
            : 0;
  }
}

// Widen a raw kKT x COLS int8 tile (COLS bytes a row) into the bf16
// MN-major swizzled layout: 64-column block cb at cb * (kKT * 128) bytes.
template <int COLS, int THREADS>
__device__ __forceinline__ void widen_codes(const unsigned char* raw,
                                            unsigned char* dst) {
  constexpr int kCh = COLS / 8;                  // 8 codes a chunk
#pragma unroll
  for (int i = threadIdx.x; i < kKT * kCh; i += THREADS) {
    const int k = i / kCh, c = i % kCh;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + k * COLS + 8 * c);
    *reinterpret_cast<uint4*>(dst + (c >> 3) * (kKT * 128) + swz(k, c)) =
        widen8(w);
  }
}

// ---------------------------------------------------------------------------
// wide route: M > 64; a pre-pass, then a TMA-fed warp-specialised product
// ---------------------------------------------------------------------------
// The k axis in the wide route's operands: every k-block of bk rows padded
// with zeros to bkp = ceil(bk / kKT) * kKT rows, kp = nkb * bkp in all, so
// a stage of kKT rows never crosses a k-block.
struct Prep {
  bf16* xp;          // (parts, M, kp) bf16: x's parts, or null (x as it is)
  bf16* cw;          // (kp, np) bf16: the codes widened, zeros past N
  int kp, np, bkp;
  bool x_vec8, c_vec8;   // 8 x values / 8 codes with one load
};

// x (M, K) -> xp; codes (K, N) -> cw. One item is 8 consecutive padded k of
// one x row, or 8 consecutive columns of one padded code row.
template <typename TX>
__global__ void __launch_bounds__(256)
quant_matmul_prepare(const Args p, const Prep q) {
  const TX* x = static_cast<const TX*>(p.x);
  const long long xc = q.kp / 8;
  const long long nx = q.xp ? static_cast<long long>(p.M) * xc : 0;
  const long long nc = static_cast<long long>(q.kp) * (q.np / 8);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < nx + nc;
       i += static_cast<long long>(gridDim.x) * 256) {
    if (i < nx) {
      const int m = static_cast<int>(i / xc), kq = static_cast<int>(i % xc) * 8;
      const int kb = kq / q.bkp, kr = kq - kb * q.bkp;
      const long long src = static_cast<long long>(m) * p.K + kb * p.bk + kr;
      float v[8];
      if (q.x_vec8) {          // bk % 8 == 0: the 8 are all in or all out
        if (kr < p.bk) {
          if constexpr (sizeof(TX) == 4) {
            const float4 a = *reinterpret_cast<const float4*>(x + src);
            const float4 b = *reinterpret_cast<const float4*>(x + src + 4);
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
            v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
          } else {
            const uint4 a = *reinterpret_cast<const uint4*>(x + src);
            const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
              v[2 * j] = f.x;
              v[2 * j + 1] = f.y;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = kr + j < p.bk ? static_cast<float>(x[src + j]) : 0.f;
      }
      const long long dst = static_cast<long long>(m) * q.kp + kq;
      if constexpr (sizeof(TX) == 4) {
        uint32_t h[4], md[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_pair(make_float2(v[2 * j], v[2 * j + 1]), h[j], md[j], lo[j]);
        const long long part = static_cast<long long>(p.M) * q.kp;
        *reinterpret_cast<uint4*>(q.xp + dst) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(q.xp + part + dst) =
            make_uint4(md[0], md[1], md[2], md[3]);
        *reinterpret_cast<uint4*>(q.xp + 2 * part + dst) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        *reinterpret_cast<uint4*>(q.xp + dst) = make_uint4(
            bits(__floats2bfloat162_rn(v[0], v[1])),
            bits(__floats2bfloat162_rn(v[2], v[3])),
            bits(__floats2bfloat162_rn(v[4], v[5])),
            bits(__floats2bfloat162_rn(v[6], v[7])));
      }
    } else {
      const long long c = i - nx;
      const int kq = static_cast<int>(c / (q.np / 8));
      const int n = static_cast<int>(c % (q.np / 8)) * 8;
      const int kb = kq / q.bkp, kr = kq - kb * q.bkp;
      const long long src = static_cast<long long>(kb * p.bk + kr) * p.N + n;
      uint2 w = make_uint2(0u, 0u);
      if (kr < p.bk) {
        if (q.c_vec8) {        // N % 8 == 0: the 8 are all in or all out
          if (n < p.N) w = *reinterpret_cast<const uint2*>(p.codes + src);
        } else {
          uint32_t b[2] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (n + j < p.N)
              b[j / 4] |= static_cast<uint32_t>(
                              static_cast<uint8_t>(p.codes[src + j]))
                          << (8 * (j % 4));
          w = make_uint2(b[0], b[1]);
        }
      }
      *reinterpret_cast<uint4*>(q.cw + static_cast<long long>(kq) * q.np + n) =
          widen8(w);
    }
  }
}

// named barrier of the two consumer warpgroups' epilogue (0 is
// __syncthreads)
constexpr int kBarEpi = 1;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// box (c0, c1, c2) of a 3-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// d (64 x 64 fp32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_ss_tb(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

template <typename TX>
struct WideSmem {
  static constexpr int kParts = sizeof(TX) == 4 ? 3 : 1;
  static constexpr int kPart = kWideBM * 128;            // 128 rows of 64 k
  static constexpr int kStage = (kParts + 1) * kPart;    // parts, codes
  static constexpr int kStages = kParts == 3 ? 3 : 5;
  static constexpr int kBars = kStages * kStage;         // full, then empty
  static constexpr size_t kSmem = kBars + 16 * kStages + 1024;
  static constexpr int kOutRow = kWideBN + 4;            // epilogue floats
  static_assert(kWideBM * kOutRow * 4 <= kBars, "epilogue staging");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

template <typename TX>
__global__ void __launch_bounds__(3 * 128, 1)
quant_matmul_wide(const Args p, const __grid_constant__ CUtensorMap mx,
                  const __grid_constant__ CUtensorMap mc) {
  using L = WideSmem<TX>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t full = base + L::kBars, empty = full + 8 * S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * kWideBN, m0 = blockIdx.y * kWideBM;
  const int spk = p.spk, G = p.K / p.bk * spk;   // stages of the padded k
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread asks the TMA for each stage's boxes (x's parts,
    // then the two 64-column blocks of codes), swizzled as wgmma reads
    // them, once the consumers have released the slot
    if (tid != 0) return;
    for (int s = 0; s < G; ++s) {
      const int slot = s % S, n = s / S;
      if (n > 0) mbar_wait(empty + 8 * slot, (n - 1) & 1);
      const uint32_t st = base + slot * L::kStage, bar = full + 8 * slot;
      mbar_expect_tx(bar, L::kStage);
#pragma unroll
      for (int pp = 0; pp < L::kParts; ++pp)
        tma_load_3d(st + pp * L::kPart, &mx, kKT * s, m0, pp, bar);
      tma_load_2d(st + L::kParts * L::kPart, &mc, n0, kKT * s, bar);
      tma_load_2d(st + L::kParts * L::kPart + kKT * 128, &mc, n0 + 64,
                  kKT * s, bar);
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 of the tile
  const int ct = tid - 128, lane = tid & 31, wq = (ct >> 5) & 3;
  const int rw = (wg - 1) * 64;
  const int r0 = rw + wq * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float part[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = acc[i] = 0.f;

  for (int s = 0; s < G; ++s) {
    const int slot = s % S;
    mbar_wait(full + 8 * slot, (s / S) & 1);
    const uint32_t st = base + slot * L::kStage;
    const uint32_t sB = st + L::kParts * L::kPart;
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < L::kParts; ++pp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(st + pp * L::kPart + rw * 128 + kk * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_ss_tb(&part[32 * h], da,
                      desc_mn(sB + h * (kKT * 128) + kk * (16 * 128)));
      }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(part);
    mbar_arrive(empty + 8 * slot);

    if (s % spk == spk - 1) {        // the k-block's last stage
      const float* srow = p.scales + static_cast<long long>(s / spk) * p.N;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int I = 0; I < 8; ++I)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 64 * h + 8 * I + cq + e;
            const float sc = n < p.N ? __ldg(srow + n) : 0.f;
            const int i = 32 * h + 4 * I + e;
            acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], sc));
            acc[i + 2] = __fadd_rn(acc[i + 2], __fmul_rn(part[i + 2], sc));
            part[i] = part[i + 2] = 0.f;
          }
    }
  }

  // epilogue: once both consumer warpgroups are done with the ring (every
  // TMA load has landed: each was waited for), the tile goes through
  // shared memory and out as 16-byte stores of whole rows
  bar_sync(kBarEpi, 256);
  float* so = reinterpret_cast<float*>(sm);
  constexpr int kOF = L::kOutRow;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int I = 0; I < 8; ++I) {
      const int c = 64 * h + 8 * I + cq, i = 32 * h + 4 * I;
      *reinterpret_cast<float2*>(so + r0 * kOF + c) =
          make_float2(acc[i], acc[i + 1]);
      *reinterpret_cast<float2*>(so + r1 * kOF + c) =
          make_float2(acc[i + 2], acc[i + 3]);
    }
  bar_sync(kBarEpi, 256);
  const bool vec = p.N % 4 == 0;
  for (int idx = ct; idx < kWideBM * (kWideBN / 4); idx += 256) {
    const int r = idx / (kWideBN / 4), c = 4 * (idx % (kWideBN / 4));
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    float* dst = p.out + static_cast<long long>(m) * p.N + n;
    const float4 v = *reinterpret_cast<const float4*>(so + r * kOF + c);
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n + j < p.N; ++j) dst[j] = vv[j];
    }
  }
}

// ---------------------------------------------------------------------------
// narrow route: M <= 64, out^T = codes^T x^T, split over k-blocks
// ---------------------------------------------------------------------------
template <typename TX, int MP>
struct NarrowSmem {
  static constexpr int kStages = MP <= 16 ? 8 : 4;
  static constexpr int kParts = sizeof(TX) == 4 ? 3 : 1;
  static constexpr int kA = kKT * kNarrowBN * 2;       // bf16 codes (A)
  static constexpr int kP = MP * 128;                  // one bf16 x part
  static constexpr int kXRow = kKT * sizeof(TX);
  static constexpr int kSlot = kKT * kNarrowBN + MP * kXRow;  // codes, x
  static constexpr int kRing = kA + kParts * kP;       // ring offset
  static constexpr int kBars = kRing + kStages * kSlot;  // TMA: a stage's
  static constexpr size_t kSmem = kBars + 8 * kStages + 1024;
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

template <typename TX, int MP>
__global__ void __launch_bounds__(kNarrowThreads)
quant_matmul_narrow(const Args p, const __grid_constant__ CUtensorMap mc,
                    const __grid_constant__ CUtensorMap mx) {
  using L = NarrowSmem<TX, MP>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sA = base, sP = base + L::kA, sRing = base + L::kRing;
  unsigned char* const ring = sm + L::kRing;

  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int n0 = blockIdx.x * kNarrowBN, split = blockIdx.y;
  const int nkb = p.K / p.bk;
  const int kb_lo = split * nkb / p.n_split;
  const int kb_hi = (split + 1) * nkb / p.n_split;
  const int s_lo = kb_lo * p.spk, G = (kb_hi - kb_lo) * p.spk;

  // TMA (bk % 64 == 0, 16-byte aligned rows): thread 0 asks for a stage's
  // code box (64 columns x kKT rows, zeros past N) and x box (kKT x MP,
  // zeros past M), counted on the slot's mbarrier; else every thread
  // copies with plain loads, seen by all after the next __syncthreads
  const uint32_t bars = base + L::kBars;
  if (p.tma && tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int s, int slot) {
    int kb, k0, kend;
    stage_range(p, s_lo + s, kb, k0, kend);
    if (p.tma) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * slot, st = sRing + slot * L::kSlot;
        mbar_expect_tx(bar, L::kSlot);
        tma_load_2d(st, &mc, n0, k0, bar);
        tma_load_2d(st + kKT * kNarrowBN, &mx, k0, 0, bar);
      }
      return;
    }
    load_codes<kNarrowBN, kNarrowThreads>(p, n0, k0, kend,
                                          ring + slot * L::kSlot);
    load_x<TX, MP, kNarrowThreads>(p, k0, kend,
                                   ring + slot * L::kSlot + kKT * kNarrowBN,
                                   L::kXRow);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < G) load(s, s);

  // accumulator rows n0 + r0, n0 + r1; columns (x rows) 8 I + 2 (l % 4) + e
  const int r0 = wq * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float part[MP / 2], acc[MP / 2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) part[i] = acc[i] = 0.f;

  for (int s = 0; s < G; ++s) {
    if (p.tma) mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);
    __syncthreads();
    if (s + kStages - 1 < G) load(s + kStages - 1, (s + kStages - 1) % kStages);

    const unsigned char* slot = ring + (s % kStages) * L::kSlot;
    widen_codes<kNarrowBN, kNarrowThreads>(slot, sm);
    // x rows as bf16 parts, K-major swizzled: 8 x values a chunk
    const unsigned char* xr = slot + kKT * kNarrowBN;
    for (int i = tid; i < MP * (kKT / 8); i += kNarrowThreads) {
      const int m = i / (kKT / 8), c = i % (kKT / 8);
      if constexpr (sizeof(TX) == 4) {
        const float4* v = reinterpret_cast<const float4*>(xr + m * L::kXRow +
                                                          c * 32);
        const float4 a = v[0], b = v[1];
        const float2 pr[4] = {make_float2(a.x, a.y), make_float2(a.z, a.w),
                              make_float2(b.x, b.y), make_float2(b.z, b.w)};
        uint32_t h[4], md[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split_pair(pr[j], h[j], md[j], lo[j]);
        unsigned char* d = sm + L::kA + swz(m, c);
        *reinterpret_cast<uint4*>(d) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(d + L::kP) =
            make_uint4(md[0], md[1], md[2], md[3]);
        *reinterpret_cast<uint4*>(d + 2 * L::kP) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        *reinterpret_cast<uint4*>(sm + L::kA + swz(m, c)) =
            *reinterpret_cast<const uint4*>(xr + m * L::kXRow + c * 16);
      }
    }
    fence_proxy_async();
    __syncthreads();

    reg_fence(part);
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < L::kParts; ++pp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaT<MP>::ss(part, desc_mn(sA + kk * (16 * 128)),
                       desc_k(sP + pp * L::kP + kk * 32));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(part);

    if (s % p.spk == p.spk - 1) {
      const float* srow =
          p.scales + static_cast<long long>(kb_lo + s / p.spk) * p.N + n0;
      const float sa = n0 + r0 < p.N ? __ldg(srow + r0) : 0.f;
      const float sb = n0 + r1 < p.N ? __ldg(srow + r1) : 0.f;
#pragma unroll
      for (int I = 0; I < MP / 8; ++I)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * I + e;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], sa));
          acc[i + 2] = __fadd_rn(acc[i + 2], __fmul_rn(part[i + 2], sb));
          part[i] = part[i + 2] = 0.f;
        }
    }
  }

  float* dst = p.out + static_cast<long long>(split) * p.M * p.N;
#pragma unroll
  for (int I = 0; I < MP / 8; ++I)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * I + cq + e;
      if (m >= p.M) continue;
      if (n0 + r0 < p.N)
        dst[static_cast<long long>(m) * p.N + n0 + r0] = acc[4 * I + e];
      if (n0 + r1 < p.N)
        dst[static_cast<long long>(m) * p.N + n0 + r1] = acc[4 * I + 2 + e];
    }
}

// out[i] = the splits' results summed in split order
__global__ void quant_matmul_merge(const float* __restrict__ scratch,
                                   float* __restrict__ out, long long n,
                                   int n_split) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = scratch[i];
    for (int s = 1; s < n_split; ++s) v = __fadd_rn(v, scratch[s * n + i]);
    out[i] = v;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, bool& ready) {
  if (ready) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) ready = true;
  return e;
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* q_fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &q_fn,
                                         12000, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q_fn,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(q_fn);
  }
  return fn;
}

// a tensor of up to three dimensions (d0 innermost, elements of esize
// bytes) as a map with boxes of b0 x b1 x 1
cudaError_t make_map(CUtensorMap* m, CUtensorMapDataType type, int esize,
                     const void* ptr, int rank, long long d0, long long d1,
                     long long d2, int b0, int b1, CUtensorMapSwizzle swizzle) {
  auto enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * esize,
                                 static_cast<cuuint64_t>(d0 * d1) * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(m, type, rank, const_cast<void*>(ptr), dims, strides,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TX>
constexpr CUtensorMapDataType map_type() {
  return sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename TX>
cudaError_t launch_wide(const Args& p, Prep q, cudaStream_t st) {
  using L = WideSmem<TX>;
  static bool ready = false;
  cudaError_t e = set_smem(quant_matmul_wide<TX>, L::kSmem, ready);
  if (e != cudaSuccess) return e;
  // the pre-pass: the codes always, x unless it is a bf16 x that TMA can
  // read as it is
  const long long items =
      (q.xp ? static_cast<long long>(p.M) * (q.kp / 8) : 0) +
      static_cast<long long>(q.kp) * (q.np / 8);
  const long long want = (items + 255) / 256;
  quant_matmul_prepare<TX><<<static_cast<unsigned>(want < 4096 ? want : 4096),
                             256, 0, st>>>(p, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mc;
  constexpr auto kBf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  e = q.xp ? make_map(&mx, kBf, 2, q.xp, 3, q.kp, p.M, L::kParts, kKT,
                      kWideBM, kSw)
           : make_map(&mx, kBf, 2, p.x, 3, p.K, p.M, 1, kKT, kWideBM, kSw);
  if (e == cudaSuccess)
    e = make_map(&mc, kBf, 2, q.cw, 2, q.np, q.kp, 1, 64, kKT, kSw);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + kWideBN - 1) / kWideBN, (p.M + kWideBM - 1) / kWideBM);
  quant_matmul_wide<TX><<<grid, 3 * 128, L::kSmem, st>>>(p, mx, mc);
  return cudaGetLastError();
}

template <typename TX, int MP>
cudaError_t launch_narrow(const Args& p, float* out, cudaStream_t st) {
  using L = NarrowSmem<TX, MP>;
  static bool ready = false;
  cudaError_t e = set_smem(quant_matmul_narrow<TX, MP>, L::kSmem, ready);
  if (e != cudaSuccess) return e;
  CUtensorMap mc{}, mx{};
  if (p.tma) {
    constexpr auto kNo = CU_TENSOR_MAP_SWIZZLE_NONE;
    e = make_map(&mc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.codes, 2, p.N, p.K,
                 1, kNarrowBN, kKT, kNo);
    if (e == cudaSuccess)
      e = make_map(&mx, map_type<TX>(), sizeof(TX), p.x, 2, p.K, p.M, 1, kKT,
                   MP, kNo);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.N + kNarrowBN - 1) / kNarrowBN, p.n_split);
  quant_matmul_narrow<TX, MP><<<grid, kNarrowThreads, L::kSmem, st>>>(p, mc,
                                                                      mx);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return e;
  const long long n = static_cast<long long>(p.M) * p.N;
  const int blocks = static_cast<int>(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
  quant_matmul_merge<<<blocks, 256, 0, st>>>(p.out, out, n, p.n_split);
  return cudaGetLastError();
}

// the narrow route's x rows padded to the wgmma's n: 8, 16, 32 or 64
int narrow_mp(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64; }

template <typename TX>
cudaError_t launch_narrow_mp(const Args& p, float* out, cudaStream_t st) {
  switch (narrow_mp(p.M)) {
    case 8: return launch_narrow<TX, 8>(p, out, st);
    case 16: return launch_narrow<TX, 16>(p, out, st);
    case 32: return launch_narrow<TX, 32>(p, out, st);
    default: return launch_narrow<TX, 64>(p, out, st);
  }
}

// (mp, ring stages, dynamic shared memory) of a layout
template <typename L>
void layout_of(int mp, int* out) {
  out[0] = mp;
  out[1] = L::kStages;
  out[2] = static_cast<int>(L::kSmem);
}
template <typename TX>
void narrow_layout(int M, int* out) {
  switch (narrow_mp(M)) {
    case 8: return layout_of<NarrowSmem<TX, 8>>(8, out);
    case 16: return layout_of<NarrowSmem<TX, 16>>(16, out);
    case 32: return layout_of<NarrowSmem<TX, 32>>(32, out);
    default: return layout_of<NarrowSmem<TX, 64>>(64, out);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The product's layout for M rows of an fp32 (x_bf16 = 0) or bf16 (1) x,
// as out = {mp, ring stages, dynamic shared memory bytes}: mp is the narrow
// route's padded x rows (M <= 64), 0 on the wide route. kernel.py plan()
// states the same numbers for the CPU tests; a card test compares them.
void repro_quant_matmul_layout(int M, int x_bf16, int* out) {
  if (M > 64) {
    x_bf16 ? layout_of<WideSmem<bf16>>(0, out)
           : layout_of<WideSmem<float>>(0, out);
  } else {
    x_bf16 ? narrow_layout<bf16>(M, out) : narrow_layout<float>(M, out);
  }
}

// x (M, K) fp32 (x_bf16 = 0) or bf16 (1), codes (K, N) int8, scales
// (K / bk, N) fp32, out (M, N) fp32; all contiguous, K % bk == 0. The plan
// of kernel.py plan():
//   narrow 0 (M > 64): cw a (kp, np) bf16 buffer and xp a (parts, M, kp)
//     bf16 one (parts 3 for fp32 x, 1 for a bf16 x), or null for a bf16 x
//     with bk % 64 == 0 and a 16-byte aligned pointer, where kp = K / bk *
//     ceil(bk / 64) * 64, np = ceil(N / 8) * 8;
//   narrow 1 (M <= 64): n_split k-block runs, each at least one k-block;
//     scratch (n_split, M, N) fp32 when n_split > 1.
// Any other plan is refused.
int repro_quant_matmul(const void* x, const void* codes, const void* scales,
                       void* out, void* scratch, void* xp, void* cw, int M,
                       int N, int K, int bk, int x_bf16, int narrow,
                       int n_split, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (bk < 1 || K % bk != 0) return cudaErrorInvalidValue;
  Args p;
  p.x = x;
  p.codes = static_cast<const int8_t*>(codes);
  p.scales = static_cast<const float*>(scales);
  p.out = static_cast<float*>(out);
  p.M = M; p.N = N; p.K = K; p.bk = bk;
  p.spk = (bk + kKT - 1) / kKT;
  p.n_split = 1;
  p.tma = false;
  auto st = static_cast<cudaStream_t>(stream);
  if (!narrow) {
    Prep q;
    q.bkp = p.spk * kKT;
    q.kp = K / bk * q.bkp;
    q.np = (N + 7) / 8 * 8;
    q.xp = static_cast<bf16*>(xp);
    q.cw = static_cast<bf16*>(cw);
    q.x_vec8 = K % 8 == 0 && bk % 8 == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0;
    q.c_vec8 = N % 8 == 0 && reinterpret_cast<uintptr_t>(codes) % 8 == 0;
    const bool direct = x_bf16 && bk % kKT == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (n_split != 1 || cw == nullptr || (xp == nullptr) != direct)
      return cudaErrorInvalidValue;
    return x_bf16 ? launch_wide<bf16>(p, q, st)
                  : launch_wide<float>(p, q, st);
  }
  if (M > 64 || n_split < 1 || n_split > K / bk) return cudaErrorInvalidValue;
  p.n_split = n_split;
  // TMA boxes: whole stages (bk % 64 == 0, so x rows are 16-byte multiples
  // too), 16-byte code rows and 16-byte aligned pointers
  p.tma = bk % kKT == 0 && N % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(x) |
           reinterpret_cast<uintptr_t>(codes)) % 16 == 0;
  if (n_split > 1) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    p.out = static_cast<float*>(scratch);
  }
  auto o = static_cast<float*>(out);
  return x_bf16 ? launch_narrow_mp<bf16>(p, o, st)
                : launch_narrow_mp<float>(p, o, st);
}

}  // extern "C"
