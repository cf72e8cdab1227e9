// The prefill kernels' templates and launches (both routes), for
// flash_prefill.cu (which says what they compute and why they are built so,
// and holds the C entry points) and for flash_prefill.d<D>.cu, one
// translation unit a head dim, which compile in parallel.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace repro_prefill {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // fp32 route: two warpgroups
constexpr int kRows = 128;             // bf16 route: q rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use (227 KB)

// E: the element type of q, k, v and out (bf16 or fp32)
template <typename E>
struct ParamsT {
  const E* q;
  const E* k;
  const E* v;
  const int* qpos;    // (B, S)
  const int* kpos;    // (B, T)
  E* out;
  float* lse;
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q (B, Hkv, G, S, D)
  long long ks_b, ks_h, ks_t;
  long long vs_b, vs_h, vs_t;
  int B, H, G, S, T;
  int GG, BQ;         // the block's query heads x positions, GG * BQ <= rows
  int groups;         // head groups: block x takes group x % groups
  int causal, window;
  float softcap, scale;
};
using Params = ParamsT<bf16>;

// ---------------------------------------------------------------------------
// shared memory: every operand is stored as 64-column blocks of 128-byte
// rows, 16-byte chunk c of row r at chunk (c ^ (r & 7)) -- the 128B swizzle
// of wgmma's descriptors; every region starts on a 1024-byte boundary
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to wgmma's async-proxy reads
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
// K-major operand (Q as A, K as B): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}
// MN-major operand (V as B, transposed): one 64-column block, 8-row groups
// along K 1024 bytes apart; both offsets carry 1024 because an n64 product
// never steps to a second 64-column block
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_sw128(addr, 1024, 1024);
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
// keep the compiler from moving register reads or writes across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(r[i]);
}

#define ACC16(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define ACC32(d)                                                             \
  ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])
#define REGS16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64 fp32, 32 per thread) (+)= A (64 x 16, shared) * B (16 x 64,
// shared, K-major)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// the same for a 64 x 32 d (16 per thread) and a 16 x 32 B
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#define ACC40(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),\
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),\
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define REGS40                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39}"
#define ACC56(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),\
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),\
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),\
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),\
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),\
  "+f"(d[54]), "+f"(d[55])
#define REGS56                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55}"

// d (64 x N fp32, N / 2 per thread) += A (64 x 16 bf16, registers) * B
// (16 x N, shared, MN-major) for the head dims that are no multiple of 64,
// N = 80 or 112: B spans two 64-column blocks of the 128-byte swizzle,
// lbo bytes apart (the leading byte offset of an MN-major operand is the
// stride between its 64-column blocks), the second read in part
template <int N>
__device__ __forceinline__ void wgmma_rs_n(float* d, const uint32_t (&a)[4],
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_n<80>(float* d,
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " REGS40
      ", {%40, %41, %42, %43}, %44, 1, 1, 1, 1;\n"
      : ACC40(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
template <>
__device__ __forceinline__ void wgmma_rs_n<112>(float* d,
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 " REGS56
      ", {%56, %57, %58, %59}, %60, 1, 1, 1, 1;\n"
      : ACC56(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two fp32 values -> their three bf16 parts, packed in pairs (the first
// value in the low half); x0 + x1 + x2 == the value, exactly
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& x0,
                                           uint32_t& x1, uint32_t& x2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = __fsub_rn(a, hf.x), rb = __fsub_rn(b, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  x0 = *reinterpret_cast<const uint32_t*>(&h);
  x1 = *reinterpret_cast<const uint32_t*>(&m);
  x2 = pack_bf16(__fsub_rn(ra, mf.x), __fsub_rn(rb, mf.y));
}

// 2^x in one MUFU op (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

constexpr int kScanTiles = 256;        // kv tiles classified at a time
constexpr uint8_t kLive = 1;  // a pair of the tile may be visible
constexpr uint8_t kFull = 2;  // every pair of a valid q row is visible

// A head dim padded to whole 64-column blocks of the 128-byte swizzle: the
// width of the fp32 route's operand rows in shared memory. D 80 and 112 are
// stored in D 128's layout; the columns past D are not read.
__host__ __device__ constexpr int pad64(int d) {
  return (d + 63) / 64 * 64;
}

// Block row r (0 .. rows - 1) -> its query head g and position s; false if
// the row holds none (unused rows of the plan, past G or past S).
template <typename P>
__device__ __forceinline__ bool block_row(const P& p, int r, int qt, int gg,
                                          int& g, int& s) {
  const int gl = r / p.BQ;
  g = gg * p.GG + gl;
  s = qt * p.BQ + (r - gl * p.BQ);
  return gl < p.GG && g < p.G && s < p.S;
}

// Classify kv tiles c0 .. c0 + kScanTiles - 1 for a block whose valid q
// positions lie in [qmin, qmax] (qmax < 0: none), from each tile's valid
// kv position range: kLive unless no pair can be visible (never drops a
// visible pair), kFull if every pair of a valid q row and a kv row of the
// tile is visible (the tile needs no mask). Warp w takes tiles w, w + 8, ...
template <int BK, typename P>
__device__ void scan_tiles(const P& p, const int* kpos_b, int c0, int nt,
                           int qmin, int qmax, uint8_t* flags) {
  const int lane = threadIdx.x & 31;
  const int n = min(kScanTiles, nt - c0);
  for (int jj = threadIdx.x >> 5; jj < n; jj += kThreads / 32) {
    const int t0 = (c0 + jj) * BK;
    int kmin = 0x7fffffff, kmax = -1;
    bool hole = false;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int t = t0 + lane + 32 * i;
      const int x = t < p.T ? kpos_b[t] : -1;
      if (x >= 0) {
        kmin = min(kmin, x);
        kmax = max(kmax, x);
      } else {
        hole = true;
      }
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    hole = __any_sync(0xffffffffu, hole);
    uint8_t f = 0;
    if (kmax >= 0 && qmax >= 0 && !(p.causal && kmin > qmax) &&
        !(p.window > 0 && kmax <= qmin - p.window)) {
      f = kLive;
      if (!hole && (!p.causal || kmax <= qmin) &&
          (p.window <= 0 || kmin > qmax - p.window))
        f |= kFull;
    }
    if (lane == 0) flags[jj] = f;
  }
}

// The first live tile at or after j (nt if none); flags hold the tiles from
// c0 on, rescanned past their end. Every thread runs it on the same values.
template <int BK, typename P>
__device__ __forceinline__ int next_live(const P& p, const int* kpos_b,
                                         int j, int nt, int qmin, int qmax,
                                         uint8_t* flags, int& c0) {
  for (; j < nt; ++j) {
    if (j >= c0 + kScanTiles) {
      __syncthreads();           // every thread is done with the flags
      c0 += kScanTiles;
      scan_tiles<BK>(p, kpos_b, c0, nt, qmin, qmax, flags);
      __syncthreads();
    }
    if (flags[j - c0] & kLive) break;
  }
  return j;
}

// The smallest and largest valid q position of a block's q tile (positions
// qt * BQ .. qt * BQ + BQ - 1); every warp reduces them itself.
template <typename P>
__device__ __forceinline__ void q_range(const P& p, const int* qpos_b, int qt,
                                        int& qmin, int& qmax) {
  const int lane = threadIdx.x & 31;
  qmin = 0x7fffffff;
  qmax = -1;
  const int s_lo = qt * p.BQ, s_hi = min(p.S, s_lo + p.BQ);
  for (int s = s_lo + lane; s < s_hi; s += 32) {
    const int x = qpos_b[s];
    if (x >= 0) {
      qmin = min(qmin, x);
      qmax = max(qmax, x);
    }
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
}

// Issue the cp.async copies of the kv positions of tile j into sKp (-1 past
// T), by the first BK threads.
template <int BK>
__device__ __forceinline__ void load_kpos(const int* kpos_b, int T, int j,
                                          uint32_t sKp) {
  if (threadIdx.x < BK) {
    const int t = j * BK + threadIdx.x;
    if (t < T)
      cp_async4(sKp + threadIdx.x * 4, kpos_b + t);
    else
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sKp + threadIdx.x * 4),
                   "r"(-1)
                   : "memory");
  }
}

// The kv positions a q row at qp sees (the masking rule above) as
// lo .. lo + span, so that the test is one unsigned subtraction and one
// compare: kp >= 0, kp <= qp if causal, kp > qp - window if windowed. With
// qp < 0 none: lo is 2^31, which no position (>= -1) equals, and span 0.
__device__ __forceinline__ void visible_range(int qp, int causal, int window,
                                              unsigned& lo, unsigned& span) {
  const int l = window > 0 ? max(0, qp - window + 1) : 0;
  const int hi = causal ? qp : 0x7fffffff;
  if (qp < 0 || hi < l) {
    lo = 0x80000000u;
    span = 0;
  } else {
    lo = static_cast<unsigned>(l);
    span = static_cast<unsigned>(hi - l);
  }
}

// A thread's two accumulator rows (wgmma layout: warp wq of the warpgroup
// holds rows 16 wq .. 16 wq + 15, lane l rows l / 4 and l / 4 + 8): where
// they are, the kv positions they see, and their online-softmax state.
// Scores stay unscaled: m is the running max of q.k, and
// p = 2^((s - m) * scale * log2 e) is one FFMA and one MUFU op.
struct RowPair {
  int g0, s0, g1, s1, qp0, qp1;
  bool ok0, ok1;
  unsigned lo0, lo1, span0, span1;
  float m0, m1;
  float l0, l1;                 // this lane's part of the row sum

  template <typename P>
  __device__ __forceinline__ RowPair(const P& p, const int* qpos_b, int r0,
                                     int qt, int gg) {
    ok0 = block_row(p, r0, qt, gg, g0, s0);
    ok1 = block_row(p, r0 + 8, qt, gg, g1, s1);
    qp0 = ok0 ? qpos_b[s0] : -1;
    qp1 = ok1 ? qpos_b[s1] : -1;
    visible_range(qp0, p.causal, p.window, lo0, span0);
    visible_range(qp1, p.causal, p.window, lo1, span1);
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
  }

  // One kv tile's scores s (BK / 2 a thread: element 4I+e is row 0 and
  // 4I+2+e row 1, column 8I + 2 (lane % 4) + e): softcap, mask (kp_s: the
  // tile's kv positions; none where full), and the online softmax over
  // the four lanes of each row. s becomes p; returns the factors alpha
  // that the rows' accumulators take before p.v is added.
  template <int BK, typename P>
  __device__ __forceinline__ void softmax(const P& p, float (&s)[BK / 2],
                                          const int* kp_s, bool full,
                                          float& alpha0, float& alpha1) {
    const int lane = threadIdx.x & 31;
    const float sl2 = p.scale * kLog2e;
    if (p.softcap > 0.f) {     // cap * tanh(s * scale / cap), unscaled again
      const float inv_scale = 1.f / p.scale;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap) * inv_scale;
    }
    if (!full) {
#pragma unroll
      for (int I = 0; I < BK / 8; ++I) {
        const int2 kv =
            *reinterpret_cast<const int2*>(kp_s + 8 * I + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned kq = static_cast<unsigned>(e ? kv.y : kv.x);
          if (kq - lo0 > span0) s[4 * I + e] = -INFINITY;
          if (kq - lo1 > span1) s[4 * I + 2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int I = 0; I < BK / 8; ++I) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * I], s[4 * I + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * I + 2], s[4 * I + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // fully-masked guard: exp(NEG_INF - NEG_INF) would be 1
    const float safe0 = mn0 <= kNegInf * 0.5f ? 0.f : mn0;
    const float safe1 = mn1 <= kNegInf * 0.5f ? 0.f : mn1;
    alpha0 = m0 <= kNegInf * 0.5f ? 0.f : ex2((m0 - safe0) * sl2);
    alpha1 = m1 <= kNegInf * 0.5f ? 0.f : ex2((m1 - safe1) * sl2);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = safe0 * sl2, ms1 = safe1 * sl2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int I = 0; I < BK / 8; ++I) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * I + e] = ex2(fmaf(s[4 * I + e], sl2, -ms0));      // masked: 0
        s[4 * I + 2 + e] = ex2(fmaf(s[4 * I + 2 + e], sl2, -ms1));
        sum0 += s[4 * I + e];
        sum1 += s[4 * I + 2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }

  // The epilogue's factors 1 / l and the rows' lse: a row whose q position
  // is -1 or that saw no visible pair gets out 0 and lse -1e30 (rows at -1
  // ride unmasked through the tiles that need no mask).
  template <typename P>
  __device__ __forceinline__ void finish(const P& p, int b, int h,
                                         float& inv0, float& inv1,
                                         bool write_lse = true) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const bool dead0 = qp0 < 0 || m0 <= kNegInf * 0.5f;
    const bool dead1 = qp1 < 0 || m1 <= kNegInf * 0.5f;
    inv0 = dead0 ? 0.f : 1.f / l0;
    inv1 = dead1 ? 0.f : 1.f / l1;
    if (write_lse && (lane & 3) == 0) {
      const long long bh = static_cast<long long>(b) * p.H + h;
      if (ok0)
        p.lse[(bh * p.G + g0) * p.S + s0] =
            dead0 ? kNegInf : m0 * p.scale + logf(l0);
      if (ok1)
        p.lse[(bh * p.G + g1) * p.S + s1] =
            dead1 ? kNegInf : m1 * p.scale + logf(l1);
    }
  }
};

// ---------------------------------------------------------------------------
// The fp32 route: the bf16 route's block, with every product in three exact
// bf16 parts (the numerics above).
// ---------------------------------------------------------------------------
// q rows a block, kv rows a tile, and whether the two warpgroups split D
// (both take the block's 64 rows: three of the six pairs of S each, then
// half of O's columns each, so o is D / 4 registers a thread, not D / 2),
// by head dim: the one place these are set (kernel.py FP32_PREFILL_TILES
// restates rows and tile; a card test compares)
template <int D> struct F32Tiles;
template <> struct F32Tiles<64> {
  static constexpr int kRows = 128, kBK = 128;
  static constexpr bool kSplitD = false;
};
template <> struct F32Tiles<128> {
  static constexpr int kRows = 128, kBK = 64;
  static constexpr bool kSplitD = false;
};
// D 80 and 112 take D 128's tiles and shared memory: every operand padded
// to 128 columns (pad64), the padding zeros that no product reads
template <> struct F32Tiles<80> : F32Tiles<128> {};
template <> struct F32Tiles<112> : F32Tiles<128> {};
template <> struct F32Tiles<256> {
  static constexpr int kRows = 64, kBK = 32;
  static constexpr bool kSplitD = true;
};

template <int D>
struct F32Smem {
  static constexpr int kR = F32Tiles<D>::kRows, BK = F32Tiles<D>::kBK;
  static constexpr bool kSplitD = F32Tiles<D>::kSplitD;
  static constexpr int kDP = pad64(D);         // a bf16 part's row width
  static constexpr int kD32 = (D + 31) / 32 * 32;  // an fp32 row's (TMA boxes)
  static constexpr int kQPart = kR * kDP * 2;  // one bf16 part of q
  static constexpr int kPart = BK * kDP * 2;   // one bf16 part of a tile
  static constexpr int kQ = 0;                 // q's three parts
  static constexpr int kK = 3 * kQPart;        // K's three parts (first q's
  static constexpr int kV = kK + 3 * kPart;    // fp32 rows), then V's
  static constexpr int kKpos = kV + 3 * kPart;         // 2 x BK positions
  static constexpr int kFlags = kKpos + 2 * BK * 4;    // kScanTiles
  static constexpr int kBars = kFlags + kScanTiles;    // K's and V's mbarrier
  static constexpr int kX = kBars + 16;                // split D: S halves
  static constexpr int kBytes = kX + (kSplitD ? 2 * 128 * (BK / 2) * 4 : 0);
  static constexpr size_t kSmem = kBytes + 1024;  // slack to align the base
  static_assert(kR == (kSplitD ? 64 : 128) && (BK == 32 || BK % 64 == 0) &&
                    D % 16 == 0 && (!kSplitD || D % 128 == 0),
                "tiles");
  static_assert(kR * kD32 * 4 <= 6 * kPart,
                "q's fp32 rows fit K's and V's parts");
  static_assert(kQPart % 1024 == 0 && kPart % 1024 == 0,
                "1024-byte aligned regions");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// q's ROWS fp32 rows as the Tensor Memory Accelerator writes them with the
// 128-byte swizzle: 32-column blocks of 128-byte rows, block cb at
// cb * ROWS * 128, 16-byte chunk c of row r at (c ^ (r & 7)). Byte offset
// of chunk c (0 .. D / 4 - 1) of row r.
template <int ROWS>
__device__ __forceinline__ int f32_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

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
// box (c0, .., c4) of a 5-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(bar)
      : "memory");
}

// The pairs (i, j), i + j <= 2, of the fp32 route's products, smallest
// first: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0).
__device__ __forceinline__ int pair_a(int n) {
  return n == 0 ? 2 : (n == 1 || n == 3) ? 1 : 0;
}
__device__ __forceinline__ int pair_b(int n) {
  return n == 2 ? 2 : (n == 1 || n == 4) ? 1 : 0;
}

// Eight fp32 values -> their three bf16 parts, one 16-byte chunk each, at
// dst, dst + part and dst + 2 part (bytes; shared or global memory)
__device__ __forceinline__ void split8(unsigned char* dst, long long part,
                                       float4 a, float4 b) {
  uint4 x0, x1, x2;
  split_pair(a.x, a.y, x0.x, x1.x, x2.x);
  split_pair(a.z, a.w, x0.y, x1.y, x2.y);
  split_pair(b.x, b.y, x0.z, x1.z, x2.z);
  split_pair(b.z, b.w, x0.w, x1.w, x2.w);
  *reinterpret_cast<uint4*>(dst) = x0;
  *reinterpret_cast<uint4*>(dst + part) = x1;
  *reinterpret_cast<uint4*>(dst + 2 * part) = x2;
}

// Ask the Tensor Memory Accelerator for the three bf16 parts of tile j
// (kv rows j * BK .., zeros past T) of kv head h of batch row b of K
// (op 0) or V (op 1) from the parts map m, into dst in the swizzled K-major
// layout wgmma reads (a box is a 64-column block of a part; zeros past D,
// which a box of D 80 or 112 counts in full), counted on mbarrier bar.
// Thread 0 alone calls it.
template <int D, int BK>
__device__ __forceinline__ void load_parts(const CUtensorMap* m, int op,
                                           int b, int h, int j, uint32_t dst,
                                           uint32_t bar) {
  constexpr int kDP = pad64(D);
  mbar_expect_tx(bar, 3 * BK * kDP * 2);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int cb = 0; cb < kDP / 64; ++cb)
      tma_load_5d(dst + part * (BK * kDP * 2) + cb * (BK * 128), m, cb * 64,
                  j * BK, h, b, 3 * op + part, bar);
}

// Split q's ROWS fp32 rows at f32 (f32_off's layout) into their three bf16
// part tiles at parts (the swizzled K-major layout), eight floats a thread
// at a time: eight neighbouring threads take one chunk of eight rows.
template <int D, int ROWS>
__device__ __forceinline__ void split_tile(unsigned char* sm, int f32,
                                           int parts) {
#pragma unroll 2
  for (int idx = threadIdx.x; idx < ROWS * (D / 8); idx += kThreads) {
    const int r = idx % ROWS, c = idx / ROWS;
    const unsigned char* t = sm + f32;
    split8(sm + parts + swz(ROWS, r, c), ROWS * pad64(D) * 2,
           *reinterpret_cast<const float4*>(t + f32_off<ROWS>(r, 2 * c)),
           *reinterpret_cast<const float4*>(t + f32_off<ROWS>(r, 2 * c + 1)));
  }
}

// K and V (B, Hkv, T, D) fp32 by element strides -> their three bf16 parts,
// parts (6, B, Hkv, T, D) contiguous: K's x0 x1 x2, then V's. Once per
// call, so that no block of the product splits a K/V row again. Block
// (x, h, 2 b + op) takes eight values a thread, kThreads / (D / 8) rows of
// kv head h of batch row b of K (op 0) or V (op 1).
template <int D>
__global__ void __launch_bounds__(kThreads)
split_kv_parts(const ParamsT<float> p, bf16* parts) {
  // the product may start its blocks now: they read no part before their
  // griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kC = D / 8;                    // 8-value chunks of a row
  const int h = blockIdx.y, b = blockIdx.z >> 1, op = blockIdx.z & 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int t = i / kC, c = i % kC;
  if (t >= p.T) return;
  const float* src =
      op == 0 ? p.k + b * p.ks_b + h * p.ks_h + t * p.ks_t
              : p.v + b * p.vs_b + h * p.vs_h + t * p.vs_t;
  const float4* s4 = reinterpret_cast<const float4*>(src + 8 * c);
  const long long part = static_cast<long long>(p.B) * p.H * p.T * D;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.T + t;
  split8(reinterpret_cast<unsigned char*>(parts + 3 * op * part + row * D +
                                          8 * c),
         2 * part, __ldg(s4), __ldg(s4 + 1));
}

// One block of two warpgroups: F32Tiles rows of q (prefill_plan with that
// many rows) of kv head blockIdx.y of batch row blockIdx.z against every
// live kv tile. q's fp32 rows land in K's and V's part tiles and are split
// into q's parts first; then, per tile, S over the six pairs while V's
// parts land, and O over the six pairs while the next K's parts land.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_f32_kernel(const ParamsT<float> p,
                         const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mkv) {
  using L = F32Smem<D>;
  constexpr int BK = L::BK, kR = L::kR;
  constexpr bool kSplit = L::kSplitD;
  constexpr int DO = kSplit ? D / 2 : D;       // o's columns a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const int* const kps = reinterpret_cast<const int*>(sm + L::kKpos);
  uint8_t* const flags = sm + L::kFlags;
  const uint32_t bar_k = base + L::kBars, bar_v = bar_k + 8;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wq = (tid >> 5) & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nq = static_cast<int>(gridDim.x) / p.groups;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / p.groups;
  const int gg = blockIdx.x % p.groups;
  const int nt = (p.T + BK - 1) / BK;
  const int* kpos_b = p.kpos + static_cast<long long>(b) * p.T;
  const int* qpos_b = p.qpos + static_cast<long long>(b) * p.S;

  // q's fp32 rows into K's and V's part tiles by the Tensor Memory
  // Accelerator (a box of GG heads x BQ positions a 32-column block; zeros
  // past G and S, rows past GG * BQ left as they are: no row of the plan
  // reads them), counted on K's barrier, while the kv tiles are
  // classified; then split into q's three parts
  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_k, p.GG * p.BQ * L::kD32 * 4);
#pragma unroll
    for (int cb = 0; cb < L::kD32 / 32; ++cb)
      tma_load_5d(base + L::kK + cb * (kR * 128), &mq, cb * 32, qt * p.BQ,
                  gg * p.GG, h, b, bar_k);
  }
  __syncthreads();               // the barriers are initialised
  int qmin, qmax;
  q_range(p, qpos_b, qt, qmin, qmax);
  int c0 = 0;
  scan_tiles<BK>(p, kpos_b, 0, nt, qmin, qmax, flags);
  mbar_wait(bar_k, 0);
  __syncthreads();
  int j = next_live<BK>(p, kpos_b, 0, nt, qmin, qmax, flags, c0);
  split_tile<D, kR>(sm, L::kK, L::kQ);
  fence_proxy_async();
  __syncthreads();               // q's fp32 rows are split
  // K's and V's parts are written by split_kv_parts, which may still run
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // the first live tile's parts of K (with its positions) and V
  uint32_t ph_k = 1, ph_v = 0;   // the phases the barriers complete next
  if (j < nt) {
    if (tid == 0) {
      load_parts<D, BK>(&mkv, 0, b, h, j, base + L::kK, bar_k);
      load_parts<D, BK>(&mkv, 1, b, h, j, base + L::kV, bar_v);
    }
    load_kpos<BK>(kpos_b, p.T, j, base + L::kKpos);
  }
  cp_async_commit();

  // split D: both warpgroups take rows 0 .. 63, warpgroup wg the pairs
  // 3 wg .. 3 wg + 2 of S and O's columns wg * D / 2 ..
  const int r0 = (kSplit ? 0 : wg * 64) + wq * 16 + (lane >> 2);
  RowPair rows(p, qpos_b, r0, qt, gg);
  const int n_lo = kSplit ? 3 * wg : 0, n_hi = kSplit ? n_lo + 3 : 6;
  const int dd0 = kSplit ? wg * (DO / 64) : 0;
  float* const x = reinterpret_cast<float*>(sm + L::kX);

  float o[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] = 0.f;
  const uint32_t a_q = base + L::kQ + (kSplit ? 0 : wg * (64 * 128));
  const uint32_t sK = base + L::kK, sV = base + L::kV;

  int st = 0;
  while (j < nt) {
    const bool full = flags[j - c0] & kFull;
    const int jn = next_live<BK>(p, kpos_b, j + 1, nt, qmin, qmax, flags,
                                 c0);
    cp_async_wait<0>();          // this thread's copies of tile j's positions
    mbar_wait(bar_k, ph_k);      // K's parts of tile j
    ph_k ^= 1;

    // S = sum over the pairs of Q_i K_j^T (64 x BK per warpgroup); the
    // warpgroup's first product overwrites s
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      if (n < n_lo || n >= n_hi) continue;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = desc_k(a_q + pair_a(n) * L::kQPart +
                                   (kk >> 2) * (kR * 128) + (kk & 3) * 32);
        const uint32_t b0 = sK + pair_b(n) * L::kPart +
                            (kk >> 2) * (BK * 128) + (kk & 3) * 32;
        if constexpr (BK == 32) {
          wgmma_ss_n32(s, da, desc_k(b0), n > n_lo || kk > 0);
        } else {
#pragma unroll
          for (int nb = 0; nb < BK / 64; ++nb)     // 64 kv rows at a time
            wgmma_ss(&s[32 * nb], da, desc_k(b0 + nb * (64 * 128)),
                     n > n_lo || kk > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    if constexpr (kSplit) {      // each warpgroup adds the other's half
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        x[(wg * (BK / 2) + i) * 128 + (tid & 127)] = s[i];
    }
    // every warpgroup is done with K's parts, and tile j's positions are in
    __syncthreads();
    if (jn < nt) {
      if (tid == 0) load_parts<D, BK>(&mkv, 0, b, h, jn, sK, bar_k);
      load_kpos<BK>(kpos_b, p.T, jn, base + L::kKpos + (st ^ 1) * BK * 4);
    }
    cp_async_commit();
    if constexpr (kSplit) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] += x[((wg ^ 1) * (BK / 2) + i) * 128 + (tid & 127)];
    }

    float alpha0, alpha1;
    rows.softmax<BK>(p, s, kps + st * BK, full, alpha0, alpha1);

    // p's three parts, straight into the A fragments of the second
    // product: k-slice kk holds columns 16 kk .. 16 kk + 15
    uint32_t pa[3][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_pair(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], pa[0][kk][e],
                   pa[1][kk][e], pa[2][kk][e]);
#pragma unroll
    for (int I = 0; I < DO / 8; ++I) {
      o[4 * I] *= alpha0;
      o[4 * I + 1] *= alpha0;
      o[4 * I + 2] *= alpha1;
      o[4 * I + 3] *= alpha1;
    }

    // O += sum over the six pairs of P_i V_j (64 x DO per warpgroup, 64
    // columns per instruction; at D 80 and 112 one of N = D), once V's
    // parts of tile j are in
    mbar_wait(bar_v, ph_v);
    ph_v ^= 1;
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const uint32_t v = sV + pair_b(n) * L::kPart;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D % 64 == 0) {
#pragma unroll
          for (int dd = 0; dd < DO / 64; ++dd)
            wgmma_rs(&o[32 * dd], pa[pair_a(n)][kk],
                     desc_mn(v + (dd0 + dd) * (BK * 128) + kk * (16 * 128)));
        } else {
          wgmma_rs_n<D>(o, pa[pair_a(n)][kk],
                        desc_sw128(v + kk * (16 * 128), BK * 128, 1024));
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    reg_fence(pa);
    __syncthreads();             // every warpgroup is done with V's parts
    if (jn < nt && tid == 0) load_parts<D, BK>(&mkv, 1, b, h, jn, sV, bar_v);

    j = jn;
    st ^= 1;
  }
  cp_async_wait<0>();            // the empty groups of the last tile

  // epilogue: out = O / l, straight from the accumulators (four lanes
  // write a row's 32 contiguous bytes of each 8-column slice); with D
  // split, warpgroup 0 writes lse
  float inv0, inv1;
  rows.finish(p, b, h, inv0, inv1, !kSplit || wg == 0);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int cb = dd0 * 64 + 2 * (lane & 3);
  if (rows.ok0) {
    float* orow = p.out + ((bh * p.G + rows.g0) * p.S + rows.s0) * D + cb;
#pragma unroll
    for (int I = 0; I < DO / 8; ++I)
      *reinterpret_cast<float2*>(orow + 8 * I) =
          make_float2(o[4 * I] * inv0, o[4 * I + 1] * inv0);
  }
  if (rows.ok1) {
    float* orow = p.out + ((bh * p.G + rows.g1) * p.S + rows.s1) * D + cb;
#pragma unroll
    for (int I = 0; I < DO / 8; ++I)
      *reinterpret_cast<float2*>(orow + 8 * I) =
          make_float2(o[4 * I + 2] * inv1, o[4 * I + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// The bf16 route (flash_prefill.cu's design note): rows unpadded, as column
// blocks of 64, 32 and 16 columns in the swizzle of their width; one
// producer warp feeds q and the live K/V tiles by TMA into an mbarrier
// ring, and two consumer warpgroups take turns on the tensor cores.
// ---------------------------------------------------------------------------
namespace tma {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 24;

// A row of D columns as D / 64 blocks of 64 columns, then one of 32 and one
// of 16 where D needs them (D 80: 64 + 16; D 112: 64 + 32 + 16; D 256: four
// of 64): block b's width, first column, and the block of column c. A
// block's rows are 128, 64 or 32 bytes, swizzled at that width.
__host__ __device__ constexpr int n_blocks(int d) {
  return d / 64 + (d % 64 >= 32) + (d % 32 >= 16);
}
__host__ __device__ constexpr int blk_cols(int d, int b) {
  return b < d / 64 ? 64 : (b == d / 64 && d % 64 >= 32) ? 32 : 16;
}
__host__ __device__ constexpr int blk_start(int d, int b) {
  return b <= d / 64 ? 64 * b : 64 * (d / 64) + 32;
}
__host__ __device__ constexpr int blk_of(int d, int c) {
  return c < 64 * (d / 64) ? c / 64
         : (d % 64 >= 32 && c >= 64 * (d / 64) + 32) ? d / 64 + 1
                                                      : d / 64;
}
constexpr int kMaxBlocks = 4;    // D 256

// Consumer registers a thread once the producer warpgroup has given its up
// (setmaxnreg works a warpgroup at a time): 168 at launch at one block an
// SM, 80 at two (65,536 / (MINB x 384), in steps of 8); 128 x 24 + 256 x
// 240 = 384 x 168 and 128 x 24 + 256 x 104 <= 384 x 80.
template <int MINB>
__host__ __device__ constexpr int consumer_regs() {
  return MINB == 1 ? 240 : 104;
}

// Shared memory of a block (byte offsets from its 1024-aligned base): q's
// 128 rows, NS stages of a K and a V tile of BK rows, each operand as its
// column blocks one after another (block b of an R-row operand at R * 2 *
// blk_start(b), a row of it 2 * blk_cols(b) bytes); the stages' kv
// positions and headers ({tile, flags}, tile -1: no more tiles); q's
// mbarrier, then a full-K, a full-V and an empty mbarrier a stage.
template <int D, int BK, int NS>
struct Smem {
  static constexpr int kQ = 0;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTile = BK * D * 2;              // one K or V tile
  static constexpr int kKV = kQBytes;                   // stage s: K, then V
  static constexpr int kKpos = kKV + NS * 2 * kTile;    // NS x BK positions
  static constexpr int kHdr = kKpos + NS * BK * 4;      // NS x {tile, flags}
  static constexpr int kBars = kHdr + NS * 8;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * NS);
  static constexpr size_t kSmem = kBytes + 1024;   // slack to align the base
  static_assert(D % 16 == 0 && D >= 64 && n_blocks(D) <= kMaxBlocks &&
                    (BK == 32 || BK % 64 == 0), "tiles");
  static_assert(kQBytes % 1024 == 0 && kTile % 1024 == 0,
                "1024-byte aligned regions");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// q's, K's, V's and out's tensor maps, one a column block
struct Maps {
  CUtensorMap q[kMaxBlocks], k[kMaxBlocks], v[kMaxBlocks], o[kMaxBlocks];
};

// Byte offset of 16-byte chunk c of row r in a column block whose rows are
// row_bytes long, in the swizzle of that width (the layout TMA writes and
// wgmma reads: chunk bits ^= the row bits above 128 bytes)
__device__ __forceinline__ uint32_t swz_rows(int r, int c, int row_bytes) {
  const int x = row_bytes == 128 ? (r & 7) : row_bytes == 64 ? ((r >> 1) & 3)
                                                             : ((r >> 2) & 1);
  return r * row_bytes + ((c ^ x) << 4);
}
// box (c0, .., c4) of shared memory at src to a 5-D tensor map's tensor
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3, %4, %5}], [%6];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(src)
      : "memory");
}

// wgmma shared-memory descriptor of an operand whose rows are row_bytes
// (128, 64 or 32) long in the swizzle of that width: 8-row groups 8 *
// row_bytes apart (K-major: along M or N; MN-major: along K); the other
// offset spans a whole atom, which no product here steps past
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  const uint64_t group = static_cast<uint64_t>(8 * row_bytes) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (group << 16) |
         (group << 32) | (layout << 62);
}

#define ACC8(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7])
#define REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

// d (64 x W fp32, W / 2 per thread) += A (64 x 16 bf16, registers) * B
// (16 x W, shared, MN-major: the transpose bit), W = 64, 32 or 16
template <int W>
__device__ __forceinline__ void wgmma_rs_w(float* d, const uint32_t (&a)[4],
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_w<64>(float* d,
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  wgmma_rs(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs_w<32>(float* d,
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
template <>
__device__ __forceinline__ void wgmma_rs_w<16>(float* d,
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REGS8
      ", {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O's columns of block CB += P (k-slice kk of the tile, registers) times
// V's rows 16 kk .. 16 kk + 15 of that block
template <int D, int BK, int CB>
__device__ __forceinline__ void pv_block(float* o, const uint32_t (&a)[4],
                                         uint32_t sV, int kk) {
  constexpr int W = blk_cols(D, CB), RB = 2 * W;
  wgmma_rs_w<W>(o + blk_start(D, CB) / 2, a,
                desc_rows(sV + BK * 2 * blk_start(D, CB) + kk * 16 * RB, RB));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// box (c0, .., c3) of a 4-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}
// the consumer warpgroups' turns on the tensor cores: named barrier 1 + c
// is warpgroup c's turn; it syncs on its own and arrives on the other's
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(kConsumers)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(kConsumers)
               : "memory");
}

// expect tx bytes more on the barrier's current phase, without arriving
__device__ __forceinline__ void mbar_expect_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// The producer warp: q's tile and the first K/V tile at once, then every
// other live K/V tile of the block in kv order into the ring (a tile in
// which no pair can be visible is neither loaded nor computed: scan_tiles'
// rule, from the positions it stages), then a header of -1. The first tile
// goes before its positions are read (it is live but where every q or kv
// position is masked, and then the consumers compute it fully masked, to
// the same result), so that the block's first product waits one load, not
// three.
template <int D, int BK, int NS>
__device__ __forceinline__ void produce(const Params& p, const Maps& maps,
                                        unsigned char* sm, uint32_t base,
                                        int b, int h, int qt, int gg) {
  using L = Smem<D, BK, NS>;
  constexpr int NB = n_blocks(D), kPer = BK / 32;
  const int lane = threadIdx.x & 31;
  int* const kps = reinterpret_cast<int*>(sm + L::kKpos);
  int* const hdr = reinterpret_cast<int*>(sm + L::kHdr);
  const uint32_t bar_q = base + L::kBars;
  const int* kpos_b = p.kpos + static_cast<long long>(b) * p.T;
  const int nt = (p.T + BK - 1) / BK;
  // K's and V's tile j into stage st, by lane 0: the bytes counted on the
  // stage's full-K (no arrival: the lanes arrive once the positions are
  // stored) and full-V barriers
  auto issue = [&](int j, int st) {
    const uint32_t sK = base + L::kKV + st * 2 * L::kTile;
    const uint32_t full_k = bar_q + 8 * (1 + st);
    const uint32_t full_v = bar_q + 8 * (1 + NS + st);
    mbar_expect_only(full_k, L::kTile);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      tma_load_4d(sK + BK * 2 * blk_start(D, cb), &maps.k[cb],
                  blk_start(D, cb), j * BK, h, b, full_k);
    mbar_expect_tx(full_v, L::kTile);          // lane 0's arrival on it
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      tma_load_4d(sK + L::kTile + BK * 2 * blk_start(D, cb), &maps.v[cb],
                  blk_start(D, cb), j * BK, h, b, full_v);
  };
  if (lane == 0) {
    mbar_expect_tx(bar_q, p.GG * p.BQ * D * 2);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      tma_load_5d(base + L::kQ + kRows * 2 * blk_start(D, cb), &maps.q[cb],
                  blk_start(D, cb), qt * p.BQ, gg * p.GG, h, b, bar_q);
    if (nt > 0) issue(0, 0);
  }
  int nxt[kPer];
  auto fetch = [&](int j) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = j * BK + lane + 32 * i;
      nxt[i] = t < p.T ? kpos_b[t] : -1;
    }
  };
  if (nt > 0) fetch(0);          // in flight with q_range's loads
  int qmin, qmax;
  q_range(p, p.qpos + static_cast<long long>(b) * p.S, qt, qmin, qmax);
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < nt; ++j) {
    int cur[kPer];
    int kmin = 0x7fffffff, kmax = -1;
    bool hole = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      cur[i] = nxt[i];
      if (cur[i] >= 0) {
        kmin = min(kmin, cur[i]);
        kmax = max(kmax, cur[i]);
      } else {
        hole = true;
      }
    }
    if (j + 1 < nt) fetch(j + 1);    // the next tile's positions in flight
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    hole = __any_sync(0xffffffffu, hole);
    const bool live = kmax >= 0 && qmax >= 0 && !(p.causal && kmin > qmax) &&
                      !(p.window > 0 && kmax <= qmin - p.window);
    const bool full = live && !hole && (!p.causal || kmax <= qmin) &&
                      (p.window <= 0 || kmin > qmax - p.window);
    if (j > 0) {
      if (!live) continue;
      mbar_wait(bar_q + 8 * (1 + 2 * NS + st), ph ^ 1);   // stage st is free
      if (lane == 0) issue(j, st);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) kps[st * BK + lane + 32 * i] = cur[i];
    if (lane == 0) {
      hdr[2 * st] = j;
      hdr[2 * st + 1] = full ? kFull : 0;
    }
    mbar_arrive(bar_q + 8 * (1 + st));   // after this lane's stores
    if (++st == NS) {
      st = 0;
      ph ^= 1;
    }
  }
  mbar_wait(bar_q + 8 * (1 + 2 * NS + st), ph ^ 1);
  if (lane == 0) hdr[2 * st] = -1;
  mbar_arrive(bar_q + 8 * (1 + st));
}

// A consumer warpgroup c: 64 of the block's rows against every tile the
// producer stages. Per tile: its turn for S = Q K^T, the softmax while the
// other warpgroup takes its turn, then its turn for O += P V. Then out = O
// / l into its rows of q's region, and the block's tile by TMA stores.
template <int D, int BK, int NS>
__device__ __forceinline__ void consume(const Params& p, const Maps& maps,
                                        unsigned char* sm, uint32_t base,
                                        int b, int h, int qt, int gg) {
  using L = Smem<D, BK, NS>;
  constexpr int NB = n_blocks(D);
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = tid >> 7, wq = (tid >> 5) & 3;
  const int* const kps = reinterpret_cast<const int*>(sm + L::kKpos);
  const int* const hdr = reinterpret_cast<const int*>(sm + L::kHdr);
  const uint32_t bar_q = base + L::kBars;
  const int r0 = c * 64 + wq * 16 + (lane >> 2);
  RowPair rows(p, p.qpos + static_cast<long long>(b) * p.S, r0, qt, gg);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  if (c == 1) turn_pass(c);      // warpgroup 0 takes the first turn
  mbar_wait(bar_q, 0);

  int st = 0;
  uint32_t ph = 0;
  for (;;) {
    mbar_wait(bar_q + 8 * (1 + st), ph);         // K and the header
    if (hdr[2 * st] < 0) break;
    const bool full = hdr[2 * st + 1] & kFull;
    const uint32_t sK = base + L::kKV + st * 2 * L::kTile;
    const uint32_t sV = sK + L::kTile;

    // S = Q K^T (64 x BK), k-slices of 16 columns through the column
    // blocks; the first overwrites s
    float s[BK / 2];
    turn_wait(c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = blk_of(D, 16 * kk), rb = 2 * blk_cols(D, cb);
      const int off = (16 * kk - blk_start(D, cb)) * 2;
      const uint64_t da = desc_rows(base + L::kQ + kRows * 2 * blk_start(D, cb)
                                        + c * 64 * rb + off, rb);
      const uint32_t kb = sK + BK * 2 * blk_start(D, cb) + off;
      if constexpr (BK == 32) {
        wgmma_ss_n32(s, da, desc_rows(kb, rb), kk > 0);
      } else {
#pragma unroll
        for (int n = 0; n < BK / 64; ++n)
          wgmma_ss(&s[32 * n], da, desc_rows(kb + n * 64 * rb, rb), kk > 0);
      }
    }
    wgmma_commit();
    turn_pass(c);
    wgmma_wait_all();
    reg_fence(s);

    float alpha0, alpha1;
    rows.softmax<BK>(p, s, kps + st * BK, full, alpha0, alpha1);
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int I = 0; I < D / 8; ++I) {
      o[4 * I] *= alpha0;
      o[4 * I + 1] *= alpha0;
      o[4 * I + 2] *= alpha1;
      o[4 * I + 3] *= alpha1;
    }

    // O += P V, a product a column block (n64, n32, n16)
    mbar_wait(bar_q + 8 * (1 + NS + st), ph);    // V
    turn_wait(c);
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pv_block<D, BK, 0>(o, pa[kk], sV, kk);
      if constexpr (NB > 1) pv_block<D, BK, 1>(o, pa[kk], sV, kk);
      if constexpr (NB > 2) pv_block<D, BK, 2>(o, pa[kk], sV, kk);
      if constexpr (NB > 3) pv_block<D, BK, 3>(o, pa[kk], sV, kk);
    }
    wgmma_commit();
    turn_pass(c);
    wgmma_wait_all();
    reg_fence(o);
    reg_fence(pa);
    mbar_arrive(bar_q + 8 * (1 + 2 * NS + st));  // stage st is free
    if (++st == NS) {
      st = 0;
      ph ^= 1;
    }
  }
  if (c == 0) turn_wait(c);      // warpgroup 1's last turn passed to it

  // epilogue: out = O / l into this warpgroup's rows of q's region (its
  // products are done), as q lies there (column blocks, swizzled), then
  // the block's GG x BQ rows to out by TMA, a box a column block, in the
  // model's (B, S, Hkv, G, D) order (rows past S or G fall outside the
  // map and are not written), so that no transpose follows
  float inv0, inv1;
  rows.finish(p, b, h, inv0, inv1);
#pragma unroll
  for (int I = 0; I < D / 8; ++I) {
    const int cb = blk_of(D, 8 * I), rb = 2 * blk_cols(D, cb);
    const int ch = (8 * I - blk_start(D, cb)) / 8;
    unsigned char* blk = sm + L::kQ + kRows * 2 * blk_start(D, cb) +
                         4 * (lane & 3);
    *reinterpret_cast<uint32_t*>(blk + swz_rows(r0, ch, rb)) =
        pack_bf16(o[4 * I] * inv0, o[4 * I + 1] * inv0);
    *reinterpret_cast<uint32_t*>(blk + swz_rows(r0 + 8, ch, rb)) =
        pack_bf16(o[4 * I + 2] * inv1, o[4 * I + 3] * inv1);
  }
  fence_proxy_async();           // the stores, before TMA reads them
  asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers) : "memory");
  if (threadIdx.x == 0) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      tma_store_5d(&maps.o[cb], base + L::kQ + kRows * 2 * blk_start(D, cb),
                   blk_start(D, cb), qt * p.BQ, gg * p.GG, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// One block: kRows query rows (prefill_plan; the q tiles in reverse, as
// the other bf16 kernel) of kv head blockIdx.y of batch row blockIdx.z.
// Warps 0-7 are the consumer warpgroups, warps 8-11 the producer
// warpgroup, of which warp 8 works and the others give up their registers
// and end; the roles part after the barriers are set up and never meet
// again.
template <int D, int BK, int NS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_prefill_kernel(const Params p, const __grid_constant__ Maps maps) {
  using L = Smem<D, BK, NS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int nq = static_cast<int>(gridDim.x) / p.groups;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / p.groups;
  const int gg = blockIdx.x % p.groups;
  if (threadIdx.x == 0) {
    const uint32_t bar_q = base + L::kBars;
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_q + 8 * (1 + s), 32);               // full K
      mbar_init(bar_q + 8 * (1 + NS + s), 1);           // full V
      mbar_init(bar_q + 8 * (1 + 2 * NS + s), kConsumers);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < kConsumers + 32)
      produce<D, BK, NS>(p, maps, sm, base, b, h, qt, gg);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs<MINB>()));
    consume<D, BK, NS>(p, maps, sm, base, b, h, qt, gg);
  }
}

}  // namespace tma

// Allow a kernel the dynamic shared memory it asks for, once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) ready = true;
  return e;
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no link
// against libcuda)
inline PFN_cuTensorMapEncodeTiled encoder() {
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

// An operand of `rank` dimensions (dims[0] innermost and contiguous,
// strides[i] in elements for dims 1 ..) of esize-byte elements as a map
// with boxes of box[0] x box[1] x .., swizzled (128 bytes unless asked
// otherwise), zeros outside; a dimension of extent 1 gets a packed stride,
// which no coordinate uses.
inline cudaError_t make_map(CUtensorMap* m, CUtensorMapDataType type, int esize,
                     const void* ptr, int rank, const long long* dims,
                     const long long* strides, const int* box,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  auto enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estr[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
    estr[i] = 1;
  }
  long long packed = dims[0] * esize;
  for (int i = 1; i < rank; ++i) {
    gstride[i - 1] = static_cast<cuuint64_t>(
        dims[i] == 1 ? packed : strides[i - 1] * esize);
    packed = static_cast<long long>(gstride[i - 1]) * dims[i];
  }
  const CUresult r = enc(m, type, rank, const_cast<void*>(ptr), gdim, gstride,
                         gbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The fp32 route: K and V split into their parts (parts: (6, B, Hkv, T, D)
// bf16 scratch), q and the parts as tensor maps (q's box: GG heads x BQ
// positions of 32 columns; the parts': a kv tile of 64 columns of a
// part), then the product.
template <int D>
cudaError_t launch_f32(const ParamsT<float>& p, void* parts, int blocks,
                       cudaStream_t st) {
  using L = F32Smem<D>;
  static bool ready = false;
  CUtensorMap mq{}, mkv{};
  const long long qd[5] = {D, p.S, p.G, p.H, p.B};
  const long long qs[4] = {p.qs_s, p.qs_g, p.qs_h, p.qs_b};
  const int qbox[5] = {32, p.BQ, p.GG, 1, 1};
  cudaError_t e = make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.q, 5,
                           qd, qs, qbox);
  if (e != cudaSuccess) return e;
  if (p.T > 0) {
    const long long rows = static_cast<long long>(p.B) * p.H * p.T;
    const dim3 grid((p.T * (D / 8) + kThreads - 1) / kThreads, p.H, 2 * p.B);
    split_kv_parts<D><<<grid, kThreads, 0, st>>>(p, static_cast<bf16*>(parts));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long kd[5] = {D, p.T, p.H, p.B, 6};
    const long long ks[4] = {D, static_cast<long long>(p.T) * D,
                             static_cast<long long>(p.H) * p.T * D, rows * D};
    const int kbox[5] = {64, L::BK, 1, 1, 1};
    e = make_map(&mkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, parts, 5, kd, ks,
                 kbox);
    if (e != cudaSuccess) return e;
  }
  e = allow_smem(flash_prefill_f32_kernel<D>, L::kSmem, ready);
  if (e != cudaSuccess) return e;
  // launched as split_kv_parts' programmatic dependent: its blocks load
  // and split q while the pre-pass finishes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, p.H, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.T > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, flash_prefill_f32_kernel<D>, p, mq, mkv);
}

// The bf16 route: q, K, V and out as tensor maps a column block (boxes of
// the block's width: q's and out's GG heads x BQ positions, K's and V's a
// kv tile), then the warp-specialised kernel.
template <int D, int BK, int NS, int MINB>
cudaError_t launch_bf16(const Params& p, int blocks, cudaStream_t st) {
  using L = tma::Smem<D, BK, NS>;
  static bool ready = false;
  tma::Maps m{};
  for (int cb = 0; cb < tma::n_blocks(D); ++cb) {
    const int w = tma::blk_cols(D, cb);
    const CUtensorMapSwizzle sw = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
    const long long qd[5] = {D, p.S, p.G, p.H, p.B};
    const long long qs[4] = {p.qs_s, p.qs_g, p.qs_h, p.qs_b};
    const int qbox[5] = {w, p.BQ, p.GG, 1, 1};
    cudaError_t e = make_map(&m.q[cb], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             p.q, 5, qd, qs, qbox, sw);
    // out (B, S, Hkv, G, D) contiguous, with q's boxes
    const long long os[4] = {static_cast<long long>(p.H) * p.G * D, D,
                             static_cast<long long>(p.G) * D,
                             static_cast<long long>(p.S) * p.H * p.G * D};
    if (e == cudaSuccess)
      e = make_map(&m.o[cb], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.out, 5,
                   qd, os, qbox, sw);
    if (e != cudaSuccess || p.T == 0) {
      if (e != cudaSuccess) return e;
      continue;
    }
    const long long kd[4] = {D, p.T, p.H, p.B};
    const long long ks[3] = {p.ks_t, p.ks_h, p.ks_b};
    const long long vs[3] = {p.vs_t, p.vs_h, p.vs_b};
    const int kbox[4] = {w, BK, 1, 1};
    e = make_map(&m.k[cb], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.k, 4, kd,
                 ks, kbox, sw);
    if (e == cudaSuccess)
      e = make_map(&m.v[cb], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.v, 4, kd,
                   vs, kbox, sw);
    if (e != cudaSuccess) return e;
  }
  const auto kernel = tma::flash_prefill_kernel<D, BK, NS, MINB>;
  const cudaError_t e = allow_smem(kernel, L::kSmem, ready);
  if (e != cudaSuccess) return e;
  // the consumers' setmaxnreg.inc waits for the registers the producer
  // gives up: refuse a build whose launch count cannot cover them (it
  // would never return)
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes a;
    const cudaError_t ea = cudaFuncGetAttributes(&a, kernel);
    if (ea != cudaSuccess) return ea;
    regs = a.numRegs;
  }
  if (regs * tma::kThreads < 128 * tma::kProducerRegs +
                                 tma::kConsumers * tma::consumer_regs<MINB>())
    return cudaErrorInvalidConfiguration;
  dim3 grid(blocks, p.H, p.B);
  tma::flash_prefill_kernel<D, BK, NS, MINB>
      <<<grid, tma::kThreads, L::kSmem, st>>>(p, m);
  return cudaGetLastError();
}

// Fill the parameters of either route and check the plan: GG query heads x
// BQ positions, GG * BQ <= rows, in `groups` head groups over `blocks`
// blocks per kv head; refuse one that leaves a (head, position) row
// uncovered, or a block empty.
template <typename E>
bool make_params(ParamsT<E>& p, const void* q, const void* k, const void* v,
                 const void* qpos, const void* kpos, void* out, void* lse,
                 const long long* strides, int B, int H, int G, int S, int T,
                 int GG, int BQ, int groups, int blocks, int rows, int causal,
                 int window, float softcap, float scale) {
  if (GG < 1 || BQ < 1 || GG * BQ > rows || groups < 1 || blocks < 1 ||
      blocks % groups != 0)
    return false;
  const long long nq = blocks / groups;
  if (static_cast<long long>(groups) * GG < G ||
      static_cast<long long>(groups - 1) * GG >= G || nq * BQ < S ||
      (nq - 1) * BQ >= S)
    return false;
  p.q = static_cast<const E*>(q);
  p.k = static_cast<const E*>(k);
  p.v = static_cast<const E*>(v);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.out = static_cast<E*>(out);
  p.lse = static_cast<float*>(lse);
  p.qs_b = strides[0]; p.qs_h = strides[1]; p.qs_g = strides[2];
  p.qs_s = strides[3];
  p.ks_b = strides[4]; p.ks_h = strides[5]; p.ks_t = strides[6];
  p.vs_b = strides[7]; p.vs_h = strides[8]; p.vs_t = strides[9];
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T;
  p.GG = GG; p.BQ = BQ; p.groups = groups;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  return true;
}

// The fp32 route's {q rows a block, kv rows a tile, dynamic shared memory
// bytes} at head dim D
template <int D>
void f32_layout(int* out) {
  out[0] = F32Smem<D>::kR;
  out[1] = F32Smem<D>::BK;
  out[2] = static_cast<int>(F32Smem<D>::kSmem);
}

// The bf16 route's {q rows a block, kv rows a tile, ring stages, dynamic
// shared memory bytes, blocks an SM} at head dim D
template <int D, int BK, int NS, int MINB>
void bf16_layout(int* out) {
  out[0] = kRows;
  out[1] = BK;
  out[2] = NS;
  out[3] = static_cast<int>(tma::Smem<D, BK, NS>::kSmem);
  out[4] = MINB;
}

// The launches at head dim D, one pair a head dim, each defined in
// flash_prefill.d<D>.cu by REPRO_PREFILL_DIM: the bf16 route's kernel (its
// kv tile BK, ring stages and blocks an SM by D), and the fp32 route's,
// with their layouts
cudaError_t prefill_bf16_d64(const Params& p, int blocks, cudaStream_t st);
cudaError_t prefill_f32_d64(const ParamsT<float>& p, void* parts, int blocks,
                            cudaStream_t st);
void f32_layout_d64(int* out);
void bf16_layout_d64(int* out);
void bf16_layout_d80(int* out);
void bf16_layout_d112(int* out);
void bf16_layout_d128(int* out);
void bf16_layout_d256(int* out);
cudaError_t prefill_bf16_d80(const Params& p, int blocks, cudaStream_t st);
cudaError_t prefill_f32_d80(const ParamsT<float>& p, void* parts, int blocks,
                            cudaStream_t st);
void f32_layout_d80(int* out);
cudaError_t prefill_bf16_d112(const Params& p, int blocks, cudaStream_t st);
cudaError_t prefill_f32_d112(const ParamsT<float>& p, void* parts, int blocks,
                             cudaStream_t st);
void f32_layout_d112(int* out);
cudaError_t prefill_bf16_d128(const Params& p, int blocks, cudaStream_t st);
cudaError_t prefill_f32_d128(const ParamsT<float>& p, void* parts, int blocks,
                             cudaStream_t st);
void f32_layout_d128(int* out);
cudaError_t prefill_bf16_d256(const Params& p, int blocks, cudaStream_t st);
cudaError_t prefill_f32_d256(const ParamsT<float>& p, void* parts, int blocks,
                             cudaStream_t st);
void f32_layout_d256(int* out);

// the bf16 route's kernel (kv tiles of BK in a ring of NS stages, MINB
// blocks an SM) and the fp32 route's, with their layouts
#define REPRO_PREFILL_DIM(D, BK, NS, MINB)                                  \
  cudaError_t prefill_bf16_d##D(const Params& p, int blocks,                \
                                cudaStream_t st) {                          \
    return launch_bf16<D, BK, NS, MINB>(p, blocks, st);                     \
  }                                                                         \
  void bf16_layout_d##D(int* out) { bf16_layout<D, BK, NS, MINB>(out); }    \
  cudaError_t prefill_f32_d##D(const ParamsT<float>& p, void* parts,        \
                               int blocks, cudaStream_t st) {               \
    return launch_f32<D>(p, parts, blocks, st);                             \
  }                                                                         \
  void f32_layout_d##D(int* out) { f32_layout<D>(out); }

}  // namespace repro_prefill
