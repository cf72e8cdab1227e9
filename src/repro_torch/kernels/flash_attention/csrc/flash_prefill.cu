// Flash-attention prefill forward for Hopper (sm_90a) on the tensor cores:
// both routes of the port's prefill kernel, bf16 and fp32.
//
// Replaces the TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention/kernel.py (body _flash_kernel,
// _tile_update) at head_dim 64, 128 and 256: repro_flash_prefill_bf16 for
// bf16 inputs, repro_flash_prefill_f32 for fp32 ones.
//
// Semantics (the masking rule of _tile_update): s = (q.k) * scale, optional
// softcap s = cap * tanh(s / cap); a (q, kv) pair is visible iff
// kp >= 0 && qp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window).
// Online softmax in fp32 with the fully-masked-row guard: l == 0 gives an
// output of 0 and lse = -1e30, otherwise lse = m + log(l). q is
// (B, Hkv, G, S, D), k/v (B, Hkv, T, D), all by element strides with a
// contiguous last axis and 16-byte aligned rows; out (B, Hkv, G, S, D) in
// q's type and lse (B, Hkv, G, S) fp32, contiguous. Any S and T: ragged
// edges are masked here, nothing is padded.
//
// Numerics of the bf16 route, a difference by design: the reference does
// both products in fp32 from fp32 copies of q, k and v. Here q.k runs on
// bf16 operands with fp32 accumulation (products of bf16 values are exact in
// fp32; only the order of the sums differs), and p = exp(s - m) is rounded
// to bf16 before p.v, a relative error of at most 2^-8 per term of a convex
// combination of v rows. l sums the fp32 p, and lse comes from the fp32
// scores.
//
// Numerics of the fp32 route, which the fp32 parity checks hold to 2e-5 of
// the plain version (one TF32 or bf16 product would not meet that): every
// fp32 operand splits exactly into three bf16 parts, x = x0 + x1 + x2 with
// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (ref.split_bf16:
// exact for |x| >= 2^-110), so each product of parts is exact in fp32.
// s = sum of q_i k_j over the six pairs with i + j <= 2, smallest first, in
// fp32 accumulators; the three pairs left out weigh 2^-27 of |q||k| or
// less. p = exp(s - m) in fp32 splits the same way, and o += p_i v_j over
// the same six pairs. l sums the fp32 p. ref.fp32_route_ref emulates this in
// plain PyTorch; it stays within 5e-6 of the reference.
//
// Bound on the H100: the bf16 route's bytes of q, k, v, out and lse over
// 3.35 TB/s at the serving shapes (pimref, D 64: 25.4 MB, 7.6 us); the
// operations over 989 TFLOP/s come within 25% of that at D 256 and pass it
// at the long Griffin prompt. The fp32 route's six tensor passes (pimref's
// fp32 shape: 6 x 3.23 GFLOP, 19.6 us) pass its 50.6 MB (15.1 us). What the
// design does:
//   * a block holds 128 q rows (the fp32 route at D 256: 64), GG query
//     heads x BQ positions of one kv head (the plan of prefill_plan in
//     kernel.py), so every K/V tile read into shared memory serves all G
//     heads of the kv head; the q tiles run in reverse, so the blocks with
//     the most causal work start first;
//   * a warpgroup per 64 rows multiplies on the tensor cores with wgmma:
//     S = Q K^T with Q and K from shared memory, then O += P V with P from
//     registers (the S accumulator's layout is the A fragment's, so p never
//     leaves the registers) and V read through the descriptor's transpose,
//     not copied;
//   * the kv tiles are classified up front, a warp a tile, from each tile's
//     kv position range while q is loaded: a tile in which no pair can be
//     visible is neither loaded nor computed (dead ring slots, the upper
//     causal triangle, tiles left of the window), and a tile in which every
//     pair of a valid row is visible skips the mask;
//   * scale, softcap, mask and the online softmax run on the accumulator
//     fragments in registers: scores stay unscaled, so p is one FFMA and
//     one ex2 per element, the mask is one unsigned compare against the
//     row's visible position range, and row max and sum take the four
//     lanes of a row, with no shared-memory round trip.
// The bf16 route copies q and K/V with 16-byte cp.async into the
// 128-byte-swizzled layout wgmma's descriptors read, K/V through a
// two-stage ring; BK = 128 kv rows at D 64 and 128, 64 at D 256; shared
// memory q 16 / 32 / 64 KiB + 2 stages of K and V 64 / 128 / 128 KiB, so
// two D-64 blocks share an SM and one D-256 block fills one.
// The fp32 route (F32Tiles: 128 q rows and BK 128 at D 64, BK 64 at D 128;
// 64 and 32 at D 256):
//   * a pre-pass, split_kv_parts, splits K and V into their bf16 parts
//     once per call: with G query heads a kv head, every K/V row is read by
//     each block of its batch row that reaches it (some 48 blocks at
//     Griffin's D-256 shape), and splitting it again in each of them was
//     the time the product lost;
//   * the product's thread 0 asks the Tensor Memory Accelerator for a
//     tile's parts (a box: 64 columns of a part) straight into the
//     swizzled layout, K's and V's each in their own region and counted on
//     their own mbarrier, so V's parts land under the products of S and the
//     next K's under those of O; two block barriers a tile; q lands the
//     same way as fp32 rows (boxes of 32 columns) in the K and V regions,
//     and the block splits it into its parts once;
//   * the product is launched as the pre-pass's programmatic dependent:
//     its blocks load and split q while the pre-pass finishes, and wait for
//     it (griddepcontrol.wait) before asking for a part;
//   * at D 256 one warpgroup holds o for 64 rows x 256 columns in 128
//     registers and spilled; the block's two warpgroups share its 64 rows
//     instead, three of the six pairs of S each (summed through shared
//     memory, in one order on both) and half of O's columns each.
//   Shared memory: q's parts 48 / 96 / 96 KiB + K's and V's parts 96 KiB
//   (+ 16 KiB for S's halves at D 256). What holds it back: one block
//   an SM runs its products, softmax and p's split one after the other
//   (two blocks an SM at D 64 bought next to nothing), and at D 256 the
//   m64n32 products of S read q's parts again for every 32 kv rows. q's
//   slices as register A fragments, each serving all pairs of its part,
//   were slower: the product then waits on every k16 slice to reuse its
//   registers. A producer warp with consumer warpgroups taking turns on
//   the tensor cores is the next step.
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // bf16: two warpgroups
constexpr int kRows = 128;             // bf16: q rows per block
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
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

template <int D, int BK>
struct PrefillSmem {
  static constexpr int kChunks = D / 8;        // 16-byte chunks of a row
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = BK * D * 2;  // one K or V tile
  static constexpr int kKV = kQBytes;          // stage s: K, then V
  static constexpr int kKpos = kKV + 4 * kTileBytes;   // 2 stages x BK
  static constexpr int kFlags = kKpos + 2 * BK * 4;    // kScanTiles
  static constexpr int kBytes = kFlags + kScanTiles;
  static constexpr size_t kSmem = kBytes + 1024;  // slack to align the base
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

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

// Issue the cp.async copies of K/V tile j and its kv positions into stage
// sK (K, V, then the positions at sKp).
template <int D, int BK>
__device__ __forceinline__ void load_kv(const Params& p, const bf16* kb,
                                        const bf16* vb, const int* kpos_b,
                                        int j, uint32_t sK, uint32_t sKp) {
  using L = PrefillSmem<D, BK>;
  const int t0 = j * BK;
  const uint32_t sV = sK + L::kTileBytes;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BK * L::kChunks; idx += kThreads) {
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    const int t = t0 + r;
    const bool ok = t < p.T;
    const long long tr = ok ? t : 0;
    const uint32_t o = swz(BK, r, c);
    cp_async16(sK + o, kb + tr * p.ks_t + c * 8, ok);
    cp_async16(sV + o, vb + tr * p.vs_t + c * 8, ok);
  }
  load_kpos<BK>(kpos_b, p.T, j, sKp);
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
// The bf16 route. One block: kRows query rows (prefill_plan; the q tiles in
// reverse, so the blocks with the most causal work start first) of kv head
// blockIdx.y of batch row blockIdx.z against every live kv tile.
// ---------------------------------------------------------------------------
template <int D, int BK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_prefill_kernel(const Params p) {
  using L = PrefillSmem<D, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const int* const kps = reinterpret_cast<const int*>(sm + L::kKpos);
  uint8_t* const flags = sm + L::kFlags;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wq = (tid >> 5) & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nq = static_cast<int>(gridDim.x) / p.groups;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / p.groups;
  const int gg = blockIdx.x % p.groups;
  const int nt = (p.T + BK - 1) / BK;
  const int* kpos_b = p.kpos + static_cast<long long>(b) * p.T;
  const int* qpos_b = p.qpos + static_cast<long long>(b) * p.S;
  const bf16* kb = p.k + b * p.ks_b + h * p.ks_h;
  const bf16* vb = p.v + b * p.vs_b + h * p.vs_h;

  // the q rows first: their copies fly while the kv tiles are classified
  for (int idx = tid; idx < kRows * L::kChunks; idx += kThreads) {
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    int g, s;
    const bool ok = block_row(p, r, qt, gg, g, s);
    const long long off =
        ok ? b * p.qs_b + h * p.qs_h + g * p.qs_g + s * p.qs_s : 0;
    cp_async16(base + swz(kRows, r, c), p.q + off + c * 8, ok);
  }

  int qmin, qmax;
  q_range(p, qpos_b, qt, qmin, qmax);
  int c0 = 0;
  scan_tiles<BK>(p, kpos_b, 0, nt, qmin, qmax, flags);
  __syncthreads();

  int j = next_live<BK>(p, kpos_b, 0, nt, qmin, qmax, flags, c0);
  if (j < nt)
    load_kv<D, BK>(p, kb, vb, kpos_b, j, base + L::kKV, base + L::kKpos);
  cp_async_commit();

  const int r0 = wg * 64 + wq * 16 + (lane >> 2), r1 = r0 + 8;
  RowPair rows(p, qpos_b, r0, qt, gg);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t a_q = base + wg * (64 * 128);

  int st = 0;
  while (j < nt) {
    const bool full = flags[j - c0] & kFull;
    const int jn = next_live<BK>(p, kpos_b, j + 1, nt, qmin, qmax, flags, c0);
    if (jn < nt) {
      load_kv<D, BK>(p, kb, vb, kpos_b, jn,
                     base + L::kKV + (st ^ 1) * 2 * L::kTileBytes,
                     base + L::kKpos + (st ^ 1) * BK * 4);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = base + L::kKV + st * 2 * L::kTileBytes;
    const uint32_t sV = sK + L::kTileBytes;

    // S = Q K^T (64 x BK per warpgroup); the first k-slice overwrites s
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          desc_k(a_q + (kk >> 2) * (kRows * 128) + (kk & 3) * 32);
#pragma unroll
      for (int n = 0; n < BK / 64; ++n)
        wgmma_ss(&s[32 * n], da,
                 desc_k(sK + (kk >> 2) * (BK * 128) + n * (64 * 128) +
                        (kk & 3) * 32),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    float alpha0, alpha1;
    rows.softmax<BK>(p, s, kps + st * BK, full, alpha0, alpha1);

    // P in bf16, straight into the A fragments of the second product:
    // k-slice kk holds columns 16 kk .. 16 kk + 15
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

    // O += P V (64 x D per warpgroup, 64 columns per instruction)
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int dd = 0; dd < D / 64; ++dd)
        wgmma_rs(&o[32 * dd], pa[kk],
                 desc_mn(sV + dd * (BK * 128) + kk * (16 * 128)));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    reg_fence(pa);

    __syncthreads();             // stage st is free for the next prefetch
    j = jn;
    st ^= 1;
  }
  cp_async_wait<0>();            // the q copies, if no tile was live
  __syncthreads();

  // epilogue: out = O / l through the q region of shared memory
  float inv0, inv1;
  rows.finish(p, b, h, inv0, inv1);
#pragma unroll
  for (int I = 0; I < D / 8; ++I) {
    const int cb = (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(sm + swz(kRows, r0, I) + cb) =
        pack_bf16(o[4 * I] * inv0, o[4 * I + 1] * inv0);
    *reinterpret_cast<uint32_t*>(sm + swz(kRows, r1, I) + cb) =
        pack_bf16(o[4 * I + 2] * inv1, o[4 * I + 3] * inv1);
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * L::kChunks; idx += kThreads) {
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    int g, s;
    if (!block_row(p, r, qt, gg, g, s)) continue;
    const long long orow = ((static_cast<long long>(b) * p.H + h) * p.G + g) * p.S + s;
    *reinterpret_cast<uint4*>(p.out + orow * D + c * 8) =
        *reinterpret_cast<const uint4*>(sm + swz(kRows, r, c));
  }
}

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
template <> struct F32Tiles<256> {
  static constexpr int kRows = 64, kBK = 32;
  static constexpr bool kSplitD = true;
};

template <int D>
struct F32Smem {
  static constexpr int kR = F32Tiles<D>::kRows, BK = F32Tiles<D>::kBK;
  static constexpr bool kSplitD = F32Tiles<D>::kSplitD;
  static constexpr int kQPart = kR * D * 2;    // one bf16 part of q
  static constexpr int kPart = BK * D * 2;     // one bf16 part of a tile
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
                    D % (kSplitD ? 128 : 64) == 0,
                "tiles");
  static_assert(kR * D * 4 <= 6 * kPart, "q's fp32 rows fit K's and V's parts");
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
// layout wgmma reads (a box is a 64-column block of a part), counted on
// mbarrier bar. Thread 0 alone calls it.
template <int D, int BK>
__device__ __forceinline__ void load_parts(const CUtensorMap* m, int op,
                                           int b, int h, int j, uint32_t dst,
                                           uint32_t bar) {
  mbar_expect_tx(bar, 3 * BK * D * 2);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load_5d(dst + part * (BK * D * 2) + cb * (BK * 128), m, cb * 64,
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
    split8(sm + parts + swz(ROWS, r, c), ROWS * D * 2,
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
    mbar_expect_tx(bar_k, p.GG * p.BQ * D * 4);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
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
    // columns per instruction), once V's parts of tile j are in
    mbar_wait(bar_v, ph_v);
    ph_v ^= 1;
    reg_fence(o);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const uint32_t v = sV + pair_b(n) * L::kPart;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int dd = 0; dd < DO / 64; ++dd)
          wgmma_rs(&o[32 * dd], pa[pair_a(n)][kk],
                   desc_mn(v + (dd0 + dd) * (BK * 128) + kk * (16 * 128)));
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

// An operand of `rank` dimensions (dims[0] innermost and contiguous,
// strides[i] in elements for dims 1 ..) of esize-byte elements as a map
// with boxes of box[0] x box[1] x .., 128-byte swizzled, zeros outside; a
// dimension of extent 1 gets a packed stride, which no coordinate uses.
cudaError_t make_map(CUtensorMap* m, CUtensorMapDataType type, int esize,
                     const void* ptr, int rank, const long long* dims,
                     const long long* strides, const int* box) {
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
                         gbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int BK, int MINB>
cudaError_t launch(const Params& p, int blocks, cudaStream_t st) {
  using L = PrefillSmem<D, BK>;
  static bool ready = false;
  const cudaError_t e = allow_smem(flash_prefill_kernel<D, BK, MINB>,
                                   L::kSmem, ready);
  if (e != cudaSuccess) return e;
  dim3 grid(blocks, p.H, p.B);
  flash_prefill_kernel<D, BK, MINB><<<grid, kThreads, L::kSmem, st>>>(p);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Both routes take: q, k, v, q positions (B, S) and kv positions (B, T)
// int32, out, lse; the element strides of q (b, h, g, s), k (b, h, t) and v
// (b, h, t); B H G S T D; the block plan of prefill_plan (kernel.py) for
// the route's rows: GG query heads x BQ positions, in `groups` head groups
// over `blocks` blocks per kv head (a plan that leaves a (head, position)
// row uncovered, or a block empty, is refused); causal, window, softcap,
// scale, stream. Pointers and row strides 16-byte aligned.
int repro_flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* lse, long long qs_b, long long qs_h,
    long long qs_g, long long qs_s, long long ks_b, long long ks_h, long long ks_t,
    long long vs_b, long long vs_h, long long vs_t, int B, int H, int G, int S,
    int T, int D, int GG, int BQ, int groups, int blocks, int causal,
    int window, float softcap, float scale, void* stream) {
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  const long long strides[] = {qs_b, qs_h, qs_g, qs_s, ks_b,
                               ks_h, ks_t, vs_b, vs_h, vs_t};
  Params p;
  if (!make_params(p, q, k, v, qpos, kpos, out, lse, strides, B, H, G, S, T,
                   GG, BQ, groups, blocks, kRows, causal, window, softcap,
                   scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, 128, 2>(p, blocks, st);
  if (D == 128) return launch<128, 128, 1>(p, blocks, st);
  if (D == 256) return launch<256, 64, 1>(p, blocks, st);
  return cudaErrorInvalidValue;
}

// The fp32 route, with the plan for F32Tiles<D>::kRows rows a block, and
// parts a (6, B, H, T, D) bf16 scratch for K's and V's parts.
int repro_flash_prefill_f32(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* lse, void* parts, long long qs_b,
    long long qs_h, long long qs_g, long long qs_s, long long ks_b,
    long long ks_h, long long ks_t, long long vs_b, long long vs_h,
    long long vs_t, int B, int H, int G, int S, int T, int D, int GG, int BQ,
    int groups, int blocks, int causal, int window, float softcap,
    float scale, void* stream) {
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  const int rows = D == 64    ? F32Tiles<64>::kRows
                   : D == 128 ? F32Tiles<128>::kRows
                   : D == 256 ? F32Tiles<256>::kRows
                              : 0;
  if (rows == 0) return cudaErrorInvalidValue;
  const long long strides[] = {qs_b, qs_h, qs_g, qs_s, ks_b,
                               ks_h, ks_t, vs_b, vs_h, vs_t};
  ParamsT<float> p;
  if (!make_params(p, q, k, v, qpos, kpos, out, lse, strides, B, H, G, S, T,
                   GG, BQ, groups, blocks, rows, causal, window, softcap,
                   scale))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_f32<64>(p, parts, blocks, st);
  if (D == 128) return launch_f32<128>(p, parts, blocks, st);
  return launch_f32<256>(p, parts, blocks, st);
}

// The fp32 route's layout at head dim D, as out = {q rows a block, kv rows
// a tile, dynamic shared memory bytes} ({0, 0, 0} for another D):
// kernel.py FP32_PREFILL_TILES states the first two for the CPU tests; a
// card test compares.
void repro_flash_prefill_f32_layout(int D, int* out) {
  out[0] = out[1] = out[2] = 0;
  if (D == 64) {
    out[0] = F32Smem<64>::kR; out[1] = F32Smem<64>::BK;
    out[2] = static_cast<int>(F32Smem<64>::kSmem);
  } else if (D == 128) {
    out[0] = F32Smem<128>::kR; out[1] = F32Smem<128>::BK;
    out[2] = static_cast<int>(F32Smem<128>::kSmem);
  } else if (D == 256) {
    out[0] = F32Smem<256>::kR; out[1] = F32Smem<256>::BK;
    out[2] = static_cast<int>(F32Smem<256>::kSmem);
  }
}

}  // extern "C"
