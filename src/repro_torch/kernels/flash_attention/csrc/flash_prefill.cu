// Flash-attention prefill forward for Hopper (sm_90a) in bf16 on the tensor
// cores: the bf16 route of the port's prefill kernel.
//
// Replaces the TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention/kernel.py (body _flash_kernel,
// _tile_update) for bf16 inputs at head_dim 64, 128 and 256. The fp32 route
// stays on flash_fwd_kernel in flash_attention.cu.
//
// Semantics (the masking rule of _tile_update): s = (q.k) * scale, optional
// softcap s = cap * tanh(s / cap); a (q, kv) pair is visible iff
// kp >= 0 && qp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window).
// Online softmax in fp32 with the fully-masked-row guard: l == 0 gives an
// output of 0 and lse = -1e30, otherwise lse = m + log(l). q is
// (B, Hkv, G, S, D), k/v (B, Hkv, T, D), all by element strides with a
// contiguous last axis and 16-byte aligned rows; out (B, Hkv, G, S, D) bf16
// and lse (B, Hkv, G, S) fp32, contiguous. Any S and T: ragged edges are
// masked here, nothing is padded.
//
// Numerics, a difference by design: the reference does both products in
// fp32 from fp32 copies of q, k and v. Here q.k runs on bf16 operands with
// fp32 accumulation (products of bf16 values are exact in fp32; only the
// order of the sums differs), and p = exp(s - m) is rounded to bf16 before
// p.v, a relative error of at most 2^-8 per term of a convex combination of
// v rows. l sums the fp32 p, and lse comes from the fp32 scores.
//
// Bound on the H100: at the serving shapes the bytes of q, k, v, out and
// lse over 3.35 TB/s (pimref, D 64: 25.4 MB, 7.6 us); the operations over
// 989 TFLOP/s come within 25% of that at D 256 and pass it at the long
// Griffin prompt. What the design does:
//   * a block holds 128 q rows, GG query heads x BQ positions of one kv
//     head (the plan of prefill_plan in kernel.py), so every K/V tile read
//     into shared memory serves all G heads of the kv head; the q tiles
//     run in reverse, so the blocks with the most causal work start first;
//   * two warpgroups, 64 rows each, multiply on the tensor cores with
//     wgmma: S = Q K^T as m64n64k16 with Q and K from shared memory, then
//     O += P V as m64n64k16 with P from registers (the S accumulator's
//     layout is the A fragment's, so p never leaves the registers) and V
//     read through the descriptor's transpose, not copied;
//   * q is gathered once and K/V stream through a two-stage ring, all with
//     16-byte cp.async into the 128-byte-swizzled layout that wgmma's
//     shared-memory descriptors read, so tile j+1 loads while tile j runs;
//   * the kv tiles are classified up front, eight warps in parallel, from
//     each tile's kv position range while the q copies fly: a tile in
//     which no pair can be visible is neither loaded nor computed (dead
//     ring slots, the upper causal triangle, tiles left of the window),
//     and a tile in which every pair of a valid row is visible skips the
//     mask;
//   * scale, softcap, mask and the online softmax run on the accumulator
//     fragments in registers: scores stay unscaled, so p is one FFMA and
//     one ex2 per element, the mask is one unsigned compare against the
//     row's visible position range, and row max and sum take the four
//     lanes of a row, with no shared-memory round trip;
//   * out goes back through shared memory as 16-byte stores per row.
// Tiles: BK = 128 kv rows at D 64 and 128, 64 at D 256. Shared memory: q
// 16 / 32 / 64 KiB + 2 stages of K and V 64 / 128 / 128 KiB, so two D-64
// blocks share an SM and one D-256 block fills one. What holds it back
// (measured by taking stages out): one D-256 block per SM runs its q load,
// its tiles' products, softmax and loads, and its epilogue one after the
// other, with nothing to overlap them; at D 64 the softmax's ex2 work
// matches the tensor cores'. TMA for K/V, a producer warp with setmaxnreg
// and two consumer warpgroups that take turns on the tensor cores are the
// next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // two warpgroups
constexpr int kRows = 128;             // q rows per block, 64 per warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* qpos;    // (B, S)
  const int* kpos;    // (B, T)
  bf16* out;
  float* lse;
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q (B, Hkv, G, S, D)
  long long ks_b, ks_h, ks_t;
  long long vs_b, vs_h, vs_t;
  int B, H, G, S, T;
  int GG, BQ;         // the block's query heads x positions, GG * BQ <= 128
  int groups;         // head groups: block x takes group x % groups
  int causal, window;
  float softcap, scale;
};

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
};

// Block row r (0..127) -> its query head g and position s; false if the row
// holds none (unused rows of the plan, past G or past S).
__device__ __forceinline__ bool block_row(const Params& p, int r, int qt,
                                          int gg, int& g, int& s) {
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
template <int BK>
__device__ void scan_tiles(const Params& p, const int* kpos_b, int c0, int nt,
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
template <int BK>
__device__ __forceinline__ int next_live(const Params& p, const int* kpos_b,
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
  if (threadIdx.x < BK) {      // past T: position -1
    const int t = t0 + threadIdx.x;
    if (t < p.T)
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

// One block: kRows query rows (prefill_plan; the q tiles in reverse, so the
// blocks with the most causal work start first) of kv head blockIdx.y of
// batch row blockIdx.z against every live kv tile.
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

  // the block's valid q positions: every warp reduces them itself
  int qmin = 0x7fffffff, qmax = -1;
  {
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
  int c0 = 0;
  scan_tiles<BK>(p, kpos_b, 0, nt, qmin, qmax, flags);
  __syncthreads();

  int j = next_live<BK>(p, kpos_b, 0, nt, qmin, qmax, flags, c0);
  if (j < nt)
    load_kv<D, BK>(p, kb, vb, kpos_b, j, base + L::kKV, base + L::kKpos);
  cp_async_commit();

  // this thread's two accumulator rows (wgmma layout: warp wq of the
  // warpgroup holds rows 16 wq .. 16 wq + 15, lane l rows l / 4 and +8)
  const int r0 = wg * 64 + wq * 16 + (lane >> 2), r1 = r0 + 8;
  int g0, s0, g1, s1;
  const bool ok0 = block_row(p, r0, qt, gg, g0, s0);
  const bool ok1 = block_row(p, r1, qt, gg, g1, s1);
  const int qp0 = ok0 ? qpos_b[s0] : -1;
  const int qp1 = ok1 ? qpos_b[s1] : -1;
  unsigned lo0, lo1, span0, span1;
  visible_range(qp0, p.causal, p.window, lo0, span0);
  visible_range(qp1, p.causal, p.window, lo1, span1);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // scores stay unscaled: m is the running max of q.k, and
  // p = 2^((s - m) * scale * log2 e) is one FFMA and one MUFU op
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;           // this lane's part of the row sum
  const float sl2 = p.scale * kLog2e;
  const float inv_scale = 1.f / p.scale;
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

    // element 4I+e is row r0 and 4I+2+e row r1, column 8I + 2 (lane % 4) + e
    if (p.softcap > 0.f) {     // cap * tanh(s * scale / cap), unscaled again
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap) * inv_scale;
    }
    if (!full) {
      const int* kp_s = kps + st * BK;
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

    // online softmax over the four lanes of each row
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
    const float alpha0 = m0 <= kNegInf * 0.5f ? 0.f : ex2((m0 - safe0) * sl2);
    const float alpha1 = m1 <= kNegInf * 0.5f ? 0.f : ex2((m1 - safe1) * sl2);
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

  // epilogue: out = O / l through the q region of shared memory; a row
  // whose q position is -1 or that saw no visible pair gets out 0 and lse
  // -1e30 (rows at -1 ride unmasked through the tiles that need no mask)
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const bool dead0 = qp0 < 0 || m0 <= kNegInf * 0.5f;
  const bool dead1 = qp1 < 0 || m1 <= kNegInf * 0.5f;
  const float inv0 = dead0 ? 0.f : 1.f / l0, inv1 = dead1 ? 0.f : 1.f / l1;
#pragma unroll
  for (int I = 0; I < D / 8; ++I) {
    const int cb = (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(sm + swz(kRows, r0, I) + cb) =
        pack_bf16(o[4 * I] * inv0, o[4 * I + 1] * inv0);
    *reinterpret_cast<uint32_t*>(sm + swz(kRows, r1, I) + cb) =
        pack_bf16(o[4 * I + 2] * inv1, o[4 * I + 3] * inv1);
  }
  if ((lane & 3) == 0) {
    const long long bh = static_cast<long long>(b) * p.H + h;
    if (ok0)
      p.lse[(bh * p.G + g0) * p.S + s0] =
          dead0 ? kNegInf : m0 * p.scale + logf(l0);
    if (ok1)
      p.lse[(bh * p.G + g1) * p.S + s1] =
          dead1 ? kNegInf : m1 * p.scale + logf(l1);
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

template <int D, int BK, int MINB>
cudaError_t launch(const Params& p, int blocks, cudaStream_t st) {
  using L = PrefillSmem<D, BK>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, BK, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid(blocks, p.H, p.B);
  flash_prefill_kernel<D, BK, MINB><<<grid, kThreads, L::kSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of repro_flash_attention_fwd (flash_attention.cu), then the
// block plan of prefill_plan (kernel.py): GG query heads x BQ positions,
// GG * BQ <= 128, in `groups` head groups over `blocks` blocks per kv head.
// A plan that leaves a (head, position) row uncovered, or a block empty, is
// refused. Pointers and row strides 16-byte aligned.
int repro_flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* lse, long long qs_b, long long qs_h,
    long long qs_g, long long qs_s, long long ks_b, long long ks_h, long long ks_t,
    long long vs_b, long long vs_h, long long vs_t, int B, int H, int G, int S,
    int T, int D, int GG, int BQ, int groups, int blocks, int causal,
    int window, float softcap, float scale, void* stream) {
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  if (GG < 1 || BQ < 1 || GG * BQ > kRows || groups < 1 || blocks < 1 ||
      blocks % groups != 0)
    return cudaErrorInvalidValue;
  const long long nq = blocks / groups;
  if (static_cast<long long>(groups) * GG < G ||
      static_cast<long long>(groups - 1) * GG >= G || nq * BQ < S ||
      (nq - 1) * BQ >= S)
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_g = qs_g; p.qs_s = qs_s;
  p.ks_b = ks_b; p.ks_h = ks_h; p.ks_t = ks_t;
  p.vs_b = vs_b; p.vs_h = vs_h; p.vs_t = vs_t;
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T;
  p.GG = GG; p.BQ = BQ; p.groups = groups;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, 128, 2>(p, blocks, st);
  if (D == 128) return launch<128, 128, 1>(p, blocks, st);
  if (D == 256) return launch<256, 64, 1>(p, blocks, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
