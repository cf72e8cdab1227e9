// The split-KV decode kernel's templates and launches, for
// flash_decode.cu (which says what the kernel computes and why it is built
// so, and holds the C entry point) and for flash_decode.d<D>.cu, one
// translation unit a head dim: the five compile in parallel, each with its
// 36 instantiations (q's dtype x K/V source x paged x q rows a block).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace repro_decode {

constexpr float kNegInf = -1e30f;
constexpr int kStages = 8;        // ring stages per warp
constexpr int kMaxSplit = 256;    // kv rows of one split (decode_plan)
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Operand {               // K or V: data and, for codes, row scales
  const unsigned char* data;
  const float* scale;
  long long s_b, s_h, s_t;     // data, in elements of the stored tensor
  long long c_b, c_h, c_t;     // scale
};

struct Params {
  const void* q;
  Operand k, v;
  const int* qpos;    // (B, S)
  const int* kpos;    // (B, T), logical positions
  const int* table;   // (B, n_pages) pool pages of a paged operand
  void* out;          // (B, Hkv, G, S, D) contiguous, q's dtype
  float* pm;          // (B, Hkv, n_split, R) partial max, when n_split > 1
  float* pl;          //                      partial sum
  float* pacc;        // (B, Hkv, n_split, R, D) partial output
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q
  int B, H, G, S, T, R;              // R = G * S q rows per kv head
  int groups;                        // q-row groups of NR rows
  int n_pages, page_size, n_split, split_len;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  bool m = (kp >= 0) && (qp >= 0);
  if (causal) m = m && (kp <= qp);
  if (window > 0) m = m && (kp > qp - window);
  return m;
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// How a K/V row of D elements is stored, cut and streamed. BITS 0: values
// of type T; 8: int8 codes; 4: nibble-packed int4 codes.
template <typename T, int D, int BITS>
struct Layout {
  static constexpr int kBits = BITS ? BITS : 8 * static_cast<int>(sizeof(T));
  static constexpr int kStore = BITS ? 1 : static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = D * kBits / 8;
  static constexpr int kActive = D / 8;            // lanes holding elements
  // lanes per row: a power of two, so a score's butterfly stays inside the
  // row (D 80 and 112: 16, of which lanes 10 .. 15 or 14 .. 15 hold zero
  // q and acc slices and load nothing)
  static constexpr int kLanes = pow2_at_least(kActive);
  static constexpr int kRowsPerStep = 32 / kLanes;
  static constexpr int kLaneBytes = kBits;         // 8 elements
  // rows of one ring stage: about 1 KiB of each operand (two kv rows a row
  // group in bf16), at most four kv rows a row group and 16 rows (one scale
  // copy per lane), a whole number of warp steps
  static constexpr int kBatch =
      cmin(cmin(cmax(1024 / kRowBytes, kRowsPerStep), 4 * kRowsPerStep),
           16) / kRowsPerStep * kRowsPerStep;
  static constexpr int kStageBytes = kBatch * kRowBytes;
  // a row is copied in chunks of 16 bytes, or of 8 where its bytes are no
  // multiple of 16 (int4 codes at D 80 and 112: 40 and 56 bytes; kernel.py
  // copy_align): the alignment the wrapper asks of pointers and strides
  static constexpr int kCopyBytes = kRowBytes % 16 == 0 ? 16 : 8;
  static constexpr int kRowChunks = kRowBytes / kCopyBytes;
  static constexpr int kStageChunks = kBatch * kRowChunks;
  static constexpr int kCopies = (kStageChunks + 31) / 32;  // per lane, operand
  static constexpr int kSteps = kBatch / kRowsPerStep;
  static_assert(D % 8 == 0 && kLanes <= 32, "lanes");
  static_assert(kRowBytes % kCopyBytes == 0 && kSteps >= 1, "copies");
  static_assert(2 * kBatch <= 32, "one scale copy per lane");
};

template <class Lt>
struct alignas(16) Stage {
  unsigned char k[Lt::kStageBytes];
  unsigned char v[Lt::kStageBytes];
  float ks[Lt::kBatch];
  float vs[Lt::kBatch];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's 8 elements of a staged row, as 32-bit words.
template <int BYTES>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[8]) {
  if constexpr (BYTES == 32) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (BYTES == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else if constexpr (BYTES == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The 8 words as fp32 elements: codes times the row's scale (one fp32
// multiply, as _dequant_rows), values converted exactly.
template <typename T, int BITS>
__device__ __forceinline__ void expand(const uint32_t (&w)[8], float scale,
                                       float (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (BITS == 8) {
      const int c = static_cast<int>(w[e >> 2] << (24 - 8 * (e & 3))) >> 24;
      x[e] = static_cast<float>(c) * scale;
    } else if constexpr (BITS == 4) {    // element 2i low nibble, 2i+1 high
      const int c = static_cast<int>(w[0] << (28 - 4 * e)) >> 28;
      x[e] = static_cast<float>(c) * scale;
    } else if constexpr (sizeof(T) == 4) {
      x[e] = __uint_as_float(w[e]);
    } else {                             // bf16: element 2i in the low half
      x[e] = __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                     : (w[e >> 1] << 16));
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&x)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// One warp: kv rows [split * split_len, ...) of slot b, kv head h, against
// q rows rg * NR .. rg * NR + NR - 1 (of R = G * S).
// ---------------------------------------------------------------------------
template <typename T, int D, int BITS, bool PAGED, int NR>
__global__ void __launch_bounds__(32) flash_decode_kernel(Params p) {
  using Lt = Layout<T, D, BITS>;
  __shared__ Stage<Lt> ring[kStages];
  __shared__ int kp_s[kMaxSplit];              // compacted rows: position,
  __shared__ int row_s[kMaxSplit];             // row (t, or row in page)
  __shared__ int page_s[PAGED ? kMaxSplit : 1];  // and pool page

  const int lane = threadIdx.x;
  const int gi = lane / Lt::kLanes, li = lane % Lt::kLanes;
  const bool active = li < Lt::kActive;        // the lane holds elements
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.groups, rg = blockIdx.y % p.groups;
  const int t0 = split * p.split_len;
  const int t_end = min(p.T, t0 + p.split_len);

  // this lane's slice of the block's q rows, and their positions
  int qp[NR];
  float q[NR][8];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int row = rg * NR + r;
    const bool ok = row < p.R;
    const int g = ok ? row / p.S : 0, s = ok ? row % p.S : 0;
    qp[r] = ok ? p.qpos[static_cast<long long>(b) * p.S + s] : -1;
    const T* qr = static_cast<const T*>(p.q) + b * p.qs_b + h * p.qs_h +
                  g * p.qs_g + s * p.qs_s + li * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) q[r][e] = ok && active ? to_f32(qr[e]) : 0.f;
  }

  // positions (and pages) of the split, all loads in flight at once; then
  // the rows visible to some q row of the block, in kv order
  constexpr int kChunks = kMaxSplit / 32;
  int kpv[kChunks], pgv[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int t = t0 + 32 * c + lane;
    const bool in = t < t_end;
    kpv[c] = in ? p.kpos[static_cast<long long>(b) * p.T + t] : -1;
    if constexpr (PAGED)
      pgv[c] = in ? p.table[static_cast<long long>(b) * p.n_pages +
                            t / p.page_size] : 0;
  }
  int n = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int t = t0 + 32 * c + lane;
    bool vis = false;
#pragma unroll
    for (int r = 0; r < NR; ++r) vis |= visible(qp[r], kpv[c], p.causal, p.window);
    const unsigned mask = __ballot_sync(kFull, vis);
    if (vis) {
      const int i = n + __popc(mask & ((1u << lane) - 1u));
      kp_s[i] = kpv[c];
      if constexpr (PAGED) {
        page_s[i] = pgv[c];
        row_s[i] = t % p.page_size;
      } else {
        row_s[i] = t;
      }
    }
    n += __popc(mask);
  }
  __syncwarp();

  // stage j of the ring: compacted rows j * kBatch .. + kBatch - 1
  const unsigned char* kdata = p.k.data;
  const unsigned char* vdata = p.v.data;
  auto issue = [&](int j) {
    Stage<Lt>& st = ring[j % kStages];
    const int i0 = j * Lt::kBatch;
#pragma unroll
    for (int c = 0; c < Lt::kCopies; ++c) {
      const int idx = lane + 32 * c;
      const int rr = idx / Lt::kRowChunks, ch = idx % Lt::kRowChunks;
      const int i = i0 + rr;
      if (idx < Lt::kStageChunks && i < n) {
        const long long pb = PAGED ? page_s[i] : b, r = row_s[i];
        const long long ko = (pb * p.k.s_b + h * p.k.s_h + r * p.k.s_t) * Lt::kStore;
        const long long vo = (pb * p.v.s_b + h * p.v.s_h + r * p.v.s_t) * Lt::kStore;
        const int so = rr * Lt::kRowBytes + ch * Lt::kCopyBytes;
        const int go = ch * Lt::kCopyBytes;
        if constexpr (Lt::kCopyBytes == 16) {
          cp_async16(st.k + so, kdata + ko + go);
          cp_async16(st.v + so, vdata + vo + go);
        } else {
          cp_async8(st.k + so, kdata + ko + go);
          cp_async8(st.v + so, vdata + vo + go);
        }
      }
    }
    if constexpr (BITS != 0) {
      const int which = lane / Lt::kBatch, rr = lane % Lt::kBatch;
      const int i = i0 + rr;
      if (which < 2 && i < n) {
        const long long pb = PAGED ? page_s[i] : b, r = row_s[i];
        const Operand& o = which ? p.v : p.k;
        cp_async4((which ? st.vs : st.ks) + rr,
                  o.scale + pb * o.c_b + h * o.c_h + r * o.c_t);
      }
    }
  };

  float m[NR], l[NR], acc[NR][8];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const int nb = (n + Lt::kBatch - 1) / Lt::kBatch;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nb) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < nb; ++j) {
    if (j + kStages - 1 < nb) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const Stage<Lt>& st = ring[j % kStages];

    // scores of this row group's kv rows of the stage; the reductions
    // over a row's lanes go level by level over all rows, so the shuffles
    // of different rows overlap
    float x[Lt::kSteps][NR];
    int kp[Lt::kSteps];
#pragma unroll
    for (int u = 0; u < Lt::kSteps; ++u) {
      const int br = u * Lt::kRowsPerStep + gi;
      const int i = j * Lt::kBatch + br;
      kp[u] = i < n ? kp_s[i] : -1;
      uint32_t w[8] = {};
      float kf[8];
      if (active)
        load_words<Lt::kLaneBytes>(st.k + br * Lt::kRowBytes + li * Lt::kLaneBytes, w);
      expand<T, BITS>(w, BITS ? st.ks[br] : 1.f, kf);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(q[r][e], kf[e], d);
        x[u][r] = d;
      }
    }
#pragma unroll
    for (int o = Lt::kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < Lt::kSteps; ++u)
#pragma unroll
        for (int r = 0; r < NR; ++r) x[u][r] += __shfl_xor_sync(kFull, x[u][r], o);
#pragma unroll
    for (int u = 0; u < Lt::kSteps; ++u)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float s = x[u][r] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        x[u][r] = visible(qp[r], kp[u], p.causal, p.window) ? s : -INFINITY;
      }
    // online softmax, one rescale per stage
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float mx = x[0][r];
#pragma unroll
      for (int u = 1; u < Lt::kSteps; ++u) mx = fmaxf(mx, x[u][r]);
      const float m_new = fmaxf(m[r], mx);
      // fully-masked guard: exp(NEG_INF - NEG_INF) would be 1
      const float safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float alpha = m[r] <= kNegInf * 0.5f ? 0.f : expf(m[r] - safe);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < Lt::kSteps; ++u) {
        x[u][r] = expf(x[u][r] - safe);             // masked: 0
        sum += x[u][r];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
    // acc += p v
#pragma unroll
    for (int u = 0; u < Lt::kSteps; ++u) {
      const int br = u * Lt::kRowsPerStep + gi;
      if (j * Lt::kBatch + br >= n || !active) continue;
      uint32_t w[8];
      float vf[8];
      load_words<Lt::kLaneBytes>(st.v + br * Lt::kRowBytes + li * Lt::kLaneBytes, w);
      expand<T, BITS>(w, BITS ? st.vs[br] : 1.f, vf);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(x[u][r], vf[e], acc[r][e]);
    }
    __syncwarp();
  }

  // merge the warp's row groups, the lower group always first, so every
  // lane of a pair computes the same sums
#pragma unroll
  for (int o = Lt::kLanes; o < 32; o <<= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      const float ma = upper ? mo : m[r], mc = upper ? m[r] : mo;
      const float la = upper ? lo : l[r], lc = upper ? l[r] : lo;
      const float M = fmaxf(ma, mc);
      const float safe = M <= kNegInf * 0.5f ? 0.f : M;
      const float wa = ma <= kNegInf * 0.5f ? 0.f : expf(ma - safe);
      const float wc = mc <= kNegInf * 0.5f ? 0.f : expf(mc - safe);
      m[r] = M;
      l[r] = la * wa + lc * wc;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[r][e], o);
        const float aa = upper ? ao : acc[r][e], ac = upper ? acc[r][e] : ao;
        acc[r][e] = aa * wa + ac * wc;
      }
    }
  }

  if (gi != 0 || !active) return;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int row = rg * NR + r;
    if (row >= p.R) break;
    if (p.n_split == 1) {
      const long long orow = (static_cast<long long>(b) * p.H + h) * p.R + row;
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      float o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = acc[r][e] / lsafe;
      store8<T>(static_cast<T*>(p.out) + orow * D + li * 8, o8);
    } else {
      const long long base =
          ((static_cast<long long>(b) * p.H + h) * p.n_split + split) * p.R + row;
      store8<float>(p.pacc + base * D + li * 8, acc[r]);
      if (li == 0) {
        p.pm[base] = m[r];
        p.pl[base] = l[r];
      }
    }
  }
}

// Merge the n_split partials of one q row, a block of kCombine threads per
// row: D / 4 column threads (four columns each) times kCombine / (D / 4)
// split lanes, rounded down (D 80: 12 lanes of 20 threads, D 112: 9 of 28;
// the threads past them idle). Lane sl folds splits sl, sl + lanes, ... in
// order with an online max, all loads in flight ahead of the folds; then
// lane 0 folds the lanes' states in lane order. Fixed orders throughout,
// so the result does not vary from call to call.
constexpr int kCombine = 256;

struct Fold {                    // (m, l, acc) of a run of splits
  float m, l;
  float4 a;
  __device__ void add(float m2, float l2, float4 a2) {
    const float M = fmaxf(m, m2);
    const float safe = M <= kNegInf * 0.5f ? 0.f : M;
    const float w1 = m <= kNegInf * 0.5f ? 0.f : expf(m - safe);
    const float w2 = m2 <= kNegInf * 0.5f ? 0.f : expf(m2 - safe);
    m = M;
    l = l * w1 + l2 * w2;
    a.x = a.x * w1 + a2.x * w2;
    a.y = a.y * w1 + a2.y * w2;
    a.z = a.z * w1 + a2.z * w2;
    a.w = a.w * w1 + a2.w * w2;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kCombine)
flash_decode_combine_kernel(const float* __restrict__ pm,
                            const float* __restrict__ pl,
                            const float* __restrict__ pacc, T* __restrict__ out,
                            int R, int n_split) {
  constexpr int kT = D / 4, kLanes = kCombine / kT;
  __shared__ Fold part[kLanes][kT];
  const int row = blockIdx.x, c = threadIdx.x % kT, sl = threadIdx.x / kT;
  const long long bh = row / R, r = row % R;
  const long long first = bh * n_split * R + r;     // split sp at + sp * R
  const float4* acc = reinterpret_cast<const float4*>(pacc);
  Fold f{kNegInf, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (sl < kLanes) {
#pragma unroll 8
    for (int sp = sl; sp < n_split; sp += kLanes) {
      const long long idx = first + static_cast<long long>(sp) * R;
      f.add(pm[idx], pl[idx], acc[idx * kT + c]);
    }
    part[sl][c] = f;
  }
  __syncthreads();
  if (sl != 0) return;
#pragma unroll
  for (int i = 1; i < kLanes; ++i) f.add(part[i][c].m, part[i][c].l, part[i][c].a);
  const float lsafe = f.l == 0.f ? 1.f : f.l;
  T* o = out + static_cast<long long>(row) * D + 4 * c;
  o[0] = from_f32<T>(f.a.x / lsafe);
  o[1] = from_f32<T>(f.a.y / lsafe);
  o[2] = from_f32<T>(f.a.z / lsafe);
  o[3] = from_f32<T>(f.a.w / lsafe);
}

template <typename T, int D, int BITS, bool PAGED, int NR>
cudaError_t launch(const Params& p, cudaStream_t st) {
  dim3 grid(p.n_split, p.H * p.groups, p.B);
  flash_decode_kernel<T, D, BITS, PAGED, NR><<<grid, 32, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return e;
  flash_decode_combine_kernel<T, D><<<p.B * p.H * p.R, kCombine, 0, st>>>(
      p.pm, p.pl, p.pacc, static_cast<T*>(p.out), p.R, p.n_split);
  return cudaGetLastError();
}

template <typename T, int D, int BITS, bool PAGED>
cudaError_t by_rows(const Params& p, int rows, cudaStream_t st) {
  if (rows == 1) return launch<T, D, BITS, PAGED, 1>(p, st);
  if (rows == 2) return launch<T, D, BITS, PAGED, 2>(p, st);
  if (rows == 4) return launch<T, D, BITS, PAGED, 4>(p, st);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t by_source(const Params& p, int bits, bool paged, int rows,
                      cudaStream_t st) {
  if (bits == 0)
    return paged ? by_rows<T, D, 0, true>(p, rows, st)
                 : by_rows<T, D, 0, false>(p, rows, st);
  if (bits == 8)
    return paged ? by_rows<T, D, 8, true>(p, rows, st)
                 : by_rows<T, D, 8, false>(p, rows, st);
  if (bits == 4)
    return paged ? by_rows<T, D, 4, true>(p, rows, st)
                 : by_rows<T, D, 4, false>(p, rows, st);
  return cudaErrorInvalidValue;
}

// The launch at head dim D, one function a head dim, each defined in
// flash_decode.d<D>.cu by REPRO_DECODE_DIM
cudaError_t decode_d64(const Params& p, bool bf16, int bits, bool paged,
                        int rows, cudaStream_t st);
cudaError_t decode_d80(const Params& p, bool bf16, int bits, bool paged,
                        int rows, cudaStream_t st);
cudaError_t decode_d112(const Params& p, bool bf16, int bits, bool paged,
                        int rows, cudaStream_t st);
cudaError_t decode_d128(const Params& p, bool bf16, int bits, bool paged,
                        int rows, cudaStream_t st);
cudaError_t decode_d256(const Params& p, bool bf16, int bits, bool paged,
                        int rows, cudaStream_t st);

#define REPRO_DECODE_DIM(D)                                                 \
  cudaError_t decode_d##D(const Params& p, bool bf16, int bits, bool paged, \
                          int rows, cudaStream_t st) {                      \
    return bf16 ? by_source<__nv_bfloat16, D>(p, bits, paged, rows, st)     \
                : by_source<float, D>(p, bits, paged, rows, st);            \
  }

}  // namespace repro_decode
