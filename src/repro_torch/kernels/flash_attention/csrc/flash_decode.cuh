// The split-KV decode kernel's templates and launches, for
// flash_decode.cu (which says what the kernel computes and why it is built
// so, and holds the C entry point) and for flash_decode.d<D>.cu, one
// translation unit a head dim: the five compile in parallel, each with its
// 36 instantiations (q's dtype x K/V source x paged x q rows a block).
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
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
  int* tickets;       // (B, Hkv * groups) zeros: splits done (D 80, 112, 128)
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q
  int B, H, G, S, T, R;              // R = G * S q rows per kv head
  int groups;                        // q-row groups of NR rows
  int n_pages, page_size, n_split, split_len;
  int n_pool;                        // pool pages of a paged operand
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

// How a K/V row of D elements (64 or 256) is stored, cut and streamed.
// BITS 0: values of type T; 8: int8 codes; 4: nibble-packed int4 codes.
template <typename T, int D, int BITS>
struct Layout {
  static constexpr int kBits = BITS ? BITS : 8 * static_cast<int>(sizeof(T));
  static constexpr int kStore = BITS ? 1 : static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = D * kBits / 8;
  static constexpr int kLanes = D / 8;             // lanes a row
  static constexpr int kRowsPerStep = 32 / kLanes;
  static constexpr int kLaneBytes = kBits;         // 8 elements
  // rows of one ring stage: about 1 KiB of each operand (two kv rows a row
  // group in bf16), at most four kv rows a row group and 16 rows (one scale
  // copy per lane), a whole number of warp steps
  static constexpr int kBatch =
      cmin(cmin(cmax(1024 / kRowBytes, kRowsPerStep), 4 * kRowsPerStep),
           16) / kRowsPerStep * kRowsPerStep;
  static constexpr int kStageBytes = kBatch * kRowBytes;
  static constexpr int kCopyBytes = 16;            // a row's copy chunks
  static constexpr int kRowChunks = kRowBytes / kCopyBytes;
  static constexpr int kStageChunks = kBatch * kRowChunks;
  static constexpr int kCopies = (kStageChunks + 31) / 32;  // per lane, operand
  static constexpr int kSteps = kBatch / kRowsPerStep;
  static_assert((D == 64 || D == 256) && kLanes <= 32, "lanes");
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
    for (int e = 0; e < 8; ++e) q[r][e] = ok ? to_f32(qr[e]) : 0.f;
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
        cp_async16(st.k + so, kdata + ko + go);
        cp_async16(st.v + so, vdata + vo + go);
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
      if (j * Lt::kBatch + br >= n) continue;
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

  if (gi != 0) return;
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
// split lanes. Lane sl folds splits sl, sl + lanes, ... in
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

// ---------------------------------------------------------------------------
// D 80, 112 and 128 (flash_decode.cu's design note): a block of four warps
// streams one kv split of one (slot, kv head) once for all of the kv head's
// q rows, through a shared ring filled by bulk asynchronous copies, and the
// last block of a (slot, kv head) to finish merges the splits.
// ---------------------------------------------------------------------------
namespace wide {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;          // kv rows a ring stage
constexpr int kMaxSplit = 128;      // kv rows of one split (decode_plan)
constexpr int kMergeChunk = 12;     // splits a merging thread loads at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRingBytes = 12288;   // the ring's K and V bytes, at most

// How a K/V row of D elements is stored and staged. BITS 0: values of type
// T; 8: int8 codes; 4: nibble-packed int4 codes. A stage (kBatch rows of
// the split, in kv order) comes as one TMA box of K and one of V (two each
// through pages of 8 rows) where a row's bytes are a multiple of 16, else
// (int4 rows of 40 and 56 bytes, 8 bytes off 16 at odd rows) in 8-byte
// cp.async copies.
template <typename T, int D, int BITS>
struct Layout {
  static constexpr int kBits = BITS ? BITS : 8 * static_cast<int>(sizeof(T));
  static constexpr int kStore = BITS ? 1 : static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = D * kBits / 8;
  static constexpr int kDc = kRowBytes / kStore;    // stored elements a row
  static constexpr int kE = D / 16;          // elements a lane holds of a row
  static constexpr bool kTma = kRowBytes % 16 == 0;
  static constexpr int kStageBytes = kBatch * kRowBytes;   // an operand's
  static constexpr int kStages =
      cmin(8, cmax(2, kRingBytes / (2 * kStageBytes)));
  static constexpr int kChunks = kRowBytes / 8;   // 8-byte copies a row
  static_assert(D % 16 == 0 && kRowBytes % 8 == 0, "rows");
  static_assert(!kTma || (8 * kRowBytes) % 128 == 0,
                "TMA boxes on 128-byte boundaries");
};

// K's and V's tensor maps (the TMA layouts): boxes of kBatch rows
// (contiguous) or of min(page size, kBatch) rows of one page
struct Maps {
  CUtensorMap k, v;
};

template <class Lt>
struct alignas(128) Stage {
  unsigned char k[Lt::kStageBytes];
  unsigned char v[Lt::kStageBytes];
  float ks[kBatch];
  float vs[kBatch];
};

// q rows a block -> q rows a warp (NR) and the warps that split the q rows
// (WQ) and the kv rows (WK) between them: 1 -> 1 x 1 x 4, 4 -> 4 x 1 x 4,
// 8 -> 4 x 2 x 2 (a staged element read from shared memory serves NR q
// rows)
template <int ROWS>
struct Split {
  static constexpr int NR = ROWS < 4 ? ROWS : 4;
  static constexpr int WQ = ROWS / NR;
  static constexpr int WK = kWarps / WQ;
  static constexpr int kSteps = kBatch / (2 * WK);   // rows a half-warp a stage
  static_assert(NR * WQ == ROWS && WQ * WK == kWarps, "rows a block");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// expect tx bytes more on the barrier's current phase, without arriving
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}
// arrive once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// box (c0, .., c3) of a 4-D tensor map into shared memory at dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* m,
                                        int c0, int c1, int c2, int c3,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Element col of a staged row as fp32: a code as its integer (the row's
// scale multiplies a row's sum once, in fp32; int4: element 2i the low
// nibble of byte i, 2i+1 the high one), a value converted exactly.
template <typename T, int BITS>
__device__ __forceinline__ float element(const unsigned char* row, int col) {
  if constexpr (BITS == 8) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[col]);
  } else if constexpr (BITS == 4) {
    const unsigned byte = row[col >> 1];
    const int c = static_cast<int>(byte << ((col & 1) ? 24 : 28)) >> 28;
    return static_cast<float>(c);
  } else if constexpr (sizeof(T) == 4) {
    return reinterpret_cast<const float*>(row)[col];
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[col]);
  }
}

// 2^x in one MUFU op (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax's merge of two runs of kv rows with maxima m1 and m2
// (scores in log2 units; the fully-masked guard: a run at -1e30 weighs 0):
// the merged max, and the weights w1, w2 of the runs' sums
__device__ __forceinline__ float merge_weights(float m1, float m2, float& w1,
                                               float& w2) {
  const float M = fmaxf(m1, m2);
  const float safe = M <= kNegInf * 0.5f ? 0.f : M;
  w1 = m1 <= kNegInf * 0.5f ? 0.f : ex2(m1 - safe);
  w2 = m2 <= kNegInf * 0.5f ? 0.f : ex2(m2 - safe);
  return M;
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&a),
      *reinterpret_cast<const uint32_t*>(&b));
}

// One block: kv rows [split * split_len, ...) of slot b, kv head h, against
// the ROWS q rows rg * ROWS .. of the kv head (of R = G * S). Lane li of a
// half-warp holds elements li, li + 16, .. of a row (5 at D 80, 7 at D
// 112, 8 at D 128): no lane idle. Warp w takes q rows (w % WQ) * NR ..
// and, of each stage, the row pairs w / WQ, w / WQ + WK, ..
template <typename T, int D, int BITS, bool PAGED, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(Params p, const __grid_constant__ Maps maps) {
  using Lt = Layout<T, D, BITS>;
  using Sp = Split<ROWS>;
  constexpr int E = Lt::kE, NS = Lt::kStages, NR = Sp::NR, WQ = Sp::WQ,
                WK = Sp::WK;
  constexpr int kSplitStages = kMaxSplit / kBatch;
  __shared__ Stage<Lt> ring[NS];
  __shared__ int kp_s[kMaxSplit];              // the split's kv positions
  __shared__ int page_s[PAGED ? kSplitStages * kBatch / 8 : 1];  // its pages
  __shared__ int stage_s[kSplitStages];        // its live stages, in order
  __shared__ uint64_t full[NS], empty[NS];
  __shared__ float part[WK > 1 ? kWarps : 1][NR][D + 2];  // a warp's acc, m, l
  __shared__ int n_s, last_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, li = lane & 15;
  const int qw = warp % WQ, kw = warp / WQ;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.groups, rg = blockIdx.y % p.groups;
  const int t0 = split * p.split_len;
  const int t_end = min(p.T, t0 + p.split_len);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int page0 = PAGED ? t0 / p.page_size : 0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);       // warp 0's lanes, one arrival each
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // warp 0: the split's positions (and pages), all loads in flight at once;
  // then its live stages: those with a row visible to some q row of the
  // block (dead ring slots, trash-page rows and rows outside the window
  // cost no bytes, a stage at a time)
  if (warp == 0) {
    const int row = rg * ROWS + lane;
    const int qpl = lane < ROWS && row < p.R
                        ? p.qpos[static_cast<long long>(b) * p.S + row % p.S]
                        : -1;
    int qps[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) qps[r] = __shfl_sync(kFull, qpl, r);
    constexpr int kC = kMaxSplit / 32;
    int kpv[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int t = t0 + 32 * c + lane;
      kpv[c] = t < t_end ? p.kpos[static_cast<long long>(b) * p.T + t] : -1;
    }
    if constexpr (PAGED) {
      const int pg = page0 + lane;
      if (lane < kSplitStages * kBatch / 8 && pg * p.page_size < t_end)
        page_s[lane] = p.table[static_cast<long long>(b) * p.n_pages + pg];
    }
    int n = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      bool vis = false;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        vis |= visible(qps[r], kpv[c], p.causal, p.window);
      kp_s[32 * c + lane] = kpv[c];
      const unsigned mask = __ballot_sync(kFull, vis);
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        if ((mask >> (16 * hs)) & 0xffffu) {
          if (lane == 0) stage_s[n] = 2 * c + hs;
          ++n;
        }
      }
    }
    if (lane == 0) n_s = n;
  }
  __syncthreads();
  const int nb = n_s;                          // live stages

  // live stage j into ring slot j % NS, by warp 0: lane 0 asks for the
  // boxes of K and V (the bytes counted on the slot's barrier), or every
  // lane copies a row of K (lanes 0-15) or V in 8-byte chunks; every lane
  // copies its row's scale; every lane arrives once
  auto issue = [&](int j) {
    Stage<Lt>& st = ring[j % NS];
    uint64_t* bar = &full[j % NS];
    const int ts = t0 + stage_s[j] * kBatch;     // the stage's first row
    if constexpr (Lt::kTma) {
      if (lane == 0) {
        if constexpr (PAGED) {
          const int box = min(p.page_size, kBatch);
          int nbox = 0;
          for (int t = ts; t < ts + kBatch && t < t_end; t += box) ++nbox;
          mbar_expect(bar, 2 * nbox * box * Lt::kRowBytes);
          for (int q = 0; q < nbox; ++q) {
            const int t = ts + q * box;
            const int pg = page_s[t / p.page_size - page0];
            const int r = t % p.page_size;
            tma_box(st.k + q * box * Lt::kRowBytes, &maps.k, 0, h, r, pg, bar);
            tma_box(st.v + q * box * Lt::kRowBytes, &maps.v, 0, h, r, pg, bar);
          }
        } else {
          mbar_expect(bar, 2 * Lt::kStageBytes);
          tma_box(st.k, &maps.k, 0, ts, h, b, bar);
          tma_box(st.v, &maps.v, 0, ts, h, b, bar);
        }
      }
    } else {
      const int rr = lane & 15, t = ts + rr;
      if (t < t_end) {
        const Operand& o = lane < 16 ? p.k : p.v;
        const long long pb =
            PAGED ? page_s[t / p.page_size - page0] : b;
        const long long r = PAGED ? t % p.page_size : t;
        const unsigned char* src =
            o.data + (pb * o.s_b + h * o.s_h + r * o.s_t) * Lt::kStore;
        unsigned char* dst = (lane < 16 ? st.k : st.v) + rr * Lt::kRowBytes;
#pragma unroll
        for (int c = 0; c < Lt::kChunks; ++c)
          cp_async8(dst + 8 * c, src + 8 * c);
      }
    }
    if constexpr (BITS != 0) {
      const int rr = lane & 15, t = ts + rr;
      if (t < t_end) {
        const Operand& o = lane < 16 ? p.k : p.v;
        const long long pb =
            PAGED ? page_s[t / p.page_size - page0] : b;
        const long long r = PAGED ? t % p.page_size : t;
        cp_async4((lane < 16 ? st.ks : st.vs) + rr,
                  o.scale + pb * o.c_b + h * o.c_h + r * o.c_t);
      }
    }
    if constexpr (BITS != 0 || !Lt::kTma)
      mbar_arrive_cp_async(bar);
    else
      mbar_arrive(bar);
  };
  if (warp == 0)
    for (int j = 0; j < min(nb, NS); ++j) issue(j);

  // this warp's slice of its q rows, and their positions
  int qp[NR];
  float q[NR][E];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int row = rg * ROWS + qw * NR + r;
    const bool ok = row < p.R;
    const int g = ok ? row / p.S : 0, s = ok ? row % p.S : 0;
    qp[r] = ok ? p.qpos[static_cast<long long>(b) * p.S + s] : -1;
    const T* qr = static_cast<const T*>(p.q) + b * p.qs_b + h * p.qs_h +
                  g * p.qs_g + s * p.qs_s + li;
#pragma unroll
    for (int e = 0; e < E; ++e) q[r][e] = ok ? to_f32(qr[16 * e]) : 0.f;
  }
  float m[NR], l[NR], acc[NR][E];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int j = 0; j < nb; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    const Stage<Lt>& st = ring[s];

    // scores of this half-warp's rows of the stage; the reductions over a
    // row's 16 lanes go level by level over all rows
    float x[Sp::kSteps][NR];
    int kp[Sp::kSteps];
#pragma unroll
    for (int u = 0; u < Sp::kSteps; ++u) {
      const int br = 2 * (u * WK + kw) + half;
      kp[u] = kp_s[stage_s[j] * kBatch + br];   // -1 past the split
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        kf[e] = element<T, BITS>(st.k + br * Lt::kRowBytes, li + 16 * e);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[r][e], kf[e], d);
        x[u][r] = d;
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < Sp::kSteps; ++u)
#pragma unroll
        for (int r = 0; r < NR; ++r)
          x[u][r] += __shfl_xor_sync(kFull, x[u][r], o);
    // scores in log2 units: q.k * scale * log2 e (codes: times the row's
    // scale), capped, masked
#pragma unroll
    for (int u = 0; u < Sp::kSteps; ++u) {
      const int br = 2 * (u * WK + kw) + half;
      const float f = BITS ? st.ks[br] * p.scale : p.scale;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float sc = x[u][r] * f;
        if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
        x[u][r] = visible(qp[r], kp[u], p.causal, p.window) ? sc * kLog2e
                                                            : -INFINITY;
      }
    }
    // online softmax, one rescale a stage
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float mx = x[0][r];
#pragma unroll
      for (int u = 1; u < Sp::kSteps; ++u) mx = fmaxf(mx, x[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float alpha = m[r] <= kNegInf * 0.5f ? 0.f : ex2(m[r] - safe);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < Sp::kSteps; ++u) {
        x[u][r] = ex2(x[u][r] - safe);              // masked: 0
        sum += x[u][r];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
    // acc += p v
#pragma unroll
    for (int u = 0; u < Sp::kSteps; ++u) {
      const int br = 2 * (u * WK + kw) + half;
      if (kp[u] < 0) continue;   // no row cached here: its bytes are not read
      float pv[NR];              // p, times the row's scale for codes
#pragma unroll
      for (int r = 0; r < NR; ++r) pv[r] = BITS ? x[u][r] * st.vs[br] : x[u][r];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vf = element<T, BITS>(st.v + br * Lt::kRowBytes, li + 16 * e);
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[r][e] = fmaf(pv[r], vf, acc[r][e]);
      }
    }
    // the stage is free once every warp is done with it; warp 0 refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (warp == 0 && j + NS < nb) {
      mbar_wait(&empty[s], (j / NS) & 1);
      issue(j + NS);
    }
  }

  // merge the warp's two half-warps, the lower first, so both compute the
  // same sums
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float mo = __shfl_xor_sync(kFull, m[r], 16);
    const float lo = __shfl_xor_sync(kFull, l[r], 16);
    float wa, wc;
    const float M = half ? merge_weights(mo, m[r], wa, wc)
                         : merge_weights(m[r], mo, wa, wc);
    l[r] = half ? lo * wa + l[r] * wc : l[r] * wa + lo * wc;
    m[r] = M;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float ao = __shfl_xor_sync(kFull, acc[r][e], 16);
      acc[r][e] = half ? ao * wa + acc[r][e] * wc : acc[r][e] * wa + ao * wc;
    }
  }
  // merge the kv warps of each q-row warp in warp order
  if constexpr (WK > 1) {
    if (kw > 0 && half == 0) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) part[warp][r][li + 16 * e] = acc[r][e];
        if (li == 0) {
          part[warp][r][D] = m[r];
          part[warp][r][D + 1] = l[r];
        }
      }
    }
    __syncthreads();
    if (kw == 0) {
#pragma unroll
      for (int k2 = 1; k2 < WK; ++k2) {
        const int w2 = k2 * WQ + qw;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float wa, wc;
          m[r] = merge_weights(m[r], part[w2][r][D], wa, wc);
          l[r] = l[r] * wa + part[w2][r][D + 1] * wc;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = acc[r][e] * wa + part[w2][r][li + 16 * e] * wc;
        }
      }
    }
  }

  // the block's rows: out itself with one split, else its partials, and
  // the last block of the (slot, kv head, group) to finish merges them
  const bool writer = kw == 0 && half == 0;
  if (p.n_split == 1) {
    if (!writer) return;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = rg * ROWS + qw * NR + r;
      if (row >= p.R) break;
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      T* orow = static_cast<T*>(p.out) + (bh * p.R + row) * D + li;
#pragma unroll
      for (int e = 0; e < E; ++e) orow[16 * e] = from_f32<T>(acc[r][e] / lsafe);
    }
    return;
  }
  if (writer) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int row = rg * ROWS + qw * NR + r;
      if (row >= p.R) break;
      const long long base = (bh * p.n_split + split) * p.R + row;
#pragma unroll
      for (int e = 0; e < E; ++e) p.pacc[base * D + li + 16 * e] = acc[r][e];
      if (li == 0) {
        p.pm[base] = m[r];
        p.pl[base] = l[r];
      }
    }
    __threadfence();             // the partials before the ticket
  }
  __syncthreads();
  int* ticket = p.tickets + static_cast<long long>(b) * gridDim.y + blockIdx.y;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == p.n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();               // every other block's partials are visible
  // out = sum over splits of acc 2^(m - M) / sum of l 2^(m - M): four
  // columns a thread, the splits in order, kMergeChunk of them in flight
  // at a time (the loads of a chunk issued together)
  const int rows = min(ROWS, p.R - rg * ROWS);
  const long long first = bh * p.n_split * p.R + rg * ROWS;  // split 0, row 0
  constexpr int C4 = D / 4;
  for (int idx = tid; idx < rows * C4; idx += kThreads) {
    const int r = idx / C4, c = 4 * (idx % C4);
    float M = kNegInf, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < p.n_split; sp0 += kMergeChunk) {
      float mm[kMergeChunk], ll[kMergeChunk];
      float4 aa[kMergeChunk];
#pragma unroll
      for (int k = 0; k < kMergeChunk; ++k) {
        const long long i = first + r + static_cast<long long>(sp0 + k) * p.R;
        const bool in = sp0 + k < p.n_split;
        mm[k] = in ? __ldcg(p.pm + i) : kNegInf;
        ll[k] = in ? __ldcg(p.pl + i) : 0.f;
        aa[k] = in ? __ldcg(reinterpret_cast<const float4*>(p.pacc + i * D + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float cm = M;
#pragma unroll
      for (int k = 0; k < kMergeChunk; ++k) cm = fmaxf(cm, mm[k]);
      const float safe = cm <= kNegInf * 0.5f ? 0.f : cm;
      const float w0 = M <= kNegInf * 0.5f ? 0.f : ex2(M - safe);
      L *= w0;
      A = make_float4(A.x * w0, A.y * w0, A.z * w0, A.w * w0);
#pragma unroll
      for (int k = 0; k < kMergeChunk; ++k) {
        const float w = mm[k] <= kNegInf * 0.5f ? 0.f : ex2(mm[k] - safe);
        L = fmaf(ll[k], w, L);
        A = make_float4(fmaf(aa[k].x, w, A.x), fmaf(aa[k].y, w, A.y),
                        fmaf(aa[k].z, w, A.z), fmaf(aa[k].w, w, A.w));
      }
      M = cm;
    }
    const float inv = 1.f / (L == 0.f ? 1.f : L);
    store4<T>(static_cast<T*>(p.out) + (bh * p.R + rg * ROWS + r) * D + c,
              make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv));
  }
  if (tid == 0) *ticket = 0;     // ready for the next launch (graph replays)
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no link
// against libcuda)
inline PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(f);
  }
  return fn;
}

// A 4-D operand (dims[0] contiguous, strides in bytes for dims 1 ..) as a
// map with boxes of box[0] x .. x box[3], unswizzled, zeros outside; a
// dimension of extent 1 gets a packed stride, which no coordinate uses.
inline cudaError_t make_map(CUtensorMap* m, CUtensorMapDataType type,
                            const void* ptr, const long long* dims,
                            const long long* strides, const int* box,
                            int esize) {
  auto enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4], estr[4];
  long long packed = dims[0] * esize;
  for (int i = 0; i < 4; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
    estr[i] = 1;
    if (i > 0) {
      gstride[i - 1] =
          static_cast<cuuint64_t>(dims[i] == 1 ? packed : strides[i - 1]);
      packed = static_cast<long long>(gstride[i - 1]) * dims[i];
    }
  }
  const CUresult r = enc(m, type, 4, const_cast<void*>(ptr), gdim, gstride,
                         gbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D, int BITS, bool PAGED, int ROWS>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using Lt = Layout<T, D, BITS>;
  if (p.split_len > kMaxSplit || p.split_len % kBatch != 0 ||
      (p.n_split > 1 && p.tickets == nullptr) || (PAGED && p.n_pool < 1))
    return cudaErrorInvalidValue;
  Maps m{};
  if constexpr (Lt::kTma) {
    // contiguous: (D, T, Hkv, B), a box of kBatch rows of one (slot, kv
    // head); pages: (D, Hkv, page size, pool pages), a box of one page's
    // rows of one kv head
    const CUtensorMapDataType type =
        BITS ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const Operand* ops[2] = {&p.k, &p.v};
    CUtensorMap* maps[2] = {&m.k, &m.v};
    for (int i = 0; i < 2; ++i) {
      const Operand& o = *ops[i];
      const long long e = Lt::kStore;
      const long long dims[4] = {Lt::kDc, PAGED ? p.H : p.T,
                                 PAGED ? p.page_size : p.H,
                                 PAGED ? p.n_pool : p.B};
      const long long strides[3] = {(PAGED ? o.s_h : o.s_t) * e,
                                    (PAGED ? o.s_t : o.s_h) * e, o.s_b * e};
      const int box[4] = {Lt::kDc, PAGED ? 1 : kBatch,
                          PAGED ? cmin(p.page_size, kBatch) : 1, 1};
      const cudaError_t err =
          make_map(maps[i], type, o.data, dims, strides, box, Lt::kStore);
      if (err != cudaSuccess) return err;
    }
  }
  dim3 grid(p.n_split, p.H * p.groups, p.B);
  wide::flash_decode_kernel<T, D, BITS, PAGED, ROWS>
      <<<grid, kThreads, 0, st>>>(p, m);
  return cudaGetLastError();
}

template <typename T, int D, int BITS, bool PAGED>
cudaError_t by_rows(const Params& p, int rows, cudaStream_t st) {
  if (rows == 1) return wide::launch<T, D, BITS, PAGED, 1>(p, st);
  if (rows == 4) return wide::launch<T, D, BITS, PAGED, 4>(p, st);
  if (rows == 8) return wide::launch<T, D, BITS, PAGED, 8>(p, st);
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t by_source(const Params& p, int bits, bool paged, int rows,
                      cudaStream_t st) {
  if (bits == 0)
    return paged ? wide::by_rows<T, D, 0, true>(p, rows, st)
                 : wide::by_rows<T, D, 0, false>(p, rows, st);
  if (bits == 8)
    return paged ? wide::by_rows<T, D, 8, true>(p, rows, st)
                 : wide::by_rows<T, D, 8, false>(p, rows, st);
  if (bits == 4)
    return paged ? wide::by_rows<T, D, 4, true>(p, rows, st)
                 : wide::by_rows<T, D, 4, false>(p, rows, st);
  return cudaErrorInvalidValue;
}

}  // namespace wide

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
// the same with the kernel of D 80, 112 and 128 (namespace wide)
#define REPRO_DECODE_DIM_WIDE(D)                                            \
  cudaError_t decode_d##D(const Params& p, bool bf16, int bits, bool paged, \
                          int rows, cudaStream_t st) {                      \
    return bf16                                                             \
               ? wide::by_source<__nv_bfloat16, D>(p, bits, paged, rows, st) \
               : wide::by_source<float, D>(p, bits, paged, rows, st);       \
  }

}  // namespace repro_decode
