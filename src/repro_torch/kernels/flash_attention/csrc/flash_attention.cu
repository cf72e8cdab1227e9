// Flash attention for Hopper (sm_90a): prefill forward and split-KV decode.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   * flash_attention_fwd (prefill; body _flash_kernel, _tile_update)
//       -> repro_flash_attention_fwd / flash_fwd_kernel
//   * flash_decode_fwd (every decode step)
//       -> repro_flash_decode_fwd / flash_decode_partial_kernel
//          + flash_decode_combine_kernel
//
// Semantics (the masking rule of _tile_update): s = (q.k) * scale, optional
// softcap s = cap * tanh(s / cap); a (q, kv) pair is visible iff
// kp >= 0 && qp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window).
// Online softmax in fp32 with the fully-masked-row guard; l == 0 gives an
// output of 0 and lse = -1e30, otherwise lse = m + log(l). Output has q's
// dtype. Any S and T: the ragged edges are masked here, nothing is padded.
// q/k/v may be strided views (last dim contiguous), so the model's
// (B, T, Hkv, D) cache layout is read in place without a transposing copy.
//
// Bound on the H100: at the serving shapes both kernels move far fewer
// operations than bytes would allow, so the floor is the bytes of q, k, v
// (and out) over 3.35 TB/s (decode: the K/V cache stream, ~14 MB per launch
// at B=8, T=576, Hkv=12, D=64, bf16). What the design does about it:
//   * each K/V tile is read from device memory once per block and staged in
//     shared memory, where every q row of the block reuses it (all G query
//     heads of a kv head ride in one block, so GQA reads K/V once per kv head);
//   * scores and probabilities never leave shared memory;
//   * tiles whose (q, kv) pairs are all masked are skipped before K/V load
//     (dead ring slots, the upper causal triangle);
//   * decode splits the kv axis over blocks (flash-decoding) so B*Hkv*n_split
//     blocks fill the 132 SMs, and a second pass merges the partials in a
//     fixed order (no atomics: results are bitwise reproducible).
// This first version multiplies with fp32 FMA loops; tensor cores (mma/wgmma)
// and TMA pipelines are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;    // (B, S)
  const int* kpos;    // (B, T)
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q (B, Hkv, G, S, D)
  long long ks_b, ks_h, ks_t;        // element strides of k (B, Hkv, T, D)
  long long vs_b, vs_h, vs_t;        // element strides of v
  int B, H, G, S, T;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  bool m = (kp >= 0) && (qp >= 0);
  if (causal) m = m && (kp <= qp);
  if (window > 0) m = m && (kp > qp - window);
  return m;
}

// One block: ROWS query rows staged in shared memory against a stream of
// BK-row K/V tiles. 256 threads laid out TY x TX for the score tile and the
// output accumulator; kThreads / ROWS threads per row for the softmax update.
template <typename T, int D, int ROWS, int BK, int TY>
struct Tile {
  static constexpr int TX = kThreads / TY;
  static constexpr int RPT = ROWS / TY;          // rows per thread
  static constexpr int CPT = BK / TX;            // score columns per thread
  static constexpr int DPT = D / TX;             // output columns per thread
  static constexpr int TPR = kThreads / ROWS;    // softmax threads per row
  static_assert(ROWS % TY == 0 && BK % TX == 0 && D % TX == 0, "tiling");
  static_assert(kThreads % ROWS == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0,
                "softmax row groups must be power-of-two slices of a warp");

  // shared-memory layout, in 4-byte words (fp32 / int32), then row offsets
  static constexpr int DP = D + 1;     // +1: conflict-free column reads
  static constexpr int BKP = BK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + ROWS * DP;
  static constexpr int kV = kK + BK * DP;
  static constexpr int kP = kV + BK * DP;
  static constexpr int kM = kP + ROWS * BKP;
  static constexpr int kL = kM + ROWS;
  static constexpr int kA = kL + ROWS;
  static constexpr int kKp = kA + ROWS;
  static constexpr int kQp = kKp + BK;
  static constexpr int kWords = kQp + ROWS;
  static constexpr size_t kRowOffBytes = ((kWords * 4 + 15) / 16) * 16;
  static constexpr size_t kSmemBytes = kRowOffBytes + ROWS * sizeof(long long);

  struct Smem {
    float* q; float* k; float* v; float* p; float* m; float* l; float* a;
    int* kp; int* qp; long long* rowoff;
    __device__ explicit Smem(unsigned char* raw) {
      float* f = reinterpret_cast<float*>(raw);
      q = f + kQ; k = f + kK; v = f + kV; p = f + kP;
      m = f + kM; l = f + kL; a = f + kA;
      kp = reinterpret_cast<int*>(f + kKp);
      qp = reinterpret_cast<int*>(f + kQp);
      rowoff = reinterpret_cast<long long*>(raw + kRowOffBytes);
    }
  };

  // Stage the q rows whose element offsets (-1 = no row) and positions the
  // caller wrote to sm.rowoff / sm.qp, and reset the softmax state.
  __device__ static void load_q(const Params& p, const Smem& sm) {
    const T* q = static_cast<const T*>(p.q);
    for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const long long off = sm.rowoff[r];
      sm.q[r * DP + d] = off >= 0 ? to_f32(q[off + d]) : 0.f;
    }
    for (int r = threadIdx.x; r < ROWS; r += kThreads) {
      sm.m[r] = kNegInf;
      sm.l[r] = 0.f;
    }
    __syncthreads();
  }

  // Online softmax of the staged rows over kv rows [t_begin, t_end).
  __device__ static void run(const Params& p, int b, int h, int t_begin,
                             int t_end, const Smem& sm, float (&acc)[RPT][DPT]) {
    const int tid = threadIdx.x;
    const int ty = tid / TX, tx = tid % TX;
    const T* kb = static_cast<const T*>(p.k) + b * p.ks_b + h * p.ks_h;
    const T* vb = static_cast<const T*>(p.v) + b * p.vs_b + h * p.vs_h;
    const int* kpos = p.kpos + static_cast<long long>(b) * p.T;

    for (int t0 = t_begin; t0 < t_end; t0 += BK) {
      for (int c = tid; c < BK; c += kThreads) {
        const int t = t0 + c;
        sm.kp[c] = t < t_end ? kpos[t] : -1;
      }
      __syncthreads();
      // skip tiles in which no (q, kv) pair is visible: no numeric effect
      int any = 0;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          any |= visible(sm.qp[ty + TY * i], sm.kp[tx + TX * j], p.causal,
                         p.window);
      if (!__syncthreads_or(any)) continue;

      for (int idx = tid; idx < BK * D; idx += kThreads) {
        const int c = idx / D, d = idx % D;
        const int t = t0 + c;
        float kv = 0.f, vv = 0.f;
        if (t < t_end) {
          kv = to_f32(kb[t * p.ks_t + d]);
          vv = to_f32(vb[t * p.vs_t + d]);
        }
        sm.k[c * DP + d] = kv;
        sm.v[c * DP + d] = vv;
      }
      __syncthreads();

      // scores: s = (q . k) * scale, softcap, mask (masked -> -inf)
      float s[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[RPT], kv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = sm.q[(ty + TY * i) * DP + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kv[j] = sm.k[(tx + TX * j) * DP + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + TX * j;
          float x = s[i][j] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          sm.p[r * BKP + c] =
              visible(sm.qp[r], sm.kp[c], p.causal, p.window) ? x : -INFINITY;
        }
      }
      __syncthreads();

      // online-softmax update, TPR threads per row (one warp slice)
      {
        const int r = tid / TPR, lane = tid % TPR;
        const float m_prev = sm.m[r];
        const float l_prev = sm.l[r];
        float mx = -INFINITY;
        for (int c = lane; c < BK; c += TPR) mx = fmaxf(mx, sm.p[r * BKP + c]);
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_prev, mx);
        // fully-masked guard: exp(NEG_INF - NEG_INF) would be 1
        const float safe_m = m_new <= kNegInf * 0.5f ? 0.f : m_new;
        float sum = 0.f;
        for (int c = lane; c < BK; c += TPR) {
          const float e = expf(sm.p[r * BKP + c] - safe_m);  // masked: 0
          sm.p[r * BKP + c] = e;
          sum += e;
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha =
              m_prev <= kNegInf * 0.5f ? 0.f : expf(m_prev - safe_m);
          sm.a[r] = alpha;
          sm.l[r] = l_prev * alpha + sum;
          sm.m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p @ v
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float alpha = sm.a[ty + TY * i];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      }
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pv[RPT], vv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = sm.p[(ty + TY * i) * BKP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) vv[j] = sm.v[c * DP + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// ---------------------------------------------------------------------------
// Prefill: one block per (q tile, g group) x kv head x batch row. A block
// holds BQ = 64 / GG query positions of GG = min(G, 64) query heads, so the
// G heads of one kv head share every K/V tile.
// ---------------------------------------------------------------------------
constexpr int kPrefillRows = 64;
template <typename T, int D>
using PrefillTile = Tile<T, D, kPrefillRows, 64, 16>;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p, T* __restrict__ out, float* __restrict__ lse) {
  using TL = PrefillTile<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const typename TL::Smem sm(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int GG = min(p.G, kPrefillRows), BQ = kPrefillRows / GG;
  const int ngg = (p.G + GG - 1) / GG;
  const int qt = blockIdx.x / ngg, gg = blockIdx.x % ngg;

  for (int r = threadIdx.x; r < kPrefillRows; r += kThreads) {
    const int gl = r / BQ, g = gg * GG + gl, s = qt * BQ + r % BQ;
    const bool ok = gl < GG && g < p.G && s < p.S;
    sm.rowoff[r] = ok ? b * p.qs_b + h * p.qs_h + g * p.qs_g + s * p.qs_s : -1;
    sm.qp[r] = ok ? p.qpos[static_cast<long long>(b) * p.S + s] : -1;
  }
  __syncthreads();
  TL::load_q(p, sm);

  float acc[TL::RPT][TL::DPT];
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
    for (int j = 0; j < TL::DPT; ++j) acc[i][j] = 0.f;
  TL::run(p, b, h, 0, p.T, sm, acc);

  const int ty = threadIdx.x / TL::TX, tx = threadIdx.x % TL::TX;
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    const int r = ty + 16 * i;
    if (sm.rowoff[r] < 0) continue;
    const int g = gg * GG + r / BQ, s = qt * BQ + r % BQ;
    const long long orow = ((static_cast<long long>(b) * p.H + h) * p.G + g) * p.S + s;
    const float l = sm.l[r];
    const float lsafe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < TL::DPT; ++j)
      out[orow * D + tx + TL::TX * j] = from_f32<T>(acc[i][j] / lsafe);
    if (tx == 0) {
      const float m = sm.m[r];
      lse[orow] = m <= kNegInf * 0.5f ? kNegInf : m + logf(lsafe);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode (flash-decoding): grid (n_split, Hkv, B). Each block takes all G*S
// query rows of its kv head, 8 rows at a time, against kv rows
// [split * split_len, (split + 1) * split_len), and writes partial (m, l, acc)
// for the combine pass.
// ---------------------------------------------------------------------------
constexpr int kDecodeRows = 8;
template <typename T, int D>
using DecodeTile = Tile<T, D, kDecodeRows, 64, 8>;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_partial_kernel(Params p, int split_len, float* __restrict__ pm,
                            float* __restrict__ pl, float* __restrict__ pacc) {
  using TL = DecodeTile<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const typename TL::Smem sm(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y, split = blockIdx.x;
  const int n_split = gridDim.x;
  const int R = p.G * p.S;
  const int t_begin = split * split_len;
  const int t_end = min(p.T, t_begin + split_len);
  const int ty = threadIdx.x / TL::TX, tx = threadIdx.x % TL::TX;

  for (int rt = 0; rt < R; rt += kDecodeRows) {
    for (int r = threadIdx.x; r < kDecodeRows; r += kThreads) {
      const int row = rt + r;
      const bool ok = row < R;
      const int g = ok ? row / p.S : 0, s = ok ? row % p.S : 0;
      sm.rowoff[r] = ok ? b * p.qs_b + h * p.qs_h + g * p.qs_g + s * p.qs_s : -1;
      sm.qp[r] = ok ? p.qpos[static_cast<long long>(b) * p.S + s] : -1;
    }
    __syncthreads();
    TL::load_q(p, sm);

    float acc[TL::RPT][TL::DPT];
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
      for (int j = 0; j < TL::DPT; ++j) acc[i][j] = 0.f;
    TL::run(p, b, h, t_begin, t_end, sm, acc);

#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = ty + 8 * i;
      const int row = rt + r;
      if (row >= R) continue;
      const long long base =
          ((static_cast<long long>(b) * p.H + h) * n_split + split) * R + row;
#pragma unroll
      for (int j = 0; j < TL::DPT; ++j) pacc[base * D + tx + TL::TX * j] = acc[i][j];
      if (tx == 0) {
        pm[base] = sm.m[r];
        pl[base] = sm.l[r];
      }
    }
    __syncthreads();
  }
}

// Merge the n_split partials of one q row through their max, in split order.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ pm,
                                            const float* __restrict__ pl,
                                            const float* __restrict__ pacc,
                                            T* __restrict__ out, int R,
                                            int n_split, int D) {
  const long long row = blockIdx.x;          // (b * H + h) * R + r
  const long long bh = row / R, r = row % R;
  const int d = threadIdx.x;
  float M = kNegInf;
  for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, pm[(bh * n_split + sp) * R + r]);
  const float safe = M <= kNegInf * 0.5f ? 0.f : M;
  float L = 0.f, a = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const long long idx = (bh * n_split + sp) * R + r;
    const float m = pm[idx];
    const float w = m <= kNegInf * 0.5f ? 0.f : expf(m - safe);
    L += pl[idx] * w;
    a += pacc[idx * D + d] * w;
  }
  out[row * D + d] = from_f32<T>(a / (L == 0.f ? 1.f : L));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, void* out, void* lse, cudaStream_t st) {
  using TL = PrefillTile<T, D>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, TL::kSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int GG = p.G < kPrefillRows ? p.G : kPrefillRows;
  const int BQ = kPrefillRows / GG;
  const int nq = (p.S + BQ - 1) / BQ, ngg = (p.G + GG - 1) / GG;
  dim3 grid(nq * ngg, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, TL::kSmemBytes, st>>>(
      p, static_cast<T*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const Params& p, int n_split, int split_len, void* out,
                          float* pm, float* pl, float* pacc, cudaStream_t st) {
  using TL = DecodeTile<T, D>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = allow_smem(flash_decode_partial_kernel<T, D>, TL::kSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid(n_split, p.H, p.B);
  flash_decode_partial_kernel<T, D><<<grid, kThreads, TL::kSmemBytes, st>>>(
      p, split_len, pm, pl, pacc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int R = p.G * p.S;
  flash_decode_combine_kernel<T><<<p.B * p.H * R, D, 0, st>>>(
      pm, pl, pacc, static_cast<T*>(out), R, n_split, D);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* qpos,
                   const void* kpos, long long qs_b, long long qs_h, long long qs_g,
                   long long qs_s, long long ks_b, long long ks_h, long long ks_t,
                   long long vs_b, long long vs_h, long long vs_t, int B, int H,
                   int G, int S, int T, int causal, int window, float softcap,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_g = qs_g; p.qs_s = qs_s;
  p.ks_b = ks_b; p.ks_h = ks_h; p.ks_t = ks_t;
  p.vs_b = vs_b; p.vs_h = vs_h; p.vs_t = vs_t;
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Hkv, G, S, D), k/v (B, Hkv, T, D) by element strides; out contiguous
// (B, Hkv, G, S, D) in q's dtype; lse contiguous (B, Hkv, G, S) fp32.
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* lse, long long qs_b, long long qs_h,
    long long qs_g, long long qs_s, long long ks_b, long long ks_h, long long ks_t,
    long long vs_b, long long vs_h, long long vs_t, int B, int H, int G, int S,
    int T, int D, int is_bf16, int causal, int window, float softcap,
    float scale, void* stream) {
  const Params p = make_params(q, k, v, qpos, kpos, qs_b, qs_h, qs_g, qs_s, ks_b,
                               ks_h, ks_t, vs_b, vs_h, vs_t, B, H, G, S, T,
                               causal, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  if (is_bf16) {
    if (D == 64) return launch_fwd<__nv_bfloat16, 64>(p, out, lse, st);
    if (D == 128) return launch_fwd<__nv_bfloat16, 128>(p, out, lse, st);
  } else {
    if (D == 64) return launch_fwd<float, 64>(p, out, lse, st);
    if (D == 128) return launch_fwd<float, 128>(p, out, lse, st);
  }
  return cudaErrorInvalidValue;
}

// Same operand layout as the prefill entry point; pm/pl (B, Hkv, n_split, G*S)
// and pacc (B, Hkv, n_split, G*S, D) fp32 are scratch from the caller.
int repro_flash_decode_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* pm, void* pl, void* pacc, long long qs_b,
    long long qs_h, long long qs_g, long long qs_s, long long ks_b, long long ks_h,
    long long ks_t, long long vs_b, long long vs_h, long long vs_t, int B, int H,
    int G, int S, int T, int D, int is_bf16, int n_split, int split_len,
    int causal, int window, float softcap, float scale, void* stream) {
  const Params p = make_params(q, k, v, qpos, kpos, qs_b, qs_h, qs_g, qs_s, ks_b,
                               ks_h, ks_t, vs_b, vs_h, vs_t, B, H, G, S, T,
                               causal, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* a = static_cast<float*>(pacc);
  if (is_bf16) {
    if (D == 64) return launch_decode<__nv_bfloat16, 64>(p, n_split, split_len, out, m, l, a, st);
    if (D == 128) return launch_decode<__nv_bfloat16, 128>(p, n_split, split_len, out, m, l, a, st);
  } else {
    if (D == 64) return launch_decode<float, 64>(p, n_split, split_len, out, m, l, a, st);
    if (D == 128) return launch_decode<float, 128>(p, n_split, split_len, out, m, l, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
