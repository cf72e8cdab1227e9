// Flash attention for Hopper (sm_90a): the fp32 prefill forward.
//
// Replaces the TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention/kernel.py (prefill; body _flash_kernel,
// _tile_update) for fp32 inputs -> repro_flash_attention_fwd /
// flash_fwd_kernel. bf16 prefill runs on the tensor-core kernel of
// flash_prefill.cu and decode on flash_decode.cu; this is the fp32 route,
// which the fp32 parity checks hold to 2e-5 (TF32 products would not meet
// that).
//
// Semantics (the masking rule of _tile_update): s = (q.k) * scale, optional
// softcap s = cap * tanh(s / cap); a (q, kv) pair is visible iff
// kp >= 0 && qp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window).
// Online softmax in fp32 with the fully-masked-row guard; l == 0 gives an
// output of 0 and lse = -1e30, otherwise lse = m + log(l). Any S and T: the
// ragged edges are masked here, nothing is padded. q and k/v may be strided
// views (last dim contiguous), so the model's (B, T, Hkv, D) layout is read
// in place without a copy.
//
// Bound on the H100: at pimref's shape (B 8, H 12, S = T = 512, D 64) the
// bytes of q, k, v, out and lse over 3.35 TB/s, with the fp32 FMA work over
// 67 TFLOP/s close behind. What the design does about it:
//   * each K/V tile is read from device memory once per block and staged in
//     shared memory in fp32, where every q row of the block reuses it (all G
//     query heads of a kv head ride in one block, so GQA reads K/V once per
//     kv head);
//   * scores and probabilities never leave shared memory;
//   * tiles whose (q, kv) pairs are all masked are skipped before K/V load
//     (the upper causal triangle, tiles left of the window, -1 slots).
// Both products are fp32 FMA loops over the staged tiles with seven block
// barriers per 64-row tile: what holds it back. It runs on no bf16 serving
// path; the fp32 parity phases use it.
//
// Head dims 64, 128 and 256. At D 256 the fp32 staging of 64 q rows and of
// one 64-row K and V tile takes 216,832 bytes of shared memory, within the
// 232,448 a block may use, so a D-256 block runs alone on its SM. With MQA
// (one kv head, G q heads) a block packs G heads x 64 / G positions.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// One K or V operand (B, Hkv, T, D) by element strides.
struct KVOperand {
  const void* data;
  long long s_b, s_h, s_t;
};

struct Params {
  const void* q;
  KVOperand k, v;
  const int* qpos;    // (B, S)
  const int* kpos;    // (B, T)
  long long qs_b, qs_h, qs_g, qs_s;  // element strides of q (B, Hkv, G, S, D)
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

  // shared-memory layout, in 4-byte words (fp32 / int32), then the 8-byte
  // element offsets of the q rows and of the K and V rows of the tile
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
  static constexpr size_t kOffBytes = ((kWords * 4 + 15) / 16) * 16;
  static constexpr size_t kSmemBytes =
      kOffBytes + (ROWS + 2 * BK) * sizeof(long long);

  struct Smem {
    float* q; float* k; float* v; float* p; float* m; float* l; float* a;
    int* kp; int* qp;
    long long* rowoff; long long* koff; long long* voff;
    __device__ explicit Smem(unsigned char* raw) {
      float* f = reinterpret_cast<float*>(raw);
      q = f + kQ; k = f + kK; v = f + kV; p = f + kP;
      m = f + kM; l = f + kL; a = f + kA;
      kp = reinterpret_cast<int*>(f + kKp);
      qp = reinterpret_cast<int*>(f + kQp);
      rowoff = reinterpret_cast<long long*>(raw + kOffBytes);
      koff = rowoff + ROWS;
      voff = koff + BK;
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

  // Online softmax of the staged rows over logical kv rows [t_begin, t_end).
  __device__ static void run(const Params& p, int b, int h, int t_begin,
                             int t_end, const Smem& sm, float (&acc)[RPT][DPT]) {
    const int tid = threadIdx.x;
    const int ty = tid / TX, tx = tid % TX;
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

      // where each kv row of the tile lives
      for (int c = tid; c < BK; c += kThreads) {
        const long long t = t0 + c;
        if (t >= t_end) continue;
        sm.koff[c] = b * p.k.s_b + h * p.k.s_h + t * p.k.s_t;
        sm.voff[c] = b * p.v.s_b + h * p.v.s_h + t * p.v.s_t;
      }
      __syncthreads();

      for (int idx = tid; idx < BK * D; idx += kThreads) {
        const int c = idx / D, d = idx % D;
        float kv = 0.f, vv = 0.f;
        if (t0 + c < t_end) {
          kv = to_f32(static_cast<const T*>(p.k.data)[sm.koff[c] + d]);
          vv = to_f32(static_cast<const T*>(p.v.data)[sm.voff[c] + d]);
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

KVOperand operand(const void* data, long long s_b, long long s_h,
                  long long s_t) {
  KVOperand o;
  o.data = data;
  o.s_b = s_b; o.s_h = s_h; o.s_t = s_t;
  return o;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fp32 prefill (bf16 prefill is repro_flash_prefill_bf16 of
// flash_prefill.cu). q (B, Hkv, G, S, D), k/v (B, Hkv, T, D) by element
// strides; out contiguous (B, Hkv, G, S, D); lse contiguous (B, Hkv, G, S).
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* lse, long long qs_b, long long qs_h,
    long long qs_g, long long qs_s, long long ks_b, long long ks_h, long long ks_t,
    long long vs_b, long long vs_h, long long vs_t, int B, int H, int G, int S,
    int T, int D, int causal, int window, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q;
  p.k = operand(k, ks_b, ks_h, ks_t);
  p.v = operand(v, vs_b, vs_h, vs_t);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_g = qs_g; p.qs_s = qs_s;
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  if (D == 64) return launch_fwd<float, 64>(p, out, lse, st);
  if (D == 128) return launch_fwd<float, 128>(p, out, lse, st);
  if (D == 256) return launch_fwd<float, 256>(p, out, lse, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
