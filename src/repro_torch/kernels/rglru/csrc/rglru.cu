// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over the time axis of (B, T, D) fp32, with h_{-1} = 0.
//
// Replaces the TPU kernel rglru_scan_kernel of
// src/repro/kernels/rglru/kernel.py (body _rglru_kernel), the recurrentgemma
// prefill hot loop: the reference carries h across time blocks in VMEM
// scratch and runs a fori_loop over the rows of each block. Here blocks run
// in parallel and in no order, so nothing is carried between them: one
// thread owns one (b, d) channel and keeps h in a register for the whole T
// loop.
//
// Numerics: the update is a rounded multiply, then a rounded add
// (__fmul_rn, __fadd_rn: no fused multiply-add), in time order, which is
// the plain loop's arithmetic: the kernel equals it bit for bit. A
// time-parallel (chunked) scan would round in another order, so the time
// axis stays sequential within a channel by design.
//
// Bound on the H100: bytes. Each element is read twice (a, b) and written
// once, 12 bytes against 2 operations. What holds a channel-per-thread
// kernel back is the bytes in flight: Griffin's prefill has 20,480
// channels (B 8 x D 2560) and its long prompt 5,120 (B 2), far fewer loads
// than 3.35 TB/s x ~2 us of memory latency needs if each thread asks for
// its own next elements. So the copies are decoupled from the channels:
//   * a block is one warp over a tile of 32 channels of one batch row (a
//     128-byte row segment of a and of b), B x ceil(D / 32) blocks;
//   * a shared-memory ring of 4 stages, each 32 time rows of a and b
//     (8 KiB), filled by the Tensor Memory Accelerator: one lane asks for a
//     stage as two boxes (32 channels x 32 rows x 1 batch row) of a 3-D
//     tensor map over (D, T, B), completing on the stage's mbarrier, so a
//     box never crosses a batch row and channels past D and rows past T
//     come back as zeros; while the warp runs the chain of one stage, the
//     next 3 are in flight: 15.7 MB chip-wide at B 8 (640 blocks), 3.9 MB
//     at B 2 (160 blocks). Deeper rings were slower at B 2 x T 2100 (8
//     stages: 0.0533 ms, 4: 0.0458; chip_smoke.py on an H100);
//   * TMA needs 16-byte aligned pointers and row strides: where D % 4 != 0
//     or a pointer is not aligned, every lane copies its own channel with
//     4-byte cp.async instead (the plan's vec 4);
//   * each lane reads its channel's 32 a and b values of a stage from
//     shared memory into registers (one bank a lane) and runs the chain of
//     32 updates; the 32 x 32 h tile goes back through one of two shared
//     tiles as one TMA store (4-byte stores by each lane on the cp.async
//     path). With each lane storing its own h_t at every step (one 128-byte
//     row segment a warp) the stores took most of the time: 0.1125 ms at
//     B 2 x T 2100, against 0.0533 with TMA stores (8 stages both;
//     chip_smoke.py on an H100).
// Why TMA and not the lanes' own 16-byte cp.async: filled that way, a
// block streamed at 4-5 GB/s whatever the ring's depth (0.1377 ms at B 2 x
// T 2100, chip_smoke.py on an H100), as if each thread could keep only a
// few copies in flight.
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                       // channels a block (a warp)
constexpr int kRows = 32;                       // time rows a stage
constexpr int kStageFloats = 2 * kRows * kTile;  // a rows, then b rows
constexpr int kStageBytes = kStageFloats * 4;
constexpr int kStages = 4;                      // the ring's depth
// dynamic shared memory: the ring, two h tiles, 128 bytes of alignment
// slack, an mbarrier a stage
constexpr int kSmem =
    kStages * kStageBytes + 2 * kRows * kTile * 4 + 128 + 8 * kStages;
static_assert(kSmem <= 232448, "227 KB a block");

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
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// box (c0, c1, c2) of a 3-D tensor map from shared memory at src
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* m, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk stores committed before the last N have read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's generic-proxy writes to shared memory, visible to the TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stage of time rows t0 .. t0 + kRows - 1 of the block's tile into the
// ring slot at shared address st. TMA (VEC 16): lane 0 asks for the a and
// b boxes, counted on the slot's mbarrier. Otherwise (VEC 4) every lane
// copies its own channel's rows below T, 4 bytes at a time.
template <int VEC>
__device__ __forceinline__ void load_stage(const CUtensorMap* ma,
                                           const CUtensorMap* mb,
                                           const float* a, const float* b,
                                           long long base, int bi, int d0,
                                           int t0, int T, int D, int nd,
                                           uint32_t st, uint32_t bar) {
  const int lane = threadIdx.x;
  if (VEC == 16) {
    if (lane == 0) {
      mbar_expect_tx(bar, kStageBytes);
      tma_load_3d(st, ma, d0, t0, bi, bar);
      tma_load_3d(st + kStageBytes / 2, mb, d0, t0, bi, bar);
    }
  } else {
    if (lane >= nd) return;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r;
      if (t >= T) break;
      const long long off = base + static_cast<long long>(t) * D + lane;
      cp_async4(st + (r * kTile + lane) * 4, a + off);
      cp_async4(st + (kRows * kTile + r * kTile + lane) * 4, b + off);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kTile)
rglru_scan_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mh,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int T, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t s0 = (raw + 127u) & ~127u;      // TMA: 128-byte aligned
  const float* ring = reinterpret_cast<const float*>(smem_raw + (s0 - raw));
  // after the ring: two h tiles (TMA path), then the stages' mbarriers
  const uint32_t hs0 = s0 + kStages * kStageBytes;
  float* const hbuf = const_cast<float*>(ring) + kStages * kStageFloats;
  const uint32_t b0 = hs0 + 2 * kRows * kTile * 4;
  const int lane = threadIdx.x;
  const int tiles = (D + kTile - 1) / kTile;
  const int bi = blockIdx.x / tiles, d0 = (blockIdx.x % tiles) * kTile;
  const int nd = min(kTile, D - d0);
  const long long base = static_cast<long long>(bi) * T * D + d0;
  const int nst = (T + kRows - 1) / kRows;
  if (VEC == 16 && lane == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(b0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto load = [&](int s) {
    load_stage<VEC>(&ma, &mb, a, b, base, bi, d0, s * kRows, T, D, nd,
                    s0 + (s % kStages) * kStageBytes, b0 + 8 * (s % kStages));
  };

  // prologue: stages 0 .. kStages - 2 in flight (cp.async: one commit group
  // each)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load(s);
    if (VEC != 16) cp_async_commit();
  }
  float state = 0.f;
  for (int s = 0; s < nst; ++s) {
    if (VEC == 16) {
      mbar_wait(b0 + 8 * (s % kStages), (s / kStages) & 1);
    } else {
      // groups committed: kStages - 1 + s; stage s is group s
      cp_async_wait<kStages - 2>();
    }
    __syncwarp();   // stage s landed for every lane; stage s - 1 was read
    if (s + kStages - 1 < nst) load(s + kStages - 1);
    if (VEC != 16) cp_async_commit();

    // the stage's a and b into registers first, then the chain, then the
    // stores
    const float* sa = ring + (s % kStages) * kStageFloats + lane;
    const float* sb = sa + kRows * kTile;
    const int t0 = s * kRows;
    const int nr = min(kRows, T - t0);
    float av[kRows], bv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      av[r] = sa[r * kTile];
      bv[r] = sb[r * kTile];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // past T: h stays as it is (those rows are not stored)
      const float nxt = __fadd_rn(__fmul_rn(av[r], state), bv[r]);
      state = r < nr ? nxt : state;
      bv[r] = state;
    }
    if (VEC == 16) {
      // h through one of two shared tiles and out as one TMA box (rows past
      // T and channels past D are clipped); the tile's store of stage s - 2
      // must have read it first
      const int j = s & 1;
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
      float* hb = hbuf + j * kRows * kTile + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) hb[r * kTile] = bv[r];
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&mh, hs0 + j * kRows * kTile * 4, d0, t0, bi);
        bulk_commit();
      }
    } else if (lane < nd) {
      float* hp = h + base + static_cast<long long>(t0) * D + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) hp[static_cast<long long>(r) * D] = bv[r];
    }
  }
  if (VEC == 16) {
    if (lane == 0) bulk_wait_all();
  } else {
    cp_async_wait<0>();
  }
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// (B, T, D) fp32 as a 3-D map, boxes of kTile channels x kRows rows x 1
cudaError_t make_map(CUtensorMap* m, const float* x, int B, int T, int D) {
  auto enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(T) * D * 4};
  const cuuint32_t box[3] = {kTile, kRows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<float*>(x), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int VEC>
cudaError_t launch(const float* a, const float* b, float* h, int B, int T,
                   int D, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        rglru_scan_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  CUtensorMap ma{}, mb{}, mh{};
  if (VEC == 16) {
    cudaError_t e = make_map(&ma, a, B, T, D);
    if (e == cudaSuccess) e = make_map(&mb, b, B, T, D);
    if (e == cudaSuccess) e = make_map(&mh, h, B, T, D);
    if (e != cudaSuccess) return e;
  }
  const long long blocks =
      static_cast<long long>(B) * ((D + kTile - 1) / kTile);
  rglru_scan_kernel<VEC>
      <<<static_cast<unsigned>(blocks), kTile, kSmem, st>>>(ma, mb, mh, a, b,
                                                          h, T, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel's layout as out = {tile, rows, stages, dynamic shared memory
// bytes}: kernel.py plan() states the same numbers for the CPU tests; a
// card test compares them.
void repro_rglru_layout(int* out) {
  out[0] = kTile;
  out[1] = kRows;
  out[2] = kStages;
  out[3] = kSmem;
}

// a, b, h contiguous (B, T, D) fp32; h is written whole. vec from
// kernel.py plan(): 16 (TMA; D % 4 == 0 and 16-byte aligned pointers) or 4
// (cp.async); anything else is refused.
int repro_rglru_scan(const void* a, const void* b, void* h, int B, int T,
                     int D, int vec, void* stream) {
  if (B == 0 || T == 0 || D == 0) return cudaSuccess;
  auto pa = static_cast<const float*>(a);
  auto pb = static_cast<const float*>(b);
  auto ph = static_cast<float*>(h);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    if (D % 4 != 0 || (reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b) |
                       reinterpret_cast<uintptr_t>(h)) % 16 != 0)
      return cudaErrorInvalidValue;
    return launch<16>(pa, pb, ph, B, T, D, st);
  }
  if (vec == 4) return launch<4>(pa, pb, ph, B, T, D, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
