// Flash-attention prefill forward for Hopper (sm_90a) on the tensor cores:
// both routes of the port's prefill kernel, bf16 and fp32.
//
// Replaces the TPU kernel flash_attention_fwd of
// src/repro/kernels/flash_attention/kernel.py (body _flash_kernel,
// _tile_update) at head_dim 64, 80, 112, 128 and 256:
// repro_flash_prefill_bf16 for bf16 inputs, repro_flash_prefill_f32 for
// fp32 ones.
//
// Files: the kernels' templates in flash_prefill.cuh; flash_prefill.d<D>.cu
// instantiate both routes one head dim a translation unit (compiled in
// parallel), linked with this file, which holds the C entry points.
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
// two-stage ring; BK = 128 kv rows at D 64, 80, 112 and 128, 64 at D 256;
// shared memory q 16 / 32 / 64 KiB + 2 stages of K and V 64 / 128 / 128
// KiB, so two D-64 blocks share an SM and one D-256 block fills one.
// D 80 and 112 (stablelm-3b, kimi-k2): a row of 160 or 224 bytes is no
// whole number of 128-byte swizzle rows, so q, K and V are laid out as at
// D 128 (pad64; both routes): S = Q K^T runs D / 16 k-slices (5 or 7) and
// O += P V one wgmma of N = D (n80, n112) whose B spans both 64-column
// blocks; the columns past D are neither copied (bf16 route) nor read
// (fp32 route: TMA's zeros), so the padding costs shared memory, not
// tensor-core work: 160 KiB a bf16 block as at D 128, where 1 - D / 128
// of it (37.5% at D 80, 12.5% at D 112) holds nothing, one block an SM.
// A later redesign would keep the rows unpadded in a 64-byte swizzle
// (80 = 5 x 16 columns, 112 = 7 x 16) and fit a second block an SM at D
// 80, or a deeper K/V ring.
// The fp32 route (F32Tiles: 128 q rows and BK 128 at D 64, BK 64 at D 80,
// 112 and 128; 64 and 32 at D 256):
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
#include "flash_prefill.cuh"

using namespace repro_prefill;

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
  switch (D) {
    case 64: return prefill_bf16_d64(p, blocks, st);
    case 80: return prefill_bf16_d80(p, blocks, st);
    case 112: return prefill_bf16_d112(p, blocks, st);
    case 128: return prefill_bf16_d128(p, blocks, st);
    case 256: return prefill_bf16_d256(p, blocks, st);
    default: return cudaErrorInvalidValue;
  }
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
                   : D == 80  ? F32Tiles<80>::kRows
                   : D == 112 ? F32Tiles<112>::kRows
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
  switch (D) {
    case 64: return prefill_f32_d64(p, parts, blocks, st);
    case 80: return prefill_f32_d80(p, parts, blocks, st);
    case 112: return prefill_f32_d112(p, parts, blocks, st);
    case 128: return prefill_f32_d128(p, parts, blocks, st);
    case 256: return prefill_f32_d256(p, parts, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// The fp32 route's layout at head dim D, as out = {q rows a block, kv rows
// a tile, dynamic shared memory bytes} ({0, 0, 0} for another D):
// kernel.py FP32_PREFILL_TILES states the first two for the CPU tests; a
// card test compares.
void repro_flash_prefill_f32_layout(int D, int* out) {
  out[0] = out[1] = out[2] = 0;
  switch (D) {
    case 64: f32_layout_d64(out); break;
    case 80: f32_layout_d80(out); break;
    case 112: f32_layout_d112(out); break;
    case 128: f32_layout_d128(out); break;
    case 256: f32_layout_d256(out); break;
    default: break;
  }
}

}  // extern "C"
