// Split-KV decode attention for Hopper (sm_90a): one streaming kernel for
// every KV-cache layout of the serving engine.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   * flash_decode_fwd (:174), decode over the contiguous ring cache;
//   * flash_decode_quant_fwd (:262), over int8 or nibble-packed int4 codes
//     with one fp32 scale per row (_dequant_rows);
//   * flash_decode_paged_fwd (:359), over a page pool through a per-slot
//     page table (page 0 is the trash page);
//   * flash_decode_paged_quant_fwd (:443), both;
// -> repro_flash_decode / flash_decode_kernel<T, D, BITS, PAGED, NR>, plus
// flash_decode_combine_kernel when the kv axis is split over blocks, at D
// 64 and 256; at D 80, 112 and 128 wide::flash_decode_kernel<T, D, BITS,
// PAGED, ROWS>, which merges the splits itself (below). The four layouts
// differ only in how a K/V row is found (PAGED) and decoded (BITS: values
// of q's type, int8 or int4 codes), so a paged launch is bitwise equal to
// a contiguous launch on the gathered pages.
//
// Files: the templates in flash_decode.cuh; flash_decode.d<D>.cu
// instantiate them one head dim a translation unit (nvcc compiles the five
// in parallel: one unit of 180 instantiations took 164 s on the H100's
// host), linked with this file, which holds the C entry point.
//
// Semantics (the masking rule of _tile_update): s = (q.k) * scale, optional
// softcap s = cap * tanh(s / cap); a (q, kv) pair is visible iff
// kp >= 0 && qp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window).
// fp32 products, codes dequantized in fp32 (code * scale) whatever q's
// dtype, and an fp32 online softmax with the fully-masked-row guard: l == 0
// gives an output of 0. Output has q's dtype. q is (B, Hkv, G, S, D) by
// element strides; K/V rows are (B, Hkv, T) or (page, Hkv, row in page) by
// element strides, aligned to the chunk a row is copied in (16 bytes; 8 for
// int4 rows at D 80 and 112). Head dims 64, 80, 112, 128 and 256. Any S, G
// and T: nothing is padded.
//
// Bound on the H100: bytes. One decode step streams the visible K/V rows
// (codes and scales where the cache holds codes, the table when paged)
// plus q, the positions and out, over 3.35 TB/s: 13.5 MB, 4.0 us at
// pimref's B 8, Hkv 12, T 576, D 64 in bf16; half that in int8. The FMA
// work is one (MHA) to ten (Griffin's MQA, G 10) per K/V element, far below
// the card's ridge point. What the design does about it:
//   * streaming, not tiling: a block is one warp that owns one kv split of
//     one (slot, kv head, group of NR q rows); it copies the split's K/V
//     rows as stored (values or codes, no fp32 staging) with 16-byte
//     cp.async into a warp-private ring of kStages stages, synchronised by
//     cp.async.wait_group and __syncwarp alone: no block barrier anywhere;
//   * it loads the split's kv positions (and table entries) first, and
//     compacts the rows visible to at least one of its q rows into a list
//     before any K/V byte is requested: dead ring slots, trash-page rows
//     and rows outside the window cost no bytes;
//   * rows to lanes: D / 8 lanes own a row, 8 elements each (16 bytes of
//     bf16, 8 of int8, 4 of int4, 32 of fp32), so a warp takes 32 / (D / 8)
//     rows a step; each lane keeps its 8-element slice of every q row and
//     of every output row in fp32 registers, dequantizes in registers and
//     reduces a score over the row's lanes with __shfl_xor_sync;
//   * each row group keeps an online (m, l, acc) per q row and rescales
//     once per ring stage (1-4 kv rows); the groups of a warp merge in a
//     fixed order at the end;
//   * NR (1, 2 or 4) q rows a block: pimref's one-token step computes one
//     row; Griffin's 10 heads run as groups of 4, 4 and 2 that stream the
//     same split (the later reads mostly hit L2). A warp's rows run one
//     after another on its SM sub-partition, and at these grids a
//     sub-partition holds one or two warps, so more rows a block would
//     lengthen each warp's chain of dependent shuffles and exps with
//     nothing to hide it;
//   * the split policy (decode_plan in kernel.py, a function of the shapes
//     only) gives at least ~1000 one-warp blocks where T allows, so the
//     stream is spread over all 132 SMs; with one split the kernel writes
//     out itself, otherwise a second launch merges the partials in split
//     order (no atomics: results are bitwise reproducible).
// No tensor cores: at G 10 and D 256 the fp32 FMA work is about half the
// byte bound; an mma.sync route for many q rows would round p to bf16.
//
// D 80, 112 and 128 (stablelm-3b's 32 heads, kimi-k2's 8 q heads a kv
// head, mixtral's and pixtral's 4), namespace wide:
//   * one pass over a split: a block of four warps streams one kv split of
//     one (slot, kv head) for all of the kv head's q rows (ROWS 1, 4 or 8
//     a block, 2 rows as 4, groups of 8 past 8: kimi-k2's G 8 in one
//     block; the one-warp blocks took them as two groups of 4, each
//     streaming the split). Warps split the q rows and the kv rows of
//     each stage: NR q rows a warp (1 or 4), WQ x WK warps (1 x 4, 1 x 4,
//     2 x 2), so an element read from shared memory serves NR q rows;
//   * staging: a split (at most 128 rows) is 16-row stages; warp 0 loads
//     the split's positions (and pages) first and keeps the live stages,
//     those with a row visible to some q row, in kv order (dead ring slots
//     and whole empty pages cost no bytes); a live stage comes as one TMA
//     box of K and one of V (contiguous: 16 rows of a (slot, kv head);
//     pages: a page's rows of one kv head, two boxes for pages of 8) into
//     a shared ring of about 12 KiB (at least 2 stages: 10 KiB of bf16 K
//     and V at D 80, 16 KiB at D 128; up to 8 stages of codes), an mbarrier a stage that warp 0's lanes
//     arrive on (their scales' cp.async with them) and one the warps free
//     it on; warp 0 refills a stage once all four are done with it. int4
//     rows of 40 and 56 bytes (8 bytes off 16 at odd rows) are no TMA box:
//     lanes copy them in 8-byte cp.async chunks, counted on the same
//     barrier (cp.async.mbarrier.arrive). The small ring keeps many blocks
//     on an SM (measured on the H100: 12 KiB beat 20 and 40 KiB at
//     stablelm-3b's step);
//   * lanes: a row takes 16 lanes, lane i elements i, i + 16, .. (5 at D
//     80, 7 at D 112, 8 at D 128): no lane idle (the one-warp kernel's
//     D / 8 lanes a row would leave 6 / 2 of 16 idle at D 80 / 112); a score is reduced over the 16 lanes
//     by butterfly, in log2 units (one FFMA and one ex2 a probability);
//     codes are dequantized in fp32, the row's scale multiplying the row's
//     sum of q x code (K) and p (V) once;
//   * the merge: with one split the block writes out; otherwise every
//     block writes its partial (m, l, acc of its rows), and the last block
//     of its (slot, kv head, group) to finish, found by an atomic ticket,
//     merges all splits' partials in split order (four columns a thread,
//     twelve splits' loads in flight) and writes out, then sets the ticket
//     back to 0 for the next launch: one launch, no combine kernel; a
//     device's tickets (kernel.py) start at 0 and are 0 after every launch,
//     so a captured graph replays correctly. Fixed orders throughout: two
//     calls give the same bits.
//   * the split policy (decode_plan in kernel.py) aims at ~264 blocks, 2
//     an SM, splits of at most 128 rows: stablelm-3b's step is 5 splits
//     of 128 a (slot, kv head), 1,280 blocks; kimi-k2's 5 of 128, 320
//     blocks (9 splits of 64, 576 blocks, ran 2.6 us slower: more to
//     merge).
// Shared memory at D 80, bf16, one q row: a 10,496-byte ring, 512 bytes of
// positions, the stage list, 32 of mbarriers and 1,312 of the warps'
// partials; so up to 16 blocks an SM (the thread limit), all of stablelm-
// 3b's 1,280 at once. What holds it back (PERF.md, measured by taking
// parts out): at kimi-k2's 8 q rows the score and p.v work, 15 of its
// ~30 us (the shuffles of each score's butterfly and the exponentials
// run on few warps); the merge 3-4 us. D 64 and 256 keep the one-warp
// kernel: at D 64 its int8 and paged-int8 routes ran faster on the H100
// than this one's (pimref's step: 0.0112 / 0.0119 ms against 0.0119 /
// 0.0142), and at D 256 this one's ring of two 16 KiB stages and 16.5 KiB
// of four-row partials pass the 48 KiB of static shared memory.
#include "flash_decode.cuh"

namespace repro_decode {

cudaError_t by_dim(const Params& p, int D, bool bf16, int bits, bool paged,
                   int rows, cudaStream_t st) {
  switch (D) {
    case 64: return decode_d64(p, bf16, bits, paged, rows, st);
    case 80: return decode_d80(p, bf16, bits, paged, rows, st);
    case 112: return decode_d112(p, bf16, bits, paged, rows, st);
    case 128: return decode_d128(p, bf16, bits, paged, rows, st);
    case 256: return decode_d256(p, bf16, bits, paged, rows, st);
    default: return cudaErrorInvalidValue;
  }
}

Operand operand(const void* data, const void* scale, long long s_b,
                long long s_h, long long s_t, long long c_b, long long c_h,
                long long c_t) {
  Operand o;
  o.data = static_cast<const unsigned char*>(data);
  o.scale = static_cast<const float*>(scale);
  o.s_b = s_b; o.s_h = s_h; o.s_t = s_t;
  o.c_b = c_b; o.c_h = c_h; o.c_t = c_t;
  return o;
}

}  // namespace repro_decode

using namespace repro_decode;

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Decode over any cache layout. q (B, Hkv, G, S, D) by element strides. k/v
// hold values of q's dtype (code_bits 0), int8 codes (8) or nibble-packed
// int4 codes (4, D / 2 bytes a row), by element strides (ks_* / vs_*) over
// (B, Hkv, T) rows, or over (page, Hkv, row in page) when page_size > 0,
// rows aligned to the chunk they are copied in (Layout::kCopyBytes: 16
// bytes, 8 for int4 rows at D 80 and 112); codes carry fp32 scales by the strides
// kc_* / vc_* of the same axes. table (B, n_pages) int32 pool pages and
// n_pool the pool's pages when paged. qpos (B, S), kpos (B, T) logical.
// The plan (rows, groups, n_split, split_len) is decode_plan's in
// kernel.py. out contiguous (B, Hkv, G, S, D) in q's dtype; when n_split >
// 1, pm / pl (B, Hkv, n_split, G*S) and pacc (B, Hkv, n_split, G*S, D)
// fp32 are scratch from the caller, and at D 80 and 112 tickets (B, Hkv *
// groups) int32 zeros, left zeros.
int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* kscale,
    const void* vscale, const void* table, const void* qpos, const void* kpos,
    void* out, void* pm, void* pl, void* pacc, void* tickets, long long qs_b,
    long long qs_h, long long qs_g, long long qs_s, long long ks_b,
    long long ks_h, long long ks_t, long long vs_b, long long vs_h,
    long long vs_t, long long kc_b, long long kc_h, long long kc_t,
    long long vc_b, long long vc_h, long long vc_t, int B, int H, int G,
    int S, int T, int D, int is_bf16, int code_bits, int n_pages,
    int page_size, int n_pool, int rows, int groups, int n_split,
    int split_len, int causal, int window, float softcap, float scale,
    void* stream) {
  if (B == 0 || H == 0 || G == 0 || S == 0) return cudaSuccess;
  const int R = G * S;
  if (split_len < 1 || split_len > kMaxSplit || n_split < 1 ||
      static_cast<long long>(n_split) * split_len < T ||
      static_cast<long long>(groups) * rows < R)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = operand(k, kscale, ks_b, ks_h, ks_t, kc_b, kc_h, kc_t);
  p.v = operand(v, vscale, vs_b, vs_h, vs_t, vc_b, vc_h, vc_t);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.pm = static_cast<float*>(pm);
  p.pl = static_cast<float*>(pl);
  p.pacc = static_cast<float*>(pacc);
  p.tickets = static_cast<int*>(tickets);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_g = qs_g; p.qs_s = qs_s;
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T; p.R = R;
  p.groups = groups;
  p.n_pages = n_pages; p.page_size = page_size; p.n_pool = n_pool;
  p.n_split = n_split; p.split_len = split_len;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool paged = page_size > 0;
  return by_dim(p, D, is_bf16 != 0, code_bits, paged, rows, st);
}

}  // extern "C"
