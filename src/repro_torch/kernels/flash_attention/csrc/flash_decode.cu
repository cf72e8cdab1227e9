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
// flash_decode_combine_kernel when the kv axis is split over blocks. The
// four differ only in how a K/V row is found (PAGED) and decoded (BITS:
// values of q's type, int8 or int4 codes), so a paged launch is bitwise
// equal to a contiguous launch on the gathered pages.
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
//     cp.async (8-byte for the 40- and 56-byte int4 rows of D 80 and 112)
//     into a warp-private ring of kStages stages, synchronised by
//     cp.async.wait_group and __syncwarp alone: no block barrier anywhere;
//   * it loads the split's kv positions (and table entries) first, and
//     compacts the rows visible to at least one of its q rows into a list
//     before any K/V byte is requested: dead ring slots, trash-page rows
//     and rows outside the window cost no bytes;
//   * rows to lanes: D / 8 lanes own a row, 8 elements each (16 bytes of
//     bf16, 8 of int8, 4 of int4, 32 of fp32), so a warp takes 32 / (D / 8)
//     rows a step; each lane keeps its 8-element slice of every q row and
//     of every output row in fp32 registers, dequantizes in registers and
//     reduces a score over the row's lanes with __shfl_xor_sync. D 80 and
//     112 give a row 16 lanes (10 or 14 is no divisor of 32): the lanes
//     past D / 8 hold zero q and acc slices and load nothing, so the
//     butterfly stays a power of two, at two rows a warp step; the idle
//     lanes cost 37.5% / 12.5% of the FMA issue at D 80 / 112, which sits
//     below the byte bound there;
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
// kc_* / vc_* of the same axes. table (B, n_pages) int32 pool pages when
// paged. qpos (B, S), kpos (B, T) logical. The plan (rows, groups, n_split,
// split_len) is decode_plan's in kernel.py. out contiguous (B, Hkv, G, S, D)
// in q's dtype; when n_split > 1, pm / pl (B, Hkv, n_split, G*S) and pacc
// (B, Hkv, n_split, G*S, D) fp32 are scratch from the caller.
int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* kscale,
    const void* vscale, const void* table, const void* qpos, const void* kpos,
    void* out, void* pm, void* pl, void* pacc, long long qs_b, long long qs_h,
    long long qs_g, long long qs_s, long long ks_b, long long ks_h,
    long long ks_t, long long vs_b, long long vs_h, long long vs_t,
    long long kc_b, long long kc_h, long long kc_t, long long vc_b,
    long long vc_h, long long vc_t, int B, int H, int G, int S, int T, int D,
    int is_bf16, int code_bits, int n_pages, int page_size, int rows,
    int groups, int n_split, int split_len, int causal, int window,
    float softcap, float scale, void* stream) {
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
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_g = qs_g; p.qs_s = qs_s;
  p.B = B; p.H = H; p.G = G; p.S = S; p.T = T; p.R = R;
  p.groups = groups;
  p.n_pages = n_pages; p.page_size = page_size;
  p.n_split = n_split; p.split_len = split_len;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool paged = page_size > 0;
  return by_dim(p, D, is_bf16 != 0, code_bits, paged, rows, st);
}

}  // extern "C"
