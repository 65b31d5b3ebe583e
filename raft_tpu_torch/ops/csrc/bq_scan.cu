// K2 — the packed 1-bit (RaBitQ) strip-scan kernel of IVF-BQ, written for
// Hopper (sm_90a).
//
// Replaces raft_tpu/ops/bq_scan.py:_bq_strip_kernel (launched by
// _bq_class_call, pl.pallas_call). It is K1 (strip_scan.cu) with a packed
// list operand: for every strip s of one length class and query row r,
//
//   score[c] = (alpha * (A[s, r, :] . pm1[list, c, :])) * scale[list, c]
//              + bias[list, c]
//
// where pm1 is the list row's code expanded to +-1 over its 8 * nb columns
// (nb = bits * rot_dim / 8 packed bytes per row) in the JAX package's
// bit-plane-major order: column j * nb + r is bit j of byte r (for bits > 1
// the planes stack in bytes; the query operand carries the plane weights,
// bq_scan.extend_query_planes). A is bf16, +-1 is exact in bf16, the sums
// are fp32, and the epilogue rounds in the JAX order (alpha * s) * scale +
// bias without FMA contraction. Top-kf, the tournament, sub-block merge,
// padding-strip, empty-row and dead-sub-block skips are K1's, from
// strip_common.cuh.
//
// What bounds it on the H100. A list row costs nb code bytes plus 8 bytes
// of scale and bias (24 B at the main path's rot_dim 128, bits 1) against
// 2 * 8 * nb flops per real query row: with up to 192 rows per strip the
// products outweigh the list reads, and at the main path's over-fetch
// (kf 40-320) the (S, C, kf) value and offset writes can outweigh the
// products. chip_smoke.py computes the bound from each search's inputs.
//
// What the design does about it. The block, tiling and selection are K1's
// (one block of 256 threads per strip and 32 query rows, two blocks a SM).
// The time went to the selection (two thirds of the kernel at kf 80: a
// radix fold cost ~14.5k cycles, its histogram atomics serializing) and,
// in the product, to staging the expanded +-1 tile through shared memory
// with two barriers a chunk. So: (1) the product runs on wgmma with the
// list operand in registers (strip_kernel_wg, register-A form): each
// thread's fragment rows are the two list columns its accumulators hold,
// so it reads their code bytes (8 a chunk, one chunk ahead) and turns
// two bits into two bf16 +-1 per register, contracting over the dims in
// byte-major order (position 8 r + j is bit j of byte r; the query rows
// are staged once a block in that order); the product has no shared tile
// and no barrier. (2) The selection's fold merges a row's queue into its
// sorted carry with bitonic networks in one warp's registers
// (strip_common.cuh). A +-1 tile expanded into wgmma's swizzled shared
// operand was built and measured first: its product kept the staging
// (PERF.md). Widths that are not a multiple of 8 bytes (rot_dim 40: nb 5)
// keep strip_kernel's mma.sync loop with a scalar staging, one byte per
// column, zero past the contraction width; raft_bq_scan_loop reports which
// loop the last launch ran. Next steps (later PRs): the idle blocks of the
// worst-case strip layout, and the epilogue's queue appends.

// The list side (PackedSrc) lives in packed_src.cuh, shared with K4; this
// file holds K2's entry point over the packed lists (ListAddr).

#include "packed_src.cuh"

namespace {

// K2's launch for one length class: the parameters, the plan, the
// instantiation of `kSelect`
template <bool kSelect>
int bq_scan_launch(const void* strip_list, const void* strip_rows,
                   const void* sub_live, const void* a, const void* codes,
                   const void* scale, const void* bias, void* out_v,
                   void* out_e, int s_pad, int c, int nb, int m, int w,
                   int n_sub, int kf, float alpha, int tournament,
                   void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = codes;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out_v = static_cast<float*>(out_v);
  p.out_e = static_cast<int32_t*>(out_e);
  p.c = c;
  p.dim = 8 * nb;
  p.m = m;
  p.w = w;
  p.n_sub = n_sub;
  p.kf = kf;
  p.tournament = tournament;
  p.nb = nb;
  p.alpha = alpha;
  p.paged = 0;
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_packed<ListAddr, kSelect>(
      p, s_pad, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch K2 for one length class on `stream`: `codes` (n_lists, m, nb)
// uint8, `a` (s_pad, c, 8 * nb) bf16, `scale` and `bias` (n_lists, m) fp32.
// `strip_rows` may be null (all c rows are real). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes the kernel does not
// take). Allocates nothing; outputs of padding strips and empty rows are
// left unwritten.
extern "C" int raft_bq_scan(const void* strip_list, const void* strip_rows,
                            const void* sub_live, const void* a,
                            const void* codes, const void* scale,
                            const void* bias, void* out_v, void* out_e,
                            int s_pad, int c, int nb, int m, int w, int n_sub,
                            int kf, float alpha, int tournament,
                            void* stream) {
  return bq_scan_launch<true>(strip_list, strip_rows, sub_live, a, codes,
                              scale, bias, out_v, out_e, s_pad, c, nb, m, w,
                              n_sub, kf, alpha, tournament, stream);
}

// The same launch with the product-only instantiation: the same plan, tiles
// and score epilogue, no selection; the outputs are left unwritten. It
// exists to split K2's time into product and selection (chip_smoke.py).
extern "C" int raft_bq_scan_product(const void* strip_list,
                                    const void* strip_rows,
                                    const void* sub_live, const void* a,
                                    const void* codes, const void* scale,
                                    const void* bias, void* out_v,
                                    void* out_e, int s_pad, int c, int nb,
                                    int m, int w, int n_sub, int kf,
                                    float alpha, int tournament,
                                    void* stream) {
  return bq_scan_launch<false>(strip_list, strip_rows, sub_live, a, codes,
                               scale, bias, out_v, out_e, s_pad, c, nb, m, w,
                               n_sub, kf, alpha, tournament, stream);
}

// The product loop of this library's last launch: 1 strip_kernel_wg (wgmma),
// 0 strip_kernel (mma.sync), -1 before the first launch. Host state, read by
// the wrapper after each launch (K2's plan picks the loop per shape).
extern "C" int raft_bq_scan_loop(void) { return g_loop; }
