// K3 — the paged strip-scan kernel of the serving data plane, written for
// Hopper (sm_90a).
//
// Replaces raft_tpu/ops/strip_scan.py:_paged_strip_kernel (launched by
// _paged_class_call, pl.pallas_call). It is K1 (strip_scan.cu) over a
// PagedListStore's pools instead of packed lists: list l owns a chain of
// chain[l] fixed-size pages of R rows, listed in table[l, :], and the pools
// (pages (cap_pages, R, dim) uint8/int8/bf16/fp32 values, bias
// (cap_pages, R) fp32, +inf at tombstones and never-filled slots) are read
// in place. Every list is planned at its capacity, one length class of
// n_sub sub-blocks of ppf pages (w = ppf * R columns); for every strip s
// (one probed list x up to C query rows), sub-block j and query row r,
//
//   score[c] = alpha * (A[s, r, :] . pages[pg[c / R], c % R, :])
//              + bias[pg[c / R], c % R]        for c < nv * R
//   score[c] = +inf                            for nv * R <= c < w
//
// where pg = table[l, j*ppf ..] and nv = clamp(chain[l] - j*ppf, 0, ppf) *
// sub_live[l*n_sub + j] is the sub-block's count of live pages. The mask
// comes after the bias add, as on the TPU, so stale or NaN pool rows past
// the chain never rank. Each row keeps its kf smallest packed scores
// (offsets (j*ppf + t)*R + r within the list) and merges them across
// sub-blocks with the JAX package's earliest-position masked-min passes. A
// sub-block with nv = 0 does nothing, except sub-block 0, which writes +inf
// at offsets 0..kf-1 (the TPU kernel's live_rows = 0 extraction).
//
// What bounds it on the H100. Per live list row: the payload (dim bytes at
// the flat path's uint8, rot_dim at the PQ cache's int8) and 4 bias bytes,
// against 2 * dim flops for every query row that probes the list; with a few
// hundred query rows per probed list the tensor-core product outweighs the
// reads. chip_smoke.py computes the bound from each search's live columns.
// What the kernel spends instead is instructions: converting each list byte
// to bf16, scoring and offering each (row, column) key, folding the queues.
//
// What the design does about it. On byte pools (uint8 flat pages, the int8
// PQ cache) with pages that make whole 128-column tiles (R divides 128 and
// is a multiple of 4, or 128 divides R) and whole 64-dim chunks, K3 runs
// strip_kernel_wg's ring loop (strip_common.cuh, RingSrc in dense_src.cuh):
// per sub-block the block stages its nv live page ids, and one thread copies
// each column tile's pages whole - payload and bias, a cp.async.bulk each
// - into a ring of up to 3 stages, 2 tiles ahead of the product, with an
// mbarrier a stage counting the bytes; nothing is addressed per load and no
// bias is gathered per column. The product is wgmma with the list operand
// in registers: each thread reads 16 bytes of each of its two columns a
// 64-dim chunk from the stage and builds bf16 fragments with 2.5 ALU
// instructions a byte (exact: every byte value is a bf16), so there is no
// shared bf16 tile and no barrier a chunk; the query rows are staged in the
// matching order of the dims. A tile ends with one barrier (its offers are
// in, its stage is free), which also tells whether any row's queue needs a
// fold; only then does a second one follow. The walk covers the
// ceil(nv * R / 128) tiles that hold live pages, so the work follows the
// live rows, not the table's capacity (the serving plan at 1M x 128 has
// w = 4096 and chains of ~8 pages of 128). The selection is the shared
// threshold filter, candidate queue (two tiles deep here) and sorted
// carry; columns past w produce no key, and a row left with fewer than kf
// keys reads +inf at the missing positions. The tournament is not taken:
// the paged paths run the exact carry. bf16 / fp32 pools and other page
// heights keep K1's loops (the wgmma loop's staged tile where its plan
// fits, else mma.sync) with the paged address policy (PagedAddr: column c
// reads pool row pg[c / R] * R + c % R).

#include "dense_src.cuh"

namespace {

template <bool kSelect>
int paged_scan_launch(const void* strip_list, const void* strip_rows,
                      const void* table, const void* chain,
                      const void* sub_live, const void* a, const void* pages,
                      const void* bias_pool, void* out_v, void* out_e,
                      int s_pad, int c, int dim, int page_rows,
                      int table_width, int ppf, int n_sub, int kf,
                      float alpha, int b_dtype, void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  Params p{};
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = pages;
  p.scale = nullptr;
  p.bias = static_cast<const float*>(bias_pool);
  p.out_v = static_cast<float*>(out_v);
  p.out_e = static_cast<int32_t*>(out_e);
  p.c = c;
  p.dim = dim;
  p.m = 0;
  p.w = ppf * page_rows;
  p.n_sub = n_sub;
  p.kf = kf;
  p.tournament = 0;
  p.nb = 0;
  p.alpha = alpha;
  p.table = static_cast<const int32_t*>(table);
  p.chain = static_cast<const int32_t*>(chain);
  p.paged = 1;
  p.page_rows = page_rows;
  p.table_width = table_width;
  p.ppf = ppf;
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_dtype<PagedAddr, kSelect>(
      p, b_dtype, s_pad, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch K3 for the paged class on `stream`: `a` (s_pad, c, dim) bf16,
// `pages` (cap_pages, page_rows, dim) of b_dtype (0 int8, 1 bf16, 2 fp32,
// 3 uint8), `bias_pool` (cap_pages, page_rows) fp32, `table`
// (n_lists * table_width,) int32, `chain` (n_lists,) int32, `sub_live`
// (n_lists * n_sub,) int32. `strip_rows` may be null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// kernel does not take). Allocates nothing; outputs of padding strips and
// empty rows are left unwritten.
extern "C" int raft_paged_scan(const void* strip_list, const void* strip_rows,
                               const void* table, const void* chain,
                               const void* sub_live, const void* a,
                               const void* pages, const void* bias_pool,
                               void* out_v, void* out_e, int s_pad, int c,
                               int dim, int page_rows, int table_width,
                               int ppf, int n_sub, int kf, float alpha,
                               int b_dtype, void* stream) {
  return paged_scan_launch<true>(strip_list, strip_rows, table, chain,
                                 sub_live, a, pages, bias_pool, out_v, out_e,
                                 s_pad, c, dim, page_rows, table_width, ppf,
                                 n_sub, kf, alpha, b_dtype, stream);
}

// The same launch with the product-only instantiation (no selection, the
// outputs left unwritten), to split K3's time (chip_smoke.py).
extern "C" int raft_paged_scan_product(
    const void* strip_list, const void* strip_rows, const void* table,
    const void* chain, const void* sub_live, const void* a,
    const void* pages, const void* bias_pool, void* out_v, void* out_e,
    int s_pad, int c, int dim, int page_rows, int table_width, int ppf,
    int n_sub, int kf, float alpha, int b_dtype, void* stream) {
  return paged_scan_launch<false>(strip_list, strip_rows, table, chain,
                                  sub_live, a, pages, bias_pool, out_v,
                                  out_e, s_pad, c, dim, page_rows,
                                  table_width, ppf, n_sub, kf, alpha,
                                  b_dtype, stream);
}

// The product loop of this library's last launch (kLoop*: 0 mma.sync, 1
// wgmma with the staged tile, -1 before the first launch). Host state,
// read by the wrapper after each launch (K3's plan picks the loop per
// shape).
extern "C" int raft_paged_scan_loop(void) { return g_loop; }
