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
//
// What the design does about it. The product loop, tiling and selection are
// K1's (the wgmma kernel of dense_src.cuh where its plan fits, else the
// mma.sync loop of strip_common.cuh), with the paged address policy
// (PagedAddr): per
// sub-block, the block stages the nv live page ids in shared memory, reads
// column c from pool row pg[c / R] * R + c % R for the payload and the bias
// alike, and walks only the ceil(nv * R / 128) column tiles that hold live
// pages, so the work follows the live rows, not the table's capacity (the
// serving plan at 1M x 128 has w = 4096 and chains of ~8 pages of 128). A
// 128-column tile may span pages when R < 128 (each row of a tile is
// addressed on its own). The selection is K1's threshold filter and
// candidate queue; columns past w in the walk's last tile produce no key,
// and a row left with fewer than kf keys reads +inf at the missing
// positions. The tournament is not taken: the paged paths run the exact
// carry. Next steps (later PRs): K1's.

#include "dense_src.cuh"

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
  return (int)launch_dense_dtype<PagedAddr>(
      p, b_dtype, s_pad, smem, static_cast<cudaStream_t>(stream));
}
