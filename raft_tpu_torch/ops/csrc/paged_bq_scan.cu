// K4 — the paged packed 1-bit (RaBitQ) scan of the serving data plane,
// written for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/bq_scan.py:_paged_bq_kernel (launched by
// _paged_bq_class_call, pl.pallas_call). It is K3 (paged_scan.cu) with K2's
// packed list side (bq_scan.cu): the code pool (cap_pages, R, nb) uint8
// holds nb = bits * rot_dim / 8 bytes per row, expanded to +-1 over 8 * nb
// columns in the bit-plane-major order, and a scale pool (cap_pages, R)
// fp32 rides beside the bias pool. For every strip, live sub-block j and
// query row r,
//
//   score[c] = (alpha * (A[s, r, :] . pm1[pg[c / R], c % R, :]))
//              * scale[pg[c / R], c % R] + bias[pg[c / R], c % R]
//
// for the sub-block's nv * R live columns, +inf for the rest of its w, with
// K3's page walk, top-kf, sub-block merge and dead/empty handling.
//
// What bounds it on the H100. A live row costs nb code bytes plus 8 bytes
// of scale and bias against 2 * 8 * nb flops per probing query row; at the
// serving over-fetch the (S, C, kf) outputs can outweigh both.
// chip_smoke.py computes the bound from each search's live columns.
//
// What the design does about it: K3's paged walk (PagedAddr, only the tiles
// that hold live pages) with K2's staging (PackedSrc, 8 code bytes per
// thread expanded to 8 bf16 +-1 with one 16-byte store when nb % 8 == 0).

#include "packed_src.cuh"

// Launch K4 for the paged class on `stream`: `a` (s_pad, c, 8 * nb) bf16,
// `codes` (cap_pages, page_rows, nb) uint8, `scale_pool` and `bias_pool`
// (cap_pages, page_rows) fp32, `table`, `chain`, `sub_live` as K3's.
// `strip_rows` may be null. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take). Allocates
// nothing; outputs of padding strips and empty rows are left unwritten.
extern "C" int raft_paged_bq_scan(const void* strip_list,
                                  const void* strip_rows, const void* table,
                                  const void* chain, const void* sub_live,
                                  const void* a, const void* codes,
                                  const void* scale_pool,
                                  const void* bias_pool, void* out_v,
                                  void* out_e, int s_pad, int c, int nb,
                                  int page_rows, int table_width, int ppf,
                                  int n_sub, int kf, float alpha,
                                  void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = codes;
  p.scale = static_cast<const float*>(scale_pool);
  p.bias = static_cast<const float*>(bias_pool);
  p.out_v = static_cast<float*>(out_v);
  p.out_e = static_cast<int32_t*>(out_e);
  p.c = c;
  p.dim = 8 * nb;
  p.m = 0;
  p.w = ppf * page_rows;
  p.n_sub = n_sub;
  p.kf = kf;
  p.tournament = 0;
  p.nb = nb;
  p.alpha = alpha;
  p.table = static_cast<const int32_t*>(table);
  p.chain = static_cast<const int32_t*>(chain);
  p.paged = 1;
  p.page_rows = page_rows;
  p.table_width = table_width;
  p.ppf = ppf;
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_packed<PagedAddr>(p, s_pad, smem,
                                       static_cast<cudaStream_t>(stream));
}
