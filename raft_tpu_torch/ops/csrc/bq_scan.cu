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
// What the design does about it. The product loop, tiling and selection
// are K1's: one block of 256 threads per strip and 32 query rows, mma.sync
// bf16 over 128-column x 64-dim tiles. Only the staging of B differs: each
// tile is expanded from the packed bytes straight into the bf16 shared
// tile. When nb is a multiple of 8, every aligned 8-column group of a
// 64-column chunk lies in one bit plane over 8 consecutive bytes, so a
// thread fetches 8 bytes (held in registers while the current tile
// multiplies) and writes 8 bf16 +-1 with one 16-byte store. Other widths
// (rot_dim 40: nb 5) take a scalar path, one byte per column, zero past
// the contraction width. Next steps (later PRs): K1's, plus a popcount
// formulation for bits = 1.

// The list side (PackedSrc) lives in packed_src.cuh, shared with K4; this
// file holds K2's entry point over the packed lists (ListAddr).

#include "packed_src.cuh"

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
  return (int)launch_packed<ListAddr>(p, s_pad, smem,
                                      static_cast<cudaStream_t>(stream));
}
