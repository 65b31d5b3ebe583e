// K1 — the strip-scan kernel of the IVF list scan, written for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/strip_scan.py:_strip_kernel (launched by
// _strip_class_call, pl.pallas_call). For every strip s of one length class
// (one probed list x up to C query rows) and every query row r it computes
//
//   score[c] = alpha * (A[s, r, :] . B[list, c, :]) + bias[list, c]
//
// over the class's w = w_blocks * 512 entries per sub-block, with both
// operands rounded to bf16 and the products summed in fp32, packs the column
// into the low 12 mantissa bits (select_k.pack_values), and keeps the row's
// kf smallest packed scores in ascending order: all of them, or, when the
// caller engaged the tournament, only those ranked < 4 in their bin
// (columns equal mod 128). Values at the packing clamp come back as +inf.
// Lists longer than one fetch are n_sub sub-blocks; the running top-kf
// merges across them with the JAX package's earliest-column masked-min
// passes (offsets + j*w). Strips with strip_list == -1 are skipped and
// write nothing; so are query rows at or past strip_rows[s] (the empty
// slots of a list's last strip). Dead sub-blocks (no finite bias lane) skip
// all work and, on the first visit, write +inf at offsets 0..kf-1.
//
// What bounds it on the H100. Per real query row the useful work is
// 2*w*dim flops against w*dim bytes of list block that all rows of the
// strip share; at 192 rows a strip does ~384 flops per byte of B, past the
// bf16 ridge (~295 flops/byte), so the bound is the tensor-core product.
// The per-row top-kf is extra work the bound does not count, and it was
// where the time went: with the exact carry, folding every 1,024-column
// chunk with a 32-pass bitwise k-th key search cost several times the
// product (48-190x the bound at kf 10-129).
//
// What the design does about it. One block of 256 threads owns one strip
// and a group of RG = 32 query rows and loops over the sub-blocks itself
// (the TPU's sequential grid axis); the row groups of a strip are adjacent
// in the launch order, so the list block comes from HBM once and from L2
// after. The product runs on wgmma (strip_kernel_wg, dense_src.cuh), taken
// transposed: each of the two warpgroups multiplies 64 columns of a
// 128-column x 64-dim list tile against the 32 rows (m64n32k16, bf16, fp32
// accumulate), both operands read by the tensor cores from shared memory
// in the 128-byte swizzled layout, so no warp loads operand fragments. The
// next tile's 16-byte loads are in flight in registers while the tensor
// cores run; two blocks stay resident on a SM, so one block's folds
// overlap the other's product. A 64-row block (one wgmma M with the rows
// as M) was built and measured first: its selection state allows one block
// a SM, and the folds it can no longer overlap cost more than the product
// saved (PERF.md). Shapes the wgmma plan does not take (dims not a
// multiple of 64, rows a block shrunk by the shared memory of a large kf)
// keep the mma.sync loop of strip_common.cuh. The selection
// (strip_common.cuh) filters first: each row keeps a threshold, its carry's
// kf-th key, and the epilogue keeps only the keys below it - appended to a
// per-row candidate queue, folded into the carry by a radix select only
// when the queue could overflow and at the end of the sub-block; with the
// tournament each bin's 4th key is the filter and the key goes straight
// into the bin's pool slots. Once a row's carry is full almost every key
// fails its one compare, so the selection follows the keys that can still
// win, not the columns. The last fold's winners are placed by rank
// (emit_row). PERF.md holds the measured gap to the bound and the
// product/selection split.
//
// The selection and the mma.sync kernel body live in strip_common.cuh,
// shared with K2-K4; the list side (int8, uint8, bf16 or fp32 list rows as
// bf16) and the wgmma kernel in dense_src.cuh, shared with K3. K2 and K4
// keep the mma.sync loop: their packed sign-bit sources expand in the
// staging of strip_common.cuh's layout. This file holds K1's entry points: the
// packed lists, addressed as they lie (ListAddr), and the product-only
// instantiation that splits K1's time (launched by chip_smoke.py alone).

#include "dense_src.cuh"

namespace {

// K1's launch for one length class: the parameters, the plan, the
// instantiation of `kSelect` for the list dtype
template <bool kSelect>
int strip_scan_launch(const void* strip_list, const void* strip_rows,
                      const void* sub_live, const void* a, const void* b,
                      const void* bias, void* out_v, void* out_e, int s_pad,
                      int c, int dim, int m, int w, int n_sub, int kf,
                      float alpha, int tournament, int b_dtype,
                      void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  Params p{};
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = b;
  p.scale = nullptr;
  p.bias = static_cast<const float*>(bias);
  p.out_v = static_cast<float*>(out_v);
  p.out_e = static_cast<int32_t*>(out_e);
  p.c = c;
  p.dim = dim;
  p.m = m;
  p.w = w;
  p.n_sub = n_sub;
  p.kf = kf;
  p.tournament = tournament;
  p.nb = 0;
  p.alpha = alpha;
  p.paged = 0;
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_dtype<ListAddr, kSelect>(
      p, b_dtype, s_pad, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch K1 for one length class on `stream`. `strip_rows` may be null (all
// c rows are real). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take). Allocates
// nothing; outputs of padding strips and empty rows are left unwritten.
// b_dtype: 0 int8, 1 bf16, 2 fp32, 3 uint8.
extern "C" int raft_strip_scan(const void* strip_list, const void* strip_rows,
                               const void* sub_live, const void* a,
                               const void* b, const void* bias, void* out_v,
                               void* out_e, int s_pad, int c, int dim, int m,
                               int w, int n_sub, int kf, float alpha,
                               int tournament, int b_dtype, void* stream) {
  return strip_scan_launch<true>(strip_list, strip_rows, sub_live, a, b, bias,
                                 out_v, out_e, s_pad, c, dim, m, w, n_sub, kf,
                                 alpha, tournament, b_dtype, stream);
}

// The same launch with the product-only instantiation: the same plan, tiles
// and score epilogue, no selection; the outputs are left unwritten. It
// exists to split K1's time into product and selection (chip_smoke.py).
extern "C" int raft_strip_scan_product(
    const void* strip_list, const void* strip_rows, const void* sub_live,
    const void* a, const void* b, const void* bias, void* out_v, void* out_e,
    int s_pad, int c, int dim, int m, int w, int n_sub, int kf, float alpha,
    int tournament, int b_dtype, void* stream) {
  return strip_scan_launch<false>(strip_list, strip_rows, sub_live, a, b,
                                  bias, out_v, out_e, s_pad, c, dim, m, w,
                                  n_sub, kf, alpha, tournament, b_dtype,
                                  stream);
}
