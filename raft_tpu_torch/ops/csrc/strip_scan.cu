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
// Where A comes from. The search hands K1 the tile's own (q, dim) bf16 query
// rows and the plan's slot table qids (S, C): each block stages its rows
// r0.. of strip s once, from row qids[s, r] (-1, an unused slot, stages as
// zero). The tile's rows are a few MB and stay in L2, so the search never
// writes a grouped (S, C, dim) operand over the static layout's slots, most
// of which are padding. Without qids, A is such a grouped operand (K1's
// direct callers; K2-K4 share the staging and always pass one).
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
// after. The product runs on wgmma (strip_kernel_wg, strip_common.cuh), taken
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
// per-row candidate queue, merged into the sorted carry by a bitonic fold
// in one warp's registers only when the queue could overflow and at the
// end of the sub-block; with the tournament each bin's 4th key is the
// filter and the key goes straight into the bin's pool slots. Once a row's
// carry is full almost every key fails its one compare, so the selection
// follows the keys that can still win, not the columns. The carry is
// sorted, so the row's top-kf is read straight off it. PERF.md holds the
// measured gap to the bound and the product/selection split.
//
// Under a filter (raft_strip_scan_gathered). A filter is +inf
// bias lanes, and at a pass rate of 10% a 512-row sub-block still holds
// ~50 live lanes, so no sub-block is dead and the dense walk computes about
// ten products and keys for every one that can rank. The gathered walk
// (GatherListAddr, strip_common.cuh) walks only the live lanes: each block
// gathers its sub-block's finite-bias lanes, in ascending order, from the w
// bias floats into shared memory (a warp ballot, then a prefix over the
// warps: built in every launch, nothing kept between calls), sets live to
// their count and walks ceil(live / 128) column tiles, reading each
// column's list row and bias by its lane as the paged walk reads pages. A
// key carries the lane, so the values and offsets of every finite slot are
// the dense walk's with exact selection; slots a row cannot fill read +inf
// at their own position. The tournament is never played there (its pool
// needs each tile to hold every bin once), so the gathered walk's selection
// is exact. It beats the dense walk at every pass rate measured, 10% to 90%
// (it also stops at the padded end of a list shorter than its class: PERF.md
// §6), so every filtered call takes it. Unfiltered calls keep
// raft_strip_scan and its instantiations.
//
// The selection and both kernel bodies (mma.sync and wgmma) live in
// strip_common.cuh, shared with K2-K4; the list side (int8, uint8, bf16 or
// fp32 list rows as bf16) in dense_src.cuh, shared with K3. This file holds
// K1's entry points: the packed lists, addressed as they lie (ListAddr) or
// over their live lanes (GatherListAddr), and the product-only
// instantiation that splits K1's time (launched by chip_smoke.py alone).

#include "dense_src.cuh"

namespace {

// K1's launch for one length class: the parameters, the plan, the
// instantiation of the address policy and `kSelect` for the list dtype
template <class Addr, bool kSelect>
int strip_scan_launch(const void* strip_list, const void* strip_rows,
                      const void* sub_live, const void* a, const void* qids,
                      const void* b, const void* bias, void* out_v,
                      void* out_e, int s_pad, int c, int dim, int m, int w,
                      int n_sub, int kf, float alpha, int tournament,
                      int b_dtype, void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  Params p{};
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.qids = static_cast<const int32_t*>(qids);
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
  p.gathered = std::is_same<Addr, GatherListAddr>::value;
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_dtype<Addr, kSelect>(
      p, b_dtype, s_pad, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch K1 for one length class on `stream`. `strip_rows` may be null (all
// c rows are real). `qids` null: `a` is the grouped (s_pad, c, dim) operand;
// else `a` holds the query rows (q, dim) and `qids` (s_pad, c) the row of
// each slot (-1 unused). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take). Allocates
// nothing; outputs of padding strips and empty rows are left unwritten.
// b_dtype: 0 int8, 1 bf16, 2 fp32, 3 uint8.
extern "C" int raft_strip_scan(const void* strip_list, const void* strip_rows,
                               const void* sub_live, const void* a,
                               const void* qids, const void* b,
                               const void* bias, void* out_v, void* out_e,
                               int s_pad, int c, int dim, int m, int w,
                               int n_sub, int kf, float alpha, int tournament,
                               int b_dtype, void* stream) {
  return strip_scan_launch<ListAddr, true>(
      strip_list, strip_rows, sub_live, a, qids, b, bias, out_v, out_e, s_pad,
      c, dim, m, w, n_sub, kf, alpha, tournament, b_dtype, stream);
}

// The same launch on the gathered walk (GatherListAddr): each (strip,
// sub-block) walks only the lanes whose bias is finite. The same arguments;
// `sub_live` is not read (may be null) and `tournament` must be 0 (the
// gathered walk selects exactly).
extern "C" int raft_strip_scan_gathered(
    const void* strip_list, const void* strip_rows, const void* sub_live,
    const void* a, const void* qids, const void* b, const void* bias,
    void* out_v, void* out_e, int s_pad, int c, int dim, int m, int w,
    int n_sub, int kf, float alpha, int tournament, int b_dtype,
    void* stream) {
  return strip_scan_launch<GatherListAddr, true>(
      strip_list, strip_rows, sub_live, a, qids, b, bias, out_v, out_e, s_pad,
      c, dim, m, w, n_sub, kf, alpha, tournament, b_dtype, stream);
}

// The same launch with the product-only instantiation: the same plan, tiles
// and score epilogue, no selection; the outputs are left unwritten. It
// exists to split K1's time into product and selection (chip_smoke.py).
extern "C" int raft_strip_scan_product(
    const void* strip_list, const void* strip_rows, const void* sub_live,
    const void* a, const void* qids, const void* b, const void* bias,
    void* out_v, void* out_e, int s_pad, int c, int dim, int m, int w,
    int n_sub, int kf, float alpha, int tournament, int b_dtype,
    void* stream) {
  return strip_scan_launch<ListAddr, false>(
      strip_list, strip_rows, sub_live, a, qids, b, bias, out_v, out_e, s_pad,
      c, dim, m, w, n_sub, kf, alpha, tournament, b_dtype, stream);
}

// The query rows one block of K1 takes for a length class of this shape,
// dense or gathered, as plan_launch plans them (0 for a shape the kernel
// does not take): K1's work counters (ops/strip_scan.py) ask the plan
// instead of copying it.
extern "C" int raft_strip_scan_block_rows(int c, int dim, int m, int w,
                                          int n_sub, int kf, int tournament,
                                          int gathered) {
  Params p{};
  p.c = c;
  p.dim = dim;
  p.m = m;
  p.w = w;
  p.n_sub = n_sub;
  p.kf = kf;
  p.tournament = tournament;
  p.paged = 0;
  p.gathered = gathered;
  return plan_launch(p) == 0 ? 0 : p.rows;
}
