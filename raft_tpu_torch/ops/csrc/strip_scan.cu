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
// The per-row top-kf is extra work the bound does not count.
//
// What the design does about it. One block of 256 threads owns one strip
// and a group of RG = 32 query rows (fewer only where shared memory forces
// it) and loops over the sub-blocks itself (the TPU's sequential grid
// axis). The row groups of a strip are adjacent in the launch order, so the
// list block comes from HBM once and from L2 after. The product runs on the
// tensor cores (mma.sync m16n8k16 bf16, fp32 accumulate): 128-column x
// 64-dim tiles of B are staged as bf16 in shared memory with 16-byte loads,
// the next tile's loads in flight while the warps multiply the current one;
// each warp owns 16 columns of the tile for all RG rows. The epilogue writes
// order keys of the packed scores into a shared (RG x cw) chunk, cw <= 1024
// columns, so the row group does not shrink as w grows. Each full chunk
// folds into a per-row carry, one warp per row: with the tournament, the 4
// smallest keys of every bin (exactly the TPU's pool); without it, the kf
// smallest keys so far (a 32-step bitwise search for the kf-th smallest key
// over carry and chunk, then a ballot compaction). At the end of the
// sub-block the carry gives the row's kf winners, bitonic-sorted. Next steps
// (later PRs): wgmma/TMA, all 192 rows per block, a radix selection;
// PERF.md holds the measured gap to the bound.
//
// The kernel body and the selection live in strip_common.cuh, shared with
// K2-K4; the list side (staging int8, uint8, bf16 or fp32 list rows as bf16)
// in dense_src.cuh, shared with K3. This file holds K1's entry point: the
// packed lists, addressed as they lie (ListAddr).

#include "dense_src.cuh"

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
  return (int)launch_dense_dtype<ListAddr>(
      p, b_dtype, s_pad, smem, static_cast<cudaStream_t>(stream));
}
