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
// K2 (bq_scan.cu); this file holds K1's list side: staging int8, bf16 or
// fp32 list rows as bf16.

#include "strip_common.cuh"

namespace {

__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16_rn((float)x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}

// ---- staging of one (kTC x kDKC) B chunk into bf16 shared memory ----------
// Vector path (dim % 64 == 0): 16-byte loads, held in registers between
// load() and store() so the next chunk's loads fly during the mma.
template <typename TB>
struct BVec;

template <>
struct BVec<int8_t> {  // a chunk row is 64 bytes: 4 x 16
  static constexpr int kN = kTC * 4 / kThreads;
  uint4 r[kN];
  __device__ void load(const int8_t* bl, int dim, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
      r[i] = *reinterpret_cast<const uint4*>(bl + (size_t)row * dim + part * 16);
    }
  }
  __device__ void store(__nv_bfloat16* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
      const int8_t* v = reinterpret_cast<const int8_t*>(&r[i]);
      __align__(16) __nv_bfloat16 o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = to_bf16(v[e]);
      uint4* dst = reinterpret_cast<uint4*>(bs + row * kST + part * 16);
      dst[0] = reinterpret_cast<const uint4*>(o)[0];
      dst[1] = reinterpret_cast<const uint4*>(o)[1];
    }
  }
};

template <>
struct BVec<__nv_bfloat16> {  // a chunk row is 128 bytes: 8 x 16
  static constexpr int kN = kTC * 8 / kThreads;
  uint4 r[kN];
  __device__ void load(const __nv_bfloat16* bl, int dim, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
      r[i] = *reinterpret_cast<const uint4*>(bl + (size_t)row * dim + part * 8);
    }
  }
  __device__ void store(__nv_bfloat16* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
      *reinterpret_cast<uint4*>(bs + row * kST + part * 8) = r[i];
    }
  }
};

template <>
struct BVec<float> {  // a chunk row is 256 bytes: 16 x 16
  static constexpr int kN = kTC * 16 / kThreads;
  float4 r[kN];
  __device__ void load(const float* bl, int dim, int tid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 4, part = idx & 15;
      r[i] = *reinterpret_cast<const float4*>(bl + (size_t)row * dim + part * 4);
    }
  }
  __device__ void store(__nv_bfloat16* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 4, part = idx & 15;
      __align__(8) __nv_bfloat16 o[4] = {to_bf16(r[i].x), to_bf16(r[i].y),
                                         to_bf16(r[i].z), to_bf16(r[i].w)};
      *reinterpret_cast<uint2*>(bs + row * kST + part * 4) =
          *reinterpret_cast<const uint2*>(o);
    }
  }
};

// Scalar path (any dim): element loads, zero past dim.
template <typename TB>
__device__ void stage_b_scalar(__nv_bfloat16* bs, const TB* bl, int dim,
                               int dk, int tid) {
  for (int i = tid; i < kTC * kDKC; i += kThreads) {
    const int row = i / kDKC, d = i % kDKC;
    bs[row * kST + d] = dk + d < dim ? to_bf16(bl[(size_t)row * dim + dk + d])
                                     : __float2bfloat16_rn(0.f);
  }
}

// K1's list side for strip_kernel: rows of dim values of type TB.
template <typename TB>
struct DenseSrc {
  static constexpr bool kScaled = false;
  struct Vec {
    BVec<TB> v;
    __device__ void load(const Params& p, size_t row0, int dk, int tid) {
      v.load(static_cast<const TB*>(p.b) + row0 * p.dim + dk, p.dim, tid);
    }
    __device__ void store(const Params&, __nv_bfloat16* bs, int,
                          int tid) const {
      v.store(bs, tid);
    }
  };
  static __device__ void stage_scalar(__nv_bfloat16* bs, const Params& p,
                                      size_t row0, int dk, int tid) {
    stage_b_scalar(bs, static_cast<const TB*>(p.b) + row0 * p.dim, p.dim, dk,
                   tid);
  }
};

template <typename TB>
cudaError_t launch_dtype(const Params& p, int s_pad, size_t smem,
                         cudaStream_t st) {
  // 16-byte staging needs whole 64-dim chunks and an aligned list block
  if (p.dim % kDKC == 0 && reinterpret_cast<uintptr_t>(p.b) % 16 == 0)
    return launch<DenseSrc<TB>, true>(p, s_pad, smem, st);
  return launch<DenseSrc<TB>, false>(p, s_pad, smem, st);
}

}  // namespace

// Launch K1 for one length class on `stream`. `strip_rows` may be null (all
// c rows are real). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take). Allocates
// nothing; outputs of padding strips and empty rows are left unwritten.
extern "C" int raft_strip_scan(const void* strip_list, const void* strip_rows,
                               const void* sub_live, const void* a,
                               const void* b, const void* bias, void* out_v,
                               void* out_e, int s_pad, int c, int dim, int m,
                               int w, int n_sub, int kf, float alpha,
                               int tournament, int b_dtype, void* stream) {
  if (s_pad <= 0) return (int)cudaSuccess;
  if (b_dtype < 0 || b_dtype > 2) return (int)cudaErrorInvalidValue;
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
  const size_t smem = plan_launch(p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_dtype == 0) return (int)launch_dtype<int8_t>(p, s_pad, smem, st);
  if (b_dtype == 1) return (int)launch_dtype<__nv_bfloat16>(p, s_pad, smem, st);
  return (int)launch_dtype<float>(p, s_pad, smem, st);
}
