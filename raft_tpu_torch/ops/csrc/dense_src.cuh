// List side of K1 (strip_scan.cu) and K3 (paged_scan.cu): rows of dim values
// of type TB (int8, uint8, bf16 or fp32), staged as bf16 into the padded
// tile of strip_kernel (strip_common.cuh) or the swizzled tile of the wgmma
// kernel both run where its plan fits (strip_kernel_wg, below). Integers up
// to 256 in magnitude and bf16 values are exact in bf16; fp32 rounds to
// nearest even.

#pragma once

#include "strip_common.cuh"

namespace {

__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16_rn((float)x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(uint8_t x) {
  return __float2bfloat16_rn((float)x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}

// ---- the 128-byte swizzled layout of K1's wgmma operands ------------------
// Rows of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes; 16-byte chunk c of
// row r lies at r*128 + ((c ^ (r & 7)) << 4) from a 1024-aligned base.

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// ---- staging of one (kTC x kDKC) B chunk into bf16 shared memory ----------
// Vector path (dim % 64 == 0): 16-byte loads, held in registers between
// load() and store() so the next chunk's loads fly during the mma. Row r of
// the chunk is column ct + r of the sub-block, read from list row
// ad.row(ct + r); a column the address policy lacks reads as zeros.
template <typename TB>
struct BVec;

template <typename TB>
struct BVecByte {  // int8 / uint8: a chunk row is 64 bytes, 4 x 16
  static constexpr int kN = kTC * 4 / kThreads;
  uint4 r[kN];
  template <class Addr>
  __device__ void load(const TB* b, const Addr& ad, int ct, int dim, int dk,
                       int tid) {
    if constexpr (!Addr::kPaged) {  // contiguous rows from ad.row(ct)
      const TB* bl = b + ad.row(ct) * dim + dk;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
        r[i] = *reinterpret_cast<const uint4*>(bl + (size_t)row * dim +
                                               part * 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
        r[i] = ad.has(ct + row)
                   ? *reinterpret_cast<const uint4*>(
                         b + ad.row(ct + row) * dim + dk + part * 16)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  __device__ void store(__nv_bfloat16* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
      const TB* v = reinterpret_cast<const TB*>(&r[i]);
      __align__(16) __nv_bfloat16 o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = to_bf16(v[e]);
      uint4* dst = reinterpret_cast<uint4*>(bs + row * kST + part * 16);
      dst[0] = reinterpret_cast<const uint4*>(o)[0];
      dst[1] = reinterpret_cast<const uint4*>(o)[1];
    }
  }
  // the same values into a 128-byte swizzled tile (strip_kernel_wg)
  __device__ void store_swz(unsigned char* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, part = idx & 3;
      const TB* v = reinterpret_cast<const TB*>(&r[i]);
      __align__(16) __nv_bfloat16 o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = to_bf16(v[e]);
      *reinterpret_cast<uint4*>(bs + swz(row, 2 * part)) =
          reinterpret_cast<const uint4*>(o)[0];
      *reinterpret_cast<uint4*>(bs + swz(row, 2 * part + 1)) =
          reinterpret_cast<const uint4*>(o)[1];
    }
  }
};

template <>
struct BVec<int8_t> : BVecByte<int8_t> {};
template <>
struct BVec<uint8_t> : BVecByte<uint8_t> {};

template <>
struct BVec<__nv_bfloat16> {  // a chunk row is 128 bytes: 8 x 16
  static constexpr int kN = kTC * 8 / kThreads;
  uint4 r[kN];
  template <class Addr>
  __device__ void load(const __nv_bfloat16* b, const Addr& ad, int ct, int dim,
                       int dk, int tid) {
    if constexpr (!Addr::kPaged) {
      const __nv_bfloat16* bl = b + ad.row(ct) * dim + dk;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
        r[i] = *reinterpret_cast<const uint4*>(bl + (size_t)row * dim +
                                               part * 8);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
        r[i] = ad.has(ct + row)
                   ? *reinterpret_cast<const uint4*>(
                         b + ad.row(ct + row) * dim + dk + part * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  __device__ void store(__nv_bfloat16* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
      *reinterpret_cast<uint4*>(bs + row * kST + part * 8) = r[i];
    }
  }
  __device__ void store_swz(unsigned char* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
      *reinterpret_cast<uint4*>(bs + swz(row, part)) = r[i];
    }
  }
};

template <>
struct BVec<float> {  // a chunk row is 256 bytes: 16 x 16
  static constexpr int kN = kTC * 16 / kThreads;
  float4 r[kN];
  template <class Addr>
  __device__ void load(const float* b, const Addr& ad, int ct, int dim, int dk,
                       int tid) {
    if constexpr (!Addr::kPaged) {
      const float* bl = b + ad.row(ct) * dim + dk;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 4, part = idx & 15;
        r[i] = *reinterpret_cast<const float4*>(bl + (size_t)row * dim +
                                                part * 4);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 4, part = idx & 15;
        r[i] = ad.has(ct + row)
                   ? *reinterpret_cast<const float4*>(
                         b + ad.row(ct + row) * dim + dk + part * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
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
  __device__ void store_swz(unsigned char* bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 4, part = idx & 15;
      __align__(8) __nv_bfloat16 o[4] = {to_bf16(r[i].x), to_bf16(r[i].y),
                                         to_bf16(r[i].z), to_bf16(r[i].w)};
      *reinterpret_cast<uint2*>(bs + swz(row, part >> 1) + (part & 1) * 8) =
          *reinterpret_cast<const uint2*>(o);
    }
  }
};

// strip_kernel's list side: rows of dim values of type TB.
template <typename TB>
struct DenseSrc {
  static constexpr bool kScaled = false;
  struct Vec {
    BVec<TB> v;
    template <class Addr>
    __device__ void load(const Params& p, const Addr& ad, int ct, int dk,
                         int tid) {
      v.load(static_cast<const TB*>(p.b), ad, ct, p.dim, dk, tid);
    }
    __device__ void store(const Params&, __nv_bfloat16* bs, int,
                          int tid) const {
      v.store(bs, tid);
    }
  };
  // scalar path (any dim): element loads, zero past dim
  template <class Addr>
  static __device__ void stage_scalar(__nv_bfloat16* bs, const Params& p,
                                      const Addr& ad, int ct, int dk,
                                      int tid) {
    const TB* b = static_cast<const TB*>(p.b);
    for (int i = tid; i < kTC * kDKC; i += kThreads) {
      const int row = i / kDKC, d = i % kDKC;
      bs[row * kST + d] =
          (dk + d < p.dim && ad.has(ct + row))
              ? to_bf16(b[ad.row(ct + row) * p.dim + dk + d])
              : __float2bfloat16_rn(0.f);
    }
  }
};

// ---- the product on wgmma (K1, K3) ---------------------------------------
// strip_kernel_wg is K1's and K3's kernel wherever its plan fits (plan_wg):
// the block, plan, address policy, staging and selection of strip_kernel
// (256 threads, 32 query rows, two blocks a SM), with the product on wgmma
// instead of mma.sync. The product is taken transposed, D = B . A^T: the
// list tile is the M side, so each of the two warpgroups multiplies 64
// columns of the 128-column tile against all 32 rows (m64n32k16, bf16, fp32
// accumulate) and no row is padding. Both operands are read by the tensor
// cores from shared memory in the 128-byte swizzled K-major layout: the
// rows once a block, each list tile as the threads convert it (the same
// register staging as strip_kernel, one tile ahead); no warp loads operand
// fragments or issues per-fragment mma.sync. A thread's accumulators are
// columns 16*wi + g + 8h of its warpgroup's 64 and rows 8i + 2*t4 + e, so
// the eight lanes that share t4 share two rows: the candidate queue's
// positions come from one prefix sum over those lanes (offer_keys_t), and
// the tournament pool's bins are swizzled for this layout. The folds' radix
// histograms alias the list tile, idle between a column tile's product and
// the next staging.

// d (+)= A (64 x 16) . B (32 x 16)^T from two shared-memory descriptors;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// shared-memory matrix descriptor: 128-byte swizzle, K-major, 8-row atoms
// 1024 bytes apart (SBO); the leading offset is unused in this layout
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_acc_fence(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// offer_keys for the transposed fragment: rows r0 and r0 + 1 (r0 even),
// this lane's keys k[e][h] of row r0 + e at columns col[h]; the eight lanes
// with the same t4 (g = 0..7) share the two rows, so one prefix sum over
// them, with the two rows' counts in the two halves of an int, places both
// rows' keys in their queues
__device__ __forceinline__ void offer_keys_t(const RowSel& rs, int r0, int nr,
                                             const uint32_t (&k)[2][2],
                                             const int (&col)[2], int qcap,
                                             int carry_w, bool tour, int g,
                                             int t4) {
  if (tour) {
    // bins XOR-swizzled by bits 3-4 from the row's t4: the 4 rows x 8
    // columns a warp touches at once fall in 32 distinct banks
    const int swz_bin = ((r0 >> 1) & 3) << 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (r0 + e >= nr) continue;
      uint32_t* cr = rs.carry + (size_t)(r0 + e) * carry_w;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bin = (col[h] & (kNB - 1)) ^ swz_bin;
        uint32_t x = k[e][h];
        if (x < cr[3 * kNB + bin]) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t y = cr[t * kNB + bin];
            if (x < y) {
              cr[t * kNB + bin] = x;
              x = y;
            }
          }
        }
      }
    }
    return;
  }
  bool take[2][2];
  int n[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool ok = r0 + e < nr;
    const uint32_t tau = ok ? rs.tau[r0 + e] : 0u;
    take[e][0] = ok && k[e][0] < tau;
    take[e][1] = ok && k[e][1] < tau;
    n[e] = (int)take[e][0] + (int)take[e][1];
  }
  const int packed = n[0] | (n[1] << 16);
  if (!__any_sync(0xffffffffu, packed != 0)) return;
  // prefix sum over the lanes t4, t4 + 4, .., t4 + 28
  int incl = packed;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, 4 * o);
    if (g >= o) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 28 + t4);
  int base = 0;
  if (g == 0) {
    const int t0 = total & 0xFFFF, t1 = total >> 16;
    const int b0 = t0 ? atomicAdd(&rs.qn[r0], t0) : 0;
    const int b1 = t1 ? atomicAdd(&rs.qn[r0 + 1], t1) : 0;
    base = b0 | (b1 << 16);
  }
  base = __shfl_sync(0xffffffffu, base, t4);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    int pos = ((base >> (16 * e)) & 0xFFFF) + ((incl >> (16 * e)) & 0xFFFF) -
              n[e];
    uint32_t* q = rs.queue + (size_t)(r0 + e) * qcap;
    if (take[e][0]) q[pos++] = k[e][0];
    if (take[e][1]) q[pos] = k[e][1];
  }
}

template <typename TB, class Addr, bool kSelect>
__global__ void __launch_bounds__(kThreads, 2) strip_kernel_wg(Params p) {
  extern __shared__ __align__(16) unsigned char smem_in[];
  // the swizzled operands need 1024-byte atoms: align the base
  unsigned char* smem = smem_in + ((1024u - (smem_u32(smem_in) & 1023u)) &
                                   1023u);
  const int s = blockIdx.x / p.groups;
  const int lst = p.strip_list[s];
  if (lst < 0) return;  // padding strip: the merge never reads its rows
  const int real = p.strip_rows ? min(p.strip_rows[s], p.c) : p.c;
  const int r0 = (blockIdx.x % p.groups) * kMaxRows;
  const int nr = min(kMaxRows, real - r0);
  if (nr <= 0) return;  // empty query slots: the merge never reads them

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int c_lo = wg * 64 + (warp & 3) * 16 + g;  // columns c_lo, c_lo + 8
  const int n_chunks = p.dim / kDKC;
  const int kf = p.kf;
  const bool tour = p.tournament != 0;

  unsigned char* a_s = smem;  // (n_chunks, 32 rows, 64 dims) swizzled
  unsigned char* b_s = a_s + (size_t)n_chunks * kMaxRows * 128;  // the tile
  RowSel rs;
  rs.queue = reinterpret_cast<uint32_t*>(b_s + kTC * 128);
  rs.carry = rs.queue + (size_t)kMaxRows * p.qcap;
  rs.qn = reinterpret_cast<int*>(rs.carry + (size_t)kMaxRows * p.carry_w);
  rs.cn = rs.qn + kMaxRows;
  rs.tau = reinterpret_cast<uint32_t*>(rs.cn + kMaxRows);
  uint32_t* sel_all = rs.tau + kMaxRows;
  float* mv_all = reinterpret_cast<float*>(sel_all + (size_t)kWarps *
                                                         p.kf_pad);
  int* me_all = reinterpret_cast<int*>(mv_all + (size_t)kWarps * 2 * kf);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;
  uint32_t* hist = reinterpret_cast<uint32_t*>(b_s) + warp * kRadix;
  float* mv = mv_all + (size_t)warp * 2 * kf;
  int* me = me_all + (size_t)warp * 2 * kf;
  int* pg_s = reinterpret_cast<int*>(mv_all) +  // after the merge buffers
              (p.n_sub > 1 ? (size_t)kWarps * 4 * kf : 0);

  const __nv_bfloat16* A = p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * kf;
  // the strip's rows, all dims, once: rows >= nr are zero
  for (int i = tid; i < kMaxRows * n_chunks * 8; i += kThreads) {
    const int c = i & 7, kc = (i >> 3) % n_chunks, r = (i >> 3) / n_chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr)
      v = *reinterpret_cast<const uint4*>(A + (size_t)r * p.dim + kc * kDKC +
                                          c * 8);
    *reinterpret_cast<uint4*>(a_s + (size_t)kc * kMaxRows * 128 + swz(r, c)) =
        v;
  }
  const uint32_t a_addr = smem_u32(a_s);
  const uint32_t b_addr = smem_u32(b_s) + wg * 64 * 128;
  float sink = INFINITY;  // product-only: keeps the scores live

  Addr ad;
  for (int j = 0; j < p.n_sub; ++j) {
    __syncthreads();  // the previous sub-block's tile, rows and pages are read
    ad.init(p, lst, j, pg_s, tid);
    if (Addr::kPaged) __syncthreads();  // the page ids are staged
    if (ad.live == 0) {
      if (kSelect && j == 0) {
        for (int i = tid; i < nr * kf; i += kThreads) {
          out_v[i] = INFINITY;
          out_e[i] = i % kf;
        }
      }
      continue;
    }
    if (kSelect) {
      for (int i = tid; i < nr * p.carry_w; i += kThreads)
        rs.carry[i] = kNoKey;
      for (int i = tid; i < nr; i += kThreads) {
        rs.qn[i] = 0;
        rs.cn[i] = 0;
        rs.tau[i] = kNoKey;
      }
    }
    const int n_steps = (ad.cols / kTC) * n_chunks;
    // packed lists: the sub-block's bias row, hoisted
    const float* bias_l = Addr::kPaged ? nullptr : p.bias + ad.row(0);
    const TB* b = static_cast<const TB*>(p.b);
    BVec<TB> pre;
    pre.load(b, ad, 0, p.dim, 0, tid);
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.f;
    for (int step = 0; step < n_steps; ++step) {
      const int ct = (step / n_chunks) * kTC;
      const int kc = step % n_chunks;
      __syncthreads();  // the previous product and fold are done with b_s
      pre.store_swz(b_s, tid);
      // the tile and the rows are read by the tensor cores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (step + 1 < n_steps)
        pre.load(b, ad, ((step + 1) / n_chunks) * kTC, p.dim,
                 ((step + 1) % n_chunks) * kDKC, tid);
      wg_acc_fence(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kDKC / 16; ++ks)
        wgmma_m64n32k16(d, wg_desc(b_addr + ks * 32),
                        wg_desc(a_addr + kc * kMaxRows * 128 + ks * 32),
                        (kc > 0 || ks > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      wg_acc_fence(d);
      if (kc + 1 < n_chunks) continue;
      // epilogue of a column tile: d[4i + 2h + e] is column ct + c_lo + 8h,
      // row 8i + 2*t4 + e; alpha * s + bias, packed keys offered a row at a
      // time (8-row blocks past the strip's real rows are skipped)
      const int cols[2] = {ct + c_lo, ct + c_lo + 8};
      float bv[2];
      bool live[2] = {true, true};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (Addr::kPaged) {
          live[h] = ad.has(cols[h]);
          bv[h] = live[h] ? p.bias[ad.row(cols[h])] : INFINITY;
        } else {
          bv[h] = bias_l[cols[h]];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (8 * i >= nr) continue;
        uint32_t k[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = __fmul_rn(p.alpha, d[4 * i + 2 * h + e]);
            x = __fadd_rn(x, bv[h]);
            if (!live[h]) x = INFINITY;
            if (!kSelect) sink = fminf(sink, x);
            // paged: past the chain +inf lanes up to w, no key beyond
            k[e][h] = (Addr::kPaged && cols[h] >= p.w) ? kNoKey
                                                       : pack_key(x, cols[h]);
          }
        if (kSelect)
          offer_keys_t(rs, 8 * i + 2 * t4, nr, k, cols, p.qcap, p.carry_w,
                       tour, g, t4);
      }
      const bool last = ct + kTC >= ad.cols;
      if (kSelect && (last || !tour)) {
        __syncthreads();
        fold_rows<kWarps>(rs, p, last, nr, warp, lane, sel, hist, mv, me,
                          out_v, out_e, j);
      }
    }
  }
  if (!kSelect && sink == -1.0f) out_v[0] = sink;  // never: a data dependence
}

// dynamic shared memory of strip_kernel_wg (with the base's alignment)
size_t wg_smem_bytes(const Params& p) {
  size_t b = 1024 + (size_t)(p.dim / kDKC) * kMaxRows * 128 + kTC * 128 +
             (size_t)kMaxRows * (p.qcap + p.carry_w) * 4 +
             (size_t)kMaxRows * 3 * 4 + (size_t)kWarps * p.kf_pad * 4;
  if (p.n_sub > 1) b += (size_t)kWarps * 2 * p.kf * 8;
  return b + (size_t)(p.paged ? p.ppf : 0) * 4;  // the paged walk's page ids
}

// Whether strip_kernel_wg takes a shape plan_launch planned: 32 rows a
// block (the plan did not shrink them), whole 64-dim chunks and 16-byte
// aligned operands. Returns its shared memory, or 0 (the shape then keeps
// strip_kernel).
size_t plan_wg(const Params& p) {
  static_assert(kTC * 128 >= kWarps * kRadix * 4,
                "the folds' histograms alias the list tile");
  if (p.rows != kMaxRows || p.dim % kDKC != 0 ||
      reinterpret_cast<uintptr_t>(p.b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.a) % 16 != 0)
    return 0;
  const size_t smem = wg_smem_bytes(p);
  return smem <= kSmemLimit ? smem : 0;
}

template <typename TB, class Addr, bool kSelect>
cudaError_t launch_wg(const Params& p, int s_pad, size_t smem,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel_wg<TB, Addr, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel_wg<TB, Addr, kSelect>
      <<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// The dense kernels' launch: 16-byte staging needs whole 64-dim chunks and
// an aligned list block. kSelect = false is the product-only instantiation.
template <typename TB, class Addr, bool kSelect>
cudaError_t launch_dense(const Params& p, int s_pad, size_t smem,
                         cudaStream_t st) {
  if (p.dim % kDKC == 0 && reinterpret_cast<uintptr_t>(p.b) % 16 == 0)
    return launch<DenseSrc<TB>, Addr, true, kSelect>(p, s_pad, smem, st);
  return launch<DenseSrc<TB>, Addr, false, kSelect>(p, s_pad, smem, st);
}

// The dense kernels' launch for a planned shape: strip_kernel_wg where its
// plan fits, else strip_kernel. b_dtype: 0 int8, 1 bf16, 2 fp32, 3 uint8.
template <class Addr, bool kSelect = true>
cudaError_t launch_dense_dtype(const Params& p, int b_dtype, int s_pad,
                               size_t smem, cudaStream_t st) {
  if (b_dtype < 0 || b_dtype > 3) return cudaErrorInvalidValue;
  if (const size_t ws = plan_wg(p)) {
    switch (b_dtype) {
      case 0: return launch_wg<int8_t, Addr, kSelect>(p, s_pad, ws, st);
      case 1:
        return launch_wg<__nv_bfloat16, Addr, kSelect>(p, s_pad, ws, st);
      case 2: return launch_wg<float, Addr, kSelect>(p, s_pad, ws, st);
      default: return launch_wg<uint8_t, Addr, kSelect>(p, s_pad, ws, st);
    }
  }
  switch (b_dtype) {
    case 0: return launch_dense<int8_t, Addr, kSelect>(p, s_pad, smem, st);
    case 1:
      return launch_dense<__nv_bfloat16, Addr, kSelect>(p, s_pad, smem, st);
    case 2: return launch_dense<float, Addr, kSelect>(p, s_pad, smem, st);
    case 3: return launch_dense<uint8_t, Addr, kSelect>(p, s_pad, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
