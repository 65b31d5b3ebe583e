// List side of K1 (strip_scan.cu) and K3 (paged_scan.cu): rows of dim values
// of type TB (int8, uint8, bf16 or fp32), staged as bf16 into the padded
// tile of strip_kernel or the swizzled shared operand of strip_kernel_wg,
// which both run where its plan fits (both in strip_common.cuh). Integers
// up to 256 in magnitude and bf16 values are exact in bf16; fp32 rounds to
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
  static constexpr bool kRegA = false;  // strip_kernel_wg stages the tile
  static constexpr int kAlign = 16;  // bytes: the Vec path's loads
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
    __device__ void store_swz(const Params&, unsigned char* bs, int,
                              int tid) const {
      v.store_swz(bs, tid);
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
  if (const size_t ws = plan_wg<DenseSrc<int8_t>>(p)) {
    switch (b_dtype) {
      case 0:
        return launch_wg<DenseSrc<int8_t>, Addr, kSelect>(p, s_pad, ws, st);
      case 1:
        return launch_wg<DenseSrc<__nv_bfloat16>, Addr, kSelect>(p, s_pad, ws,
                                                                st);
      case 2:
        return launch_wg<DenseSrc<float>, Addr, kSelect>(p, s_pad, ws, st);
      default:
        return launch_wg<DenseSrc<uint8_t>, Addr, kSelect>(p, s_pad, ws, st);
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
