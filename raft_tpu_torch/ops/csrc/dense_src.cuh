// List side of K1 (strip_scan.cu) and K3 (paged_scan.cu): rows of dim values
// of type TB (int8, uint8, bf16 or fp32), staged as bf16 into the padded
// tile of strip_kernel or the swizzled shared operand of strip_kernel_wg,
// which both run where its plan fits (both in strip_common.cuh). Integers
// up to 256 in magnitude and bf16 values are exact in bf16; fp32 rounds to
// nearest even. K3's byte pools (RingSrc) take strip_kernel_wg's ring loop
// where its plan fits (plan_ring): whole pages by bulk copy, the A
// fragments built in registers.

#pragma once

#include <type_traits>

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
    if constexpr (!Addr::kPerRow) {  // contiguous rows from ad.row(ct)
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
    if constexpr (!Addr::kPerRow) {
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
    if constexpr (!Addr::kPerRow) {
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
  static constexpr bool kRing = false;
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

// bytes 0, 1 (hi: 2, 3) of w as two bf16, the first in the low half, each
// exact: the byte under a float's 2^23 exponent minus 2^23 (+128 for int8,
// whose sign bit is flipped first) is its value, and a float of at most 8
// significant bits is its own bf16, the high half
template <bool kSigned>
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t w, bool hi) {
  constexpr float kMagic = kSigned ? 8388736.0f : 8388608.0f;
  if (kSigned) w ^= 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(w, 0x4B000000u, hi ? 0x7442 : 0x7440)) -
      kMagic;
  const float f1 =
      __uint_as_float(__byte_perm(w, 0x4B000000u, hi ? 0x7443 : 0x7441)) -
      kMagic;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// K3's list side on byte pools (int8, uint8) for strip_kernel_wg's ring
// loop: a tile's page rows sit in a ring stage as they are in the pool, and
// each thread reads 16 bytes of each of its two columns a 64-dim chunk,
// dims 16*t4 .. + 15, and builds wgmma's A fragments from them. So the
// product contracts over the dims in this order: position 16 ks + 8 hh +
// 2 t4 + e of a chunk is dim 16 t4 + 4 ks + 2 hh + e (a_dim), and the query
// rows are staged in it.
template <typename TB>
struct RingSrc {
  static constexpr bool kScaled = false;
  static constexpr bool kRegA = true;  // query rows staged in a_dim's order
  static constexpr bool kRing = true;
  static constexpr int kAlign = 16;
  static __device__ __forceinline__ int a_dim(const Params&, int pos) {
    return (pos & ~63) | (((pos >> 1) & 3) << 4) | (((pos >> 4) & 3) << 2) |
           (((pos >> 3) & 1) << 1) | (pos & 1);
  }
  // the A fragments of a chunk's four k-steps from the two columns' 16
  // bytes (x: column c_lo, fragment row g; y: c_lo + 8, row g + 8): k-step
  // ks takes word ks, its bytes 0-1 at k 2 t4 .. + 1, bytes 2-3 at k 2 t4 +
  // 8 .. + 9
  static __device__ __forceinline__ void frag(const uint4& x, const uint4& y,
                                              uint32_t (&a)[4][4]) {
    constexpr bool kS = std::is_same<TB, int8_t>::value;
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[ks][0] = bytes_bf16x2<kS>(xw[ks], false);
      a[ks][1] = bytes_bf16x2<kS>(yw[ks], false);
      a[ks][2] = bytes_bf16x2<kS>(xw[ks], true);
      a[ks][3] = bytes_bf16x2<kS>(yw[ks], true);
    }
  }
};

// Whether strip_kernel_wg's ring loop takes a shape plan_launch planned for
// K3's byte pools (q, a copy of the plan, gets the ring's stages and queue):
// 32 rows a block, whole 64-dim chunks, pages of whole 128-row tiles or
// tiles of whole pages (R divides 128, or 128 divides R) whose bias rows are
// whole 16-byte units (R a multiple of 4), 16-byte aligned pools and query
// block. Its queue holds two tiles' keys; it takes as many stages (up to
// 3) as leave two blocks a SM, else 2. Returns its shared memory, or 0 (the shape
// keeps strip_kernel_wg's staged loop or strip_kernel).
constexpr int kRingMax = 3;
constexpr size_t kSmemTwoBlocks = 113 * 1024;

template <typename TB>
size_t plan_ring(Params& q) {
  const int R = q.page_rows;
  const bool tiles_of_pages = R < kTC && kTC % R == 0 && R % 4 == 0;
  if (!q.paged || q.rows != kMaxRows || q.dim % kDKC != 0 ||
      !(tiles_of_pages || R % kTC == 0) ||
      reinterpret_cast<uintptr_t>(q.b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q.bias) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q.a) % 16 != 0)
    return 0;
  if (q.qcap > 2 * kTC) q.qcap = 2 * kTC;
  for (q.ring = kRingMax; q.ring >= 2; --q.ring) {
    const size_t b = wg_smem_bytes<RingSrc<TB>>(q);
    if (b <= kSmemTwoBlocks) return b;
  }
  q.ring = 2;
  const size_t b = wg_smem_bytes<RingSrc<TB>>(q);
  return b <= kSmemLimit ? b : 0;
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

// The dense kernels' launch for a planned shape: K3's byte pools take the
// ring loop where its plan fits, every shape strip_kernel_wg's staged loop
// where its plan fits, else strip_kernel. b_dtype: 0 int8, 1 bf16, 2 fp32,
// 3 uint8.
template <class Addr, bool kSelect = true>
cudaError_t launch_dense_dtype(const Params& p, int b_dtype, int s_pad,
                               size_t smem, cudaStream_t st) {
  if (b_dtype < 0 || b_dtype > 3) return cudaErrorInvalidValue;
  if constexpr (std::is_same<Addr, PagedAddr>::value) {
    if (b_dtype == 0 || b_dtype == 3) {  // byte pools: the ring loop
      Params q = p;
      if (const size_t rs = plan_ring<int8_t>(q)) {
        if (b_dtype == 0)
          return launch_wg<RingSrc<int8_t>, Addr, kSelect>(q, s_pad, rs, st);
        return launch_wg<RingSrc<uint8_t>, Addr, kSelect>(q, s_pad, rs, st);
      }
    }
  }
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
