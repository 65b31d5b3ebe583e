// List side of K2 (bq_scan.cu) and K4 (paged_bq_scan.cu): rows of nb packed
// code bytes, expanded to 8 * nb columns of +-1 (exact in bf16) straight into
// the bf16 shared tile of strip_kernel (strip_common.cuh), in the JAX
// package's bit-plane-major order: column j * nb + r is bit j of byte r.

#pragma once

#include "strip_common.cuh"

namespace {

// bf16 bit patterns of +1 and -1
constexpr uint16_t kPlusOne = 0x3F80;
constexpr uint16_t kMinusOne = 0xBF80;

__device__ __forceinline__ uint16_t pm1(uint32_t byte, int bit) {
  return ((byte >> bit) & 1u) ? kPlusOne : kMinusOne;
}

// strip_kernel's list side: the packed rows, scaled per row. Row r of a
// chunk is column ct + r of the sub-block, read from code row
// ad.row(ct + r); a column the address policy lacks reads as zero bytes
// (its score is masked in the epilogue).
struct PackedSrc {
  static constexpr bool kScaled = true;
  struct Vec {  // nb % 8 == 0: 8 groups of 8 columns per chunk row
    static constexpr int kN = kTC * (kDKC / 8) / kThreads;
    uint2 r[kN];
    template <class Addr>
    __device__ void load(const Params& p, const Addr& ad, int ct, int dk,
                         int tid) {
      const uint8_t* codes = static_cast<const uint8_t*>(p.b);
      if constexpr (!Addr::kPaged) {  // contiguous rows from ad.row(ct)
        const uint8_t* cl = codes + ad.row(ct) * p.nb;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
          const int byte0 = (dk + part * 8) % p.nb;
          r[i] = *reinterpret_cast<const uint2*>(cl + (size_t)row * p.nb +
                                                 byte0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
          const int byte0 = (dk + part * 8) % p.nb;
          r[i] = ad.has(ct + row)
                     ? *reinterpret_cast<const uint2*>(
                           codes + ad.row(ct + row) * p.nb + byte0)
                     : make_uint2(0u, 0u);
        }
      }
    }
    __device__ void store(const Params& p, __nv_bfloat16* bs, int dk,
                          int tid) const {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
        const int bit = (dk + part * 8) / p.nb;
        const uint8_t* v = reinterpret_cast<const uint8_t*>(&r[i]);
        __align__(16) uint16_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = pm1(v[e], bit);
        *reinterpret_cast<uint4*>(bs + row * kST + part * 8) =
            *reinterpret_cast<const uint4*>(o);
      }
    }
  };
  // scalar path (any nb): one byte per column, zero past the width
  template <class Addr>
  static __device__ void stage_scalar(__nv_bfloat16* bs, const Params& p,
                                      const Addr& ad, int ct, int dk,
                                      int tid) {
    const uint8_t* codes = static_cast<const uint8_t*>(p.b);
    uint16_t* out = reinterpret_cast<uint16_t*>(bs);
    for (int i = tid; i < kTC * kDKC; i += kThreads) {
      const int row = i / kDKC, d = dk + i % kDKC;
      out[row * kST + i % kDKC] =
          (d < p.dim && ad.has(ct + row))
              ? pm1(codes[ad.row(ct + row) * p.nb + d % p.nb], d / p.nb)
              : (uint16_t)0;
    }
  }
};

// The packed kernels' launch: 8-byte staging needs whole 8-column groups in
// one plane and an aligned code block.
template <class Addr>
cudaError_t launch_packed(const Params& p, int s_pad, size_t smem,
                          cudaStream_t st) {
  if (p.nb % 8 == 0 && reinterpret_cast<uintptr_t>(p.b) % 8 == 0)
    return launch<PackedSrc, Addr, true>(p, s_pad, smem, st);
  return launch<PackedSrc, Addr, false>(p, s_pad, smem, st);
}

}  // namespace
