// List side of K2 (bq_scan.cu) and K4 (paged_bq_scan.cu): rows of nb packed
// code bytes, 8 * nb columns of +-1 (exact in bf16) in the JAX package's
// bit-plane-major order: column j * nb + r is bit j of byte r. For
// strip_kernel_wg (nb a multiple of 8) it supplies wgmma's A fragments from
// registers (kRegA: chunk, frag, a_dim); for strip_kernel's mma.sync loop
// it expands each tile into the bf16 shared tile (Vec, stage_scalar).

#pragma once

#include "strip_common.cuh"

namespace {

// bf16 bit patterns of +1 and -1
constexpr uint16_t kPlusOne = 0x3F80;
constexpr uint16_t kMinusOne = 0xBF80;

__device__ __forceinline__ uint16_t pm1(uint32_t byte, int bit) {
  return ((byte >> bit) & 1u) ? kPlusOne : kMinusOne;
}

// bits 0 and 1 of x as two bf16 +-1 (low half from bit 0)
__device__ __forceinline__ uint32_t pm1x2(uint32_t x) {
  return 0xBF80BF80u ^ ((x & 1u) << 15) ^ ((x & 2u) << 30);
}

// bit `bit` of each of 8 code bytes as 8 bf16 +-1 (16 bytes): -1 is 0xBF80,
// and a set bit clears its sign (bit 15 of each half)
__device__ __forceinline__ uint4 expand8(uint2 v, int bit) {
  const uint32_t lo = (v.x >> bit) & 0x01010101u;  // bits at 0, 8, 16, 24
  const uint32_t hi = (v.y >> bit) & 0x01010101u;
  constexpr uint32_t kM = 0xBF80BF80u;
  return make_uint4(
      kM ^ ((lo << 15) & 0x8000u) ^ ((lo << 23) & 0x80000000u),
      kM ^ ((lo >> 1) & 0x8000u) ^ ((lo << 7) & 0x80000000u),
      kM ^ ((hi << 15) & 0x8000u) ^ ((hi << 23) & 0x80000000u),
      kM ^ ((hi >> 1) & 0x8000u) ^ ((hi << 7) & 0x80000000u));
}

// strip_kernel's list side: the packed rows, scaled per row. Row r of a
// chunk is column ct + r of the sub-block, read from code row
// ad.row(ct + r); a column the address policy lacks reads as zero bytes
// (its score is masked in the epilogue).
struct PackedSrc {
  static constexpr bool kScaled = true;
  static constexpr int kAlign = 8;  // bytes: the Vec path's loads

  // strip_kernel_wg builds the list operand in registers (kRegA) and
  // contracts over the dims in byte-major order: position 8 * r + j of the
  // product is bit j of code byte r, column j * nb + r of the query block
  static constexpr bool kRegA = true;
  static constexpr bool kRing = false;
  static __device__ __forceinline__ int a_dim(const Params& p, int pos) {
    return (pos & 7) * p.nb + (pos >> 3);
  }
  // the 8 code bytes of chunk kc (product positions 64 kc ..) of columns
  // col and col + 8, zeros where the address policy lacks the column
  template <class Addr>
  static __device__ __forceinline__ void chunk(const Params& p,
                                               const Addr& ad, int col,
                                               int kc, uint2 (&v)[2]) {
    const uint8_t* codes = static_cast<const uint8_t*>(p.b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col + 8 * h;
      v[h] = ad.has(c) ? *reinterpret_cast<const uint2*>(
                             codes + ad.row(c) * p.nb + kc * 8)
                       : make_uint2(0u, 0u);
    }
  }
  // the A fragment of k-step ks of a chunk (code bytes 2 ks, 2 ks + 1):
  // rows g, g + 8 are the two columns, k 2 t4 .. + 1 bits 2 t4 .. + 1 of
  // byte 2 ks and k 2 t4 + 8 .. + 9 the same bits of byte 2 ks + 1, each
  // pair as two bf16 +-1
  static __device__ __forceinline__ void frag(const uint2 (&v)[2], int ks,
                                              int t4, uint32_t (&a)[4]) {
    const int sh = 16 * (ks & 1) + 2 * t4;
    const uint32_t w0 = ks < 2 ? v[0].x : v[0].y;
    const uint32_t w1 = ks < 2 ? v[1].x : v[1].y;
    a[0] = pm1x2(w0 >> sh);
    a[1] = pm1x2(w1 >> sh);
    a[2] = pm1x2(w0 >> (sh + 8));
    a[3] = pm1x2(w1 >> (sh + 8));
  }
  struct Vec {  // nb % 8 == 0: 8 groups of 8 columns per chunk row
    static constexpr int kN = kTC * (kDKC / 8) / kThreads;
    uint2 r[kN];
    template <class Addr>
    __device__ void load(const Params& p, const Addr& ad, int ct, int dk,
                         int tid) {
      const uint8_t* codes = static_cast<const uint8_t*>(p.b);
      if constexpr (!Addr::kPerRow) {  // contiguous rows from ad.row(ct)
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
    // into strip_kernel's padded tile
    __device__ void store(const Params& p, __nv_bfloat16* bs, int dk,
                          int tid) const {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = tid + i * kThreads, row = idx >> 3, part = idx & 7;
        *reinterpret_cast<uint4*>(bs + row * kST + part * 8) =
            expand8(r[i], (dk + part * 8) / p.nb);
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

// The packed kernels' launch for a planned shape: strip_kernel_wg where its
// plan fits (nb a multiple of 8, 32 rows a block, aligned blocks), else
// strip_kernel, whose 8-byte staging needs the same whole 8-column groups
// in one plane and whose scalar staging takes any width. kSelect = false is
// the product-only instantiation.
template <class Addr, bool kSelect = true>
cudaError_t launch_packed(const Params& p, int s_pad, size_t smem,
                          cudaStream_t st) {
  if (const size_t ws = plan_wg<PackedSrc>(p))
    return launch_wg<PackedSrc, Addr, kSelect>(p, s_pad, ws, st);
  if (p.nb % 8 == 0 && reinterpret_cast<uintptr_t>(p.b) % 8 == 0)
    return launch<PackedSrc, Addr, true, kSelect>(p, s_pad, smem, st);
  return launch<PackedSrc, Addr, false, kSelect>(p, s_pad, smem, st);
}

}  // namespace
