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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDKC = 64;                // dims per staged chunk
constexpr int kTC = 128;                // columns per tile, 16 per warp
constexpr int kST = kDKC + 8;           // smem row stride (bf16): conflict-free
constexpr int kPackBits = 12;
constexpr uint32_t kPackMask = (1u << kPackBits) - 1u;
constexpr uint32_t kClampBits = (0x7F7FFFFFu >> kPackBits) << kPackBits;
constexpr int kNB = 128;                // tournament bins
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every packed key
constexpr int kMaxKf = 512;
constexpr int kMaxRows = 32;
constexpr int kMaxChunk = 1024;       // widest key chunk per row
constexpr size_t kSmemLimit = 225 * 1024;

struct Params {
  const int32_t* strip_list;  // (S,)
  const int32_t* strip_rows;  // (S,) real query rows per strip, or null
  const int32_t* sub_live;    // (n_lists * n_sub,)
  const __nv_bfloat16* a;     // (S, c, dim)
  const void* b;              // (n_lists, m, dim) int8 | bf16 | fp32
  const float* bias;          // (n_lists, m)
  float* out_v;               // (S, c, kf)
  int32_t* out_e;             // (S, c, kf)
  int c, dim, m, w, n_sub, kf, kf_pad, rows, groups, tournament;
  int cw, carry_w;  // key-chunk columns; per-row carry (512 | kf_pad)
  float alpha;
};

__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t x) {
  return __float2bfloat16_rn((float)x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}

// unsigned key whose integer order is the float order of the packed score
__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

__device__ __forceinline__ uint32_t pack_key(float v, int col) {
  const float clamp = __uint_as_float(kClampBits);
  if (isnan(v)) v = INFINITY;
  v = fminf(fmaxf(v, -clamp), clamp);
  return order_key((__float_as_uint(v) & ~kPackMask) | (uint32_t)col);
}

__device__ __forceinline__ void decode_key(uint32_t key, float* v, int* e) {
  const uint32_t bits = key_bits(key);
  float x = __uint_as_float(bits & ~kPackMask);
  if (x >= __uint_as_float(kClampBits)) x = INFINITY;
  *v = x;
  *e = (int)(bits & kPackMask);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// The strip's query rows, all dims, once per block: rows >= nr and dims >=
// dim are zero; row stride dim_pad + 8 keeps the fragment loads
// conflict-free.
__device__ void stage_a(__nv_bfloat16* as, const __nv_bfloat16* A, int rows_p,
                        int nr, int dim, int dim_pad, int tid) {
  const int st = dim_pad + 8;
  for (int i = tid; i < rows_p * dim_pad; i += kThreads) {
    const int r = i / dim_pad, d = i % dim_pad;
    as[r * st + d] = (r < nr && d < dim) ? A[(size_t)r * dim + d]
                                         : __float2bfloat16_rn(0.f);
  }
}

// ---- per-row selection helpers (one warp per row) -------------------------

// the kf-th smallest of the keys in a[0..na) and b[0..nb): the largest x
// with #(keys < x) < kf. Keys are unique, so exactly kf of them are <= x.
__device__ uint32_t kth_key(const uint32_t* a, int na, const uint32_t* b,
                            int nb, int kf, int lane) {
  uint32_t x = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t y = x | (1u << bit);
    int cnt = 0;
    for (int i = lane; i < na; i += 32) cnt += a[i] < y;
    for (int i = lane; i < nb; i += 32) cnt += b[i] < y;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (cnt < kf) x = y;
  }
  return x;
}

// append the keys <= x of a[0..n) to sel from position base (ballot order)
__device__ int compact_le(const uint32_t* a, int n, uint32_t x, uint32_t* sel,
                          int base, int cap, int lane) {
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int i = c0 + lane;
    const bool take = i < n && a[i] <= x;
    const unsigned ball = __ballot_sync(0xffffffffu, take);
    const int pos = base + __popc(ball & ((1u << lane) - 1u));
    if (take && pos < cap) sel[pos] = a[i];
    base += __popc(ball);
  }
  return base;
}

// fold one chunk of a row's keys (kr[0..cw)) into the row's carry: the 4
// smallest keys per bin (tournament; carry[t * kNB + bin], ascending in t),
// or the kf smallest keys so far (carry[0..kf), any order, via sel)
__device__ void fold_chunk(const uint32_t* kr, int cw, uint32_t* cr,
                           uint32_t* sel, int kf, int kf_pad, bool tournament,
                           int lane) {
  if (tournament) {
    for (int bin = lane; bin < kNB; bin += 32) {
      uint32_t m0 = cr[bin], m1 = cr[kNB + bin], m2 = cr[2 * kNB + bin],
               m3 = cr[3 * kNB + bin];
      for (int t = 0; t < cw / kNB; ++t) {
        const uint32_t x = kr[t * kNB + bin];
        if (x < m3) {
          m3 = x;
          if (m3 < m2) { uint32_t y = m2; m2 = m3; m3 = y; }
          if (m2 < m1) { uint32_t y = m1; m1 = m2; m2 = y; }
          if (m1 < m0) { uint32_t y = m0; m0 = m1; m1 = y; }
        }
      }
      cr[bin] = m0;
      cr[kNB + bin] = m1;
      cr[2 * kNB + bin] = m2;
      cr[3 * kNB + bin] = m3;
    }
  } else {
    const uint32_t x = kth_key(cr, kf, kr, cw, kf, lane);
    const int n = compact_le(cr, kf, x, sel, 0, kf_pad, lane);
    compact_le(kr, cw, x, sel, n, kf_pad, lane);
    __syncwarp();
    for (int i = lane; i < kf; i += 32) cr[i] = sel[i];
  }
  __syncwarp();
}

template <typename TB, bool kVec>
__global__ void __launch_bounds__(kThreads) strip_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x / p.groups;  // the groups of a strip are adjacent
  const int lst = p.strip_list[s];
  if (lst < 0) return;  // padding strip: the merge never reads its rows
  const int real = p.strip_rows ? min(p.strip_rows[s], p.c) : p.c;
  const int r0 = (blockIdx.x % p.groups) * p.rows;
  const int nr = min(p.rows, real - r0);
  if (nr <= 0) return;  // empty query slots: the merge never reads them

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows_p = p.rows < 16 ? 16 : p.rows;  // mma rows (zero-padded)
  const int m_tiles = rows_p / 16;
  const bool tour = p.tournament != 0;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);            // (rows, cw)
  uint32_t* carry = keys + (size_t)p.rows * p.cw;            // (rows, carry_w)
  const int n_chunks = (p.dim + kDKC - 1) / kDKC;
  const int a_st = n_chunks * kDKC + 8;                      // a_s row stride
  __nv_bfloat16* a_s =
      reinterpret_cast<__nv_bfloat16*>(carry + (size_t)p.rows * p.carry_w);
  __nv_bfloat16* b_s = a_s + rows_p * a_st;
  uint32_t* sel_all = reinterpret_cast<uint32_t*>(b_s + kTC * kST);
  float* mv_all = reinterpret_cast<float*>(sel_all + (size_t)kWarps * p.kf_pad);
  int* me_all = reinterpret_cast<int*>(mv_all + (size_t)kWarps * 2 * p.kf);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;      // per-warp winners
  float* mv = mv_all + (size_t)warp * 2 * p.kf;           // per-warp merge
  int* me = me_all + (size_t)warp * 2 * p.kf;             // (n_sub > 1 only)

  const __nv_bfloat16* A = p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * p.kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * p.kf;
  const int kf = p.kf;
  const int n_steps = (p.w / kTC) * n_chunks;
  stage_a(a_s, A, rows_p, nr, p.dim, a_st - 8, tid);  // read after a sync

  for (int j = 0; j < p.n_sub; ++j) {
    if (p.sub_live[(size_t)lst * p.n_sub + j] == 0) {
      // dead sub-block: first visit writes the all-dead extraction result,
      // revisits leave the running top-kf as it is
      if (j == 0) {
        for (int i = tid; i < nr * kf; i += kThreads) {
          out_v[i] = INFINITY;
          out_e[i] = i % kf;
        }
      }
      continue;
    }
    const size_t col0 = (size_t)lst * p.m + (size_t)j * p.w;
    const TB* Bl = reinterpret_cast<const TB*>(p.b) + col0 * p.dim;
    const float* bias = p.bias + col0;
    __syncthreads();  // the previous sub-block's rows are read
    for (int i = tid; i < nr * p.carry_w; i += kThreads) carry[i] = kNoKey;

    // ---- scores on the tensor cores, one (kTC x kDKC) step at a time -----
    float acc[kMaxRows / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < kMaxRows / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    BVec<TB> pre;
    if (kVec) pre.load(Bl, p.dim, tid);
    for (int step = 0; step < n_steps; ++step) {
      const int ct = (step / n_chunks) * kTC;
      const int dk = (step % n_chunks) * kDKC;
      __syncthreads();  // the previous step's fragments and keys are read
      if (kVec) {
        pre.store(b_s, tid);
      } else {
        stage_b_scalar(b_s, Bl + (size_t)ct * p.dim, p.dim, dk, tid);
      }
      __syncthreads();
      if (kVec && step + 1 < n_steps) {
        const int nct = ((step + 1) / n_chunks) * kTC;
        const int ndk = ((step + 1) % n_chunks) * kDKC;
        pre.load(Bl + (size_t)nct * p.dim + ndk, p.dim, tid);
      }
      const int n0 = warp * 16;
#pragma unroll
      for (int ks = 0; ks < kDKC / 16; ++ks) {
        const int k0 = ks * 16 + 2 * t4;
        uint32_t b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* bp = b_s + (n0 + nt * 8 + g) * kST + k0;
          b[nt][0] = ld32(bp);
          b[nt][1] = ld32(bp + 8);
        }
#pragma unroll
        for (int mt = 0; mt < kMaxRows / 16; ++mt) {
          if (mt < m_tiles) {
            const __nv_bfloat16* ap = a_s + (mt * 16 + g) * a_st + dk + k0;
            const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * a_st);
            const uint32_t a2 = ld32(ap + 8), a3 = ld32(ap + 8 * a_st + 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_bf16(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
          }
        }
      }
      if (dk + kDKC >= p.dim) {
        // epilogue of a column tile: alpha * s + bias, packed order keys
        // into the row's current chunk
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = ct + n0 + nt * 8 + 2 * t4;
          const int cc = col & (p.cw - 1);
          const float bv0 = bias[col], bv1 = bias[col + 1];
#pragma unroll
          for (int mt = 0; mt < kMaxRows / 16; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + g + 8 * h;
              if (mt < m_tiles && r < nr) {
                uint32_t* kr = keys + (size_t)r * p.cw + cc;
                kr[0] = pack_key(__fadd_rn(__fmul_rn(p.alpha, acc[mt][nt][2 * h]), bv0), col);
                kr[1] = pack_key(__fadd_rn(__fmul_rn(p.alpha, acc[mt][nt][2 * h + 1]), bv1),
                                 col + 1);
              }
              acc[mt][nt][2 * h] = 0.f;
              acc[mt][nt][2 * h + 1] = 0.f;
            }
          }
        }
        if (((ct + kTC) & (p.cw - 1)) == 0) {
          // a chunk is complete: fold it into each row's carry
          __syncthreads();
          for (int r = warp; r < nr; r += kWarps)
            fold_chunk(keys + (size_t)r * p.cw, p.cw,
                       carry + (size_t)r * p.carry_w, sel, kf, p.kf_pad, tour,
                       lane);
        }
      }
    }

    // ---- per-row top-kf from the carry: the same warp owns the same rows --
    for (int r = warp; r < nr; r += kWarps) {
      const uint32_t* cr = carry + (size_t)r * p.carry_w;
      if (tour) {
        // the kf smallest of the pool (4 per bin)
        const uint32_t x = kth_key(cr, 4 * kNB, cr, 0, kf, lane);
        compact_le(cr, 4 * kNB, x, sel, 0, p.kf_pad, lane);
      } else {
        for (int i = lane; i < kf; i += 32) sel[i] = cr[i];
      }
      for (int i = kf + lane; i < p.kf_pad; i += 32) sel[i] = kNoKey;
      __syncwarp();
      for (int k2 = 2; k2 <= p.kf_pad; k2 <<= 1) {
        for (int jj = k2 >> 1; jj > 0; jj >>= 1) {
          for (int i = lane; i < p.kf_pad; i += 32) {
            const int ixj = i ^ jj;
            if (ixj > i) {
              const uint32_t u = sel[i], v = sel[ixj];
              const bool up = (i & k2) == 0;
              if ((u > v) == up) { sel[i] = v; sel[ixj] = u; }
            }
          }
          __syncwarp();
        }
      }
      float* ov = out_v + (size_t)r * kf;
      int32_t* oe = out_e + (size_t)r * kf;
      if (j == 0) {
        for (int i = lane; i < kf; i += 32) {
          float v; int e;
          decode_key(sel[i], &v, &e);
          ov[i] = v;
          oe[i] = e;
        }
      } else {
        // merge with the running top-kf: kf masked-min passes over
        // [carry | new], earliest position on ties
        for (int i = lane; i < kf; i += 32) {
          mv[i] = ov[i];
          me[i] = oe[i];
          float v; int e;
          decode_key(sel[i], &v, &e);
          mv[kf + i] = v;
          me[kf + i] = e + j * p.w;
        }
        __syncwarp();
        for (int i = 0; i < kf; ++i) {
          float mn = INFINITY;
          for (int t = lane; t < 2 * kf; t += 32) mn = fminf(mn, mv[t]);
          mn = warp_min(mn);
          unsigned am = 2u * kf;
          for (int t = lane; t < 2 * kf; t += 32) {
            if (mv[t] <= mn) { am = (unsigned)t; break; }
          }
          am = __reduce_min_sync(0xffffffffu, am);
          if (lane == 0) {
            ov[i] = mn;
            oe[i] = me[am];
            mv[am] = INFINITY;
          }
          __syncwarp();
        }
      }
      __syncwarp();
    }
  }
}

size_t smem_bytes(int rows, int cw, int carry_w, int dim, int kf, int kf_pad,
                  int n_sub) {
  const int rows_p = rows < 16 ? 16 : rows;
  const int a_st = (dim + kDKC - 1) / kDKC * kDKC + 8;
  size_t b = (size_t)rows * (cw + carry_w) * 4 + (size_t)rows_p * a_st * 2 +
             (size_t)kTC * kST * 2 + (size_t)kWarps * kf_pad * 4;
  if (n_sub > 1) b += (size_t)kWarps * 2 * kf * 8;
  return b;
}

template <typename TB, bool kVec>
cudaError_t launch(const Params& p, int s_pad, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<TB, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel<TB, kVec><<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_dtype(const Params& p, int s_pad, size_t smem,
                         cudaStream_t st) {
  // 16-byte staging needs whole 64-dim chunks and an aligned list block
  if (p.dim % kDKC == 0 && reinterpret_cast<uintptr_t>(p.b) % 16 == 0)
    return launch<TB, true>(p, s_pad, smem, st);
  return launch<TB, false>(p, s_pad, smem, st);
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
  if (kf < 1 || kf > kMaxKf || kf > w || w % 512 != 0 ||
      w > (1 << kPackBits) || c < 1 || dim < 1 || n_sub < 1 ||
      (size_t)n_sub * w > (size_t)m || b_dtype < 0 || b_dtype > 2)
    return (int)cudaErrorInvalidValue;
  int kf_pad = 1;
  while (kf_pad < kf) kf_pad <<= 1;
  // 32 query rows per block when they fit; the keys of a row live in
  // chunks of cw columns that fold into a small per-row carry
  const int carry_w = tournament ? 4 * kNB : (kf_pad < 4 ? 4 : kf_pad);
  int rows = kMaxRows, cw = w < kMaxChunk ? w : kMaxChunk;
  while (smem_bytes(rows, cw, carry_w, dim, kf, kf_pad, n_sub) > kSmemLimit) {
    if (cw > 512) cw >>= 1;
    else if (rows > 1) rows >>= 1;
    else break;
  }
  const size_t smem = smem_bytes(rows, cw, carry_w, dim, kf, kf_pad, n_sub);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Params p;
  p.strip_list = static_cast<const int32_t*>(strip_list);
  p.strip_rows = static_cast<const int32_t*>(strip_rows);
  p.sub_live = static_cast<const int32_t*>(sub_live);
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = b;
  p.bias = static_cast<const float*>(bias);
  p.out_v = static_cast<float*>(out_v);
  p.out_e = static_cast<int32_t*>(out_e);
  p.c = c;
  p.dim = dim;
  p.m = m;
  p.w = w;
  p.n_sub = n_sub;
  p.kf = kf;
  p.kf_pad = kf_pad;
  p.rows = rows;
  p.cw = cw;
  p.carry_w = carry_w;
  p.groups = (c + rows - 1) / rows;
  p.tournament = tournament;
  p.alpha = alpha;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_dtype == 0) return (int)launch_dtype<int8_t>(p, s_pad, smem, st);
  if (b_dtype == 1) return (int)launch_dtype<__nv_bfloat16>(p, s_pad, smem, st);
  return (int)launch_dtype<float>(p, s_pad, smem, st);
}
