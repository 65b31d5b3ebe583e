// Shared body of the strip-scan kernels K1 (strip_scan.cu), K2 (bq_scan.cu),
// K3 (paged_scan.cu) and K4 (paged_bq_scan.cu), written for Hopper (sm_90a).
//
// All four score, for every strip s of one length class (one probed list x up
// to C query rows) and every query row r,
//
//   K1, K3: score[c] = alpha * (A[s, r, :] . B[row(c), :]) + bias[row(c)]
//   K2, K4: score[c] = (alpha * (A[s, r, :] . B[row(c), :])) * scale[row(c)]
//                      + bias[row(c)]
//
// with both operands in bf16 and the products summed in fp32, and keep each
// row's kf smallest packed scores (column in the low 12 mantissa bits). They
// differ in where B comes from (a list-side policy `Src`: dense rows of
// int8/uint8/bf16/fp32 values, dense_src.cuh, or packed sign bits expanded to
// +-1, packed_src.cuh) and in how column c of a sub-block maps to a row of
// the list arrays (an address policy `Addr`, below: the identity for the
// packed lists of K1/K2, a page-table walk for the paged pools of K3/K4). This
// header holds everything else once: the packed-key selection (order keys,
// the bitwise k-th key search, the ballot compaction, the per-row carry fold,
// the bitonic sort, the sub-block merge), the tensor-core product loop and
// the launch plan. A kernel source picks its policies and supplies its
// extern "C" entry point.
//
// The design, and what bounds it, is described in strip_scan.cu (K1) and
// paged_scan.cu (the paged walk).

#pragma once

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
  const void* b;              // list rows: K1 (n_lists, m, dim) values,
                              // K2 (n_lists, m, nb) packed uint8 codes
  const float* scale;         // (n_lists, m), K2 only
  const float* bias;          // (n_lists, m)
  float* out_v;               // (S, c, kf)
  int32_t* out_e;             // (S, c, kf)
  int c, dim, m, w, n_sub, kf, kf_pad, rows, groups, tournament;
  int cw, carry_w;  // key-chunk columns; per-row carry (512 | kf_pad)
  int nb;           // K2, K4: packed bytes per list row (dim == 8 * nb)
  float alpha;
  // paged pools (K3, K4): b, scale and bias are (cap_pages * page_rows, .)
  // and sub-block j of list l is the pages table[l, j*ppf .. j*ppf + nv)
  const int32_t* table;  // (n_lists * table_width,), -1 at absent slots
  const int32_t* chain;  // (n_lists,) live pages per list
  int paged, page_rows, table_width, ppf;
};

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

// slot i of a row's sorted top-kf: a real key decodes; an empty slot (the
// sub-block walked fewer than kf columns) reads +inf at column i
__device__ __forceinline__ void decode_slot(uint32_t key, int i, float* v,
                                            int* e) {
  if (key == kNoKey) {
    *v = INFINITY;
    *e = i;
  } else {
    decode_key(key, v, e);
  }
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
    // x is the kf-th smallest key, or kNoKey when carry and chunk hold fewer
    // than kf real keys: then every real key is kept and the rest of the
    // carry stays empty (the carry's own kNoKey slots must not crowd out
    // the chunk's keys)
    const uint32_t x = kth_key(cr, kf, kr, cw, kf, lane);
    const uint32_t xs = x == kNoKey ? kNoKey - 1u : x;
    const int n = compact_le(cr, kf, xs, sel, 0, kf_pad, lane);
    const int n2 = compact_le(kr, cw, xs, sel, n, kf_pad, lane);
    __syncwarp();
    for (int i = lane; i < kf; i += 32) cr[i] = i < n2 ? sel[i] : kNoKey;
  }
  __syncwarp();
}

// ---- row addressing of one (strip, sub-block) -----------------------------
// An address policy maps column c of the sub-block to a row of the list-side
// arrays (b, scale, bias) and says how many columns score (`live`) and how
// many the product loop walks (`cols`, whole 128-column tiles).
//
// ListAddr (K1, K2): packed lists, sub-block j of list l is the rows
// l*m + j*w .. + w; every column is walked; a dead sub-block (sub_live 0)
// has live = 0.
struct ListAddr {
  static constexpr bool kPaged = false;
  size_t base;
  int live, cols;
  __device__ void init(const Params& p, int lst, int j, int*, int) {
    base = (size_t)lst * p.m + (size_t)j * p.w;
    live = p.sub_live[(size_t)lst * p.n_sub + j] ? p.w : 0;
    cols = p.w;
  }
  __device__ __forceinline__ bool has(int) const { return true; }
  __device__ __forceinline__ size_t row(int c) const { return base + c; }
};

// PagedAddr (K3, K4): the sub-block's nv = clamp(chain[l] - j*ppf, 0, ppf) *
// sub_live[l*n_sub + j] live pages; their ids are staged in shared memory
// (pg), and column c reads pool row pg[c / R] * R + c % R. Only the first
// nv*R columns score; the walk stops at the tile that holds the last of
// them, so the work follows the live rows, not the capacity. Page slots at
// or past the chain (-1 in the table) are never read, nor are pool rows past
// nv*R.
struct PagedAddr {
  static constexpr bool kPaged = true;
  const int* pg;
  int R, live, cols;
  __device__ void init(const Params& p, int lst, int j, int* pg_s, int tid) {
    const int first = j * p.ppf;
    int nv = min(max(p.chain[lst] - first, 0), p.ppf);
    if (p.sub_live[(size_t)lst * p.n_sub + j] == 0) nv = 0;
    const int32_t* t = p.table + (size_t)lst * p.table_width + first;
    for (int i = tid; i < nv; i += kThreads) pg_s[i] = t[i];
    pg = pg_s;
    R = p.page_rows;
    live = nv * R;
    cols = (live + kTC - 1) / kTC * kTC;
  }
  __device__ __forceinline__ bool has(int c) const { return c < live; }
  __device__ __forceinline__ size_t row(int c) const {
    return (size_t)pg[c / R] * R + c % R;
  }
};

// The kernel body. `Src` supplies the list side of the product:
//   Src::kScaled                      multiply by scale[row] before the bias;
//   Src::Vec                          register-staged fast path:
//     load(p, ad, ct, dk, tid)        fetch the (kTC x kDKC) chunk of the
//                                     columns ct.. at dims dk.. (rows the
//                                     address policy `ad` lacks read as 0);
//     store(p, b_s, dk, tid)          write it to shared memory as bf16;
//   Src::stage_scalar(b_s, p, ad, ct, dk, tid)   the same, any width.
// kVec picks the fast path; its launcher checks that the shapes allow it.
//
// Columns past `live` (paged: past the chain) score +inf with their own
// column, as the TPU kernels' lane mask leaves them; columns past w produce
// no key. A row whose sub-block walks fewer than kf columns ends with keys
// missing from its top-kf: those slots read +inf at their own position,
// which is the column the all-+inf remainder of the block would have given.
template <class Src, class Addr, bool kVec>
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
  int* pg_s = reinterpret_cast<int*>(mv_all) +  // after the merge buffers
              (p.n_sub > 1 ? (size_t)kWarps * 4 * p.kf : 0);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;      // per-warp winners
  float* mv = mv_all + (size_t)warp * 2 * p.kf;           // per-warp merge
  int* me = me_all + (size_t)warp * 2 * p.kf;             // (n_sub > 1 only)

  const __nv_bfloat16* A = p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * p.kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * p.kf;
  const int kf = p.kf;
  stage_a(a_s, A, rows_p, nr, p.dim, a_st - 8, tid);  // read after a sync

  Addr ad;
  for (int j = 0; j < p.n_sub; ++j) {
    __syncthreads();  // the previous sub-block's rows and page ids are read
    ad.init(p, lst, j, pg_s, tid);
    if (Addr::kPaged) __syncthreads();  // the page ids are staged
    if (ad.live == 0) {
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
    for (int i = tid; i < nr * p.carry_w; i += kThreads) carry[i] = kNoKey;
    const int n_steps = (ad.cols / kTC) * n_chunks;
    // packed lists: the sub-block's bias and scale rows, hoisted
    const float* bias_l = Addr::kPaged ? nullptr : p.bias + ad.row(0);
    const float* scale_l =
        (Addr::kPaged || !Src::kScaled) ? nullptr : p.scale + ad.row(0);

    // ---- scores on the tensor cores, one (kTC x kDKC) step at a time -----
    float acc[kMaxRows / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < kMaxRows / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    typename Src::Vec pre;
    if (kVec) pre.load(p, ad, 0, 0, tid);
    for (int step = 0; step < n_steps; ++step) {
      const int ct = (step / n_chunks) * kTC;
      const int dk = (step % n_chunks) * kDKC;
      __syncthreads();  // the previous step's fragments and keys are read
      if (kVec) {
        pre.store(p, b_s, dk, tid);
      } else {
        Src::stage_scalar(b_s, p, ad, ct, dk, tid);
      }
      __syncthreads();
      if (kVec && step + 1 < n_steps) {
        const int nct = ((step + 1) / n_chunks) * kTC;
        const int ndk = ((step + 1) % n_chunks) * kDKC;
        pre.load(p, ad, nct, ndk, tid);
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
        // epilogue of a column tile: alpha * s (* scale) + bias, packed
        // order keys into the row's current chunk; explicit roundings keep
        // nvcc from contracting the product and the add into an FMA
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = ct + n0 + nt * 8 + 2 * t4;
          const int cc = col & (p.cw - 1);
          const bool h0 = ad.has(col), h1 = ad.has(col + 1);
          float bv0, bv1, sv0 = 1.f, sv1 = 1.f;
          if constexpr (Addr::kPaged) {
            bv0 = h0 ? p.bias[ad.row(col)] : INFINITY;
            bv1 = h1 ? p.bias[ad.row(col + 1)] : INFINITY;
            if (Src::kScaled) {
              if (h0) sv0 = p.scale[ad.row(col)];
              if (h1) sv1 = p.scale[ad.row(col + 1)];
            }
          } else {
            bv0 = bias_l[col];
            bv1 = bias_l[col + 1];
            if (Src::kScaled) {
              sv0 = scale_l[col];
              sv1 = scale_l[col + 1];
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMaxRows / 16; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + g + 8 * h;
              if (mt < m_tiles && r < nr) {
                float x0 = __fmul_rn(p.alpha, acc[mt][nt][2 * h]);
                float x1 = __fmul_rn(p.alpha, acc[mt][nt][2 * h + 1]);
                if (Src::kScaled) {
                  x0 = __fmul_rn(x0, sv0);
                  x1 = __fmul_rn(x1, sv1);
                }
                uint32_t* kr = keys + (size_t)r * p.cw + cc;
                if (Addr::kPaged) {
                  // past the chain: +inf lanes up to w, no key beyond it
                  kr[0] = col >= p.w ? kNoKey
                          : pack_key(h0 ? __fadd_rn(x0, bv0) : INFINITY, col);
                  kr[1] = col + 1 >= p.w ? kNoKey
                          : pack_key(h1 ? __fadd_rn(x1, bv1) : INFINITY,
                                     col + 1);
                } else {
                  kr[0] = pack_key(__fadd_rn(x0, bv0), col);
                  kr[1] = pack_key(__fadd_rn(x1, bv1), col + 1);
                }
              }
              acc[mt][nt][2 * h] = 0.f;
              acc[mt][nt][2 * h + 1] = 0.f;
            }
          }
        }
        const int end = ct + kTC;
        if ((end & (p.cw - 1)) == 0 || end == ad.cols) {
          // a chunk is complete, or the walk ends inside one (paged: a
          // short chain): fold its columns into each row's carry
          __syncthreads();
          const int n = ((end - 1) & (p.cw - 1)) + 1;
          for (int r = warp; r < nr; r += kWarps)
            fold_chunk(keys + (size_t)r * p.cw, n,
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
          decode_slot(sel[i], i, &v, &e);
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
          decode_slot(sel[i], i, &v, &e);
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
                  int n_sub, int ppf) {
  const int rows_p = rows < 16 ? 16 : rows;
  const int a_st = (dim + kDKC - 1) / kDKC * kDKC + 8;
  size_t b = (size_t)rows * (cw + carry_w) * 4 + (size_t)rows_p * a_st * 2 +
             (size_t)kTC * kST * 2 + (size_t)kWarps * kf_pad * 4;
  if (n_sub > 1) b += (size_t)kWarps * 2 * kf * 8;
  return b + (size_t)ppf * 4;  // the paged walk's page ids
}

// Checks the class shape and fills the launch plan of `p` (kf_pad, rows per
// block, key chunk, carry, groups) from c, dim, w, n_sub, kf, tournament
// (and, paged, page_rows, table_width, ppf). Returns the dynamic shared
// memory the kernel needs, or 0 when the shape is one the kernel does not
// take.
size_t plan_launch(Params& p) {
  if (p.kf < 1 || p.kf > kMaxKf || p.kf > p.w || p.w > (1 << kPackBits) ||
      p.c < 1 || p.dim < 1 || p.n_sub < 1)
    return 0;
  if (p.paged) {
    if (p.page_rows < 1 || p.ppf < 1 || p.w != p.ppf * p.page_rows ||
        p.table_width < 1 || p.tournament)
      return 0;
  } else if (p.w % 512 != 0 || (size_t)p.n_sub * p.w > (size_t)p.m) {
    return 0;
  }
  const int ppf = p.paged ? p.ppf : 0;
  p.kf_pad = 1;
  while (p.kf_pad < p.kf) p.kf_pad <<= 1;
  // 32 query rows per block when they fit; the keys of a row live in
  // chunks of cw columns (a power of two, whole tiles) that fold into a
  // small per-row carry
  p.carry_w = p.tournament ? 4 * kNB : (p.kf_pad < 4 ? 4 : p.kf_pad);
  p.rows = kMaxRows;
  const int w_tiles = (p.w + kTC - 1) / kTC * kTC;
  p.cw = kTC;
  while (p.cw < w_tiles && p.cw < kMaxChunk) p.cw <<= 1;
  while (smem_bytes(p.rows, p.cw, p.carry_w, p.dim, p.kf, p.kf_pad, p.n_sub,
                    ppf) > kSmemLimit) {
    if (p.cw > 512) p.cw >>= 1;
    else if (p.rows > 1) p.rows >>= 1;
    else break;
  }
  const size_t smem = smem_bytes(p.rows, p.cw, p.carry_w, p.dim, p.kf,
                                 p.kf_pad, p.n_sub, ppf);
  if (smem > kSmemLimit) return 0;
  p.groups = (p.c + p.rows - 1) / p.rows;
  return smem;
}

template <class Src, class Addr, bool kVec>
cudaError_t launch(const Params& p, int s_pad, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<Src, Addr, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel<Src, Addr, kVec>
      <<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
