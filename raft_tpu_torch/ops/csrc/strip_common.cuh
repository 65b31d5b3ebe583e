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
// the per-row threshold filter and candidate queue, the radix k-th key
// search, the ballot compaction, the per-row carry fold, the rank placement,
// the sub-block merge), the mma.sync product loop and the launch plan. A
// kernel source picks its policies and supplies its extern "C" entry point.
// K1 and K3 run their own product loop on wgmma wherever its plan fits
// (strip_kernel_wg, dense_src.cuh), with this selection.
//
// The selection. Each row keeps a threshold tau, its carry's kf-th key
// (kNoKey until the carry holds kf real keys). The epilogue of a column tile
// keeps only the keys below tau: without the tournament it appends them to
// the row's shared candidate queue (positions from a quad prefix sum and one
// shared atomic per quad); a fold - the kf smallest of carry and queue, by a
// radix select on 8-bit digits (4 histogram passes in shared memory) and a
// ballot compaction - runs only when the next tile could overflow the queue,
// and at the end of the sub-block. A fold costs the block far more than a
// tile's filtering (a warp's dependent chain while the others wait at the
// next barrier), so the queue is long: 512 keys a row up to kf 32, 256
// above (where the carry takes the room). Within a sub-block a row's packed
// keys are distinct (the column rides the low 12 bits), so a key >= tau
// could never enter the top-kf and dropping it changes nothing. With the tournament the
// column tile holds each bin once, so the thread that owns a column owns its
// (row, bin) slot of the pool for the whole sub-block: it inserts the key in
// place when it is below the bin's 4th key, with no queue, no fold and no
// barrier. A product-only instantiation (kSelect = false) runs the same
// product and score epilogue without any of this, so that the split of the
// kernel's time can be measured; no search launches it.
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
constexpr int kMaxQueue = 512;        // widest per-row candidate queue
constexpr int kRadix = 256;           // bins of one radix-select pass
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
  int qcap, carry_w;  // per-row candidate queue (0 with the tournament);
                      // per-row carry (512 | kf_pad)
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

// add the keys of a[0..n) whose bits under `mask` equal `prefix` to the
// histogram of their digit at `shift` (shared atomics: the warp's lanes that
// hold one digit serialize on one address, which costs less than grouping
// them first)
__device__ void radix_count(const uint32_t* a, int n, uint32_t prefix,
                            uint32_t mask, int shift, uint32_t* hist,
                            int lane) {
  for (int i = lane; i < n; i += 32) {
    const uint32_t k = a[i];
    if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
  }
}

// the kf-th smallest of the keys in a[0..na) and b[0..nb) (1 <= kf <= na +
// nb), by a radix select on 8-bit digits from the top: each pass counts the
// digit of the keys that share the prefix found so far and descends into the
// bin that holds the kf-th. Exact when the keys are distinct.
__device__ uint32_t radix_kth(const uint32_t* a, int na, const uint32_t* b,
                              int nb, int kf, uint32_t* hist, int lane) {
  uint32_t prefix = 0u, mask = 0u;
  uint32_t rank = (uint32_t)kf;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < kRadix; i += 32) hist[i] = 0u;
    __syncwarp();
    radix_count(a, na, prefix, mask, shift, hist, lane);
    radix_count(b, nb, prefix, mask, shift, hist, lane);
    __syncwarp();
    // lane l sums bins 8l .. 8l + 7; a warp scan finds the bin of rank
    uint32_t h[8], sum = 0u;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      h[t] = hist[8 * lane + t];
      sum += h[t];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t excl = incl - sum;
    const unsigned owner =
        __ballot_sync(0xffffffffu, excl < rank && rank <= incl);
    const int src = __ffs(owner) - 1;
    uint32_t bin = 0u, before = excl;
    if (lane == src) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (before + h[t] >= rank) {
          bin = (uint32_t)(8 * lane + t);
          break;
        }
        before += h[t];
      }
    }
    bin = __shfl_sync(0xffffffffu, bin, src);
    before = __shfl_sync(0xffffffffu, before, src);
    rank -= before;
    prefix |= bin << shift;
    mask |= 255u << shift;
    __syncwarp();  // the histogram is read before the next pass clears it
  }
  return prefix;
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

// one row's fold: the kf smallest keys of a[0..na) and b[0..nb) into
// sel[0..), in no order; returns how many (min(kf, real keys)). kNoKey
// entries (a tournament pool's empty slots) never count as keys.
__device__ int select_kf(const uint32_t* a, int na, const uint32_t* b, int nb,
                         uint32_t* sel, int kf, uint32_t* hist, int lane) {
  uint32_t x = kNoKey - 1u;
  if (na + nb > kf) {
    x = radix_kth(a, na, b, nb, kf, hist, lane);
    if (x == kNoKey) x = kNoKey - 1u;
  }
  const int n = compact_le(a, na, x, sel, 0, kf, lane);
  const int n2 = compact_le(b, nb, x, sel, n, kf, lane);
  __syncwarp();
  return min(n2, kf);
}

// A row's selection state in shared memory, for rows [0, rows):
//   queue[r * qcap ..]   keys below tau not folded yet (qn[r] of them)
//   carry[r * carry_w ..] the exact carry (cn[r] real keys, the rest
//                         kNoKey) or the tournament pool (4 per bin:
//                         carry[t * kNB + bin], ascending in t)
//   tau[r]                the carry's kf-th key, kNoKey while it holds
//                         fewer than kf
struct RowSel {
  uint32_t* queue;
  uint32_t* carry;
  int* qn;
  int* cn;
  uint32_t* tau;
};

// the epilogue's part for one row and a quad's 4 x 2 columns (lanes with
// the same g share the row): `k` holds this lane's keys (kNoKey = no key),
// `col` their columns; keys below the row's filter are kept
__device__ __forceinline__ void offer_keys(const RowSel& rs, int r, bool row_ok,
                                           const uint32_t (&k)[4],
                                           const int (&col)[4], int qcap,
                                           int carry_w, bool tour, int t4) {
  if (tour) {
    if (!row_ok) return;
    uint32_t* cr = rs.carry + (size_t)r * carry_w;
    // the bins of a row are XOR-swizzled by the row (bits 0, 3, 4 from r's
    // low 3 bits): the 8 rows x 4 column pairs a warp touches at once fall
    // in 32 distinct banks (the pool's order is free: it is selected from)
    const int swz = (r & 1) | ((r & 6) << 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bin = (col[e] & (kNB - 1)) ^ swz;
      uint32_t x = k[e];
      if (x < cr[3 * kNB + bin]) {
        // insertion into the bin's 4 ascending slots (this thread owns them)
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
    return;
  }
  const uint32_t tau = row_ok ? rs.tau[r] : 0u;
  bool take[4];
  int n = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    take[e] = row_ok && k[e] < tau;
    n += take[e];
  }
  // once the rows' carries are full, most tiles offer nothing: one vote
  if (!__any_sync(0xffffffffu, n > 0)) return;
  // quad prefix sum: lanes 4g .. 4g + 3 own the row
  int incl = n;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o, 4);
    if (t4 >= o) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
  int base = 0;
  if (t4 == 0 && total > 0) base = atomicAdd(&rs.qn[r], total);
  base = __shfl_sync(0xffffffffu, base, 0, 4) + incl - n;
  uint32_t* q = rs.queue + (size_t)r * qcap;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (take[e]) q[base++] = k[e];
}

// fold row r (one warp): the kf smallest of carry and queue become the
// carry, tau its kf-th key once it is full, and the queue empties; the
// winners are left in sel as well. With the tournament the fold is the
// pool's top-kf into sel. Returns the number of winners.
__device__ int fold_row(const RowSel& rs, int r, uint32_t* sel, int kf,
                        int qcap, int carry_w, bool tour, uint32_t* hist,
                        int lane) {
  uint32_t* cr = rs.carry + (size_t)r * carry_w;
  if (tour) return select_kf(cr, 4 * kNB, cr, 0, sel, kf, hist, lane);
  const int cn = rs.cn[r];
  const int qn = rs.qn[r];
  const int n = select_kf(cr, cn, rs.queue + (size_t)r * qcap, qn, sel, kf,
                          hist, lane);
  for (int i = lane; i < n; i += 32) cr[i] = sel[i];
  __syncwarp();
  uint32_t mx = 0u;
  for (int i = lane; i < n; i += 32) mx = max(mx, cr[i]);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    rs.cn[r] = n;
    rs.qn[r] = 0;
    if (n == kf) rs.tau[r] = mx;
  }
  __syncwarp();
  return n;
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

// a row's output for sub-block j from its fold's n winners in sel (distinct
// keys, any order): each key goes to its rank (the count of smaller keys),
// decoded; slots n.. read +inf at their own position. Sub-block 0 writes the
// row; a later one merges into the running top-kf with kf masked-min passes
// over [running | new], earliest position on ties (offsets + j * w).
__device__ void emit_row(const uint32_t* sel, int n, float* ov, int32_t* oe,
                         float* mv, int* me, int kf, int j, int w, int lane) {
  float* dv = j == 0 ? ov : mv + kf;
  int* de = j == 0 ? oe : me + kf;
  for (int i = lane; i < n; i += 32) {
    const uint32_t x = sel[i];
    int rank = 0;
    for (int t = 0; t < n; ++t) rank += sel[t] < x;
    float v; int e;
    decode_key(x, &v, &e);
    dv[rank] = v;
    de[rank] = e + j * w;
  }
  for (int i = n + lane; i < kf; i += 32) {
    dv[i] = INFINITY;
    de[i] = i + j * w;
  }
  __syncwarp();
  if (j == 0) return;
  for (int i = lane; i < kf; i += 32) {
    mv[i] = ov[i];
    me[i] = oe[i];
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

// the fold at the end of a column tile (after a barrier): the rows whose
// queue the next tile could overflow, and every row at the end of the walk
// (the tournament only then), one warp a row in turn; the last fold leaves
// the row's winners in sel, which emit_row places as its top-kf
template <int kNW>
__device__ __forceinline__ void fold_rows(const RowSel& rs, const Params& p,
                                          bool last, int nr, int warp,
                                          int lane, uint32_t* sel,
                                          uint32_t* hist, float* mv, int* me,
                                          float* out_v, int32_t* out_e,
                                          int j) {
  const bool tour = p.tournament != 0;
  for (int r = warp; r < nr; r += kNW) {
    if (!last && rs.qn[r] <= p.qcap - kTC) continue;
    const int n_win = fold_row(rs, r, sel, p.kf, p.qcap, p.carry_w, tour,
                               hist, lane);
    if (last) emit_row(sel, n_win, out_v + (size_t)r * p.kf,
                       out_e + (size_t)r * p.kf, mv, me, p.kf, j, p.w, lane);
  }
}

// The kernel body. `Src` supplies the list side of the product:
//   Src::kScaled                      multiply by scale[row] before the bias;
//   Src::Vec                          register-staged fast path:
//     load(p, ad, ct, dk, tid)        fetch the (kTC x kDKC) chunk of the
//                                     columns ct.. at dims dk.. (rows the
//                                     address policy `ad` lacks read as 0);
//     store(p, b_s, dk, tid)          write it to shared memory as bf16;
//   Src::stage_scalar(b_s, p, ad, ct, dk, tid)   the same, any width.
// kVec picks the fast path; its launcher checks that the shapes allow it.
// kSelect = false is the product-only instantiation (no keys, no output).
//
// Columns past `live` (paged: past the chain) score +inf with their own
// column, as the TPU kernels' lane mask leaves them; columns past w produce
// no key. A row whose sub-block walks fewer than kf columns ends with keys
// missing from its top-kf: those slots read +inf at their own position,
// which is the column the all-+inf remainder of the block would have given.
template <class Src, class Addr, bool kVec, bool kSelect>
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
  RowSel rs;
  rs.queue = reinterpret_cast<uint32_t*>(smem);              // (rows, qcap)
  rs.carry = rs.queue + (size_t)p.rows * p.qcap;          // (rows, carry_w)
  const int rows4 = (p.rows + 3) & ~3;  // keeps what follows 16-byte aligned
  rs.qn = reinterpret_cast<int*>(rs.carry + (size_t)p.rows * p.carry_w);
  rs.cn = rs.qn + rows4;
  rs.tau = reinterpret_cast<uint32_t*>(rs.cn + rows4);
  uint32_t* hist_all = rs.tau + rows4;                     // (kWarps, kRadix)
  const int n_chunks = (p.dim + kDKC - 1) / kDKC;
  const int a_st = n_chunks * kDKC + 8;                      // a_s row stride
  __nv_bfloat16* a_s =
      reinterpret_cast<__nv_bfloat16*>(hist_all + kWarps * kRadix);
  __nv_bfloat16* b_s = a_s + rows_p * a_st;
  uint32_t* sel_all = reinterpret_cast<uint32_t*>(b_s + kTC * kST);
  float* mv_all = reinterpret_cast<float*>(sel_all + (size_t)kWarps * p.kf_pad);
  int* me_all = reinterpret_cast<int*>(mv_all + (size_t)kWarps * 2 * p.kf);
  int* pg_s = reinterpret_cast<int*>(mv_all) +  // after the merge buffers
              (p.n_sub > 1 ? (size_t)kWarps * 4 * p.kf : 0);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;      // per-warp winners
  uint32_t* hist = hist_all + warp * kRadix;              // per-warp radix
  float* mv = mv_all + (size_t)warp * 2 * p.kf;           // per-warp merge
  int* me = me_all + (size_t)warp * 2 * p.kf;             // (n_sub > 1 only)

  const __nv_bfloat16* A = p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * p.kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * p.kf;
  const int kf = p.kf;
  stage_a(a_s, A, rows_p, nr, p.dim, a_st - 8, tid);  // read after a sync
  float sink = INFINITY;  // product-only: keeps the scores live

  Addr ad;
  for (int j = 0; j < p.n_sub; ++j) {
    __syncthreads();  // the previous sub-block's rows and page ids are read
    ad.init(p, lst, j, pg_s, tid);
    if (Addr::kPaged) __syncthreads();  // the page ids are staged
    if (ad.live == 0) {
      // dead sub-block: first visit writes the all-dead extraction result,
      // revisits leave the running top-kf as it is
      if (kSelect && j == 0) {
        for (int i = tid; i < nr * kf; i += kThreads) {
          out_v[i] = INFINITY;
          out_e[i] = i % kf;
        }
      }
      continue;
    }
    if (kSelect) {
      for (int i = tid; i < nr * p.carry_w; i += kThreads) rs.carry[i] = kNoKey;
      for (int i = tid; i < nr; i += kThreads) {
        rs.qn[i] = 0;
        rs.cn[i] = 0;
        rs.tau[i] = kNoKey;
      }
    }
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
      __syncthreads();  // the previous step's fragments are read
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
        // order keys offered to each row's filter; explicit roundings keep
        // nvcc from contracting the product and the add into an FMA
        int cols[4];
        float bv[4], sv[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = ct + n0 + nt * 8 + 2 * t4 + e;
            cols[2 * nt + e] = col;
            sv[2 * nt + e] = 1.f;
            if constexpr (Addr::kPaged) {
              const bool h = ad.has(col);
              bv[2 * nt + e] = h ? p.bias[ad.row(col)] : INFINITY;
              if (Src::kScaled && h) sv[2 * nt + e] = p.scale[ad.row(col)];
            } else {
              bv[2 * nt + e] = bias_l[col];
              if (Src::kScaled) sv[2 * nt + e] = scale_l[col];
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMaxRows / 16; ++mt) {
          if (mt < m_tiles) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = mt * 16 + g + 8 * h;
              uint32_t k[4];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = 2 * nt + e;
                  float x = __fmul_rn(p.alpha, acc[mt][nt][2 * h + e]);
                  if (Src::kScaled) x = __fmul_rn(x, sv[i]);
                  x = __fadd_rn(x, bv[i]);
                  if (Addr::kPaged && !ad.has(cols[i])) x = INFINITY;
                  if (!kSelect) sink = fminf(sink, x);
                  // paged: past the chain +inf lanes up to w, no key beyond
                  k[i] = (Addr::kPaged && cols[i] >= p.w) ? kNoKey
                                                          : pack_key(x, cols[i]);
                  acc[mt][nt][2 * h + e] = 0.f;
                }
              }
              if (kSelect)
                offer_keys(rs, r, r < nr, k, cols, p.qcap, p.carry_w, tour,
                           t4);
            }
          }
        }
        // fold the rows whose queue the next tile could overflow, and every
        // row at the end of the walk (the tournament only then); the last
        // fold leaves the row's winners in sel, which become its top-kf
        const bool last = ct + kTC >= ad.cols;
        if (kSelect && (last || !tour)) {
          __syncthreads();
          fold_rows<kWarps>(rs, p, last, nr, warp, lane, sel, hist, mv, me,
                            out_v, out_e, j);
        }
      }
    }
  }
  if (!kSelect && sink == -1.0f) out_v[0] = sink;  // never: a data dependence
}

size_t smem_bytes(int rows, int qcap, int carry_w, int dim, int kf,
                  int kf_pad, int n_sub, int ppf) {
  const int rows_p = rows < 16 ? 16 : rows;
  const int rows4 = (rows + 3) & ~3;
  const int a_st = (dim + kDKC - 1) / kDKC * kDKC + 8;
  size_t b = (size_t)rows * (qcap + carry_w) * 4 + (size_t)rows4 * 3 * 4 +
             (size_t)kWarps * kRadix * 4 + (size_t)rows_p * a_st * 2 +
             (size_t)kTC * kST * 2 + (size_t)kWarps * kf_pad * 4;
  if (n_sub > 1) b += (size_t)kWarps * 2 * kf * 8;
  return b + (size_t)ppf * 4;  // the paged walk's page ids
}

// Checks the class shape and fills the launch plan of `p` (kf_pad, rows per
// block, candidate queue, carry, groups) from c, dim, w, n_sub, kf,
// tournament (and, paged, page_rows, table_width, ppf). Returns the dynamic
// shared memory the kernel needs, or 0 when the shape is one the kernel
// does not take.
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
  // 32 query rows per block when they fit; each row's keys below its
  // threshold queue up (up to kMaxQueue, half of it above kf 32, at least
  // one tile's kTC) and fold into a per-row carry; the tournament keeps its
  // pool and no queue
  p.carry_w = p.tournament ? 4 * kNB : (p.kf_pad < 4 ? 4 : p.kf_pad);
  p.rows = kMaxRows;
  p.qcap = p.tournament ? 0 : (p.kf_pad <= 32 ? kMaxQueue : kMaxQueue / 2);
  while (smem_bytes(p.rows, p.qcap, p.carry_w, p.dim, p.kf, p.kf_pad,
                    p.n_sub, ppf) > kSmemLimit) {
    if (p.qcap > kTC) p.qcap >>= 1;
    else if (p.rows > 1) p.rows >>= 1;
    else break;
  }
  const size_t smem = smem_bytes(p.rows, p.qcap, p.carry_w, p.dim, p.kf,
                                 p.kf_pad, p.n_sub, ppf);
  if (smem > kSmemLimit) return 0;
  p.groups = (p.c + p.rows - 1) / p.rows;
  return smem;
}

template <class Src, class Addr, bool kVec, bool kSelect = true>
cudaError_t launch(const Params& p, int s_pad, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<Src, Addr, kVec, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel<Src, Addr, kVec, kSelect>
      <<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
