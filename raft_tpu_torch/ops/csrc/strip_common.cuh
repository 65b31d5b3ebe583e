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
// row's kf smallest packed scores (column in the low 12 mantissa bits). A is
// a grouped (S, C, dim) operand, or, for K1 in the search, read by id: row
// qids[s, r] of the (q, dim) query rows, taken as the block stages its rows
// (a_row; -1 stages a zero row, as the grouped operand holds there). They
// differ in where B comes from (a list-side policy `Src`: dense rows of
// int8/uint8/bf16/fp32 values, dense_src.cuh, or packed sign bits expanded to
// +-1, packed_src.cuh) and in how column c of a sub-block maps to a row of
// the list arrays (an address policy `Addr`, below: the identity for the
// packed lists of K1/K2, a page-table walk for the paged pools of K3/K4, and,
// for K1 under a filter, the gathered walk over a packed list's live lanes
// alone). This
// header holds everything else once: the packed-key selection (order keys,
// the per-row threshold filter and candidate queue, the sorted carry and its
// bitonic fold, the sub-block merge), the two product loops and the launch
// plan. A kernel source picks its policies and supplies its extern "C"
// entry points.
//
// The product loops. strip_kernel_wg (below) runs the product on wgmma,
// taken transposed (the list tile is the M side, 64 columns a warpgroup,
// against the block's 32 query rows), wherever its plan fits (plan_wg: 32
// rows a block, whole 64-dim chunks). Its list operand comes from the
// list-side policy: a dense source converts each tile into a 128-byte
// swizzled shared tile (two barriers a chunk); the packed source builds the
// A fragments in registers straight from the code bytes each thread reads
// for its own two columns, so its product has no shared tile and no
// barrier; K3's byte pools take the ring loop: whole pages arrive by bulk
// copy (cp.async.bulk, mbarrier completion) into a ring of stages a few
// tiles ahead, and each thread builds its A fragments in registers from its
// two columns' bytes in the stage, with one barrier a tile. strip_kernel's
// mma.sync loop takes every other shape (dims not a multiple of 64, rows a
// block shrunk by a large kf's shared memory).
//
// The gathered walk (K1, GatherListAddr below). Under a filter many bias
// lanes of a sub-block are +inf, yet the dense walk runs the product and the
// selection over all w of them. The gathered walk first
// collects the sub-block's live lanes (finite bias) in ascending order into
// shared memory, then walks only those: column c is lane[c], read row by
// row through the per-row path the paged walk uses, and the walk stops at
// the tile that holds the last of them. A key carries the lane, not c, so
// ties, offsets and the sub-block merge see the columns the dense walk
// gives; columns past the live ones give no key (a row with fewer than kf
// live lanes ends with +inf slots at their own position). A gathered tile
// does not hold each bin once, so the gathered walk never plays the
// tournament: its selection is exact.
//
// The selection. Each row keeps a threshold tau, its carry's kf-th key
// (kNoKey until the carry holds kf real keys). The epilogue of a column tile
// keeps only the keys below tau: without the tournament it appends them to
// the row's shared candidate queue (positions from a prefix sum over the
// lanes that share the row and one shared atomic per row and warp). The
// carry is the row's smallest keys so far, sorted. A fold - when the next
// tile could overflow the queue, and at the end of the sub-block - merges
// the queue into it 128 keys at a time in one warp's registers: a bitonic
// sort of the chunk, then against each 128-key window of the carry the
// half-cleaner of the bitonic sequence (window, chunk) keeps the minima as
// the window (bitonic merge) and passes the maxima on. No histogram, no
// atomic and no rank search: tau and the row's output are read straight off
// the sorted carry. Within a sub-block a row's packed keys are distinct
// (the column rides the low 12 bits), so a key >= tau could never enter the
// top-kf and dropping it changes nothing. With the tournament the column
// tile holds each bin once, so the thread that owns a column owns its (row,
// bin) slot of the pool for the whole sub-block: it inserts the key in place
// when it is below the bin's 4th key, with no queue and no mid-walk fold; the
// last fold merges the pool into a sorted top. A product-only instantiation
// (kSelect = false) runs the same product and score epilogue without any of
// this, so that the split of the kernel's time can be measured; no search
// launches it.
//
// The design, and what bounds it, is described in strip_scan.cu (K1),
// bq_scan.cu (K2) and paged_scan.cu (the paged walk).

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
constexpr size_t kSmemLimit = 225 * 1024;

struct Params {
  const int32_t* strip_list;  // (S,)
  const int32_t* strip_rows;  // (S,) real query rows per strip, or null
  const int32_t* sub_live;    // (n_lists * n_sub,)
  const __nv_bfloat16* a;     // (S, c, dim), or with qids (q, dim)
  const int32_t* qids;        // K1: (S, c) query row of each slot, or null
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
  int ring;  // stages of the paged ring (strip_kernel_wg's ring loop), or 0
  int gathered;  // K1: the gathered walk over live lanes (GatherListAddr)
};

// unsigned key whose integer order is the float order of the packed score:
// a negative float's bits flipped, a positive one's sign bit set
__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  return bits ^ ((uint32_t)((int32_t)bits >> 31) | 0x80000000u);
}
__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

// the packed order key of score v at column col: v clamped to the finite
// range first (fminf returns the number, so NaN and +inf take the top,
// -inf the bottom), then the column in the low bits; no branch
__device__ __forceinline__ uint32_t pack_key(float v, int col) {
  const float clamp = __uint_as_float(kClampBits);
  v = fmaxf(fminf(v, clamp), -clamp);
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

// ---- the 128-byte swizzled layout of the wgmma operands ------------------
// Rows of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes; 16-byte chunk c of
// row r lies at r*128 + ((c ^ (r & 7)) << 4) from a 1024-aligned base.

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The block's query row r: row r of the grouped operand at A, or, given the
// slots' ids (K1 reading by id), row qid[r] of the query rows at A; -1 for
// an unused slot (a zero row, as the grouped operand holds there)
__device__ __forceinline__ int a_row(const int32_t* qid, int r) {
  return qid ? qid[r] : r;
}

// The strip's query rows, all dims, once per block: rows >= nr, unused slots
// and dims >= dim are zero; row stride dim_pad + 8 keeps the fragment loads
// conflict-free.
__device__ void stage_a(__nv_bfloat16* as, const __nv_bfloat16* A,
                        const int32_t* qid, int rows_p, int nr, int dim,
                        int dim_pad, int tid) {
  const int st = dim_pad + 8;
  for (int i = tid; i < rows_p * dim_pad; i += kThreads) {
    const int r = i / dim_pad, d = i % dim_pad;
    const int row = r < nr && d < dim ? a_row(qid, r) : -1;
    as[r * st + d] = row >= 0 ? A[(size_t)row * dim + d]
                              : __float2bfloat16_rn(0.f);
  }
}

// ---- per-row selection helpers (one warp per row) -------------------------
// A warp holds 128 keys in registers, 4 a lane, lane-major (key i is k[i %
// 4] of lane i / 4), and sorts or merges them with bitonic networks: a
// stage whose partners lie within a lane swaps registers, one whose
// partners lie in another lane exchanges them with a shuffle.

// one compare-exchange stage of a bitonic network over the warp's 128 keys:
// partners i and i ^ j; the run of kk keys that holds i is sorted ascending
// when bit kk of i is clear (descending with kDesc)
template <int kk, int j, bool kDesc>
__device__ __forceinline__ void bitonic_stage(uint32_t (&k)[4], int lane) {
  if constexpr (j >= 4) {
    const int i0 = lane * 4;  // bits j and kk of i are lane bits
    const bool asc = ((i0 & kk) == 0) != kDesc;
    const bool low = (i0 & j) == 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t y = __shfl_xor_sync(0xffffffffu, k[e], j >> 2);
      k[e] = (low == asc) ? min(k[e], y) : max(k[e], y);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e & j) continue;
      const int i = lane * 4 + e;
      const bool asc = ((i & kk) == 0) != kDesc;
      const uint32_t x = k[e], y = k[e | j];
      k[e] = asc ? min(x, y) : max(x, y);
      k[e | j] = asc ? max(x, y) : min(x, y);
    }
  }
}

// the 128 keys sorted (ascending, or descending with kDesc)
template <bool kDesc>
__device__ __forceinline__ void bitonic_sort(uint32_t (&k)[4], int lane) {
#define RAFT_SORT_RUN(kk)                                       \
  if constexpr (kk >= 128) bitonic_stage<kk, 64, kDesc>(k, lane); \
  if constexpr (kk >= 64) bitonic_stage<kk, 32, kDesc>(k, lane);  \
  if constexpr (kk >= 32) bitonic_stage<kk, 16, kDesc>(k, lane);  \
  if constexpr (kk >= 16) bitonic_stage<kk, 8, kDesc>(k, lane);   \
  if constexpr (kk >= 8) bitonic_stage<kk, 4, kDesc>(k, lane);    \
  if constexpr (kk >= 4) bitonic_stage<kk, 2, kDesc>(k, lane);    \
  bitonic_stage<kk, 1, kDesc>(k, lane);
  RAFT_SORT_RUN(2)
  RAFT_SORT_RUN(4)
  RAFT_SORT_RUN(8)
  RAFT_SORT_RUN(16)
  RAFT_SORT_RUN(32)
  RAFT_SORT_RUN(64)
  RAFT_SORT_RUN(128)
#undef RAFT_SORT_RUN
}

// a bitonic sequence of 128 keys sorted (ascending, or descending)
template <bool kDesc>
__device__ __forceinline__ void bitonic_merge(uint32_t (&k)[4], int lane) {
  bitonic_stage<256, 64, kDesc>(k, lane);
  bitonic_stage<256, 32, kDesc>(k, lane);
  bitonic_stage<256, 16, kDesc>(k, lane);
  bitonic_stage<256, 8, kDesc>(k, lane);
  bitonic_stage<256, 4, kDesc>(k, lane);
  bitonic_stage<256, 2, kDesc>(k, lane);
  bitonic_stage<256, 1, kDesc>(k, lane);
}

// 4 keys a lane of a[i0 ..), kNoKey at or past n (a is 16-byte aligned and
// readable up to the next multiple of 4 past n)
__device__ __forceinline__ void load4(const uint32_t* a, int i0, int n,
                                      uint32_t (&k)[4]) {
  uint4 v = make_uint4(kNoKey, kNoKey, kNoKey, kNoKey);
  if (i0 < n) v = *reinterpret_cast<const uint4*>(a + i0);
  k[0] = v.x;
  k[1] = i0 + 1 < n ? v.y : kNoKey;
  k[2] = i0 + 2 < n ? v.z : kNoKey;
  k[3] = i0 + 3 < n ? v.w : kNoKey;
}

// Merge the keys src[0..n) (any order, distinct) into top[0..top_w), the
// top_w smallest keys seen so far in ascending order (kNoKey where fewer):
// 128 keys at a time, sorted descending; against each 128-key window of
// top (ascending), the elementwise minima are the window's new keys and the
// maxima, all above them, carry on to the next window (the half-cleaner of
// the bitonic sequence window | chunk). top_w is a multiple of 4.
__device__ void merge_sorted(uint32_t* top, int top_w, const uint32_t* src,
                             int n, int lane) {
  for (int c0 = 0; c0 < n; c0 += 128) {
    uint32_t k[4];
    load4(src, c0 + 4 * lane, n, k);
    bitonic_sort<true>(k, lane);
    for (int w0 = 0; w0 < top_w; w0 += 128) {
      uint32_t t[4];
      load4(top, w0 + 4 * lane, top_w, t);
      uint32_t lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = min(t[e], k[e]);
        k[e] = max(t[e], k[e]);
      }
      bitonic_merge<false>(lo, lane);
      if (w0 + 4 * lane < top_w)
        *reinterpret_cast<uint4*>(top + w0 + 4 * lane) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      // the rest is above the window: done when it holds no key
      if (w0 + 128 >= top_w ||
          !__any_sync(0xffffffffu, k[0] != kNoKey || k[1] != kNoKey ||
                                       k[2] != kNoKey || k[3] != kNoKey))
        break;
      bitonic_merge<true>(k, lane);
    }
  }
  __syncwarp();
}

// A row's selection state in shared memory, for rows [0, rows):
//   queue[r * qcap ..]   keys below tau not folded yet (qn[r] of them)
//   carry[r * carry_w ..] the exact carry, the row's carry_w smallest keys
//                         so far in ascending order (kNoKey where fewer),
//                         or the tournament pool (4 per bin:
//                         carry[t * kNB + bin], ascending in t)
//   tau[r]                the carry's kf-th key, kNoKey while it holds
//                         fewer than kf
struct RowSel {
  uint32_t* queue;
  uint32_t* carry;
  int* qn;
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

// fold row r (one warp): the queue merges into the sorted carry, tau
// becomes its kf-th key and the queue empties; with the tournament the
// pool's kf_pad smallest keys go to sel instead. Returns the row's sorted
// top (the carry, or sel).
__device__ const uint32_t* fold_row(const RowSel& rs, int r, uint32_t* sel,
                                    int kf, int kf_pad, int qcap,
                                    int carry_w, bool tour, int lane) {
  uint32_t* cr = rs.carry + (size_t)r * carry_w;
  if (tour) {
    for (int i = lane; i < kf_pad; i += 32) sel[i] = kNoKey;
    __syncwarp();
    merge_sorted(sel, kf_pad, cr, 4 * kNB, lane);
    return sel;
  }
  merge_sorted(cr, carry_w, rs.queue + (size_t)r * qcap, rs.qn[r], lane);
  if (lane == 0) {
    rs.qn[r] = 0;
    rs.tau[r] = cr[kf - 1];
  }
  __syncwarp();
  return cr;
}

// ---- row addressing of one (strip, sub-block) -----------------------------
// An address policy maps column c of the sub-block to a row of the list-side
// arrays (b, scale, bias) and says how many columns score (`live`) and how
// many the product loop walks (`cols`, whole 128-column tiles). kPerRow:
// rows are addressed one by one (has, row), not as one contiguous block.
// Column c's key carries its lane of the sub-block, col(c), where
// keyed(p, c); a column that is not keyed gives no key.
//
// ListAddr (K1, K2): packed lists, sub-block j of list l is the rows
// l*m + j*w .. + w; every column is walked; a dead sub-block (sub_live 0)
// has live = 0.
struct ListAddr {
  static constexpr bool kPerRow = false;
  size_t base;
  int live, cols;
  __device__ void init(const Params& p, int lst, int j, int*, int) {
    base = (size_t)lst * p.m + (size_t)j * p.w;
    live = p.sub_live[(size_t)lst * p.n_sub + j] ? p.w : 0;
    cols = p.w;
  }
  __device__ __forceinline__ bool has(int) const { return true; }
  __device__ __forceinline__ size_t row(int c) const { return base + c; }
  __device__ __forceinline__ bool keyed(const Params&, int) const {
    return true;
  }
  __device__ __forceinline__ int col(int c) const { return c; }
};

// PagedAddr (K3, K4): the sub-block's nv = clamp(chain[l] - j*ppf, 0, ppf) *
// sub_live[l*n_sub + j] live pages; their ids are staged in shared memory
// (pg), and column c reads pool row pg[c / R] * R + c % R. Only the first
// nv*R columns score; the walk stops at the tile that holds the last of
// them, so the work follows the live rows, not the capacity. Page slots at
// or past the chain (-1 in the table) are never read, nor are pool rows past
// nv*R. Past the chain, lanes up to w are +inf with their own offsets; a
// column at or past w gives no key.
struct PagedAddr {
  static constexpr bool kPerRow = true;
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
  __device__ __forceinline__ bool keyed(const Params& p, int c) const {
    return c < p.w;
  }
  __device__ __forceinline__ int col(int c) const { return c; }
};

// GatherListAddr (K1 under a filter): the packed lists of
// ListAddr, walked over the sub-block's live lanes (finite bias) alone. init
// gathers their offsets in ascending order into shared memory (lane[],
// uint16: w <= 4096) from the sub-block's w bias floats: each warp ballots
// its w / 8 lanes 32 at a time (the ballots kept in shared memory), a prefix
// over the warps' counts places each warp's lanes. live counts them, cols
// rounds live up to whole tiles, column c reads list row base + lane[c] and
// its key carries lane[c]; the columns past the live ones give no key. A
// sub-block with no finite lane gathers nothing (live 0: dead), so the walk
// reads no sub_live (the launch passes none).
// Shared memory: gather_bytes(w), in the address policy's scratch.
struct GatherListAddr {
  static constexpr bool kPerRow = true;
  const uint16_t* lane;
  size_t base;
  int live, cols;
  __device__ void init(const Params& p, int lst, int j, int* scratch,
                       int tid) {
    base = (size_t)lst * p.m + (size_t)j * p.w;
    int* cnt = scratch;                                      // (kWarps,)
    uint32_t* bal = reinterpret_cast<uint32_t*>(scratch + kWarps);  // w/32
    uint16_t* ln = reinterpret_cast<uint16_t*>(bal + p.w / 32);     // (w,)
    lane = ln;
    const int wl = tid & 31, warp = tid >> 5;
    const int span = p.w / kWarps;  // a warp's lanes: a multiple of 64
    const float* b = p.bias + base + (size_t)warp * span;
    int n = 0;
    for (int c = 0; c < span; c += 32) {
      const uint32_t m = __ballot_sync(0xffffffffu, isfinite(b[c + wl]));
      if (wl == 0) bal[(warp * span + c) >> 5] = m;
      n += __popc(m);
    }
    if (wl == 0) cnt[warp] = n;
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      off += i < warp ? cnt[i] : 0;
      total += cnt[i];
    }
    for (int c = 0; c < span; c += 32) {
      const uint32_t m = bal[(warp * span + c) >> 5];
      if ((m >> wl) & 1u)
        ln[off + __popc(m & ((1u << wl) - 1u))] =
            (uint16_t)(warp * span + c + wl);
      off += __popc(m);
    }
    live = total;
    cols = (total + kTC - 1) / kTC * kTC;
  }
  __device__ __forceinline__ bool has(int c) const { return c < live; }
  __device__ __forceinline__ size_t row(int c) const { return base + lane[c]; }
  __device__ __forceinline__ bool keyed(const Params&, int c) const {
    return c < live;
  }
  __device__ __forceinline__ int col(int c) const { return lane[c]; }
};

// shared-memory bytes of GatherListAddr's scratch for w lanes: the warps'
// counts, the ballots and the gathered lanes
__host__ __device__ __forceinline__ size_t gather_bytes(int w) {
  return ((size_t)kWarps * 4 + (size_t)w / 32 * 4 + (size_t)w * 2 + 15) &
         ~(size_t)15;
}

// shared-memory bytes of a launch's address-policy scratch: the paged walk's
// page ids, the gathered walk's lanes, or none
__host__ __device__ __forceinline__ size_t addr_bytes(const Params& p) {
  if (p.paged) return (size_t)p.ppf * 4;
  return p.gathered ? gather_bytes(p.w) : 0;
}

// a row's output for sub-block j from its sorted top-kf (kNoKey where the
// sub-block walked fewer than kf columns: +inf at the slot's own position).
// Sub-block 0 writes the row; a later one merges into the running top-kf
// with kf masked-min passes over [running | new], earliest position on ties
// (offsets + j * w).
__device__ void emit_row(const uint32_t* top, float* ov, int32_t* oe,
                         float* mv, int* me, int kf, int j, int w, int lane) {
  float* dv = j == 0 ? ov : mv + kf;
  int* de = j == 0 ? oe : me + kf;
  for (int i = lane; i < kf; i += 32) {
    float v;
    int e;
    decode_slot(top[i], i, &v, &e);
    dv[i] = v;
    de[i] = e + j * w;
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
// (the tournament only then), one warp a row in turn; the last fold's sorted
// top becomes the row's output. With `eager` (a round taken only when some
// row needs it) every row with a queued key folds: its threshold tightens
// while the warps that need no fold would wait at the next barrier anyway.
template <int kNW>
__device__ __forceinline__ void fold_rows(const RowSel& rs, const Params& p,
                                          bool last, int nr, int warp,
                                          int lane, uint32_t* sel, float* mv,
                                          int* me, float* out_v,
                                          int32_t* out_e, int j,
                                          bool eager = false) {
  const bool tour = p.tournament != 0;
  for (int r = warp; r < nr; r += kNW) {
    if (!last && rs.qn[r] <= (eager ? 0 : p.qcap - kTC)) continue;
    const uint32_t* top = fold_row(rs, r, sel, p.kf, p.kf_pad, p.qcap,
                                   p.carry_w, tour, lane);
    if (last) emit_row(top, out_v + (size_t)r * p.kf,
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
  rs.tau = reinterpret_cast<uint32_t*>(rs.qn + rows4);
  const int n_chunks = (p.dim + kDKC - 1) / kDKC;
  const int a_st = n_chunks * kDKC + 8;                      // a_s row stride
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(rs.tau + rows4);
  __nv_bfloat16* b_s = a_s + rows_p * a_st;
  uint32_t* sel_all = reinterpret_cast<uint32_t*>(b_s + kTC * kST);
  float* mv_all = reinterpret_cast<float*>(sel_all + (size_t)kWarps * p.kf_pad);
  int* me_all = reinterpret_cast<int*>(mv_all + (size_t)kWarps * 2 * p.kf);
  // the address policy's scratch (page ids, gathered lanes), after the
  // merge buffers
  int* pg_s = reinterpret_cast<int*>(mv_all) +
              (p.n_sub > 1 ? (size_t)kWarps * 4 * p.kf : 0);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;  // per-warp tournament top
  float* mv = mv_all + (size_t)warp * 2 * p.kf;           // per-warp merge
  int* me = me_all + (size_t)warp * 2 * p.kf;             // (n_sub > 1 only)

  const int32_t* qid = p.qids ? p.qids + (size_t)s * p.c + r0 : nullptr;
  const __nv_bfloat16* A =
      qid ? p.a : p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * p.kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * p.kf;
  const int kf = p.kf;
  stage_a(a_s, A, qid, rows_p, nr, p.dim, a_st - 8, tid);  // read after a sync
  float sink = INFINITY;  // product-only: keeps the scores live

  Addr ad;
  for (int j = 0; j < p.n_sub; ++j) {
    __syncthreads();  // the previous sub-block's rows and page ids are read
    ad.init(p, lst, j, pg_s, tid);
    if (Addr::kPerRow) __syncthreads();  // the page ids or lanes are staged
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
        rs.tau[i] = kNoKey;
      }
    }
    const int n_steps = (ad.cols / kTC) * n_chunks;
    // packed lists: the sub-block's bias and scale rows, hoisted
    const float* bias_l = Addr::kPerRow ? nullptr : p.bias + ad.row(0);
    const float* scale_l =
        (Addr::kPerRow || !Src::kScaled) ? nullptr : p.scale + ad.row(0);

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
        // nvcc from contracting the product and the add into an FMA; a
        // keyed column's key carries its lane
        int cols[4];
        float bv[4], sv[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = ct + n0 + nt * 8 + 2 * t4 + e;
            cols[2 * nt + e] = col;
            sv[2 * nt + e] = 1.f;
            if constexpr (Addr::kPerRow) {
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
                  if (Addr::kPerRow && !ad.has(cols[i])) x = INFINITY;
                  if (!kSelect) sink = fminf(sink, x);
                  k[i] = ad.keyed(p, cols[i]) ? pack_key(x, ad.col(cols[i]))
                                              : kNoKey;
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
          fold_rows<kWarps>(rs, p, last, nr, warp, lane, sel, mv, me, out_v,
                            out_e, j);
        }
      }
    }
  }
  if (!kSelect && sink == -1.0f) out_v[0] = sink;  // never: a data dependence
}

size_t smem_bytes(int rows, int qcap, int carry_w, int dim, int kf,
                  int kf_pad, int n_sub, size_t addr_b) {
  const int rows_p = rows < 16 ? 16 : rows;
  const int rows4 = (rows + 3) & ~3;
  const int a_st = (dim + kDKC - 1) / kDKC * kDKC + 8;
  size_t b = (size_t)rows * (qcap + carry_w) * 4 + (size_t)rows4 * 2 * 4 +
             (size_t)rows_p * a_st * 2 + (size_t)kTC * kST * 2 +
             (size_t)kWarps * kf_pad * 4;
  if (n_sub > 1) b += (size_t)kWarps * 2 * kf * 8;
  return b + addr_b;  // the address policy's scratch
}

// Checks the class shape and fills the launch plan of `p` (kf_pad, rows per
// block, candidate queue, carry, groups) from c, dim, w, n_sub, kf,
// tournament, gathered (and, paged, page_rows, table_width, ppf). Returns the
// dynamic shared memory the kernel needs, or 0 when the shape is one the
// kernel does not take.
size_t plan_launch(Params& p) {
  if (p.kf < 1 || p.kf > kMaxKf || p.kf > p.w || p.w > (1 << kPackBits) ||
      p.c < 1 || p.dim < 1 || p.n_sub < 1)
    return 0;
  if (p.tournament && p.kf < 3) return 0;  // the pool's top: 4 keys a lane
  // the gathered walk: packed lists, exact selection
  if (p.gathered && (p.paged || p.tournament)) return 0;
  if (p.paged) {
    if (p.page_rows < 1 || p.ppf < 1 || p.w != p.ppf * p.page_rows ||
        p.table_width < 1 || p.tournament)
      return 0;
  } else if (p.w % 512 != 0 || (size_t)p.n_sub * p.w > (size_t)p.m) {
    return 0;
  }
  const size_t addr_b = addr_bytes(p);
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
                    p.n_sub, addr_b) > kSmemLimit) {
    if (p.qcap > kTC) p.qcap >>= 1;
    else if (p.rows > 1) p.rows >>= 1;
    else break;
  }
  const size_t smem = smem_bytes(p.rows, p.qcap, p.carry_w, p.dim, p.kf,
                                 p.kf_pad, p.n_sub, addr_b);
  if (smem > kSmemLimit) return 0;
  p.groups = (p.c + p.rows - 1) / p.rows;
  return smem;
}

// the product loop of the library's last launch (host side), which the
// kernel sources report through their *_loop entry points
constexpr int kLoopMma = 0;
constexpr int kLoopWgmma = 1;
constexpr int kLoopRing = 2;  // strip_kernel_wg's paged ring (K3)
int g_loop = -1;

template <class Src, class Addr, bool kVec, bool kSelect = true>
cudaError_t launch(const Params& p, int s_pad, size_t smem, cudaStream_t st) {
  g_loop = kLoopMma;
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<Src, Addr, kVec, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel<Src, Addr, kVec, kSelect>
      <<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---- the product on wgmma (K1-K4) ----------------------------------------
// strip_kernel_wg is every strip kernel's wherever its plan fits (plan_wg):
// the block, plan, list-side and address policies and selection of
// strip_kernel (256 threads, 32 query rows, two blocks a SM), with the
// product on wgmma instead of mma.sync. The product is taken transposed,
// D = B . A^T: the list tile is the M side, so each of the two warpgroups
// multiplies 64 columns of the 128-column tile against all 32 rows
// (m64n32k16, bf16, fp32 accumulate) and no row is padding. The query rows
// are staged once a block in the 128-byte swizzled K-major layout the
// tensor cores read. The list side either converts each tile into a shared
// operand in the same layout (Src::Vec::store_swz, register-staged one tile
// ahead; dense values to bf16) or, with Src::kRegA, supplies the A
// fragments from registers (wgmma's register-A form): a thread's fragment
// rows are exactly the two columns its accumulators hold, so it reads those
// columns' code bytes (one chunk ahead) and expands them itself, and the
// product needs no shared tile and no barrier; the query rows are then
// staged in the list side's order of the dims (Src::a_dim). A thread's
// accumulators are columns 16*wi + g + 8h of its warpgroup's 64 and rows
// 8i + 2*t4 + e, so the eight lanes that share t4 share two rows: the
// candidate queue's positions come from prefix sums over those lanes
// (offer_tile_t), and the tournament pool's bins are swizzled for this
// layout.

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

// the same with A from registers: a[] is this thread's fragment of the
// warp's 16 x 16 slice (rows g, g + 8; k 2*t4 .. + 1, 2*t4 + 8 .. + 9)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

// one 64-dim chunk of the product with A from registers: d (+)= the four
// k-steps' fragments a[] against the query rows' chunk at a_chunk (shared
// address), issued and waited for; first overwrites d
__device__ __forceinline__ void wgmma_chunk_rs(float (&d)[16],
                                               const uint32_t (&a)[4][4],
                                               uint32_t a_chunk, bool first) {
  wg_acc_fence(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kDKC / 16; ++ks)
    wgmma_m64n32k16_rs(d, a[ks], wg_desc(a_chunk + ks * 32),
                       (first && ks == 0) ? 0 : 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_acc_fence(d);
}

// ---- the paged ring's bulk copies (cp.async.bulk, mbarrier completion) ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `bar` with this parity has completed (a copy
// that never lands traps after ~2^31 polls instead of hanging the card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == 0x80000000u) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a or b by value, word by word (selects, not a reference that would put
// both in local memory)
__device__ __forceinline__ uint4 pick(bool take_a, const uint4& a,
                                      const uint4& b) {
  return make_uint4(take_a ? a.x : b.x, take_a ? a.y : b.y,
                    take_a ? a.z : b.z, take_a ? a.w : b.w);
}

// shared-memory bytes of one ring stage: a tile's payload (kTC rows of dim
// bytes) and its bias (kTC floats)
__host__ __device__ __forceinline__ size_t ring_stage_bytes(int dim) {
  return (size_t)kTC * dim + (size_t)kTC * 4;
}

// offer_keys for the transposed fragment, a whole tile at once: this lane's
// keys k[i][e][h] of row 8i + 2*t4 + e at columns col[h]. The eight lanes
// with the same t4 (g = 0..7) share those eight rows, so two prefix sums
// over them (four rows' counts a byte) place every key; one lane a row
// reserves its room with one atomic. The four row pairs go through each step
// together, so their latencies overlap. A lane that reserved room returns
// whether its row needs a fold after this tile (its queue could overflow on
// the next one): the last reservation of a row sees its final count, so the
// OR over the block is exact.
__device__ __forceinline__ bool offer_tile_t(const RowSel& rs, int nr,
                                             const uint32_t (&k)[4][2][2],
                                             const int (&col)[2], int qcap,
                                             int carry_w, bool tour, int g,
                                             int t4) {
  if (tour) {
    // bins XOR-swizzled by bits 3-4 from the row's t4: the 4 rows x 8
    // columns a warp touches at once fall in 32 distinct banks
    const int swz_bin = (t4 & 3) << 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + 2 * t4 + e;
        if (r >= nr) continue;
        uint32_t* cr = rs.carry + (size_t)r * carry_w;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bin = (col[h] & (kNB - 1)) ^ swz_bin;
          uint32_t x = k[i][e][h];
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
    return false;
  }
  // byte 2*(i & 1) + e of cnt[i >> 1]: the keys this lane offers row 8i +
  // 2*t4 + e (at most 2; a row's sum over the eight lanes at most 16)
  bool take[4][2][2];
  uint32_t cnt[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * i + 2 * t4 + e;
      const uint32_t tau = r < nr ? rs.tau[r] : 0u;
      take[i][e][0] = k[i][e][0] < tau;
      take[i][e][1] = k[i][e][1] < tau;
      cnt[i >> 1] += (uint32_t)((int)take[i][e][0] + (int)take[i][e][1])
                     << (8 * (2 * (i & 1) + e));
    }
  if (!__any_sync(0xffffffffu, (cnt[0] | cnt[1]) != 0u)) return false;
  uint32_t inc[2] = {cnt[0], cnt[1]};
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const uint32_t y0 = __shfl_up_sync(0xffffffffu, inc[0], 4 * o);
    const uint32_t y1 = __shfl_up_sync(0xffffffffu, inc[1], 4 * o);
    if (g >= o) {
      inc[0] += y0;
      inc[1] += y1;
    }
  }
  const uint32_t tot[2] = {__shfl_sync(0xffffffffu, inc[0], 28 + t4),
                           __shfl_sync(0xffffffffu, inc[1], 28 + t4)};
  // each of the eight rows is reserved by one lane of the t4 group: lane g
  // takes row 8 (g >> 1) + 2 t4 + (g & 1) with one atomic; each row's first
  // queue slot then travels back two rows a word (16 bits each)
  const int ri = g >> 1, re = g & 1;
  const uint32_t t =
      ((ri >> 1 ? tot[1] : tot[0]) >> (8 * (2 * (ri & 1) + re))) & 0xFFu;
  int old = 0;
  if (t) old = atomicAdd(&rs.qn[8 * ri + 2 * t4 + re], (int)t);
  const bool need = t && old + (int)t > qcap - kTC;
  const uint32_t pair =
      (uint32_t)old | ((uint32_t)__shfl_down_sync(0xffffffffu, old, 4) << 16);
  uint32_t base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    base[i] = __shfl_sync(0xffffffffu, pair, 8 * i + t4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sh = 8 * (2 * (i & 1) + e);
      int pos = (int)((base[i] >> (16 * e)) & 0xFFFFu) +
                (int)(((inc[i >> 1] - cnt[i >> 1]) >> sh) & 0xFFu);
      uint32_t* q = rs.queue + (size_t)(8 * i + 2 * t4 + e) * qcap;
      if (take[i][e][0]) q[pos++] = k[i][e][0];
      if (take[i][e][1]) q[pos] = k[i][e][1];
    }
  return need;
}

// shared-memory bytes of the list side of strip_kernel_wg: the ring's
// stages and their mbarriers, the staged swizzled tile, or nothing
// (register-A)
template <class Src>
__host__ __device__ __forceinline__ size_t list_side_bytes(const Params& p) {
  if (Src::kRing)
    return (size_t)p.ring * ring_stage_bytes(p.dim) +
           (((size_t)p.ring * 8 + 15) & ~(size_t)15);
  return Src::kRegA ? 0 : (size_t)kTC * 128;
}

template <class Src, class Addr, bool kSelect>
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
  // the list side: the staged tile, or the ring's stages and mbarriers
  unsigned char* b_s = a_s + (size_t)n_chunks * kMaxRows * 128;
  RowSel rs;
  rs.queue = reinterpret_cast<uint32_t*>(b_s + list_side_bytes<Src>(p));
  rs.carry = rs.queue + (size_t)kMaxRows * p.qcap;
  rs.qn = reinterpret_cast<int*>(rs.carry + (size_t)kMaxRows * p.carry_w);
  rs.tau = reinterpret_cast<uint32_t*>(rs.qn + kMaxRows);
  uint32_t* sel_all = rs.tau + kMaxRows;
  float* mv_all = reinterpret_cast<float*>(sel_all + (size_t)kWarps *
                                                         p.kf_pad);
  int* me_all = reinterpret_cast<int*>(mv_all + (size_t)kWarps * 2 * kf);
  uint32_t* sel = sel_all + (size_t)warp * p.kf_pad;
  float* mv = mv_all + (size_t)warp * 2 * kf;
  int* me = me_all + (size_t)warp * 2 * kf;
  // the address policy's scratch (page ids, gathered lanes), after the
  // merge buffers
  int* pg_s = reinterpret_cast<int*>(mv_all) +
              (p.n_sub > 1 ? (size_t)kWarps * 4 * kf : 0);

  const int32_t* qid = p.qids ? p.qids + (size_t)s * p.c + r0 : nullptr;
  const __nv_bfloat16* A =
      qid ? p.a : p.a + ((size_t)s * p.c + r0) * p.dim;
  float* out_v = p.out_v + ((size_t)s * p.c + r0) * kf;
  int32_t* out_e = p.out_e + ((size_t)s * p.c + r0) * kf;
  // the strip's rows, all dims, once: rows >= nr and unused slots are zero;
  // a register-A list side contracts over its own order of the dims
  // (Src::a_dim)
  for (int i = tid; i < kMaxRows * n_chunks * 8; i += kThreads) {
    const int c = i & 7, kc = (i >> 3) % n_chunks, r = (i >> 3) / n_chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int row = r < nr ? a_row(qid, r) : -1;
    if (row >= 0) {
      const __nv_bfloat16* ar = A + (size_t)row * p.dim;
      if constexpr (Src::kRegA) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = ar[Src::a_dim(p, kc * kDKC + c * 8 + e)];
        v = *reinterpret_cast<const uint4*>(o);
      } else {
        v = *reinterpret_cast<const uint4*>(ar + kc * kDKC + c * 8);
      }
    }
    *reinterpret_cast<uint4*>(a_s + (size_t)kc * kMaxRows * 128 + swz(r, c)) =
        v;
  }
  // the rows are read by the tensor cores (after the next barrier)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t a_addr = smem_u32(a_s);
  const uint32_t b_addr = smem_u32(b_s) + wg * 64 * 128;
  float sink = INFINITY;  // product-only: keeps the scores live
  uint64_t* full = reinterpret_cast<uint64_t*>(
      b_s + (size_t)p.ring * ring_stage_bytes(p.dim));  // ring: a stage each
  uint32_t ring_seq = 0;  // ring: tiles loaded so far (a stage's uses)
  if constexpr (Src::kRing) {
    if (tid == 0) {
      for (int i = 0; i < p.ring; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  Addr ad;
  for (int j = 0; j < p.n_sub; ++j) {
    __syncthreads();  // the previous sub-block's tile, rows and pages are read
    ad.init(p, lst, j, pg_s, tid);
    if (Addr::kPerRow) __syncthreads();  // the page ids or lanes are staged
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
        rs.tau[i] = kNoKey;
      }
    }
    // packed lists: the sub-block's bias and scale rows, hoisted
    const float* bias_l = Addr::kPerRow ? nullptr : p.bias + ad.row(0);
    const float* scale_l =
        (Addr::kPerRow || !Src::kScaled) ? nullptr : p.scale + ad.row(0);
    // the bias (and scale) of this thread's columns ct + c_lo + 8h
    auto scalars = [&](int ct, float (&bv)[2], float (&sv)[2],
                       bool (&live)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ct + c_lo + 8 * h;
        sv[h] = 1.f;
        live[h] = true;
        if constexpr (Addr::kPerRow) {
          live[h] = ad.has(col);
          bv[h] = live[h] ? p.bias[ad.row(col)] : INFINITY;
          if (Src::kScaled && live[h]) sv[h] = p.scale[ad.row(col)];
        } else {
          bv[h] = bias_l[col];
          if (Src::kScaled) sv[h] = scale_l[col];
        }
      }
    };
    // the packed keys of the column tile at ct: d[4i + 2h + e] is column ct
    // + c_lo + 8h, row 8i + 2*t4 + e; alpha * s (* scale) + bias in the JAX
    // order, with explicit roundings (no FMA contraction); all 32 rows'
    // without a branch (rows past the strip's real rows are never offered);
    // a keyed column's key carries its lane
    auto tile_keys = [&](int ct, const float (&d)[16], const float (&bv)[2],
                         const float (&sv)[2], const bool (&live)[2],
                         uint32_t (&k)[4][2][2]) {
      const int cols[2] = {ct + c_lo, ct + c_lo + 8};
      const bool keyed[2] = {ad.keyed(p, cols[0]), ad.keyed(p, cols[1])};
      const int lanes[2] = {ad.col(cols[0]), ad.col(cols[1])};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = __fmul_rn(p.alpha, d[4 * i + 2 * h + e]);
            if (Src::kScaled) x = __fmul_rn(x, sv[h]);
            x = __fadd_rn(x, bv[h]);
            if (!live[h]) x = INFINITY;
            if (!kSelect) sink = fminf(sink, x);
            k[i][e][h] = keyed[h] ? pack_key(x, lanes[h]) : kNoKey;
          }
    };
    // epilogue of the column tile at ct: its keys offered at once, then the
    // fold (after a barrier: every offer of the tile is in)
    auto tile_end = [&](int ct, const float (&d)[16], const float (&bv)[2],
                        const float (&sv)[2], const bool (&live)[2]) {
      const int cols[2] = {ct + c_lo, ct + c_lo + 8};
      uint32_t k[4][2][2];
      tile_keys(ct, d, bv, sv, live, k);
      if (kSelect)
        offer_tile_t(rs, nr, k, cols, p.qcap, p.carry_w, tour, g, t4);
      const bool last = ct + kTC >= ad.cols;
      if (kSelect && (last || !tour)) {
        __syncthreads();
        fold_rows<kWarps>(rs, p, last, nr, warp, lane, sel, mv, me, out_v,
                          out_e, j);
      }
      return last;
    };
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.f;
    if constexpr (Src::kRing) {
      // K3 on byte pools: the sub-block's column tiles arrive whole, by
      // bulk copy, into a ring of p.ring stages (the page rows of a tile and
      // their bias, a copy a page); one thread issues them from the staged
      // page ids and a stage's mbarrier reports their bytes. Each thread
      // builds its A fragments in registers from its two columns' bytes in
      // the stage (Src::frag), so the product has no shared tile and no
      // barrier. The one barrier a tile (its offers are in, its stage is
      // free) also tells whether a row needs a fold; only then is the second
      // taken. Stale bytes past the chain in a stage score +inf (their +inf
      // bias).
      const uint8_t* pages = static_cast<const uint8_t*>(p.b);
      const int n_tiles = ad.cols / kTC;
      const size_t stage_b = ring_stage_bytes(p.dim);
      const int seg = min(p.page_rows, kTC);  // rows a copy
      auto issue = [&](int t) {
        const uint32_t sq = ring_seq + t;
        uint64_t* bar = &full[sq % p.ring];
        unsigned char* dst = b_s + (sq % p.ring) * stage_b;
        float* dbias = reinterpret_cast<float*>(dst + (size_t)kTC * p.dim);
        const int n_seg = (min(t * kTC + kTC, ad.live) - t * kTC) / seg;
        mbar_expect_tx(bar, (uint32_t)(n_seg * seg * (p.dim + 4)));
        for (int i = 0; i < n_seg; ++i) {
          const int c = t * kTC + i * seg;
          const size_t row = (size_t)ad.pg[c / p.page_rows] * p.page_rows +
                             c % p.page_rows;
          bulk_g2s(dst + (size_t)i * seg * p.dim, pages + row * p.dim,
                   (uint32_t)(seg * p.dim), bar);
          bulk_g2s(dbias + i * seg, p.bias + row, (uint32_t)(seg * 4), bar);
        }
      };
      if (tid == 0)
        for (int t = 0; t < n_tiles && t < p.ring; ++t) issue(t);
      __syncthreads();  // the rows' selection state is set before any offer
      // a row of an even number of chunks spans all banks: the odd lanes
      // read the chunks of a pair in the other order (no bank conflict)
      const int sw = n_chunks % 2 == 0 ? (g & 1) : 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int ct = t * kTC;
        const uint32_t sq = ring_seq + t;
        const unsigned char* stage = b_s + (sq % p.ring) * stage_b;
        mbar_wait(&full[sq % p.ring], (sq / p.ring) & 1);
        const unsigned char* col0 = stage + (size_t)c_lo * p.dim + 16 * t4;
        const unsigned char* col1 = col0 + (size_t)8 * p.dim;
        for (int kc = 0; kc < n_chunks; kc += 2) {
          const bool pair = kc + 1 < n_chunks;
          uint4 v[2][2];
          v[0][0] = *reinterpret_cast<const uint4*>(col0 + (kc + sw) * kDKC);
          v[1][0] = *reinterpret_cast<const uint4*>(col1 + (kc + sw) * kDKC);
          v[0][1] = v[0][0];
          v[1][1] = v[1][0];
          if (pair) {
            v[0][1] = *reinterpret_cast<const uint4*>(col0 +
                                                      (kc + (sw ^ 1)) * kDKC);
            v[1][1] = *reinterpret_cast<const uint4*>(col1 +
                                                      (kc + (sw ^ 1)) * kDKC);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q == 1 && !pair) break;
            const bool other = (q ^ sw) != 0;
            uint32_t a[4][4];
            Src::frag(pick(other, v[0][1], v[0][0]),
                      pick(other, v[1][1], v[1][0]), a);
            wgmma_chunk_rs(d, a, a_addr + (kc + q) * kMaxRows * 128,
                           kc + q == 0);
          }
        }
        const float* bias_s =
            reinterpret_cast<const float*>(stage + (size_t)kTC * p.dim);
        // a column past the chain takes a +inf bias, which scores it +inf
        // (+inf or NaN whatever the product; pack_key sends NaN to the top)
        const int cols[2] = {ct + c_lo, ct + c_lo + 8};
        float bv[2];
        const float sv[2] = {1.f, 1.f};
        const bool live[2] = {true, true};
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bv[h] = cols[h] < ad.live ? bias_s[c_lo + 8 * h] : INFINITY;
        uint32_t k[4][2][2];
        tile_keys(ct, d, bv, sv, live, k);
        bool my_need = false;
        if (kSelect)
          my_need = offer_tile_t(rs, nr, k, cols, p.qcap, p.carry_w, false,
                                 g, t4);
        const bool last = t + 1 == n_tiles;
        // every offer of the tile is in and no thread reads its stage
        const bool need = __syncthreads_or(kSelect && (last || my_need));
        if (tid == 0 && t + p.ring < n_tiles) issue(t + p.ring);
        if (need) {
          fold_rows<kWarps>(rs, p, last, nr, warp, lane, sel, mv, me, out_v,
                            out_e, j, true);
          if (!last) __syncthreads();  // the next offers read the folds
        }
      }
      ring_seq += n_tiles;
    } else if constexpr (Src::kRegA) {
      // the list tile from registers: each thread builds its A fragments
      // (its two columns) from the code bytes it reads, one chunk ahead;
      // no shared tile, no barrier in the product loop
      __syncthreads();  // the rows' selection state is set before any offer
      uint2 nxt[2];
      Src::chunk(p, ad, c_lo, 0, nxt);
      for (int ct = 0; ct < ad.cols; ct += kTC) {
        float bv[2], sv[2];
        bool live[2];
        scalars(ct, bv, sv, live);  // in flight during the product
        for (int kc = 0; kc < n_chunks; ++kc) {
          const uint2 cur[2] = {nxt[0], nxt[1]};
          const int nkc = kc + 1 < n_chunks ? kc + 1 : 0;
          const int nct = kc + 1 < n_chunks ? ct : ct + kTC;
          if (nct < ad.cols) Src::chunk(p, ad, nct + c_lo, nkc, nxt);
          uint32_t a[4][4];
#pragma unroll
          for (int ks = 0; ks < kDKC / 16; ++ks)
            Src::frag(cur, ks, t4, a[ks]);
          wgmma_chunk_rs(d, a, a_addr + kc * kMaxRows * 128, kc == 0);
        }
        // the fold's queue and thresholds are read again by the next
        // tile's offers
        if (!tile_end(ct, d, bv, sv, live) && kSelect && !tour)
          __syncthreads();
      }
    } else {
      const int n_steps = (ad.cols / kTC) * n_chunks;
      typename Src::Vec pre;
      pre.load(p, ad, 0, 0, tid);
      for (int step = 0; step < n_steps; ++step) {
        const int ct = (step / n_chunks) * kTC;
        const int kc = step % n_chunks;
        __syncthreads();  // the previous product and fold are done with b_s
        pre.store_swz(p, b_s, kc * kDKC, tid);
        // the tile and the rows are read by the tensor cores
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (step + 1 < n_steps)
          pre.load(p, ad, ((step + 1) / n_chunks) * kTC,
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
        float bv[2], sv[2];
        bool live[2];
        scalars(ct, bv, sv, live);
        tile_end(ct, d, bv, sv, live);
      }
    }
  }
  if (!kSelect && sink == -1.0f) out_v[0] = sink;  // never: a data dependence
}

// dynamic shared memory of strip_kernel_wg (with the base's alignment)
template <class Src>
size_t wg_smem_bytes(const Params& p) {
  size_t b = 1024 + (size_t)(p.dim / kDKC) * kMaxRows * 128 +
             list_side_bytes<Src>(p) +
             (size_t)kMaxRows * (p.qcap + p.carry_w) * 4 +
             (size_t)kMaxRows * 2 * 4 + (size_t)kWarps * p.kf_pad * 4;
  if (p.n_sub > 1) b += (size_t)kWarps * 2 * p.kf * 8;
  return b + addr_bytes(p);  // the address policy's scratch
}

// Whether strip_kernel_wg takes a shape plan_launch planned for the list
// side Src: 32 rows a block (the plan did not shrink them), whole 64-dim
// chunks (packed: nb a multiple of 8 bytes), a 16-byte aligned query block
// and a list block aligned for Src's loads. Returns its shared memory, or 0
// (the shape then keeps strip_kernel).
template <class Src>
size_t plan_wg(const Params& p) {
  if (p.rows != kMaxRows || p.dim % kDKC != 0 ||
      reinterpret_cast<uintptr_t>(p.b) % Src::kAlign != 0 ||
      reinterpret_cast<uintptr_t>(p.a) % 16 != 0)
    return 0;
  const size_t smem = wg_smem_bytes<Src>(p);
  return smem <= kSmemLimit ? smem : 0;
}

template <class Src, class Addr, bool kSelect>
cudaError_t launch_wg(const Params& p, int s_pad, size_t smem,
                      cudaStream_t st) {
  g_loop = Src::kRing ? kLoopRing : kLoopWgmma;
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel_wg<Src, Addr, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strip_kernel_wg<Src, Addr, kSelect>
      <<<(unsigned)s_pad * p.groups, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
