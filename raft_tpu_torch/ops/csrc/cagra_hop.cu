// K6 — one fused CAGRA best-first hop, its parent pickup included, written
// for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/cagra_hop.py:_hop_kernel (launched by fused_hop,
// pl.pallas_call) and the parent pickup the JAX package runs around it in
// the loop body of raft_tpu/neighbors/cagra.py:_fused_hop_chunk. For every
// query row it takes the candidate buffer (itopk ids, packed distances,
// visited flags) and the query in code units qp (p fp32) and does one hop:
//
//   0. the parents: the picking entry (raft_cagra_pick_hop) takes the w
//      best unvisited valid slots by the packed select of
//      select_k.iter_topk_min_packed over the itopk columns (pkey = +inf
//      where vis > 0 or id < 0; parent -1 where the picked value is +-inf)
//      and marks them visited; raft_cagra_hop takes them as an operand;
//   1. gather the w parent graph rows (deg int32 each) and their inlined
//      (deg, p) int8 code records;
//   2. score each of the b = w * deg candidates in code units,
//        cd = nrm - 2 * ip,  ip = sum bf16(c) * bf16(qp),  nrm = sum c * c,
//      ip in fp32, nrm exact (an integer below 2**24 for p <= 512);
//   3. mask as +inf every candidate whose id is -1 (a -1 edge or an invalid
//      parent), that matches a buffer id, or that matches an earlier
//      candidate;
//   4. keep the itopk smallest of [buffer | candidates] by the mantissa-packed
//      select: the column rides the low pack_bits = ceil(log2(itopk + b))
//      mantissa bits, keys are ordered as integers (exact on the denormals
//      that scores near zero pack to), values at the packing clamp come back
//      as +-inf;
//   5. write ids (-1 where the value is +inf), the packed values with their
//      column bits cleared, and vis (the buffer's flag, 0 for a candidate).
//
// What bounds it on the H100: bytes. A hop reads q * w * deg * (4 + p) bytes
// of graph rows and code records (parents are data-dependent rows anywhere
// in a multi-GB array), plus the buffer read and written and qp: at 10,000
// queries, itopk 64, w 4, deg 64, p 64 that is 0.9178 ms for a 16-hop
// search at 3.35 TB/s. The arithmetic is 2 * p multiply-adds a candidate.
//
// What the design does about it. One warp serves one query and a block
// holds up to 4 queries; nothing on the hop's path synchronises more than
// one warp (only __syncwarp, votes and shuffles), so a warp that waits on
// its gathers never holds up another query. The warp picks its own
// parents: the TPU kernel needed parent ids as scalar-prefetch operands of
// its DMA engine, so the JAX package picked them outside with a packed
// select; a CUDA warp reads its buffer row and loads its own rows, which
// takes a sort, a gather, a where and a scatter (about 8 launches) off
// every hop. A parent's deg * p bytes of records are contiguous: L lanes
// share a candidate (L = p / 16 rounded up to a power of two), each loads
// one 16-byte chunk, four candidates a lane in flight, the int8 codes
// become floats by byte permutes (full rate, where I2F is quarter rate),
// and the partial sums meet by shuffles. The exact dedup is a per-warp
// open-addressing table in shared memory, 32 positions a round, buffer
// positions first: atomicCAS claims an id's slot and the claimer writes
// its position beside it; a lane that finds its id claimed is a duplicate
// when the claimer's position is earlier and otherwise lowers it
// (atomicMin), so after the round only the least position of each id
// stays. Only candidates below the buffer's largest key can land below
// itopk: a ballot compacts them, a bitonic sort in registers across the
// warp (by shuffles, at the least of 1 .. K keys a lane that holds them)
// orders them, and every key is placed by rank: its index in its own
// sorted list plus the count of smaller keys in the other list (binary
// search; keys are unique, so the ranks are exact). The buffer's keys are
// already ascending whenever the buffer came from a hop or the seed
// merge; a warp checks, and sorts them the same way when they are not.
// Every code-record and graph-row address is computed in 64 bits: at
// 1M x 64 x 64 the records span 4.2 GB.
//
// Measured (chip_smoke.py --k6-variants, copies of this file with one
// change each, on an H100 at itopk 64, w 4): the gathers are not what
// limits it. Taking the code loads out saves 4% of the kernel's time, the
// scoring arithmetic 6%, the dedup 28% (its shared-memory atomics: more
// entries a lane a round is slower, not faster); the rest is each warp's
// chain of buffer, pickup, table, sort and merge steps over ~2.4 waves of
// 32 warps a SM (64 registers; 8 blocks of 4 warps).
//
// Built without --use_fast_math and without -ftz: packed scores near zero
// are denormals and must survive as they are.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;   // queries a block
constexpr int kMaxMerge = 2048;     // itopk + w * deg
constexpr int kMaxVecP = 512;       // 16-byte loop: at most 32 chunks a code
constexpr int kUnroll = 4;          // candidates a lane has in flight
constexpr size_t kSmemLimit = 227 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// unsigned key whose integer order is the float order of the packed value
__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

// select_k.pack_values for one value: NaN -> +inf, clamp to +-clamp, column
// into the low bits; returned as its order key
__device__ __forceinline__ uint32_t pack_key(float v, uint32_t col,
                                             uint32_t mask, float clamp) {
  if (isnan(v)) v = INFINITY;
  v = fminf(fmaxf(v, -clamp), clamp);
  return order_key((__float_as_uint(v) & ~mask) | col);
}

// the value of a packed key, its column bits cleared, +-inf at the clamp
__device__ __forceinline__ float key_value(uint32_t key, uint32_t mask,
                                           float clamp) {
  float v = __uint_as_float(key_bits(key) & ~mask);
  if (v >= clamp) v = INFINITY;
  if (v <= -clamp) v = -INFINITY;
  return v;
}

__device__ __forceinline__ float clamp_for(int bits) {
  return __uint_as_float((0x7F7FFFFFu >> bits) << bits);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ascending bitonic sort of the warp's 32 * K keys, blocked: lane l holds
// keys l*K .. l*K + K-1. Strides below K stay in a lane's registers, the
// others cross lanes by shuffles.
template <int K>
__device__ __forceinline__ void warp_sort(uint32_t (&k)[K], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * K; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= K) {
        const int ls = stride / K;
        const bool lower = (lane & ls) == 0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const bool up = ((lane * K + r) & size) == 0;
          const uint32_t o = __shfl_xor_sync(kFull, k[r], ls);
          k[r] = (lower == up) ? min(k[r], o) : max(k[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & stride) == 0) {
            const bool up = ((lane * K + r) & size) == 0;
            const uint32_t a = k[r], c = k[r + stride];
            const bool swap = up ? (a > c) : (a < c);
            k[r] = swap ? c : a;
            k[r + stride] = swap ? a : c;
          }
        }
      }
    }
  }
}

// how many of the n ascending keys a[] are below x
__device__ __forceinline__ int count_below(const uint32_t* a, int n,
                                           uint32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the dedup table's first slot for an id (linear probing from there)
__device__ __forceinline__ uint32_t home_slot(int32_t id, int shift) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> shift;
}

// byte s of a word whose int8 bytes were biased by ^ 0x80, as a float:
// 2**23 + (c + 128) by a byte permute, less 2**23 + 128 (exact)
__device__ __forceinline__ float biased_byte(uint32_t biased, int s) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | s))
         - 8388736.0f;
}

struct HopParams {
  const int32_t* buf_ids;   // (q, itopk)
  const float* buf_d;       // (q, itopk)
  const float* buf_vis;     // (q, itopk)
  const int32_t* parents;   // (q, w); null: the warp picks them
  const float* qp;          // (q, p)
  const int32_t* graph;     // (n, deg)
  const int8_t* codes;      // (n, deg, p)
  int32_t* out_ids;
  float* out_d;
  float* out_vis;
  int q, itopk, w, deg, p, b;
  int pack_bits;            // the merge's, ceil(log2(itopk + b))
  int pick_bits;            // the pickup's, ceil(log2(itopk))
  int table_log;            // log2 of the dedup table's slots
  int lanes;                // lanes a candidate (16-byte loop); 0: scalar
  int warp_bytes;           // shared memory a warp
};

// this warp's view of the hop for the merge: the buffer row (keys sorted)
// and the candidates' ids
struct WarpRow {
  const uint32_t* bkey;
  const int32_t* bid;
  const float* bvis;
  const int32_t* cid;
  int64_t brow;
  int itopk;
  uint32_t mask;
  float clamp;
};

// decode one kept key and write its output slot
__device__ __forceinline__ void emit_slot(const HopParams& P, const WarpRow& R,
                                          int slot, uint32_t k) {
  const uint32_t col = key_bits(k) & R.mask;
  const float v = key_value(k, R.mask, R.clamp);
  int32_t id;
  float vis;
  if (col < static_cast<uint32_t>(R.itopk)) {
    id = R.bid[col];
    vis = R.bvis[col];
  } else {
    id = R.cid[col - R.itopk];
    vis = 0.f;
  }
  if (v == INFINITY) id = -1;
  P.out_ids[R.brow + slot] = id;
  P.out_d[R.brow + slot] = v;
  P.out_vis[R.brow + slot] = vis;
}

// sort the ns surviving candidate keys of cs[] in registers (32 * KS >= ns)
// and merge them with the sorted buffer keys by rank: a key's output slot
// is its index in its own list plus the count of smaller keys in the
// other; slots below itopk are written, each by exactly one lane
template <int KS>
__device__ void sort_merge(const HopParams& P, const WarpRow& R, uint32_t* cs,
                           int ns, int lane) {
  uint32_t key[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int j = lane * KS + r;
    key[r] = j < ns ? cs[j] : kFull;
  }
  warp_sort<KS>(key, lane);
  const int nc = min(ns, R.itopk);   // candidates that can land below itopk
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int j = lane * KS + r;
    if (j < nc) cs[j] = key[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int j = lane * KS + r;
    if (j < nc) {
      const int slot = j + count_below(R.bkey, R.itopk, key[r]);
      if (slot < R.itopk) emit_slot(P, R, slot, key[r]);
    }
  }
  for (int e = lane; e < R.itopk; e += 32) {
    const uint32_t k = R.bkey[e];
    const int slot = e + count_below(cs, nc, k);
    if (slot < R.itopk) emit_slot(P, R, slot, k);
  }
}

// sort_merge at the least register width that holds ns keys, up to K
template <int KS, int K>
__device__ void sort_merge_fit(const HopParams& P, const WarpRow& R,
                               uint32_t* cs, int ns, int lane) {
  if constexpr (KS < K) {
    if (ns > 32 * KS) {
      sort_merge_fit<KS * 2, K>(P, R, cs, ns, lane);
      return;
    }
  }
  sort_merge<KS>(P, R, cs, ns, lane);
}

// 32 warps a SM (64 registers) up to 8 keys a lane; wider sorts take the
// registers they need
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, K <= 8 ? 8 : 1)
cagra_hop_kernel(const HopParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + wi;
  if (qi >= P.q) return;
  const int itopk = P.itopk, w = P.w, deg = P.deg, p = P.p, b = P.b;
  const int T = 1 << P.table_log;
  const uint32_t tmask = static_cast<uint32_t>(T - 1);
  const int shift = 32 - P.table_log;

  // this warp's shared memory: the dedup table (ids, then least
  // positions) first; the pickup keys and then the surviving candidates'
  // keys reuse its space
  unsigned char* base = smem + static_cast<size_t>(wi) * P.warp_bytes;
  uint32_t* tab = reinterpret_cast<uint32_t*>(base);
  uint32_t* scratch = tab;
  uint32_t* bkey = tab + 2 * T;
  int32_t* bid = reinterpret_cast<int32_t*>(bkey + itopk);
  float* bvis = reinterpret_cast<float*>(bid + itopk);
  int32_t* cid = reinterpret_cast<int32_t*>(bvis + itopk);
  float* cval = reinterpret_cast<float*>(cid + b);
  int32_t* par = reinterpret_cast<int32_t*>(cval + b);

  const uint32_t mask = (1u << P.pack_bits) - 1u;
  const float clamp = clamp_for(P.pack_bits);
  const bool pick = P.parents == nullptr;
  const uint32_t pmask = (1u << P.pick_bits) - 1u;
  const float pclamp = clamp_for(P.pick_bits);

  // 1. the buffer row and its merge keys; the pickup's keys
  const int64_t brow = qi * itopk;
  for (int e = lane; e < itopk; e += 32) {
    const int32_t id = P.buf_ids[brow + e];
    const float d = P.buf_d[brow + e];
    const float vis = P.buf_vis[brow + e];
    bid[e] = id;
    bvis[e] = vis;
    bkey[e] = pack_key(d, e, mask, clamp);
    if (pick)
      scratch[e] = pack_key((vis > 0.f || id < 0) ? INFINITY : d, e, pmask,
                            pclamp);
  }
  __syncwarp();

  // 2. the parents. Picking: w rounds of a warp-wide minimum; a lane reads
  // and retires only its own slots (e = lane mod 32), so rounds need no
  // barrier. The keys are unique: the column rides in them.
  if (pick) {
    for (int r = 0; r < w; ++r) {
      uint32_t best = kFull;
      for (int e = lane; e < itopk; e += 32) best = min(best, scratch[e]);
      best = __reduce_min_sync(kFull, best);
      const uint32_t col = key_bits(best) & pmask;
      if (static_cast<int>(col & 31u) == lane) {
        scratch[col] = kFull;
        bvis[col] = 1.f;
      }
      if (lane == 0) par[r] = isinf(key_value(best, pmask, pclamp)) ? -1
                                                                     : bid[col];
    }
  } else {
    for (int r = lane; r < w; r += 32) par[r] = P.parents[qi * w + r];
  }

  // the buffer's keys ascending (they already are after a hop or the seed
  // merge; a buffer from elsewhere is sorted here)
  bool ascending = true;
  for (int e = lane; e + 1 < itopk; e += 32)
    ascending &= bkey[e] < bkey[e + 1];
  if (!__all_sync(kFull, ascending)) {
    uint32_t k[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int e = lane * K + r;
      k[r] = e < itopk ? bkey[e] : kFull;
    }
    warp_sort<K>(k, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int e = lane * K + r;
      if (e < itopk) bkey[e] = k[r];
    }
  }
  __syncwarp();

  // 3. gather and score, a parent at a time: cid (-1 for a -1 edge or
  // parent) and cval
  if (P.lanes) {
    // L lanes a candidate, one 16-byte chunk each; G candidates a step
    const int L = P.lanes, G = 32 / L;
    const int g = lane & (L - 1), cg = lane / L;
    const bool act = g < (p >> 4);
    float qv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      qv[u] = act ? bf16_round(P.qp[qi * p + g * 16 + u]) : 0.f;
    for (int r = 0; r < w; ++r) {
      const int pid = par[r];
      int32_t* cid_r = cid + r * deg;
      float* cval_r = cval + r * deg;
      if (pid < 0) {
        for (int j = lane; j < deg; j += 32) cid_r[j] = -1;
        continue;
      }
      const int64_t row0 = static_cast<int64_t>(pid) * deg;
      const int4* rec = reinterpret_cast<const int4*>(P.codes + row0 * p);
      const int32_t* grow = P.graph + row0;
      for (int j0 = 0; j0 < deg; j0 += G * kUnroll) {
        int4 raw[kUnroll];
        int32_t gid[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * G + cg;
          raw[u] = make_int4(0, 0, 0, 0);
          gid[u] = -1;
          if (j < deg) {
            if (act) raw[u] = __ldg(rec + j * (p >> 4) + g);
            if (g == 0) gid[u] = __ldg(grow + j);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t word[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
          float ip = 0.f;
          int nrm = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            nrm = __dp4a(word[t], word[t], nrm);
            const uint32_t biased = static_cast<uint32_t>(word[t]) ^ 0x80808080u;
#pragma unroll
            for (int s = 0; s < 4; ++s)
              ip += biased_byte(biased, s) * qv[4 * t + s];
          }
          for (int o = 1; o < L; o <<= 1) {
            ip += __shfl_xor_sync(kFull, ip, o);
            nrm += __shfl_xor_sync(kFull, nrm, o);
          }
          const int j = j0 + u * G + cg;
          if (g == 0 && j < deg) {
            cid_r[j] = gid[u] >= 0 ? gid[u] : -1;
            cval_r[j] = static_cast<float>(nrm) - 2.0f * ip;
          }
        }
      }
    }
  } else {
    // any p, any alignment: the warp walks one candidate's record at a time
    for (int c = 0; c < b; ++c) {
      const int r = c / deg;
      const int pid = par[r];
      float ip = 0.f;
      int nrm = 0;
      int32_t gid = -1;
      if (pid >= 0) {
        const int64_t row = static_cast<int64_t>(pid) * deg + (c - r * deg);
        const int8_t* cr = P.codes + row * p;
        for (int k = lane; k < p; k += 32) {
          const int cv = cr[k];
          ip += static_cast<float>(cv) * bf16_round(P.qp[qi * p + k]);
          nrm += cv * cv;
        }
        if (lane == 0) gid = P.graph[row];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ip += __shfl_xor_sync(kFull, ip, o);
        nrm += __shfl_xor_sync(kFull, nrm, o);
      }
      if (lane == 0) {
        cid[c] = (pid >= 0 && gid >= 0) ? gid : -1;
        cval[c] = static_cast<float>(nrm) - 2.0f * ip;
      }
    }
  }
  __syncwarp();

  // 4. the exact dedup, 32 positions a round, the buffer's first. A lane
  // claims its id's slot (atomicCAS) and writes its position beside it;
  // a lane that finds its id claimed is a duplicate if the claimer's
  // position is earlier, and otherwise (a later lane of the same round)
  // lowers that position to its own (atomicMin). After the round, every
  // position but the least of its id is a duplicate.
  uint32_t* tpos = tab + T;
  for (int h = lane; h < T; h += 32) tab[h] = kFull;
  __syncwarp();
  for (int e0 = 0; e0 < itopk + b; e0 += 32) {
    const int e = e0 + lane;
    int32_t id = -1;
    if (e < itopk) id = bid[e];
    else if (e < itopk + b) id = cid[e - itopk];
    uint32_t h = 0;
    bool claimed = false;
    if (id >= 0) {
      h = home_slot(id, shift);
      while (true) {
        const uint32_t old = atomicCAS(&tab[h], kFull,
                                       static_cast<uint32_t>(id));
        if (old == kFull) { claimed = true; break; }
        if (old == static_cast<uint32_t>(id)) break;
        h = (h + 1) & tmask;
      }
      if (claimed) tpos[h] = e;
    }
    __syncwarp();
    bool dup = false;
    if (id >= 0 && !claimed) {
      if (tpos[h] < static_cast<uint32_t>(e)) dup = true;
      else atomicMin(&tpos[h], static_cast<uint32_t>(e));
    }
    __syncwarp();
    if (id >= 0 && !dup) dup = tpos[h] != static_cast<uint32_t>(e);
    if (e >= itopk && dup) cid[e - itopk] = -1;
  }
  __syncwarp();

  // 5. the candidates' packed keys; only those below the buffer's largest
  // key can land below itopk: they survive, compacted into the table's
  // space by ballots
  const uint32_t thr = bkey[itopk - 1];
  uint32_t* cs = scratch;
  int ns = 0;
  for (int c0 = 0; c0 < b; c0 += 32) {
    const int c = c0 + lane;
    uint32_t k = kFull;
    if (c < b)
      k = pack_key(cid[c] >= 0 ? cval[c] : INFINITY, itopk + c, mask, clamp);
    const bool keep = k < thr;
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep) cs[ns + __popc(kept & ((1u << lane) - 1u))] = k;
    ns += __popc(kept);
  }
  __syncwarp();

  // 6. the survivors sorted in registers and merged with the buffer by rank
  const WarpRow R{bkey, bid, bvis, cid, brow, itopk, mask, clamp};
  sort_merge_fit<1, K>(P, R, cs, ns, lane);
}

template <int K>
int launch(const HopParams& P, cudaStream_t stream) {
  // queries a block: 4, fewer where 4 warps' tables would not fit
  const size_t fit = kSmemLimit / static_cast<size_t>(P.warp_bytes);
  const int wpb = fit < kWarpsPerBlock ? static_cast<int>(fit)
                                       : kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(wpb) * P.warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cagra_hop_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (P.q + wpb - 1) / wpb;
  cagra_hop_kernel<K><<<blocks, wpb * 32, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

int ceil_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// fill the shape-derived fields and launch; cudaErrorInvalidValue for a
// shape the kernel does not take
int hop_launch(HopParams P, long long n, void* stream) {
  if (P.q <= 0) return (int)cudaSuccess;
  if (P.itopk <= 0 || P.w <= 0 || P.deg <= 0 || P.p <= 0 || n <= 0 ||
      n > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  P.b = P.w * P.deg;
  const int m = P.itopk + P.b;
  if (m > kMaxMerge || (1 << P.pack_bits) < m || P.pack_bits > 22)
    return (int)cudaErrorInvalidValue;
  if (P.parents == nullptr &&
      (P.w > P.itopk || (1 << P.pick_bits) < P.itopk || P.pick_bits > 22))
    return (int)cudaErrorInvalidValue;
  P.table_log = ceil_log2(m + m / 2 > 32 ? m + m / 2 : 32);
  const bool vec = P.p % 16 == 0 && P.p <= kMaxVecP &&
                   reinterpret_cast<uintptr_t>(P.codes) % 16 == 0;
  P.lanes = vec ? (1 << ceil_log2(P.p / 16)) : 0;
  const size_t bytes = (static_cast<size_t>(8) << P.table_log) +
                       static_cast<size_t>(P.itopk) * 12 +
                       static_cast<size_t>(P.b) * 8 +
                       static_cast<size_t>(P.w) * 4;
  P.warp_bytes = static_cast<int>((bytes + 15) / 16 * 16);
  const int keys = P.b > P.itopk ? P.b : P.itopk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys <= 32) return launch<1>(P, s);
  if (keys <= 64) return launch<2>(P, s);
  if (keys <= 128) return launch<4>(P, s);
  if (keys <= 256) return launch<8>(P, s);
  if (keys <= 512) return launch<16>(P, s);
  if (keys <= 1024) return launch<32>(P, s);
  return launch<64>(P, s);
}

}  // namespace

// Launch K6 with the parents given, for q queries on `stream`. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// kernel does not take: a merge wider than 2048 rows or too few pack
// bits). Allocates nothing. Parent ids must be -1 or in [0, n).
extern "C" int raft_cagra_hop(const void* buf_ids, const void* buf_d,
                              const void* buf_vis, const void* parents,
                              const void* qp, const void* graph,
                              const void* codes, void* out_ids, void* out_d,
                              void* out_vis, int q, int itopk, int w,
                              long long n, int deg, int p, int pack_bits,
                              void* stream) {
  if (parents == nullptr) return (int)cudaErrorInvalidValue;
  HopParams P{};
  P.buf_ids = static_cast<const int32_t*>(buf_ids);
  P.buf_d = static_cast<const float*>(buf_d);
  P.buf_vis = static_cast<const float*>(buf_vis);
  P.parents = static_cast<const int32_t*>(parents);
  P.qp = static_cast<const float*>(qp);
  P.graph = static_cast<const int32_t*>(graph);
  P.codes = static_cast<const int8_t*>(codes);
  P.out_ids = static_cast<int32_t*>(out_ids);
  P.out_d = static_cast<float*>(out_d);
  P.out_vis = static_cast<float*>(out_vis);
  P.q = q;
  P.itopk = itopk;
  P.w = w;
  P.deg = deg;
  P.p = p;
  P.pack_bits = pack_bits;
  return hop_launch(P, n, stream);
}

// Launch K6 in its picking mode: each query's w parents are picked from its
// buffer (w <= itopk, pick_bits = ceil(log2(itopk))) and marked visited in
// out_vis, then the hop runs as raft_cagra_hop's. Same returns.
extern "C" int raft_cagra_pick_hop(const void* buf_ids, const void* buf_d,
                                   const void* buf_vis, const void* qp,
                                   const void* graph, const void* codes,
                                   void* out_ids, void* out_d, void* out_vis,
                                   int q, int itopk, int w, long long n,
                                   int deg, int p, int pack_bits,
                                   int pick_bits, void* stream) {
  HopParams P{};
  P.buf_ids = static_cast<const int32_t*>(buf_ids);
  P.buf_d = static_cast<const float*>(buf_d);
  P.buf_vis = static_cast<const float*>(buf_vis);
  P.parents = nullptr;
  P.qp = static_cast<const float*>(qp);
  P.graph = static_cast<const int32_t*>(graph);
  P.codes = static_cast<const int8_t*>(codes);
  P.out_ids = static_cast<int32_t*>(out_ids);
  P.out_d = static_cast<float*>(out_d);
  P.out_vis = static_cast<float*>(out_vis);
  P.q = q;
  P.itopk = itopk;
  P.w = w;
  P.deg = deg;
  P.p = p;
  P.pack_bits = pack_bits;
  P.pick_bits = pick_bits;
  return hop_launch(P, n, stream);
}
