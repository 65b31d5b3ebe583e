// K6 — one fused CAGRA best-first hop, written for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/cagra_hop.py:_hop_kernel (launched by fused_hop,
// pl.pallas_call). For every query row it takes the candidate buffer
// (itopk ids, packed distances, visited flags), the w parents to expand
// (-1 = none), the query in code units qp (p fp32) and does one hop:
//
//   1. gather the w parent graph rows (deg int32 each) and their inlined
//      (deg, p) int8 code records;
//   2. score each of the b = w * deg candidates in code units,
//        cd = nrm - 2 * ip,  ip = sum bf16(c) * bf16(qp),  nrm = sum c * c,
//      both sums in fp32;
//   3. mask as +inf every candidate whose id is -1 (a -1 edge or an invalid
//      parent), that matches a buffer id, or that matches an earlier
//      candidate;
//   4. keep the itopk smallest of [buffer | candidates] by the mantissa-packed
//      select of select_k.iter_topk_min_packed: the column rides the low
//      pack_bits = ceil(log2(itopk + b)) mantissa bits, keys are ordered as
//      integers (exact on the denormals that scores near zero pack to), and
//      values at the packing clamp come back as +-inf;
//   5. write ids (-1 where the value is +inf), the packed values with their
//      column bits cleared, and vis (the buffer's flag, 0 for a candidate).
//
// What bounds it on the H100: bytes. A hop reads q * w * deg * (4 + p) bytes
// of graph rows and code records (parents are data-dependent rows anywhere
// in a multi-GB array), plus the buffer read and written and qp; the
// arithmetic is 2 * p multiply-adds per candidate, far below the bytes' time.
//
// What the design does about it. One block of 256 threads owns one query:
// it stages qp, its buffer row, the w parent rows and the w code records in
// shared memory (16-byte loads where the records are 16-byte aligned, 32 KB
// at w = 8), so every gathered byte is read from device memory once. Every
// code-record and graph-row address is computed in 64 bits: at 1M x 64 x 64
// the records span 4.2 GB. The exact dedup is a bitonic sort of
// (id, position) keys over buffer and candidates, the buffer first, so the
// first copy of an id keeps its slot and every later copy is masked. The
// selection is a bitonic sort of the <= 2048 packed order keys; the first
// itopk are the result. Nothing is carried over from the Pallas kernel's
// layout: its fp32 one-hot id extraction through the MXU existed because
// Mosaic cannot gather, and a CUDA thread simply reads the slot. Next steps
// (later PRs): several queries per block for short rows, a warp-level
// merge of the already-sorted buffer instead of a full sort.
//
// Built without --use_fast_math and without -ftz: packed scores near zero
// are denormals and must survive as they are.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSort = 2048;
constexpr size_t kSmemLimit = 227 * 1024;

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

// ascending bitonic sort of n (a power of two) keys in shared memory by the
// whole block; the caller has synchronised the block before
template <typename T>
__device__ void bitonic_sort(T* s, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = (t / j) * 2 * j + (t % j);
        const int ixj = i + j;
        const T a = s[i], b = s[ixj];
        const bool up = (i & k) == 0;
        if (up ? (a > b) : (a < b)) {
          s[i] = b;
          s[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

struct HopParams {
  const int32_t* buf_ids;   // (q, itopk)
  const float* buf_d;       // (q, itopk)
  const float* buf_vis;     // (q, itopk)
  const int32_t* parents;   // (q, w)
  const float* qp;          // (q, p)
  const int32_t* graph;     // (n, deg)
  const int8_t* codes;      // (n, deg, p)
  int32_t* out_ids;
  float* out_d;
  float* out_vis;
  int itopk, w, deg, p, b, m, npad, pack_bits, vec;
  size_t code_bytes;        // w * deg * p, padded to 16
};

__global__ void __launch_bounds__(kThreads)
cagra_hop_kernel(const HopParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int itopk = P.itopk, w = P.w, deg = P.deg, p = P.p, b = P.b;
  const int m = P.m, npad = P.npad;

  int8_t* codes_s = reinterpret_cast<int8_t*>(smem);
  uint64_t* dkey = reinterpret_cast<uint64_t*>(smem + P.code_bytes);
  uint32_t* skey = reinterpret_cast<uint32_t*>(dkey);  // after the dedup
  float* qpb = reinterpret_cast<float*>(dkey + npad);
  int32_t* bid = reinterpret_cast<int32_t*>(qpb + p);
  float* bd = reinterpret_cast<float*>(bid + itopk);
  float* bvis = bd + itopk;
  int32_t* cid = reinterpret_cast<int32_t*>(bvis + itopk);
  int32_t* pr = cid + b;

  const int64_t row = static_cast<int64_t>(qi);
  for (int r = tid; r < w; r += blockDim.x) pr[r] = P.parents[row * w + r];
  for (int k = tid; k < p; k += blockDim.x)
    qpb[k] = __bfloat162float(__float2bfloat16(P.qp[row * p + k]));
  for (int e = tid; e < itopk; e += blockDim.x) {
    bid[e] = P.buf_ids[row * itopk + e];
    bd[e] = P.buf_d[row * itopk + e];
    bvis[e] = P.buf_vis[row * itopk + e];
  }
  __syncthreads();

  // 1. gather: graph rows into cid, code records into codes_s
  for (int c = tid; c < b; c += blockDim.x) {
    const int pid = pr[c / deg];
    int32_t g = -1;
    if (pid >= 0) g = P.graph[static_cast<int64_t>(pid) * deg + c % deg];
    cid[c] = (pid >= 0 && g >= 0) ? g : -1;
  }
  const int64_t rec = static_cast<int64_t>(deg) * p;  // bytes per record
  if (P.vec) {
    const int rec16 = static_cast<int>(rec / 16);
    const int4* src = reinterpret_cast<const int4*>(P.codes);
    int4* dst = reinterpret_cast<int4*>(codes_s);
    for (int i = tid; i < w * rec16; i += blockDim.x) {
      const int pid = pr[i / rec16];
      if (pid >= 0) dst[i] = src[static_cast<int64_t>(pid) * rec16 + i % rec16];
    }
  } else {
    for (int64_t i = tid; i < w * rec; i += blockDim.x) {
      const int pid = pr[i / rec];
      if (pid >= 0) codes_s[i] = P.codes[static_cast<int64_t>(pid) * rec + i % rec];
    }
  }
  __syncthreads();

  // 3. dedup keys: (id, position), the buffer at positions 0..itopk-1
  for (int e = tid; e < npad; e += blockDim.x) {
    uint64_t key = ~0ull;
    if (e < m) {
      const int32_t id = e < itopk ? bid[e] : cid[e - itopk];
      key = (static_cast<uint64_t>(static_cast<uint32_t>(id) ^ 0x80000000u)
             << 32) | static_cast<uint32_t>(e);
    }
    dkey[e] = key;
  }
  __syncthreads();
  bitonic_sort(dkey, npad);
  for (int s = tid + 1; s < m; s += blockDim.x) {
    if ((dkey[s] >> 32) == (dkey[s - 1] >> 32)) {
      const uint32_t pos = static_cast<uint32_t>(dkey[s]);
      if (pos >= static_cast<uint32_t>(itopk)) cid[pos - itopk] = -1;
    }
  }
  __syncthreads();

  // 2 + 4. scores and packed order keys (skey overwrites the dedup keys)
  const uint32_t mask = (1u << P.pack_bits) - 1u;
  const uint32_t clamp_bits = (0x7F7FFFFFu >> P.pack_bits) << P.pack_bits;
  const float clamp = __uint_as_float(clamp_bits);
  for (int e = tid; e < npad; e += blockDim.x) {
    uint32_t key = 0xFFFFFFFFu;
    if (e < itopk) {
      key = pack_key(bd[e], e, mask, clamp);
    } else if (e < m) {
      const int c = e - itopk;
      float v = INFINITY;
      if (cid[c] >= 0) {
        const int8_t* cr = codes_s + static_cast<int64_t>(c) * p;
        float ip = 0.f, nrm = 0.f;
        if ((p & 15) == 0) {
          const int nch = p >> 4;
          for (int t = 0; t < nch; ++t) {
            const int ch = (t + c) % nch;  // staggered: fewer bank conflicts
            const int4 raw = reinterpret_cast<const int4*>(cr)[ch];
            const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const float cv = static_cast<float>(v8[u]);
              ip += cv * qpb[ch * 16 + u];
              nrm += cv * cv;
            }
          }
        } else {
          for (int k = 0; k < p; ++k) {
            const float cv = static_cast<float>(cr[k]);
            ip += cv * qpb[k];
            nrm += cv * cv;
          }
        }
        v = nrm - 2.0f * ip;
      }
      key = pack_key(v, e, mask, clamp);
    }
    skey[e] = key;
  }
  __syncthreads();
  bitonic_sort(skey, npad);

  // 5. the itopk smallest, decoded
  for (int t = tid; t < itopk; t += blockDim.x) {
    const uint32_t bits = key_bits(skey[t]);
    const uint32_t col = bits & mask;
    float v = __uint_as_float(bits & ~mask);
    if (v >= clamp) v = INFINITY;
    if (v <= -clamp) v = -INFINITY;
    int32_t id;
    float vis;
    if (col < static_cast<uint32_t>(itopk)) {
      id = bid[col];
      vis = bvis[col];
    } else {
      id = cid[col - itopk];
      vis = 0.f;
    }
    if (v == INFINITY) id = -1;
    P.out_ids[row * itopk + t] = id;
    P.out_d[row * itopk + t] = v;
    P.out_vis[row * itopk + t] = vis;
  }
}

}  // namespace

// Launch K6 for q queries on `stream`. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take: a merge
// wider than 2048 or staging past the shared-memory limit). Allocates
// nothing. Parent ids must be -1 or in [0, n).
extern "C" int raft_cagra_hop(const void* buf_ids, const void* buf_d,
                              const void* buf_vis, const void* parents,
                              const void* qp, const void* graph,
                              const void* codes, void* out_ids, void* out_d,
                              void* out_vis, int q, int itopk, int w,
                              long long n, int deg, int p, int pack_bits,
                              void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  if (itopk <= 0 || w <= 0 || deg <= 0 || p <= 0 || n <= 0 ||
      n > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
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
  P.itopk = itopk;
  P.w = w;
  P.deg = deg;
  P.p = p;
  P.b = w * deg;
  P.m = itopk + P.b;
  int npad = 2;
  while (npad < P.m) npad <<= 1;
  if (npad > kMaxSort || (1 << pack_bits) < P.m || pack_bits > 22)
    return (int)cudaErrorInvalidValue;
  P.npad = npad;
  P.pack_bits = pack_bits;
  const size_t rec = static_cast<size_t>(deg) * p;
  P.vec = (rec % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(codes) % 16 == 0) ? 1 : 0;
  P.code_bytes = (static_cast<size_t>(w) * rec + 15) / 16 * 16;
  const size_t smem = P.code_bytes + static_cast<size_t>(npad) * 8 +
                      static_cast<size_t>(p) * 4 +
                      static_cast<size_t>(itopk) * 12 +
                      static_cast<size_t>(P.b) * 4 + static_cast<size_t>(w) * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cagra_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  cagra_hop_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
