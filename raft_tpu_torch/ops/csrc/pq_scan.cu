// K5 — the IVF-PQ lookup-table list scan, written for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/pq_scan.py:_pq_scan_kernel (launched by pq_scan,
// pl.pallas_call). Every probed (query, list) pair is scored against all
// entries of its list:
//
//   out[pair_out[i], j] = sum_s luts[pair_lut[i], s * nc + codes_t[l, s, j]]
//                         + b_sum[l, j]            (l the pair's list)
//
// luts (rows, s * nc) bf16, one row per query; codes_t (L, s, m) uint8 (list
// dimension minor); b_sum (L, m) fp32 with +inf at padding entries; out
// (P, m) fp32. The pairs are sorted by list and cut into blocks of up to 16
// pairs of one list (blocks (n_blocks, 3) int32: list, first pair, count;
// rows with count 0 do nothing). The s lookups of an entry are summed in
// fp32 in subspace order and b_sum is added last, the plain twin's order; a
// LUT row of zeros comes out as exactly b_sum, and padding as +inf. The JAX
// package's grouped layout (lists x slots) is the trivial pair list: slot
// (l, i) is the pair of LUT row and output row l * qpl + i.
//
// What the TPU's design cost here. Mosaic cannot gather, so the TPU scan
// takes each list's queries as a dense (n_lists, cap, s * nc) block of LUT
// rows, zeros at empty slots, and writes a dense (n_lists, cap, m) block;
// under probe skew a cap that drops pairs forces the whole search to rerun
// at twice the cap. On the streamed path (1,024 lists, n_probes 16, q_tile
// 312) that was four attempts and 96% empty slots. K5 now reads the pairs
// themselves: no cap, no dropped pair, no grouped LUT block and no scores
// gather back; each pair's scores land in their query/probe row at once.
//
// What bounds it on the H100. Per launch the bytes are each input once -
// the tile's LUT table (rows * s * nc * 2), the codes and b_sum of the
// probed lists, the pair arrays - and the scores written once (P * m * 4);
// the operations are P * m * s fp32 adds. At the streamed path's shape the
// bytes bound it, mostly the codes of the probed lists and the scores. What
// the kernel really pays for is one data-dependent shared-memory lookup per
// (pair, entry, subspace), and 16 adds per lookup however many of the
// block's 16 slots are pairs (8 when a block holds 8 or fewer).
//
// What the design does about it. A CUDA thread gathers where the TPU
// multiplied by a one-hot block. One block owns (16 pairs of one list, a
// tile of up to 1,024 entries); each of its up to 256 threads owns 4
// consecutive entries and keeps 16 fp32 sums for each in registers. The
// block stages its pairs' LUT rows for a chunk of subspaces (2,048 LUT
// entries per slot, 64 KB) in shared memory, TRANSPOSED to
// [s][code][slot]: the 16 slots' values of one (subspace, code) are 32
// contiguous bytes, so one lookup is two 16-byte shared loads that serve
// all 16 slots (one when the block holds 8 pairs or fewer). The
// transposition is done in registers (8 slots x 8 codes a thread, byte
// permutes) between a 16-byte coalesced global load and 16-byte shared
// stores; the rows are XOR-swizzled so the stores of a quarter-warp fall in
// distinct banks. The codes of 4 entries are one coalesced 32-bit load per
// subspace. A pair's LUT row is read from its query's row of the table:
// the pairs of one query hit L2 while the tile's table fits there. Every
// offset into luts, codes and out is 64-bit.
// Next steps (later PRs): pack two slots per 32-bit bank to halve bank
// conflicts, double-buffer the staging, fuse the per-query select.
//
// Built without --use_fast_math and without -ftz: the sums are plain fp32
// adds in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 16;            // query slots per block
constexpr int kEPT = 4;            // consecutive entries per thread
constexpr int kMaxThreads = 256;
constexpr int kChunkElems = 2048;  // LUT entries per slot staged at once
constexpr size_t kSmemBytes =
    static_cast<size_t>(kChunkElems) * kQB * 2;  // 64 KB

struct ScanParams {
  const uint4* luts;       // (rows, f) bf16, as 16-byte vectors
  const int32_t* pair_lut; // (P,) LUT row of each pair
  const int32_t* pair_out; // (P,) output row of each pair
  const int32_t* blocks;   // (n_blocks, 3): list, first pair, pairs <= kQB
  const uint8_t* codes;    // (L, s, m)
  const float* b_sum;      // (L, m)
  float* out;              // (P, m)
  int s, m, nc, f;
  int n_mtiles;
  int vec;                 // m % 4 == 0: 32-bit code loads, float4 I/O
};

// 16-byte shared chunk of (row f, half h): row f holds the 16 slots of one
// (subspace, code) as 32 bytes; the XOR spreads the rows a quarter-warp
// stores (f = 8v + cc for 8 consecutive v) over 8 distinct bank groups
__device__ __forceinline__ int phys_chunk(int f, int h) {
  return ((f >> 2) << 3) + ((((f & 3) << 1) + h) ^ ((f >> 3) & 7));
}

__device__ __forceinline__ void add_bf16x2(float& lo, float& hi, uint32_t w) {
  lo += __uint_as_float(w << 16);
  hi += __uint_as_float(w & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kMaxThreads)
pq_scan_kernel(ScanParams P) {
  extern __shared__ uint4 lut_s[];
  __shared__ int64_t lut_off[kQB];   // element offset of each slot's LUT row
  __shared__ int64_t out_off[kQB];   // element offset of each slot's scores
  const int bi = blockIdx.x / P.n_mtiles;
  const int mt = blockIdx.x % P.n_mtiles;
  const int64_t l = P.blocks[3 * bi];
  const int first = P.blocks[3 * bi + 1];
  const int cnt = P.blocks[3 * bi + 2];
  if (cnt <= 0) return;              // a spare row of the block table
  const int tid = threadIdx.x;
  if (tid < kQB) {
    lut_off[tid] = tid < cnt
        ? static_cast<int64_t>(P.pair_lut[first + tid]) * P.f : -1;
    out_off[tid] = tid < cnt
        ? static_cast<int64_t>(P.pair_out[first + tid]) * P.m : -1;
  }
  const int j0 = (mt * blockDim.x + tid) * kEPT;
  const bool live = j0 < P.m;
  const bool half = cnt <= kQB / 2;  // slots 8..15 are empty
  const int nc = P.nc;
  const int s_chunk = min(P.s, kChunkElems / nc);

  float acc[kEPT][kQB];
#pragma unroll
  for (int e = 0; e < kEPT; ++e)
#pragma unroll
    for (int k = 0; k < kQB; ++k) acc[e][k] = 0.0f;

  for (int s0 = 0; s0 < P.s; s0 += s_chunk) {
    const int sc = min(s_chunk, P.s - s0);
    const int f8 = sc * nc / 8;          // 8-entry vectors per slot row
    __syncthreads();                     // the previous chunk is consumed
    for (int item = tid; item < (half ? f8 : 2 * f8); item += blockDim.x) {
      const int h = item / f8;           // slots 8h .. 8h + 7
      const int v = item - h * f8;
      uint4 in[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int64_t off = lut_off[8 * h + kk];
        in[kk] = off >= 0 ? P.luts[(off + static_cast<int64_t>(s0) * nc +
                                    8 * v) >> 3]
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const uint32_t sel = (cc & 1) ? 0x7632u : 0x5410u;
        uint32_t w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t* a = reinterpret_cast<const uint32_t*>(&in[2 * p]);
          const uint32_t* b = reinterpret_cast<const uint32_t*>(&in[2 * p + 1]);
          w[p] = __byte_perm(a[cc >> 1], b[cc >> 1], sel);
        }
        lut_s[phys_chunk(8 * v + cc, h)] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int si = 0; si < sc; ++si) {
      const int64_t crow = (l * P.s + s0 + si) * static_cast<int64_t>(P.m);
      uint32_t cw = 0;
      if (P.vec) {
        cw = *reinterpret_cast<const uint32_t*>(P.codes + crow + j0);
      } else {
#pragma unroll
        for (int e = 0; e < kEPT; ++e)
          if (j0 + e < P.m) cw |= static_cast<uint32_t>(P.codes[crow + j0 + e]) << (8 * e);
      }
#pragma unroll
      for (int e = 0; e < kEPT; ++e) {
        // codes are < nc; the mask keeps a bad code inside the staged rows
        const int ch = phys_chunk(si * nc + ((cw >> (8 * e)) & (nc - 1)), 0);
        const uint4 lo = lut_s[ch];
        add_bf16x2(acc[e][0], acc[e][1], lo.x);
        add_bf16x2(acc[e][2], acc[e][3], lo.y);
        add_bf16x2(acc[e][4], acc[e][5], lo.z);
        add_bf16x2(acc[e][6], acc[e][7], lo.w);
        if (!half) {
          const uint4 hi = lut_s[ch ^ 1];
          add_bf16x2(acc[e][8], acc[e][9], hi.x);
          add_bf16x2(acc[e][10], acc[e][11], hi.y);
          add_bf16x2(acc[e][12], acc[e][13], hi.z);
          add_bf16x2(acc[e][14], acc[e][15], hi.w);
        }
      }
    }
  }
  if (!live) return;

  const int64_t brow = l * static_cast<int64_t>(P.m);
  float b[kEPT];
  if (P.vec) {
    const float4 bv = *reinterpret_cast<const float4*>(P.b_sum + brow + j0);
    b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
  } else {
#pragma unroll
    for (int e = 0; e < kEPT; ++e)
      b[e] = j0 + e < P.m ? P.b_sum[brow + j0 + e] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kQB; ++k) {
    if (k >= cnt) break;
    float* o = P.out + out_off[k] + j0;
    if (P.vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[0][k] + b[0], acc[1][k] + b[1], acc[2][k] + b[2],
                      acc[3][k] + b[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPT; ++e)
        if (j0 + e < P.m) o[e] = acc[e][k] + b[e];
    }
  }
}

}  // namespace

// Launch K5 over the block table on `stream`. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes the kernel does not
// take: nc not a power of two in [16, 256], luts not 16-byte aligned, a
// grid past the card's limits). Allocates nothing. Codes must be < nc (a
// code past it reads the entry of code & (nc - 1)); pair_lut must index
// rows of luts and pair_out rows of out.
extern "C" int raft_pq_scan(const void* luts, const void* pair_lut,
                            const void* pair_out, const void* blocks,
                            const void* codes, const void* b_sum, void* out,
                            int n_blocks, int s, int m, int nc,
                            void* stream) {
  if (n_blocks <= 0 || m <= 0) return (int)cudaSuccess;
  if (s <= 0 || nc < 16 || nc > 256 || (nc & (nc - 1)) ||
      reinterpret_cast<uintptr_t>(luts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  ScanParams P{};
  P.luts = static_cast<const uint4*>(luts);
  P.pair_lut = static_cast<const int32_t*>(pair_lut);
  P.pair_out = static_cast<const int32_t*>(pair_out);
  P.blocks = static_cast<const int32_t*>(blocks);
  P.codes = static_cast<const uint8_t*>(codes);
  P.b_sum = static_cast<const float*>(b_sum);
  P.out = static_cast<float*>(out);
  P.s = s;
  P.m = m;
  P.nc = nc;
  P.f = s * nc;
  P.vec = (m % 4 == 0) &&
          reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(b_sum) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
  const int groups = (m + kEPT - 1) / kEPT;
  const int threads = min(kMaxThreads, (groups + 31) / 32 * 32);
  P.n_mtiles = (groups + threads - 1) / threads;
  const long long gx = static_cast<long long>(n_blocks) * P.n_mtiles;
  if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return (int)err;
  pq_scan_kernel<<<static_cast<unsigned>(gx), threads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
