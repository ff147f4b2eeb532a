// Fused unpack + dequantize + weighted cohort reduce for Hopper (sm_90a).
// Two entry points, one per TPU kernel; they fold in different orders, so
// each has its own body.
//
// 1. `dequant_agg_rows_launch` (the flat-tree fold)
//
// Replaces the Pallas TPU kernel `dequant_agg_rows_pallas` in
// src/repro/kernels/dequant_agg.py: both of its programs, the K-tiled
// `_dequant_agg_rows_ktiled_kernel` and the whole-K oracle
// `_dequant_agg_rows_kernel`, fold clients through `_seq_fold`. On the TPU
// the two differ only in how the K dimension is tiled through VMEM; here
// one loop over k inside each thread serves both, so every block_k gives
// the same bits.
//
//   out[c, n] = sum_k w_k * ((lv[k, c, n] - zp[k, c]) * scale[k, c])
//
// folded in strict k order (k = 0..K-1, starting from 0.0), with zp taken
// as 0 where scale is 0 (phantom rows), and out[c, n] = 0 exactly for
// n >= n_valid[c]. K = 1 is the streaming fold.
//
// What bounds it: bytes. Per output level it reads K*bits/8 bytes of words
// and writes 4 bytes of fp32, with ~4 flops per client and level. At the
// main path's K=5, int8, (1610, 640) words, the fp32 output (16.5 MB)
// dominates; the words read are K * 4.1 MB at most. The design reads no
// word that lies wholly past a row's n_valid (its outputs are zeros), so on
// the ResNet-8 layout the words read shrink to the ~6% that carry levels.
//
// Layout: one thread per packed word position (c, w). It keeps 32/bits fp32
// accumulators in registers and walks k in order; neighbouring threads read
// neighbouring words (coalesced along w) and write neighbouring float4
// groups of the output. No atomics and no cross-thread reduction: the
// result is deterministic. Each add and multiply is an explicitly rounded
// intrinsic, so nothing is contracted into an FMA and the kernel gives the
// same bits as its plain PyTorch version.
//
// 2. `dequant_agg_leaves_launch` (the per-leaf fold, grouped)
//
// Replaces the Pallas TPU kernel `dequant_agg_pallas` (body
// `_dequant_agg_kernel`), src/repro/kernels/dequant_agg.py:231 (its
// pallas_call at :259), which the per-leaf wire
// (`FLoCoRAConfig(flat_wire=False)`) calls once per packed leaf. Its grid
// walks (C/bc, K) with K innermost, and each step computes
//
//   contrib_k = (w_k * (lv - zp'[k, c])) * scale[k, c]  for n < n_valid[c],
//               +0.0 past it
//   out = contrib_0 at k = 0, then out += contrib_k
//
// with zp' = 0 wherever scale <= 0 (the JAX wrapper's `where`, applied here
// in registers). The association, (w * (lv - zp')) * scale, and the init,
// out = contrib_0 rather than 0 + contrib_0 (which would turn a -0.0 into
// +0.0), both differ from the flat fold above, so this body keeps its own
// loop: clients in strict k order, every add and multiply an explicitly
// rounded intrinsic (__fmul_rn, __fsub_rn, __fadd_rn: nothing contracted
// into an FMA), bit-identical to `dequant_agg_ref` in ref.py. CUDA, not
// Triton: Triton does not promise that a product and a sum stay two
// rounded operations.
//
// What bounds it: bytes, and in practice the launch. At ResNet-8 r=32,
// int8, K = 5 a round's 18 leaves hold 63,552 words a client that carry
// levels: 1,271,040 B of words, 64,400 B of sidecars and 1,016,576 B of
// compact fp32 output, about 2.35 MB, 0.70 us at 3.35 TB/s, spread over
// leaves of 10 to 256 rows. One launch a leaf (18 a round, each too small
// to fill the card, behind three copies that stacked the clients' words)
// cost about 57 us a round.
//
// Design: ONE launch folds every leaf of a round, reading each client's
// words where they lie (a row slice of a flat buffer, any row stride).
// The wrapper builds a descriptor table: the blocks' leaf starts (a
// prefix), then per leaf its rows C, words a row, valid levels n (or a
// per-row n_valid vector), output address and row stride, flags; then per
// (leaf, client) the words' address and row stride and the scale and zp
// addresses. A table of up to 8 KB (1024 words: K <= 11 clients at 18
// leaves) rides in the kernel's parameters (`__grid_constant__`), so the
// call is the launch alone; a larger one goes to the card in one
// non-blocking pinned copy first: on an H100 a copy between two launches
// cost the stream more time than the fold itself (chip_smoke.py timed the
// round's call at 16.4 us with the table uploaded, 5.5 us with it in the
// parameters). A larger block is no cure: with 32,000-byte blocks, 90
// one-leaf launches (among 270 small copies) filled the launch queue
// behind a 0.1 s kernel, where 8 KB blocks did not (chip_smoke.py's
// timing, four runs of four). A block finds its leaf from the prefix with
// a warp ballot (one read a lane), and each of its 64 threads owns four
// consecutive words of one row: one 16-byte load a client where the base
// and row stride allow it, the K clients' table entries (the same for the
// whole block: one broadcast read) and loads in flight eight at a time,
// the fold in registers, and only the row's first n_out columns stored
// (float4 where the output rows are 16-byte aligned). A word wholly past
// a row's valid levels is never read: its columns are +0.0. No atomics
// and no cross-thread reduction. The round's ~63,500 word positions a
// client make ~250 blocks of 64 threads: one wave on 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_agg_rows_kernel(const uint32_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        const float* __restrict__ zp,
                        const float* __restrict__ weights,
                        const int* __restrict__ n_valid,
                        float* __restrict__ out, int k_clients, int c_rows,
                        int nw) {
  constexpr int kPer = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t total = static_cast<int64_t>(c_rows) * nw;
  if (idx >= total) return;
  const int c = static_cast<int>(idx / nw);
  const int w = static_cast<int>(idx - static_cast<int64_t>(c) * nw);
  const int c0 = w * kPer;
  const int nv = n_valid[c];

  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;

  if (c0 < nv) {
    for (int k = 0; k < k_clients; ++k) {
      const int64_t kc = static_cast<int64_t>(k) * c_rows + c;
      const uint32_t word = packed[kc * nw + w];
      const float s = scale[kc];
      const float z = s > 0.0f ? zp[kc] : 0.0f;
      const float wk = weights[k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float lv = static_cast<float>((word >> (j * BITS)) & kMask);
        const float deq = __fmul_rn(__fsub_rn(lv, z), s);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, deq));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (c0 + j >= nv) acc[j] = 0.0f;
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      out + static_cast<int64_t>(c) * nw * kPer + c0);
#pragma unroll
  for (int j = 0; j < kPer / 4; ++j) {
    dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                         acc[4 * j + 3]);
  }
}

constexpr int kAggThreads = 64;      // threads a block: two warps
constexpr int kAggWords = 4;         // words a thread: one 16-byte load
constexpr int kLeafFields = 8;       // int64 fields of a leaf's head
constexpr int kClientFields = 4;     // ... and of a (leaf, client) entry
constexpr int kInFlight = 8;         // clients whose loads issue together
// int64 words of a table passed by value: 8 KB
constexpr int kInlineWords = 1024;

struct InlineTable {
  int64_t v[kInlineWords];
};

// The grouped per-leaf fold. `table` (int64): [0, L] the leaves' first
// blocks (start[L] = the grid); at L + 1 + 8 l leaf l's head {C, words a
// row nw, valid levels n, n_valid vector address or 0, output address,
// output row stride n_out, flags (1: 16-byte loads, 2: float4 stores), 0};
// at L + 1 + 8 L + 4 (l K + k) client k's {words address, row stride in
// words, scale address, zp address}. Columns past a row's valid levels
// and below n_out come out +0.0; n_out <= nw * 32 / BITS.
template <int BITS>
__device__ __forceinline__ void fold_leaves(const int64_t* table,
                                            const float* __restrict__ weights,
                                            int n_leaves, int k_clients) {
  constexpr int kPer = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kCols = kAggWords * kPer;   // output columns a thread
  const int block = static_cast<int>(blockIdx.x);
  const int lane = threadIdx.x & 31;

  // this block's leaf: the last whose first block is at or before it
  int leaf = -1;
  for (int i0 = 0; i0 < n_leaves; i0 += 32) {
    const int i = i0 + lane;
    leaf += __popc(__ballot_sync(0xffffffffu,
                                 i < n_leaves && table[i] <= block));
  }
  const int64_t* head = table + (n_leaves + 1) + kLeafFields * leaf;
  const int c_rows = static_cast<int>(head[0]);
  const int nw = static_cast<int>(head[1]);
  const int n_all = static_cast<int>(head[2]);
  const int* nvec = reinterpret_cast<const int*>(head[3]);
  float* out = reinterpret_cast<float*>(head[4]);
  const int64_t n_out = head[5];
  const int flags = static_cast<int>(head[6]);
  const int64_t* cli = table + (n_leaves + 1) + kLeafFields * n_leaves +
                       static_cast<int64_t>(kClientFields) * leaf * k_clients;

  // this thread's words: row c, words w0 .. w0 + 3
  const int64_t groups =
      ((n_out + kPer - 1) / kPer + kAggWords - 1) / kAggWords;
  const int64_t u =
      static_cast<int64_t>(block - table[leaf]) * kAggThreads + threadIdx.x;
  if (u >= groups * c_rows) return;
  const int c = static_cast<int>(u / groups);
  const int w0 = static_cast<int>(u - static_cast<int64_t>(c) * groups) *
                 kAggWords;
  const int c0 = w0 * kPer;
  const int nv = nvec != nullptr ? nvec[c] : n_all;
  // the row's words that hold a level; the others are never read
  const int wr = min(nw, nv > 0 ? (nv + kPer - 1) / kPer : 0);

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
  if (w0 < wr) {
    const bool vec = (flags & 1) && w0 + kAggWords <= wr;
    for (int k0 = 0; k0 < k_clients; k0 += kInFlight) {
      uint32_t word[kInFlight][kAggWords];
      float sc[kInFlight], zz[kInFlight], wk[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int k = k0 + j;
        if (k < k_clients) {
          const int64_t* e = cli + kClientFields * k;
          const uint32_t* p = reinterpret_cast<const uint32_t*>(e[0]) +
                              c * e[1] + w0;
          if (vec) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
            word[j][0] = v.x;
            word[j][1] = v.y;
            word[j][2] = v.z;
            word[j][3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < kAggWords; ++q)
              word[j][q] = w0 + q < wr ? __ldg(p + q) : 0u;
          }
          const float s = __ldg(reinterpret_cast<const float*>(e[2]) + c);
          const float z = __ldg(reinterpret_cast<const float*>(e[3]) + c);
          sc[j] = s;
          zz[j] = s > 0.0f ? z : 0.0f;
          wk[j] = weights[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int k = k0 + j;
        if (k < k_clients) {
#pragma unroll
          for (int q = 0; q < kAggWords; ++q) {
#pragma unroll
            for (int t = 0; t < kPer; ++t) {
              const float lv =
                  static_cast<float>((word[j][q] >> (t * BITS)) & kMask);
              float contrib =
                  __fmul_rn(__fmul_rn(wk[j], __fsub_rn(lv, zz[j])), sc[j]);
              if (c0 + q * kPer + t >= nv) contrib = 0.0f;
              float& a = acc[q * kPer + t];
              a = k == 0 ? contrib : __fadd_rn(a, contrib);
            }
          }
        }
      }
    }
  }
  // a word wholly past the valid levels holds only masked columns: every
  // contribution was +0.0, so the sum is +0.0 and no word was read
  float* dst = out + c * n_out + c0;
  const bool vec_out = flags & 2;
#pragma unroll
  for (int j = 0; j < kCols / 4; ++j) {
    const int64_t col = c0 + 4 * j;
    if (vec_out && col + 4 <= n_out) {
      *reinterpret_cast<float4*>(dst + 4 * j) = make_float4(
          acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (col + t < n_out) dst[4 * j + t] = acc[4 * j + t];
      }
    }
  }
}

// The fold with its table in device memory.
template <int BITS>
__global__ void __launch_bounds__(kAggThreads)
dequant_agg_leaves_kernel(const int64_t* __restrict__ table,
                          const float* __restrict__ weights, int n_leaves,
                          int k_clients) {
  fold_leaves<BITS>(table, weights, n_leaves, k_clients);
}

// The fold with its table in the kernel's parameters.
template <int BITS>
__global__ void __launch_bounds__(kAggThreads)
dequant_agg_leaves_inline_kernel(const __grid_constant__ InlineTable t,
                                 const float* __restrict__ weights,
                                 int n_leaves, int k_clients) {
  fold_leaves<BITS>(t.v, weights, n_leaves, k_clients);
}

template <int BITS>
cudaError_t launch_fold(const int64_t* table, int words, bool on_device,
                        const float* weights, int n_leaves, int k,
                        int blocks, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(blocks));
  if (on_device) {
    dequant_agg_leaves_kernel<BITS><<<grid, kAggThreads, 0, s>>>(
        table, weights, n_leaves, k);
  } else if (words <= kInlineWords) {
    InlineTable t;
    memcpy(t.v, table, sizeof(int64_t) * words);
    dequant_agg_leaves_inline_kernel<BITS>
        <<<grid, kAggThreads, 0, s>>>(t, weights, n_leaves, k);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// packed (K, C, Nw) uint32; scale, zp (K, C) fp32; weights (K,) fp32;
// n_valid (C,) int32; out (C, Nw*32/bits) fp32 with a 16-byte aligned base.
// Returns cudaGetLastError() after the launch.
extern "C" int dequant_agg_rows_launch(const uint32_t* packed,
                                       const float* scale, const float* zp,
                                       const float* weights,
                                       const int* n_valid, float* out, int k,
                                       int c, int nw, int bits, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int64_t total = static_cast<int64_t>(c) * nw;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      dequant_agg_rows_kernel<2><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, out, k, c, nw);
      break;
    case 4:
      dequant_agg_rows_kernel<4><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, out, k, c, nw);
      break;
    case 8:
      dequant_agg_rows_kernel<8><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, out, k, c, nw);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The per-leaf fold (B3), every leaf of a call in one launch: `table` as
// fold_leaves reads it, `words` int64 long: in device memory when
// `on_device`, else in host memory and passed by value in the launch's
// parameters (at most 1024 words); weights (K,) fp32 on the card,
// `blocks` = the table's start[L]. K = 0 writes zeros. Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_agg_leaves_launch(const int64_t* table, int words,
                                         int on_device, const float* weights,
                                         int n_leaves, int k, int blocks,
                                         int bits, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n_leaves < 1 || k < 0 || blocks < 0 || words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch_fold<2>(table, words, on_device, weights, n_leaves, k,
                           blocks, s);
      break;
    case 4:
      err = launch_fold<4>(table, words, on_device, weights, n_leaves, k,
                           blocks, s);
      break;
    case 8:
      err = launch_fold<8>(table, words, on_device, weights, n_leaves, k,
                           blocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
