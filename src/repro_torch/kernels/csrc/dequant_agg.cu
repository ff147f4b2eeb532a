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
// 2. `dequant_agg_launch` (the per-leaf fold)
//
// Replaces the Pallas TPU kernel `dequant_agg_pallas` (body
// `_dequant_agg_kernel`) in src/repro/kernels/dequant_agg.py, which the
// per-leaf wire (`FLoCoRAConfig(flat_wire=False)`) calls once per packed
// leaf. Its grid walks (C/bc, K) with K innermost, and each step computes
//
//   contrib_k = (w_k * (lv - zp'[k, c])) * scale[k, c]  for n < n_valid[c],
//               +0.0 past it
//   out = contrib_0 at k = 0, then out += contrib_k
//
// with zp' = 0 wherever scale <= 0 (the JAX wrapper's `where`, applied here
// in registers). The association, (w * (lv - zp')) * scale, and the init,
// out = contrib_0 rather than 0 + contrib_0 (which would turn a -0.0 into
// +0.0), both differ from the flat fold above, so this body keeps its own
// loop: one thread per packed word, clients in strict k order, explicitly
// rounded intrinsics, bit-identical to `dequant_agg_ref` in ref.py.
//
// What bounds it: bytes, K words read and 32/bits fp32 values written per
// thread. At ResNet-8 r=32 int8 the 18 leaves move about 9 MB a round in all
// (2.7 us at 3.35 TB/s), spread over 18 launches of 10-256 rows, so each
// launch is far too small to fill the card: expect it to be launch-bound.
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kLeafThreads = 128;
constexpr int kMaxGridY = 65535;

// One thread per packed word: blockIdx.x walks the row's words, blockIdx.y
// (strided by gridDim.y) the rows, so no thread divides to find its row.
// n_valid may be null: every row then has nv_all valid levels.
template <int BITS>
__global__ void __launch_bounds__(kLeafThreads)
dequant_agg_kernel(const uint32_t* __restrict__ packed,
                   const float* __restrict__ scale,
                   const float* __restrict__ zp,
                   const float* __restrict__ weights,
                   const int* __restrict__ n_valid, int nv_all,
                   float* __restrict__ out, int k_clients, int c_rows,
                   int nw) {
  constexpr int kPer = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int w = blockIdx.x * kLeafThreads + threadIdx.x;
  if (w >= nw) return;
  const int c0 = w * kPer;
  for (int c = blockIdx.y; c < c_rows; c += gridDim.y) {
    const int nv = n_valid != nullptr ? n_valid[c] : nv_all;
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
          float contrib = __fmul_rn(__fmul_rn(wk, __fsub_rn(lv, z)), s);
          if (c0 + j >= nv) contrib = 0.0f;
          acc[j] = k == 0 ? contrib : __fadd_rn(acc[j], contrib);
        }
      }
    }
    // a word wholly past n_valid holds only masked columns: every
    // contribution was +0.0, so the sum is +0.0 and no word is read
    float4* dst = reinterpret_cast<float4*>(
        out + static_cast<int64_t>(c) * nw * kPer + c0);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                           acc[4 * j + 3]);
    }
  }
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

// The per-leaf fold (B3). packed (K, C, Nw) uint32; scale, zp (K, C) fp32
// (zp counts as 0 where scale <= 0); weights (K,) fp32; n_valid (C,) int32,
// or null for nv_all valid levels in every row; out (C, Nw*32/bits) fp32
// with a 16-byte aligned base. K = 0 writes zeros. Returns
// cudaGetLastError() after the launch.
extern "C" int dequant_agg_launch(const uint32_t* packed, const float* scale,
                                  const float* zp, const float* weights,
                                  const int* n_valid, int nv_all, float* out,
                                  int k, int c, int nw, int bits,
                                  void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (c <= 0 || nw <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((nw + kLeafThreads - 1) / kLeafThreads,
                  c < kMaxGridY ? c : kMaxGridY);
  const dim3 block(kLeafThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      dequant_agg_kernel<2><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, nv_all, out, k, c, nw);
      break;
    case 4:
      dequant_agg_kernel<4><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, nv_all, out, k, c, nw);
      break;
    case 8:
      dequant_agg_kernel<8><<<grid, block, 0, s>>>(
          packed, scale, zp, weights, n_valid, nv_all, out, k, c, nw);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
