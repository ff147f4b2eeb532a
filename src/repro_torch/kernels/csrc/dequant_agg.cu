// Fused unpack + dequantize + weighted cohort reduce for Hopper (sm_90a).
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
