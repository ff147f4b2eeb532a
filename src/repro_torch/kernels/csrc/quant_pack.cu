// Fused per-row affine quantize + bit-pack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `quant_pack_pallas` / `_quant_pack_kernel`
// (src/repro/kernels/quant_pack.py), as reached through
// `ops.quant_pack_rows`: the flat-tree codec packs a whole message, every
// leaf's channel rows stacked in one ragged (C, N) fp32 buffer, in one
// launch. Row c is valid over its first n_valid[c] columns. The per-leaf
// wire (`ops.quant_pack`) calls it once a leaf with every row full.
//
// What bounds it: bytes. Each level costs one fp32 read and bits/8 bytes of
// output, a few flops apiece, far below the card's ~20 flops per byte.
// The kernel never reads a column past n_valid[c], so what it must move is
// the valid levels in, the whole (C, N*bits/32) word buffer and the two
// sidecars out. On the main path (ResNet-8, r=32, int8: a (1610, 2560)
// buffer, 640 words a row) that is 254,144 valid levels (1.02 MB) + 4.12
// MB of words + 12.9 KB of sidecars = 5,157,496 B, 1.54 us at 3.35 TB/s.
//
// Layout: one block of 128 threads per row. Pass 1 is a masked min/max
// (warp shuffles, then shared memory); thread 0 derives scale and zp.
// Pass 2 has each thread build whole uint32 words, 32/bits levels
// little-endian per word, reading its levels as float4; neighbouring
// threads take neighbouring words, so reads and stores coalesce.
//
// Designs measured against this one on the card (PERF.md), all
// bit-exact, none faster: a warp per row (8 rows a block, no block
// barrier, 16-byte stores), several independent warps per row, and a
// block per row with one barrier, float4 pass-1 batches and 16-byte
// stores. A warp per row leaves one warp to do a 2304-level row's 576
// words and 2304 correctly rounded divisions; spreading the row wider
// brings back the barrier this layout has. At ~5 us the kernel sits near
// the card's fixed cost for a dependent chain of two global reads, a
// barrier and a store; the 256-thread blocks of the first design took
// 1.5 waves.
//
// Numerics: bit-exact against the reference. Build WITHOUT --use_fast_math.
// x/scale and -xmin/scale are correctly rounded divisions (__fdiv_rn), the
// range multiplies by f32(1/qmax) passed from the host (the reference's
// reciprocal multiply), rounding is rintf (half to even, like jnp.round),
// and a zero zp is stored as +0.0 (the reference's sign of zero).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a row: 1610 blocks of 4 warps are one wave on 132 SMs (16
// blocks an SM); blocks of 8 warps took 1.5 waves
constexpr int kThreads = 128;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ uint32_t level_of(float x, float scale, float zp,
                                             float qmax) {
  float q = __fadd_rn(rintf(__fdiv_rn(x, scale)), zp);
  q = fminf(fmaxf(q, 0.0f), qmax);
  return static_cast<uint32_t>(q);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_pack_rows_kernel(const float* __restrict__ x,
                       const int* __restrict__ n_valid,
                       uint32_t* __restrict__ packed,
                       float* __restrict__ scale_out,
                       float* __restrict__ zp_out,
                       int n, float inv_qmax) {
  constexpr int kPer = 32 / BITS;
  constexpr float kQmax = static_cast<float>((1 << BITS) - 1);
  const int row = blockIdx.x;
  const int nw = n / kPer;
  const int nv = min(max(n_valid[row], 0), n);
  const float* xr = x + static_cast<size_t>(row) * n;
  uint32_t* pr = packed + static_cast<size_t>(row) * nw;

  // pass 1: masked min/max over the row's valid columns only
  float lo = kBig, hi = -kBig;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const float v = xr[i];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  __shared__ float s_scale, s_zp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      lo = fminf(lo, s_lo[i]);
      hi = fmaxf(hi, s_hi[i]);
    }
    const float xmin = fminf(lo, 0.0f);
    const float xmax = fmaxf(hi, 0.0f);
    const float rng = __fsub_rn(xmax, xmin);
    const float scale = rng > 0.0f ? __fmul_rn(rng, inv_qmax) : 1.0f;
    float zp = fminf(fmaxf(rintf(__fdiv_rn(-xmin, scale)), 0.0f), kQmax);
    zp = zp > 0.0f ? zp : 0.0f;  // +0.0, never -0.0
    s_scale = scale;
    s_zp = zp;
    scale_out[row] = scale;
    zp_out[row] = zp;
  }
  __syncthreads();
  const float scale = s_scale, zp = s_zp;

  // pass 2: whole words; zero words past the row's length are not read
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const int c0 = w * kPer;
    uint32_t word = 0;
    if (c0 + kPer <= nv) {
      const float4* src = reinterpret_cast<const float4*>(xr + c0);
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const float4 v = src[j];
        word |= level_of(v.x, scale, zp, kQmax) << ((4 * j + 0) * BITS);
        word |= level_of(v.y, scale, zp, kQmax) << ((4 * j + 1) * BITS);
        word |= level_of(v.z, scale, zp, kQmax) << ((4 * j + 2) * BITS);
        word |= level_of(v.w, scale, zp, kQmax) << ((4 * j + 3) * BITS);
      }
    } else if (c0 < nv) {
      for (int j = 0; j < kPer && c0 + j < nv; ++j) {
        word |= level_of(xr[c0 + j], scale, zp, kQmax) << (j * BITS);
      }
    }
    pr[w] = word;
  }
}

}  // namespace

// x (C, N) fp32 row-major with N a multiple of 4 * 32/bits and a 16-byte
// aligned base; n_valid (C,) int32; packed (C, N*bits/32) uint32;
// scale, zp (C,) fp32. Returns cudaGetLastError() after the launch.
extern "C" int quant_pack_rows_launch(const float* x, const int* n_valid,
                                      uint32_t* packed, float* scale,
                                      float* zp, int c, int n, int bits,
                                      float inv_qmax, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (c <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(c), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      quant_pack_rows_kernel<2><<<grid, block, 0, s>>>(x, n_valid, packed,
                                                       scale, zp, n, inv_qmax);
      break;
    case 4:
      quant_pack_rows_kernel<4><<<grid, block, 0, s>>>(x, n_valid, packed,
                                                       scale, zp, n, inv_qmax);
      break;
    case 8:
      quant_pack_rows_kernel<8><<<grid, block, 0, s>>>(x, n_valid, packed,
                                                       scale, zp, n, inv_qmax);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
