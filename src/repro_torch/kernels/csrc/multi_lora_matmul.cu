// Multi-adapter LoRA matmuls for Hopper (sm_90a): the multi-tenant serving
// read path.
//
//   y[m, n] = sum_k x[m, k] W[k, n]
//             + s * sum_{r<R} h[m, r] * B_{ids[m]}[r, n],
//   h[m, r] = sum_{k<K} x[m, k] * A_{ids[m]}[k, r]
//
// every request row gathering its OWN adapter slot ids[m] from a rank
// bucket's staged slab. Two operations, each one C launch entry over an
// A/B source template:
//
//   multi_lora_matmul_q_launch (PackedSource<BITS>) replaces the Pallas
//     TPU kernel `multi_lora_matmul_q_pallas` /
//     `_multi_lora_matmul_q_kernel` (src/repro/kernels/lora_matmul.py).
//     A and B arrive as packed wire rows: aq (E, R, KW) uint32 with
//     (E, R) fp32 scale/zp, bq (E, N, RW)
//     uint32 with (E, N) scale/zp, levels little-endian within each word.
//     Unpack and dequant, (lv - zp) * scale, happen in registers inside
//     the product; no fp32 adapter reaches device memory. Only the first K
//     (A) and R (B) levels of a row are read: a zero level past them
//     dequantizes to -zp*scale, which is not 0.
//   multi_lora_matmul_launch (FpSource) replaces
//     `multi_lora_matmul_pallas` / `_multi_lora_matmul_kernel` (the
//     dequant-then-matmul baseline): the same structure over fp slabs
//     A (E, K, R), B (E, R, N).
//
// What bounds them on this card: at the serving shapes (M=64,
// K=N=2560, R=8, int4) the base product is 0.84 GFLOP of fp32 FMA (12.5 us
// at 67 TFLOP/s) against ~27 MB of bytes (W dominates, ~8 us at 3.35 TB/s):
// operations, by a little. The product stays in fp32 FMA, no TF32, because
// the reference computes it in fp32.
//
// Design (simple and right first; no wgmma or TMA yet). Each launch entry
// enqueues three kernels on the caller's stream:
//   1. lora_h_kernel: h[m, r] = sum_{k<K} x[m, k] * A_{ids[m]}[k, r] into
//      an (M, R) fp32 scratch the wrapper allocates. One block per row,
//      one warp per (row, r) pair walking the gathered A row along k
//      (packed: words unpacked and dequantized in registers, coalesced;
//      fp: strided floats), then a warp reduction. h is computed ONCE per
//      row: folding it into every N tile of the product repeated it 40
//      times at N=2560 and left each k slab waiting on its loads.
//   2. lora_tile_kernel: partial x @ W tiles. 64 threads own a TM x TN
//      output tile (64 x 16 for M > 16, else 16 x 64: every column strip
//      of W is read by one block when M <= 64), 4 x 4 outputs a thread,
//      over one of S contiguous k ranges (split-K, S <= kMaxSplits, so
//      that about four blocks run on each SM: at M=64 the product has
//      only 160 tiles, two warps each). 32-deep k slabs of x and W go
//      through two shared-memory buffers filled by cp.async (16-byte
//      copies when K and N are multiples of 4, else 4-byte; zero-fill
//      past the edges), the next slab in flight while this one computes;
//      per 4 k a thread issues 8 shared-memory float4 reads for 64 FMAs.
//      (Holding the next slab in registers instead spilled ~600 bytes a
//      thread at four blocks an SM.) Each split writes its partial tile
//      to an (S, M, N) scratch.
//   3. lora_epilogue_kernel: one thread per output sums the S partials
//      in split order (deterministic, no atomics) and adds
//      s * sum_r h[m, r] * B_{ids[m]}[r, n], as the reference associates
//      it: acc + s * y (packed B: the row's words unpacked and
//      dequantized; fp B: floats). Neighbouring threads take
//      neighbouring n.
// Rank-bucket padding is exact: padded A rows carry scale = zp = 0, so
// their h lanes are exact zeros that multiply finite padded-B values.
// Row ids must lie below E; the wrapper checks them on the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHThreads = 256;     // lora_h_kernel: 8 warps, one row
constexpr int kTileThreads = 64;   // lora_tile_kernel: 4 x 4 outputs each
constexpr int kTK = 32;            // k slab depth
constexpr int kXPad = kTK + 4;     // x slab row stride (float4 reads,
                                   // conflict-free stores)
constexpr int kMaxSplits = 8;      // split-K ranges (the scratch's depth)
constexpr int kTargetBlocks = 528; // about four tile blocks per SM
constexpr int kEpiThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A and B as packed wire rows: levels little-endian in uint32 words,
// dequantized as (lv - zp) * scale, reading only the first K (A) and R
// (B) levels of a row.
template <int BITS>
struct PackedSource {
  static constexpr int kPer = 32 / BITS;
  static constexpr uint32_t kMask = (1u << BITS) - 1u;
  const uint32_t* aq;     // (E, R, KW)
  const float* a_scale;   // (E, R)
  const float* a_zp;
  const uint32_t* bq;     // (E, N, RW)
  const float* b_scale;   // (E, N)
  const float* b_zp;
  int KW, RW;

  // this lane's part of sum_{k<K} x[k] * A_{id}[k, r]
  __device__ __forceinline__ float h_part(const float* __restrict__ xr,
                                          int id, int r, int R, int K,
                                          int lane) const {
    const int64_t row = static_cast<int64_t>(id) * R + r;
    const uint32_t* words = aq + row * KW;
    const float sc = a_scale[row], zp = a_zp[row];
    float part = 0.0f;
#pragma unroll 4
    for (int wi = lane; wi < KW; wi += 32) {
      const uint32_t word = words[wi];
      const int kb = wi * kPer;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        if (kb + t < K) {
          const float lv = static_cast<float>((word >> (t * BITS)) & kMask);
          part = fmaf(xr[kb + t], (lv - zp) * sc, part);
        }
      }
    }
    return part;
  }

  // sum_{r<R} h[r] * B_{id}[r, n]
  __device__ __forceinline__ float y(const float* __restrict__ h, int id,
                                     int n, int N, int R) const {
    const int64_t row = static_cast<int64_t>(id) * N + n;
    const uint32_t* words = bq + row * RW;
    const float sc = b_scale[row], zp = b_zp[row];
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) {
      const uint32_t word = words[r / kPer];
      const float lv =
          static_cast<float>((word >> ((r % kPer) * BITS)) & kMask);
      acc = fmaf(h[r], (lv - zp) * sc, acc);
    }
    return acc;
  }
};

// A (E, K, R) and B (E, R, N) as fp32 slabs
struct FpSource {
  const float* a;
  const float* b;

  __device__ __forceinline__ float h_part(const float* __restrict__ xr,
                                          int id, int r, int R, int K,
                                          int lane) const {
    const float* col = a + static_cast<int64_t>(id) * K * R + r;
    float part = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32)
      part = fmaf(xr[k], col[static_cast<int64_t>(k) * R], part);
    return part;
  }

  __device__ __forceinline__ float y(const float* __restrict__ h, int id,
                                     int n, int N, int R) const {
    const float* bm = b + static_cast<int64_t>(id) * R * N + n;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r)
      acc = fmaf(h[r], bm[static_cast<int64_t>(r) * N], acc);
    return acc;
  }
};

// h (M, R): block m, warp w takes r = w, w + 8, ...
template <class Source>
__global__ void __launch_bounds__(kHThreads)
lora_h_kernel(const float* __restrict__ x, const Source src,
              const int* __restrict__ ids, float* __restrict__ h, int K,
              int R) {
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int id = ids[m];
  const float* xr = x + static_cast<int64_t>(m) * K;
  for (int r = warp; r < R; r += kHThreads / 32) {
    const float part = warp_sum(src.h_part(xr, id, r, R, K, lane));
    if (lane == 0) h[static_cast<int64_t>(m) * R + r] = part;
  }
}

// 4-byte asynchronous global -> shared copy (sm_80+); a false `valid`
// copies no byte and zero-fills the destination
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// the same for 16 bytes (4 floats; both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// VEC: K and N are multiples of 4 and x, w are 16-byte aligned, so every
// slab row copies in float4 pieces that lie wholly inside or outside
template <int TM, int TN, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
lora_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ part, int M, int K, int N,
                 int k_split) {
  static_assert(TM * TN == 16 * kTileThreads, "4 x 4 outputs a thread");
  constexpr int kColGroups = TN / 4;
  constexpr int kXLoads = TM * kTK / kTileThreads;
  constexpr int kWLoads = kTK * TN / kTileThreads;
  // two slab buffers: one computes while the other fills
  __shared__ __align__(16) float xs[2][TM][kXPad];   // x slabs, row-major
  __shared__ __align__(16) float ws[2][kTK][TN];     // W slabs

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_slabs = (k_end - k_begin + kTK - 1) / kTK;
  const int tid = threadIdx.x;
  const int tr = tid / kColGroups;   // rows tr*4 .. tr*4+3
  const int tc = tid % kColGroups;   // columns tc*4 .. tc*4+3

  auto issue = [&](int slab) {       // one commit group per slab
    const int k0 = k_begin + slab * kTK;
    const int b = slab & 1;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kXLoads / 4; ++i) {   // k fastest: coalesced
        const int idx = tid + i * kTileThreads;
        const int mm = idx / (kTK / 4), kk = (idx % (kTK / 4)) * 4;
        const int m = m0 + mm, k = k0 + kk;
        const bool ok = m < M && k < k_end;
        cp_async16(&xs[b][mm][kk],
                   ok ? x + static_cast<int64_t>(m) * K + k : x, ok);
      }
#pragma unroll
      for (int i = 0; i < kWLoads / 4; ++i) {   // n fastest: coalesced
        const int idx = tid + i * kTileThreads;
        const int kk = idx / (TN / 4), nn = (idx % (TN / 4)) * 4;
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < k_end && n < N;
        cp_async16(&ws[b][kk][nn],
                   ok ? w + static_cast<int64_t>(k) * N + n : w, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + i * kTileThreads;
        const int mm = idx / kTK, kk = idx % kTK;
        const int m = m0 + mm, k = k0 + kk;
        const bool ok = m < M && k < k_end;
        cp_async4(&xs[b][mm][kk],
                  ok ? x + static_cast<int64_t>(m) * K + k : x, ok);
      }
#pragma unroll 4
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = tid + i * kTileThreads;
        const int kk = idx / TN, nn = idx % TN;
        const int k = k0 + kk, n = n0 + nn;
        const bool ok = k < k_end && n < N;
        cp_async4(&ws[b][kk][nn],
                  ok ? w + static_cast<int64_t>(k) * N + n : w, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  issue(0);
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab + 1 < n_slabs) {
      issue(slab + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);   // this slab landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int b = slab & 1;
#pragma unroll 2
    for (int kk = 0; kk < kTK; kk += 4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&xs[b][tr * 4 + i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[b][kk + q][tc * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y
                         : q == 2 ? xv[i].z : xv[i].w;
          acc[i][0] = fmaf(xq, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xq, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xq, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xq, wv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();   // all reads of buffer b done before it refills
  }

  float* dst = part + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc * 4 + j;
      if (n < N) dst[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

// out[m, n] = (sum of the S partials, in split order) + s * y[m, n]
template <class Source>
__global__ void __launch_bounds__(kEpiThreads)
lora_epilogue_kernel(const float* __restrict__ part, const Source src,
                     const int* __restrict__ ids, const float* __restrict__ h,
                     float* __restrict__ out, int M, int N, int R,
                     int splits, float s) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kEpiThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(M) * N) return;
  const int m = static_cast<int>(idx / N);
  const int n = static_cast<int>(idx - static_cast<int64_t>(m) * N);
  float acc = part[idx];
  for (int z = 1; z < splits; ++z)
    acc += part[static_cast<int64_t>(z) * M * N + idx];
  out[idx] = acc + s * src.y(h + static_cast<int64_t>(m) * R, ids[m], n, N,
                             R);
}

template <class Source>
int launch(const float* x, const float* w, const Source& src, const int* ids,
           float* h, float* part, float* out, int M, int K, int N, int R,
           float s, cudaStream_t st) {
  lora_h_kernel<Source><<<M, kHThreads, 0, st>>>(x, src, ids, h, K, R);
  const bool tall = M > 16;
  const int tm = tall ? 64 : 16, tn = tall ? 16 : 64;
  const int tiles = ((N + tn - 1) / tn) * ((M + tm - 1) / tm);
  const int slabs = (K + kTK - 1) / kTK;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = max(1, min(splits, min(kMaxSplits, slabs)));
  const int k_split = ((slabs + splits - 1) / splits) * kTK;
  splits = (K + k_split - 1) / k_split;   // no empty split
  const dim3 grid((N + tn - 1) / tn, (M + tm - 1) / tm, splits);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  auto tile = tall ? (vec ? lora_tile_kernel<64, 16, true>
                          : lora_tile_kernel<64, 16, false>)
                   : (vec ? lora_tile_kernel<16, 64, true>
                          : lora_tile_kernel<16, 64, false>);
  tile<<<grid, kTileThreads, 0, st>>>(x, w, part, M, K, N, k_split);
  const int64_t total = static_cast<int64_t>(M) * N;
  lora_epilogue_kernel<Source><<<
      static_cast<unsigned>((total + kEpiThreads - 1) / kEpiThreads),
      kEpiThreads, 0, st>>>(part, src, ids, h, out, M, N, R, splits, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w (K, N) fp32; aq (E, R, KW) uint32, a_scale/a_zp (E, R);
// bq (E, N, RW) uint32, b_scale/b_zp (E, N); ids (M,) int32 < E;
// scratch h (M, R) and part (8, M, N) fp32; out (M, N) fp32. Returns
// cudaGetLastError() after the launches.
extern "C" int multi_lora_matmul_q_launch(
    const float* x, const float* w, const uint32_t* aq, const float* a_scale,
    const float* a_zp, const uint32_t* bq, const float* b_scale,
    const float* b_zp, const int* ids, float* h, float* part, float* out,
    int M, int K, int N, int R, int KW, int RW, int bits, float s,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (R < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      return launch(x, w, PackedSource<2>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, h, part, out, M, K, N, R, s, st);
    case 4:
      return launch(x, w, PackedSource<4>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, h, part, out, M, K, N, R, s, st);
    case 8:
      return launch(x, w, PackedSource<8>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, h, part, out, M, K, N, R, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (M, K), w (K, N), a (E, K, R), b (E, R, N) fp32; ids (M,) int32 < E;
// scratch h (M, R) and part (8, M, N) fp32; out (M, N) fp32. Returns
// cudaGetLastError() after the launches.
extern "C" int multi_lora_matmul_launch(const float* x, const float* w,
                                        const float* a, const float* b,
                                        const int* ids, float* h, float* part,
                                        float* out, int M, int K, int N,
                                        int R, float s, void* stream) {
  cudaGetLastError();
  if (R < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  return launch(x, w, FpSource{a, b}, ids, h, part, out, M, K, N, R, s,
                static_cast<cudaStream_t>(stream));
}
