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
//     (E, R) fp32 scale/zp, bq (E, N, RW) uint32 with (E, N) scale/zp,
//     levels little-endian within each word. Unpack and dequant,
//     (lv - zp) * scale, happen in registers; no fp32 adapter reaches
//     device memory. Only the first K (A) and R (B) levels of a row are
//     read: a zero level past them dequantizes to -zp*scale, not 0.
//   multi_lora_matmul_launch (FpSource) replaces
//     `multi_lora_matmul_pallas` / `_multi_lora_matmul_kernel` (the
//     dequant-then-matmul baseline): the same over fp32 slabs A (E, K, R),
//     B (E, R, N).
//
// What bounds them on this card. At the serving shape (M = 64 rows,
// K = N = 2560, R = 8, int4, 24 distinct slots) the function must move
// 28,509,952 bytes (B4; 31,457,536 for B5), W's 26.2 MB most of it:
// 8.5 us at 3.35 TB/s. On the tensor cores the product below is
// 3 x 2MKN = 2.5 GFLOP of bf16, 2.5 us at 989 TFLOP/s, so it is bound by
// BYTES at every M the path launches (8, 32, 64). (As fp32 FMA on the
// CUDA cores the same product would take 12.5 us at 67 TFLOP/s.)
// chip_smoke.py times a plain streaming read of W (W.sum()) beside these
// kernels: the yardstick for what the card's memory gives in practice.
//
// The base product x@W on the tensor cores, fp32-accurate. The contract
// is rtol = atol = 1e-4 against the fp32 plain version. A single bf16 or
// TF32 pass misses it at K = 2560 (about 1.5e-2 and 1.7e-3 of max|y| ~ 6),
// so every fp32 operand v is split into hi = bf16(v) and lo = bf16(v - hi)
// (v - hi is exact in fp32) and the product is
//     x@W ~ xlo@Whi + xhi@Wlo + xhi@Whi    (fp32 accumulators),
// dropping only lo@lo (about 2^-16 relative per term); worst error at the
// serving shape about 3e-5 (tests/test_torch_serve_split.py emulates it
// on the CPU). mma.sync.m16n8k16 (HMMA), not wgmma: the product is bound
// by W's bytes, three HMMA passes at ~60% of the tensor-core peak need
// ~4.2 us at M = 64, and A (W's split fragments) is built in registers,
// which mma.sync takes as it is.
//
// Design. Each launch entry enqueues two kernels on the caller's stream:
//   1. lora_prep_kernel, two jobs in one grid:
//      - h = x A[ids], once per row, split over K so that there are
//        blocks enough at M = 8: block (m, q) writes the partial
//        hpart[q, m, :] over the q-th k chunk (whole 32-level chunks, so
//        packed words never straddle two chunks). Packed A: one warp per
//        r walks the row's words (coalesced), unpacks and dequantizes in
//        registers, then a warp sum. fp A: the gathered (chunk, R) slab
//        is walked as ONE contiguous array, thread -> r = idx mod R, then
//        the threads that share an r are summed in order.
//      - x split into bf16 hi/lo MMA fragments ONCE for the whole product
//        (xfrag), in the order the product reads them: a 32-deep slab of
//        a row tile is one contiguous piece.
//      It lets the product kernel launch at once (programmatic dependent
//      launch); the product streams W until it needs xfrag.
//   2. lora_product_kernel: yT = WT xT, so that N fills the MMA's 16-row
//      side and the request rows (padded to 8, 16, 32 or 64: MT 8-row
//      tiles) its 8-wide side; M = 8 wastes nothing. A block (256
//      threads) owns 128 columns of N for a row tile and one of S
//      contiguous k ranges (split-K, S <= 8: S = 8 at N = 2560, 160
//      blocks). 32-deep slabs of W (fp32) and of xfrag go through a
//      4-stage cp.async ring in shared memory, issued by all threads
//      (16-byte copies when N is a multiple of 4 and W is aligned, else
//      4-byte; zero fill past every edge). Each W element is read from
//      HBM once and split into hi/lo once, by the one thread whose MMA
//      fragment holds it. Warp w computes 32 columns over one 16-deep
//      half of each slab. x's L2 traffic is ceil(N/128) x M x K x 4 B:
//      13.1 MB at M = 64, 1.6 MB at M = 8, against 105 MB in the first
//      design (a 64 x 16 tile re-reading a 64 x 640 x slab per block).
//      The S blocks of one column tile form a thread-block CLUSTER: each
//      stores its fp32 partial tile (its two k halves added in a fixed
//      order) in its own shared memory, and after a cluster barrier every
//      block sums a 1/S share of the tile's rows over the S partials
//      through distributed shared memory, in split order (no atomics, no
//      round trip through device memory: two calls give the same bits),
//      then writes out = acc + s * sum_r h[m, r] * B_{ids[m]}[r, n], the
//      reference's association (packed B unpacked and dequantized in
//      registers, fp B read as floats); h's k partials are summed in
//      order once per block, while the ring fills.
// Rank-bucket padding is exact: padded A rows carry scale = zp = 0, so
// their h lanes are exact zeros that multiply finite padded-B values.
// Row ids must lie below E and R <= 128; the wrapper checks both.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHThreads = 256;      // lora_prep_kernel: 8 warps
constexpr int kTN = 128;            // columns of N a product block owns
constexpr int kWarpN = 32;          // a warp's columns: two 16-row MMA
constexpr int kWarpTiles = kWarpN / 16;   // tiles
constexpr int kColWarps = kTN / kWarpN;
constexpr int kTK = 32;             // k slab depth: a 16-deep MMA step for
constexpr int kKHalves = kTK / 16;  // each of kKHalves warp groups
constexpr int kThreads = 32 * kColWarps * kKHalves;   // 8 warps
constexpr int kStages = 4;          // slabs in the ring
constexpr int kWStride = kTN + 4;   // W slab row stride: fragment loads
                                    // hit 32 distinct banks
constexpr int kWSlab = kTK * kWStride;
constexpr int kMaxRows = 64;        // request rows a product block covers
constexpr int kMaxSplits = 8;       // the largest portable cluster
constexpr int kTargetBlocks = 264;  // product blocks: two an SM of an H100
constexpr int kMaxRank = 128;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

  // dst[r] = sum_{k0 <= k < k1} x[k] * A_{id}[k, r]; k0 is a multiple of
  // 32, so the chunk starts on a word; one warp per r
  __device__ __forceinline__ void h_chunk(const float* __restrict__ xr,
                                          int id, int k0, int k1, int K,
                                          int R, float* __restrict__ dst)
      const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int w0 = k0 / kPer, w1 = (k1 + kPer - 1) / kPer;
    for (int r = warp; r < R; r += kHThreads / 32) {
      const int64_t row = static_cast<int64_t>(id) * R + r;
      const uint32_t* words = aq + row * KW;
      const float sc = a_scale[row], zp = a_zp[row];
      float part = 0.0f;
      for (int wi = w0 + lane; wi < w1; wi += 32) {
        const uint32_t word = words[wi];
        const int kb = wi * kPer;
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          if (kb + t < k1) {
            const float lv = static_cast<float>((word >> (t * BITS)) & kMask);
            part = fmaf(xr[kb + t], (lv - zp) * sc, part);
          }
        }
      }
      part = warp_sum(part);
      if (lane == 0) dst[r] = part;
    }
  }

  // sum_{r<R} h[r] * B_{id}[r, n]
  __device__ __forceinline__ float y(const float* h, int id, int n, int N,
                                     int R) const {
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

  // dst[r] = sum_{k0 <= k < k1} x[k] * A_{id}[k, r]: the (k1 - k0, R)
  // slab is one contiguous array; thread i < G*R (G = 256 / R groups)
  // always reads r = i mod R, coalesced, then each r's G sums add in order
  __device__ __forceinline__ void h_chunk(const float* __restrict__ xr,
                                          int id, int k0, int k1, int K,
                                          int R, float* __restrict__ dst)
      const {
    __shared__ float red[kHThreads];
    const int tid = threadIdx.x;
    const int groups = kHThreads / R;
    const float* slab = a + (static_cast<int64_t>(id) * K + k0) * R;
    float part = 0.0f;
    if (tid < groups * R) {
      const int r = tid % R;
#pragma unroll 4
      for (int k = tid / R; k < k1 - k0; k += groups)
        part = fmaf(xr[k0 + k], slab[static_cast<int64_t>(k) * R + r], part);
    }
    red[tid] = part;
    __syncthreads();
    if (tid < R) {
      float v = red[tid];
      for (int q = 1; q < groups; ++q) v += red[q * R + tid];
      dst[tid] = v;
    }
  }

  __device__ __forceinline__ float y(const float* h, int id, int n, int N,
                                     int R) const {
    const float* bm = b + static_cast<int64_t>(id) * R * N + n;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r)
      acc = fmaf(h[r], bm[static_cast<int64_t>(r) * N], acc);
    return acc;
  }
};

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi, b - hi), a in
// the low half (the MMA fragment's lower-index element)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One launch of the first kernel does two jobs:
//  - blocks [0, M * h_splits): hpart (h_splits, M, R), block (m, q)
//    summing the q-th k chunk of row m;
//  - the rest: x split into the product's bf16 MMA fragments, once for
//    all blocks of the product. Entry (row tile, 16-deep k step s, 8-row
//    tile j, lane) is {hi(x[r][k], x[r][k+1]), hi(x[r][k+8], x[r][k+9]),
//    lo(...), lo(...)} with r = 8(MT * tile + j) + lane / 4 and
//    k = 16s + 2(lane % 4); rows past M and k past K are zeros, so a
//    32-deep slab of one row tile is MT KB in one piece.
template <class Source>
__global__ void __launch_bounds__(kHThreads)
lora_prep_kernel(const float* __restrict__ x, const Source src,
                 const int* __restrict__ ids, float* __restrict__ hpart,
                 uint4* __restrict__ xfrag, int M, int K, int R, int h_splits,
                 int k_chunk, int MT, int k_steps, int64_t frags) {
  griddep_launch_dependents();   // the product kernel may start streaming W
  const int nh = M * h_splits;
  if (static_cast<int>(blockIdx.x) < nh) {
    const int m = blockIdx.x % M, q = blockIdx.x / M;
    const int k0 = q * k_chunk, k1 = min(K, k0 + k_chunk);
    src.h_chunk(x + static_cast<int64_t>(m) * K, ids[m], k0, k1, K, R,
                hpart + (static_cast<int64_t>(q) * M + m) * R);
    return;
  }
  const int64_t e =
      static_cast<int64_t>(blockIdx.x - nh) * kHThreads + threadIdx.x;
  if (e >= frags) return;
  const int lane = static_cast<int>(e % 32);
  const int64_t tile_j = e / 32;
  const int j = static_cast<int>(tile_j % MT);
  const int64_t step = tile_j / MT;
  const int s = static_cast<int>(step % k_steps);
  const int64_t row = (step / k_steps * MT + j) * 8 + lane / 4;
  const int k = s * 16 + 2 * (lane % 4);
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // k, k+1, k+8, k+9
  if (row < M) {
    const float* xr = x + row * K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k + (i & 1) + (i >> 1) * 8;
      if (kk < K) v[i] = xr[kk];
    }
  }
  uint4 f;
  split2(v[0], v[1], f.x, f.z);
  split2(v[2], v[3], f.y, f.w);
  xfrag[e] = f;
}

// asynchronous global -> shared copies (sm_80+); a false `valid` copies
// no byte and zero-fills the destination
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// the same for 16 bytes (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's newest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// uint4 x fragments in one ring slot: (k half, 8-row tile, lane)
template <int MT>
__host__ __device__ constexpr int xslab_frags() {
  return kKHalves * MT * 32;
}

// bytes of the W ring (fp32) and the x-fragment ring; h (8MT x R fp32)
// follows them
template <int MT>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kWSlab * 4 + kStages * xslab_frags<MT>() * 16;
}

// out[m0 .. m0+8MT, n0 .. n0+128) for the blockIdx.z-th k range, reduced
// across the cluster (1, 1, gridDim.z). Warp w computes columns
// 32 (w % 4) .. +32 over the (w / 4)-th 16-deep half of every slab; all
// 256 threads fill the ring with cp.async, one commit group per slab,
// one block barrier per slab. VEC: N is a multiple of 4 and w is 16-byte
// aligned, so every 4-float piece of a W row lies wholly inside or
// outside. Two blocks fit on an SM (registers <= 128, shared memory
// <= 113 KB at R <= 32), so the clusters find room in one wave: with
// room for one block an SM, clusters of 6 ran in two.
template <class Source, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
lora_product_kernel(const float* __restrict__ w,
                    const uint4* __restrict__ xfrag, const Source src,
                    const int* __restrict__ ids,
                    const float* __restrict__ hpart, float* __restrict__ out,
                    int M, int K, int N, int R, int h_splits, int k_split,
                    int k_steps, float s) {
  constexpr int MC = MT * 8;
  constexpr int kXSlab = xslab_frags<MT>();
  // with few rows, one accumulator set per pass (chains enough to hide
  // the MMA latency), summed in pass order after the loop
  constexpr int kPassAcc = MT <= 2 ? 3 : 1;
  constexpr int kJB = MT >= 2 ? 2 : 1;   // 8-row tiles per MMA round
  extern __shared__ __align__(16) float smem[];
  uint4* xring = reinterpret_cast<uint4*>(smem + kStages * kWSlab);
  float* hs = smem + ring_bytes<MT>() / 4;   // h (rows, R)

  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * MC;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_slabs = (k_end - k_begin + kTK - 1) / kTK;
  const int rows = min(MC, M - m0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // the MMA fragments' indices
  const int col_warp = warp % kColWarps;  // this warp's 32 columns
  const int khalf = warp / kColWarps;     // and 16 of each slab's 32 k
  const uint4* xsrc = xfrag + (static_cast<int64_t>(blockIdx.y) * k_steps +
                               k_begin / 16) * MT * 32;

  auto issue_w = [&](int slab) {
    float* ws = smem + (slab % kStages) * kWSlab;
    const int k0 = k_begin + slab * kTK;
#pragma unroll
    for (int i = tid; i < kTK * kTN / 4; i += kThreads) {   // n fastest
      const int kk = i / (kTN / 4), nn = (i % (kTN / 4)) * 4;
      const int k = k0 + kk, n = n0 + nn;
      const float* row = w + static_cast<int64_t>(k) * N + n;
      if (VEC) {
        const bool ok = k < k_end && n < N;
        cp_async16(ws + kk * kWStride + nn, ok ? row : w, ok);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = k < k_end && n + c < N;
          cp_async4(ws + kk * kWStride + nn + c, ok ? row + c : w, ok);
        }
      }
    }
  };
  auto issue_x = [&](int slab) {
    uint4* xs = xring + (slab % kStages) * kXSlab;
    const uint4* from = xsrc + static_cast<int64_t>(slab) * kXSlab;
    for (int i = tid; i < kXSlab; i += kThreads)
      cp_async16(xs + i, from + i, true);
  };

  // W streams before the first kernel is done; x's fragments and h come
  // from it. Commit groups: W(0..S-2), X(0..S-2), then one (W, X) per
  // slab, so "all but the newest S-2 groups" always covers the slab.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_slabs) issue_w(st);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_slabs) issue_x(st);
    cp_async_commit();
  }
  // h[m, r] = its k chunks' partials summed in chunk order, spread over
  // the block (the loads overlap the ring's)
  for (int i = tid; i < rows * R; i += kThreads) {
    const int mm = i / R, r = i - mm * R;
    const float* hp = hpart + static_cast<int64_t>(m0 + mm) * R + r;
    float v = hp[0];
    for (int q = 1; q < h_splits; ++q)
      v += hp[static_cast<int64_t>(q) * M * R];
    hs[i] = v;
  }

  float acc[kPassAcc][kWarpTiles][MT][4];
#pragma unroll
  for (int p = 0; p < kPassAcc; ++p)
#pragma unroll
    for (int i = 0; i < kWarpTiles; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][j][c] = 0.0f;

  for (int slab = 0; slab < n_slabs; ++slab) {
    cp_async_wait<kStages - 2>();   // this slab has landed
    __syncthreads();                // ... for every thread; and the slot
                                    // refilled below is no longer read
    if (slab + kStages - 1 < n_slabs) {
      issue_w(slab + kStages - 1);
      issue_x(slab + kStages - 1);
    }
    cp_async_commit();
    const float* ws = smem + (slab % kStages) * kWSlab;
    const uint4* xs = xring + (slab % kStages) * kXSlab;
    // A fragments of WT: rows n (g, g + 8), columns k (2t, 2t+1, +8, +9)
    uint32_t whi[kWarpTiles][4], wlo[kWarpTiles][4];
#pragma unroll
    for (int i = 0; i < kWarpTiles; ++i) {
      const float* p = ws + (khalf * 16 + 2 * t) * kWStride +
                       col_warp * kWarpN + i * 16 + g;
      split2(p[0], p[kWStride], whi[i][0], wlo[i][0]);
      split2(p[8], p[kWStride + 8], whi[i][1], wlo[i][1]);
      split2(p[8 * kWStride], p[9 * kWStride], whi[i][2], wlo[i][2]);
      split2(p[8 * kWStride + 8], p[9 * kWStride + 8], whi[i][3],
             wlo[i][3]);
    }
    // the three passes over kJB 8-row tiles at a time, each pass issued
    // across all kJB x kWarpTiles accumulators before the next
#pragma unroll
    for (int j0 = 0; j0 < MT; j0 += kJB) {
      uint4 v[kJB];   // B fragments {xhi (2), xlo (2)}
#pragma unroll
      for (int jj = 0; jj < kJB; ++jj)
        v[jj] = xs[(khalf * MT + j0 + jj) * 32 + lane];
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int jj = 0; jj < kJB; ++jj)
#pragma unroll
          for (int i = 0; i < kWarpTiles; ++i)
            mma_bf16(acc[pass % kPassAcc][i][j0 + jj],
                     pass == 0 ? wlo[i] : whi[i],
                     pass == 1 ? v[jj].z : v[jj].x,
                     pass == 1 ? v[jj].w : v[jj].y);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the partial tile
#pragma unroll
  for (int p = 1; p < kPassAcc; ++p)
#pragma unroll
    for (int i = 0; i < kWarpTiles; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[0][i][j][c] += acc[p][i][j][c];

  // this split's partial tile, part[m][n] (fp32): the second k half's
  // sums, then the first half's added to them (a fixed order)
  float* part = smem;
#pragma unroll
  for (int half = kKHalves - 1; half >= 0; --half) {
    if (khalf == half) {
#pragma unroll
      for (int i = 0; i < kWarpTiles; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int nl = col_warp * kWarpN + i * 16 + g, ml = j * 8 + 2 * t;
          float* d = part + ml * kWStride + nl;
          const float* a = acc[0][i][j];
          const bool first = half == kKHalves - 1;
          d[0] = first ? a[0] : a[0] + d[0];
          d[kWStride] = first ? a[1] : a[1] + d[kWStride];
          d[8] = first ? a[2] : a[2] + d[8];
          d[kWStride + 8] = first ? a[3] : a[3] + d[kWStride + 8];
        }
    }
    __syncthreads();
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial tile is in place

  // this block's share of the tile's rows, a column a thread: the S
  // partials in split order, then the adapter term
  const int share = (rows + splits - 1) / splits;
  const int r1 = min(rows, (split + 1) * share);
  const int nl = tid % kTN, n = n0 + nl;
  if (n < N) {
#pragma unroll 2
    for (int mm = split * share + tid / kTN; mm < r1;
         mm += kThreads / kTN) {
      float* mine = part + mm * kWStride + nl;
      float v = *cluster.map_shared_rank(mine, 0);
      for (int q = 1; q < splits; ++q)
        v += *cluster.map_shared_rank(mine, q);
      const int m = m0 + mm;
      out[static_cast<int64_t>(m) * N + n] =
          v + s * src.y(hs + mm * R, ids[m], n, N, R);
    }
  }
  cluster.sync();   // no block leaves while another reads its partial
}

template <class Source, int MT, bool VEC>
cudaError_t launch_product(const float* w, const uint4* xfrag,
                           const Source& src, const int* ids,
                           const float* hpart, float* out, int M, int K,
                           int N, int R, int h_splits, int k_steps, float s,
                           cudaStream_t st) {
  constexpr int MC = MT * 8;
  auto kernel = lora_product_kernel<Source, MT, VEC>;
  static_assert(kStages * kWSlab >= MC * kWStride,
                "the W ring holds the epilogue's partial tile");
  const int smem = ring_bytes<MT>() + MC * R * 4;
  // the shared-memory opt-in for the largest rank, once per device (it
  // costs a CUDA runtime call)
  static bool opted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring_bytes<MT>() + MC * kMaxRank * 4);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  const int n_tiles = (N + kTN - 1) / kTN;
  const int m_tiles = (M + MC - 1) / MC;
  const int slabs = (K + kTK - 1) / kTK;
  int splits = kTargetBlocks / (n_tiles * m_tiles);
  splits = max(1, min(splits, min(kMaxSplits, slabs)));
  const int k_split = ((slabs + splits - 1) / splits) * kTK;
  splits = (K + k_split - 1) / k_split;   // no empty split

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, m_tiles, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = splits;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, w, xfrag, src, ids, hpart, out, M,
                            K, N, R, h_splits, k_split, k_steps, s);
}

template <class Source, int MT>
cudaError_t launch_product_mt(const float* w, const uint4* xfrag,
                              const Source& src, const int* ids,
                              const float* hpart, float* out, int M, int K,
                              int N, int R, int h_splits, int k_steps,
                              float s, cudaStream_t st) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_product<Source, MT, true>(w, xfrag, src, ids, hpart,
                                                out, M, K, N, R, h_splits,
                                                k_steps, s, st)
             : launch_product<Source, MT, false>(w, xfrag, src, ids, hpart,
                                                 out, M, K, N, R, h_splits,
                                                 k_steps, s, st);
}

template <class Source>
int launch(const float* x, const float* w, const Source& src, const int* ids,
           float* hpart, uint4* xfrag, float* out, int M, int K, int N,
           int R, int h_splits, int h_chunk, int MT, float s,
           cudaStream_t st) {
  const int k_steps = (K + kTK - 1) / kTK * kKHalves;
  const int m_tiles = (M + MT * 8 - 1) / (MT * 8);
  const int64_t frags = static_cast<int64_t>(m_tiles) * k_steps * MT * 32;
  const int64_t blocks =
      static_cast<int64_t>(M) * h_splits + (frags + kHThreads - 1) / kHThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  lora_prep_kernel<Source><<<static_cast<unsigned>(blocks), kHThreads, 0,
                             st>>>(x, src, ids, hpart, xfrag, M, K, R,
                                   h_splits, h_chunk, MT, k_steps, frags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (MT) {
    case 1:
      err = launch_product_mt<Source, 1>(w, xfrag, src, ids, hpart, out, M,
                                         K, N, R, h_splits, k_steps, s, st);
      break;
    case 2:
      err = launch_product_mt<Source, 2>(w, xfrag, src, ids, hpart, out, M,
                                         K, N, R, h_splits, k_steps, s, st);
      break;
    case 4:
      err = launch_product_mt<Source, 4>(w, xfrag, src, ids, hpart, out, M,
                                         K, N, R, h_splits, k_steps, s, st);
      break;
    default:
      err = launch_product_mt<Source, 8>(w, xfrag, src, ids, hpart, out, M,
                                         K, N, R, h_splits, k_steps, s, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the checks both entries share: h_chunk a positive multiple of 32 that
// the h_splits chunks need all of; MT the 8-row tiles of the row tile,
// 8 * MT the least power of two >= M, from 8 to 64
bool bad_shape(int M, int K, int R, int h_splits, int h_chunk, int MT) {
  const int rows = min(max(M, 1), kMaxRows);
  int want = 1;
  while (want * 8 < rows) want *= 2;
  return R < 1 || R > kMaxRank || K < 1 || h_splits < 1 || h_chunk < 1 ||
         h_chunk % 32 != 0 ||
         static_cast<int64_t>(h_splits) * h_chunk < K ||
         static_cast<int64_t>(h_splits - 1) * h_chunk >= K || MT != want;
}

}  // namespace

// x (M, K), w (K, N) fp32; aq (E, R, KW) uint32, a_scale/a_zp (E, R);
// bq (E, N, RW) uint32, b_scale/b_zp (E, N); ids (M,) int32 < E; scratch
// hpart (h_splits, M, R) fp32 for h's k chunks of h_chunk levels (a
// multiple of 32) and xfrag (ceil(M / 8MT) * 8MT * ceil(K / 32) * 32)
// fp32-sized words for x's MMA fragments, MT = the 8-row tiles of a row
// tile; out (M, N) fp32; R <= 128. Returns cudaGetLastError() after the
// launches.
extern "C" int multi_lora_matmul_q_launch(
    const float* x, const float* w, const uint32_t* aq, const float* a_scale,
    const float* a_zp, const uint32_t* bq, const float* b_scale,
    const float* b_zp, const int* ids, float* hpart, void* xfrag, float* out,
    int M, int K, int N, int R, int KW, int RW, int bits, int h_splits,
    int h_chunk, int MT, float s, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bad_shape(M, K, R, h_splits, h_chunk, MT))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint4* xf = static_cast<uint4*>(xfrag);
  switch (bits) {
    case 2:
      return launch(x, w, PackedSource<2>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, hpart, xf, out, M, K, N, R, h_splits, h_chunk, MT,
                    s, st);
    case 4:
      return launch(x, w, PackedSource<4>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, hpart, xf, out, M, K, N, R, h_splits, h_chunk, MT,
                    s, st);
    case 8:
      return launch(x, w, PackedSource<8>{aq, a_scale, a_zp, bq, b_scale,
                                          b_zp, KW, RW},
                    ids, hpart, xf, out, M, K, N, R, h_splits, h_chunk, MT,
                    s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (M, K), w (K, N), a (E, K, R), b (E, R, N) fp32; ids (M,) int32 < E;
// scratch hpart and xfrag as above; out (M, N) fp32; R <= 128. Returns
// cudaGetLastError() after the launches.
extern "C" int multi_lora_matmul_launch(const float* x, const float* w,
                                        const float* a, const float* b,
                                        const int* ids, float* hpart,
                                        void* xfrag, float* out, int M, int K,
                                        int N, int R, int h_splits,
                                        int h_chunk, int MT, float s,
                                        void* stream) {
  cudaGetLastError();
  if (bad_shape(M, K, R, h_splits, h_chunk, MT))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  return launch(x, w, FpSource{a, b}, ids, hpart, static_cast<uint4*>(xfrag),
                out, M, K, N, R, h_splits, h_chunk, MT, s,
                static_cast<cudaStream_t>(stream));
}
