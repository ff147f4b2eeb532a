// Single-adapter LoRA matmul for Hopper (sm_90a):
//
//   y = x @ W + s * bf16(x @ a) @ b
//
// x (M, K), W (K, N), a (K, r), b (r, N) bf16, row-major; y (M, N) bf16,
// every product accumulated in fp32. Any M, K, N and r >= 1.
//
// Replaces the Pallas TPU kernel `lora_matmul_pallas` (body
// `_lora_matmul_kernel`) in src/repro/kernels/lora_matmul.py. h = x @ a is
// summed over all of K in fp32 and rounded to bf16 ONCE, as the plain
// version `lora_matmul_ref` in ref.py does, and the low-rank term keeps
// its own accumulator: y = acc + s * low (no s folded into h or b).
//
// What bounds it: operations. At (M, K, N, r) = (512, 2560, 2560, 32) it
// does 2MKN + 2MKr + 2MrN + 2MN = 6.881 GFLOP, 6.96 us at 989 TFLOP/s
// bf16, and must move x, W, a, b and y once, 18,677,760 B, 5.6 us at
// 3.35 TB/s.
//
// The TMA path (K, N, r multiples of 8, r <= 128, 16-byte aligned
// operands) is ONE
// kernel, `lora_wgmma_kernel<RP>`, a warp-specialised wgmma GEMM with h in
// its mainloop, as the TPU kernel computes it:
//   - a producer warp keeps a ring of 4-6 shared-memory stages (as many
//     as fit) full with TMA loads (cp.async.bulk.tensor) that complete
//     on mbarriers: x's 128 x 64 tile (K-major, 128-byte swizzle), W's
//     64 x 80 tile as a 64-column box (128-byte swizzle) and a 16-column
//     box (32-byte swizzle), and a's 64 x RP tile; W (K, N) and a (K, r)
//     row-major are MN-major for B, which 16-bit wgmma reads directly: no
//     transposed copy;
//   - two consumer warpgroups, 64 rows each, run wgmma.mma_async (bf16 in,
//     fp32 accumulators in registers): m64n64k16 + m64n16k16 for x @ W and
//     m64nRPk16 for x @ a, r padded to RP in {32, 64, 128} by TMA's zeros;
//   - after the last K stage each thread rounds its h accumulator to bf16
//     in registers, already in the layout of wgmma's A operand, and b's
//     rows stream through the ring for h @ b (wgmma with A from registers)
//     into a second accumulator; y = acc + s * low is written as bf16
//     through shared memory with 16-byte stores.
//
// Tile choice for 132 SMs: 128 x 128 tiles would give 80 blocks at the
// full-width shape (52 SMs idle); 128 x 80 gives 4 x 32 = 128 blocks, one
// wave. L2 traffic at that shape: x is read by 32 column tiles, 32 x 2.62
// MB = 83.9 MB; W by 4 row tiles, 4 x 13.1 MB = 52.4 MB; a by 128 blocks,
// 21 MB; 157 MB in all (the earlier 64 x 64 WMMA tile read ~210 MB). What
// limits the mainloop on the card is the number of TMA box rows a stage
// more than the bytes: W in five 32-byte-wide boxes was much slower than
// in one 128-byte-wide box and one 32-byte box, and a cluster of 2
// multicasting x (half the x traffic) was no faster.
//
// Design (a), h once in a separate split-K kernel launched ahead of the
// GEMM as its programmatic dependent, was measured too: its GEMM alone
// was faster than this kernel, but h cost a second launch (6.5 us on an
// H100 by the profiler) that
// did not overlap the GEMM on the card, and the call was no faster than
// this one. Design (b) recomputes h in every column tile (r/80 more
// tensor work) in exchange for one launch and no h in device memory.
//
// The masked path (any other shape) runs two kernels: `lora_h_kernel`,
// h = bf16(x @ a) on a 64 x 64 WMMA (mma.sync) tile per block with K
// split over a thread-block cluster (<= 8) and the splits' fp32 partials
// summed in distributed shared memory in split order; then
// `lora_tile_kernel`, a 64 x 64 WMMA tile of y whose loads zero-fill
// ragged edges. Still on the card; never the plain version.
//
// Ranks above 128 (more than the wgmma path's m64nRP accumulator holds)
// take the masked path too, which has no rank limit: the h kernel's grid
// walks r in 64-wide column tiles, each element of h summed over all of K
// and rounded to bf16 once, and the tile kernel adds h @ b over r in
// 64-deep slabs into ONE fp32 accumulator, so y is rounded to bf16 once,
// after the last rank chunk, as the plain version does.
//
// The wrapper (ops.lora_plan) picks the path from shapes and alignment
// alone and passes it here; this file checks it. No atomics: repeated
// calls give identical bits.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// The WMMA tile loop (h's split-K partials, and the masked path's tile)
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;      // 4 warps, 2 x 2, each 32 x 32
constexpr int kPad = 8;            // bf16 row padding (keeps 32-byte rows)
constexpr int kLdA = kBK + kPad;   // A slab: kBM x kBK
constexpr int kLdB = kBN + kPad;   // B slab: kBK x kBN
constexpr int kLdC = kBN + 4;      // fp32 epilogue tile
constexpr int kChunks = kBM * kBK / 8 / kThreads;  // 8-element chunks/thread
constexpr int kMaxSplits = 8;      // the largest portable cluster

static_assert(kBM * kBK == kBK * kBN, "A and B slabs hold as many chunks");

// Eight consecutive bf16 of row `row` from column `col` of a (rows, cols)
// row-major matrix with leading dimension `ld`; zeros past either edge.
// `vec` says 16-byte loads are safe (ld % 8 == 0 and an aligned base).
__device__ __forceinline__ uint4 load_chunk(const bf16* __restrict__ src,
                                            int64_t ld, int rows, int cols,
                                            int row, int col, bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return out;
  const bf16* p = src + static_cast<int64_t>(row) * ld + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 v;
    bf16 e[8];
  } tmp;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    tmp.e[e] = col + e < cols ? p[e] : __float2bfloat16(0.0f);
  }
  return tmp.v;
}

struct Slab {
  uint4 a[kChunks];
  uint4 b[kChunks];
};

// Global loads of the A slab (rows m0.., cols k0..) and the B slab (rows
// k0.., cols n0..) into registers.
__device__ __forceinline__ void fetch(Slab& sl, const bf16* __restrict__ A,
                                      int lda, const bf16* __restrict__ B,
                                      int ldb, int m_rows, int n_cols,
                                      int k_dim, int m0, int n0, int k0,
                                      bool vec_a, bool vec_b) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int ar = q / (kBK / 8), ac = (q % (kBK / 8)) * 8;
    sl.a[i] = load_chunk(A, lda, m_rows, k_dim, m0 + ar, k0 + ac, vec_a);
    const int br = q / (kBN / 8), bc = (q % (kBN / 8)) * 8;
    sl.b[i] = load_chunk(B, ldb, k_dim, n_cols, k0 + br, n0 + bc, vec_b);
  }
}

__device__ __forceinline__ void stage(const Slab& sl, bf16* As, bf16* Bs) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int ar = q / (kBK / 8), ac = (q % (kBK / 8)) * 8;
    *reinterpret_cast<uint4*>(As + ar * kLdA + ac) = sl.a[i];
    const int br = q / (kBN / 8), bc = (q % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + br * kLdB + bc) = sl.b[i];
  }
}

using FragA =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void warp_origin(int& wm, int& wn) {
  const int warp = threadIdx.x >> 5;
  wm = (warp >> 1) * 32;
  wn = (warp & 1) * 32;
}

// acc += A[m0:m0+64, k_begin:k_end] @ B[k_begin:k_end, n0:n0+64] over
// 64-deep slabs (k_begin a multiple of 8), the next slab's loads in
// flight while the current one multiplies; zeros past k_end.
__device__ void gemm_tile(FragC (&acc)[2][2], const bf16* __restrict__ A,
                          int lda, const bf16* __restrict__ B, int ldb,
                          int m_rows, int n_cols, int k_begin, int k_end,
                          int m0, int n0, bool vec_a, bool vec_b, bf16* As,
                          bf16* Bs) {
  int wm, wn;
  warp_origin(wm, wn);
  Slab sl;
  fetch(sl, A, lda, B, ldb, m_rows, n_cols, k_end, m0, n0, k_begin, vec_a,
        vec_b);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    stage(sl, As, Bs);
    __syncthreads();
    if (k0 + kBK < k_end) {
      fetch(sl, A, lda, B, ldb, m_rows, n_cols, k_end, m0, n0, k0 + kBK,
            vec_a, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * kLdA + kk, kLdA);
        wmma::load_matrix_sync(fb[i], Bs + kk * kLdB + wn + 16 * i, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j],
                                                   acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
}

// ---------------------------------------------------------------------------
// 1. h = bf16(x @ a): split-K over a cluster, summed in distributed shared
//    memory in split order
// ---------------------------------------------------------------------------

// Grid (ceil(r/64), ceil(M/64), splits), cluster (1, 1, splits): block z
// sums x[:, z*k_chunk : (z+1)*k_chunk] @ a[that range] into its own
// shared fp32 tile; then block z rounds its share of the tile's rows,
// adding the splits' tiles in order 0, 1, ..., splits-1.
__global__ void __launch_bounds__(kThreads)
lora_h_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
              bf16* __restrict__ h, int m_rows, int k_dim, int r_dim,
              int k_chunk, bool vec_x, bool vec_a) {
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k_dim, k_begin + k_chunk);
  int wm, wn;
  warp_origin(wm, wn);
  FragC acc[2][2];
  zero(acc);
  gemm_tile(acc, x, k_dim, a, r_dim, m_rows, r_dim, k_begin, k_end, m0, n0,
            vec_x, vec_a, As, Bs);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial tile is in place
  const int splits = gridDim.z;
  const int rows = (kBM + splits - 1) / splits;
  const int r_lo = blockIdx.z * rows;
  const int r_hi = min(kBM, r_lo + rows);
  for (int q = threadIdx.x; q < (r_hi - r_lo) * kBN; q += kThreads) {
    const int row = r_lo + q / kBN, col = q % kBN;
    if (m0 + row >= m_rows || n0 + col >= r_dim) continue;
    float* mine = Cs + row * kLdC + col;
    float part[kMaxSplits];   // every remote read in flight, then the sum
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      if (z < splits) part[z] = *cluster.map_shared_rank(mine, z);
    }
    float v = part[0];
#pragma unroll
    for (int z = 1; z < kMaxSplits; ++z) {
      if (z < splits) v += part[z];
    }
    h[static_cast<int64_t>(m0 + row) * r_dim + n0 + col] =
        __float2bfloat16(v);
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// 2. the TMA path: a warp-specialised wgmma GEMM with the low-rank epilogue
// ---------------------------------------------------------------------------

constexpr int kTM = 128;                 // tile rows: two consumer warpgroups
constexpr int kTN = 80;                  // tile columns: a 64- and a 16-wide part
constexpr int kTNw = 64;                 // the 128-byte swizzled part of B
constexpr int kTNn = kTN - kTNw;         // the 32-byte swizzled part of B
constexpr int kTK = 64;                  // K depth a stage (128 B of bf16)
constexpr int kABytes = kTM * kTK * 2;   // 16,384
constexpr int kBwBytes = kTK * kTNw * 2; // 8,192
constexpr int kBnBytes = kTK * kTNn * 2; // 2,048
constexpr int kOutLd = kTN + 8;          // bf16 output tile pitch (176 B)
constexpr int kOutBytes = kTM * kOutLd * 2;
constexpr int kWgThreads = 384;          // 2 consumer warpgroups + producer
constexpr int kConsumerWarps = 8;
constexpr int kAcc = kTN / 2;            // fp32 accumulators a thread

// The adapter rank is padded to RP in {32, 64, 128} (TMA fills the padding
// with zeros). A stage holds x's tile, W's wide and narrow column parts
// and a's (64 x RP) tile; the ring has as many stages as fit in a block's
// 227 KB beside the output tile, at most 6: 6, 5 and 4 at RP = 32, 64,
// 128.
template <int RP>
struct Shape {
  static constexpr int kATileBytes = kTK * RP * 2;
  static constexpr int kStageBytes = kABytes + kBwBytes + kBnBytes +
                                     kATileBytes;
  static constexpr int kFit =
      (232448 - 1024 - kOutBytes - 2 * 6 * 8) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes +
                               2 * kStages * 8;
  static constexpr int kLowIters = (RP + kTK - 1) / kTK;   // b's stages
  static_assert(kStageBytes % 1024 == 0 &&
                    (kABytes + kBwBytes + kBnBytes) % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1 = 128 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

// A: 64 rows of 128-byte K-major rows, 128-byte swizzle: 8-row groups
// 1024 B apart; a 16-deep k step moves 32 B along the row.
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 32, 16, 1024, 1);
}

// B's 64 wide columns: one box of 64 K rows x 128 B, MN-major, 128-byte
// swizzle: 8-row groups 1024 B apart (stride); one 64-column atom, so the
// leading offset is unused; a 16-deep k step moves 16 rows of 128 B.
__device__ __forceinline__ uint64_t desc_bw(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 2048, kBwBytes, 1024, 1);
}

// B's last 16 columns: one box of 64 K rows x 32 B, 32-byte swizzle:
// 8-row groups 256 B apart; a 16-deep k step moves 16 rows of 32 B.
__device__ __forceinline__ uint64_t desc_bn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 512, kBnBytes, 256, 3);
}

// a's tile: 64 K rows x RP columns, MN-major. RP = 32: one 64-byte
// swizzled box (8-row groups 512 B apart, a k step 16 rows of 64 B);
// otherwise 128-byte swizzled boxes of 64 columns, 8192 B apart
// (leading), 8-row groups 1024 B apart, a k step 16 rows of 128 B.
template <int RP>
__device__ __forceinline__ uint64_t desc_at(uint32_t tile, int kk) {
  if constexpr (RP == 32) {
    return gmma_desc(tile + kk * 1024, kTK * 64, 512, 2);
  } else {
    return gmma_desc(tile + kk * 2048, kTK * 128, 1024, 1);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (this warpgroup's 64 x 64 fp32 fragment) += A (64 x 16) @ B (16 x 64),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a,
                                                uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (this warpgroup's 64 x 16 fp32 fragment) += A (64 x 16) @ B (16 x 16),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n16k16(float* d, uint64_t desc_a,
                                                uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (this warpgroup's 64 x 32 fp32 fragment) += A (64 x 16) @ B (16 x 32),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t desc_a,
                                                uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (this warpgroup's 64 x 128 fp32 fragment) += A (64 x 16) @ B (16 x 128),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, this thread's four registers of
// the fragment) @ B (16 x 64), B MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                   uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 16 fp32) += A (64 x 16 bf16, this thread's four registers of
// the fragment) @ B (16 x 16), B MN-major.
__device__ __forceinline__ void wgmma_rs_m64n16k16(float* d, const uint32_t* a,
                                                   uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int RP>
__device__ __forceinline__ void wgmma_xa(float* d, uint64_t desc_a,
                                        uint64_t desc_b) {
  if constexpr (RP == 32) {
    wgmma_m64n32k16(d, desc_a, desc_b);
  } else if constexpr (RP == 64) {
    wgmma_m64n64k16(d, desc_a, desc_b);
  } else {
    wgmma_m64n128k16(d, desc_a, desc_b);
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The mainloop: `count` stages of x's, W's and a's tiles. acc (the m64n80
// fragment: columns 0-63 from W's wide part, 64-79 from its narrow part)
// += x_k @ W_k and hacc (m64nRP) += x_k @ a_k, four 16-deep k steps a
// stage (past K the tiles hold TMA's zeros). The previous stage is
// released once the next is issued, so one wgmma group stays in flight.
// The accumulators are written by the asynchronous wgmma: fence_regs
// ties every access to the issue and the wait.
template <int RP>
__device__ __forceinline__ void mainloop(float (&acc)[kAcc],
                                         float (&hacc)[RP / 2],
                                         Ring<Shape<RP>::kStages>& ring,
                                         int count, uint32_t base,
                                         uint32_t full, uint32_t empty,
                                         int wg, int lane) {
  constexpr int kStageBytes = Shape<RP>::kStageBytes;
  int prev = -1;
  for (int i = 0; i < count; ++i) {
    const int s = ring.stage;
    mbar_wait(full + 8 * s, ring.phase);
    const uint32_t a = base + s * kStageBytes + wg * (kABytes / 2);
    const uint32_t bw = base + s * kStageBytes + kABytes;
    const uint32_t bn = bw + kBwBytes;
    const uint32_t at = bn + kBnBytes;
    fence_regs(acc);
    fence_regs(hacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      const uint64_t da = desc_a(a, kk);
      wgmma_m64n64k16(acc, da, desc_bw(bw, kk));
      wgmma_m64n16k16(acc + kTNw / 2, da, desc_bn(bn, kk));
      wgmma_xa<RP>(hacc, da, desc_at<RP>(at, kk));
    }
    wgmma_commit();
    fence_regs(acc);
    fence_regs(hacc);
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = s;
    ring.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(hacc);
  if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
}

// One kernel a call (design (b)): grid (ceil(N/80), ceil(M/128)); warps
// 0-7 two consumer warpgroups, warp 8 the producer.
template <int RP>
__global__ void __launch_bounds__(kWgThreads, 1)
lora_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_ww,
                  const __grid_constant__ CUtensorMap tm_wn,
                  const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_bw,
                  const __grid_constant__ CUtensorMap tm_bn,
                  bf16* __restrict__ y, int m_rows, int k_dim, int n_cols,
                  float s) {
  using S = Shape<RP>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // stage s at base + s*kStageBytes: x's tile, W's wide and narrow parts
  // (b's in the low-rank stages), a's tile
  bf16* out_tile = reinterpret_cast<bf16*>(gbase + kStages * S::kStageBytes);
  const uint32_t full = base + kStages * S::kStageBytes + kOutBytes;
  const uint32_t empty = full + 8 * kStages;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int k_iters = (k_dim + kTK - 1) / kTK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    if (threadIdx.x == 256) {
      Ring<kStages> ring;
      for (int it = 0; it < k_iters + S::kLowIters; ++it) {
        const int st = ring.stage;
        mbar_wait(empty + 8 * st, ring.phase ^ 1u);
        const uint32_t bar = full + 8 * st;
        const uint32_t a = base + st * S::kStageBytes, bw = a + kABytes;
        if (it < k_iters) {
          const int k0 = it * kTK;
          mbar_expect_tx(bar, S::kStageBytes);
          tma_load(a, &tm_x, bar, k0, m0);
          tma_load(bw, &tm_ww, bar, n0, k0);
          tma_load(bw + kBwBytes, &tm_wn, bar, n0 + kTNw, k0);
          const uint32_t at = bw + kBwBytes + kBnBytes;
#pragma unroll
          for (int j = 0; j < (RP == 32 ? 1 : RP / 64); ++j) {
            tma_load(at + j * kTK * 128, &tm_a, bar, 64 * j, k0);
          }
        } else {
          const int k0 = (it - k_iters) * kTK;   // b's rows
          mbar_expect_tx(bar, kBwBytes + kBnBytes);
          tma_load(bw, &tm_bw, bar, n0, k0);
          tma_load(bw + kBwBytes, &tm_bn, bar, n0 + kTNw, k0);
        }
        ring.next();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64*wg .. +63
  float acc[kAcc], hacc[RP / 2], low[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc[i] = 0.0f;
    low[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) hacc[i] = 0.0f;
  Ring<kStages> ring;
  mainloop<RP>(acc, hacc, ring, k_iters, base, full, empty, wg, lane);

  // h = bf16(x @ a), summed over all of K, as wgmma A fragments: k chunk j
  // of the m64nRP accumulator is registers 8j .. 8j+7 in the m64k16 A
  // fragment's order, paired low half first
  uint32_t hfrag[RP / 16][4];
#pragma unroll
  for (int j = 0; j < RP / 16; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(hacc[8 * j + 2 * q], hacc[8 * j + 2 * q + 1]);
      hfrag[j][q] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  // low = bf16(h) @ b: b's rows stream through the ring, 64 a stage
#pragma unroll
  for (int c = 0; c < S::kLowIters; ++c) {
    const int st = ring.stage;
    mbar_wait(full + 8 * st, ring.phase);
    const uint32_t bw = base + st * S::kStageBytes + kABytes;
    fence_regs(low);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      if (4 * c + kk < RP / 16) {
        wgmma_rs_m64n64k16(low, hfrag[4 * c + kk], desc_bw(bw, kk));
        wgmma_rs_m64n16k16(low + kTNw / 2, hfrag[4 * c + kk],
                           desc_bn(bw + kBwBytes, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(low);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    ring.next();
  }

  // epilogue: y = acc + s * low as bf16, through shared memory. Thread
  // (warp, g = lane/4, c = lane%4) holds rows 16*warp + g and + 8, columns
  // 8i + 2c and + 1 of the m64n80 fragment.
  const int t = threadIdx.x % 128;
  const int warp = t / 32, g = lane / 4, c = lane % 4;
  bf16* tile = out_tile + wg * 64 * kOutLd;
#pragma unroll
  for (int i = 0; i < kTN / 8; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;
      const int col = 8 * i + 2 * c;
      const float v0 = acc[4 * i + 2 * half] + s * low[4 * i + 2 * half];
      const float v1 = acc[4 * i + 2 * half + 1] + s * low[4 * i + 2 * half + 1];
      *reinterpret_cast<__nv_bfloat162*>(tile + row * kOutLd + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int kChunksRow = kTN / 8;
  for (int q = t; q < 64 * kChunksRow; q += 128) {
    const int row = q / kChunksRow, cc = q % kChunksRow;
    const int gm = m0 + 64 * wg + row, gn = n0 + 8 * cc;
    if (gm < m_rows && gn < n_cols) {
      *reinterpret_cast<uint4*>(y + static_cast<int64_t>(gm) * n_cols + gn) =
          *reinterpret_cast<const uint4*>(tile + row * kOutLd + 8 * cc);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the masked path: y = x @ W + s * h @ b on a 64 x 64 WMMA tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lora_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ h, const bf16* __restrict__ b,
                 bf16* __restrict__ y, int m_rows, int k_dim, int n_cols,
                 int r_dim, float s, bool vec_x, bool vec_w, bool vec_h,
                 bool vec_b) {
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int wm, wn;
  warp_origin(wm, wn);

  FragC acc[2][2], low[2][2];
  zero(acc);
  zero(low);
  gemm_tile(acc, x, k_dim, w, n_cols, m_rows, n_cols, 0, k_dim, m0, n0,
            vec_x, vec_w, As, Bs);
  gemm_tile(low, h, r_dim, b, n_cols, m_rows, n_cols, 0, r_dim, m0, n0,
            vec_h, vec_b, As, Bs);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) {
        acc[i][j].x[t] = acc[i][j].x[t] + s * low[i][j].x[t];
      }
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kBM * kBN; q += kThreads) {
    const int r = q / kBN, c = q % kBN;
    if (m0 + r < m_rows && n0 + c < n_cols) {
      y[static_cast<int64_t>(m0 + r) * n_cols + n0 + c] =
          __float2bfloat16(Cs[r * kLdC + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the CUDA
// runtime's entry-point query (no link against libcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D tensor map of a (rows, cols) row-major bf16 matrix, boxes of
// (box_rows, box_cols), zeros past its edges.
bool tensor_map(CUtensorMap* tm, const bf16* p, int rows, int cols,
                int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_h(const bf16* x, const bf16* a, bf16* h, int m, int k,
                     int r, int splits, int k_chunk, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((r + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lora_h_kernel, x, a, h, m, k, r, k_chunk,
                            k % 8 == 0 && aligned16(x),
                            r % 8 == 0 && aligned16(a));
}

template <int RP>
cudaError_t launch_wgmma(const bf16* x, const bf16* w, const bf16* a,
                         const bf16* b, bf16* y, int m, int k, int n, int r,
                         float s, cudaStream_t st) {
  using S = Shape<RP>;
  static bool opted[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(lora_wgmma_kernel<RP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmem);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tm_x, tm_ww, tm_wn, tm_a, tm_bw, tm_bn;
  if (!tensor_map(&tm_x, x, m, k, kTM, kTK, sw128) ||
      !tensor_map(&tm_ww, w, k, n, kTK, kTNw, sw128) ||
      !tensor_map(&tm_wn, w, k, n, kTK, kTNn, sw32) ||
      !tensor_map(&tm_a, a, k, r, kTK, RP == 32 ? 32 : 64,
                  RP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : sw128) ||
      !tensor_map(&tm_bw, b, r, n, kTK, kTNw, sw128) ||
      !tensor_map(&tm_bn, b, r, n, kTK, kTNn, sw32)) {
    return cudaErrorInvalidValue;
  }
  lora_wgmma_kernel<RP>
      <<<dim3((n + kTN - 1) / kTN, (m + kTM - 1) / kTM), kWgThreads,
         S::kSmem, st>>>(tm_x, tm_ww, tm_wn, tm_a, tm_bw, tm_bn, y, m, k, n,
                         s);
  return cudaGetLastError();
}

cudaError_t launch_masked(const bf16* x, const bf16* w, const bf16* h,
                          const bf16* b, bf16* y, int m, int k, int n, int r,
                          float s, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  lora_tile_kernel<<<grid, kThreads, 0, st>>>(
      x, w, h, b, y, m, k, n, r, s, k % 8 == 0 && aligned16(x),
      n % 8 == 0 && aligned16(w), r % 8 == 0 && aligned16(h),
      n % 8 == 0 && aligned16(b));
  return cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), a (K, r), b (r, N) bf16 row-major; y (M, N) bf16.
// `path` 1 enqueues the TMA + wgmma kernel (K, N, r multiples of 8,
// r <= 128, every base 16-byte aligned: checked here); `path` 0 (any
// r >= 1) enqueues h's kernel, into
// the (M, r) bf16 scratch h, in `splits` (<= 8) K chunks of `k_chunk` (a
// multiple of 64, no chunk empty), then the masked WMMA tile. h is unused
// on path 1 and may be null there. Returns cudaGetLastError() after the
// launches.
extern "C" int lora_matmul_launch(const bf16* x, const bf16* w, const bf16* a,
                                  const bf16* b, bf16* h, bf16* y, int m,
                                  int k, int n, int r, int splits,
                                  int k_chunk, int path, float s,
                                  void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (r < 1 || k < 1 || splits < 1 || splits > kMaxSplits ||
      k_chunk % kBK != 0 || static_cast<int64_t>(splits) * k_chunk < k ||
      static_cast<int64_t>(splits - 1) * k_chunk >= k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tma = k % 8 == 0 && n % 8 == 0 && r % 8 == 0 && r <= 128 &&
                   aligned16(x) && aligned16(w) && aligned16(a) &&
                   aligned16(b) && aligned16(h) && aligned16(y);
  if ((path == 0 && h == nullptr) || (path != 0 && (path != 1 || !tma))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (path == 1) {
    err = r <= 32   ? launch_wgmma<32>(x, w, a, b, y, m, k, n, r, s, st)
          : r <= 64 ? launch_wgmma<64>(x, w, a, b, y, m, k, n, r, s, st)
                    : launch_wgmma<128>(x, w, a, b, y, m, k, n, r, s, st);
  } else {
    err = launch_h(x, a, h, m, k, r, splits, k_chunk, st);
    if (err == cudaSuccess) {
      err = launch_masked(x, w, h, b, y, m, k, n, r, s, st);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
