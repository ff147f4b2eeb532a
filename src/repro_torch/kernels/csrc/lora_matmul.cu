// Single-adapter LoRA matmul for Hopper (sm_90a):
//
//   y = x @ W + s * (x @ a) @ b
//
// x (M, K), W (K, N), a (K, r), b (r, N) bf16, row-major; y (M, N) bf16,
// every product accumulated in fp32. Any M, K, N; r <= 128.
//
// Replaces the Pallas TPU kernel `lora_matmul_pallas` (body
// `_lora_matmul_kernel`) in src/repro/kernels/lora_matmul.py. On the TPU
// each (bm, bn, bk) grid step adds x_k @ w_k + s * bf16(x_k @ a_k) @ b_n
// into an fp32 block resident in VMEM, so the low-rank side is recomputed
// in every N tile, cheaply next to the MXU product, and the wrapper pads r
// up to 128 lanes. Here neither is carried over:
//
//   1. h = x @ a is computed ONCE per call in fp32 and rounded to bf16
//      once (the plain version `lora_matmul_ref` in ref.py does the same);
//      recomputing it in every N tile repeated it N/64 times. h is a thin
//      product (r <= 128 columns), so `lora_h_split_kernel` splits K
//      over blocks, each running the tile's WMMA loop over its K range
//      into an fp32 partial, and `lora_h_reduce_kernel` adds the
//      partials in split order and rounds: deterministic, and enough
//      blocks to cover the SMs (a first design, a CUDA-core dot per
//      (row, column) with 8 warps splitting K, took 58 us at the full
//      width, bound by load latency).
//   2. `lora_tile_kernel` computes a 64 x 64 tile of y on the tensor cores
//      with WMMA bf16 -> fp32 fragments (mma.sync): 4 warps of 2 x 2
//      16 x 16 fragments, 64-deep K slabs staged in shared memory, and the
//      next slab's global loads issued into registers before the current
//      slab's products so they are in flight meanwhile. The same loop then
//      runs h @ b over r into a second set of fragments, and the epilogue
//      writes acc + s * lowrank as bf16. No r padding: ragged edges of M,
//      N, K and r are zero-filled in shared memory, never read from global.
//
// What bounds it: operations at the full-width shape. At (M, K, N, r) =
// (512, 2560, 2560, 32) it does 6.9 GFLOP (7.0 us at 989 TFLOP/s bf16)
// and must move 18.7 MB (5.6 us at 3.35 TB/s). This simple design (no TMA,
// no wgmma, one slab of prefetch) is far from that; wgmma and a deeper
// pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// ---------------------------------------------------------------------------
// The WMMA tile loop (y's tile, and h's split-K partials)
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

// acc += A[m0:m0+64, k_begin:k_end] @ B[k_begin:k_end, n0:n0+64] over
// 64-deep slabs (k_begin a multiple of 8), the next slab's loads in
// flight while the current one multiplies; zeros past k_end.
__device__ void gemm_tile(FragC (&acc)[2][2], const bf16* __restrict__ A,
                          int lda, const bf16* __restrict__ B, int ldb,
                          int m_rows, int n_cols, int k_begin, int k_end,
                          int m0, int n0, bool vec_a, bool vec_b, bf16* As,
                          bf16* Bs) {
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
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

__device__ __forceinline__ void warp_origin(int& wm, int& wn) {
  const int warp = threadIdx.x >> 5;
  wm = (warp >> 1) * 32;
  wn = (warp & 1) * 32;
}

// ---------------------------------------------------------------------------
// 1. h = bf16(x @ a): split-K partials, then an ordered reduce
// ---------------------------------------------------------------------------

// partial[z] (M, r) fp32 = x[:, z*k_chunk : (z+1)*k_chunk] @ a[that range]
__global__ void __launch_bounds__(kThreads)
lora_h_split_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                    float* __restrict__ partial, int m_rows, int k_dim,
                    int r_dim, int k_chunk, bool vec_x, bool vec_a) {
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k_dim, k_begin + k_chunk);
  int wm, wn;
  warp_origin(wm, wn);
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
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
  __syncthreads();
  float* dst = partial + static_cast<int64_t>(blockIdx.z) * m_rows * r_dim;
  for (int q = threadIdx.x; q < kBM * kBN; q += kThreads) {
    const int r = q / kBN, c = q % kBN;
    if (m0 + r < m_rows && n0 + c < r_dim) {
      dst[static_cast<int64_t>(m0 + r) * r_dim + n0 + c] = Cs[r * kLdC + c];
    }
  }
}

// h[i] = bf16(partial[0][i] + partial[1][i] + ...), splits in order
__global__ void lora_h_reduce_kernel(const float* __restrict__ partial,
                                     bf16* __restrict__ h, int64_t count,
                                     int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= count) return;
  float sum = partial[i];
  for (int z = 1; z < splits; ++z) sum += partial[z * count + i];
  h[i] = __float2bfloat16(sum);
}

// ---------------------------------------------------------------------------
// 2. the tile: y = x @ W + s * h @ b on the tensor cores
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      wmma::fill_fragment(low[i][j], 0.0f);
    }
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x (M, K), w (K, N), a (K, r), b (r, N) bf16 row-major; h (M, r) bf16
// and partial (splits, M, r) fp32 scratch, with k_chunk a multiple of 64
// and splits * k_chunk >= K; y (M, N) bf16. Enqueues the h split and
// reduce kernels, then the tile kernel, on `stream`. Returns
// cudaGetLastError() after the launches.
extern "C" int lora_matmul_launch(const bf16* x, const bf16* w, const bf16* a,
                                  const bf16* b, bf16* h, float* partial,
                                  bf16* y, int m, int k, int n, int r,
                                  int splits, int k_chunk, float s,
                                  void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (r < 1 || r > 128 || k < 1 || splits < 1 || k_chunk % kBK != 0 ||
      static_cast<int64_t>(splits) * k_chunk < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_x = k % 8 == 0 && aligned16(x);
  const dim3 hgrid((r + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  lora_h_split_kernel<<<hgrid, kThreads, 0, st>>>(
      x, a, partial, m, k, r, k_chunk, vec_x, r % 8 == 0 && aligned16(a));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(m) * r;
  lora_h_reduce_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                         st>>>(partial, h, count, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  lora_tile_kernel<<<grid, kThreads, 0, st>>>(
      x, w, h, b, y, m, k, n, r, s, vec_x, n % 8 == 0 && aligned16(w),
      r % 8 == 0 && aligned16(h), n % 8 == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}
