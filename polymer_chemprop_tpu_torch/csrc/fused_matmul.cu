// A split-bf16 ("3xBF16") matrix product on the tensor cores:
//   out = x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi        (float32 out)
// with x (N, K) float32 split as it is staged, x_hi = bf16_rn(x) and
// x_lo = bf16_rn(x - x_hi), and b_hi, b_lo (K, M) bf16 split once by the
// caller (ops/probe_kernels.py split_bf16). Every bf16 x bf16 product is
// exact in float32; the three passes add into one float32 accumulator.
//
// Replaces: scripts/fused_matmul_probe.py _fused_kernel (through
// fused_matmul), the TPU's in-register hi/lo split with three MXU passes;
// the same split as polymer_chemprop_tpu/ops/pallas_mpnn.py _dot_band at
// Precision.HIGH.
//
// What bounds it on an H100: at (28,032 x 300) @ (300 x 300) the three
// passes are 3 * 2*N*K*M = 1.5 GFLOP, 0.015 ms at the 989 TFLOP/s bf16
// tensor-core peak, while x read once and out written once are
// 2*N*K*4 + 2*K*M*2 bytes = 67 MB, 0.020 ms at 3.35 TB/s: bound by bytes.
//
// Design (simple and right first; wgmma, TMA and a pipeline are later
// work): one block of 4 warps owns a 64 x 64 output tile; K goes through
// shared memory in steps of KT = 32. Each thread stages x as float4 where
// it can, splits it and stores both halves as bf16; b_hi and b_lo are
// copied. Rows past N, columns past M and depths past K are staged as
// zeros, so the ragged edges need no masks in the product (H = 300 is no
// multiple of 16). Each warp holds a 32 x 32 quarter of the tile as 2 x 2
// nvcuda::wmma m16n16k16 float accumulators and issues the three bf16
// passes on every k step. The tile goes back through shared memory, and
// the store masks rows past N and columns past M. Tile pointers are 32-byte
// aligned and every ldm is a multiple of 8 elements, as wmma requires.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;               // output rows per block
constexpr int BN = 64;               // output columns per block
constexpr int KT = 32;               // depth per shared-memory stage
constexpr int THREADS = 128;         // 4 warps, 2 x 2 over the tile
constexpr int LDA = KT + 8;          // x tiles: BM x LDA bf16
constexpr int LDB = BN + 8;          // b tiles: KT x LDB bf16
constexpr int LDC = BN + 8;          // out tile: BM x LDC float
// shared memory, in bytes: the four staging tiles, and the out tile over
// them once the product is done
constexpr int A_BYTES = BM * LDA * 2;
constexpr int B_BYTES = KT * LDB * 2;
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES;
static_assert(A_BYTES % 32 == 0 && B_BYTES % 32 == 0,
              "wmma tile pointers must stay 32-byte aligned");

__device__ __forceinline__ void split(float v, __nv_bfloat16* hi,
                                      __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__global__ void __launch_bounds__(THREADS)
fused_matmul_kernel(const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ b_hi,
                    const __nv_bfloat16* __restrict__ b_lo,
                    float* __restrict__ out, int N, int K, int M) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  auto* a_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* a_lo = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  auto* bs_hi = reinterpret_cast<__nv_bfloat16*>(smem + 2 * A_BYTES);
  auto* bs_lo = reinterpret_cast<__nv_bfloat16*>(smem + 2 * A_BYTES +
                                                 B_BYTES);
  auto* c_s = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 32;     // the warp's rows in the tile
  const int wc = (warp & 1) * 32;      // the warp's columns in the tile
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // every row of x starts 16-byte aligned: stage it as float4
  const bool vec_x =
      (K & 3) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous stage is no longer read
    // x: BM x KT floats, split into hi and lo as they are stored
    for (int idx = tid; idx < BM * KT / 4; idx += THREADS) {
      const int r = idx / (KT / 4);
      const int k = (idx % (KT / 4)) * 4;
      const int gr = row0 + r;
      const int gk = k0 + k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gr < N) {
        const float* src = x + static_cast<size_t>(gr) * K + gk;
        if (vec_x && gk + 3 < K) {
          const float4 q = *reinterpret_cast<const float4*>(src);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gk + e < K) v[e] = src[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(v[e], &a_hi[r * LDA + k + e], &a_lo[r * LDA + k + e]);
    }
    // b_hi, b_lo: KT x BN each
    for (int idx = tid; idx < KT * BN; idx += THREADS) {
      const int k = idx / BN;
      const int n = idx % BN;
      const int gk = k0 + k;
      const int gn = col0 + n;
      __nv_bfloat16 h = __float2bfloat16_rn(0.f), l = h;
      if (gk < K && gn < M) {
        const size_t o = static_cast<size_t>(gk) * M + gn;
        h = b_hi[o];
        l = b_lo[o];
      }
      bs_hi[k * LDB + n] = h;
      bs_lo[k * LDB + n] = l;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> ah[2], al[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ah[i], &a_hi[(wr + 16 * i) * LDA + kk],
                               LDA);
        wmma::load_matrix_sync(al[i], &a_lo[(wr + 16 * i) * LDA + kk],
                               LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bh[j], &bs_hi[kk * LDB + wc + 16 * j], LDB);
        wmma::load_matrix_sync(bl[j], &bs_lo[kk * LDB + wc + 16 * j], LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], ah[i], bh[j], acc[i][j]);
          wmma::mma_sync(acc[i][j], ah[i], bl[j], acc[i][j]);
          wmma::mma_sync(acc[i][j], al[i], bh[j], acc[i][j]);
        }
    }
  }

  __syncthreads();  // the staging tiles are no longer read: reuse as c
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_s[(wr + 16 * i) * LDC + wc + 16 * j],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int n = idx % BN;
    if (row0 + r < N && col0 + n < M)
      out[static_cast<size_t>(row0 + r) * M + col0 + n] = c_s[r * LDC + n];
  }
}

}  // namespace

extern "C" {

// Launches out = x_hi b_hi + x_hi b_lo + x_lo b_hi on `stream`; x (N, K)
// float32, b_hi and b_lo (K, M) bf16, out (N, M) float32, all row-major
// and contiguous. Returns cudaGetLastError() as an int.
int fused_matmul_f32(const float* x, const void* b_hi, const void* b_lo,
                     float* out, int N, int K, int M, void* stream) {
  const dim3 grid((M + BN - 1) / BN, (N + BM - 1) / BM);
  fused_matmul_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(b_hi),
      static_cast<const __nv_bfloat16*>(b_lo), out, N, K, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
