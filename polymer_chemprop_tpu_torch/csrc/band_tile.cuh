// The tile-product stage shared by the W_h-fused band kernels
// (band_rev_layer.cu, band_matmul.cu), in FP32.
//
// A block owns ROWS = 32 consecutive bond rows. Its kernel first builds the
// (ROWS x H) aggregation tile z in dynamic shared memory; only that stage
// differs between the kernels. The stages here are the same for all:
//   store_tile:    write the z tile to global memory (training only);
//   product_stage: out = z @ W_h, optionally act(inp + .). W_h streams
//     through shared memory in KS x NCHUNK slices; each thread keeps an
//     RPT-row x NQ-column block of the product in registers (z reads are
//     warp-wide broadcasts, W reads are conflict-free), and the epilogue
//     stores with consecutive lanes on consecutive columns.
// Dynamic shared memory: ROWS x H floats of z, then KS x NCHUNK of W_h,
// then ROWS ints a kernel may use for its rows' indices (smem_bytes). The
// widest H whose tile fits a block's 227 KB is 1,495; the
// Python side mirrors this arithmetic (ops/band_mpnn.py fused_layer_fits)
// to pick another layer form for wider models.
#pragma once
#include <cuda_runtime.h>

namespace band_tile {

constexpr int ROWS = 32;             // bond rows per block
constexpr int TX = 64;               // threads across output columns
constexpr int TY = 4;                // threads across rows
constexpr int THREADS = TX * TY;     // 256
constexpr int RPT = ROWS / TY;       // rows per thread (8)
constexpr int NQ = 5;                // column groups per thread
constexpr int NCHUNK = TX * NQ;      // output columns per pass (320)
constexpr int KS = 32;               // W_h rows per shared-memory slice

// Bytes of dynamic shared memory one block needs at hidden width H.
inline size_t smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(ROWS) * H + KS * NCHUNK) +
         sizeof(int) * ROWS;
}

// activation ids: 0 relu, 1 leakyrelu(0.1), 2 prelu as leakyrelu(0.25),
// 3 tanh, 4 elu, 5 selu (pallas_mpnn.py _ACT_FNS)
__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 0: return fmaxf(x, 0.f);
    case 1: return x > 0.f ? x : 0.1f * x;
    case 2: return x > 0.f ? x : 0.25f * x;
    case 3: return tanhf(x);
    case 4: return x > 0.f ? x : expm1f(x);
    default: {
      const float scale = 1.0507009873554805f;
      const float alpha = 1.6732632423543772f;
      return scale * (x > 0.f ? x : alpha * expm1f(x));
    }
  }
}

// z_out[row0 + r, :] = z_s[r, :] for the tile's rows below B. Call after
// the __syncthreads() that completes the tile.
__device__ __forceinline__ void store_tile(const float* z_s,
                                           float* __restrict__ z_out,
                                           int row0, int B, int H) {
  for (int idx = threadIdx.x; idx < ROWS * H; idx += THREADS) {
    const int t = row0 + idx / H;
    if (t < B) z_out[static_cast<size_t>(row0) * H + idx] = z_s[idx];
  }
}

// out[t, :] = z_s[t - row0, :] @ W_h, and with EPILOGUE
// act(inp[t, :] + .), for the tile's rows below B; NCHUNK output columns
// per pass. `w_s` is the KS x NCHUNK slice buffer behind the z tile. Call
// after the __syncthreads() that completes the tile.
template <bool EPILOGUE>
__device__ __forceinline__ void product_stage(const float* z_s, float* w_s,
                                              const float* __restrict__ wh,
                                              const float* __restrict__ inp,
                                              float* __restrict__ out,
                                              int row0, int B, int H,
                                              int act) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int n0 = 0; n0 < H; n0 += NCHUNK) {
    float acc[RPT][NQ];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[i][q] = 0.f;

    for (int k0 = 0; k0 < H; k0 += KS) {
      __syncthreads();  // the previous slice is no longer read
      for (int idx = tid; idx < KS * NCHUNK; idx += THREADS) {
        const int k = k0 + idx / NCHUNK;
        const int n = n0 + idx % NCHUNK;
        w_s[idx] = (k < H && n < H) ? wh[static_cast<size_t>(k) * H + n] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KS, H - k0);
#pragma unroll 4
      for (int kk = 0; kk < kmax; ++kk) {
        float wv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) wv[q] = w_s[kk * NCHUNK + tx + q * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float zv = z_s[(ty * RPT + i) * H + k0 + kk];
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[i][q] = fmaf(zv, wv[q], acc[i][q]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = row0 + ty * RPT + i;
      if (t >= B) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + tx + q * TX;
        if (n < H) {
          const size_t o = static_cast<size_t>(t) * H + n;
          out[o] = EPILOGUE ? act_fn(inp[o] + acc[i][q], act) : acc[i][q];
        }
      }
    }
  }
}

}  // namespace band_tile
