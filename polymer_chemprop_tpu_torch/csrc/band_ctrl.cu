// The band-layer control: band_rev_layer with the band selection taken
// out, in FP32, to measure how the layer's time splits.
//
// Replaces: scripts/band_mxu_probe.py _ctrl_kernel (modes "noq" and
// "pure"), reached through _ctrl_apply and scripts/band_mxu_probe2.py
// _apply. On the TPU every row of a 256-row tile got the same
// z = sum over the tile's 512-row window of w[c] m[c,:]; here the window is
// an explicit row range per ROWS-row block.
//
// For every row t of block j (rows [ROWS j, ROWS j + ROWS) below B):
//   z[t,:]   = sum_{c in [lo[j], hi[j])} w[c] m[c,:]       (one z per block)
//   out[t,:] = relu(inp[t,:] + z[t,:] @ W_h)                EPILOGUE (noq)
//   out[t,:] = z[t,:] @ W_h                                 no EPILOGUE (pure)
// The range is clamped to [0, B), so a range past the end reads nothing.
//
// What bounds it on an H100: the z @ W_h product, 2*B*H^2 FP32 operations
// (5.0 GFLOP at B = 28,032, H = 300, 0.075 ms at 67 TFLOP/s), against about
// 3*B*H*4 bytes of m, inp and out (0.030 ms at 3.35 TB/s).
//
// Design: the grid, block size, dynamic shared-memory layout and the
// tile-product stage are band_rev_layer.cu's (band_tile.cuh), so the time
// of this kernel is the layer's without its CSR z build. Only stage 1
// differs: the block reads no rowptr, src or srev and runs no data-dependent
// loop per row. Its threads, over the columns, sum the block's single z row
// once (two columns a thread in one loop, so that the block waits for one
// chain of loads) and write it to all ROWS rows of the shared tile.
#include <cuda_runtime.h>

#include "band_tile.cuh"

namespace {

using namespace band_tile;

template <bool EPILOGUE>
__global__ void __launch_bounds__(THREADS, 2)
band_ctrl_kernel(const float* __restrict__ m,
                 const float* __restrict__ inp,
                 const float* __restrict__ wh,
                 const float* __restrict__ w,
                 const int* __restrict__ lo,
                 const int* __restrict__ hi,
                 float* __restrict__ out,
                 int B, int H) {
  extern __shared__ float smem[];
  float* z_s = smem;                     // ROWS x z_stride(H)
  const int zs = z_stride(H);
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int c0 = max(lo[blockIdx.x], 0);
  const int c1 = min(hi[blockIdx.x], B);

  // 1. the block's z row, written to its real rows (the others stay 0):
  // columns j and j + THREADS of a thread summed in one loop, two chains
  for (int j = threadIdx.x; j < H; j += 2 * THREADS) {
    const int j2 = j + THREADS < H ? j + THREADS : j;
    float acc = 0.f, acc2 = 0.f;
#pragma unroll 16   // the range's loads in flight together
    for (int c = c0; c < c1; ++c) {
      const float* mc = m + static_cast<size_t>(c) * H;
      acc = fmaf(w[c], mc[j], acc);
      acc2 = fmaf(w[c], mc[j2], acc2);
    }
    for (int r = 0; r < ROWS; ++r) {
      z_s[r * zs + j] = r < nrows ? acc : 0.f;
      z_s[r * zs + j2] = r < nrows ? acc2 : 0.f;
    }
  }
  product_stage<EPILOGUE>(smem, wh, inp, out, row0, B, H, /*relu*/ 0);
}

template <bool EPILOGUE>
int launch(const float* m, const float* inp, const float* wh, const float* w,
           const int* lo, const int* hi, float* out, int B, int H,
           void* stream) {
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      band_ctrl_kernel<EPILOGUE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + ROWS - 1) / ROWS;
  band_ctrl_kernel<EPILOGUE><<<blocks, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      m, inp, wh, w, lo, hi, out, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the control on `stream`: mode 0 is "noq" (relu epilogue, inp
// read), 1 is "pure" (out = z @ W_h, inp not read). Returns
// cudaGetLastError() as an int.
int band_ctrl_f32(const float* m, const float* inp, const float* wh,
                  const float* w, const int* lo, const int* hi, float* out,
                  int B, int H, int mode, void* stream) {
  if (mode == 0)
    return launch<true>(m, inp, wh, w, lo, hi, out, B, H, stream);
  return launch<false>(m, inp, wh, w, lo, hi, out, B, H, stream);
}

}  // extern "C"
