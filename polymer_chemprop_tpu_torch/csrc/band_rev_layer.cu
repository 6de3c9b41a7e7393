// One whole wD-MPNN depth-loop layer over dst-sorted bonds, in FP32.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_rev_act_kernel
// (the rev-fused band layer, write_z=False in inference), reached through
// _band_rev_act_apply and band_rev_layer_step_sorted.
//
// For every sorted bond row t (src/srev/rowptr from ops/sorted_aux.py):
//   z[t,:]   = sum_{c in [rowptr[src t], rowptr[src t + 1])} w[c] m[c,:]
//              - m[srev t,:]
//   out[t,:] = act(inp[t,:] + z[t,:] @ W_h)            W_h is (in, out)
// and, when z_out is not null (the training slice), z is written too.
//
// What bounds it on an H100: the z @ W_h product, 2*B*H^2 FP32 operations
// (5.2 GFLOP at B = 28,672, H = 300), against ~3*B*H*4 bytes of m, inp and
// out: about 50 operations per byte, above the card's FP32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20). So it is bound by FP32 FMA issue, not
// by memory. The TPU kernel built a dense band matrix over a 512-bond
// window and ran it on the MXU; a CUDA block has no such window and reads
// each incoming run through the CSR instead, so the aggregation costs only
// the ~2 incoming bonds per row that exist.
//
// Design (simple and right first; tensor cores are a later redesign):
//   1. A block owns ROWS = 32 consecutive bond rows. Its warps build the
//      z tile in dynamic shared memory, one row per warp at a time, lanes
//      over the H columns (coalesced row reads of m).
//   2. The tile-product stage of band_tile.cuh, shared with
//      band_matmul.cu: W_h streams through shared memory and the epilogue
//      adds inp, applies the activation and stores out.
// Padding rows (src 0, own reverse, zero m and inp) come out exactly 0.
#include <cuda_runtime.h>

#include "band_tile.cuh"

namespace {

using namespace band_tile;

__global__ void __launch_bounds__(THREADS)
band_rev_layer_kernel(const float* __restrict__ m,
                      const float* __restrict__ inp,
                      const float* __restrict__ wh,
                      const float* __restrict__ w,
                      const int* __restrict__ src,
                      const int* __restrict__ srev,
                      const int* __restrict__ rowptr,
                      float* __restrict__ out,
                      float* __restrict__ z_out,
                      int B, int H, int act) {
  extern __shared__ float smem[];
  float* z_s = smem;                     // ROWS x H
  float* w_s = smem + ROWS * H;          // KS x NCHUNK
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  // 1. z tile: incoming run of src(t) minus the reverse message
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int t = row0 + r;
    float* zr = z_s + r * H;
    if (t >= B) {
      for (int j = lane; j < H; j += 32) zr[j] = 0.f;
      continue;
    }
    const int s = src[t];
    const size_t rv = static_cast<size_t>(srev[t]) * H;
    const int c0 = rowptr[s];
    const int c1 = rowptr[s + 1];
    for (int j = lane; j < H; j += 32) {
      float acc = 0.f;
      for (int c = c0; c < c1; ++c)
        acc = fmaf(w[c], m[static_cast<size_t>(c) * H + j], acc);
      zr[j] = acc - m[rv + j];
    }
  }
  __syncthreads();
  if (z_out != nullptr) store_tile(z_s, z_out, row0, B, H);
  product_stage<true>(z_s, w_s, wh, inp, out, row0, B, H, act);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at hidden width H.
size_t band_rev_layer_smem_bytes(int H) {
  return band_tile::smem_bytes(H);
}

// Launches the layer on `stream`; returns cudaGetLastError() as an int.
int band_rev_layer_f32(const float* m, const float* inp, const float* wh,
                       const float* w, const int* src, const int* srev,
                       const int* rowptr, float* out, float* z_out,
                       int B, int H, int act, void* stream) {
  const size_t smem = band_rev_layer_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      band_rev_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + band_tile::ROWS - 1) / band_tile::ROWS;
  band_rev_layer_kernel<<<blocks, band_tile::THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      m, inp, wh, w, src, srev, rowptr, out, z_out, B, H, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
