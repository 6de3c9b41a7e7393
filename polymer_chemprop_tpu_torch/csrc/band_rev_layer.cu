// One whole wD-MPNN depth-loop layer over dst-sorted bonds, with an FP32
// entry point and a tensor-core one.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_rev_act_kernel
// (the rev-fused band layer, write_z=False in inference), reached through
// _band_rev_act_apply and band_rev_layer_step_sorted (the default
// encoder's layer).
//
// For every sorted bond row t (src/srev/rowptr from ops/sorted_aux.py):
//   z[t,:]   = sum_{c in [rowptr[src t], rowptr[src t + 1])} w[c] m[c,:]
//              - m[srev t,:]
//   out[t,:] = act(inp[t,:] + z[t,:] @ W_h)            W_h is (in, out)
// and, when z_out is not null (the training slice), z is written too. Both
// entry points build z alike, in FP32, bit for bit: fmaf over the run in
// its order, then the reverse message subtracted. Padding rows (src 0,
// atom 0's run empty, own reverse, zero m and inp) come out exactly 0.
// The TPU kernel built a dense band matrix over a 512-bond window and ran
// it on the MXU; a CUDA block has no such window and reads each incoming
// run through the CSR instead, so the aggregation costs only the ~2
// incoming bonds per row that exist.
//
// band_rev_layer_f32 (band_precision="highest"): the product in FP32 on
// the CUDA cores. What bounds it on an H100: 2*B*H^2 FP32 operations (5.05
// GFLOP at B = 28,032, H = 300) against ~3*B*H*4 bytes of m, inp and out:
// about 50 operations per byte, above the card's FP32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20), so FP32 FMA issue. Design: a block owns ROWS = 32
// consecutive bond rows; its warps build the z tile in dynamic shared
// memory, one row per warp at a time, lanes over the H columns (coalesced
// row reads of m); then the tile-product stage of band_tile.cuh, shared
// with band_matmul.cu, streams W_h through shared memory and its epilogue
// adds inp, applies the activation and stores out.
//
// band_rev_layer_tc (band_precision "high", passes = 3: z_hi W_hi +
// z_hi W_lo + z_lo W_hi; "default", passes = 1: z_hi W_hi): the product on
// the tensor cores, the split-bf16 arithmetic of the TPU kernel's
// _dot_band (pallas_mpnn.py:331-357). What bounds it on an H100: the three
// passes are 3 * 2*B*H^2 = 15.1 GFLOP, 0.015 ms at the 989 TFLOP/s bf16
// peak, while m, inp and out move ~101 MB, 0.030 ms at 3.35 TB/s: bytes.
// Design: the Hopper stage of band_tile_sm90.cuh, as band_matmul.cu's
// tensor-core entries use it (W_h split once per call by split_wh_kernel
// into the caller's scratch, z built chunk by chunk into a two-stage ring
// while the previous chunk's wgmmas run), with inp itself as the residual:
// the rev form needs no srev permutation around the call. Each of the
// block's 64 rows finds its run by a direct lookup, rowptr[src t] and
// rowptr[src t + 1] (no binary search, unlike band_matmul.cu), into the
// stage's two ints a row; the z functor reads srev[t] itself, a cached
// 4-byte load beside the run's 32-byte row reads, so that the stage's
// shared layout (and band_matmul.cu's build) stays as it is.
#include <cuda_runtime.h>

#include "band_tile.cuh"
#include "band_tile_sm90.cuh"

namespace {

using namespace band_tile;

__global__ void __launch_bounds__(THREADS, 2)
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
  float* z_s = smem;                     // ROWS x z_stride(H)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int zs = z_stride(H);

  // 1. z tile: incoming run of src(t) minus the reverse message
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int t = row0 + r;
    float* zr = z_s + r * zs;
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
  product_stage<true>(smem, wh, inp, out, row0, B, H, act);
}

// the block's rows' runs, [c0, c1) of the row's source atom (empty for a
// row past B), by a direct lookup
__device__ __forceinline__ void rev_runs(const int* __restrict__ src,
                                         const int* __restrict__ rowptr,
                                         int* runs, int row0, int rows,
                                         int B) {
  const int r = threadIdx.x;
  if (r >= rows) return;
  const int t = row0 + r;
  int c0 = 0, c1 = 0;
  if (t < B) {
    const int s = src[t];
    c0 = rowptr[s];
    c1 = rowptr[s + 1];
  }
  runs[2 * r] = c0;
  runs[2 * r + 1] = c1;
}

// z[t, col:col + 8] in the FP32 kernel's order: fma over the run of
// src(t), then the reverse message m[srev t] subtracted
struct CsrRevZRow {
  const float* __restrict__ m;
  const float* __restrict__ w;
  const int* __restrict__ srev;
  const int* runs;
  int H;
  bool vec;

  __device__ __forceinline__ void operator()(int r, int t, int col,
                                             float (&v)[8]) const {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int c1 = runs[2 * r + 1];
    for (int c = runs[2 * r]; c < c1; ++c) {
      const float wc = w[c];
      float x[8];
      band_tile_sm90::load8(m + static_cast<size_t>(c) * H, col, H, vec, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wc, x[e], acc[e]);
    }
    float rev[8];
    band_tile_sm90::load8(m + static_cast<size_t>(srev[t]) * H, col, H, vec,
                          rev);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = acc[e] - rev[e];
  }
};

template <int PASSES>
__global__ void __launch_bounds__(band_tile_sm90::THREADS, 1)
band_rev_layer_tc_kernel(const float* __restrict__ m,
                         const float* __restrict__ inp,
                         const unsigned char* __restrict__ wsplit,
                         const float* __restrict__ w,
                         const int* __restrict__ src,
                         const int* __restrict__ srev,
                         const int* __restrict__ rowptr,
                         float* __restrict__ out,
                         float* __restrict__ z_out,
                         int B, int H, int act) {
  namespace tc = band_tile_sm90;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const tc::Layout L = tc::layout(tc_smem);
  const int row0 = blockIdx.x * tc::BM;
  rev_runs(src, rowptr, L.rows, row0, tc::BM, B);
  const CsrRevZRow zrow{m, w, srev, L.rows, H, (H & 3) == 0};
  tc::stage<true, PASSES>(L, zrow, wsplit, inp, out, z_out, row0, B, H, act);
}

template <int PASSES>
int launch_tc_kernel(const float* m, const float* inp,
                     const unsigned char* wsplit, const float* w,
                     const int* src, const int* srev, const int* rowptr,
                     float* out, float* z_out, int B, int H, int act,
                     cudaStream_t stream) {
  namespace tc = band_tile_sm90;
  cudaError_t err = cudaFuncSetAttribute(
      band_rev_layer_tc_kernel<PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + tc::BM - 1) / tc::BM;
  band_rev_layer_tc_kernel<PASSES>
      <<<blocks, tc::THREADS, tc::SMEM_BYTES, stream>>>(
          m, inp, wsplit, w, src, srev, rowptr, out, z_out, B, H, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the FP32 entry needs at
// hidden width H.
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

// The layer with the product in `passes` (3 or 1) bf16 passes on the
// tensor cores; z (FP32) written when z_out is not null. `scratch` holds
// band_tile_sm90::scratch_bytes(H) bytes (ops/band_mpnn.py
// tc_scratch_bytes), 16-byte aligned: W_h split into it first, then the
// stage. Launches on `stream`; returns cudaGetLastError() as an int.
int band_rev_layer_tc(const float* m, const float* inp, const float* wh,
                      void* scratch, const float* w, const int* src,
                      const int* srev, const int* rowptr, float* out,
                      float* z_out, int B, int H, int act, int passes,
                      void* stream_ptr) {
  namespace tc = band_tile_sm90;
  if (passes != 1 && passes != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* wsplit = static_cast<unsigned char*>(scratch);
  const cudaError_t err = tc::split_wh(wh, wsplit, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return passes == 3
      ? launch_tc_kernel<3>(m, inp, wsplit, w, src, srev, rowptr, out, z_out,
                            B, H, act, stream)
      : launch_tc_kernel<1>(m, inp, wsplit, w, src, srev, rowptr, out, z_out,
                            B, H, act, stream);
}

}  // extern "C"
