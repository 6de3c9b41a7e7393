// VJP of the plain band aggregation over dst-sorted bonds, in FP32:
// dm = S^T g - g = w o (K g) - g with K[b, c] = [dst c == dst b], the
// gradient of z = S m - m with respect to the messages m.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_bwd_kernel,
// reached through _band_bwd_apply from the custom_vjp of _band_op,
// band_matmul_step_sorted and band_matmul_act_step_sorted: the backward of
// every plain-band layer form.
//
// With run(v) = [rowptr[v], rowptr[v + 1]) (rowptr from ops/sorted_aux.py):
//   G[v,:]  = sum_{b in run(v)} g[b,:]          unit weights inside the sum
//   dm[c,:] = w[c] * G[v,:] - g[c,:]            the row's own weight outside
// for every c in run(v). (The rev-fused layer's VJP, band_rev_bwd.cu, is
// the other way round: it sums g[srev c] and reads no row of its own.)
// Padding rows (c >= rowptr[A]) belong to no run and have weight 0:
//   dm[c,:] = -g[c,:]
//
// What bounds it on an H100: memory. g is read once and dm written once
// (2*B*H*4 bytes, 67 MB at B = 28,032, H = 300) for about 2 operations per
// element: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel contracted a unit one-hot band over a 512-row window on the MXU
// and scaled the rows afterwards; on Hopper this is a segment sum over the
// CSR with no window and no atomics.
//
// Design (simple and right first): one warp per atom v, lanes over the H
// columns, as in band_agg.cu: read the run's rows, keep G[v] in registers,
// write dm[c] for every c of the run (the second read of each row comes
// from cache). Each dm row is written once and the summation order is
// fixed. A tail of the grid strides over the padding rows and writes
// dm = -g there. Any H works: the lanes loop over the columns.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAIL_BLOCKS = 32;      // blocks striding over padding rows

__global__ void __launch_bounds__(THREADS)
band_bwd_kernel(const float* __restrict__ g,
                const float* __restrict__ w,
                const int* __restrict__ rowptr,
                float* __restrict__ dm,
                int A, int B, int H, int atom_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < atom_blocks) {
    const int v = blockIdx.x * WARPS + warp;
    if (v >= A) return;
    const int c0 = rowptr[v];
    const int c1 = rowptr[v + 1];
    for (int j = lane; j < H; j += 32) {
      float s = 0.f;
      for (int c = c0; c < c1; ++c) s += g[static_cast<size_t>(c) * H + j];
      for (int c = c0; c < c1; ++c) {
        const size_t o = static_cast<size_t>(c) * H + j;
        dm[o] = fmaf(w[c], s, -g[o]);
      }
    }
    return;
  }
  // tail: padding rows [rowptr[A], B)
  const int n_real = rowptr[A];
  const int stride = (gridDim.x - atom_blocks) * WARPS;
  for (int r = n_real + (blockIdx.x - atom_blocks) * WARPS + warp; r < B;
       r += stride) {
    const size_t o = static_cast<size_t>(r) * H;
    for (int j = lane; j < H; j += 32) dm[o + j] = -g[o + j];
  }
}

}  // namespace

extern "C" {

// Launches dm = S^T g - g on `stream`; returns cudaGetLastError() as an int.
int band_bwd_f32(const float* g, const float* w, const int* rowptr, float* dm,
                 int A, int B, int H, void* stream) {
  const int atom_blocks = (A + WARPS - 1) / WARPS;
  band_bwd_kernel<<<atom_blocks + TAIL_BLOCKS, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      g, w, rowptr, dm, A, B, H, atom_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
