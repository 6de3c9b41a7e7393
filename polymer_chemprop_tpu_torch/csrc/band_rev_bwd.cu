// VJP of the rev-fused band aggregation over dst-sorted bonds, in FP32:
// dm = M^T g, the gradient of z = M m with respect to the messages m.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_rev_bwd_kernel,
// reached through _band_rev_bwd_apply from the custom_vjp of
// band_rev_layer_step_sorted.
//
// For every sorted bond row c (srev/rowptr/w from ops/sorted_aux.py):
//   dm[c,:] = w[c] * sum_{t : src(t) = dst(c)} g[t,:]  -  g[srev c,:]
// The bonds leaving atom a are exactly the reverses of the bonds entering
// it, so with run(a) = [rowptr[a], rowptr[a + 1]):
//   S[a,:]  = sum_{c' in run(a)} g[srev c',:]
//   dm[c,:] = w[c] * S[dst c,:] - g[srev c,:]
// Padding rows (c >= rowptr[A]) belong to no run, have w = 0 and are their
// own reverse: dm[c,:] = -g[srev c,:] = -g[c,:].
//
// What bounds it on an H100: memory. g is read once and dm written once
// (2*B*H*4 bytes, 67 MB at B = 28,032, H = 300) for about 2 operations per
// element: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel contracted a one-hot band over a 512-row window on the MXU; on
// Hopper this is a gather-and-add over the CSR with no window and no
// atomics.
//
// Design (simple and right first): one warp per atom a, lanes over the H
// columns. The warp reads the rows g[srev c'] of its run (each a coalesced
// row read), forms S[a] in registers, and writes dm[c'] for every c' of the
// run; the row subtracted for c' is the one just added for it, so its
// second read comes from cache. Every real row lies in exactly one run, so
// each dm row is written once and the summation order is fixed. A tail of
// the grid, a fixed number of blocks striding over the padding rows, writes
// dm = -g[srev] there without the host having to know how many there are.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAIL_BLOCKS = 32;      // blocks striding over padding rows

__global__ void __launch_bounds__(THREADS)
band_rev_bwd_kernel(const float* __restrict__ g,
                    const float* __restrict__ w,
                    const int* __restrict__ srev,
                    const int* __restrict__ rowptr,
                    float* __restrict__ dm,
                    int A, int B, int H, int atom_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < atom_blocks) {
    const int a = blockIdx.x * WARPS + warp;
    if (a >= A) return;
    const int c0 = rowptr[a];
    const int c1 = rowptr[a + 1];
    for (int j = lane; j < H; j += 32) {
      float s = 0.f;
      for (int c = c0; c < c1; ++c)
        s += g[static_cast<size_t>(srev[c]) * H + j];
      for (int c = c0; c < c1; ++c)
        dm[static_cast<size_t>(c) * H + j] =
            fmaf(w[c], s, -g[static_cast<size_t>(srev[c]) * H + j]);
    }
    return;
  }
  // tail: padding rows [rowptr[A], B)
  const int n_real = rowptr[A];
  const int stride = (gridDim.x - atom_blocks) * WARPS;
  for (int r = n_real + (blockIdx.x - atom_blocks) * WARPS + warp; r < B;
       r += stride) {
    const size_t rv = static_cast<size_t>(srev[r]) * H;
    for (int j = lane; j < H; j += 32)
      dm[static_cast<size_t>(r) * H + j] = -g[rv + j];
  }
}

}  // namespace

extern "C" {

// Launches dm = M^T g on `stream`; returns cudaGetLastError() as an int.
int band_rev_bwd_f32(const float* g, const float* w, const int* srev,
                     const int* rowptr, float* dm, int A, int B, int H,
                     void* stream) {
  const int atom_blocks = (A + WARPS - 1) / WARPS;
  band_rev_bwd_kernel<<<atom_blocks + TAIL_BLOCKS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      g, w, srev, rowptr, dm, A, B, H, atom_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
