// The plain band aggregation over dst-sorted bonds, in FP32:
// z = S m - m with S[b, c] = w[c] * [dst c == dst b].
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_kernel, reached
// through _band_apply and band_message_step_sorted: the layer form of the
// encoder configurations whose W_h product is not fused (bias, bf16, hidden
// sizes too wide for the fused kernels). The srev gather that follows it
// stays outside the kernel, as in the JAX package (permute_rows).
//
// With run(v) = [rowptr[v], rowptr[v + 1]) (rowptr from ops/sorted_aux.py):
//   A[v,:] = sum_{c in run(v)} w[c] m[c,:]
//   z[c,:] = A[v,:] - m[c,:]                    for every c in run(v)
// Padding rows (c >= rowptr[A]) belong to no run and have weight 0:
//   z[c,:] = -m[c,:]
// which is what the TPU kernel gives them.
//
// What bounds it on an H100: memory. m is read once and z written once
// (2*B*H*4 bytes, 67 MB at B = 28,032, H = 300) for about 2 operations per
// element: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel contracted a weighted one-hot band over a 512-bond window on the
// MXU; on Hopper every row of a run shares one sum, so the run is read
// through the CSR once with no window and no atomics.
//
// Design (simple and right first): one warp per atom v, lanes over the H
// columns. The warp reads the rows of its run (each a coalesced row read),
// keeps A[v] in registers, and writes z[c] for every c of the run; the
// second read of each row comes from cache. Every real row lies in exactly
// one run, so each z row is written once and the summation order is fixed.
// A tail of the grid, a fixed number of blocks striding over the padding
// rows, writes z = -m there without the host having to know how many there
// are. Any H works: the lanes loop over the columns.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAIL_BLOCKS = 32;      // blocks striding over padding rows

__global__ void __launch_bounds__(THREADS)
band_agg_kernel(const float* __restrict__ m,
                const float* __restrict__ w,
                const int* __restrict__ rowptr,
                float* __restrict__ z,
                int A, int B, int H, int atom_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < atom_blocks) {
    const int v = blockIdx.x * WARPS + warp;
    if (v >= A) return;
    const int c0 = rowptr[v];
    const int c1 = rowptr[v + 1];
    for (int j = lane; j < H; j += 32) {
      float acc = 0.f;
      for (int c = c0; c < c1; ++c)
        acc = fmaf(w[c], m[static_cast<size_t>(c) * H + j], acc);
      for (int c = c0; c < c1; ++c) {
        const size_t o = static_cast<size_t>(c) * H + j;
        z[o] = acc - m[o];
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
    for (int j = lane; j < H; j += 32) z[o + j] = -m[o + j];
  }
}

}  // namespace

extern "C" {

// Launches z = S m - m on `stream`; returns cudaGetLastError() as an int.
int band_agg_f32(const float* m, const float* w, const int* rowptr, float* z,
                 int A, int B, int H, void* stream) {
  const int atom_blocks = (A + WARPS - 1) / WARPS;
  band_agg_kernel<<<atom_blocks + TAIL_BLOCKS, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      m, w, rowptr, z, A, B, H, atom_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
