// The plain band aggregation with the W_h product fused, over dst-sorted
// bonds, in FP32. Two entry points:
//
//   band_matmul_act_f32: out = act(inp_srev + z @ W_h), z written when asked
//     Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py
//     _band_matmul_act_kernel, reached through _band_matmul_act_apply and
//     band_matmul_act_step_sorted (the undirected encoder's layer).
//   band_matmul_f32:     out = z @ W_h and z
//     Replaces: _band_matmul_kernel, reached through _band_matmul_apply and
//     band_matmul_step_sorted.
//
// with z = S m - m, S[b, c] = w[c] * [dst c == dst b], W_h in (in, out)
// layout. For every sorted bond row t whose destination atom is v
// (run(v) = [rowptr[v], rowptr[v + 1]), rowptr from ops/sorted_aux.py):
//   z[t,:] = sum_{c in run(v)} w[c] m[c,:] - m[t,:]
// and padding rows (t >= rowptr[A], in no run) get z[t,:] = -m[t,:]. The
// caller pre-permutes the residual by srev and gathers out by srev
// afterwards (srev is an involution), as in the JAX package.
//
// What bounds it on an H100: the z @ W_h product, 2*B*H^2 FP32 operations
// (5.05 GFLOP at B = 28,032, H = 300) against ~3*B*H*4 bytes of m, inp and
// out: about 50 operations per byte, above the card's FP32 ridge of 20. So
// it is bound by FP32 FMA issue, not by memory. The TPU kernel built a dense
// band matrix over a 512-bond window for the MXU; here a block reads each
// run through the CSR.
//
// Design (simple and right first): as band_rev_layer.cu, with which it
// shares the tile-product stage (band_tile.cuh). A block owns ROWS = 32
// consecutive bond rows. Consecutive sorted rows have non-decreasing
// destination atoms, but the kernel is given no dst array: the first ROWS
// threads each find their row's atom by a binary search over rowptr (one
// search latency per block), then the warps build the z tile in shared
// memory, one row per warp at a time, lanes over the H columns. The product
// and, for band_matmul_act, the residual and activation follow from the
// shared stage.
#include <cuda_runtime.h>

#include "band_tile.cuh"

namespace {

using namespace band_tile;

template <bool EPILOGUE>
__global__ void __launch_bounds__(THREADS)
band_matmul_kernel(const float* __restrict__ m,
                   const float* __restrict__ inp,
                   const float* __restrict__ wh,
                   const float* __restrict__ w,
                   const int* __restrict__ rowptr,
                   float* __restrict__ out,
                   float* __restrict__ z_out,
                   int A, int B, int H, int act) {
  extern __shared__ float smem[];
  float* z_s = smem;                     // ROWS x H
  float* w_s = smem + ROWS * H;          // KS x NCHUNK
  int* atom_s = reinterpret_cast<int*>(w_s + KS * NCHUNK);   // ROWS
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  // destination atom of each row of the tile: the v with
  // rowptr[v] <= t < rowptr[v + 1]; A for a padding row (t >= rowptr[A])
  if (tid < ROWS) {
    const int t = row0 + tid;
    int lo = 0, hi = A + 1;              // first index with rowptr[.] > t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rowptr[mid] <= t) lo = mid + 1; else hi = mid;
    }
    atom_s[tid] = lo - 1;                // rowptr[0] == 0 <= t, so lo >= 1
  }
  __syncthreads();

  // z tile: the run of the row's destination atom minus the row itself
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int t = row0 + r;
    float* zr = z_s + r * H;
    if (t >= B) {
      for (int j = lane; j < H; j += 32) zr[j] = 0.f;
      continue;
    }
    const int v = atom_s[r];
    const int c0 = v < A ? rowptr[v] : 0;
    const int c1 = v < A ? rowptr[v + 1] : 0;
    const size_t own = static_cast<size_t>(t) * H;
    for (int j = lane; j < H; j += 32) {
      float acc = 0.f;
      for (int c = c0; c < c1; ++c)
        acc = fmaf(w[c], m[static_cast<size_t>(c) * H + j], acc);
      zr[j] = acc - m[own + j];
    }
  }
  __syncthreads();
  if (z_out != nullptr) store_tile(z_s, z_out, row0, B, H);
  product_stage<EPILOGUE>(z_s, w_s, wh, inp, out, row0, B, H, act);
}

template <bool EPILOGUE>
int launch(const float* m, const float* inp, const float* wh, const float* w,
           const int* rowptr, float* out, float* z_out, int A, int B, int H,
           int act, void* stream) {
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      band_matmul_kernel<EPILOGUE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + ROWS - 1) / ROWS;
  band_matmul_kernel<EPILOGUE><<<blocks, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      m, inp, wh, w, rowptr, out, z_out, A, B, H, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at hidden width H.
size_t band_matmul_smem_bytes(int H) { return band_tile::smem_bytes(H); }

// out = act(inp_srev + z @ W_h); z is written when z_out is not null.
// Launches on `stream`; returns cudaGetLastError() as an int.
int band_matmul_act_f32(const float* m, const float* inp_srev,
                        const float* wh, const float* w, const int* rowptr,
                        float* out, float* z_out, int A, int B, int H,
                        int act, void* stream) {
  return launch<true>(m, inp_srev, wh, w, rowptr, out, z_out, A, B, H, act,
                      stream);
}

// out = z @ W_h and z, no residual and no activation.
int band_matmul_f32(const float* m, const float* wh, const float* w,
                    const int* rowptr, float* out, float* z_out, int A, int B,
                    int H, void* stream) {
  return launch<false>(m, nullptr, wh, w, rowptr, out, z_out, A, B, H, 0,
                       stream);
}

}  // extern "C"
