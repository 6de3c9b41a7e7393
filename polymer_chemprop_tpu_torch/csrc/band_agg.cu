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
//   A[v,:] = sum_{c in run(v)} w[c] m[c,:]      fmaf from 0 in CSR order
//   z[c,:] = A[v,:] - m[c,:]                    for every c in run(v)
// Padding rows (c >= rowptr[A]) belong to no run and have weight 0:
//   z[c,:] = -m[c,:]
// which is what the TPU kernel gives them. The order of the sum is the one
// of band_matmul.cu's z build, so z equals that kernel's z bit for bit.
//
// What bounds it on an H100: memory. m is read once and z written once
// (2*B*H*4 bytes, 67 MB at B = 28,032, H = 300) for about 2 operations per
// element: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel contracted a weighted one-hot band over a 512-bond window on the
// MXU; on Hopper every row of a run shares one sum, so the run is read
// through the CSR once with no window and no atomics.
//
// Design (csr_rows.cuh): one thread per (atom, 16-byte column chunk) over
// a flattened index. The run's rows are loaded csr_rows::UNROLL at a time
// before the first fmaf and, for runs that fit one group, stay in
// registers until z = A - m is written from them: m is read once. Longer
// runs read their rows a second time for z. The padding rows are folded into the same
// grid without the host knowing how many there are: item (v, k) also
// writes z = -m for rows rowptr[A] + v, rowptr[A] + v + A, ... below B,
// loaded together with its run. Every row is written by exactly one
// thread. Rows that are not 16-byte aligned, or H % 4 != 0, take one
// column a thread.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(csr_rows::THREADS)
band_agg_kernel(const float* __restrict__ m,
                const float* __restrict__ w,
                const int* __restrict__ rowptr,
                float* __restrict__ z, int A, int B, int H) {
  csr_rows::for_item(A, H / VEC, [&](int v, int k) {
    const int c0 = __ldg(rowptr + v);
    const int c1 = __ldg(rowptr + v + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float y[VEC];   // this item's first padding row, loaded with the run
    const size_t p = csr_rows::pad_first<VEC>(m, rowptr, A, B, H, col, v, y);
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC>(m, w, H, col, c0, c1, acc, x, wc);
    csr_rows::run_store<VEC>(m, w, z, H, col, c0, c1, acc, x, wc);
    csr_rows::pad_store<VEC>(m, z, A, B, H, col, p, y);
  });
}

template <int VEC>
int launch(const float* m, const float* w, const int* rowptr, float* z,
           int A, int B, int H, cudaStream_t stream) {
  const unsigned grid = csr_rows::blocks(A, H / VEC);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  band_agg_kernel<VEC><<<grid, csr_rows::THREADS, 0, stream>>>(
      m, w, rowptr, z, A, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches z = S m - m on `stream`, 16 bytes a thread where H and the
// pointers allow it; returns cudaGetLastError() as an int. The padding
// rows are spread over the atoms' items, so A >= 1 (atom 0, the padding
// slot, is always there).
int band_agg_f32(const float* m, const float* w, const int* rowptr, float* z,
                 int A, int B, int H, void* stream) {
  if (A < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_rows::vec4_ok(H, m, z)
             ? launch<4>(m, w, rowptr, z, A, B, H, s)
             : launch<1>(m, w, rowptr, z, A, B, H, s);
}

}  // extern "C"
