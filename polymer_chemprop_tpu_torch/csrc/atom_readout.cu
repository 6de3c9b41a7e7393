// Weighted incoming-bond sum per atom over dst-sorted bonds, in FP32.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _atom_band_kernel,
// reached through _atom_band_apply and atom_readout_sorted.
//
//   a[v,:] = sum_{c in [rowptr[v], rowptr[v + 1])} w[c] m[c,:]      (A, H) out
//
// summed with fmaf from 0 in CSR order, so that a[src t] - m[srev t] is the
// rev-fused layer's z (band_rev_layer.cu) bit for bit.
//
// What bounds it on an H100: memory. Each real bond row of m is read once
// and each atom row of a written once (about 34 MB at the bench shape of
// 28k bonds and 1024 molecules, H = 300), for 2 operations per element
// read: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel ran the scatter as a one-hot band matmul on the MXU over a
// 1024-bond window per 256-atom tile; on Hopper a segment reduction over
// the CSR moves the least bytes and needs no atomics.
//
// Design (csr_rows.cuh): one thread per (atom, 16-byte column chunk) over
// a flattened index, the run's rows loaded csr_rows::UNROLL at a time
// before the first fmaf, m through the read-only path, the chunk of a stored once.
// The padding atom 0 has an empty run and comes out exactly 0. Rows that
// are not 16-byte aligned, or H % 4 != 0, take one column a thread.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(csr_rows::THREADS)
atom_readout_kernel(const float* __restrict__ m,
                    const float* __restrict__ w,
                    const int* __restrict__ rowptr,
                    float* __restrict__ out, int A, int H) {
  csr_rows::for_item(A, H / VEC, [&](int v, int k) {
    const int c0 = __ldg(rowptr + v);
    const int c1 = __ldg(rowptr + v + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC>(m, w, H, col, c0, c1, acc, x, wc);
    csr_rows::store<VEC>(out + static_cast<size_t>(v) * H + col, acc);
  });
}

template <int VEC>
int launch(const float* m, const float* w, const int* rowptr, float* out,
           int A, int H, cudaStream_t stream) {
  const unsigned grid = csr_rows::blocks(A, H / VEC);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  atom_readout_kernel<VEC><<<grid, csr_rows::THREADS, 0, stream>>>(
      m, w, rowptr, out, A, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the readout on `stream`, 16 bytes a thread where H and the
// pointers allow it; returns cudaGetLastError() as an int.
int atom_readout_f32(const float* m, const float* w, const int* rowptr,
                     float* out, int A, int H, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_rows::vec4_ok(H, m, out)
             ? launch<4>(m, w, rowptr, out, A, H, s)
             : launch<1>(m, w, rowptr, out, A, H, s);
}

}  // extern "C"
