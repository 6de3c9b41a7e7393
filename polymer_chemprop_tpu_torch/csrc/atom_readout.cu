// Weighted incoming-bond sum per atom over dst-sorted bonds, in FP32, and
// the same sum over rows gathered from an atom table.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _atom_band_kernel,
// reached through _atom_band_apply: by atom_readout_sorted on bond rows
// (atom_readout_f32), and by atom_neighbor_sum_sorted and
// src_readout_sorted on the gathered atom rows h[src_sorted]
// (atom_gather_readout_f32, the atom_messages encoder; a null w means unit
// weights).
//
//   atom_readout_f32:         a[v,:] = sum_{c in run(v)} w[c] m[c,:]
//   atom_gather_readout_f32:  a[v,:] = sum_{c in run(v)} w[c] h[idx[c],:]
//
// run(v) = [rowptr[v], rowptr[v + 1]), (A, H) out, summed with fmaf from 0
// in CSR order, so that a[src t] - m[srev t] is the rev-fused layer's z
// (band_rev_layer.cu) bit for bit, and the gather entry equals
// atom_readout_f32 on the gathered copy h[idx] bit for bit without ever
// writing that (B, H) copy.
//
// What bounds it on an H100: memory. Each real bond row of m is read once
// and each atom row of a written once (about 34 MB at the bench shape of
// 28k bonds and 1024 molecules, H = 300), for 2 operations per element
// read: far below the FP32 ridge of ~20 operations per byte. The gather
// entry reads each atom row of h about B / A ~ 2 times; the (A, H) table
// (16 MB at the bench shape) fits the 50 MB L2, so HBM sees it about once.
// The TPU kernel ran the scatter as a one-hot band matmul on the MXU over
// a 1024-bond window per 256-atom tile; on Hopper a segment reduction over
// the CSR moves the least bytes and needs no atomics.
//
// Design (csr_rows.cuh): one thread per (atom, 16-byte column chunk) over
// a flattened index, the run's rows loaded csr_rows::UNROLL at a time
// before the first fmaf (the gather entry first loads their indices
// idx[c]: csr_rows::Gather), inputs through the read-only path, the chunk
// of a stored once. The padding atom 0 has an empty run and comes out
// exactly 0. Rows that are not 16-byte aligned, or H % 4 != 0, take one
// column a thread.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

// WT is csr_rows::kInSum (weights w) or csr_rows::kUnit (w not read); Rows
// csr_rows::Direct (row c of m) or csr_rows::Gather (row idx[c])
template <int VEC, csr_rows::Weights WT, class Rows>
__global__ void __launch_bounds__(csr_rows::THREADS)
atom_readout_kernel(const float* __restrict__ m,
                    const float* __restrict__ w,
                    const int* __restrict__ rowptr,
                    float* __restrict__ out, int A, int H, Rows rows) {
  csr_rows::for_item(A, H / VEC, [&](int v, int k) {
    const int c0 = __ldg(rowptr + v);
    const int c1 = __ldg(rowptr + v + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC, WT>(m, w, H, col, c0, c1, acc, x, wc, rows);
    csr_rows::store<VEC>(out + static_cast<size_t>(v) * H + col, acc);
  });
}

template <csr_rows::Weights WT, class Rows>
int launch(const float* m, const float* w, const int* rowptr, float* out,
           int A, int H, Rows rows, cudaStream_t stream) {
  const bool vec4 = csr_rows::vec4_ok(H, m, out);
  const unsigned grid = csr_rows::blocks(A, vec4 ? H / 4 : H);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  if (vec4)
    atom_readout_kernel<4, WT, Rows><<<grid, csr_rows::THREADS, 0, stream>>>(
        m, w, rowptr, out, A, H, rows);
  else
    atom_readout_kernel<1, WT, Rows><<<grid, csr_rows::THREADS, 0, stream>>>(
        m, w, rowptr, out, A, H, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the readout on `stream`, 16 bytes a thread where H and the
// pointers allow it; returns cudaGetLastError() as an int.
int atom_readout_f32(const float* m, const float* w, const int* rowptr,
                     float* out, int A, int H, void* stream) {
  return launch<csr_rows::kInSum>(m, w, rowptr, out, A, H,
                                 csr_rows::Direct{},
                                 static_cast<cudaStream_t>(stream));
}

// The readout of the gathered rows h[idx[c]] of an (A, H) atom table: w and
// idx are (B,), read only inside the runs; a null w means unit weights
// (acc + x, which is fmaf(1, x, acc) bit for bit). 16 bytes a thread where
// H and the pointers of h and out allow it.
int atom_gather_readout_f32(const float* h, const int* idx, const float* w,
                            const int* rowptr, float* out, int A, int H,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const csr_rows::Gather rows{idx};
  return w ? launch<csr_rows::kInSum>(h, w, rowptr, out, A, H, rows, s)
           : launch<csr_rows::kUnit>(h, w, rowptr, out, A, H, rows, s);
}

}  // extern "C"
