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
// Design (csr_rows.cuh, the weights kInStore): one thread per (atom,
// 16-byte column chunk) over a flattened index. The run's rows and
// weights are loaded csr_rows::UNROLL at a time before the first add and,
// for runs that fit one group, stay in registers until dm = fmaf(w, G, -g)
// is written from them: g is read once. Longer runs read their rows a
// second time for dm. The padding rows are folded into the same grid
// without the host knowing how many there are: item (v, k) also writes
// dm = -g for rows rowptr[A] + v, rowptr[A] + v + A, ... below B, loaded
// together with its run. Every row is written by exactly one thread. G is
// summed from 0 in CSR order and scaled by one fmaf, so with unit weights
// dm[c] is atom_readout.cu's G[v] - g[c] bit for bit. Rows that are not
// 16-byte aligned, or H % 4 != 0, take one column a thread.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(csr_rows::THREADS)
band_bwd_kernel(const float* __restrict__ g,
                const float* __restrict__ w,
                const int* __restrict__ rowptr,
                float* __restrict__ dm, int A, int B, int H) {
  csr_rows::for_item(A, H / VEC, [&](int v, int k) {
    const int c0 = __ldg(rowptr + v);
    const int c1 = __ldg(rowptr + v + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float y[VEC];   // this item's first padding row, loaded with the run
    const size_t p = csr_rows::pad_first<VEC>(g, rowptr, A, B, H, col, v, y);
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC, csr_rows::kInStore>(g, w, H, col, c0, c1, acc, x,
                                               wc);
    csr_rows::run_store<VEC, csr_rows::kInStore>(g, w, dm, H, col, c0, c1,
                                                 acc, x, wc);
    csr_rows::pad_store<VEC>(g, dm, A, B, H, col, p, y);
  });
}

template <int VEC>
int launch(const float* g, const float* w, const int* rowptr, float* dm,
           int A, int B, int H, cudaStream_t stream) {
  const unsigned grid = csr_rows::blocks(A, H / VEC);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  band_bwd_kernel<VEC><<<grid, csr_rows::THREADS, 0, stream>>>(
      g, w, rowptr, dm, A, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches dm = S^T g - g on `stream`, 16 bytes a thread where H and the
// pointers allow it; returns cudaGetLastError() as an int. The padding
// rows are spread over the atoms' items, so A >= 1 (atom 0, the padding
// slot, is always there).
int band_bwd_f32(const float* g, const float* w, const int* rowptr, float* dm,
                 int A, int B, int H, void* stream) {
  if (A < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_rows::vec4_ok(H, g, dm)
             ? launch<4>(g, w, rowptr, dm, A, B, H, s)
             : launch<1>(g, w, rowptr, dm, A, B, H, s);
}

}  // extern "C"
