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
// Design (csr_rows.cuh, the weights kInStore, rows through csr_rows::Gather
// on srev): one thread per (atom, 16-byte column chunk) over a flattened
// index. A group of csr_rows::UNROLL run elements loads its srev entries
// (contiguous) and weights first, then all its rows g[srev c'] (each a
// coalesced 16-byte-a-thread read within its row), before the first add:
// three dependent round trips (rowptr, srev, the rows) where the forward
// kernels make two. For runs that fit one group, the rows stay in
// registers until dm[c'] = fmaf(w[c'], S, -g[srev c']) is written from
// them: g is read once. Longer runs read srev and their rows a second
// time. The padding rows are folded into the same grid: item (a, k) also
// writes dm = -g[srev r] for rows r = rowptr[A] + a, + a + A, ... below B,
// loaded together with its run. Every real row lies in exactly one run,
// so each dm row is written by exactly one thread. S is summed from 0 in
// CSR order and scaled by one fmaf, so with unit weights dm[c] is
// atom_readout.cu's S[a] of g[srev] less g[srev c] bit for bit. Rows that
// are not 16-byte aligned, or H % 4 != 0, take one column a thread.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(csr_rows::THREADS)
band_rev_bwd_kernel(const float* __restrict__ g,
                    const float* __restrict__ w,
                    const int* __restrict__ srev,
                    const int* __restrict__ rowptr,
                    float* __restrict__ dm, int A, int B, int H) {
  const csr_rows::Gather rev{srev};
  csr_rows::for_item(A, H / VEC, [&](int a, int k) {
    const int c0 = __ldg(rowptr + a);
    const int c1 = __ldg(rowptr + a + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float y[VEC];   // this item's first padding row, loaded with the run
    const size_t p =
        csr_rows::pad_first<VEC>(g, rowptr, A, B, H, col, a, y, rev);
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC, csr_rows::kInStore>(g, w, H, col, c0, c1, acc, x,
                                               wc, rev);
    csr_rows::run_store<VEC, csr_rows::kInStore>(g, w, dm, H, col, c0, c1,
                                                 acc, x, wc, rev);
    csr_rows::pad_store<VEC>(g, dm, A, B, H, col, p, y, rev);
  });
}

template <int VEC>
int launch(const float* g, const float* w, const int* srev,
           const int* rowptr, float* dm, int A, int B, int H,
           cudaStream_t stream) {
  const unsigned grid = csr_rows::blocks(A, H / VEC);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  band_rev_bwd_kernel<VEC><<<grid, csr_rows::THREADS, 0, stream>>>(
      g, w, srev, rowptr, dm, A, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches dm = M^T g on `stream`, 16 bytes a thread where H and the
// pointers allow it; returns cudaGetLastError() as an int. The padding
// rows are spread over the atoms' items, so A >= 1 (atom 0, the padding
// slot, is always there).
int band_rev_bwd_f32(const float* g, const float* w, const int* srev,
                     const int* rowptr, float* dm, int A, int B, int H,
                     void* stream) {
  if (A < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_rows::vec4_ok(H, g, dm)
             ? launch<4>(g, w, srev, rowptr, dm, A, B, H, s)
             : launch<1>(g, w, srev, rowptr, dm, A, B, H, s);
}

}  // extern "C"
