// Weighted incoming-bond sum per atom over dst-sorted bonds, in FP32.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _atom_band_kernel,
// reached through _atom_band_apply and atom_readout_sorted.
//
//   a[v,:] = sum_{c in [rowptr[v], rowptr[v + 1])} w[c] m[c,:]      (A, H) out
//
// What bounds it on an H100: memory. Each real bond row of m is read once
// and each atom row of a written once (about 34 MB at the bench shape of
// 28k bonds and 1024 molecules, H = 300), for 2 operations per element
// read: far below the FP32 ridge of ~20 operations per byte. The TPU
// kernel ran the scatter as a one-hot band matmul on the MXU over a
// 1024-bond window per 256-atom tile; on Hopper a segment reduction over
// the CSR moves the least bytes and needs no atomics.
//
// Design: one warp per atom, lanes over the H columns, so each incoming
// bond row is one coalesced read; the run is summed in registers in CSR
// order and the row stored once. The padding atom 0 has an empty run and
// comes out exactly 0.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
atom_readout_kernel(const float* __restrict__ m,
                    const float* __restrict__ w,
                    const int* __restrict__ rowptr,
                    float* __restrict__ out, int A, int H) {
  const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= A) return;
  const int c0 = rowptr[v];
  const int c1 = rowptr[v + 1];
  float* o = out + static_cast<size_t>(v) * H;
  for (int j = lane; j < H; j += 32) {
    float acc = 0.f;
    for (int c = c0; c < c1; ++c)
      acc = fmaf(w[c], m[static_cast<size_t>(c) * H + j], acc);
    o[j] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the readout on `stream`; returns cudaGetLastError() as an int.
int atom_readout_f32(const float* m, const float* w, const int* rowptr,
                     float* out, int A, int H, void* stream) {
  const int blocks = (A + WARPS - 1) / WARPS;
  atom_readout_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      m, w, rowptr, out, A, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
