// Weighted incoming-bond sum per atom over dst-sorted bonds, in FP32; the
// same sum over rows gathered from a table; and the molecule readout.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _atom_band_kernel,
// reached through _atom_band_apply: by atom_readout_sorted on bond rows
// (atom_readout_f32), and by atom_neighbor_sum_sorted and
// src_readout_sorted on the gathered atom rows h[src_sorted]
// (atom_gather_readout_f32, the atom_messages encoder; a null w means unit
// weights). molecule_readout_f32 is the same gather sum over the molecule
// CSR of ops/sorted_aux.py with the readout's aggregation applied to it
// (the JAX package sums molecules with a segment sum, no Pallas kernel).
//
//   atom_readout_f32:         a[v,:] = sum_{c in run(v)} w[c] m[c,:]
//   atom_gather_readout_f32:  a[v,:] = sum_{c in run(v)} wt(c) h[idx[c],:]
//                             wt(c) = 1, w[c] or w[widx[c]]
//   molecule_readout_f32:     s[m,:] = sum_{c in run(m)} w[idx[c]] h[idx[c],:]
//                             out[m,:] = aggregate(s[m,:])
//
// run(v) = [rowptr[v], rowptr[v + 1]), summed with fmaf from 0 in CSR
// order, so that a[src t] - m[srev t] is the rev-fused layer's z
// (band_rev_layer.cu) bit for bit, and each gather entry equals
// atom_readout_f32 on the gathered copy h[idx] (with the gathered weights)
// bit for bit without ever writing that copy. The aggregation is torch's
// ops on the sum in torch's order (ops/band_mpnn.py aggregate_molecules):
//   mean: q = s / max(denom, 1e-12); q = denom > 0 ? q : 0; out = q * dop
//   sum:  out = s * dop
//   norm: out = (s * inv_norm) * dop, inv_norm = 1.0f / float(norm) from
//         the host: torch's CUDA division by a Python scalar multiplies by
//         its float reciprocal (BinaryDivTrueKernel.cu, a CPU scalar)
// compiled without fast math, so that '/' rounds correctly.
//
// What bounds them on an H100: memory. atom_readout_f32 reads each real
// bond row of m once and writes each atom row once (about 34 MB at the
// bench shape of 28k bonds and 1024 molecules, H = 300), for 2 operations
// per element read: far below the FP32 ridge of ~20 operations per byte.
// The gather entry reads each atom row of h about B / A ~ 2 times; the
// (A, H) table (16 MB at the bench shape) fits the 50 MB L2. The molecule
// readout reads each real atom row once and writes (M, H), about 17.8 MB
// at the bench batch. The TPU kernel ran the scatter as a one-hot band
// matmul on the MXU over a 1024-bond window per 256-atom tile; on Hopper a
// segment reduction over the CSR moves the least bytes and needs no
// atomics.
//
// Design (csr_rows.cuh), one kernel for all three entries: one thread per
// (output row, 16-byte column chunk) over a flattened index, the run's
// rows loaded csr_rows::UNROLL = 4 at a time before the first fmaf (the
// gather entries first load their indices idx[c]: csr_rows::Gather; the
// weights through widx, the same map on w, or for the molecules through
// the rows' own indices: csr_rows::SameAsRows),
// inputs through the read-only path, the chunk of the output stored once.
// * The molecule readout is the gather entry with widx = idx and an
//   epilogue that aggregates the sum in registers: one launch where it was
//   the gather entry, a weight gather and about seven elementwise launches
//   (PERF.md §6: at the bench batch 0.019 ms cold, as fast as the gather
//   entry alone on weights gathered beforehand).
// * A run is never split across threads: a tree sum would change the
//   bits. At the bench batch's molecule runs of 13-15 atoms, 8 or 16 rows
//   in flight measured slower than 4 (PERF.md §6): ptxas issues the first
//   fmaf before the last loads to hold the registers down, and occupancy
//   falls. So the molecules keep the atom runs' group of 4.
// * No atomics and no shared memory: every output element is written by
//   exactly one thread, after its whole run. Rows that are not 16-byte
//   aligned, or H % 4 != 0, take one column a thread. The padding atom 0
//   and any molecule with no atoms have an empty run: their sum is exactly
//   0 (and the mean's 0 denominator selects 0).
#include <cuda_runtime.h>

#include <cmath>

#include "csr_rows.cuh"

namespace {

// the readout's aggregation of the sum (molecule_readout_f32's modes)
enum Aggregation { kMean = 1, kSum = 2, kNorm = 3 };

// the mean's denominator clamp: torch.clamp(denom, min=1e-12) in float
constexpr float kMinDenom = 1e-12f;

// the sum as it is (atom_readout_f32, atom_gather_readout_f32)
struct AsSummed {
  template <int VEC>
  __device__ __forceinline__ void operator()(int, float (&)[VEC]) const {}
};

// the molecule readout's aggregation of row v's sum, in registers (its
// operands read after the run: read before it, they measured slower)
struct Aggregate {
  const float* __restrict__ denom;  // (M,), read for kMean only
  const float* __restrict__ dop;    // (M,)
  int agg;
  float inv_norm;

  template <int VEC>
  __device__ __forceinline__ void operator()(int v, float (&acc)[VEC]) const {
    const float p = __ldg(dop + v);
    if (agg == kMean) {
      const float d = __ldg(denom + v);
      const float dc = isnan(d) ? d : fmaxf(d, kMinDenom);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float q = acc[e] / dc;
        acc[e] = (d > 0.f ? q : 0.f) * p;
      }
    } else if (agg == kSum) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] * p;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = (acc[e] * inv_norm) * p;
    }
  }
};

// WT is csr_rows::kInSum (weights w) or csr_rows::kUnit (w not read); Rows
// csr_rows::Direct (row c of m) or csr_rows::Gather (row idx[c]); WRows the
// same for the weights; Epilogue AsSummed or Aggregate
template <int VEC, csr_rows::Weights WT, class Rows, class WRows,
          class Epilogue>
__global__ void __launch_bounds__(csr_rows::THREADS)
atom_readout_kernel(const float* __restrict__ m,
                    const float* __restrict__ w,
                    const int* __restrict__ rowptr,
                    float* __restrict__ out, int A, int H, Rows rows,
                    WRows wrows, Epilogue epilogue) {
  csr_rows::for_item(A, H / VEC, [&](int v, int k) {
    const int c0 = __ldg(rowptr + v);
    const int c1 = __ldg(rowptr + v + 1);
    const size_t col = static_cast<size_t>(k) * VEC;
    float acc[VEC], x[csr_rows::UNROLL][VEC], wc[csr_rows::UNROLL];
    csr_rows::run_sum<VEC, WT>(m, w, H, col, c0, c1, acc, x, wc, rows,
                               wrows);
    epilogue(v, acc);
    csr_rows::store<VEC>(out + static_cast<size_t>(v) * H + col, acc);
  });
}

template <csr_rows::Weights WT, class Rows, class WRows = csr_rows::Direct,
          class Epilogue = AsSummed>
int launch(const float* m, const float* w, const int* rowptr, float* out,
           int A, int H, Rows rows, cudaStream_t stream,
           WRows wrows = WRows(), Epilogue epilogue = Epilogue()) {
  const bool vec4 = csr_rows::vec4_ok(H, m, out);
  const unsigned grid = csr_rows::blocks(A, vec4 ? H / 4 : H);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  if (vec4)
    atom_readout_kernel<4, WT, Rows, WRows, Epilogue>
        <<<grid, csr_rows::THREADS, 0, stream>>>(m, w, rowptr, out, A, H,
                                                 rows, wrows, epilogue);
  else
    atom_readout_kernel<1, WT, Rows, WRows, Epilogue>
        <<<grid, csr_rows::THREADS, 0, stream>>>(m, w, rowptr, out, A, H,
                                                 rows, wrows, epilogue);
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

// The readout of the gathered rows h[idx[c]] of a row table h: idx, and w
// and widx where given, are (B,), read only inside the runs. The weight of
// run element c is 1 (w null: never read), w[c] (widx null) or w[widx[c]]
// (read with the row's index when widx is idx). 16 bytes a thread where H
// and the pointers of h and out allow it.
int atom_gather_readout_f32(const float* h, const int* idx, const float* w,
                            const int* widx, const int* rowptr, float* out,
                            int A, int H, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const csr_rows::Gather rows{idx};
  if (!w) return launch<csr_rows::kUnit>(h, w, rowptr, out, A, H, rows, s);
  if (!widx)
    return launch<csr_rows::kInSum>(h, w, rowptr, out, A, H, rows, s);
  if (widx == idx)
    return launch<csr_rows::kInSum>(h, w, rowptr, out, A, H, rows, s,
                                    csr_rows::SameAsRows{});
  return launch<csr_rows::kInSum>(h, w, rowptr, out, A, H, rows, s,
                                  csr_rows::Gather{widx});
}

// The molecule readout over a molecule CSR (idx (A,), rowptr (M + 1,)):
// the gather entry's sum of w[idx[c]] h[idx[c]] over each molecule's run,
// then aggregation `agg` (1 mean with denom (M,), 2 sum, 3 norm with
// inv_norm), each row scaled by dop (M,); any other agg is
// cudaErrorInvalidValue.
int molecule_readout_f32(const float* h, const int* idx, const float* w,
                         const int* rowptr, const float* denom,
                         const float* dop, float* out, int M, int H, int agg,
                         float inv_norm, void* stream) {
  if (agg < kMean || agg > kNorm)
    return static_cast<int>(cudaErrorInvalidValue);
  const csr_rows::Gather rows{idx};
  return launch<csr_rows::kInSum>(h, w, rowptr, out, M, H, rows,
                                  static_cast<cudaStream_t>(stream),
                                  csr_rows::SameAsRows{},
                                  Aggregate{denom, dop, agg, inv_norm});
}

}  // extern "C"
