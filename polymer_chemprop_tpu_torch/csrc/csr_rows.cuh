// Reading CSR runs of rows over dst-sorted bonds at the H100's memory rate:
// the shared part of atom_readout.cu, band_agg.cu, band_bwd.cu and
// band_rev_bwd.cu.
//
// Each kernel sums, for an atom v and a slice of VEC columns, the rows of
// its run [rowptr[v], rowptr[v + 1]), and three of them then write one
// output row for every row of the run. Where the weights w act is the
// Weights switch:
//
//   kInSum (the forward kernels, atom_readout.cu, band_agg.cu):
//     acc = 0; for c in run(v): acc = fmaf(w[c], x_c, acc)
//     out[c] = acc - x_c
//   kInStore (their VJPs, band_bwd.cu, band_rev_bwd.cu):
//     acc = 0; for c in run(v): acc = acc + x_c     (= fmaf(1, x_c, acc))
//     out[c] = fmaf(w[c], acc, -x_c)
//   kUnit (atom_readout.cu's gather entry with unit weights): kInStore's
//     sum with w never read
//
// in CSR order from 0, which is the order of every z build in the port
// (band_rev_layer.cu, band_matmul.cu): the forward outputs equal those
// kernels' z bit for bit, and with unit weights the VJPs' dm equals the
// forward readout less the row bit for bit. x_c is row rows(c) of the
// input: row c itself (Direct) or row idx[c] (Gather; band_rev_bwd.cu reads
// g[srev c]); the weight of run element c is likewise w[wrows(c)], w[c]
// unless a run_sum caller passes another index map (atom_readout.cu's
// gather entry reads w[srev c] in 3b's VJP, and w[idx c] for molecules,
// with the row's own index: SameAsRows).
//
// What bounds them is HBM, and the design keeps many bytes in flight:
//
// * Work item = (atom, column chunk of VEC floats), one thread per item
//   over a flattened index, so every thread makes one round trip for the
//   whole run (a run's chunk at H = 300 is 75 float4 threads, not 10
//   passes of one warp).
// * The run is read in groups of UNROLL rows: the group's row indices
//   (for Gather), then its weights and rows, each load predicated on the
//   run's end and all issued before the first add; runs longer than
//   UNROLL loop over groups. The rows and weights of the last group stay
//   in registers, so a run that fits one group is read once.
// * Padding rows (p >= rowptr[A]) lie in no run and have weight 0, so
//   out[p] = -x_p. They are spread over the atoms' items without the host
//   knowing how many there are: item (v, k) takes rows rowptr[A] + v,
//   + v + A, ... below B, the first loaded together with its run.
// * Everything stays in registers (no shared memory, no atomics): every
//   output row is written by exactly one thread.
// * Inputs are read through the read-only path (ld.global.nc); the
//   16-byte path (VEC = 4) needs H % 4 == 0 and 16-byte aligned rows
//   (vec4_ok), else VEC = 1 reads one float a thread.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace csr_rows {

constexpr int THREADS = 128;
// rows of a run in flight together: every run of the bench batch fits one
// group (PERF.md §6)
constexpr int UNROLL = 4;

enum Weights { kInSum, kInStore, kUnit };

// the input row of run element c: c itself ...
struct Direct {
  __device__ __forceinline__ int operator()(int c) const { return c; }
};

// ... or idx[c]
struct Gather {
  const int* idx;
  __device__ __forceinline__ int operator()(int c) const {
    return __ldg(idx + c);
  }
};

// the weights through the rows' own map, w[rows(c)], read with the row
// index already loaded (a second read of idx[c] for them measured slower
// on the molecule readout)
struct SameAsRows {};

// the 16-byte path: every row of a width-H matrix at p and q starts on a
// 16-byte boundary
inline bool vec4_ok(int H, const void* p, const void* q) {
  return H % 4 == 0 && reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    static_assert(VEC == 1, "VEC is 1 or 4");
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// w[wrows(c)] for c in [base, min(base + UNROLL, c1)) (Direct: addressed
// from w + base, one pointer for the group)
template <class WRows = Direct>
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             int base, int c1,
                                             float (&wc)[UNROLL],
                                             const WRows& wrows = WRows()) {
#pragma unroll
  for (int r = 0; r < UNROLL; ++r)
    if (base + r < c1) {
      if constexpr (std::is_same<WRows, Direct>::value)
        wc[r] = __ldg(w + base + r);
      else
        wc[r] = __ldg(w + wrows(base + r));
    }
}

// input rows rows(c) for c in [base, min(base + UNROLL, c1)) at column
// col: the row indices first, then every row load, before any is used
template <int VEC, class Rows = Direct>
__device__ __forceinline__ void load_group(const float* __restrict__ m,
                                           size_t H, size_t col, int base,
                                           int c1, float (&x)[UNROLL][VEC],
                                           const Rows& rows = Rows()) {
  int row[UNROLL];
#pragma unroll
  for (int r = 0; r < UNROLL; ++r)
    if (base + r < c1) row[r] = rows(base + r);
#pragma unroll
  for (int r = 0; r < UNROLL; ++r)
    if (base + r < c1)
      load<VEC>(m + static_cast<size_t>(row[r]) * H + col, x[r]);
}

// acc = the run's sum over c in [c0, c1) at columns [col, col + VEC),
// weighted as WT says (the weight of c is w[wrows(c)], or w[rows(c)] with
// SameAsRows). On return x and wc hold the rows and weights of the last
// group, which is the whole run when c1 - c0 <= UNROLL.
template <int VEC, Weights WT = kInSum, class Rows = Direct,
          class WRows = Direct>
__device__ __forceinline__ void run_sum(const float* __restrict__ m,
                                        const float* __restrict__ w,
                                        size_t H, size_t col, int c0, int c1,
                                        float (&acc)[VEC],
                                        float (&x)[UNROLL][VEC],
                                        float (&wc)[UNROLL],
                                        const Rows& rows = Rows(),
                                        const WRows& wrows = WRows()) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int base = c0; base < c1; base += UNROLL) {
    if constexpr (std::is_same<WRows, SameAsRows>::value) {
      int row[UNROLL];
#pragma unroll
      for (int r = 0; r < UNROLL; ++r)
        if (base + r < c1) row[r] = rows(base + r);
#pragma unroll
      for (int r = 0; r < UNROLL; ++r)
        if (base + r < c1) {
          load<VEC>(m + static_cast<size_t>(row[r]) * H + col, x[r]);
          wc[r] = __ldg(w + row[r]);
        }
    } else {
      if constexpr (WT != kUnit) load_weights(w, base, c1, wc, wrows);
      load_group<VEC>(m, H, col, base, c1, x, rows);
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r)
      if (base + r < c1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = WT == kInSum ? fmaf(wc[r], x[r][e], acc[e])
                                : acc[e] + x[r][e];
      }
  }
}

// out[c] for c in [base, min(base + UNROLL, c1)) from the group's rows x
// and weights wc, as WT says
template <int VEC, Weights WT>
__device__ __forceinline__ void store_group(float* __restrict__ out,
                                            size_t H, size_t col, int base,
                                            int c1, const float (&acc)[VEC],
                                            const float (&x)[UNROLL][VEC],
                                            const float (&wc)[UNROLL]) {
#pragma unroll
  for (int r = 0; r < UNROLL; ++r)
    if (base + r < c1) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = WT == kInSum ? acc[e] - x[r][e]
                            : fmaf(wc[r], acc[e], -x[r][e]);
      store<VEC>(out + static_cast<size_t>(base + r) * H + col, o);
    }
}

// out[c] for every c of the run after run_sum: from the rows still in
// registers when the run fits one group, else reading them again
template <int VEC, Weights WT = kInSum, class Rows = Direct>
__device__ __forceinline__ void run_store(const float* __restrict__ m,
                                          const float* __restrict__ w,
                                          float* __restrict__ out, size_t H,
                                          size_t col, int c0, int c1,
                                          const float (&acc)[VEC],
                                          float (&x)[UNROLL][VEC],
                                          float (&wc)[UNROLL],
                                          const Rows& rows = Rows()) {
  if (c1 - c0 <= UNROLL) {
    store_group<VEC, WT>(out, H, col, c0, c1, acc, x, wc);
    return;
  }
  for (int base = c0; base < c1; base += UNROLL) {
    if constexpr (WT == kInStore) load_weights(w, base, c1, wc);
    load_group<VEC>(m, H, col, base, c1, x, rows);
    store_group<VEC, WT>(out, H, col, base, c1, acc, x, wc);
  }
}

// The padding rows of item v: p = rowptr[A] + v + jA below B, out[p] =
// -x_p. pad_first loads the first before the run is read and returns p;
// pad_store writes them all after it.
template <int VEC, class Rows = Direct>
__device__ __forceinline__ size_t pad_first(const float* __restrict__ m,
                                            const int* __restrict__ rowptr,
                                            int A, int B, size_t H,
                                            size_t col, int v,
                                            float (&y)[VEC],
                                            const Rows& rows = Rows()) {
  const size_t p = static_cast<size_t>(__ldg(rowptr + A)) + v;
  if (p < static_cast<size_t>(B))
    load<VEC>(m + static_cast<size_t>(rows(static_cast<int>(p))) * H + col,
              y);
  return p;
}

template <int VEC, class Rows = Direct>
__device__ __forceinline__ void pad_store(const float* __restrict__ m,
                                          float* __restrict__ out, int A,
                                          int B, size_t H, size_t col,
                                          size_t p, float (&y)[VEC],
                                          const Rows& rows = Rows()) {
  for (; p < static_cast<size_t>(B); p += A) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = -y[e];
    store<VEC>(out + p * H + col, y);
    const size_t q = p + A;
    if (q < static_cast<size_t>(B))
      load<VEC>(
          m + static_cast<size_t>(rows(static_cast<int>(q))) * H + col, y);
  }
}

// Calls item(v, chunk) for this thread's work item, if it has one: atom
// v < A, chunk < nc.
template <class Item>
__device__ __forceinline__ void for_item(int A, int nc, const Item& item) {
  const unsigned long long i =
      static_cast<unsigned long long>(blockIdx.x) * THREADS + threadIdx.x;
  const unsigned long long n = static_cast<unsigned long long>(A) * nc;
  if (i >= n) return;
  int v, k;
  if (n <= 0xffffffffull) {            // 32-bit division where it fits
    const unsigned ii = static_cast<unsigned>(i);
    v = static_cast<int>(ii / static_cast<unsigned>(nc));
    k = static_cast<int>(ii - static_cast<unsigned>(v) * nc);
  } else {
    v = static_cast<int>(i / nc);
    k = static_cast<int>(i - static_cast<unsigned long long>(v) * nc);
  }
  item(v, k);
}

// blocks of a launch over A atoms with nc chunks each
inline unsigned blocks(int A, int nc) {
  return static_cast<unsigned>(
      (static_cast<unsigned long long>(A) * nc + THREADS - 1) / THREADS);
}

}  // namespace csr_rows
