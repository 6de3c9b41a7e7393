// Reading CSR runs of rows over dst-sorted bonds at the H100's memory rate:
// the shared part of atom_readout.cu and band_agg.cu.
//
// Both kernels sum, for an atom v and a slice of VEC columns, the rows of
// its run [rowptr[v], rowptr[v + 1]) weighted by w:
//
//   acc = 0; for c in run(v): acc = fmaf(w[c], m[c, j], acc)
//
// in that order, which is the order of every z build in the port
// (band_rev_layer.cu, band_matmul.cu), so that their outputs equal those
// kernels' z bit for bit.
//
// What bounds them is HBM, and the design keeps many bytes in flight:
//
// * Work item = (atom, column chunk of VEC floats), one thread per item
//   over a flattened index, so every thread makes one round trip for the
//   whole run (a run's chunk at H = 300 is 75 float4 threads, not 10
//   passes of one warp).
// * The run is read in groups of UNROLL rows whose loads are all issued,
//   each predicated on the run's end, before the first fmaf; runs longer
//   than UNROLL loop over groups. The rows of the last group stay in
//   registers.
// * m is read through the read-only path (ld.global.nc); the 16-byte path
//   (VEC = 4) needs H % 4 == 0 and 16-byte aligned rows (vec4_ok), else
//   VEC = 1 reads one float a thread.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace csr_rows {

constexpr int THREADS = 128;
// rows of a run in flight together: every run of the bench batch fits one
// group (PERF.md §6)
constexpr int UNROLL = 4;

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

// rows [base, min(base + UNROLL, c1)) of m at column col, all loads issued
// before any is used
template <int VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ m,
                                           size_t H, size_t col, int base,
                                           int c1, float (&x)[UNROLL][VEC]) {
#pragma unroll
  for (int r = 0; r < UNROLL; ++r)
    if (base + r < c1)
      load<VEC>(m + static_cast<size_t>(base + r) * H + col, x[r]);
}

// acc = sum over c in [c0, c1) of w[c] m[c, col:col + VEC], fmaf from 0 in
// CSR order. On return x holds the rows of the last group, which is the
// whole run when c1 - c0 <= UNROLL.
template <int VEC>
__device__ __forceinline__ void run_sum(const float* __restrict__ m,
                                        const float* __restrict__ w,
                                        size_t H, size_t col, int c0, int c1,
                                        float (&acc)[VEC],
                                        float (&x)[UNROLL][VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int base = c0; base < c1; base += UNROLL) {
    float wc[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r)
      if (base + r < c1) wc[r] = __ldg(w + base + r);
    load_group<VEC>(m, H, col, base, c1, x);
#pragma unroll
    for (int r = 0; r < UNROLL; ++r)
      if (base + r < c1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wc[r], x[r][e], acc[e]);
      }
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
