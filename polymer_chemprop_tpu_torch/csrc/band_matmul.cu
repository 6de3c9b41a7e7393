// The plain band aggregation with the W_h product fused, over dst-sorted
// bonds. Two functions, each with an FP32 entry point and a tensor-core
// one:
//
//   band_matmul_act: out = act(inp_srev + z @ W_h), z written when asked
//     Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py
//     _band_matmul_act_kernel, reached through _band_matmul_act_apply and
//     band_matmul_act_step_sorted (the undirected encoder's layer).
//   band_matmul:     out = z @ W_h and z
//     Replaces: _band_matmul_kernel, reached through _band_matmul_apply and
//     band_matmul_step_sorted.
//
// with z = S m - m, S[b, c] = w[c] * [dst c == dst b], W_h in (in, out)
// layout. For every sorted bond row t whose destination atom is v
// (run(v) = [rowptr[v], rowptr[v + 1]), rowptr from ops/sorted_aux.py):
//   z[t,:] = sum_{c in run(v)} w[c] m[c,:] - m[t,:]
// and padding rows (t >= rowptr[A], in no run) get z[t,:] = -m[t,:]. The
// caller pre-permutes the residual by srev and gathers out by srev
// afterwards (srev is an involution), as in the JAX package. Both entry
// points of a function build z alike, in FP32, bit for bit.
//
// band_matmul_act_f32, band_matmul_f32 (band_precision="highest"): the
// product in FP32 on the CUDA cores. What bounds it on an H100: 2*B*H^2
// FP32 operations (5.05 GFLOP at B = 28,032, H = 300) against ~3*B*H*4
// bytes of m, inp and out: about 50 operations per byte, above the card's
// FP32 ridge of 20, so FP32 FMA issue. Design: as band_rev_layer.cu, with
// which it shares the tile-product stage (band_tile.cuh). A block owns
// ROWS = 32 consecutive bond rows. Consecutive sorted rows have
// non-decreasing destination atoms, but the kernel is given no dst array:
// the first ROWS threads each find their row's atom by a binary search over
// rowptr (one search latency per block), then the warps build the z tile
// in shared memory, one row per warp at a time, lanes over the H columns.
//
// band_matmul_act_tc, band_matmul_tc (band_precision "high", passes = 3:
// z_hi W_hi + z_hi W_lo + z_lo W_hi; "default", passes = 1: z_hi W_hi): the
// product on the tensor cores, the split-bf16 arithmetic of the TPU
// kernels' _dot_band (pallas_mpnn.py:331-357). What bounds it on an H100:
// the three passes are 3 * 2*B*H^2 = 15.1 GFLOP, 0.015 ms at the 989
// TFLOP/s bf16 peak, while m, inp (or z) and out move ~101 MB, 0.030 ms at
// 3.35 TB/s: bytes. Design: the Hopper stage of band_tile_sm90.cuh (wgmma
// on 64-row tiles, z built and split chunk by chunk into a two-stage ring
// while the previous chunk's wgmmas run, W_h split once per call by
// split_wh_kernel and brought in by bulk copies), so the product costs a
// fraction of the bytes' time and what remains is the z build's CSR
// gather; its shared memory does not grow with H, so it serves every
// width the FP32 stage fits. The block's rows find their atoms as above.
#include <cuda_runtime.h>

#include "band_tile.cuh"
#include "band_tile_sm90.cuh"

namespace {

using namespace band_tile;

template <bool EPILOGUE>
__global__ void __launch_bounds__(THREADS, 2)
band_matmul_kernel(const float* __restrict__ m,
                   const float* __restrict__ inp,
                   const float* __restrict__ wh,
                   const float* __restrict__ w,
                   const int* __restrict__ rowptr,
                   float* __restrict__ out,
                   float* __restrict__ z_out,
                   int A, int B, int H, int act) {
  extern __shared__ float smem[];
  float* z_s = smem;                     // ROWS x z_stride(H)
  int* atom_s = tile_ints(smem, H);      // ROWS
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int zs = z_stride(H);

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
    float* zr = z_s + r * zs;
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
  product_stage<EPILOGUE>(smem, wh, inp, out, row0, B, H, act);
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

// the block's rows' runs, [c0, c1) of the destination atom (empty for a
// padding row), from a binary search over rowptr
__device__ __forceinline__ void find_runs(const int* __restrict__ rowptr,
                                          int* runs, int row0, int rows,
                                          int A, int B) {
  const int r = threadIdx.x;
  if (r >= rows) return;
  const int t = row0 + r;
  int c0 = 0, c1 = 0;
  if (t < B) {
    int lo = 0, hi = A + 1;              // first index with rowptr[.] > t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rowptr[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const int v = lo - 1;                // A for a padding row
    if (v < A) {
      c0 = rowptr[v];
      c1 = rowptr[v + 1];
    }
  }
  runs[2 * r] = c0;
  runs[2 * r + 1] = c1;
}

// z[t, col:col + 8] in the FP32 kernel's order: fma over the run, then the
// row itself subtracted
struct CsrZRow {
  const float* __restrict__ m;
  const float* __restrict__ w;
  const int* runs;
  int H;
  bool vec;

  __device__ __forceinline__ void operator()(int r, int t, int col,
                                             float (&v)[8]) const {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int c1 = runs[2 * r + 1];
    for (int c = runs[2 * r]; c < c1; ++c) {
      const float wc = w[c];
      float x[8];
      band_tile_sm90::load8(m + static_cast<size_t>(c) * H, col, H, vec, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wc, x[e], acc[e]);
    }
    float own[8];
    band_tile_sm90::load8(m + static_cast<size_t>(t) * H, col, H, vec, own);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = acc[e] - own[e];
  }
};

template <bool EPILOGUE, int PASSES>
__global__ void __launch_bounds__(band_tile_sm90::THREADS, 1)
band_matmul_tc_kernel(const float* __restrict__ m,
                      const float* __restrict__ inp,
                      const unsigned char* __restrict__ wsplit,
                      const float* __restrict__ w,
                      const int* __restrict__ rowptr,
                      float* __restrict__ out,
                      float* __restrict__ z_out,
                      int A, int B, int H, int act) {
  namespace tc = band_tile_sm90;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const tc::Layout L = tc::layout(tc_smem);
  const int row0 = blockIdx.x * tc::BM;
  find_runs(rowptr, L.rows, row0, tc::BM, A, B);
  const CsrZRow zrow{m, w, L.rows, H, (H & 3) == 0};
  tc::stage<EPILOGUE, PASSES>(L, zrow, wsplit, inp, out, z_out, row0, B, H,
                              act);
}

template <bool EPILOGUE, int PASSES>
int launch_tc_kernel(const float* m, const float* inp,
                     const unsigned char* wsplit, const float* w,
                     const int* rowptr, float* out, float* z_out, int A,
                     int B, int H, int act, cudaStream_t stream) {
  namespace tc = band_tile_sm90;
  cudaError_t err = cudaFuncSetAttribute(
      band_matmul_tc_kernel<EPILOGUE, PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tc::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + tc::BM - 1) / tc::BM;
  band_matmul_tc_kernel<EPILOGUE, PASSES>
      <<<blocks, tc::THREADS, tc::SMEM_BYTES, stream>>>(
          m, inp, wsplit, w, rowptr, out, z_out, A, B, H, act);
  return static_cast<int>(cudaGetLastError());
}

// W_h split into the scratch, then the stage; `passes` 3 or 1
template <bool EPILOGUE>
int launch_tc(const float* m, const float* inp, const float* wh,
              void* scratch, const float* w, const int* rowptr, float* out,
              float* z_out, int A, int B, int H, int act, int passes,
              void* stream_ptr) {
  namespace tc = band_tile_sm90;
  if (passes != 1 && passes != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* wsplit = static_cast<unsigned char*>(scratch);
  const cudaError_t err = tc::split_wh(wh, wsplit, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return passes == 3
      ? launch_tc_kernel<EPILOGUE, 3>(m, inp, wsplit, w, rowptr, out, z_out,
                                      A, B, H, act, stream)
      : launch_tc_kernel<EPILOGUE, 1>(m, inp, wsplit, w, rowptr, out, z_out,
                                      A, B, H, act, stream);
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

// Bytes of dynamic shared memory one block of the tensor-core stage needs,
// at every H.
size_t band_matmul_tc_smem_bytes(void) { return band_tile_sm90::SMEM_BYTES; }

// Bytes of the split-W_h scratch the tensor-core entry points take at H.
size_t band_matmul_tc_scratch_bytes(int H) {
  return band_tile_sm90::scratch_bytes(H);
}

// out = act(inp_srev + z @ W_h) with the product in `passes` (3 or 1) bf16
// passes on the tensor cores; z (FP32) written when z_out is not null.
// `scratch` holds band_matmul_tc_scratch_bytes(H) bytes, 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() as an int.
int band_matmul_act_tc(const float* m, const float* inp_srev,
                       const float* wh, void* scratch, const float* w,
                       const int* rowptr, float* out, float* z_out, int A,
                       int B, int H, int act, int passes, void* stream) {
  return launch_tc<true>(m, inp_srev, wh, scratch, w, rowptr, out, z_out, A,
                         B, H, act, passes, stream);
}

// out = z @ W_h and z, on the tensor cores as band_matmul_act_tc.
int band_matmul_tc(const float* m, const float* wh, void* scratch,
                   const float* w, const int* rowptr, float* out,
                   float* z_out, int A, int B, int H, int passes,
                   void* stream) {
  return launch_tc<false>(m, nullptr, wh, scratch, w, rowptr, out, z_out, A,
                          B, H, 0, passes, stream);
}

}  // extern "C"
