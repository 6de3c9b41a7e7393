// A split-bf16 ("3xBF16") matrix product on the tensor cores:
//   out = x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi        (float32 out)
// with x (N, K) float32 split as it is staged, x_hi = bf16_rn(x) and
// x_lo = bf16_rn(x - x_hi), and b_hi, b_lo (K, M) bf16 split once by the
// caller (ops/probe_kernels.py split_bf16). Every bf16 x bf16 product is
// exact in float32.
//
// Replaces: scripts/fused_matmul_probe.py _fused_kernel (through
// fused_matmul), the TPU's in-register hi/lo split with three MXU passes;
// the same split as polymer_chemprop_tpu/ops/pallas_mpnn.py _dot_band at
// Precision.HIGH.
//
// What bounds it on an H100: at (28,032 x 300) @ (300 x 300) the three
// passes are 3 * 2*N*K*M = 1.5 GFLOP, 0.0153 ms at the 989 TFLOP/s bf16
// tensor-core peak, while x read once and out written once are
// 2*N*K*4 + 2*K*M*2 bytes = 67 MB, 0.020 ms at 3.35 TB/s: bound by bytes.
//
// Design: the Hopper machinery of band_tile_sm90.cuh (the band layers'
// split-bf16 stage) for a dense x, with the product alone, so that its time
// is that stage's without the CSR z build and the epilogue:
//   * pack_b_kernel lays b_hi and b_lo into the stage's scratch layout
//     (K-major, 128-byte swizzled, zero past K and M, one slice of NP = 304
//     output columns by KC = 64 depths per (column pass, depth chunk)), for
//     any K and M; one bulk copy a step lands a slice on an mbarrier;
//   * a block of two warpgroups owns 64 rows and one column pass (an
//     item); the blocks are persistent (one per SM, items strided over the
//     grid, a tile's passes on neighbouring blocks so that the second read
//     of its x rows hits L2), so one item's epilogue overlaps the next
//     item's loads;
//   * x goes through registers: each thread loads its two 8-float pieces
//     of the next step's chunk before the current step's wgmmas are
//     issued, so the loads are in flight during them; it then splits them
//     into the swizzled bf16 halves of a 2-stage ring. The rows of the
//     block's next item are prefetched into L2 when an item starts;
//   * per step and warpgroup 4 k16 steps x 3 wgmma.m64n152k16 with both
//     operands in shared memory, hi x hi in one accumulator and the two
//     cross terms in another (band_tile_sm90.cuh says why), added in the
//     epilogue, which stores from the fragment.
// Columns and depths past M and K are zero in both halves of both operands
// and rows past N are zero in x, so the edges need no masks in the
// product. Shared memory is the stage's (band_tile_sm90::SMEM_BYTES).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_tile_sm90.cuh"

namespace {

namespace tc = band_tile_sm90;

// Bytes of the packed b at (K, M): one slice per (column pass, chunk).
size_t scratch_bytes(int K, int M) {
  return static_cast<size_t>((M + tc::NP - 1) / tc::NP) *
         ((K + tc::KC - 1) / tc::KC) * tc::SLICE_BYTES;
}

// b_hi, b_lo (K, M) into the scratch: slice (pass p, chunk kc) row n holds
// b[kc KC .. + KC, p NP + n], hi block then lo block, swizzled as in shared
// memory; one thread per 16-byte piece of the hi block, `pieces` =
// passes x chunks x 8 x NP (band_tile_sm90.cuh split_wh_kernel's layout)
__global__ void pack_b_kernel(const uint16_t* __restrict__ b_hi,
                              const uint16_t* __restrict__ b_lo,
                              unsigned char* __restrict__ scratch, int K,
                              int M, int nkc, int pieces) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pieces) return;
  const int n = idx % tc::NP;
  const int q = (idx / tc::NP) & 7;
  const int slice = idx / (tc::NP * 8);
  const int p = slice / nkc;
  const int kc = slice - p * nkc;
  const int gn = p * tc::NP + n;
  const int k0 = kc * tc::KC + q * 8;
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t hv = 0, lv = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + 2 * e + half;
      if (k < K && gn < M) {
        const size_t o = static_cast<size_t>(k) * M + gn;
        hv |= static_cast<uint32_t>(b_hi[o]) << (16 * half);
        lv |= static_cast<uint32_t>(b_lo[o]) << (16 * half);
      }
    }
    h[e] = hv;
    l[e] = lv;
  }
  unsigned char* dst = scratch + static_cast<size_t>(slice) * tc::SLICE_BYTES +
                       tc::swizzled(n, q);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(dst + tc::B_BYTES) =
      make_uint4(l[0], l[1], l[2], l[3]);
}

constexpr int PIECES = tc::BM * 8 / tc::THREADS;   // x pieces a thread (2)

// this thread's pieces of x[row0:row0 + BM, col0:col0 + KC], 0 past N, K
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           int row0, int col0, int N, int K,
                                           bool vec, float (&v)[PIECES][8]) {
#pragma unroll
  for (int h = 0; h < PIECES; ++h) {
    const int piece = threadIdx.x + h * tc::THREADS;
    const int t = row0 + (piece >> 3);
    if (t < N) {
      tc::load8(x + static_cast<size_t>(t) * K, col0 + (piece & 7) * 8, K,
                vec, v[h]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[h][e] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(tc::THREADS, 1)
fused_matmul_kernel(const float* __restrict__ x,
                    const unsigned char* __restrict__ bsplit,
                    float* __restrict__ out, int N, int K, int M,
                    int passes, int items) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const tc::Layout L = tc::layout(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int nkc = (K + tc::KC - 1) / tc::KC;
  const int stride = gridDim.x;
  // this block's items: blockIdx.x, + stride, ...; nkc steps each
  const int total = (items - blockIdx.x + stride - 1) / stride * nkc;
  const bool vec = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < tc::STAGES; ++s) tc::mbar_init(&L.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step s works on item blockIdx.x + (s / nkc) stride, chunk s % nkc, and
  // reads slice (pass, chunk) of the packed b
  auto copy_slice = [&](int s) {
    const int item = blockIdx.x + (s / nkc) * stride;
    const int slice = (item % passes) * nkc + s % nkc;
    uint64_t* bar = &L.full[s % tc::STAGES];
    tc::mbar_expect_tx(bar, tc::SLICE_BYTES);
    tc::bulk_copy(L.stage + (s % tc::STAGES) * tc::STAGE_BYTES +
                      2 * tc::A_BYTES,
                  bsplit + static_cast<size_t>(slice) * tc::SLICE_BYTES,
                  tc::SLICE_BYTES, bar);
  };
  if (tid == 0) copy_slice(0);
  float v[PIECES][8];
  load_chunk(x, (blockIdx.x / passes) * tc::BM, 0, N, K, vec, v);

  float acc[tc::ACC], cor[tc::ACC];
#pragma unroll
  for (int i = 0; i < tc::ACC; ++i) acc[i] = cor[i] = 0.f;
  for (int s = 0; s < total; ++s) {
    const int item = blockIdx.x + (s / nkc) * stride;
    const int kc = s % nkc;
    const int row0 = (item / passes) * tc::BM;
    unsigned char* st = L.stage + (s % tc::STAGES) * tc::STAGE_BYTES;

    if (kc == 0 && item + stride < items)   // the next item's rows, into L2
      tc::prefetch_rows(x, ((item + stride) / passes) * tc::BM, N, K, 0, K);
    // this step's x, split into the stage last read by step s - 2's
    // wgmmas (complete since step s - 1's wait and barrier)
#pragma unroll
    for (int h = 0; h < PIECES; ++h) {
      const int piece = tid + h * tc::THREADS;
      const int r = piece >> 3;
      const int q = piece & 7;
      uint4 hi, lo;
      tc::split8(v[h], hi, lo);
      *reinterpret_cast<uint4*>(st + tc::swizzled(r, q)) = hi;
      *reinterpret_cast<uint4*>(st + tc::A_BYTES + tc::swizzled(r, q)) = lo;
    }
    // the next step's x: in flight during this step's wgmmas
    if (s + 1 < total) {
      const int next = blockIdx.x + ((s + 1) / nkc) * stride;
      load_chunk(x, (next / passes) * tc::BM, ((s + 1) % nkc) * tc::KC, N,
                 K, vec, v);
    }
    tc::fence_proxy_async();
    __syncthreads();
    tc::mbar_wait(&L.full[s % tc::STAGES], (s / tc::STAGES) & 1);
    __syncwarp();        // wgmma is warp-aligned

    tc::wgmma_fence();
    const uint64_t a_hi = tc::sw128_desc(st);
    const uint64_t a_lo = tc::sw128_desc(st + tc::A_BYTES);
    const uint64_t b_hi = tc::sw128_desc(st + 2 * tc::A_BYTES +
                                         wg * tc::WG_N * tc::ROW_BYTES);
    const uint64_t b_lo = b_hi + (tc::B_BYTES >> 4);
#pragma unroll
    for (int k = 0; k < tc::KC / 16; ++k) {
      const uint64_t o = (k * 32) >> 4;   // 16 bf16 further in the row
      const int scale = (kc | k) != 0;    // 0: an item's first step
      tc::wgmma_m64n152k16(acc, a_hi + o, b_hi + o, scale);
      tc::wgmma_m64n152k16(cor, a_hi + o, b_lo + o, scale);
      tc::wgmma_m64n152k16(cor, a_lo + o, b_hi + o, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();     // step s - 1 is done
    __syncthreads();         // ... in both warpgroups: its stage is free
    if (tid == 0 && s + 1 < total) copy_slice(s + 1);

    if (kc == nkc - 1) {
      tc::wgmma_wait<0>();
      tc::fence_acc(acc);
      tc::fence_acc(cor);
      tc::store_fragment<false, 3>(acc, cor, nullptr, out, row0,
                                   (item % passes) * tc::NP + wg * tc::WG_N,
                                   N, M, 0);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch fused_matmul_f32 takes at (K, M).
size_t fused_matmul_scratch_bytes(int K, int M) {
  return scratch_bytes(K, M);
}

// Launches out = x_hi b_hi + x_hi b_lo + x_lo b_hi on `stream`; x (N, K)
// float32, b_hi and b_lo (K, M) bf16, out (N, M) float32, all row-major
// and contiguous; `scratch` holds fused_matmul_scratch_bytes(K, M) bytes,
// 16-byte aligned: b packed into it first, then the product. Returns
// cudaGetLastError() as an int.
int fused_matmul_f32(const float* x, const void* b_hi, const void* b_lo,
                     void* scratch, float* out, int N, int K, int M,
                     void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* bsplit = static_cast<unsigned char*>(scratch);
  const int nkc = (K + tc::KC - 1) / tc::KC;
  const int passes = (M + tc::NP - 1) / tc::NP;
  const int pieces = passes * nkc * 8 * tc::NP;
  if (pieces > 0)
    pack_b_kernel<<<(pieces + 255) / 256, 256, 0, stream>>>(
        static_cast<const uint16_t*>(b_hi),
        static_cast<const uint16_t*>(b_lo), bsplit, K, M, nkc, pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (N + tc::BM - 1) / tc::BM * passes;
  if (items == 0) return 0;
  if (nkc == 0)        // K = 0: the empty sum
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(N) * M, stream));
  err = cudaFuncSetAttribute(fused_matmul_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tc::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = items < sms ? items : sms;
  fused_matmul_kernel<<<blocks, tc::THREADS, tc::SMEM_BYTES, stream>>>(
      x, bsplit, out, N, K, M, passes, items);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
