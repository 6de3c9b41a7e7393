// The Hopper tile stage of the W_h-fused band kernels at split-bf16
// precision: out = z @ W_h, optionally act(inp + .), on wgmma.
//
// The product is z_hi W_hi + z_hi W_lo + z_lo W_hi (PASSES = 3, the JAX
// package's band_precision="high") or z_hi W_hi (PASSES = 1, "default"),
// with hi = bf16_rn(x), lo = bf16_rn(x - hi) on both operands, as
// pallas_mpnn.py _dot_band splits them; every bf16 x bf16 product is exact
// in float32 and all passes add into one float32 accumulator.
//
// A block of two warpgroups owns BM = 64 consecutive bond rows, one wgmma
// M. Its kernel supplies z row by row (ZRow, below); only that differs
// between the kernels. The stage:
//   * walks the depth in chunks of KC = 64: z[:, k0:k0 + 64] is built by all
//     256 threads, one 16-byte piece (8 columns) of a row at a time, split
//     into bf16 halves and stored in the 128-byte-swizzled K-major layout
//     that the wgmma descriptor reads (a row of 64 bf16 is one swizzle row);
//     the FP32 z goes straight to global memory when the caller wants it;
//   * reads W_h as a scratch the wrapper's prep kernel (split_wh_kernel)
//     wrote once per call: hi and lo halves, padded with zeros, K-major and
//     already swizzled, one contiguous slice per (N pass, K chunk), so one
//     bulk copy per slice lands it in shared memory, completed on an
//     mbarrier;
//   * issues, per chunk and warpgroup, 4 k16 steps x PASSES
//     wgmma.m64n152k16.f32.bf16.bf16 with both operands in shared memory:
//     warpgroup g takes output columns [152 g, 152 g + 152) of the pass,
//     so a pass covers NP = 304 columns (H = 300 in one pass; wider H loops
//     over passes and rebuilds z). The tensor cores drop the bits of each
//     k16 step's sum below the accumulator's last place (measured on the
//     card: about 1e-6 of the sums' size at H = 300, against 1e-7 for
//     float32 rounding), so the two cross terms, 2^-8 of hi x hi, have an
//     accumulator of their own: added to hi x hi they would cost that at
//     every step. The two are added in the epilogue;
//   * keeps two stages in a ring: the wgmmas of chunk k run asynchronously
//     while the threads build chunk k + 1 and its W_h slice is copied;
//   * stores from the accumulator fragment (row 16 w + lane / 4 (+ 8),
//     column 8 j + 2 (lane % 4) (+ 1)), adding inp and applying act_fn,
//     masked to rows < B and columns < H. With one block per SM nothing
//     else hides the epilogue's loads of inp, so they are prefetched into
//     L2 when the pass starts and issued JG column groups at a time.
// Columns and depths past H are zero in both halves of both operands, rows
// past B are zero in z. Shared memory is fixed (SMEM_BYTES, about 186 KB),
// whatever H: the Python side mirrors it (ops/band_mpnn.py TC_SMEM_BYTES,
// tc_scratch_bytes).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_tile.cuh"

namespace band_tile_sm90 {

constexpr int BM = 64;                    // bond rows per block: one wgmma M
constexpr int KC = 64;                    // depth per chunk: 128 bytes of bf16
constexpr int WG_N = 152;                 // output columns per warpgroup
constexpr int WGS = 2;                    // consumer warpgroups per block
constexpr int NP = WGS * WG_N;            // output columns per pass (304)
constexpr int THREADS = 128 * WGS;        // 256
constexpr int STAGES = 2;
constexpr int ROW_BYTES = 2 * KC;         // one swizzle row
constexpr int A_BYTES = BM * ROW_BYTES;   // one half of a z chunk (8 KB)
constexpr int B_BYTES = NP * ROW_BYTES;   // one half of a W_h slice (38 KB)
constexpr int SLICE_BYTES = 2 * B_BYTES;  // a W_h slice, hi then lo
// a stage: z_hi, z_lo, W_hi, W_lo, each 1024-byte aligned
constexpr int STAGE_BYTES = 2 * A_BYTES + SLICE_BYTES;
constexpr int ACC = WG_N / 2;             // accumulator floats per thread
// alignment slack, the stages, one mbarrier per stage, 2 ints per row
constexpr size_t SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + 8 * STAGES + 2 * sizeof(int) * BM;
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "every operand tile starts on a 1024-byte swizzle atom");
static_assert(WG_N % 8 == 0 && WG_N <= 256, "wgmma N");

// Bytes of the split W_h scratch at width H: one slice per (pass, chunk).
inline size_t scratch_bytes(int H) {
  return static_cast<size_t>((H + NP - 1) / NP) * ((H + KC - 1) / KC) *
         SLICE_BYTES;
}

struct Layout {
  unsigned char* stage;   // STAGES x STAGE_BYTES, 1024-byte aligned
  uint64_t* full;         // STAGES mbarriers: the stage's W_h slice landed
  int* rows;              // 2 x BM ints the kernel may use for its rows
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ Layout layout(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  Layout L;
  L.stage = raw + pad;
  L.full = reinterpret_cast<uint64_t*>(L.stage + STAGES * STAGE_BYTES);
  L.rows = reinterpret_cast<int*>(L.full + STAGES);
  return L;
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused for this layout), stride
// 1024 bytes between 8-row groups, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// `bytes` from global `src` to shared `dst`, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the generic-proxy stores of this thread become visible to wgmma reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 152 f32 fragment) += A (64 x 16 bf16) B (16 x 152 bf16), both
// K-major in shared memory; scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n152k16(float (&d)[ACC],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75}, "
      "%76, %77, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// v[e] = row[col + e] for the 8 columns from `col`, 0 past H; `vec` when
// every row starts 16-byte aligned (H % 4 == 0) and col % 8 == 0
__device__ __forceinline__ void load8(const float* __restrict__ row, int col,
                                      int H, bool vec, float (&v)[8]) {
  if (vec && col + 8 <= H) {
    const float4 a = *reinterpret_cast<const float4*>(row + col);
    const float4 b = *reinterpret_cast<const float4*>(row + col + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = col + e < H ? row[col + e] : 0.f;
  }
}

__device__ __forceinline__ void store8(float* __restrict__ row, int col,
                                       int H, bool vec, const float (&v)[8]) {
  if (vec && col + 8 <= H) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    *reinterpret_cast<float4*>(row + col + 4) = make_float4(v[4], v[5], v[6],
                                                            v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < H) row[col + e] = v[e];
  }
}

// the bf16 halves of 8 floats, packed two to a word (element 2e low)
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 bh = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    const float2 fh = __bfloat1622float2(bh);
    const __nv_bfloat162 bl =
        __floats2bfloat162_rn(v[2 * e] - fh.x, v[2 * e + 1] - fh.y);
    h[e] = *reinterpret_cast<const uint32_t*>(&bh);
    l[e] = *reinterpret_cast<const uint32_t*>(&bl);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// byte offset of the 16-byte piece q (columns 8q..8q+7) of row r in a
// 128-byte-swizzled K-major tile
__device__ __forceinline__ int swizzled(int r, int q) {
  return r * ROW_BYTES + ((q ^ (r & 7)) << 4);
}

// The W_h scratch: for every pass p and chunk kc one slice of NP rows (the
// output columns n = p NP + row) of KC depths (k = kc KC + col), W_h[k, n]
// split, hi block then lo block, swizzled as in shared memory. One thread
// per 16-byte piece of the hi block; `pieces` = passes x chunks x 8 x NP.
__global__ void split_wh_kernel(const float* __restrict__ wh,
                                unsigned char* __restrict__ scratch, int H,
                                int nkc, int pieces) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pieces) return;
  const int n = idx % NP;
  const int q = (idx / NP) & 7;
  const int slice = idx / (NP * 8);
  const int p = slice / nkc;
  const int kc = slice - p * nkc;
  const int gn = p * NP + n;
  const int k0 = kc * KC + q * 8;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = k0 + e;
    v[e] = (k < H && gn < H) ? wh[static_cast<size_t>(k) * H + gn] : 0.f;
  }
  uint4 hi, lo;
  split8(v, hi, lo);
  unsigned char* dst =
      scratch + static_cast<size_t>(slice) * SLICE_BYTES + swizzled(n, q);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + B_BYTES) = lo;
}

// Host side: W_h (H x H, (in, out)) split into `scratch`
// (scratch_bytes(H) bytes) on `stream`, before a kernel runs the stage on
// it; returns the launch's error.
inline cudaError_t split_wh(const float* wh, unsigned char* scratch, int H,
                            cudaStream_t stream) {
  const int nkc = (H + KC - 1) / KC;
  const int pieces = ((H + NP - 1) / NP) * nkc * 8 * NP;
  split_wh_kernel<<<(pieces + 255) / 256, 256, 0, stream>>>(wh, scratch, H,
                                                            nkc, pieces);
  return cudaGetLastError();
}

// L2 prefetch of columns [c0, c1) of the block's rows of x: one request
// per 128-byte line, spread over the block's threads
__device__ __forceinline__ void prefetch_rows(const float* x, int row0,
                                              int B, int H, int c0, int c1) {
  const int lines = (c1 - c0 + 31) / 32 + 1;   // +1: a line cut at the end
  for (int idx = threadIdx.x; idx < BM * lines; idx += THREADS) {
    const int t = row0 + idx / lines;
    const int c = min(c0 + (idx % lines) * 32, c1 - 1);
    if (t < B)
      asm volatile("prefetch.global.L2 [%0];\n"
                   :: "l"(x + static_cast<size_t>(t) * H + c));
  }
}

// A warpgroup's share of a pass, columns [n0, n0 + WG_N), stored from its
// accumulator fragment (row 16 w + lane / 4 (+ 8), column n0 + 8 j +
// 2 (lane % 4) (+ 1)) to rows < B and columns < H; with EPILOGUE
// act(inp + .), inp read JG column groups at a time so that the loads of a
// group are in flight together.
template <bool EPILOGUE, int PASSES>
__device__ __forceinline__ void store_fragment(
    const float (&acc)[ACC], const float (&cor)[ACC],
    const float* __restrict__ inp, float* __restrict__ out, int row0,
    int n0, int B, int H, int act) {
  constexpr int NJ = WG_N / 8;    // column groups of 8
  constexpr int JG = 5;
  const int lane = threadIdx.x & 31;
  const int rbase = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cbase = n0 + 2 * (lane & 3);
  const bool even = (H & 1) == 0;   // n even: both columns, 8-byte aligned
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += JG) {
    float2 b[JG][2];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = rbase + 8 * h;
        const int n = cbase + 8 * (j0 + jj);
        b[jj][h] = make_float2(0.f, 0.f);
        if (!EPILOGUE || j0 + jj >= NJ || t >= B || n >= H) continue;
        const size_t o = static_cast<size_t>(t) * H + n;
        if (even) {
          b[jj][h] = *reinterpret_cast<const float2*>(inp + o);
        } else {
          b[jj][h].x = inp[o];
          if (n + 1 < H) b[jj][h].y = inp[o + 1];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj;
        const int t = rbase + 8 * h;
        const int n = cbase + 8 * j;
        if (j >= NJ || t >= B || n >= H) continue;
        const int i = 4 * j + 2 * h;
        float x0 = PASSES == 3 ? acc[i] + cor[i] : acc[i];
        float x1 = PASSES == 3 ? acc[i + 1] + cor[i + 1] : acc[i + 1];
        if (EPILOGUE) {
          x0 = band_tile::act_fn(b[jj][h].x + x0, act);
          x1 = band_tile::act_fn(b[jj][h].y + x1, act);
        }
        const size_t o = static_cast<size_t>(t) * H + n;
        if (even) {
          *reinterpret_cast<float2*>(out + o) = make_float2(x0, x1);
        } else {
          out[o] = x0;
          if (n + 1 < H) out[o + 1] = x1;
        }
      }
    }
  }
}

// The stage, run by all THREADS threads of the block that owns rows
// [row0, row0 + BM). `zrow(r, t, col, v)` writes z[t, col:col + 8] (0 past
// H) of the block's row r = t - row0 < B into v; it may read what the
// kernel left in L.rows before the call (the stage's first barrier
// publishes it). z_out, when not null, gets the FP32 z of rows < B.
template <bool EPILOGUE, int PASSES, class ZRow>
__device__ __forceinline__ void stage(const Layout& L, const ZRow& zrow,
                                      const unsigned char* __restrict__ wsplit,
                                      const float* __restrict__ inp,
                                      float* __restrict__ out,
                                      float* __restrict__ z_out, int row0,
                                      int B, int H, int act) {
  static_assert(PASSES == 1 || PASSES == 3, "1 or 3 bf16 passes");
  constexpr uint32_t COPY_BYTES = PASSES == 3 ? SLICE_BYTES : B_BYTES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int nkc = (H + KC - 1) / KC;
  const int total = ((H + NP - 1) / NP) * nkc;   // (pass, chunk) steps
  const bool vec = (H & 3) == 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&L.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step `it` = pass * nkc + chunk reads slice `it` of the scratch
  auto copy_slice = [&](int it) {
    uint64_t* bar = &L.full[it % STAGES];
    mbar_expect_tx(bar, COPY_BYTES);
    bulk_copy(L.stage + (it % STAGES) * STAGE_BYTES + 2 * A_BYTES,
              wsplit + static_cast<size_t>(it) * SLICE_BYTES, COPY_BYTES,
              bar);
  };
  if (tid == 0) copy_slice(0);

  // hi x hi in acc, the two smaller cross terms apart in cor (module note)
  float acc[ACC], cor[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = cor[i] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int p = it / nkc;
    const int kc = it - p * nkc;
    unsigned char* st = L.stage + (it % STAGES) * STAGE_BYTES;

    if (EPILOGUE && kc == 0)   // the pass's inp, into L2 for the epilogue
      prefetch_rows(inp, row0, B, H, p * NP, min(H, p * NP + NP));
    // z chunk kc: this stage's z halves were last read by the wgmmas of
    // step it - 2, complete since step it - 1's wait and barrier
    for (int item = tid; item < BM * 8; item += THREADS) {
      const int r = item >> 3;
      const int q = item & 7;
      const int t = row0 + r;
      const int col = kc * KC + q * 8;
      float v[8];
      if (t < B) {
        zrow(r, t, col, v);
        if (z_out != nullptr && p == 0)
          store8(z_out + static_cast<size_t>(t) * H, col, H, vec, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      uint4 hi, lo;
      split8(v, hi, lo);
      *reinterpret_cast<uint4*>(st + swizzled(r, q)) = hi;
      if (PASSES == 3)
        *reinterpret_cast<uint4*>(st + A_BYTES + swizzled(r, q)) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    mbar_wait(&L.full[it % STAGES], (it / STAGES) & 1);
    __syncwarp();        // wgmma is warp-aligned

    // every warpgroup issues, also past H (zeros there), so that no wgmma
    // sits on a path the compiler sees as divergent
    wgmma_fence();
    const uint64_t a_hi = sw128_desc(st);
    const uint64_t a_lo = sw128_desc(st + A_BYTES);
    const uint64_t b_hi = sw128_desc(st + 2 * A_BYTES + wg * WG_N *
                                     ROW_BYTES);
    const uint64_t b_lo = b_hi + (B_BYTES >> 4);
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      const uint64_t o = (k * 32) >> 4;   // 16 bf16 further in the row
      const int scale = (kc | k) != 0;    // 0: a pass's first step
      wgmma_m64n152k16(acc, a_hi + o, b_hi + o, scale);
      if (PASSES == 3) {
        wgmma_m64n152k16(cor, a_hi + o, b_lo + o, scale);
        wgmma_m64n152k16(cor, a_lo + o, b_hi + o, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();     // step it - 1 is done
    __syncthreads();     // ... in both warpgroups: its stage is free
    if (tid == 0 && it + 1 < total) copy_slice(it + 1);

    if (kc == nkc - 1) {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(cor);
      store_fragment<EPILOGUE, PASSES>(acc, cor, inp, out, row0,
                                       p * NP + wg * WG_N, B, H, act);
    }
  }
}

}  // namespace band_tile_sm90
