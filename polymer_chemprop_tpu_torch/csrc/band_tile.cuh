// The tile-product stage shared by the W_h-fused band kernels
// (band_rev_layer.cu, band_matmul.cu) and their control (band_ctrl.cu), in
// FP32 on the CUDA cores (band_precision="highest").
//
// A block of THREADS = 256 owns ROWS = 32 consecutive bond rows. Its kernel
// first builds the (ROWS x H) aggregation tile z in dynamic shared memory,
// at row stride z_stride(H); only that stage differs between the kernels.
// The stages here are the same for all:
//   store_tile:    write the z tile to global memory (training only);
//   product_stage: out = z @ W_h, optionally act(inp + .).
//
// Every output keeps one chain: acc = fmaf(z[t,k], W_h[k,n], acc) over
// k = 0..H-1 in order from 0.f, then act(inp + acc): no split of k and no
// tensor cores, so every design of this stage gives the same bits.
//
// What bounds it on an H100: 2*B*H^2 FP32 operations, about 50 per byte of
// m, inp and out at H = 300, above the card's FP32 ridge of 20: FMA issue.
// Design, for the SIMT pipe and the shared-memory port:
//   * register micro-tiles read with 128-bit shared loads: a pass's columns
//     form groups of 4 quads (16 columns); warp w takes the 16 rows of half
//     w % 2 and the groups w / 2 + 4 j (j < 5), lane (rt = lane % 8,
//     ct = lane / 8) rows 16 (w % 2) + rt + 8 i (i < 2) and quad ct of each
//     group: 40 accumulators. For 4 depths it loads one float4 of z per row
//     (8 consecutive rows a warp, conflict free because z_stride / 4 is
//     odd) and per depth one float4 of W_h per group (4 consecutive quads a
//     warp), so 5.5 shared loads feed 40 fmaf. At H = 300 the 19 groups
//     give the four warp pairs 5, 5, 5 and 4 (a 4-row x 12-column tile per
//     thread, tried first, kept 6.25 of 8 warps busy and was slower);
//   * W_h slices of SK = 16 depths land with cp.async in a double buffer,
//     16 threads on a slice row: the copy of slice s + 1 is in flight while
//     the warps multiply slice s, and one barrier a slice publishes it and
//     frees the other buffer (a producer warp on full / empty mbarriers,
//     tried, was slower);
//   * no padded columns: a pass covers at most PASS_COLS = 312 columns (H =
//     300 in one pass), and each warp multiplies only the groups of its
//     share that exist (0..5, a template argument picked per warp);
//   * the epilogue stores float4s (consecutive lanes ct on consecutive
//     quads of a row) when H % 4 == 0 and the pointers are 16-byte aligned,
//     else one float at a time.
// Dynamic shared memory (smem_bytes): ROWS x H floats of z plus KS x
// NCHUNK floats, then ROWS ints a kernel may use for its rows (tile_ints).
// The z tile takes ROWS x z_stride(H) (at most 7 columns more than H), the
// two W_h slices the rest (at least 10,016 floats; 2 x SK x PASS_COLS =
// 9,984). The widest H whose block fits the card's 227 KB is 1,495; the
// Python side mirrors this arithmetic (ops/band_mpnn.py fused_layer_fits)
// to pick another layer form for wider models.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace band_tile {

constexpr int ROWS = 32;             // bond rows per block
constexpr int THREADS = 256;         // 8 warps
constexpr int KS = 32;               // the budget: KS x NCHUNK floats
constexpr int NCHUNK = 320;          //   beside the z tile (smem_bytes)
constexpr int SK = 16;               // W_h depths per slice
constexpr int PASS_COLS = 312;       // output columns per pass, at most
constexpr int RPT = 2;               // rows per thread: 16 h + rt + 8 i
constexpr int JQ = 5;                // quads per thread, one a group, at most
static_assert(ROWS == 2 * 8 * RPT, "2 row halves x 8 row lanes x RPT");
static_assert((THREADS / 64) * JQ * 16 >= PASS_COLS,
              "the warp pairs cover a pass");
static_assert(2 * SK * PASS_COLS <= KS * NCHUNK - ROWS * 7,
              "two slices fit beside the widest z stride");

// Bytes of dynamic shared memory one block needs at hidden width H.
inline size_t smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(ROWS) * H + KS * NCHUNK) +
         sizeof(int) * ROWS;
}

// Row stride of the z tile in floats: the least multiple of 4 >= H whose
// quarter is odd (16-byte rows, 8 rows on 8 distinct bank quads).
__device__ __forceinline__ int z_stride(int H) {
  const int zs = (H + 3) & ~3;
  return ((zs >> 2) & 1) ? zs : zs + 4;
}

// The ROWS ints behind the tile's floats.
__device__ __forceinline__ int* tile_ints(float* smem, int H) {
  return reinterpret_cast<int*>(smem + ROWS * H + KS * NCHUNK);
}

// activation ids: 0 relu, 1 leakyrelu(0.1), 2 prelu as leakyrelu(0.25),
// 3 tanh, 4 elu, 5 selu (pallas_mpnn.py _ACT_FNS)
__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 0: return fmaxf(x, 0.f);
    case 1: return x > 0.f ? x : 0.1f * x;
    case 2: return x > 0.f ? x : 0.25f * x;
    case 3: return tanhf(x);
    case 4: return x > 0.f ? x : expm1f(x);
    default: {
      const float scale = 1.0507009873554805f;
      const float alpha = 1.6732632423543772f;
      return scale * (x > 0.f ? x : alpha * expm1f(x));
    }
  }
}

// z_out[row0 + r, :] = z_s[r, :H] for the tile's rows below B. Call after
// the __syncthreads() that completes the tile.
__device__ __forceinline__ void store_tile(const float* z_s,
                                           float* __restrict__ z_out,
                                           int row0, int B, int H) {
  const int zs = z_stride(H);
  for (int idx = threadIdx.x; idx < ROWS * H; idx += THREADS) {
    const int r = idx / H;
    if (row0 + r < B)
      z_out[static_cast<size_t>(row0) * H + idx] =
          z_s[r * zs + idx - r * H];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// W_h[k0:k0 + SK, n0:n0 + 4 nq] into dst (row stride 4 nq) by cp.async,
// thread t on row t / 16 and every 16th quad (16 bytes a copy when `vec`)
// or float (4 bytes, zero past column H) of it; commits a group.
__device__ __forceinline__ void load_slice(float* dst,
                                           const float* __restrict__ wh,
                                           int k0, int n0, int nq, int H,
                                           bool vec) {
  static_assert(THREADS == 16 * SK, "16 threads a slice row");
  const int kk = threadIdx.x >> 4;
  const int ws = 4 * nq;
  if (kk < H - k0) {
    const float* src = wh + static_cast<size_t>(k0 + kk) * H + n0;
    float* row = dst + kk * ws;
    if (vec) {
      for (int q = threadIdx.x & 15; q < nq; q += 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(row + 4 * q)), "l"(src + 4 * q)
                     : "memory");
    } else {
      for (int c = threadIdx.x & 15; c < ws; c += 16) {
        const bool in = n0 + c < H;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_addr(row + c)), "l"(in ? src + c : wh),
                        "r"(in ? 4 : 0)
                     : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[., j < NJ] += z[rows, depths] W[depths, quads] for the `ne` (<= 4)
// depths of one group, in depth order; z_row at the group's first depth of
// the thread's first row, w_row at the group's first slice row
template <int NJ, bool FULL>
__device__ __forceinline__ void fma_group(float (&acc)[RPT][JQ][4],
                                          const float* z_row, int zs,
                                          const float* w_row, int ws,
                                          const int (&wcol)[JQ], int ne) {
  float4 zv[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    zv[i] = *reinterpret_cast<const float4*>(z_row + 8 * i * zs);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!FULL && e >= ne) break;
    float4 wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wv[j] = *reinterpret_cast<const float4*>(w_row + e * ws + wcol[j]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float zi = lane_of(zv[i], e);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] = fmaf(zi, wv[j].x, acc[i][j][0]);
        acc[i][j][1] = fmaf(zi, wv[j].y, acc[i][j][1]);
        acc[i][j][2] = fmaf(zi, wv[j].z, acc[i][j][2]);
        acc[i][j][3] = fmaf(zi, wv[j].w, acc[i][j][3]);
      }
    }
  }
}

// one slice (kmax depths) for a warp that owns NJ quad groups
template <int NJ>
__device__ __forceinline__ void fma_slice(float (&acc)[RPT][JQ][4],
                                          const float* zr, int zs,
                                          const float* wb, int ws,
                                          const int (&wcol)[JQ], int kmax) {
  if (kmax == SK) {
#pragma unroll
    for (int kk = 0; kk < SK; kk += 4)
      fma_group<NJ, true>(acc, zr + kk, zs, wb + kk * ws, ws, wcol, 4);
  } else {
    for (int kk = 0; kk < kmax; kk += 4)
      fma_group<NJ, false>(acc, zr + kk, zs, wb + kk * ws, ws, wcol,
                           kmax - kk);
  }
}

// out[t, :] = z[t - row0, :] @ W_h, and with EPILOGUE act(inp[t, :] + .),
// for the tile's rows below B, PASS_COLS output columns per pass. `smem`
// is the kernel's dynamic buffer with the z tile at its start (stride
// z_stride(H)); call it once the tile is written (the stage's first
// barrier completes it). Every thread takes part in the copies and the
// barriers; only the multiply depends on the warp's share of the pass.
template <bool EPILOGUE>
__device__ __forceinline__ void product_stage(float* smem,
                                              const float* __restrict__ wh,
                                              const float* __restrict__ inp,
                                              float* __restrict__ out,
                                              int row0, int B, int H,
                                              int act) {
  const int zs = z_stride(H);
  const float* z_s = smem;
  float* w_s = smem + ROWS * zs;
  const bool vec = (H & 3) == 0 && aligned16(wh) && aligned16(out) &&
                   (!EPILOGUE || aligned16(inp));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 1) + (lane & 7);   // the thread's first row
  const int wp = warp >> 1;                      // its groups: wp + 4 j
  const int ct = lane >> 3;                      // its quad in a group
  const int nks = (H + SK - 1) / SK;
  for (int n0 = 0; n0 < H; n0 += PASS_COLS) {
    const int nq = (min(PASS_COLS, H - n0) + 3) >> 2;   // quads in the pass
    const int ws = 4 * nq;
    // warp-uniform: how many of the pass's groups of 4 quads the warp has
    const int nj = min(JQ, max(0, (((nq + 3) >> 2) - wp + 3) >> 2));
    int wcol[JQ];      // the thread's quads as slice columns; a quad past
#pragma unroll         // the pass reads a real one and is not stored
    for (int j = 0; j < JQ; ++j)
      wcol[j] = 4 * min(4 * (wp + 4 * j) + ct, nq - 1);
    float acc[RPT][JQ][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < JQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    __syncthreads();   // the z tile is complete; no slice buffer is read
    load_slice(w_s, wh, 0, n0, nq, H, vec);
    for (int s = 0; s < nks; ++s) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();   // slice s landed for all; slice s - 1 is read
      if (s + 1 < nks)
        load_slice(w_s + ((s + 1) & 1) * SK * ws, wh, (s + 1) * SK, n0, nq,
                   H, vec);
      const float* wb = w_s + (s & 1) * SK * ws;
      const float* zr = z_s + r0 * zs + s * SK;
      const int kmax = min(SK, H - s * SK);
      switch (nj) {
        case 5: fma_slice<5>(acc, zr, zs, wb, ws, wcol, kmax); break;
        case 4: fma_slice<4>(acc, zr, zs, wb, ws, wcol, kmax); break;
        case 3: fma_slice<3>(acc, zr, zs, wb, ws, wcol, kmax); break;
        case 2: fma_slice<2>(acc, zr, zs, wb, ws, wcol, kmax); break;
        case 1: fma_slice<1>(acc, zr, zs, wb, ws, wcol, kmax); break;
        default: break;
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = row0 + r0 + 8 * i;
      if (t >= B) continue;
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        const int q = 4 * (wp + 4 * j) + ct;
        if (q >= nq) continue;
        const int n = n0 + 4 * q;
        const size_t o = static_cast<size_t>(t) * H + n;
        float v[4] = {acc[i][j][0], acc[i][j][1], acc[i][j][2],
                      acc[i][j][3]};
        if (vec) {
          if (EPILOGUE) {
            const float4 b = *reinterpret_cast<const float4*>(inp + o);
            v[0] = act_fn(b.x + v[0], act);
            v[1] = act_fn(b.y + v[1], act);
            v[2] = act_fn(b.z + v[2], act);
            v[3] = act_fn(b.w + v[3], act);
          }
          *reinterpret_cast<float4*>(out + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < H)
              out[o + e] = EPILOGUE ? act_fn(inp[o + e] + v[e], act) : v[e];
        }
      }
    }
  }
}

}  // namespace band_tile
