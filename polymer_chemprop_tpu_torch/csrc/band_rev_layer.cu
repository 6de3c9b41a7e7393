// One whole wD-MPNN depth-loop layer over dst-sorted bonds, in FP32.
//
// Replaces: polymer_chemprop_tpu/ops/pallas_mpnn.py _band_rev_act_kernel
// (the rev-fused band layer, write_z=False in inference), reached through
// _band_rev_act_apply and band_rev_layer_step_sorted.
//
// For every sorted bond row t (src/srev/rowptr from ops/sorted_aux.py):
//   z[t,:]   = sum_{c in [rowptr[src t], rowptr[src t + 1])} w[c] m[c,:]
//              - m[srev t,:]
//   out[t,:] = act(inp[t,:] + z[t,:] @ W_h)            W_h is (in, out)
// and, when z_out is not null (the training slice), z is written too.
//
// What bounds it on an H100: the z @ W_h product, 2*B*H^2 FP32 operations
// (5.2 GFLOP at B = 28,672, H = 300), against ~3*B*H*4 bytes of m, inp and
// out: about 50 operations per byte, above the card's FP32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20). So it is bound by FP32 FMA issue, not
// by memory. The TPU kernel built a dense band matrix over a 512-bond
// window and ran it on the MXU; a CUDA block has no such window and reads
// each incoming run through the CSR instead, so the aggregation costs only
// the ~2 incoming bonds per row that exist.
//
// Design (simple and right first; tensor cores are a later redesign):
//   1. A block owns ROWS = 32 consecutive bond rows. Its warps build the
//      z tile in dynamic shared memory, one row per warp at a time, lanes
//      over the H columns (coalesced row reads of m).
//   2. W_h streams through shared memory in KS x 320 slices; each thread
//      keeps an 8-row x 5-column block of the product in registers
//      (z reads are warp-wide broadcasts, W reads are conflict-free).
//   3. The epilogue adds inp, applies the activation and stores out with
//      consecutive lanes on consecutive columns.
// Padding rows (src 0, own reverse, zero m and inp) come out exactly 0.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;             // bond rows per block
constexpr int TX = 64;               // threads across output columns
constexpr int TY = 4;                // threads across rows
constexpr int THREADS = TX * TY;     // 256
constexpr int RPT = ROWS / TY;       // rows per thread (8)
constexpr int NQ = 5;                // column groups per thread
constexpr int NCHUNK = TX * NQ;      // output columns per pass (320)
constexpr int KS = 32;               // W_h rows per shared-memory slice

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

__global__ void __launch_bounds__(THREADS)
band_rev_layer_kernel(const float* __restrict__ m,
                      const float* __restrict__ inp,
                      const float* __restrict__ wh,
                      const float* __restrict__ w,
                      const int* __restrict__ src,
                      const int* __restrict__ srev,
                      const int* __restrict__ rowptr,
                      float* __restrict__ out,
                      float* __restrict__ z_out,
                      int B, int H, int act) {
  extern __shared__ float smem[];
  float* z_s = smem;                     // ROWS x H
  float* w_s = smem + ROWS * H;          // KS x NCHUNK
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  // 1. z tile: incoming run of src(t) minus the reverse message
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int t = row0 + r;
    float* zr = z_s + r * H;
    if (t >= B) {
      for (int j = lane; j < H; j += 32) zr[j] = 0.f;
      continue;
    }
    const int s = src[t];
    const size_t rv = static_cast<size_t>(srev[t]) * H;
    const int c0 = rowptr[s];
    const int c1 = rowptr[s + 1];
    for (int j = lane; j < H; j += 32) {
      float acc = 0.f;
      for (int c = c0; c < c1; ++c)
        acc = fmaf(w[c], m[static_cast<size_t>(c) * H + j], acc);
      zr[j] = acc - m[rv + j];
    }
  }
  __syncthreads();
  if (z_out != nullptr) {
    for (int idx = tid; idx < ROWS * H; idx += THREADS) {
      const int t = row0 + idx / H;
      if (t < B) z_out[static_cast<size_t>(row0) * H + idx] = z_s[idx];
    }
  }

  // 2-3. out = act(inp + z @ W_h), NCHUNK output columns per pass
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int n0 = 0; n0 < H; n0 += NCHUNK) {
    float acc[RPT][NQ];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[i][q] = 0.f;

    for (int k0 = 0; k0 < H; k0 += KS) {
      __syncthreads();  // the previous slice is no longer read
      for (int idx = tid; idx < KS * NCHUNK; idx += THREADS) {
        const int k = k0 + idx / NCHUNK;
        const int n = n0 + idx % NCHUNK;
        w_s[idx] = (k < H && n < H) ? wh[static_cast<size_t>(k) * H + n] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KS, H - k0);
#pragma unroll 4
      for (int kk = 0; kk < kmax; ++kk) {
        float wv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) wv[q] = w_s[kk * NCHUNK + tx + q * TX];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float zv = z_s[(ty * RPT + i) * H + k0 + kk];
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[i][q] = fmaf(zv, wv[q], acc[i][q]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = row0 + ty * RPT + i;
      if (t >= B) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + tx + q * TX;
        if (n < H) {
          const size_t o = static_cast<size_t>(t) * H + n;
          out[o] = act_fn(inp[o] + acc[i][q], act);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at hidden width H.
size_t band_rev_layer_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(ROWS) * H + KS * NCHUNK);
}

// Launches the layer on `stream`; returns cudaGetLastError() as an int.
int band_rev_layer_f32(const float* m, const float* inp, const float* wh,
                       const float* w, const int* src, const int* srev,
                       const int* rowptr, float* out, float* z_out,
                       int B, int H, int act, void* stream) {
  const size_t smem = band_rev_layer_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      band_rev_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + ROWS - 1) / ROWS;
  band_rev_layer_kernel<<<blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      m, inp, wh, w, src, srev, rowptr, out, z_out, B, H, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
