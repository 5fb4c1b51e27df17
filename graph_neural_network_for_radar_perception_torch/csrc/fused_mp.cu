// Fused message-passing forward for Hopper (sm_90a): edge gather ->
// two-layer message MLP with channel-norm + leaky-ReLU -> scatter-add.
//
// Replaces the TPU kernel
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py::_kernel
// (the forward of one message round, launched by _forward_impl).  For every
// directed edge e = (s -> r):
//
//   pre1 = xa[r] + xb[s] + ef[e] . W1e + b1            [H]
//   m1   = lrelu(cnorm(pre1; g1, be1))
//   m2   = lrelu(cnorm(m1 . W2 + b2; g2, be2))         [D2]
//   agg[r] += m2
//
// with xa = x . W1r and xb = x . W1s computed outside (torch.matmul), as the
// JAX package computes them outside Pallas.  cnorm is the reference
// channel normalisation: Bessel-corrected std over the row, eps added to the
// std, one scalar (gamma, beta) pair.  Sentinel semantics follow _kernel:
// a receiver outside [0, N) drops the message; a sender outside [0, N)
// gathers a zero xb row while the message still counts.
//
// What bounds it.  At the shipped widths (De = D = D2 = 64, H = 128) an edge
// costs 2 * (De*H + H*D2) = 32 768 FLOP and reads ~264 bytes, about 120
// FLOP/byte: well above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte).  So its bound is FP32 FMA throughput (no tensor cores: the
// reference is f32), and the design keeps the FMA pipes fed from registers
// and shared memory.  At the deploy shapes (E = 15 360) the edge groups fill
// a single wave, and the launch is measured to take several times that
// bound: it lasts one warp's chain of dependent steps (PERF.md).
//
// Design (simple first; wgmma/TMA is later work):
// * W1e [De, H], W2 [H, D2], b1, b2 are staged once per block in dynamic
//   shared memory (65 KB at the shipped widths, hence the opt-in attribute).
// * One warp carries kEdgesPerWarp edges at once.  Lane l owns hidden
//   channels l, l+32, ... and output channels l, l+32, ...; every weight it
//   reads from shared memory feeds kEdgesPerWarp FMAs (register blocking
//   over edges), so shared-memory bandwidth does not bound the FMA rate.
// * The edge rows (ef, then the layer-1 activations) are staged per warp in
//   shared memory and read back as 16-byte broadcasts.
// * Row statistics of both channel norms are warp-shuffle reductions; both
//   norms take the mean first and then the centred squares, as the reference.
// * The scatter is atomicAdd into agg[r] (agg is zeroed by the caller), so
//   the summation order, and the last bits of agg, vary from run to run.
// * A group of edges whose receivers are all outside [0, N) (the padded tail
//   of a frame) is skipped: its messages would be dropped anyway.
// * The edge axis needs no padding: the ragged tail is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kEdgesPerWarp = 8;   // edges a warp carries at once
constexpr float kEps = 1e-5f;      // reference modules/neural_net/constants.py

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// Channel norm + leaky ReLU of kEdgesPerWarp rows of width `width`, each row
// spread over the warp as v[j][t] = row_j[lane + 32 t] (t < CPL, masked past
// `width`).
template <int CPL>
__device__ __forceinline__ void cnorm_lrelu(float (&v)[kEdgesPerWarp][CPL],
                                            int lane, int width, float gamma,
                                            float beta, float slope) {
  const float inv_n = 1.0f / static_cast<float>(width);
  const float inv_nm1 = 1.0f / static_cast<float>(width > 1 ? width - 1 : 1);
#pragma unroll
  for (int j = 0; j < kEdgesPerWarp; ++j) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (lane + 32 * t < width) s += v[j][t];
    const float mean = warp_sum(s) * inv_n;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (lane + 32 * t < width) {
        const float u = v[j][t] - mean;
        q += u * u;
      }
    const float denom = sqrtf(warp_sum(q) * inv_nm1) + kEps;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const float y = gamma * ((v[j][t] - mean) / denom) + beta;
      v[j][t] = y >= 0.f ? y : slope * y;
    }
  }
}

template <int HPL, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
fused_mp_fwd_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef,
                    const int* __restrict__ senders,
                    const int* __restrict__ receivers,
                    const float* __restrict__ w1e, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ scal, float slope,
                    float* __restrict__ agg, int n, int e, int de, int h,
                    int d2) {
  constexpr int EPW = kEdgesPerWarp;
  extern __shared__ __align__(16) float smem[];
  const int stage_w = de > h ? de : h;  // floats per staged edge row
  float* s_w1e = smem;                  // [de, h]
  float* s_w2 = s_w1e + de * h;         // [h, d2]
  float* s_b1 = s_w2 + h * d2;          // [h]
  float* s_b2 = s_b1 + h;               // [d2]
  // d2 is a multiple of 4 (checked on the host), so the stage stays 16-byte
  // aligned.
  float* s_stage = s_b2 + d2;           // [kWarps][EPW][stage_w]

  const int tid = threadIdx.x;
  for (int i = tid; i < (de * h) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_w1e)[i] = reinterpret_cast<const float4*>(w1e)[i];
  for (int i = tid; i < (h * d2) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_w2)[i] = reinterpret_cast<const float4*>(w2)[i];
  for (int i = tid; i < h; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = tid; i < d2; i += blockDim.x) s_b2[i] = b2[i];
  __syncthreads();

  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  const int warp = tid >> 5, lane = tid & 31;
  float* stage = s_stage + warp * EPW * stage_w;
  const int groups = (e + EPW - 1) / EPW;

  for (int grp = blockIdx.x * kWarps + warp; grp < groups;
       grp += gridDim.x * kWarps) {
    const int e0 = grp * EPW;
    int recv[EPW], send[EPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool live = e0 + j < e;
      recv[j] = live ? receivers[e0 + j] : -1;
      send[j] = live ? senders[e0 + j] : -1;
      any |= in_range(recv[j], n);
    }
    if (!any) continue;  // warp-uniform: every message would be dropped

    __syncwarp();  // the previous group's reads of the stage are done
    for (int i = lane * 4; i < EPW * de; i += 128) {
      const int j = i / de, k = i - j * de;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + j < e)
        v = *reinterpret_cast<const float4*>(ef + static_cast<size_t>(e0) * de + i);
      *reinterpret_cast<float4*>(stage + j * stage_w + k) = v;
    }
    __syncwarp();

    // ---- layer 1: pre1 = xa[r] + xb[s] + ef . W1e + b1 -------------------
    float a1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool rok = in_range(recv[j], n), sok = in_range(send[j], n);
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        float v = 0.f;
        if (c < h) {
          v = s_b1[c];
          if (rok) v += xa[static_cast<size_t>(recv[j]) * h + c];
          if (sok) v += xb[static_cast<size_t>(send[j]) * h + c];
        }
        a1[j][t] = v;
      }
    }
    for (int k = 0; k < de; k += 4) {
      float w[4][HPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          const int c = lane + 32 * t;
          w[q][t] = c < h ? s_w1e[(k + q) * h + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(stage + j * stage_w + k);
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          float acc = a1[j][t];
          acc = fmaf(x.x, w[0][t], acc);
          acc = fmaf(x.y, w[1][t], acc);
          acc = fmaf(x.z, w[2][t], acc);
          acc = fmaf(x.w, w[3][t], acc);
          a1[j][t] = acc;
        }
      }
    }
    cnorm_lrelu<HPL>(a1, lane, h, g1, be1, slope);

    __syncwarp();  // every lane has finished reading ef from the stage
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        if (c < h) stage[j * stage_w + c] = a1[j][t];
      }
    __syncwarp();

    // ---- layer 2: m1 . W2 + b2 --------------------------------------------
    float a2[EPW][DPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        a2[j][t] = c < d2 ? s_b2[c] : 0.f;
      }
    for (int k = 0; k < h; k += 4) {
      float w[4][DPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int c = lane + 32 * t;
          w[q][t] = c < d2 ? s_w2[(k + q) * d2 + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(stage + j * stage_w + k);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          float acc = a2[j][t];
          acc = fmaf(x.x, w[0][t], acc);
          acc = fmaf(x.y, w[1][t], acc);
          acc = fmaf(x.z, w[2][t], acc);
          acc = fmaf(x.w, w[3][t], acc);
          a2[j][t] = acc;
        }
      }
    }
    cnorm_lrelu<DPL>(a2, lane, d2, g2, be2, slope);

    // ---- scatter-add at the receiver --------------------------------------
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (!in_range(recv[j], n)) continue;
      float* row = agg + static_cast<size_t>(recv[j]) * d2;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        if (c < d2) atomicAdd(row + c, a2[j][t]);
      }
    }
  }
}

template <int HPL, int DPL>
cudaError_t launch(const float* xa, const float* xb, const float* ef,
                   const int* senders, const int* receivers, const float* w1e,
                   const float* b1, const float* w2, const float* b2,
                   const float* scal, float slope, float* agg, int n, int e,
                   int de, int h, int d2, cudaStream_t stream) {
  const int stage_w = de > h ? de : h;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(de) * h + static_cast<size_t>(h) * d2 + h + d2 +
       static_cast<size_t>(kWarps) * kEdgesPerWarp * stage_w);
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_mp_fwd_kernel<HPL, DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  int grid = (groups + kWarps - 1) / kWarps;
  if (grid > 2 * sms) grid = 2 * sms;  // grid-stride beyond two blocks per SM
  fused_mp_fwd_kernel<HPL, DPL><<<grid, kWarps * 32, smem, stream>>>(
      xa, xb, ef, senders, receivers, w1e, b1, w2, b2, scal, slope, agg, n, e,
      de, h, d2);
  return cudaGetLastError();
}

template <int HPL>
cudaError_t dispatch_d2(const float* xa, const float* xb, const float* ef,
                        const int* senders, const int* receivers,
                        const float* w1e, const float* b1, const float* w2,
                        const float* b2, const float* scal, float slope,
                        float* agg, int n, int e, int de, int h, int d2,
                        cudaStream_t stream) {
  const int dpl = (d2 + 31) / 32;
#define FMP_CASE(D)                                                          \
  case D:                                                                    \
    return launch<HPL, D>(xa, xb, ef, senders, receivers, w1e, b1, w2, b2,   \
                          scal, slope, agg, n, e, de, h, d2, stream);
  switch (dpl) {
    FMP_CASE(1)
    FMP_CASE(2)
    FMP_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef FMP_CASE
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// to contiguous arrays: xa, xb [n, h]; ef [e, de]; senders, receivers [e]
// int32; w1e [de, h]; b1 [h]; w2 [h, d2]; b2 [d2]; scal [4] = (g1, be1, g2,
// be2); agg [n, d2], zeroed by the caller.  Requires de, h, d2 multiples of 4,
// h <= 256 and d2 <= 128 (d2 rounded up to a multiple of 32 must be 32, 64 or
// 128).  Returns the launch's cudaError_t (0 on success).
extern "C" int fused_mp_forward(const float* xa, const float* xb,
                                const float* ef, const int* senders,
                                const int* receivers, const float* w1e,
                                const float* b1, const float* w2,
                                const float* b2, const float* scal,
                                float slope, float* agg, int n, int e, int de,
                                int h, int d2, void* stream) {
  if (e <= 0 || n <= 0 || de <= 0 || de % 4 || h % 4 || d2 % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpl = (h + 31) / 32;
#define FMP_CASE(H)                                                          \
  case H:                                                                    \
    return dispatch_d2<H>(xa, xb, ef, senders, receivers, w1e, b1, w2, b2,   \
                          scal, slope, agg, n, e, de, h, d2, s);
  switch (hpl) {
    FMP_CASE(1)
    FMP_CASE(2)
    FMP_CASE(4)
    FMP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FMP_CASE
}
