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
//
// bf16 operands (fused_mp_forward_bf16).  The TPU kernel's bf16 mode
// (_kernel with bf16=True) feeds every MXU dot bf16 operands and accumulates
// in f32.  The BF16 instantiation rounds (to nearest even,
// __float2bfloat16_rn) at exactly its points: W1e and W2 when staged, each
// staged ef row, each gathered xa/xb element (the TPU rounds the products
// x.W1r and x.W1s, which the caller computes in f32), the layer-1
// activations when staged for layer 2, and each message before its
// atomicAdd.  b1, b2, both norms and every sum stay f32.  A product of two
// bf16 values is exact in f32, so f32 FMAs over rounded operands compute the
// TPU function up to summation order.  Its bound on this card is the bytes
// (the same work on bf16 tensor cores, 989 TFLOP/s, takes less time than
// reading the inputs); tensor-core tiles are later work.
//
// ---------------------------------------------------------------------------
// Backward (fused_mp_backward) for the same round.  Replaces the TPU kernel
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py::_bwd_kernel
// (launched by _backward_impl).  Per edge e = (s -> r) it recomputes the
// forward (pre1 -> norm1 -> a1 -> pre2 -> norm2), then, with gm = g_out[r]
// (zero if r is outside [0, N)):
//
//   g_pre2, dg2, dbe2 = cnorm_act_bwd(gm)        dW2 += a1^T g_pre2, db2 += g_pre2
//   ga1 = g_pre2 W2^T
//   g_pre1, dg1, dbe1 = cnorm_act_bwd(ga1)       dW1e += ef^T g_pre1, db1 += g_pre1
//   gef[e] = g_pre1 W1e^T
//   dxa[r] += g_pre1;  dxb[s] += g_pre1 only if s is inside [0, N)
//
// cnorm_act_bwd is the chain rule of lrelu(gamma * xhat + beta) with the
// reference's guard for constant rows: c = sum(gamma gh u) /
// ((sd + eps)^2 max(sd, 1e-30) (d - 1)), g_pre = g_u - mean(g_u).
// dx = dxa W1r^T + dxb W1s^T and the W1r/W1s rows of dW1 are node-level
// products left to torch.matmul, as _backward_impl leaves them to XLA.
//
// What bounds it.  An edge costs three times the forward's FMAs: 2 * 3 *
// (De*H + H*D2) = 98 304 FLOP at the shipped widths, against ~400 bytes of
// its own traffic, so it is FP32-FMA-bound on paper (~13.5 us for 9 216
// live edges at 67 TFLOP/s).  Like the forward it is expected to miss that
// by a wide margin: one warp walks a long dependent chain per edge group.
//
// Design (simple first):
// * The forward's layout: one warp carries kEdgesPerWarp edges; lanes own
//   channels (hidden, output or edge-feature, per product); both norm
//   backwards reduce with warp shuffles.
// * The weight gradients dW1e [De, H] and dW2 [H, D2] accumulate in shared
//   memory with shared atomics (64 KB at the shipped widths) and go to the
//   global result with one atomicAdd per element per block; db1, db2 and the
//   four scalar gradients accumulate in registers and are added once per
//   warp.  A block walks edge groups in a grid-stride loop, one block per SM.
// * Weights are read from global memory (L1/L2-resident); W1e^T and W2^T
//   come in transposed copies so that every product reads along rows.
// * Per warp, the edge rows (ef), the layer-1 activations and the current
//   cotangent rows are staged in shared memory and read back as 16-byte
//   broadcasts.
// * dxa/dxb are atomicAdd into buffers the caller zeroes; gef is a plain
//   store of the edges whose receiver is in range (the caller zeroes the
//   rest).  Groups whose receivers are all outside [0, N) are skipped.
// * Atomics make the summation order, and the last bits, vary per run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kEdgesPerWarp = 8;   // edges a warp carries at once
constexpr float kEps = 1e-5f;      // reference modules/neural_net/constants.py

// v as an MXU operand of the TPU kernel: rounded to bf16 (nearest even, as
// JAX's astype) when BF16, else unchanged.
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
__device__ __forceinline__ float4 operand(float4 v) {
  return make_float4(operand<BF16>(v.x), operand<BF16>(v.y),
                     operand<BF16>(v.z), operand<BF16>(v.w));
}

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

template <int HPL, int DPL, bool BF16>
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
    reinterpret_cast<float4*>(s_w1e)[i] =
        operand<BF16>(reinterpret_cast<const float4*>(w1e)[i]);
  for (int i = tid; i < (h * d2) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_w2)[i] =
        operand<BF16>(reinterpret_cast<const float4*>(w2)[i]);
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
      *reinterpret_cast<float4*>(stage + j * stage_w + k) = operand<BF16>(v);
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
          if (rok) v += operand<BF16>(xa[static_cast<size_t>(recv[j]) * h + c]);
          if (sok) v += operand<BF16>(xb[static_cast<size_t>(send[j]) * h + c]);
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
        if (c < h) stage[j * stage_w + c] = operand<BF16>(a1[j][t]);
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
        if (c < d2) atomicAdd(row + c, operand<BF16>(a2[j][t]));
      }
    }
  }
}

template <int HPL, int DPL, bool BF16>
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
  err = cudaFuncSetAttribute(fused_mp_fwd_kernel<HPL, DPL, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  int grid = (groups + kWarps - 1) / kWarps;
  if (grid > 2 * sms) grid = 2 * sms;  // grid-stride beyond two blocks per SM
  fused_mp_fwd_kernel<HPL, DPL, BF16><<<grid, kWarps * 32, smem, stream>>>(
      xa, xb, ef, senders, receivers, w1e, b1, w2, b2, scal, slope, agg, n, e,
      de, h, d2);
  return cudaGetLastError();
}

template <int HPL, bool BF16>
cudaError_t dispatch_d2(const float* xa, const float* xb, const float* ef,
                        const int* senders, const int* receivers,
                        const float* w1e, const float* b1, const float* w2,
                        const float* b2, const float* scal, float slope,
                        float* agg, int n, int e, int de, int h, int d2,
                        cudaStream_t stream) {
  const int dpl = (d2 + 31) / 32;
#define FMP_CASE(D)                                                          \
  case D:                                                                    \
    return launch<HPL, D, BF16>(xa, xb, ef, senders, receivers, w1e, b1, w2, \
                                b2, scal, slope, agg, n, e, de, h, d2, stream);
  switch (dpl) {
    FMP_CASE(1)
    FMP_CASE(2)
    FMP_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef FMP_CASE
}

// ===========================================================================
// Backward
// ===========================================================================

constexpr float kTiny = 1e-30f;  // fused_mp.py::_TINY

// Centre kEdgesPerWarp rows in place (v <- v - mean, zero past `width`) and
// return their Bessel std in sd.
template <int CPL>
__device__ __forceinline__ void cnorm_stats(float (&v)[kEdgesPerWarp][CPL],
                                            float (&sd)[kEdgesPerWarp],
                                            int lane, int width) {
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
    for (int t = 0; t < CPL; ++t) {
      const float u = lane + 32 * t < width ? v[j][t] - mean : 0.f;
      v[j][t] = u;
      q += u * u;
    }
    sd[j] = sqrtf(warp_sum(q) * inv_nm1);
  }
}

// Chain rule through lrelu(gamma * u / (sd + eps) + beta) for kEdgesPerWarp
// rows: g holds the cotangent of the activation and is replaced by the
// cotangent of the norm's input; dgamma/dbeta accumulate this lane's share.
template <int CPL>
__device__ __forceinline__ void cnorm_act_bwd(
    float (&g)[kEdgesPerWarp][CPL], const float (&u)[kEdgesPerWarp][CPL],
    const float (&sd)[kEdgesPerWarp], int lane, int width, float gamma,
    float beta, float slope, float& dgamma, float& dbeta) {
  const float inv_n = 1.0f / static_cast<float>(width);
  const float nm1 = static_cast<float>(width > 1 ? width - 1 : 1);
#pragma unroll
  for (int j = 0; j < kEdgesPerWarp; ++j) {
    const float den = sd[j] + kEps;
    float num = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      float gxh = 0.f;
      if (lane + 32 * t < width) {
        const float xhat = u[j][t] / den;
        const float gh = gamma * xhat + beta >= 0.f ? g[j][t] : g[j][t] * slope;
        dgamma += gh * xhat;
        dbeta += gh;
        gxh = gamma * gh;
        num += gxh * u[j][t];
      }
      g[j][t] = gxh;
    }
    const float c = warp_sum(num) / (den * den * fmaxf(sd[j], kTiny) * nm1);
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const float gu = lane + 32 * t < width ? g[j][t] / den - u[j][t] * c : 0.f;
      g[j][t] = gu;
      s += gu;
    }
    const float mean = warp_sum(s) * inv_n;
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      g[j][t] = lane + 32 * t < width ? g[j][t] - mean : 0.f;
  }
}

template <int HPL, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
fused_mp_bwd_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef,
                    const int* __restrict__ senders,
                    const int* __restrict__ receivers,
                    const float* __restrict__ w1e,
                    const float* __restrict__ w1e_t,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ w2_t,
                    const float* __restrict__ b2,
                    const float* __restrict__ scal,
                    const float* __restrict__ gout, float slope,
                    float* __restrict__ gef, float* __restrict__ dxa,
                    float* __restrict__ dxb, float* __restrict__ dw1e,
                    float* __restrict__ db1, float* __restrict__ dw2,
                    float* __restrict__ db2, float* __restrict__ dscal, int n,
                    int e, int de, int h, int d2) {
  constexpr int EPW = kEdgesPerWarp;
  extern __shared__ __align__(16) float smem[];
  const int gw = h > d2 ? h : d2;  // width of the staged cotangent rows
  float* s_dw1e = smem;            // [de, h]
  float* s_dw2 = s_dw1e + de * h;  // [h, d2]
  // de, h, d2 are multiples of 4 (checked on the host): every row below
  // starts 16-byte aligned.
  float* s_stage = s_dw2 + h * d2;  // [kWarps][EPW][de + h + gw]

  const int tid = threadIdx.x;
  for (int i = tid; i < de * h; i += blockDim.x) s_dw1e[i] = 0.f;
  for (int i = tid; i < h * d2; i += blockDim.x) s_dw2[i] = 0.f;
  __syncthreads();

  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  const int warp = tid >> 5, lane = tid & 31;
  float* st_ef = s_stage + warp * EPW * (de + h + gw);  // [EPW][de]
  float* st_a1 = st_ef + EPW * de;                      // [EPW][h]
  float* st_g = st_a1 + EPW * h;                        // [EPW][gw]
  const int groups = (e + EPW - 1) / EPW;

  float r_db1[HPL], r_db2[DPL];
#pragma unroll
  for (int t = 0; t < HPL; ++t) r_db1[t] = 0.f;
#pragma unroll
  for (int t = 0; t < DPL; ++t) r_db2[t] = 0.f;
  float r_dg1 = 0.f, r_dbe1 = 0.f, r_dg2 = 0.f, r_dbe2 = 0.f;

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
    if (!any) continue;  // warp-uniform: every cotangent would be zero

    __syncwarp();  // the previous group's reads of the stage are done
    for (int i = lane * 4; i < EPW * de; i += 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + i / de < e)
        v = *reinterpret_cast<const float4*>(ef + static_cast<size_t>(e0) * de + i);
      *reinterpret_cast<float4*>(st_ef + i) = v;
    }
    __syncwarp();

    // ---- recompute layer 1: pre1 = xa[r] + xb[s] + ef . W1e + b1 ---------
    float u1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool rok = in_range(recv[j], n), sok = in_range(send[j], n);
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        float v = 0.f;
        if (c < h) {
          v = b1[c];
          if (rok) v += xa[static_cast<size_t>(recv[j]) * h + c];
          if (sok) v += xb[static_cast<size_t>(send[j]) * h + c];
        }
        u1[j][t] = v;
      }
    }
    for (int k = 0; k < de; k += 4) {
      float w[4][HPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          const int c = lane + 32 * t;
          w[q][t] = c < h ? w1e[(k + q) * h + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(st_ef + j * de + k);
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          float acc = u1[j][t];
          acc = fmaf(x.x, w[0][t], acc);
          acc = fmaf(x.y, w[1][t], acc);
          acc = fmaf(x.z, w[2][t], acc);
          acc = fmaf(x.w, w[3][t], acc);
          u1[j][t] = acc;
        }
      }
    }
    float sd1[EPW];
    cnorm_stats<HPL>(u1, sd1, lane, h);
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        if (c < h) {
          const float y = g1 * (u1[j][t] / (sd1[j] + kEps)) + be1;
          st_a1[j * h + c] = y >= 0.f ? y : slope * y;
        }
      }
    __syncwarp();

    // ---- recompute layer 2: pre2 = a1 . W2 + b2 ---------------------------
    float u2[EPW][DPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        u2[j][t] = c < d2 ? b2[c] : 0.f;
      }
    for (int k = 0; k < h; k += 4) {
      float w[4][DPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int c = lane + 32 * t;
          w[q][t] = c < d2 ? w2[(k + q) * d2 + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(st_a1 + j * h + k);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          float acc = u2[j][t];
          acc = fmaf(x.x, w[0][t], acc);
          acc = fmaf(x.y, w[1][t], acc);
          acc = fmaf(x.z, w[2][t], acc);
          acc = fmaf(x.w, w[3][t], acc);
          u2[j][t] = acc;
        }
      }
    }
    float sd2[EPW];
    cnorm_stats<DPL>(u2, sd2, lane, d2);

    // ---- norm2 backward from the receiver's cotangent ---------------------
    float gp2[EPW][DPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool rok = in_range(recv[j], n);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        gp2[j][t] = rok && c < d2 ? gout[static_cast<size_t>(recv[j]) * d2 + c] : 0.f;
      }
    }
    cnorm_act_bwd<DPL>(gp2, u2, sd2, lane, d2, g2, be2, slope, r_dg2, r_dbe2);
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        r_db2[t] += gp2[j][t];
        if (c < d2) st_g[j * gw + c] = gp2[j][t];
      }
    __syncwarp();

    // ---- dW2 += a1^T g_pre2 (lanes own output columns) --------------------
    for (int k = 0; k < h; k += 4) {
      float acc[4][DPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[q][t] = 0.f;
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(st_a1 + j * h + k);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          acc[0][t] = fmaf(a.x, gp2[j][t], acc[0][t]);
          acc[1][t] = fmaf(a.y, gp2[j][t], acc[1][t]);
          acc[2][t] = fmaf(a.z, gp2[j][t], acc[2][t]);
          acc[3][t] = fmaf(a.w, gp2[j][t], acc[3][t]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int c = lane + 32 * t;
          if (c < d2) atomicAdd(s_dw2 + (k + q) * d2 + c, acc[q][t]);
        }
    }

    // ---- ga1 = g_pre2 W2^T (lanes own hidden channels) --------------------
    float gp1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) gp1[j][t] = 0.f;
    for (int k = 0; k < d2; k += 4) {
      float w[4][HPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          const int c = lane + 32 * t;
          w[q][t] = c < h ? w2_t[(k + q) * h + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(st_g + j * gw + k);
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          float acc = gp1[j][t];
          acc = fmaf(x.x, w[0][t], acc);
          acc = fmaf(x.y, w[1][t], acc);
          acc = fmaf(x.z, w[2][t], acc);
          acc = fmaf(x.w, w[3][t], acc);
          gp1[j][t] = acc;
        }
      }
    }

    // ---- norm1 backward, then the node cotangents --------------------------
    cnorm_act_bwd<HPL>(gp1, u1, sd1, lane, h, g1, be1, slope, r_dg1, r_dbe1);
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool rok = in_range(recv[j], n), sok = in_range(send[j], n);
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        r_db1[t] += gp1[j][t];
        if (c < h && rok) {
          atomicAdd(dxa + static_cast<size_t>(recv[j]) * h + c, gp1[j][t]);
          if (sok) atomicAdd(dxb + static_cast<size_t>(send[j]) * h + c, gp1[j][t]);
        }
      }
    }
    __syncwarp();  // every lane has finished reading g_pre2 from the stage
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        if (c < h) st_g[j * gw + c] = gp1[j][t];
      }
    __syncwarp();

    // ---- dW1e += ef^T g_pre1 (lanes own hidden channels) ------------------
    for (int k = 0; k < de; k += 4) {
      float acc[4][HPL];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < HPL; ++t) acc[q][t] = 0.f;
#pragma unroll
      for (int j = 0; j < EPW; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(st_ef + j * de + k);
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          acc[0][t] = fmaf(x.x, gp1[j][t], acc[0][t]);
          acc[1][t] = fmaf(x.y, gp1[j][t], acc[1][t]);
          acc[2][t] = fmaf(x.z, gp1[j][t], acc[2][t]);
          acc[3][t] = fmaf(x.w, gp1[j][t], acc[3][t]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < HPL; ++t) {
          const int c = lane + 32 * t;
          if (c < h) atomicAdd(s_dw1e + (k + q) * h + c, acc[q][t]);
        }
    }

    // ---- gef = g_pre1 W1e^T (lanes own edge-feature channels) --------------
    for (int cb = 0; cb < de; cb += 32) {
      const int c = cb + lane;
      float acc[EPW];
#pragma unroll
      for (int j = 0; j < EPW; ++j) acc[j] = 0.f;
      for (int k = 0; k < h; k += 4) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = c < de ? w1e_t[(k + q) * de + c] : 0.f;
#pragma unroll
        for (int j = 0; j < EPW; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(st_g + j * gw + k);
          float a = acc[j];
          a = fmaf(x.x, w[0], a);
          a = fmaf(x.y, w[1], a);
          a = fmaf(x.z, w[2], a);
          a = fmaf(x.w, w[3], a);
          acc[j] = a;
        }
      }
#pragma unroll
      for (int j = 0; j < EPW; ++j)
        if (c < de && in_range(recv[j], n))
          gef[static_cast<size_t>(e0 + j) * de + c] = acc[j];
    }
  }

  // ---- this warp's bias and scalar gradients, then the block's weights ----
#pragma unroll
  for (int t = 0; t < HPL; ++t)
    if (lane + 32 * t < h) atomicAdd(db1 + lane + 32 * t, r_db1[t]);
#pragma unroll
  for (int t = 0; t < DPL; ++t)
    if (lane + 32 * t < d2) atomicAdd(db2 + lane + 32 * t, r_db2[t]);
  const float sg1 = warp_sum(r_dg1), sbe1 = warp_sum(r_dbe1);
  const float sg2 = warp_sum(r_dg2), sbe2 = warp_sum(r_dbe2);
  if (lane == 0) {
    atomicAdd(dscal + 0, sg1);
    atomicAdd(dscal + 1, sbe1);
    atomicAdd(dscal + 2, sg2);
    atomicAdd(dscal + 3, sbe2);
  }
  __syncthreads();
  for (int i = tid; i < de * h; i += blockDim.x) atomicAdd(dw1e + i, s_dw1e[i]);
  for (int i = tid; i < h * d2; i += blockDim.x) atomicAdd(dw2 + i, s_dw2[i]);
}

template <int HPL, int DPL>
cudaError_t launch_bwd(const float* xa, const float* xb, const float* ef,
                       const int* senders, const int* receivers,
                       const float* w1e, const float* w1e_t, const float* b1,
                       const float* w2, const float* w2_t, const float* b2,
                       const float* scal, const float* gout, float slope,
                       float* gef, float* dxa, float* dxb, float* dw1e,
                       float* db1, float* dw2, float* db2, float* dscal, int n,
                       int e, int de, int h, int d2, cudaStream_t stream) {
  const int gw = h > d2 ? h : d2;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(de) * h + static_cast<size_t>(h) * d2 +
       static_cast<size_t>(kWarps) * kEdgesPerWarp * (de + h + gw));
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_mp_bwd_kernel<HPL, DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  int grid = (groups + kWarps - 1) / kWarps;
  if (grid > sms) grid = sms;  // one block per SM walks the rest
  fused_mp_bwd_kernel<HPL, DPL><<<grid, kWarps * 32, smem, stream>>>(
      xa, xb, ef, senders, receivers, w1e, w1e_t, b1, w2, w2_t, b2, scal,
      gout, slope, gef, dxa, dxb, dw1e, db1, dw2, db2, dscal, n, e, de, h, d2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point of the backward, loaded with ctypes.  All pointers are
// device pointers to contiguous f32 arrays unless stated: xa, xb [n, h];
// ef [e, de]; senders, receivers [e] int32; w1e [de, h] and its transpose
// w1e_t [h, de]; b1 [h]; w2 [h, d2] and its transpose w2_t [d2, h]; b2 [d2];
// scal [4] = (g1, be1, g2, be2); gout [n, d2].  Outputs, all zeroed by the
// caller: gef [e, de]; dxa, dxb [n, h]; dw1e [de, h]; db1 [h]; dw2 [h, d2];
// db2 [d2]; dscal [4] = (dg1, dbe1, dg2, dbe2).  The same width limits as
// fused_mp_forward.  Returns the launch's cudaError_t (0 on success).
extern "C" int fused_mp_backward(
    const float* xa, const float* xb, const float* ef, const int* senders,
    const int* receivers, const float* w1e, const float* w1e_t,
    const float* b1, const float* w2, const float* w2_t, const float* b2,
    const float* scal, const float* gout, float slope, float* gef, float* dxa,
    float* dxb, float* dw1e, float* db1, float* dw2, float* db2, float* dscal,
    int n, int e, int de, int h, int d2, void* stream) {
  if (e <= 0 || n <= 0 || de <= 0 || de % 4 || h % 4 || d2 % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
#define FMP_BWD_CASE(H, D)                                                    \
  if (hpl == H && dpl == D)                                                   \
    return launch_bwd<H, D>(xa, xb, ef, senders, receivers, w1e, w1e_t, b1,   \
                            w2, w2_t, b2, scal, gout, slope, gef, dxa, dxb,   \
                            dw1e, db1, dw2, db2, dscal, n, e, de, h, d2, s);
#define FMP_BWD_ROW(H) FMP_BWD_CASE(H, 1) FMP_BWD_CASE(H, 2) FMP_BWD_CASE(H, 4)
  FMP_BWD_ROW(1)
  FMP_BWD_ROW(2)
  FMP_BWD_ROW(4)
  FMP_BWD_ROW(8)
#undef FMP_BWD_ROW
#undef FMP_BWD_CASE
  return cudaErrorInvalidValue;
}

namespace {

template <bool BF16>
int forward_entry(const float* xa, const float* xb, const float* ef,
                  const int* senders, const int* receivers, const float* w1e,
                  const float* b1, const float* w2, const float* b2,
                  const float* scal, float slope, float* agg, int n, int e,
                  int de, int h, int d2, void* stream) {
  if (e <= 0 || n <= 0 || de <= 0 || de % 4 || h % 4 || d2 % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpl = (h + 31) / 32;
#define FMP_CASE(H)                                                          \
  case H:                                                                    \
    return dispatch_d2<H, BF16>(xa, xb, ef, senders, receivers, w1e, b1, w2, \
                                b2, scal, slope, agg, n, e, de, h, d2, s);
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
  return forward_entry<false>(xa, xb, ef, senders, receivers, w1e, b1, w2, b2,
                              scal, slope, agg, n, e, de, h, d2, stream);
}

// The same with the TPU kernel's bf16 operands (top of this file): the same
// arguments, xa and xb the f32 products x . W1r and x . W1s.
extern "C" int fused_mp_forward_bf16(const float* xa, const float* xb,
                                     const float* ef, const int* senders,
                                     const int* receivers, const float* w1e,
                                     const float* b1, const float* w2,
                                     const float* b2, const float* scal,
                                     float slope, float* agg, int n, int e,
                                     int de, int h, int d2, void* stream) {
  return forward_entry<true>(xa, xb, ef, senders, receivers, w1e, b1, w2, b2,
                             scal, slope, agg, n, e, de, h, d2, stream);
}
