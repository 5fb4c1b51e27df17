// Fused message-passing round for Hopper (sm_90a): forward
// (fused_mp_forward, fused_mp_forward_bf16) and backward (fused_mp_backward).
//
// Replaces the TPU kernels
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py::_kernel
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/fused_mp.py::_bwd_kernel
// (launched by _forward_impl and _backward_impl).  For every directed edge
// e = (s -> r):
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
// Fixed-order sums.  The TPU kernel adds into its output block over a
// sequential grid, so its sums run in a fixed order.  Here the edges come
// in any order, with the graph's layout (ops/fused_mp.fused_layout, made
// once per graph): recv_order, the edges by receiver (a stable argsort,
// the out-of-range receivers last), and recv_off [N+1], node v's segment
// [recv_off[v], recv_off[v+1]) of it; the same over the senders.  Every
// sum below walks one of them: no atomics, two launches give the same bits.
//
// Forward (two launches in one C call).  (1) fused_mp_msg_kernel: a warp
// carries eight consecutive positions of the receiver order (one group of
// edges, as every warp of the TPU port's first kernel did), computes their
// messages and writes each to its edge's row of a scratch msgs [E, D2];
// blocks past the kept edges return at once.  (2) segsum_kernel (shared
// with the backward, csrc/mp_edge_tile.cuh): one warp a node adds its
// receiver segment's rows in edge order and writes its agg row once (zero
// for a node without edges), so the caller zeroes nothing.  Lane l owns
// hidden channels l, l+32, ... and output channels l, l+32, ...; every
// weight it reads from shared memory feeds eight FMAs.  W1e [De, H], W2
// [H, D2], b1, b2 are staged once per block in dynamic shared memory (65 KB
// at the shipped widths); the edge rows (ef, then the layer-1 activations)
// are staged per warp and read back as 16-byte broadcasts; both norms are
// warp-shuffle reductions, the mean first, then the centred squares, as
// the reference.  A warp that walked whole receiver segments instead (one
// launch, no scratch, the same sums) carried a segment's groups in a row:
// 88 us against 36 + 7 us for the two launches here, at the main path's
// shapes on an H100 (PERF.md).
//
// What bounds it.  At the shipped widths (De = D = D2 = 64, H = 128) an edge
// costs 2 * (De*H + H*D2) = 32 768 FLOP and reads ~264 bytes, about 120
// FLOP/byte: well above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte).  So its bound is FP32 FMA throughput (no tensor cores: the
// reference is f32).  At the deploy shapes the warps fill one wave, and
// the message launch lasts one warp's dependent chain over its group
// (PERF.md).
//
// bf16 operands (fused_mp_forward_bf16).  The TPU kernel's bf16 mode
// (_kernel with bf16=True) feeds every MXU dot bf16 operands and accumulates
// in f32.  The BF16 instantiation rounds (to nearest even,
// __float2bfloat16_rn) at exactly its points: W1e and W2 when staged, each
// staged ef row, each gathered xa/xb element (the TPU rounds the products
// x.W1r and x.W1s, which the caller computes in f32), the layer-1
// activations when staged for layer 2, and each message before it is added.
// b1, b2, both norms and every sum stay f32.  A product of two bf16 values
// is exact in f32, so f32 FMAs over rounded operands compute the TPU
// function up to summation order.  Its bound on this card is the bytes
// (the same work on bf16 tensor cores takes less time than reading the
// inputs); tensor-core tiles are later work.
//
// ---------------------------------------------------------------------------
// Backward (fused_mp_backward).  Per edge e = (s -> r) it recomputes the
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
// Three launches in one C call, over the edge-tile core that the CSR
// round's backward shares (csrc/mp_edge_tile.cuh): (1) bwd_edge_kernel over
// the receiver order: one block per SM, each a balanced contiguous run of
// the kept edges in tiles of 32 (16 or 8 where 32 rows overflow the shared
// memory), W1e and W2 in shared memory once per block, the four edge
// products register-tiled on shared memory, dW1e, dW2, db1, db2 and the
// four scalars into one partial per block, gef written for every edge
// (zero for a dropped one), g_pre1 to a per-edge scratch; (2) segsum_kernel:
// dxa over the receiver segments, dxb over the sender segments, in edge
// order; (3) bwd_reduce_kernel: every partial in block order.  Every output
// is written by the call (no zeroing by the caller) and is a fixed-order sum.
//
// What bounds it.  Three times the forward's FMAs: 2 * 3 * (De*H + H*D2) =
// 98 304 FLOP an edge at the shipped widths, against ~400 bytes of its own
// traffic, so FP32 FMAs on paper (~13.5 us for 9 216 live edges at 67
// TFLOP/s).  The edge kernel's products are bound by shared-memory
// bandwidth instead (a lane's 16-byte load costs the same whether or not
// its warp shares the address): csrc/csr_mp.cu and PERF.md.

#include "mp_edge_tile.cuh"

namespace {

// Forward, launch 1: warp gw carries the kEdgesPerWarp positions from
// gw * kEdgesPerWarp of the receiver order (those before recv_off[n], the
// kept edges) and writes each edge's message, rounded as it will be added,
// to its row of msgs [e, d2].  BF16 rounds W1e, W2, the staged ef rows,
// each gathered xa/xb element, the staged layer-1 activations and each
// message.
template <int HPL, int DPL, bool BF16>
__global__ void __launch_bounds__(kWarps * 32)
fused_mp_msg_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef,
                    const int* __restrict__ senders,
                    const int* __restrict__ receivers,
                    const int* __restrict__ order, const int* __restrict__ off,
                    const float* __restrict__ w1e, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ scal, float slope,
                    float* __restrict__ msgs, int n, int de, int h, int d2) {
  constexpr int EPW = kEdgesPerWarp;
  const int q_hi = off[n];
  // A block whose positions all lie past the kept edges stages nothing.
  if (static_cast<int>(blockIdx.x) * kWarps * EPW >= q_hi) return;
  extern __shared__ __align__(16) float smem[];
  const int stage_w = de > h ? de : h;  // floats per staged edge row
  float* s_w1e = smem;                  // [de, h]
  float* s_w2 = s_w1e + de * h;         // [h, d2]
  float* s_b1 = s_w2 + h * d2;          // [h]
  float* s_b2 = s_b1 + h;               // [d2]
  // d2 is a multiple of 4 (checked on the host): the stage is 16-byte aligned.
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

  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (blockIdx.x * kWarps + warp) * EPW;
  if (q0 >= q_hi) return;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  float* stage = s_stage + warp * EPW * stage_w;
  // Lane j < EPW reads the edge at position q0 + j and its two ends; the
  // warp shares them by shuffles.
  const int my_p = lane < EPW && q0 + lane < q_hi ? order[q0 + lane] : -1;
  const int my_r = my_p >= 0 ? receivers[my_p] : -1;
  const int my_s = my_p >= 0 ? senders[my_p] : -1;
  int pj[EPW], rj[EPW], sj[EPW];
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    pj[j] = __shfl_sync(0xffffffffu, my_p, j);
    rj[j] = __shfl_sync(0xffffffffu, my_r, j);
    sj[j] = __shfl_sync(0xffffffffu, my_s, j);
  }

  for (int base = 0; base < EPW * de; base += 128) {
    const int i = base + lane * 4;
    const int j = min(i / de, EPW - 1);
    const int p = __shfl_sync(0xffffffffu, my_p, j);
    if (i < EPW * de) {
      const int k = i - j * de;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p >= 0) v = *reinterpret_cast<const float4*>(ef + static_cast<size_t>(p) * de + k);
      *reinterpret_cast<float4*>(stage + j * stage_w + k) = operand<BF16>(v);
    }
  }
  __syncwarp();

  // ---- layer 1: pre1 = xa[r] + xb[s] + ef . W1e + b1 -------------------
  float a1[EPW][HPL];
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    const bool live = pj[j] >= 0, sok = in_range(sj[j], n);
#pragma unroll
    for (int t = 0; t < HPL; ++t) {
      const int c = lane + 32 * t;
      float v = 0.f;
      if (c < h) {
        v = s_b1[c];
        if (live) v += operand<BF16>(xa[static_cast<size_t>(rj[j]) * h + c]);
        if (sok) v += operand<BF16>(xb[static_cast<size_t>(sj[j]) * h + c]);
      }
      a1[j][t] = v;
    }
  }
  rows_times<HPL>(a1, stage, stage_w, s_w1e, h, de, lane, h);
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
  rows_times<DPL>(a2, stage, stage_w, s_w2, d2, h, lane, d2);
  cnorm_lrelu<DPL>(a2, lane, d2, g2, be2, slope);

  // ---- each message to its edge's row ------------------------------------
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    if (pj[j] < 0) continue;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int c = lane + 32 * t;
      if (c < d2) msgs[static_cast<size_t>(pj[j]) * d2 + c] = operand<BF16>(a2[j][t]);
    }
  }
}

template <int HPL, int DPL, bool BF16>
cudaError_t launch_fwd(const float* xa, const float* xb, const float* ef,
                       const int* senders, const int* receivers,
                       const int* order, const int* off, const float* w1e,
                       const float* b1, const float* w2, const float* b2,
                       const float* scal, float slope, float* msgs, float* agg,
                       int n, int e, int de, int h, int d2,
                       cudaStream_t stream) {
  const int stage_w = de > h ? de : h;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(de) * h + static_cast<size_t>(h) * d2 + h + d2 +
       static_cast<size_t>(kWarps) * kEdgesPerWarp * stage_w);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_mp_msg_kernel<HPL, DPL, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // One warp per edge group of the edge capacity: known on the host, so
  // the launch needs no device->host read of the kept count.
  const int groups = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  const int grid = groups > 0 ? (groups + kWarps - 1) / kWarps : 1;
  fused_mp_msg_kernel<HPL, DPL, BF16><<<grid, kWarps * 32, smem, stream>>>(
      xa, xb, ef, senders, receivers, order, off, w1e, b1, w2, b2, scal,
      slope, msgs, n, de, h, d2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // Launch 2: agg[v] = the messages of v's receiver segment, in edge order.
  segsum_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      msgs, receivers, order, nullptr, off, nullptr, n, d2, agg);
  return cudaGetLastError();
}

// The (ceil(h / 32), ceil(d2 / 32)) pairs the forward is instantiated for.
#define FUSED_WIDTHS(X) \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) \
  X(4, 1) X(4, 2) X(4, 4) X(8, 1) X(8, 2) X(8, 4)

template <bool BF16>
int forward_entry(const float* xa, const float* xb, const float* ef,
                  const int* senders, const int* receivers, const int* order,
                  const int* off, const float* w1e, const float* b1,
                  const float* w2, const float* b2, const float* scal,
                  float slope, float* msgs, float* agg, int n, int e, int de,
                  int h, int d2, void* stream) {
  if (!edge_widths_ok(n, e, de, h, d2)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
#define FMP_FWD(H, D)                                                         \
  if (hpl == H && dpl == D)                                                   \
    return launch_fwd<H, D, BF16>(xa, xb, ef, senders, receivers, order, off, \
                                  w1e, b1, w2, b2, scal, slope, msgs, agg, n, \
                                  e, de, h, d2, s);
  FUSED_WIDTHS(FMP_FWD)
#undef FMP_FWD
  return cudaErrorInvalidValue;
}

// fused_mp_backward's scratch, in floats, each part rounded up to 16 bytes:
// rows [e, h] (g_pre1 by edge) and p_edge [blocks, edge_partial].
constexpr int kFusedScratchParts = 2;
void fused_bwd_scratch(int e, int de, int h, int d2, int blocks,
                       long long (&sz)[kFusedScratchParts]) {
  sz[0] = static_cast<long long>(e) * h;
  sz[1] = static_cast<long long>(blocks) * edge_partial(de, h, d2);
  for (long long& v : sz) v = (v + 3) & ~3LL;
}

}  // namespace

// Forward entry point, loaded with ctypes.  All pointers are device
// pointers to contiguous arrays: xa, xb [n, h]; ef [e, de]; senders,
// receivers [e] int32; recv_order [e] int32 and recv_off [n + 1] int32, the
// receiver order of the graph's layout (top of this file); w1e [de, h]; b1
// [h]; w2 [h, d2]; b2 [d2]; scal [4] = (g1, be1, g2, be2); msgs [e, d2], a
// scratch never read before the call writes it; agg [n, d2], every row of
// which is written.  Requires de, h, d2 multiples of 4, h <= 256 and
// d2 <= 128 (d2 rounded up to a multiple of 32 must be 32, 64 or 128).
// Returns the first failing cudaError_t (0 on success).
extern "C" int fused_mp_forward(const float* xa, const float* xb,
                                const float* ef, const int* senders,
                                const int* receivers, const int* recv_order,
                                const int* recv_off, const float* w1e,
                                const float* b1, const float* w2,
                                const float* b2, const float* scal,
                                float slope, float* msgs, float* agg, int n,
                                int e, int de, int h, int d2, void* stream) {
  return forward_entry<false>(xa, xb, ef, senders, receivers, recv_order,
                              recv_off, w1e, b1, w2, b2, scal, slope, msgs,
                              agg, n, e, de, h, d2, stream);
}

// The same with the TPU kernel's bf16 operands (top of this file): the same
// arguments, xa and xb the f32 products x . W1r and x . W1s.
extern "C" int fused_mp_forward_bf16(const float* xa, const float* xb,
                                     const float* ef, const int* senders,
                                     const int* receivers,
                                     const int* recv_order, const int* recv_off,
                                     const float* w1e, const float* b1,
                                     const float* w2, const float* b2,
                                     const float* scal, float slope,
                                     float* msgs, float* agg, int n, int e,
                                     int de, int h, int d2, void* stream) {
  return forward_entry<true>(xa, xb, ef, senders, receivers, recv_order,
                             recv_off, w1e, b1, w2, b2, scal, slope, msgs, agg,
                             n, e, de, h, d2, stream);
}

// The scratch of one fused_mp_backward call at these widths on the current
// device, in floats, or minus a cudaError_t (1: widths the forward does not
// take).  plan[3] gets the edge kernel's tile, input stages and blocks.
// Loaded with ctypes.
extern "C" long long fused_mp_backward_scratch(int n, int e, int de, int h,
                                               int d2, int* plan) {
  if (!edge_widths_ok(n, e, de, h, d2)) return -cudaErrorInvalidValue;
  BwdPlan p;
  const cudaError_t err = bwd_plan(e, de, h, d2, true, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  long long sz[kFusedScratchParts];
  fused_bwd_scratch(e, de, h, d2, p.blocks, sz);
  plan[0] = p.tile;
  plan[1] = p.stages;
  plan[2] = p.blocks;
  return sz[0] + sz[1];
}

// Backward entry point, loaded with ctypes.  Inputs as fused_mp_forward,
// plus send_order [e] and send_off [n + 1] int32 (the sender order of the
// layout) and gout [n, d2]; w1e, w2, gout, xa, xb and, for e > 0, ef are
// 16-byte aligned.  scratch: the floats fused_mp_backward_scratch gives,
// never read before the call writes them.  Outputs, every element written:
// gef [e, de] (16-byte aligned); dxab [2, n, h] = dxa, dxb; dw [de*h + h +
// h*d2 + d2 + 4] = dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2.  Returns the
// first failing cudaError_t (0 on success).
extern "C" int fused_mp_backward(
    const float* xa, const float* xb, const float* ef, const int* senders,
    const int* receivers, const int* recv_order, const int* recv_off,
    const int* send_order, const int* send_off, const float* w1e,
    const float* b1, const float* w2, const float* b2, const float* scal,
    const float* gout, float slope, float* scratch, float* gef, float* dxab,
    float* dw, int n, int e, int de, int h, int d2, void* stream) {
  if (!edge_widths_ok(n, e, de, h, d2) || !(aligned16(ef) || e == 0) ||
      !(aligned16(gef) || e == 0) || !aligned16(xa) || !aligned16(xb) ||
      !aligned16(w1e) || !aligned16(w2) || !aligned16(gout) ||
      !aligned16(scratch))
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = bwd_plan(e, de, h, d2, true, p);
  if (err != cudaSuccess) return err;
  long long sz[kFusedScratchParts];
  fused_bwd_scratch(e, de, h, d2, p.blocks, sz);
  float* rows = scratch;
  float* p_edge = rows + sz[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (1) The edge tiles over the receiver order: gef, rows = g_pre1, the
  // blocks' partials.
  err = bwd_edges<true>(p, xa, xb, ef, senders, receivers, recv_order,
                        recv_off, w1e, b1, w2, b2, scal, gout, slope, gef,
                        rows, p_edge, n, e, de, h, d2, s);
  if (err != cudaSuccess) return err;
  // (2) dxa over the receiver segments, dxb over the sender segments.
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 2), kWarps * 32, 0, s>>>(
      rows, receivers, recv_order, send_order, recv_off, send_off, n, h, dxab);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (3) The partials in block order (no node part: d = 0).
  constexpr int kOut = kReduceThreads / kReduceGroups;
  const int grid = static_cast<int>((edge_partial(de, h, d2) + kOut - 1) / kOut);
  bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      nullptr, 0, p_edge, p.blocks, nullptr, 0, n, 0, de, h, d2, dw, nullptr);
  return cudaGetLastError();
}
