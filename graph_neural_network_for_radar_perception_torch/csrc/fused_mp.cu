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
// Forward (two launches in one C call, csrc/mp_edge_tile.cuh, shared with
// the CSR round's forward).  (1) fwd_edge_kernel over the receiver order:
// one block per SM, each a balanced contiguous run of the kept edges'
// positions in tiles of 32 (16 or 8 where 32 rows overflow the shared
// memory: fwd_plan), not cut at segment boundaries; W1e, W2, b1, b2 in
// shared memory once per block, each tile's ef, xa[r], xb[s] rows by
// cp.async, both layers' products register-tiled on shared memory
// (tile_gemm), both norms row phases (the mean first, then the centred
// squares, as the reference); each message to its edge's row of a scratch
// msgs [E, D2].  (2) segsum_kernel: one warp a node adds its receiver
// segment's rows in edge order and writes its agg row once (zero for a
// node without edges), so the caller zeroes nothing.  A warp that walked
// whole receiver segments instead (one launch, no scratch, the same sums)
// carried a segment's groups in a row: 88 us against 36 + 7 us for an
// earlier warp-per-group message kernel and these sums, at the main path's
// shapes on an H100 (PERF.md).
//
// What bounds it.  At the shipped widths (De = D = D2 = 64, H = 128) an edge
// costs 2 * (De*H + H*D2) = 32 768 FLOP and reads ~264 bytes, about 120
// FLOP/byte: well above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte).  So its bound is FP32 FMA throughput on paper (no tensor
// cores: the reference is f32); in practice the shared-memory bandwidth of
// tile_gemm and, at the deploy shapes (~70 edges a block), the tiles'
// fixed cost (scripts/fwd_tile_ablation.py, PERF.md).
//
// bf16 operands (fused_mp_forward_bf16).  The TPU kernel's bf16 mode
// (_kernel with bf16=True) feeds every MXU dot bf16 operands and accumulates
// in f32.  Its counterpart on this card is the bf16 tensor core: the edge
// kernel is fwd_edge_kernel_bf16 (csrc/mp_edge_tile.cuh), both products on
// mma.sync.m16n8k16 with f32 accumulators, rounding (to nearest even,
// __float2bfloat16_rn) at exactly the TPU kernel's points: W1e and W2 once
// a block, each ef row, each gathered xa/xb element (the TPU rounds the
// products x.W1r and x.W1s, which the caller computes in f32), the layer-1
// activations (written as layer 2's bf16 A tile) and each message before it
// is added.  b1, b2, both norms and every sum stay f32.  A product of two
// bf16 values is exact in f32: the TPU function up to summation order.  Its
// tiles are 32 edges, two blocks an SM where they fit (fwd_plan).  Its
// bound on this card is the bytes: at the shipped widths the products of
// 9216 edges take 0.3 us at the bf16 peak, reading the inputs 1 us.
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
// A batch of graphs.  Every entry point takes `graphs`, B, and arrays
// [B, ...] (contiguous; graph g's slice at g times one graph's size): the
// JAX package vmaps the one-graph round, so its pallas_call runs once a
// round for the whole batch with a leading grid axis over the graphs.  Here
// each kernel gets a grid dimension over the graphs (csrc/mp_edge_tile.cuh);
// graph g's tiles and sums are exactly those of a call on graph g alone, so
// agg, msgs, gef and dxab equal B calls of one graph bit for bit, and dw
// sums every graph's block partials in graph order.
//
// What bounds it.  Three times the forward's FMAs: 2 * 3 * (De*H + H*D2) =
// 98 304 FLOP an edge at the shipped widths, against ~400 bytes of its own
// traffic, so FP32 FMAs on paper (~13.5 us for 9 216 live edges at 67
// TFLOP/s).  The edge kernel's products are bound by shared-memory
// bandwidth instead (a lane's 16-byte load costs the same whether or not
// its warp shares the address): csrc/csr_mp.cu and PERF.md.

#include "mp_edge_tile.cuh"

namespace {

// The forward's two launches over the receiver order (fwd_round): the
// edge tiles' messages, then the receivers' sums.
template <bool BF16>
int forward_entry(const float* xa, const float* xb, const float* ef,
                  const int* senders, const int* receivers, const int* order,
                  const int* off, const float* w1e, const float* b1,
                  const float* w2, const float* b2, const float* scal,
                  float slope, float* msgs, float* agg, int n, int e, int de,
                  int h, int d2, int graphs, void* stream) {
  if (!edge_widths_ok(n, e, de, h, d2) || graphs < 1 || graphs > 65535 ||
      !(aligned16(ef) || e == 0) ||
      !aligned16(xa) || !aligned16(xb) || !aligned16(w1e) || !aligned16(w2) ||
      !aligned16(msgs))
    return cudaErrorInvalidValue;
  FwdPlan p;
  const cudaError_t err = fwd_plan(e, de, h, d2, BF16, p);
  if (err != cudaSuccess) return err;
  return fwd_round<true, BF16, BF16>(p, xa, xb, ef, senders, receivers, order,
                                     off, w1e, b1, w2, b2, scal, slope, msgs,
                                     agg, n, e, de, h, d2, graphs,
                                     static_cast<long long>(n) * h,
                                     static_cast<cudaStream_t>(stream));
}

// fused_mp_backward's scratch, in floats, each part rounded up to 16 bytes:
// rows [graphs, e, h] (g_pre1 by edge) and p_edge [graphs, blocks,
// edge_partial].
constexpr int kFusedScratchParts = 2;
void fused_bwd_scratch(int e, int de, int h, int d2, int blocks, int graphs,
                       long long (&sz)[kFusedScratchParts]) {
  sz[0] = static_cast<long long>(graphs) * e * h;
  sz[1] = static_cast<long long>(graphs) * blocks * edge_partial(de, h, d2);
  for (long long& v : sz) v = (v + 3) & ~3LL;
}

}  // namespace

// Forward entry point, loaded with ctypes, over `graphs` = B graphs of n
// nodes and e edges each.  All pointers are device pointers to contiguous
// arrays: xa, xb [B, n, h]; ef [B, e, de]; senders, receivers [B, e] int32;
// recv_order [B, e] int32 and recv_off [B, n + 1] int32, the receiver order
// of each graph's layout (top of this file); w1e [de, h]; b1 [h]; w2 [h,
// d2]; b2 [d2]; scal [4] = (g1, be1, g2, be2); msgs [B, e, d2], a scratch
// never read before the call writes it; agg [B, n, d2], every row of which
// is written.  xa, xb, ef, w1e, w2 and msgs are 16-byte aligned.  Requires
// de, h, d2 multiples of 4, 1 <= B <= 65535 and a plan whose 8-edge tiles
// fit the shared memory.  Returns the first failing cudaError_t (0 on
// success).
extern "C" int fused_mp_forward(const float* xa, const float* xb,
                                const float* ef, const int* senders,
                                const int* receivers, const int* recv_order,
                                const int* recv_off, const float* w1e,
                                const float* b1, const float* w2,
                                const float* b2, const float* scal,
                                float slope, float* msgs, float* agg, int n,
                                int e, int de, int h, int d2, int graphs,
                                void* stream) {
  return forward_entry<false>(xa, xb, ef, senders, receivers, recv_order,
                              recv_off, w1e, b1, w2, b2, scal, slope, msgs,
                              agg, n, e, de, h, d2, graphs, stream);
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
                                     int de, int h, int d2, int graphs,
                                     void* stream) {
  return forward_entry<true>(xa, xb, ef, senders, receivers, recv_order,
                             recv_off, w1e, b1, w2, b2, scal, slope, msgs, agg,
                             n, e, de, h, d2, graphs, stream);
}

// How the forward's edge kernel runs at these widths on the current device:
// plan[3] gets its tile, input stages and blocks.  Returns 0, or the
// cudaError_t of widths the forward does not take.  Loaded with ctypes.
extern "C" int fused_mp_forward_plan(int n, int e, int de, int h, int d2,
                                     int* plan) {
  if (!edge_widths_ok(n, e, de, h, d2)) return cudaErrorInvalidValue;
  return fwd_plan_out(e, de, h, d2, false, plan);
}

// The same for fused_mp_forward_bf16's edge kernel.
extern "C" int fused_mp_forward_bf16_plan(int n, int e, int de, int h, int d2,
                                          int* plan) {
  if (!edge_widths_ok(n, e, de, h, d2)) return cudaErrorInvalidValue;
  return fwd_plan_out(e, de, h, d2, true, plan);
}

// The scratch of one fused_mp_backward call at these widths over `graphs`
// graphs on the current device, in floats, or minus a cudaError_t (1:
// widths the forward does not take).  plan[3] gets the edge kernel's tile,
// input stages and blocks (a graph's).  Loaded with ctypes.
extern "C" long long fused_mp_backward_scratch(int n, int e, int de, int h,
                                               int d2, int graphs, int* plan) {
  if (!edge_widths_ok(n, e, de, h, d2) || graphs < 1 || graphs > 65535)
    return -cudaErrorInvalidValue;
  BwdPlan p;
  const cudaError_t err = bwd_plan(e, de, h, d2, true, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  long long sz[kFusedScratchParts];
  fused_bwd_scratch(e, de, h, d2, p.blocks, graphs, sz);
  plan[0] = p.tile;
  plan[1] = p.stages;
  plan[2] = p.blocks;
  return sz[0] + sz[1];
}

// Backward entry point, loaded with ctypes.  Inputs as fused_mp_forward,
// plus send_order [B, e] and send_off [B, n + 1] int32 (the sender order of
// each layout) and gout [B, n, d2]; w1e, w2, gout, xa, xb and, for e > 0, ef
// are 16-byte aligned.  scratch: the floats fused_mp_backward_scratch gives
// for `graphs` graphs, never read before the call writes them.  Outputs,
// every element written: gef [B, e, de] (16-byte aligned); dxab [B, 2, n,
// h] = dxa, dxb of each graph; dw [de*h + h + h*d2 + d2 + 4] = dW1e | db1 |
// dW2 | db2 | dg1 dbe1 dg2 dbe2, summed over the graphs.  Returns the first
// failing cudaError_t (0 on success).
extern "C" int fused_mp_backward(
    const float* xa, const float* xb, const float* ef, const int* senders,
    const int* receivers, const int* recv_order, const int* recv_off,
    const int* send_order, const int* send_off, const float* w1e,
    const float* b1, const float* w2, const float* b2, const float* scal,
    const float* gout, float slope, float* scratch, float* gef, float* dxab,
    float* dw, int n, int e, int de, int h, int d2, int graphs, void* stream) {
  if (!edge_widths_ok(n, e, de, h, d2) || graphs < 1 || graphs > 65535 ||
      !(aligned16(ef) || e == 0) ||
      !(aligned16(gef) || e == 0) || !aligned16(xa) || !aligned16(xb) ||
      !aligned16(w1e) || !aligned16(w2) || !aligned16(gout) ||
      !aligned16(scratch))
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = bwd_plan(e, de, h, d2, true, p);
  if (err != cudaSuccess) return err;
  long long sz[kFusedScratchParts];
  fused_bwd_scratch(e, de, h, d2, p.blocks, graphs, sz);
  float* rows = scratch;
  float* p_edge = rows + sz[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (1) The edge tiles over the receiver order: gef, rows = g_pre1, the
  // blocks' partials.
  const long long nh = static_cast<long long>(n) * h;
  err = bwd_edges<true>(p, xa, xb, ef, senders, receivers, recv_order,
                        recv_off, w1e, b1, w2, b2, scal, gout, slope, gef,
                        rows, p_edge, n, e, de, h, d2, graphs, nh, s);
  if (err != cudaSuccess) return err;
  // (2) dxa over the receiver segments, dxb over the sender segments.
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 2, graphs), kWarps * 32, 0, s>>>(
      rows, receivers, recv_order, send_order, recv_off, send_off, n, e, h,
      static_cast<long long>(e) * h, 2 * nh, dxab);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (3) The partials in block order, graph by graph (no node part: d = 0).
  constexpr int kOut = kReduceThreads / kReduceGroups;
  const int grid = static_cast<int>((edge_partial(de, h, d2) + kOut - 1) / kOut);
  bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      nullptr, 0, p_edge, graphs * p.blocks, nullptr, 0, n, 0, de, h, d2, graphs,
      dw, nullptr);
  return cudaGetLastError();
}
