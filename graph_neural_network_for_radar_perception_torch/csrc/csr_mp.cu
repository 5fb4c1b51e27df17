// CSR (destination-sorted) message-passing round for Hopper (sm_90a):
// forward (csr_mp_forward) and backward (csr_mp_backward).
//
// Replaces the TPU kernels
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py::_fwd_kernel
//   graph_neural_network_for_radar_perception_tpu/ops/pallas/csr_mp.py::_bwd_kernel
// (launched by _forward_impl and _backward_impl).  For every edge p with
// destination dst[p] and source src[p]:
//
//   pre1 = x[dst] . W1r + x[src] . W1s + ef[p] . W1e + b1      [H]
//   m1   = lrelu(cnorm(pre1; g1, be1))
//   m2   = lrelu(cnorm(m1 . W2 + b2; g2, be2))                 [D2]
//   agg[dst] += m2
//
// cnorm is the reference channel norm (Bessel std, eps on the std, scalar
// gamma/beta).  The caller (ops/csr_mp.py) passes the *effective* indices
// of the TPU kernel's window semantics: dst = N where the destination falls
// outside its tile's window (message dropped), src = N where the source
// falls outside its tile's source window (zero x_src, message kept).  It
// also passes off[N+1], the segment of each destination: node v's edges lie
// in [off[v], off[v+1]); edges there whose dst is N are skipped.  dst must
// be non-decreasing over the edges it keeps.
//
// The one-hot window gathers and scatters of the TPU kernels are a TPU
// device; here a gather is a gather, and the scatter is a segmented
// reduction over the sorted destinations, with no atomics:
//
// Forward, three launches in one C call.  (1) x . W1r and x . W1s once
// per node (one batched gemm_kernel, gemm_bf16_kernel in bf16; the TPU body
// computes them per edge: the same function with less work); (2)
// fwd_edge_kernel (fwd_edge_kernel_bf16 in bf16)
// (csrc/mp_edge_tile.cuh, shared with the fused round's forward): one
// block per SM, each a balanced contiguous run of the edges before off[N]
// in tiles of T = 32 (16 or 8 where 32 rows overflow the shared memory:
// fwd_plan), not cut at segment boundaries; W1e and W2 in shared memory,
// both layers' products register-tiled on shared memory, the norms row
// phases; each message to its edge's row of a scratch msgs [E, D2]; (3)
// segsum_kernel: agg[v] = the sum of v's segment of msgs in edge order,
// edges whose dst is N skipped, every row written once (zero for a node
// without edges).  Two launches give the same bits.
//
// Backward, six launches in one C call.  (1) x . W1r, x . W1s again (one
// batched gemm_kernel); (2) bwd_edge_kernel (csrc/mp_edge_tile.cuh, shared
// with the fused round's backward): one block per SM, each a
// balanced contiguous run of the edges in tiles of T = 32 edges (16 or 8
// at widths whose shared memory 32 rows would overflow: bwd_plan), with
// W1e and W2 in shared memory; per tile it recomputes the forward and applies
// the chain rule of _bwd_kernel with the norm-backward guard of
// ops/fused_mp._cnorm_act_bwd, writes gef and g_pre1 (to a per-edge
// scratch), and accumulates dW1e = ef^T g_pre1, dW2 = a1^T g_pre2, db1, db2
// and the four scalar gradients into one partial per block; (3)
// segsum_kernel: dxa[v] = sum of g_pre1 over v's destination segment, dxb[u]
// = sum over u's source segment (edges in source order from a stable
// argsort made by the caller), both in edge order; (4) dxa . W1r^T and
// dxb . W1s^T, split over the hidden channels; (5) dW1r = x^T dxa, dW1s =
// x^T dxb, split over the nodes; (6) bwd_reduce_kernel sums every partial
// in a fixed order (as _backward_impl sums its per-tile partials in XLA)
// into dW1, db1, dW2, db2, the scalars and dx.  Every output is a
// fixed-order sum: two launches give the same bits.
//
// A batch of graphs.  Every entry point takes `graphs`, B, and arrays
// [B, ...] (contiguous; graph g's slice at g times one graph's size), the
// counterpart of the vmapped pallas_call's leading grid axis over the
// graphs: gemm_kernel batches (graph, matrix) pairs, and the edge kernels,
// segsum_kernel and the partials get a grid dimension over the graphs
// (csrc/mp_edge_tile.cuh).  Graph g's products, tiles and sums are those of
// a call on graph g alone, so agg, msgs, gef and dx equal B calls bit for
// bit; dw sums every graph's partials in graph order.
//
// What bounds them.  At the shipped widths (D = De = D2 = 64, H = 128) an
// edge's message costs 2 * (De*H + H*D2) = 32 768 FLOP against ~300 bytes,
// far above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B):
// f32 FMA throughput bounds both on paper (no tensor cores: the reference is
// f32; TF32 would change the function).  Both edge kernels keep the weights
// in shared memory once per block, read no weight from global memory in
// their k-loops, and give each thread a register tile of every product;
// there shared-memory bandwidth, not the FMAs, bounds them (a lane's
// 16-byte load costs the same whether or not its warp shares the address),
// so the tiles are as large as the T x N products and the registers allow
// (tile_gemm, tile_xty).  The backward's edge kernel does three times the
// forward's products; the weight gradients never leave the block as
// per-edge rows.  At the main path's shapes (~70 edges a block) a launch
// also pays its tiles' fixed cost: the ablations, scripts/fwd_tile_ablation.py
// and scripts/edge_tile_ablation.py, and PERF.md.  Simple first: no wgmma,
// no TMA, f32 FMAs on the CUDA cores (the bf16 forward: mma.sync, below).
//
// bf16 operands (csr_mp_forward_bf16).  The TPU kernel's bf16 mode
// (_fwd_kernel with bf16=True) rounds every MXU operand to bf16 and
// accumulates in f32, at other points than the fused kernel's: x is rounded
// *before* the node products (xw = x[...].astype(dt), then dot(xd,
// w1r.astype(dt))).  Both products run on the bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulators): the node products in
// gemm_bf16_kernel, which rounds x and W1r/W1s as it copies them into
// shared memory, and the edge products in fwd_edge_kernel_bf16<T, false,
// false> (csrc/mp_edge_tile.cuh), which takes the node products unrounded.
// After that, as in csrc/fused_mp.cu: ef and W1e, the layer-1 activations
// and W2, and each message before the segmented sum are rounded; b1, b2,
// the norms and every sum stay f32.  The forward stays deterministic.  The
// backward is the f32 one for either forward, as the JAX package's.

#include "mp_edge_tile.cuh"

namespace {

constexpr int kTile = 64;          // gemm_kernel output tile (kTile x kTile)
constexpr int kTileK = 16;         // gemm_kernel depth per stage
constexpr int kGemmThreads = 256;  // gemm_kernel threads per block (16 x 16)
constexpr int kSplitRows = 32;     // nodes per split-K partial of dW1r, dW1s
constexpr int kDxSplitK = 32;      // hidden channels per split-K partial of dx

// ---------------------------------------------------------------------------
// C[b][z] = A[b] . B[b] over the k range of split z, for batch b of
// `batches` = graphs x inner, b = g * inner + j: A(m, k) = A[g*sag + j*sab +
// m*sam + k*sak], B(k, n) = B[g*sbg + j*sbb + k*sbk + n*sbn], C row-major
// [M, N] per (batch, split), splits fastest.  Split z
// covers k in [z*k_split, (z+1)*k_split).  A block computes a 64 x 64 output
// tile, 4 x 4 per thread, summing k in order: fixed-order sums.  A matrix
// whose k stride is 1 is read with neighbouring threads on neighbouring k
// (coalesced); the others with neighbouring threads on neighbouring m or n.
// Use only names the instantiation (GemmUse), so that a profile tells the
// products apart.
enum GemmUse { kNodePartials, kNodeCotangent, kNodeWeightGrad };

template <int Use>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, long long sag, long long sab,
            long long sam, long long sak, const float* __restrict__ B,
            long long sbg, long long sbb, long long sbk, long long sbn,
            float* __restrict__ C, int M, int N, int K, int k_split, int splits,
            int inner) {
  constexpr int kLoads = kTileK * kTile / kGemmThreads;  // per thread per matrix
  // Rows padded by 4 floats: 16-byte aligned, and a column store by
  // neighbouring threads spreads over the banks.
  __shared__ __align__(16) float As[kTileK][kTile + 4];
  __shared__ __align__(16) float Bs[kTileK][kTile + 4];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int z = blockIdx.z % splits, batch = blockIdx.z / splits;
  const int g = batch / inner, j = batch % inner;
  const int k0 = z * k_split;
  const int k1 = min(K, k0 + k_split);
  A += g * sag + j * sab;
  B += g * sbg + j * sbb;
  C += static_cast<size_t>(blockIdx.z) * M * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // Element r of this thread's share of a tile: (k, row) for A, (k, col)
  // for B, with q fastest, or with k fastest for a k-contiguous matrix.
  int a_k[kLoads], a_q[kLoads], b_k[kLoads], b_q[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int i = tid + r * kGemmThreads;
    const int kq = i / kTile, q = i - kq * kTile;
    const int kt = i % kTileK, qt = i / kTileK;
    a_k[r] = sak == 1 ? kt : kq;
    a_q[r] = sak == 1 ? qt : q;
    b_k[r] = sbk == 1 ? kt : kq;
    b_q[r] = sbk == 1 ? qt : q;
  }
  float av[kLoads], bv[kLoads];
  // All loads of a tile are issued before any is used: one latency a tile.
  auto load = [&](int kb) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int ka = kb + a_k[r], m = m0 + a_q[r];
      av[r] = (ka < k1 && m < M) ? A[m * sam + ka * sak] : 0.f;
      const int kb2 = kb + b_k[r], nn = n0 + b_q[r];
      bv[r] = (kb2 < k1 && nn < N) ? B[kb2 * sbk + nn * sbn] : 0.f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (k0 < k1) load(k0);
  for (int kb = k0; kb < k1; kb += kTileK) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      As[a_k[r]][a_q[r]] = av[r];
      Bs[b_k[r]][b_q[r]] = bv[r];
    }
    __syncthreads();
    if (kb + kTileK < k1) load(kb + kTileK);  // in flight during the sums
#pragma unroll
    for (int kq = 0; kq < kTileK; ++kq) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kq][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kq][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, nn = n0 + tx * 4 + j;
      if (m < M && nn < N) C[static_cast<size_t>(m) * N + nn] = acc[i][j];
    }
}

// graphs x inner products, each split over k into ceil(K / k_split)
// partials.
template <int Use>
cudaError_t gemm(const float* A, long long sag, long long sab, long long sam,
                 long long sak, const float* B, long long sbg, long long sbb,
                 long long sbk, long long sbn, float* C, int M, int N, int K,
                 int k_split, int inner, int graphs, cudaStream_t stream) {
  const int splits = K > 0 ? (K + k_split - 1) / k_split : 1;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits * inner * graphs);
  gemm_kernel<Use><<<grid, kGemmThreads, 0, stream>>>(
      A, sag, sab, sam, sak, B, sbg, sbb, sbk, sbn, C, M, N, K, k_split, splits,
      inner);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 forward's node products: xab[g][j] = bf16(x[g]) . bf16(W1[j]) for
// graph g = blockIdx.z / 2 and j = blockIdx.z % 2 (W1r, W1s: rows [j d,
// (j+1) d) of w1), x [graphs, n, d], xab [graphs, 2, n, h], on the bf16
// tensor cores (mma.sync.m16n8k16, f32 accumulators).  A block computes a
// 64 x 64 output tile, each of its 4 warps 16 rows by 8 n-tiles; the k
// range in chunks of kBf16GemmK (one at D = 64), each rounded (nearest even)
// into shared memory as it is copied, a chunk's loads all in flight before
// any is stored, zero past n, d and h (exact: the function does not
// change); k in order: fixed-order sums.  What bounds it: the bytes (at
// N = 768, D = 64, H = 128 its 25 MFLOP a graph take 25 ns at the bf16
// peak, its 1.0 MB 0.3 us) and, at these sizes, one load latency a chunk.
constexpr int kBf16GemmTile = 64;     // gemm_bf16_kernel's output tile (64 x 64)
constexpr int kBf16GemmK = 64;        // its k chunk
constexpr int kBf16GemmThreads = 128;

__global__ void __launch_bounds__(kBf16GemmThreads)
gemm_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 float* __restrict__ xab, int n, int d, int h) {
  // Rows of 40 and 72 bf16: 8 mod 16, so ldmatrix's rows fall on distinct banks.
  __shared__ __align__(16) bf16 As[kBf16GemmTile][kBf16GemmK + 8];  // [m][k]
  __shared__ __align__(16) bf16 Bs[kBf16GemmK][kBf16GemmTile + 8];  // [k][n]
  const int m0 = blockIdx.y * kBf16GemmTile, n0 = blockIdx.x * kBf16GemmTile;
  const size_t g = blockIdx.z / 2, j = blockIdx.z % 2;
  x += g * n * d;
  w1 += j * d * h;
  xab += static_cast<size_t>(blockIdx.z) * n * h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float acc[kBf16GemmTile / 8][4] = {};
  constexpr int kA = kBf16GemmTile * kBf16GemmK / kBf16GemmThreads;  // x elements a thread a chunk
  for (int k0 = 0; k0 < d; k0 += kBf16GemmK) {
    float a_v[kA];  // x is read element by element: d may be any width
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      const int i = tid + j * kBf16GemmThreads, r = i / kBf16GemmK, kk = k0 + i % kBf16GemmK;
      a_v[j] = m0 + r < n && kk < d ? x[static_cast<size_t>(m0 + r) * d + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      const int i = tid + j * kBf16GemmThreads;
      As[i / kBf16GemmK][i % kBf16GemmK] = __float2bfloat16_rn(a_v[j]);
    }
    // W1r or W1s rows [k0, k0 + kBf16GemmK), columns [n0, n0 + kBf16GemmTile).
    round_into<kBf16GemmThreads>(&Bs[0][0], kBf16GemmTile + 8, kBf16GemmK, kBf16GemmTile,
                             w1 + static_cast<size_t>(k0) * h + n0, h,
                             min(kBf16GemmK, d - k0), min(kBf16GemmTile, h - n0));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBf16GemmK; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, &As[warp * 16 + (lane & 15)][kk + 8 * (lane >> 4)]);
#pragma unroll
      for (int t = 0; t < kBf16GemmTile / 8; t += 2) {
        unsigned b[4];
        ldsm_x4_t(b, &Bs[kk + (lane & 15)][8 * t + 8 * (lane >> 4)]);
        mma_bf16(acc[t], a, b[0], b[1]);
        mma_bf16(acc[t + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  const int m = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < kBf16GemmTile / 8; ++t) {
    const int c = n0 + 8 * t + 2 * (lane & 3);  // c + 1 < h where c < h
    if (c >= h) continue;
    if (m < n)
      *reinterpret_cast<float2*>(xab + static_cast<size_t>(m) * h + c) =
          make_float2(acc[t][0], acc[t][1]);
    if (m + 8 < n)
      *reinterpret_cast<float2*>(xab + static_cast<size_t>(m + 8) * h + c) =
          make_float2(acc[t][2], acc[t][3]);
  }
}

// csr_mp_backward's scratch over `graphs` = B graphs, in floats, each part
// rounded up to 16 bytes: xab [B, 2, n, h]; rows [B, e, h]; dxab [B, 2, n,
// h]; p_dx [B, 2, ceil(h / kDxSplitK), n, d]; p_w1rs [B, 2, ceil(n /
// kSplitRows), d, h]; p_edge [B, blocks, de*h + h + h*d2 + d2 + 4].
constexpr int kScratchParts = 6;
void bwd_scratch(int n, int e, int d, int de, int h, int d2, int blocks,
                 int graphs, long long (&sz)[kScratchParts]) {
  const long long nh = static_cast<long long>(n) * h;
  sz[0] = 2 * nh;
  sz[1] = static_cast<long long>(e) * h;
  sz[2] = 2 * nh;
  sz[3] = 2LL * ((h + kDxSplitK - 1) / kDxSplitK) * n * d;
  sz[4] = 2LL * ((n + kSplitRows - 1) / kSplitRows) * d * h;
  sz[5] = static_cast<long long>(blocks) * edge_partial(de, h, d2);
  for (long long& v : sz) v = (graphs * v + 3) & ~3LL;
}

bool widths_ok(int n, int e, int d, int de, int h, int d2) {
  return d > 0 && edge_widths_ok(n, e, de, h, d2);
}

bool graphs_ok(int graphs) { return graphs >= 1 && graphs <= 65535; }

}  // namespace

namespace {

// The forward's three launches: x . W1r, x . W1s (one batched gemm_kernel;
// with BF16 gemm_bf16_kernel, of bf16(x) and bf16(W1r), bf16(W1s)), the edge
// tiles' messages and the destination segments' sums (fwd_round).
template <bool BF16>
int forward_entry(const float* x, const float* ef, const int* src,
                  const int* dst, const int* off, const float* w1,
                  const float* b1, const float* w2, const float* b2,
                  const float* scal, float* xab, float slope, float* msgs,
                  float* agg, int n, int e, int d, int de, int h, int d2,
                  int graphs, void* stream) {
  if (!widths_ok(n, e, d, de, h, d2) || !graphs_ok(graphs) || !(aligned16(ef) || e == 0) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(xab) || !aligned16(msgs))
    return cudaErrorInvalidValue;
  FwdPlan p;
  cudaError_t err = fwd_plan(e, de, h, d2, BF16, p);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dh = static_cast<long long>(d) * h;
  const long long nh = static_cast<long long>(n) * h;
  // xab [B, 2, n, h]: graph g's x . W1r, x . W1s.
  if constexpr (BF16) {
    const dim3 grid((h + kBf16GemmTile - 1) / kBf16GemmTile,
                    (n + kBf16GemmTile - 1) / kBf16GemmTile, 2 * graphs);
    gemm_bf16_kernel<<<grid, kBf16GemmThreads, 0, s>>>(x, w1, xab, n, d, h);
    err = cudaGetLastError();
  } else {
    err = gemm<kNodePartials>(x, static_cast<long long>(n) * d, 0, d, 1, w1, 0,
                              dh, h, 1, xab, n, h, d, d, 2, graphs, s);
  }
  if (err != cudaSuccess) return err;
  return fwd_round<false, false, BF16>(p, xab, xab + nh, ef, src, dst, nullptr, off,
                                       w1 + 2 * dh, b1, w2, b2, scal, slope, msgs,
                                       agg, n, e, de, h, d2, graphs, 2 * nh, s);
}

}  // namespace

// Forward entry point, loaded with ctypes, over `graphs` = B graphs of n
// nodes and e edges each.  All pointers are device pointers to contiguous
// arrays: x [B, n, d]; ef [B, e, de]; src, dst [B, e] int32 (effective
// indices, see the top of this file); off [B, n + 1] int32; w1 [2d + de, h]
// (rows W1r, W1s, W1e); b1 [h]; w2 [h, d2]; b2 [d2]; scal [4] = (g1, be1,
// g2, be2); xab [B, 2, n, h] and msgs [B, e, d2] scratch, never read before
// the call writes them; agg [B, n, d2], every row of which is written.  ef,
// w1, w2, xab and msgs are 16-byte aligned.  Requires de, h, d2 multiples
// of 4, 1 <= B <= 65535 and a plan whose 8-edge tiles fit the shared
// memory.  Returns the first failing cudaError_t (0 on success).
extern "C" int csr_mp_forward(const float* x, const float* ef, const int* src,
                              const int* dst, const int* off, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, const float* scal, float* xab,
                              float slope, float* msgs, float* agg, int n,
                              int e, int d, int de, int h, int d2, int graphs,
                              void* stream) {
  return forward_entry<false>(x, ef, src, dst, off, w1, b1, w2, b2, scal, xab,
                              slope, msgs, agg, n, e, d, de, h, d2, graphs, stream);
}

// The same with the TPU kernel's bf16 operands (top of this file).
extern "C" int csr_mp_forward_bf16(const float* x, const float* ef,
                                   const int* src, const int* dst,
                                   const int* off, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* scal,
                                   float* xab, float slope, float* msgs,
                                   float* agg, int n, int e, int d, int de,
                                   int h, int d2, int graphs, void* stream) {
  return forward_entry<true>(x, ef, src, dst, off, w1, b1, w2, b2, scal, xab,
                             slope, msgs, agg, n, e, d, de, h, d2, graphs, stream);
}

// How the forward's edge kernel runs at these widths on the current device:
// plan[3] gets its tile, input stages and blocks.  Returns 0, or the
// cudaError_t of widths csr_mp_forward does not take.  Loaded with ctypes.
extern "C" int csr_mp_forward_plan(int n, int e, int d, int de, int h, int d2,
                                   int* plan) {
  if (!widths_ok(n, e, d, de, h, d2)) return cudaErrorInvalidValue;
  return fwd_plan_out(e, de, h, d2, false, plan);
}

// The same for csr_mp_forward_bf16's edge kernel.
extern "C" int csr_mp_forward_bf16_plan(int n, int e, int d, int de, int h,
                                        int d2, int* plan) {
  if (!widths_ok(n, e, d, de, h, d2)) return cudaErrorInvalidValue;
  return fwd_plan_out(e, de, h, d2, true, plan);
}

// The scratch of one csr_mp_backward call at these widths over `graphs`
// graphs on the current device, in floats, or minus a cudaError_t (1:
// widths csr_mp_forward does not take).  plan[3] gets the edge kernel's
// tile, input stages and blocks (a graph's).  Loaded with ctypes.
extern "C" long long csr_mp_backward_scratch(int n, int e, int d, int de,
                                             int h, int d2, int graphs,
                                             int* plan) {
  BwdPlan p;
  if (!widths_ok(n, e, d, de, h, d2) || !graphs_ok(graphs))
    return -cudaErrorInvalidValue;
  const cudaError_t err = bwd_plan(e, de, h, d2, false, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  long long sz[kScratchParts], total = 0;
  bwd_scratch(n, e, d, de, h, d2, p.blocks, graphs, sz);
  for (long long v : sz) total += v;
  plan[0] = p.tile;
  plan[1] = p.stages;
  plan[2] = p.blocks;
  return total;
}

// Backward entry point, loaded with ctypes.  Inputs as csr_mp_forward, plus
// perm [B, e] int32, each graph's edges in source order, and off_src [B, n +
// 1] int32, each source's segment of perm; gout [B, n, d2].  scratch: the
// floats csr_mp_backward_scratch gives for `graphs` graphs, never read
// before the call writes them.  Outputs, every element written: gef [B, e,
// de]; dx [B, n, d]; dw [(2d + de)*h + h + h*d2 + d2 + 4] = dW1 (rows W1r,
// W1s, W1e) | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2, summed over the graphs.
// ef, w1, w2, gout and scratch are 16-byte aligned.  Requires the widths
// csr_mp_forward takes.  Returns the first failing cudaError_t (0 on
// success).
extern "C" int csr_mp_backward(
    const float* x, const float* ef, const int* src, const int* dst,
    const int* off, const int* perm, const int* off_src, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* scal,
    const float* gout, float slope, float* scratch, float* gef, float* dx,
    float* dw, int n, int e, int d, int de, int h, int d2, int graphs,
    void* stream) {
  if (!widths_ok(n, e, d, de, h, d2) || !graphs_ok(graphs) || !(aligned16(ef) || e == 0) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(gout) || !aligned16(scratch) ||
      !(aligned16(gef) || e == 0))
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = bwd_plan(e, de, h, d2, false, p);
  if (err != cudaSuccess) return err;
  long long sz[kScratchParts];
  bwd_scratch(n, e, d, de, h, d2, p.blocks, graphs, sz);
  float* xab = scratch;
  float* rows = xab + sz[0];
  float* dxab = rows + sz[1];
  float* p_dx = dxab + sz[2];
  float* p_w1rs = p_dx + sz[3];
  float* p_edge = p_w1rs + sz[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dh = static_cast<long long>(d) * h;
  const long long nh = static_cast<long long>(n) * h;
  const long long nd = static_cast<long long>(n) * d;
  // (1) x . W1r, x . W1s of each graph: xab [B, 2, n, h].
  err = gemm<kNodePartials>(x, nd, 0, d, 1, w1, 0, dh, h, 1, xab, n, h, d, d, 2,
                            graphs, s);
  if (err != cudaSuccess) return err;
  // (2) The edge tiles: gef, rows = g_pre1, the blocks' partials.
  err = bwd_edges<false>(p, xab, xab + nh, ef, src, dst, nullptr, off,
                         w1 + 2 * dh, b1, w2, b2, scal, gout, slope, gef, rows,
                         p_edge, n, e, de, h, d2, graphs, 2 * nh, s);
  if (err != cudaSuccess) return err;
  // (3) dxa, dxb: segmented sums of g_pre1 in edge order, dxab [B, 2, n, h].
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 2, graphs), kWarps * 32, 0, s>>>(
      rows, dst, nullptr, perm, off, off_src, n, e, h,
      static_cast<long long>(e) * h, 2 * nh, dxab);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (4) dxa W1r^T, dxb W1s^T, split over the hidden channels.
  err = gemm<kNodeCotangent>(dxab, 2 * nh, nh, h, 1, w1, 0, dh, 1, h, p_dx, n, d, h,
                             kDxSplitK, 2, graphs, s);
  if (err != cudaSuccess) return err;
  // (5) x^T dxa, x^T dxb, split over the nodes.
  err = gemm<kNodeWeightGrad>(x, nd, 0, 1, d, dxab, 2 * nh, nh, h, 1, p_w1rs, d, h, n,
                              kSplitRows, 2, graphs, s);
  if (err != cudaSuccess) return err;
  // (6) The fixed-order sums of every partial.
  const int splits = (n + kSplitRows - 1) / kSplitRows;
  const int dx_splits = (h + kDxSplitK - 1) / kDxSplitK;
  const long long edge_out = edge_partial(de, h, d2);
  const long long rest = 2 * dh + graphs * nd;
  constexpr int kOut = kReduceThreads / kReduceGroups;
  const int grid = static_cast<int>((edge_out + kOut - 1) / kOut +
                                    (rest + kReduceThreads - 1) / kReduceThreads);
  bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      p_w1rs, splits, p_edge, graphs * p.blocks, p_dx, dx_splits, n, d, de, h, d2,
      graphs, dw, dx);
  return cudaGetLastError();
}
