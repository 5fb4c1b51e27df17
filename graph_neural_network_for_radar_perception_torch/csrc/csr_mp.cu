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
// Forward.  (1) x . W1r and x . W1s once per node (gemm_kernel, the TPU
// body computes them per edge: the same function with less work);
// (2) csr_fwd_kernel: a warp owns a run of whole destination segments,
// balanced by edge count (each warp finds its first node by binary search
// in off).  It computes its edges' messages eight at a time with the fused
// kernel's register blocking (csrc/fused_mp.cu) and warp-shuffle norms, adds
// them in edge order in registers, and writes every agg row exactly once
// (zero for a node without edges).  Two launches give the same bits.
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
// What bounds them.  At the shipped widths (D = De = D2 = 64, H = 128) an
// edge's message costs 2 * (De*H + H*D2) = 32 768 FLOP against ~300 bytes,
// far above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B):
// f32 FMA throughput bounds both on paper (no tensor cores: the reference is
// f32; TF32 would change the function).  The forward's warps fill less than
// one wave at the main path's shapes (N = 768, E = 15 360), so a launch
// lasts the chain of the busiest warp: a few edge groups in a row
// (PERF.md); it streams W1e and W2 through L1 at every step.  The backward's
// edge kernel does three times the forward's products: it keeps the
// weights in shared memory once per block, reads no weight from global
// memory in its k-loops, and gives each thread a register tile of every
// product; there shared-memory bandwidth, not the FMAs, bounds it (a
// lane's 16-byte load costs the same whether or not its warp shares the
// address), so the tiles are as large as the T x N products and the
// registers allow (tile_gemm, tile_xty).  The weight gradients never leave
// the block as per-edge rows.  Simple first: no wgmma, no TMA, f32 FMAs on
// the CUDA cores.
//
// bf16 operands (csr_mp_forward_bf16).  The TPU kernel's bf16 mode
// (_fwd_kernel with bf16=True) rounds every MXU operand to bf16 and
// accumulates in f32, at other points than the fused kernel's: x is rounded
// *before* the node products (xw = x[...].astype(dt), then dot(xd,
// w1r.astype(dt))), so the node GEMM's BF16 instantiation rounds both x and
// W1r/W1s on load, and the edge kernel takes its products unrounded.  After
// that, as in csrc/fused_mp.cu: ef and W1e, the layer-1 activations and W2,
// and each message before the segmented sum are rounded; b1, b2, the norms
// and every sum stay f32.  The forward stays deterministic.  The backward is
// the f32 one for either forward, as the JAX package's.

#include "mp_edge_tile.cuh"

namespace {

constexpr int kTile = 64;          // gemm_kernel output tile (kTile x kTile)
constexpr int kTileK = 16;         // gemm_kernel depth per stage
constexpr int kGemmThreads = 256;  // gemm_kernel threads per block (16 x 16)
constexpr int kSplitRows = 32;     // nodes per split-K partial of dW1r, dW1s
constexpr int kDxSplitK = 32;      // hidden channels per split-K partial of dx

// ---------------------------------------------------------------------------
// C[b][z] = A[b] . B[b] over the k range of split z, for batch b of
// `batches`: A(m, k) = A[b*sab + m*sam + k*sak], B(k, n) = B[b*sbb + k*sbk +
// n*sbn], C row-major [M, N] per (batch, split), splits fastest.  Split z
// covers k in [z*k_split, (z+1)*k_split).  A block computes a 64 x 64 output
// tile, 4 x 4 per thread, summing k in order: fixed-order sums.  A matrix
// whose k stride is 1 is read with neighbouring threads on neighbouring k
// (coalesced); the others with neighbouring threads on neighbouring m or n.
// Use only names the instantiation (GemmUse), so that a profile tells the
// products apart.  BF16 rounds every element of A and B to bf16 on load (the
// products of two bf16 values are exact in f32, the sums stay f32).
enum GemmUse { kNodePartials, kNodeCotangent, kNodeWeightGrad };

template <int Use, bool BF16 = false>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, long long sab, long long sam,
            long long sak, const float* __restrict__ B, long long sbb,
            long long sbk, long long sbn, float* __restrict__ C, int M, int N,
            int K, int k_split, int splits) {
  constexpr int kLoads = kTileK * kTile / kGemmThreads;  // per thread per matrix
  // Rows padded by 4 floats: 16-byte aligned, and a column store by
  // neighbouring threads spreads over the banks.
  __shared__ __align__(16) float As[kTileK][kTile + 4];
  __shared__ __align__(16) float Bs[kTileK][kTile + 4];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int z = blockIdx.z % splits, batch = blockIdx.z / splits;
  const int k0 = z * k_split;
  const int k1 = min(K, k0 + k_split);
  A += batch * sab;
  B += batch * sbb;
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
      av[r] = (ka < k1 && m < M) ? operand<BF16>(A[m * sam + ka * sak]) : 0.f;
      const int kb2 = kb + b_k[r], nn = n0 + b_q[r];
      bv[r] = (kb2 < k1 && nn < N) ? operand<BF16>(B[kb2 * sbk + nn * sbn]) : 0.f;
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

// `batches` products, each split over k into ceil(K / k_split) partials.
template <int Use, bool BF16 = false>
cudaError_t gemm(const float* A, long long sab, long long sam, long long sak,
                 const float* B, long long sbb, long long sbk, long long sbn,
                 float* C, int M, int N, int K, int k_split, int batches,
                 cudaStream_t stream) {
  const int splits = K > 0 ? (K + k_split - 1) / k_split : 1;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits * batches);
  gemm_kernel<Use, BF16><<<grid, kGemmThreads, 0, stream>>>(
      A, sab, sam, sak, B, sbb, sbk, sbn, C, M, N, K, k_split, splits);
  return cudaGetLastError();
}

// x . W1r -> xab[0], x . W1s -> xab[1] (w1 rows: [W1r; W1s; W1e]); with
// BF16, bf16(x) . bf16(W1r) and bf16(x) . bf16(W1s).
template <bool BF16 = false>
cudaError_t node_partials(const float* x, const float* w1, float* xab, int n,
                          int d, int h, cudaStream_t stream) {
  cudaError_t err = gemm<kNodePartials, BF16>(x, 0, d, 1, w1, 0, h, 1, xab, n,
                                              h, d, d, 1, stream);
  if (err != cudaSuccess) return err;
  return gemm<kNodePartials, BF16>(x, 0, d, 1, w1 + static_cast<size_t>(d) * h,
                                   0, h, 1, xab + static_cast<size_t>(n) * h, n,
                                   h, d, d, 1, stream);
}

// ---------------------------------------------------------------------------
// Forward: segmented message pass.  Warp gw of num_warps owns the nodes
// [va, vb) whose segments start in its share of the off[N] kept positions.
// BF16 rounds W1e, W2, the staged ef rows, the staged layer-1 activations
// and each message (xa, xb are products of rounded operands already).
template <int HPL, int DPL, bool BF16>
__global__ void __launch_bounds__(kWarps * 32)
csr_fwd_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
               const float* __restrict__ ef, const int* __restrict__ src,
               const int* __restrict__ dst, const int* __restrict__ off,
               const float* __restrict__ w1e, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ scal, float slope,
               float* __restrict__ agg, int n, int de, int h, int d2,
               int num_warps) {
  constexpr int EPW = kEdgesPerWarp;
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
  const int gw = blockIdx.x * kWarps + warp;
  if (gw >= num_warps) return;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  float* stage = s_stage + warp * EPW * stage_w;

  const int chunk = (off[n] + num_warps - 1) / num_warps;
  const int va = lower_bound(off, n, gw * chunk);
  const int vb = gw + 1 == num_warps ? n : lower_bound(off, n, (gw + 1) * chunk);
  const int p_hi = off[vb];

  float acc[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) acc[t] = 0.f;
  int cur = va;  // the node whose sum acc holds

  for (int e0 = off[va]; e0 < p_hi; e0 += EPW) {
    int dj[EPW], sj[EPW];
    bool keep[EPW], any = false;
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool live = e0 + j < p_hi;
      dj[j] = live ? dst[e0 + j] : -1;
      sj[j] = live ? src[e0 + j] : -1;
      keep[j] = live && dj[j] >= va && dj[j] < vb;
      any |= keep[j];
    }
    if (!any) continue;  // warp-uniform: no message of the group lands

    __syncwarp();  // the previous group's reads of the stage are done
    for (int i = lane * 4; i < EPW * de; i += 128) {
      const int j = i / de, k = i - j * de;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + j < p_hi)
        v = *reinterpret_cast<const float4*>(ef + static_cast<size_t>(e0) * de + i);
      *reinterpret_cast<float4*>(stage + j * stage_w + k) = operand<BF16>(v);
    }
    __syncwarp();

    // ---- layer 1: pre1 = xa[dst] + xb[src] + ef . W1e + b1 ---------------
    float a1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool sok = in_range(sj[j], n);
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        float v = 0.f;
        if (c < h) {
          v = s_b1[c];
          if (keep[j]) v += xa[static_cast<size_t>(dj[j]) * h + c];
          if (sok) v += xb[static_cast<size_t>(sj[j]) * h + c];
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

    // ---- segmented sum in edge order; a finished node's row is written ----
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (!keep[j] || dj[j] < cur) continue;  // dst out of order: not kept
      for (; cur < dj[j]; ++cur) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int c = lane + 32 * t;
          if (c < d2) agg[static_cast<size_t>(cur) * d2 + c] = acc[t];
          acc[t] = 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[t] += operand<BF16>(a2[j][t]);
    }
  }
  for (; cur < vb; ++cur) {
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int c = lane + 32 * t;
      if (c < d2) agg[static_cast<size_t>(cur) * d2 + c] = acc[t];
      acc[t] = 0.f;
    }
  }
}

template <int HPL, int DPL, bool BF16>
cudaError_t launch_fwd(const float* xab, const float* ef, const int* src,
                       const int* dst, const int* off, const float* w1e,
                       const float* b1, const float* w2, const float* b2,
                       const float* scal, float slope, float* agg, int n,
                       int e, int de, int h, int d2, cudaStream_t stream) {
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
  err = cudaFuncSetAttribute(csr_fwd_kernel<HPL, DPL, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // One warp per edge group of the edge capacity: known on the host, so
  // the launch needs no device->host read of the live count.
  int num_warps = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  if (num_warps < 1) num_warps = 1;
  const int grid = (num_warps + kWarps - 1) / kWarps;
  csr_fwd_kernel<HPL, DPL, BF16><<<grid, kWarps * 32, smem, stream>>>(
      xab, xab + static_cast<size_t>(n) * h, ef, src, dst, off, w1e, b1, w2,
      b2, scal, slope, agg, n, de, h, d2, num_warps);
  return cudaGetLastError();
}

// csr_mp_backward's scratch, in floats, each part rounded up to 16 bytes:
// xab [2, n, h]; rows [e, h]; dxab [2, n, h]; p_dx [2, ceil(h /
// kDxSplitK), n, d]; p_w1rs [2, ceil(n / kSplitRows), d, h]; p_edge
// [blocks, de*h + h + h*d2 + d2 + 4].
constexpr int kScratchParts = 6;
void bwd_scratch(int n, int e, int d, int de, int h, int d2, int blocks,
                 long long (&sz)[kScratchParts]) {
  const long long nh = static_cast<long long>(n) * h;
  sz[0] = 2 * nh;
  sz[1] = static_cast<long long>(e) * h;
  sz[2] = 2 * nh;
  sz[3] = 2LL * ((h + kDxSplitK - 1) / kDxSplitK) * n * d;
  sz[4] = 2LL * ((n + kSplitRows - 1) / kSplitRows) * d * h;
  sz[5] = static_cast<long long>(blocks) * edge_partial(de, h, d2);
  for (long long& v : sz) v = (v + 3) & ~3LL;
}

bool widths_ok(int n, int e, int d, int de, int h, int d2) {
  return d > 0 && edge_widths_ok(n, e, de, h, d2);
}

}  // namespace

// The (ceil(h / 32), ceil(d2 / 32)) pairs the kernels are instantiated for.
#define CSR_WIDTHS(X) \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) \
  X(4, 1) X(4, 2) X(4, 4) X(8, 1) X(8, 2) X(8, 4)

namespace {

template <bool BF16>
int forward_entry(const float* x, const float* ef, const int* src,
                  const int* dst, const int* off, const float* w1,
                  const float* b1, const float* w2, const float* b2,
                  const float* scal, float* xab, float slope, float* agg,
                  int n, int e, int d, int de, int h, int d2, void* stream) {
  if (!widths_ok(n, e, d, de, h, d2)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = node_partials<BF16>(x, w1, xab, n, d, h, s);
  if (err != cudaSuccess) return err;
  const float* w1e = w1 + 2 * static_cast<size_t>(d) * h;
  const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
#define CSR_FWD(H, D)                                                        \
  if (hpl == H && dpl == D)                                                  \
    return launch_fwd<H, D, BF16>(xab, ef, src, dst, off, w1e, b1, w2, b2,   \
                                  scal, slope, agg, n, e, de, h, d2, s);
  CSR_WIDTHS(CSR_FWD)
#undef CSR_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward entry point, loaded with ctypes.  All pointers are device
// pointers to contiguous arrays: x [n, d]; ef [e, de]; src, dst [e] int32
// (effective indices, see the top of this file); off [n + 1] int32;
// w1 [2d + de, h] (rows W1r, W1s, W1e); b1 [h]; w2 [h, d2]; b2 [d2];
// scal [4] = (g1, be1, g2, be2); xab [2, n, h] scratch; agg [n, d2], every
// row of which is written.  Requires de, h, d2 multiples of 4, h <= 256 and
// d2 <= 128 (rounded up to a multiple of 32: 32, 64 or 128).  Returns the
// first failing cudaError_t (0 on success).
extern "C" int csr_mp_forward(const float* x, const float* ef, const int* src,
                              const int* dst, const int* off, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, const float* scal, float* xab,
                              float slope, float* agg, int n, int e, int d,
                              int de, int h, int d2, void* stream) {
  return forward_entry<false>(x, ef, src, dst, off, w1, b1, w2, b2, scal, xab,
                              slope, agg, n, e, d, de, h, d2, stream);
}

// The same with the TPU kernel's bf16 operands (top of this file).
extern "C" int csr_mp_forward_bf16(const float* x, const float* ef,
                                   const int* src, const int* dst,
                                   const int* off, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* scal,
                                   float* xab, float slope, float* agg, int n,
                                   int e, int d, int de, int h, int d2,
                                   void* stream) {
  return forward_entry<true>(x, ef, src, dst, off, w1, b1, w2, b2, scal, xab,
                             slope, agg, n, e, d, de, h, d2, stream);
}

// The scratch of one csr_mp_backward call at these widths on the current
// device, in floats, or minus a cudaError_t (1: widths csr_mp_forward does
// not take).  plan[3] gets the edge kernel's tile, input stages and blocks.
// Loaded with ctypes.
extern "C" long long csr_mp_backward_scratch(int n, int e, int d, int de,
                                             int h, int d2, int* plan) {
  BwdPlan p;
  if (!widths_ok(n, e, d, de, h, d2)) return -cudaErrorInvalidValue;
  const cudaError_t err = bwd_plan(e, de, h, d2, false, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  long long sz[kScratchParts], total = 0;
  bwd_scratch(n, e, d, de, h, d2, p.blocks, sz);
  for (long long v : sz) total += v;
  plan[0] = p.tile;
  plan[1] = p.stages;
  plan[2] = p.blocks;
  return total;
}

// Backward entry point, loaded with ctypes.  Inputs as csr_mp_forward, plus
// perm [e] int32, the edges in source order, and off_src [n + 1] int32,
// each source's segment of perm; gout [n, d2].  scratch: the floats
// csr_mp_backward_scratch gives, never read before the call writes them.
// Outputs, every element written: gef [e, de]; dx [n, d]; dw [(2d + de)*h
// + h + h*d2 + d2 + 4] = dW1 (rows W1r, W1s, W1e) | db1 | dW2 | db2 | dg1
// dbe1 dg2 dbe2.  ef, w1, w2, gout and scratch are 16-byte aligned.
// Requires the widths csr_mp_forward takes.  Returns the first failing
// cudaError_t (0 on success).
extern "C" int csr_mp_backward(
    const float* x, const float* ef, const int* src, const int* dst,
    const int* off, const int* perm, const int* off_src, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* scal,
    const float* gout, float slope, float* scratch, float* gef, float* dx,
    float* dw, int n, int e, int d, int de, int h, int d2, void* stream) {
  if (!widths_ok(n, e, d, de, h, d2) || !(aligned16(ef) || e == 0) ||
      !aligned16(w1) || !aligned16(w2) || !aligned16(gout) || !aligned16(scratch) ||
      !(aligned16(gef) || e == 0))
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = bwd_plan(e, de, h, d2, false, p);
  if (err != cudaSuccess) return err;
  long long sz[kScratchParts];
  bwd_scratch(n, e, d, de, h, d2, p.blocks, sz);
  float* xab = scratch;
  float* rows = xab + sz[0];
  float* dxab = rows + sz[1];
  float* p_dx = dxab + sz[2];
  float* p_w1rs = p_dx + sz[3];
  float* p_edge = p_w1rs + sz[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dh = static_cast<long long>(d) * h;
  const long long nh = static_cast<long long>(n) * h;
  // (1) x . W1r, x . W1s.
  err = gemm<kNodePartials>(x, 0, d, 1, w1, dh, h, 1, xab, n, h, d, d, 2, s);
  if (err != cudaSuccess) return err;
  // (2) The edge tiles: gef, rows = g_pre1, the blocks' partials.
  err = bwd_edges<false>(p, xab, xab + nh, ef, src, dst, nullptr, off,
                         w1 + 2 * dh, b1, w2, b2, scal, gout, slope, gef, rows,
                         p_edge, n, e, de, h, d2, s);
  if (err != cudaSuccess) return err;
  // (3) dxa, dxb: segmented sums of g_pre1 in edge order.
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 2), kWarps * 32, 0, s>>>(
      rows, dst, nullptr, perm, off, off_src, n, h, dxab);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (4) dxa W1r^T, dxb W1s^T, split over the hidden channels.
  err = gemm<kNodeCotangent>(dxab, nh, h, 1, w1, dh, 1, h, p_dx, n, d, h,
                             kDxSplitK, 2, s);
  if (err != cudaSuccess) return err;
  // (5) x^T dxa, x^T dxb, split over the nodes.
  err = gemm<kNodeWeightGrad>(x, 0, 1, d, dxab, nh, h, 1, p_w1rs, d, h, n,
                              kSplitRows, 2, s);
  if (err != cudaSuccess) return err;
  // (6) The fixed-order sums of every partial.
  const int splits = (n + kSplitRows - 1) / kSplitRows;
  const int dx_splits = (h + kDxSplitK - 1) / kDxSplitK;
  const long long edge_out = edge_partial(de, h, d2);
  const long long rest = 2 * dh + static_cast<long long>(n) * d;
  constexpr int kOut = kReduceThreads / kReduceGroups;
  const int grid = static_cast<int>((edge_out + kOut - 1) / kOut +
                                    (rest + kReduceThreads - 1) / kReduceThreads);
  bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      p_w1rs, splits, p_edge, p.blocks, p_dx, dx_splits, n, d, de, h, d2, dw, dx);
  return cudaGetLastError();
}
