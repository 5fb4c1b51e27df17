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
// batched gemm_kernel); (2) csr_bwd_edge_kernel: one block per SM, each a
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block (forward and segsum kernels)
constexpr int kEdgesPerWarp = 8;   // forward: edges a warp carries at once
constexpr int kPad = 4;            // floats past each shared-memory row (4 mod 32)
constexpr float kEps = 1e-5f;      // reference modules/neural_net/constants.py
constexpr float kTiny = 1e-30f;    // ops/fused_mp.py _TINY
constexpr int kTile = 64;          // gemm_kernel output tile (kTile x kTile)
constexpr int kTileK = 16;         // gemm_kernel depth per stage
constexpr int kGemmThreads = 256;  // gemm_kernel threads per block (16 x 16)
constexpr int kSplitRows = 32;     // nodes per split-K partial of dW1r, dW1s
constexpr int kDxSplitK = 32;      // hidden channels per split-K partial of dx
constexpr int kBwdThreads = 256;   // backward: threads per edge block (one block per SM)
constexpr int kReduceThreads = 256;  // bwd_reduce_kernel threads per block
constexpr int kReduceGroups = 8;     // bwd_reduce_kernel: groups of partials per output

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

// Smallest v in [0, n] with off[v] >= target, or n.
__device__ __forceinline__ int lower_bound(const int* off, int n, int target) {
  int lo = 0, hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo < n ? lo : n;
}

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

// Node cotangents, blockIdx.y = 0: dxa[v, :] = sum over q in [off[v],
// off[v+1]) of rows[q, :]; blockIdx.y = 1: dxb[u, :] = the same over
// [off_src[u], off_src[u+1]) of rows[perm[q], :].  Edges whose destination
// is out of range (dropped) are skipped: their rows are zero or, past
// off[n], never written.  In order of q; one warp per node, lanes own
// columns, and the lanes load the next 32 edges' indices together; rows
// and out have width h.
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const float* __restrict__ rows, const int* __restrict__ dst,
              const int* __restrict__ perm, const int* __restrict__ off,
              const int* __restrict__ off_src, int n, int h,
              float* __restrict__ dxab) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (v >= n) return;
  const bool by_src = blockIdx.y == 1;
  const int* seg = by_src ? off_src : off;
  float* out = dxab + (by_src ? static_cast<size_t>(n) * h : 0);
  const int lo = seg[v], hi = seg[v + 1];
  for (int cb = 0; cb < h; cb += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = lo; q0 < hi; q0 += 32) {
      int p = -1;  // the edge at q0 + lane, or -1 if there is none to add
      if (q0 + lane < hi) {
        p = by_src ? perm[q0 + lane] : q0 + lane;
        if (!in_range(dst[p], n)) p = -1;
      }
      const int cnt = min(32, hi - q0);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int pj = __shfl_sync(0xffffffffu, p, j);
        if (pj < 0) continue;
        const float* row = rows + static_cast<size_t>(pj) * h;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = cb + lane + 32 * t;
          if (c < h) acc[t] += row[c];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = cb + lane + 32 * t;
      if (c < h) out[static_cast<size_t>(v) * h + c] = acc[t];
    }
  }
}

// ---------------------------------------------------------------------------
// Channel norm + leaky ReLU of kEdgesPerWarp rows of width `width`, each row
// spread over the warp as v[j][t] = row_j[lane + 32 t] (t < CPL, masked past
// `width`).  The mean first, then the centred squares, as the reference.
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

// acc[j][t] += sum_k stage[j*ld + k] * w[k*wld + lane + 32 t], k < kdim (a
// multiple of 4): one warp, kEdgesPerWarp rows of the stage against a
// weight matrix whose columns the lanes own (masked past `width`).
template <int CPL>
__device__ __forceinline__ void rows_times(float (&acc)[kEdgesPerWarp][CPL],
                                           const float* stage, int ld,
                                           const float* w, int wld, int kdim,
                                           int lane, int width) {
  for (int k = 0; k < kdim; k += 4) {
    float wv[4][CPL];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        wv[q][t] = c < width ? w[(k + q) * wld + c] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kEdgesPerWarp; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(stage + j * ld + k);
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        float a = acc[j][t];
        a = fmaf(x.x, wv[0][t], a);
        a = fmaf(x.y, wv[1][t], a);
        a = fmaf(x.z, wv[2][t], a);
        a = fmaf(x.w, wv[3][t], a);
        acc[j][t] = a;
      }
    }
  }
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

// ---------------------------------------------------------------------------
// Backward, per edge tile (csr_bwd_edge_kernel).  Every edge from off[n] on
// is dropped (its destination is the sentinel), so the work is the edges
// before it; block b of G takes the contiguous run [b off[n] / G,
// (b+1) off[n] / G) in tiles of T (the last one short: the row
// phases and products skip the rows past it, so a block's time follows its
// edge count, not a whole number of tiles).  W1e and W2 sit in shared
// memory for the whole block; each tile's ef rows and gathered xa[dst],
// xb[src], gout[dst] rows arrive by cp.async, the next tile's while this
// one computes (two stages when they fit, else one).  The four edge-level
// products are block-level register-tiled products on shared-memory
// operands (tile_gemm; the transposed ones read the same copies of W2 and
// W1e with transposed indexing), the norms are fixed-order reductions over
// the RT threads of a row, and dW1e += ef^T g_pre1, dW2 += a1^T
// g_pre2 accumulate over the block's tiles (tile_xty: in registers, and
// at wide widths past a thread's register items in the block's partial),
// db1, db2 in shared memory.  g_pre1 goes to rows[p] (zero for a dropped edge)
// for the segmented sums, gef[p] is written for every edge (zero from
// off[n] on), and the block writes one partial [dW1e | db1 | dW2 | db2 |
// dg1 dbe1 dg2 dbe2].

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out(t, c) = init(t, c) + sum over k < K of A[t*lda + k] * B(k, c), for
// the first `rows` rows t of a tile (a multiple of 4: the rows of the row
// phases) and the N columns c, from shared memory; k in order; store(t, c,
// out) takes each element once.
// B(k, c) = W[k*ldw + c], or with TRANS W[c*ldw + k] (a weight matrix read
// transposed from the same copy).  A thread owns 4 rows by 4 columns:
// contiguous columns, or with TRANS columns N/4 apart, so that neighbouring
// lanes read neighbouring rows of W (ldw = 4 mod 32: no bank conflicts);
// neighbouring lanes share their rows of A.  K and N are multiples of 4.
// What bounds it is shared-memory bandwidth: a lane's 16-byte load costs
// the same whether or not its warp shares the address (it is served a
// quarter warp at a time), so a 4 x 4 tile loads 0.5 floats per FMA; 4 x 4
// at N = 64 (128 threads busy) beat 2 x 4 (all 256), and 8 x 4 at N = 128
// (128 busy) lost to 4 x 4 (scripts/torch_csr_bwd_ablation.py, PERF.md).
template <bool TRANS, typename Init, typename Store>
__device__ __forceinline__ void tile_gemm(const float* A, int lda,
                                          const float* W, int ldw, int K,
                                          int N, int rows, Init init,
                                          Store store) {
  constexpr int RM = 4;
  const int ncg = N >> 2, items = ((rows + RM - 1) / RM) * ncg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % ncg, r0 = (it / ncg) * RM;
    int col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j] = TRANS ? cg + j * ncg : cg * 4 + j;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = init(r0 + i, col[j]);
    const float* a_row = A + r0 * lda;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[RM], b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(a_row + i * lda + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = TRANS ? ld4(W + col[j] * ldw + k) : ld4(W + (k + j) * ldw + cg * 4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
        if (TRANS) {  // b[j]: W[col j][k .. k+3]
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = acc[i][j];
            v = fmaf(av[0], b[j].x, v);
            v = fmaf(av[1], b[j].y, v);
            v = fmaf(av[2], b[j].z, v);
            v = fmaf(av[3], b[j].w, v);
            acc[i][j] = v;
          }
        } else {  // b[q]: W[k + q][4 cg .. 4 cg + 3]
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][0] = fmaf(av[q], b[q].x, acc[i][0]);
            acc[i][1] = fmaf(av[q], b[q].y, acc[i][1]);
            acc[i][2] = fmaf(av[q], b[q].z, acc[i][2]);
            acc[i][3] = fmaf(av[q], b[q].w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(r0 + i, col[j], acc[i][j]);
  }
}

// a += X^T Y over the first `rows` rows t of a tile for one item of
// tile_xty: m in [8 mg, 8 mg + 8), c in [4 cg, 4 cg + 4), t in order
// (0.375 floats loaded per FMA).
__device__ __forceinline__ void xty_item(float (&a)[8][4], const float* X,
                                         int ldx, const float* Y, int ldy,
                                         int mg, int cg, int rows) {
#pragma unroll 4
  for (int t = 0; t < rows; ++t) {
    const float4 x0 = ld4(X + t * ldx + 8 * mg), x1 = ld4(X + t * ldx + 8 * mg + 4);
    const float4 y = ld4(Y + t * ldy + 4 * cg);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// out[m * N + c] = a for the rows m < M of item (mg, cg).
__device__ __forceinline__ void store_item(const float (&a)[8][4], float* out,
                                           int mg, int cg, int M, int N) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (8 * mg + i < M)
      *reinterpret_cast<float4*>(out + (8 * mg + i) * N + 4 * cg) =
          make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
}

// The M x N product acc += X^T Y over the first `rows` rows of a tile, in
// items of 8 x 4: item it = threadIdx.x + q * blockDim.x.  Items q < DWI
// live in registers (acc) over the block's tiles; rows m >= M (M a
// multiple of 4) read the row padding and are never stored.  At wide
// widths a thread has more items than that: those (q >= DWI) add into
// `spill`, the block's partial of this product [M, N] in global memory,
// each thread to its own elements only (zeroed by zero_spill before the
// first tile).
template <int DWI>
__device__ __forceinline__ void tile_xty(float (&acc)[DWI][8][4], float* spill,
                                         const float* X, int ldx,
                                         const float* Y, int ldy, int M,
                                         int N, int rows) {
  const int ncg = N >> 2, items = ((M + 7) >> 3) * ncg;
#pragma unroll
  for (int q = 0; q < DWI; ++q) {
    const int it = threadIdx.x + q * blockDim.x;
    if (it < items) xty_item(acc[q], X, ldx, Y, ldy, it / ncg, it % ncg, rows);
  }
  for (int it = threadIdx.x + DWI * blockDim.x; it < items; it += blockDim.x) {
    const int mg = it / ncg, cg = it % ncg;
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = 8 * mg + i < M ? ld4(spill + (8 * mg + i) * N + 4 * cg)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
    xty_item(a, X, ldx, Y, ldy, mg, cg, rows);
    store_item(a, spill, mg, cg, M, N);
  }
}

// Zero this thread's items of tile_xty that live in `spill`.
template <int DWI>
__device__ __forceinline__ void zero_spill(float* spill, int M, int N) {
  const int ncg = N >> 2, items = ((M + 7) >> 3) * ncg;
  const float z[8][4] = {};
  for (int it = threadIdx.x + DWI * blockDim.x; it < items; it += blockDim.x)
    store_item(z, spill, it / ncg, it % ncg, M, N);
}

// out = acc for this thread's register items of tile_xty.
template <int DWI>
__device__ __forceinline__ void store_xty(const float (&acc)[DWI][8][4],
                                          float* out, int M, int N) {
  const int ncg = N >> 2, items = ((M + 7) >> 3) * ncg;
#pragma unroll
  for (int q = 0; q < DWI; ++q) {
    const int it = threadIdx.x + q * blockDim.x;
    if (it < items) store_item(acc[q], out, it / ncg, it % ncg, M, N);
  }
}

// Items per thread of tile_xty for the two weight gradients.
int bwd_xty_items(int de, int h, int d2) {
  const int a = ((de + 7) / 8) * (h / 4), b = ((h + 7) / 8) * (d2 / 4);
  const int items = a > b ? a : b;
  return (items + kBwdThreads - 1) / kBwdThreads;
}

// The sum over the RT threads that share a row (neighbouring
// lanes), in a fixed order; every one of them gets it.
template <int RT>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = RT / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A row of `width` in shared memory, shared by RT threads: part owns the
// float4s at columns 4 part + 4 RT j (8 neighbouring lanes read 128
// contiguous bytes).  Centres this thread's columns in place and
// returns the row's Bessel std (mean first, then the centred squares, as
// the reference channel norm); each component of the float4s keeps its
// own partial sum, added in a fixed order.
template <int RT>
__device__ __forceinline__ float centre_row(float* u, int width, int part,
                                            float inv_n, float inv_nm1) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int c = 4 * part; c < width; c += 4 * RT) {
    const float4 v = ld4(u + c);
    s0 += v.x;
    s1 += v.y;
    s2 += v.z;
    s3 += v.w;
  }
  const float mean = row_sum<RT>((s0 + s1) + (s2 + s3)) * inv_n;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
  for (int c = 4 * part; c < width; c += 4 * RT) {
    float4 v = ld4(u + c);
    v.x -= mean;
    v.y -= mean;
    v.z -= mean;
    v.w -= mean;
    *reinterpret_cast<float4*>(u + c) = v;
    q0 += v.x * v.x;
    q1 += v.y * v.y;
    q2 += v.z * v.z;
    q3 += v.w * v.w;
  }
  return sqrtf(row_sum<RT>((q0 + q1) + (q2 + q3)) * inv_nm1);
}

// The chain rule through lrelu(gamma * u / (sd + eps) + beta) for a row
// (columns as centre_row): g, the cotangent of the activation, becomes the
// cotangent of the norm's input, with the _TINY guard of
// ops/fused_mp._cnorm_act_bwd; dgamma and dbeta accumulate this thread's
// share.  1 / (sd + eps) is taken once and multiplied.
template <int RT>
__device__ __forceinline__ void cnorm_act_bwd_row(
    float* g, const float* u, float sd, int width, int part, float gamma,
    float beta, float slope, float inv_n, float nm1, float& dgamma,
    float& dbeta) {
  const float den = sd + kEps, inv_den = 1.0f / den;
  float num[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 4 * part; c < width; c += 4 * RT) {
    const float4 uv = ld4(u + c), gv = ld4(g + c);
    const float ur[4] = {uv.x, uv.y, uv.z, uv.w}, gr[4] = {gv.x, gv.y, gv.z, gv.w};
    float out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xhat = ur[k] * inv_den;
      const float gh = gamma * xhat + beta >= 0.f ? gr[k] : gr[k] * slope;
      dgamma += gh * xhat;
      dbeta += gh;
      out[k] = gamma * gh;
      num[k] += out[k] * ur[k];
    }
    *reinterpret_cast<float4*>(g + c) = make_float4(out[0], out[1], out[2], out[3]);
  }
  const float cc = row_sum<RT>((num[0] + num[1]) + (num[2] + num[3])) /
                   (den * den * fmaxf(sd, kTiny) * nm1);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 4 * part; c < width; c += 4 * RT) {
    const float4 uv = ld4(u + c), gv = ld4(g + c);
    const float4 gu = make_float4(gv.x * inv_den - uv.x * cc, gv.y * inv_den - uv.y * cc,
                                  gv.z * inv_den - uv.z * cc, gv.w * inv_den - uv.w * cc);
    *reinterpret_cast<float4*>(g + c) = gu;
    s[0] += gu.x;
    s[1] += gu.y;
    s[2] += gu.z;
    s[3] += gu.w;
  }
  const float mean = row_sum<RT>((s[0] + s[1]) + (s[2] + s[3])) * inv_n;
  for (int c = 4 * part; c < width; c += 4 * RT) {
    float4 v = ld4(g + c);
    v.x -= mean;
    v.y -= mean;
    v.z -= mean;
    v.w -= mean;
    *reinterpret_cast<float4*>(g + c) = v;
  }
}

// Dynamic shared memory of csr_bwd_edge_kernel with tiles of T edges and
// `stages` input stages.
size_t bwd_smem(int de, int h, int d2, int T, int stages) {
  const size_t lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  const size_t floats = de * ldh + h * ldd + stages * T * (lde + 2 * ldh + ldd) +
                        2 * T * ldh + 2 * (h + d2) + T + 4 * (kBwdThreads / 32);
  return sizeof(float) * floats + sizeof(int) * stages * T;
}

// T edges a tile, RT = kBwdThreads / T threads a row of the tile in the
// row phases (a warp holds 32 / RT rows), DWI register items a thread of
// each weight-gradient product (tile_xty).
template <int T, int DWI>
__global__ void __launch_bounds__(kBwdThreads, 1)
csr_bwd_edge_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef, const int* __restrict__ src,
                    const int* __restrict__ dst, const int* __restrict__ off,
                    const float* __restrict__ w1e, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ scal,
                    const float* __restrict__ gout, float slope,
                    float* __restrict__ gef, float* __restrict__ g_rows,
                    float* __restrict__ partial, int n, int e, int de,
                    int h, int d2, int stages) {
  constexpr int RT = kBwdThreads / T, WR = 32 / RT;
  static_assert(RT * T == kBwdThreads && RT >= 8 && RT <= 32, "8 to 32 threads a row");
  extern __shared__ __align__(16) float smem[];
  const int lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  const int stage_f = T * (lde + 2 * ldh + ldd);
  float* s_w1e = smem;                       // [de][ldh]
  float* s_w2 = s_w1e + de * ldh;            // [h][ldd]
  float* s_stage = s_w2 + h * ldd;           // [stages] of ef | xa | xb | gout
  float* s_a1 = s_stage + stages * stage_f;  // [T][ldh] layer-1 activations
  float* s_y = s_a1 + T * ldh;               // [T][ldh] g_pre2 W2^T, then g_pre1
  float* s_b1 = s_y + T * ldh;               // [h]
  float* s_b2 = s_b1 + h;                    // [d2]
  float* s_db1 = s_b2 + d2;                  // [h] the block's sum of g_pre1
  float* s_db2 = s_db1 + h;                  // [d2] ... of g_pre2
  float* s_sd1 = s_db2 + d2;                 // [T] layer-1 Bessel std
  float* s_red = s_sd1 + T;                  // [warps][4]
  int* s_dst = reinterpret_cast<int*>(s_red + 4 * (kBwdThreads / 32));  // [stages][T]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // This block's edges: a contiguous, balanced share [e_lo, e_hi) of the
  // edges before off[n], in tiles of T from e_lo (the last one short).
  const int p_end = off[n];
  const int e_lo = static_cast<int>(static_cast<long long>(blockIdx.x) * p_end / gridDim.x);
  const int e_hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p_end / gridDim.x);
  const int nt = (e_hi - e_lo + T - 1) / T;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  const float inv_h = 1.0f / static_cast<float>(h);
  const float inv_d2 = 1.0f / static_cast<float>(d2);
  const float nm1_h = static_cast<float>(h > 1 ? h - 1 : 1);
  const float nm1_d2 = static_cast<float>(d2 > 1 ? d2 - 1 : 1);
  const float inv_hm1 = 1.0f / nm1_h, inv_d2m1 = 1.0f / nm1_d2;

  // The weights, once per block (their copies join the first tile's group).
  const int ch = h >> 2, cd = d2 >> 2, ce = de >> 2;
  for (int i = tid; i < de * ch; i += blockDim.x) {
    const int r = i / ch, c = (i - r * ch) * 4;
    cp_async16(s_w1e + r * ldh + c, w1e + static_cast<size_t>(r) * h + c, true);
  }
  for (int i = tid; i < h * cd; i += blockDim.x) {
    const int r = i / cd, c = (i - r * cd) * 4;
    cp_async16(s_w2 + r * ldd + c, w2 + static_cast<size_t>(r) * d2 + c, true);
  }
  for (int i = tid; i < h; i += blockDim.x) {
    s_b1[i] = b1[i];
    s_db1[i] = 0.f;
  }
  for (int i = tid; i < d2; i += blockDim.x) {
    s_b2[i] = b2[i];
    s_db2[i] = 0.f;
  }

  // Tile i's inputs into stage `buf`: ef rows, xa[dst], xb[src], gout[dst]
  // (zero past the block's edges or for a sentinel index), and dst.  The
  // RT threads of row t copy 4 RT contiguous floats a step; the row's
  // indices (dd, ss) are read a tile ahead (next_index).
  const int row_t = tid / RT, part = tid % RT;
  auto next_index = [&](int i, int& dd, int& ss) {
    const int p = e_lo + i * T + row_t;
    dd = p < e_hi ? dst[p] : n;
    ss = p < e_hi ? src[p] : n;
  };
  auto stage_in = [&](int i, int buf, int dd, int ss) {
    float* st = s_stage + buf * stage_f;
    const int p = e_lo + i * T + row_t;
    const bool live = p < e_hi;
    const bool keep = in_range(dd, n), sok = in_range(ss, n);
    const float* g_ef = ef + static_cast<size_t>(live ? p : 0) * de;
    const float* g_xa = xa + static_cast<size_t>(keep ? dd : 0) * h;
    const float* g_xb = xb + static_cast<size_t>(sok ? ss : 0) * h;
    const float* g_go = gout + static_cast<size_t>(keep ? dd : 0) * d2;
    float* s_ef = st + row_t * lde;
    float* s_xa = st + T * lde + row_t * ldh;
    float* s_xb = s_xa + T * ldh;
    float* s_go = st + T * (lde + 2 * ldh) + row_t * ldd;
    for (int c = 4 * part; c < de; c += 4 * RT) cp_async16(s_ef + c, g_ef + c, live);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(s_xa + c, g_xa + c, keep);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(s_xb + c, g_xb + c, sok);
    for (int c = 4 * part; c < d2; c += 4 * RT) cp_async16(s_go + c, g_go + c, keep);
    if (part == 0) s_dst[buf * T + row_t] = dd;
  };

  // This block's partial: dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2.
  float* out = partial + static_cast<size_t>(blockIdx.x) *
                          (de * h + h + h * d2 + d2 + 4);
  float* out_w2 = out + de * h + h;
  float acc_w1e[DWI][8][4], acc_w2[DWI][8][4];
#pragma unroll
  for (int q = 0; q < DWI; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_w1e[q][i][j] = acc_w2[q][i][j] = 0.f;
  zero_spill<DWI>(out, de, h);
  zero_spill<DWI>(out_w2, h, d2);
  float r_dg1 = 0.f, r_dbe1 = 0.f, r_dg2 = 0.f, r_dbe2 = 0.f;

  const bool two = stages == 2;
  int dd = n, ss = n;  // the indices of the next tile to stage
  next_index(0, dd, ss);
  if (two && nt > 0) {
    stage_in(0, 0, dd, ss);
    next_index(1, dd, ss);
  }
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    const int buf = two ? i & 1 : 0;
    const int staged = two ? i + 1 : i;
    if (staged < nt) {
      stage_in(staged, two ? buf ^ 1 : 0, dd, ss);
      next_index(staged + 1, dd, ss);  // in flight during this tile
    }
    cp_async_commit();
    if (two)
      cp_async_wait<1>();  // every group but the next tile's has landed
    else
      cp_async_wait<0>();
    __syncthreads();
    float* st = s_stage + buf * stage_f;
    float* s_ef = st;                // [T][lde]
    float* s_p1 = st + T * lde;      // [T][ldh] xa[dst], then pre1, then u1
    float* s_p2 = s_p1 + T * ldh;    // [T][ldh] xb[src], then pre2, then u2
    float* s_g2 = s_p2 + T * ldh;    // [T][ldd] gout[dst], then g_pre2
    const int* t_dst = s_dst + buf * T;
    const int p0 = e_lo + i * T, rows = min(T, e_hi - p0);
    // The products and the row phases take the rows before prows (`rows`
    // rounded up to the products' groups of 4 rows); a warp whose rows are
    // all past it skips the row phases.  Rows past `rows` are zero inputs
    // (added in exactly) or never read.
    const int prows = (rows + 3) & ~3;
    const bool warp_rows = warp * WR < prows;

    // ---- pre1 = b1 + xa[dst] + xb[src] + ef . W1e, over xa[dst] ----------
    tile_gemm<false>(
        s_ef, lde, s_w1e, ldh, de, h, prows,
        [&](int t, int c) { return s_b1[c] + s_p1[t * ldh + c] + s_p2[t * ldh + c]; },
        [&](int t, int c, float v) { s_p1[t * ldh + c] = v; });
    __syncthreads();

    // ---- norm 1: u1 = pre1 - mean in place, sd1, a1 -----------------------
    if (warp_rows) {
      float* u = s_p1 + row_t * ldh;
      const float sd = centre_row<RT>(u, h, part, inv_h, inv_hm1);
      const float inv_den = 1.0f / (sd + kEps);
      for (int c = 4 * part; c < h; c += 4 * RT) {
        const float4 v = ld4(u + c);
        const float vr[4] = {v.x, v.y, v.z, v.w};
        float ar[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float y = g1 * (vr[k] * inv_den) + be1;
          ar[k] = y >= 0.f ? y : slope * y;
        }
        *reinterpret_cast<float4*>(s_a1 + row_t * ldh + c) =
            make_float4(ar[0], ar[1], ar[2], ar[3]);
      }
      if (part == 0) s_sd1[row_t] = sd;
    }
    __syncthreads();

    // ---- pre2 = b2 + a1 . W2, over xb[src] ----------------------------------
    tile_gemm<false>(
        s_a1, ldh, s_w2, ldd, h, d2, prows, [&](int, int c) { return s_b2[c]; },
        [&](int t, int c, float v) { s_p2[t * ldh + c] = v; });
    __syncthreads();

    // ---- norm 2 and its backward from gout[dst]: g_pre2 in place -----------
    if (warp_rows) {
      float* u = s_p2 + row_t * ldh;
      const float sd = centre_row<RT>(u, d2, part, inv_d2, inv_d2m1);
      cnorm_act_bwd_row<RT>(s_g2 + row_t * ldd, u, sd, d2, part, g2, be2, slope,
                        inv_d2, nm1_d2, r_dg2, r_dbe2);
    }
    __syncthreads();

    // ---- ga1 = g_pre2 W2^T --------------------------------------------------
    tile_gemm<true>(
        s_g2, ldd, s_w2, ldd, d2, h, prows, [](int, int) { return 0.f; },
        [&](int t, int c, float v) { s_y[t * ldh + c] = v; });
    __syncthreads();

    // ---- norm 1 backward: g_pre1 in place, and to g_rows[p] ----------------
    if (warp_rows) {
      float* g = s_y + row_t * ldh;
      cnorm_act_bwd_row<RT>(g, s_p1 + row_t * ldh, s_sd1[row_t], h, part, g1, be1,
                        slope, inv_h, nm1_h, r_dg1, r_dbe1);
      if (row_t < rows) {
        const bool keep = in_range(t_dst[row_t], n);
        float* row = g_rows + static_cast<size_t>(p0 + row_t) * h;
        for (int c = 4 * part; c < h; c += 4 * RT)
          *reinterpret_cast<float4*>(row + c) =
              keep ? ld4(g + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();

    // ---- gef = g_pre1 W1e^T; dW1e += ef^T g_pre1, dW2 += a1^T g_pre2 -------
    tile_gemm<true>(
        s_y, ldh, s_w1e, ldh, h, de, prows, [](int, int) { return 0.f; },
        [&](int t, int c, float v) {
          if (t < rows)
            gef[static_cast<size_t>(p0 + t) * de + c] = in_range(t_dst[t], n) ? v : 0.f;
        });
    tile_xty<DWI>(acc_w1e, out, s_ef, lde, s_y, ldh, de, h, rows);
    tile_xty<DWI>(acc_w2, out_w2, s_a1, ldh, s_g2, ldd, h, d2, rows);
    for (int c = tid; c < h; c += blockDim.x) {
      float v = s_db1[c];
      for (int t = 0; t < rows; ++t) v += s_y[t * ldh + c];
      s_db1[c] = v;
    }
    for (int c = tid; c < d2; c += blockDim.x) {
      float v = s_db2[c];
      for (int t = 0; t < rows; ++t) v += s_g2[t * ldd + c];
      s_db2[c] = v;
    }
    __syncthreads();  // the stage and s_a1, s_y are free for the next tile
  }
  cp_async_wait<0>();  // a block without tiles still has the weights in flight

  // ---- this block's partial ---------------------------------------------
  store_xty<DWI>(acc_w1e, out, de, h);
  for (int c = tid; c < h; c += blockDim.x) out[de * h + c] = s_db1[c];
  store_xty<DWI>(acc_w2, out_w2, h, d2);
  for (int c = tid; c < d2; c += blockDim.x) out[de * h + h + h * d2 + c] = s_db2[c];
  const float r[4] = {warp_sum(r_dg1), warp_sum(r_dbe1), warp_sum(r_dg2),
                      warp_sum(r_dbe2)};
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) s_red[warp * 4 + k] = r[k];
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    for (int w = 0; w < kBwdThreads / 32; ++w) v += s_red[w * 4 + tid];
    out[de * h + h + h * d2 + d2 + tid] = v;
  }

  // ---- gef of the edges from off[n] on: zero ------------------------------
  float4* gef4 = reinterpret_cast<float4*>(gef);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(p_end) * ce + blockIdx.x * blockDim.x + tid;
       i < static_cast<size_t>(e) * ce; i += stride)
    gef4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// How csr_bwd_edge_kernel runs at these widths on this device: edges a
// tile T (32, else 16, else 8: the largest whose shared memory fits a
// block, with two input stages where they fit, else one), edge blocks (one
// per SM, no more than there are tiles) and weight-gradient items a thread.
// Every width csr_mp_forward takes fits at T = 8.
struct BwdPlan {
  int tile, stages, blocks, items;
  size_t smem;
};

cudaError_t bwd_plan(int e, int de, int h, int d2, BwdPlan& p) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int t = 32; t >= 8; t /= 2)
    for (int stages = 2; stages >= 1; --stages) {
      const size_t smem = bwd_smem(de, h, d2, t, stages);
      if (smem > static_cast<size_t>(smem_max)) continue;
      const int tiles = (e + t - 1) / t;
      p = {t, stages, tiles < 1 ? 1 : (tiles < sms ? tiles : sms),
           bwd_xty_items(de, h, d2), smem};
      return cudaSuccess;
    }
  return cudaErrorInvalidValue;
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
  sz[5] = static_cast<long long>(blocks) *
          (static_cast<long long>(de) * h + h + static_cast<long long>(h) * d2 + d2 + 4);
  for (long long& v : sz) v = (v + 3) & ~3LL;
}

template <int T, int DWI>
cudaError_t launch_bwd_edges(const BwdPlan& p, const float* xab,
                             const float* ef, const int* src, const int* dst,
                             const int* off, const float* w1e, const float* b1,
                             const float* w2, const float* b2,
                             const float* scal, const float* gout, float slope,
                             float* gef, float* rows, float* part, int n,
                             int e, int de, int h, int d2,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(csr_bwd_edge_kernel<T, DWI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  csr_bwd_edge_kernel<T, DWI><<<p.blocks, kBwdThreads, p.smem, stream>>>(
      xab, xab + static_cast<size_t>(n) * h, ef, src, dst, off, w1e, b1, w2, b2,
      scal, gout, slope, gef, rows, part, n, e, de, h, d2, p.stages);
  return cudaGetLastError();
}

// The final sums, in fixed order.  The edge blocks' partials
// [dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2]: a block takes kReduceOut
// outputs, kReduceGroups groups of its threads each sum a contiguous run
// of the partials in block order, then the group sums are added in group
// order (dw after the node part).  Then one thread an output: dw's node
// part [x^T dxa | x^T dxb], the sum of the node splits in order, and dx,
// the sum of the 2 x dx_splits partials of dxa W1r^T, dxb W1s^T in order.
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce_kernel(const float* __restrict__ p_w1rs, int splits,
                  const float* __restrict__ p_edge, int blocks,
                  const float* __restrict__ p_dx, int dx_splits, int n, int d,
                  int de, int h, int d2, float* __restrict__ dw,
                  float* __restrict__ dx) {
  constexpr int kOut = kReduceThreads / kReduceGroups;
  __shared__ float group_sum[kReduceGroups][kOut];
  const long long dh = static_cast<long long>(d) * h;
  const long long node = 2 * dh;
  const long long edge = static_cast<long long>(de) * h + h +
                         static_cast<long long>(h) * d2 + d2 + 4;
  const long long ndx = static_cast<long long>(n) * d;
  const int edge_blocks = static_cast<int>((edge + kOut - 1) / kOut);
  if (static_cast<int>(blockIdx.x) < edge_blocks) {
    const int o = threadIdx.x % kOut, g = threadIdx.x / kOut;
    const long long j = static_cast<long long>(blockIdx.x) * kOut + o;
    float v = 0.f;
    if (j < edge) {
      const float* p = p_edge + j;
#pragma unroll 4
      for (int b = g * blocks / kReduceGroups; b < (g + 1) * blocks / kReduceGroups; ++b)
        v += p[b * edge];
    }
    group_sum[g][o] = v;
    __syncthreads();
    if (g == 0 && j < edge) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < kReduceGroups; ++k) t += group_sum[k][o];
      dw[node + j] = t;
    }
    return;
  }
  const long long i = static_cast<long long>(blockIdx.x - edge_blocks) * blockDim.x + threadIdx.x;
  if (i < node) {
    const long long b = i / dh;
    const float* p = p_w1rs + b * splits * dh + (i - b * dh);
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += p[z * dh];
    dw[i] = v;
  } else if (i < node + ndx) {
    const float* p = p_dx + (i - node);
    float v = 0.f;
    for (int z = 0; z < 2 * dx_splits; ++z) v += p[z * ndx];
    dx[i - node] = v;
  }
}

bool widths_ok(int n, int e, int d, int de, int h, int d2) {
  const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
  return n > 0 && e >= 0 && d > 0 && de > 0 && de % 4 == 0 && h % 4 == 0 &&
         d2 % 4 == 0 && (hpl == 1 || hpl == 2 || hpl == 4 || hpl == 8) &&
         (dpl == 1 || dpl == 2 || dpl == 4);
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
  const cudaError_t err = bwd_plan(e, de, h, d2, p);
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
  auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  if (!widths_ok(n, e, d, de, h, d2) || !(aligned(ef) || e == 0) ||
      !aligned(w1) || !aligned(w2) || !aligned(gout) || !aligned(scratch) ||
      !(aligned(gef) || e == 0))
    return cudaErrorInvalidValue;
  BwdPlan p;
  cudaError_t err = bwd_plan(e, de, h, d2, p);
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
  const float* w1e = w1 + 2 * dh;
  const int dwi = p.items > 1 ? 2 : 1;
#define CSR_BWD(T, W)                                                         \
  if (p.tile == T && dwi == W)                                                \
    err = launch_bwd_edges<T, W>(p, xab, ef, src, dst, off, w1e, b1, w2, b2,  \
                                 scal, gout, slope, gef, rows, p_edge, n, e,  \
                                 de, h, d2, s);
  CSR_BWD(32, 1) CSR_BWD(32, 2) CSR_BWD(16, 1) CSR_BWD(16, 2) CSR_BWD(8, 1) CSR_BWD(8, 2)
#undef CSR_BWD
  if (err != cudaSuccess) return err;
  // (3) dxa, dxb: segmented sums of g_pre1 in edge order.
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 2), kWarps * 32, 0, s>>>(
      rows, dst, perm, off, off_src, n, h, dxab);
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
  const long long edge_out = static_cast<long long>(de) * h + h +
                             static_cast<long long>(h) * d2 + d2 + 4;
  const long long rest = 2 * dh + static_cast<long long>(n) * d;
  constexpr int kOut = kReduceThreads / kReduceGroups;
  const int grid = static_cast<int>((edge_out + kOut - 1) / kOut +
                                    (rest + kReduceThreads - 1) / kReduceThreads);
  bwd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      p_w1rs, splits, p_edge, p.blocks, p_dx, dx_splits, n, d, de, h, d2, dw, dx);
  return cudaGetLastError();
}
