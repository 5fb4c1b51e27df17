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
// Backward.  (1) x . W1r, x . W1s again; (2) csr_bwd_edge_kernel: per
// edge, recompute the forward and apply the chain rule of _bwd_kernel with
// the norm-backward guard of ops/fused_mp._cnorm_act_bwd; write gef, and
// g_pre1, a1, g_pre2 to a per-edge scratch; db1, db2 and the four scalar
// gradients go to per-warp partials; (3) segsum_kernel: dxa[v] = sum of
// g_pre1 over v's destination segment, dxb[u] = sum over u's source segment
// (edges in source order from a stable argsort made by the caller), both in
// edge order; (4) dx = dxa . W1r^T + dxb . W1s^T; (5) dW1r = x^T dxa,
// dW1s = x^T dxb, dW1e = ef^T g_pre1, dW2 = a1^T g_pre2 as split-K
// products whose per-block partials the caller sums (as _backward_impl sums
// its per-tile partials in XLA).  Every output is a fixed-order sum: two
// launches give the same bits.
//
// What bounds them.  At the shipped widths (D = De = D2 = 64, H = 128) an
// edge's message costs 2 * (De*H + H*D2) = 32 768 FLOP against ~300 bytes,
// far above the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B):
// f32 FMA throughput bounds both on paper (no tensor cores: the reference is
// f32).  At the main path's shapes (N = 768, E = 15 360) the forward's
// warps fill less than one wave, so a launch lasts the chain of the busiest
// warp: a few edge groups in a row (PERF.md).  Simple first: no wgmma, no
// TMA, plain tiled f32 products.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block (ops/csr_mp.py _KERNEL_WARPS)
constexpr int kEdgesPerWarp = 8;   // edges a warp carries at once
constexpr float kEps = 1e-5f;      // reference modules/neural_net/constants.py
constexpr float kTiny = 1e-30f;    // ops/fused_mp.py _TINY
constexpr int kTile = 64;          // gemm_kernel output tile (kTile x kTile)
constexpr int kTileK = 16;         // gemm_kernel depth per stage
constexpr int kGemmThreads = 256;  // gemm_kernel threads per block (16 x 16)
constexpr int kSplitRows = 256;    // rows per split-K partial (ops/csr_mp.py _SPLIT_ROWS)

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
// C[z] = (accumulate ? C[z] : 0) + A . B over the k range of split z:
// A(m, k) = A[m*sam + k*sak], B(k, n) = B[k*sbk + n*sbn], C row-major
// [M, N] per split.  Split z covers k in [z*k_split, (z+1)*k_split), cut at
// *k_limit when given (rows past it are zero).  A block computes a 64 x 64
// output tile, 4 x 4 per thread, summing k in order: fixed-order sums.  A
// matrix whose k stride is 1 is read with neighbouring threads on
// neighbouring k (coalesced); the others with neighbouring threads on
// neighbouring m or n.  Use only names the instantiation (GemmUse), so that
// a profile tells the products apart.
enum GemmUse { kNodePartials, kNodeCotangent, kNodeWeightGrad, kEdgeWeightGrad };

template <int Use>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, long long sam, long long sak,
            const float* __restrict__ B, long long sbk, long long sbn,
            float* __restrict__ C, int M, int N, int K, int k_split,
            const int* __restrict__ k_limit, int accumulate) {
  constexpr int kLoads = kTileK * kTile / kGemmThreads;  // per thread per matrix
  // Rows padded by 4 floats: 16-byte aligned, and a column store by
  // neighbouring threads spreads over the banks.
  __shared__ __align__(16) float As[kTileK][kTile + 4];
  __shared__ __align__(16) float Bs[kTileK][kTile + 4];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int z = blockIdx.z;
  const int k0 = z * k_split;
  int k1 = min(K, k0 + k_split);
  if (k_limit != nullptr) k1 = min(k1, *k_limit);
  C += static_cast<size_t>(z) * M * N;
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
      if (m < M && nn < N) {
        float* c = C + static_cast<size_t>(m) * N + nn;
        *c = accumulate ? *c + acc[i][j] : acc[i][j];
      }
    }
}

template <int Use>
cudaError_t gemm(const float* A, long long sam, long long sak, const float* B,
                 long long sbk, long long sbn, float* C, int M, int N, int K,
                 int k_split, const int* k_limit, int accumulate,
                 cudaStream_t stream) {
  const int splits = K > 0 ? (K + k_split - 1) / k_split : 1;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  gemm_kernel<Use><<<grid, kGemmThreads, 0, stream>>>(A, sam, sak, B, sbk, sbn, C, M,
                                             N, K, k_split, k_limit,
                                             accumulate);
  return cudaGetLastError();
}

// x . W1r -> xab[0], x . W1s -> xab[1] (w1 rows: [W1r; W1s; W1e]).
cudaError_t node_partials(const float* x, const float* w1, float* xab, int n,
                          int d, int h, cudaStream_t stream) {
  cudaError_t err = gemm<kNodePartials>(x, d, 1, w1, h, 1, xab, n, h, d, d,
                                        nullptr, 0, stream);
  if (err != cudaSuccess) return err;
  return gemm<kNodePartials>(x, d, 1, w1 + static_cast<size_t>(d) * h, h, 1,
              xab + static_cast<size_t>(n) * h, n, h, d, d, nullptr, 0, stream);
}

// out[v, :] = sum over q in [off[v], off[v+1]) of rows[perm ? perm[q] : q, :]
// (the first `width` columns of rows with leading dimension ld), in order of
// q; one warp per node, lanes own columns.
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const float* __restrict__ rows, int ld,
              const int* __restrict__ perm, const int* __restrict__ off,
              int n, int width, float* __restrict__ out) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (v >= n) return;
  const int lo = off[v], hi = off[v + 1];
  for (int cb = 0; cb < width; cb += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int q = lo; q < hi; ++q) {
      const float* row = rows + static_cast<size_t>(perm ? perm[q] : q) * ld;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = cb + lane + 32 * t;
        if (c < width) acc[t] += row[c];
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = cb + lane + 32 * t;
      if (c < width) out[static_cast<size_t>(v) * width + c] = acc[t];
    }
  }
}

cudaError_t segsum(const float* rows, int ld, const int* perm, const int* off,
                   int n, int width, float* out, cudaStream_t stream) {
  segsum_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      rows, ld, perm, off, n, width, out);
  return cudaGetLastError();
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
template <int HPL, int DPL>
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
    reinterpret_cast<float4*>(s_w1e)[i] = reinterpret_cast<const float4*>(w1e)[i];
  for (int i = tid; i < (h * d2) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_w2)[i] = reinterpret_cast<const float4*>(w2)[i];
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
      *reinterpret_cast<float4*>(stage + j * stage_w + k) = v;
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
      for (int t = 0; t < DPL; ++t) acc[t] += a2[j][t];
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

template <int HPL, int DPL>
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
  err = cudaFuncSetAttribute(csr_fwd_kernel<HPL, DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // One warp per edge group of the edge capacity: known on the host, so
  // the launch needs no device->host read of the live count.
  int num_warps = (e + kEdgesPerWarp - 1) / kEdgesPerWarp;
  if (num_warps < 1) num_warps = 1;
  const int grid = (num_warps + kWarps - 1) / kWarps;
  csr_fwd_kernel<HPL, DPL><<<grid, kWarps * 32, smem, stream>>>(
      xab, xab + static_cast<size_t>(n) * h, ef, src, dst, off, w1e, b1, w2,
      b2, scal, slope, agg, n, de, h, d2, num_warps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, per edge: warp gw takes the edge group gw (edges 8gw..8gw+7).
// rows[p] = [g_pre1 (h) | a1 (h) | g_pre2 (d2)] and gef[p] are written for
// every edge of the group (zero where dst is out of range); the warp's sums
// of g_pre1, g_pre2 and the four scalar gradients go to part[gw].
template <int HPL, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
csr_bwd_edge_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef, const int* __restrict__ src,
                    const int* __restrict__ dst, const float* __restrict__ w1e,
                    const float* __restrict__ w1e_t,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ w2_t,
                    const float* __restrict__ b2,
                    const float* __restrict__ scal,
                    const float* __restrict__ gout, float slope,
                    float* __restrict__ gef, float* __restrict__ rows,
                    float* __restrict__ part, int n, int e, int de, int h,
                    int d2) {
  constexpr int EPW = kEdgesPerWarp;
  extern __shared__ __align__(16) float smem[];
  const int gw_ = h > d2 ? h : d2;  // width of the staged cotangent rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // de, h, d2 are multiples of 4 (checked on the host): rows stay aligned.
  float* st_ef = smem + warp * EPW * (de + h + gw_);  // [EPW][de]
  float* st_a1 = st_ef + EPW * de;                     // [EPW][h]
  float* st_g = st_a1 + EPW * h;                       // [EPW][gw_]
  const int ld = 2 * h + d2;
  const int grp = blockIdx.x * kWarps + warp;
  const int e0 = grp * EPW;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];

  float r_db1[HPL], r_db2[DPL];
#pragma unroll
  for (int t = 0; t < HPL; ++t) r_db1[t] = 0.f;
#pragma unroll
  for (int t = 0; t < DPL; ++t) r_db2[t] = 0.f;
  float r_dg1 = 0.f, r_dbe1 = 0.f, r_dg2 = 0.f, r_dbe2 = 0.f;

  int dj[EPW], sj[EPW];
  bool rok[EPW], any = false;
#pragma unroll
  for (int j = 0; j < EPW; ++j) {
    const bool live = e0 + j < e;
    dj[j] = live ? dst[e0 + j] : -1;
    sj[j] = live ? src[e0 + j] : -1;
    rok[j] = in_range(dj[j], n);
    any |= rok[j];
  }

  if (any) {  // warp-uniform
    for (int i = lane * 4; i < EPW * de; i += 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + i / de < e)
        v = *reinterpret_cast<const float4*>(ef + static_cast<size_t>(e0) * de + i);
      *reinterpret_cast<float4*>(st_ef + i) = v;
    }
    __syncwarp();

    // ---- recompute layer 1 --------------------------------------------------
    float u1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      const bool sok = in_range(sj[j], n);
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        float v = 0.f;
        if (c < h) {
          v = b1[c];
          if (rok[j]) v += xa[static_cast<size_t>(dj[j]) * h + c];
          if (sok) v += xb[static_cast<size_t>(sj[j]) * h + c];
        }
        u1[j][t] = v;
      }
    }
    rows_times<HPL>(u1, st_ef, de, w1e, h, de, lane, h);
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

    // ---- recompute layer 2 --------------------------------------------------
    float u2[EPW][DPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        u2[j][t] = c < d2 ? b2[c] : 0.f;
      }
    rows_times<DPL>(u2, st_a1, h, w2, d2, h, lane, d2);
    float sd2[EPW];
    cnorm_stats<DPL>(u2, sd2, lane, d2);

    // ---- norm2 backward from the destination's cotangent ------------------
    float gp2[EPW][DPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        gp2[j][t] = rok[j] && c < d2 ? gout[static_cast<size_t>(dj[j]) * d2 + c] : 0.f;
      }
    cnorm_act_bwd<DPL>(gp2, u2, sd2, lane, d2, g2, be2, slope, r_dg2, r_dbe2);
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        r_db2[t] += gp2[j][t];
        if (c < d2) st_g[j * gw_ + c] = gp2[j][t];
      }
    __syncwarp();

    // ---- ga1 = g_pre2 W2^T (lanes own hidden channels), norm1 backward -----
    float gp1[EPW][HPL];
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) gp1[j][t] = 0.f;
    rows_times<HPL>(gp1, st_g, gw_, w2_t, h, d2, lane, h);
    cnorm_act_bwd<HPL>(gp1, u1, sd1, lane, h, g1, be1, slope, r_dg1, r_dbe1);

    // ---- per-edge rows: g_pre1 | a1 | g_pre2 -------------------------------
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (e0 + j >= e) continue;
      float* row = rows + static_cast<size_t>(e0 + j) * ld;
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        r_db1[t] += gp1[j][t];
        if (c < h) {
          row[c] = rok[j] ? gp1[j][t] : 0.f;
          row[h + c] = rok[j] ? st_a1[j * h + c] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int c = lane + 32 * t;
        if (c < d2) row[2 * h + c] = rok[j] ? st_g[j * gw_ + c] : 0.f;
      }
    }
    __syncwarp();  // every lane has finished reading g_pre2 from the stage
#pragma unroll
    for (int j = 0; j < EPW; ++j)
#pragma unroll
      for (int t = 0; t < HPL; ++t) {
        const int c = lane + 32 * t;
        if (c < h) st_g[j * gw_ + c] = gp1[j][t];
      }
    __syncwarp();

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
          const float4 x = *reinterpret_cast<const float4*>(st_g + j * gw_ + k);
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
        if (c < de && e0 + j < e)
          gef[static_cast<size_t>(e0 + j) * de + c] = rok[j] ? acc[j] : 0.f;
    }
  } else {
    // No edge of the group has its destination in range: zero rows.
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (e0 + j >= e) continue;
      for (int c = lane; c < ld; c += 32) rows[static_cast<size_t>(e0 + j) * ld + c] = 0.f;
      for (int c = lane; c < de; c += 32) gef[static_cast<size_t>(e0 + j) * de + c] = 0.f;
    }
  }

  // ---- this warp's partial sums: db1 | db2 | dg1 dbe1 dg2 dbe2 ------------
  float* out = part + static_cast<size_t>(grp) * (h + d2 + 4);
#pragma unroll
  for (int t = 0; t < HPL; ++t)
    if (lane + 32 * t < h) out[lane + 32 * t] = r_db1[t];
#pragma unroll
  for (int t = 0; t < DPL; ++t)
    if (lane + 32 * t < d2) out[h + lane + 32 * t] = r_db2[t];
  const float sg1 = warp_sum(r_dg1), sbe1 = warp_sum(r_dbe1);
  const float sg2 = warp_sum(r_dg2), sbe2 = warp_sum(r_dbe2);
  if (lane == 0) {
    out[h + d2 + 0] = sg1;
    out[h + d2 + 1] = sbe1;
    out[h + d2 + 2] = sg2;
    out[h + d2 + 3] = sbe2;
  }
}

template <int HPL, int DPL>
cudaError_t launch_bwd_edges(const float* xab, const float* ef, const int* src,
                             const int* dst, const float* w1e,
                             const float* w1e_t, const float* b1,
                             const float* w2, const float* w2_t,
                             const float* b2, const float* scal,
                             const float* gout, float slope, float* gef,
                             float* rows, float* part, int n, int e, int de,
                             int h, int d2, int warps, cudaStream_t stream) {
  const int gw = h > d2 ? h : d2;
  const size_t smem = sizeof(float) * static_cast<size_t>(kWarps) *
                      kEdgesPerWarp * (de + h + gw);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(csr_bwd_edge_kernel<HPL, DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  csr_bwd_edge_kernel<HPL, DPL><<<warps / kWarps, kWarps * 32, smem, stream>>>(
      xab, xab + static_cast<size_t>(n) * h, ef, src, dst, w1e, w1e_t, b1, w2,
      w2_t, b2, scal, gout, slope, gef, rows, part, n, e, de, h, d2);
  return cudaGetLastError();
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
  if (!widths_ok(n, e, d, de, h, d2)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = node_partials(x, w1, xab, n, d, h, s);
  if (err != cudaSuccess) return err;
  const float* w1e = w1 + 2 * static_cast<size_t>(d) * h;
  const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
#define CSR_FWD(H, D)                                                        \
  if (hpl == H && dpl == D)                                                  \
    return launch_fwd<H, D>(xab, ef, src, dst, off, w1e, b1, w2, b2, scal,   \
                            slope, agg, n, e, de, h, d2, s);
  CSR_WIDTHS(CSR_FWD)
#undef CSR_FWD
  return cudaErrorInvalidValue;
}

// Backward entry point, loaded with ctypes.  Inputs as csr_mp_forward, plus:
// perm [e] int32, the edges in source order, and off_src [n + 1] int32,
// each source's segment of perm; w1e_t [h, de] and w2_t [d2, h], transposed
// copies of W1e and W2; gout [n, d2].  Scratch: xab [2, n, h]; rows
// [e, 2h + d2].  Outputs, every element written: gef [e, de]; dxab [2, n, h]
// (dxa, dxb); dx [n, d]; p_w1rs [2, ceil(n / 256), d, h] (partials of
// x^T dxa, x^T dxb); p_w1e [ceil(e / 256), de, h]; p_w2 [ceil(e / 256), h,
// d2]; part [warps, h + d2 + 4] (per-warp db1, db2, dg1, dbe1, dg2, dbe2),
// warps = ceil(ceil(e / 8) / 8) * 8.  Returns the first failing
// cudaError_t (0 on success).
extern "C" int csr_mp_backward(
    const float* x, const float* ef, const int* src, const int* dst,
    const int* off, const int* perm, const int* off_src, const float* w1,
    const float* w1e_t, const float* b1, const float* w2, const float* w2_t,
    const float* b2, const float* scal, const float* gout, float* xab,
    float* rows, float slope, float* gef, float* dxab, float* dx,
    float* p_w1rs, float* p_w1e, float* p_w2, float* part, int n, int e,
    int d, int de, int h, int d2, int warps, void* stream) {
  if (!widths_ok(n, e, d, de, h, d2) || warps % kWarps ||
      warps * kEdgesPerWarp < e)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = node_partials(x, w1, xab, n, d, h, s);
  if (err != cudaSuccess) return err;
  const float* w1e = w1 + 2 * static_cast<size_t>(d) * h;
  if (warps > 0) {
    const int hpl = (h + 31) / 32, dpl = (d2 + 31) / 32;
    err = cudaErrorInvalidValue;
#define CSR_BWD(H, D)                                                        \
  if (hpl == H && dpl == D)                                                  \
    err = launch_bwd_edges<H, D>(xab, ef, src, dst, w1e, w1e_t, b1, w2, w2_t, \
                                 b2, scal, gout, slope, gef, rows, part, n,   \
                                 e, de, h, d2, warps, s);
    CSR_WIDTHS(CSR_BWD)
#undef CSR_BWD
    if (err != cudaSuccess) return err;
  }
  const int ld = 2 * h + d2;
  float* dxa = dxab;
  float* dxb = dxab + static_cast<size_t>(n) * h;
  // Node cotangents: segmented sums of g_pre1 in edge order.
  if ((err = segsum(rows, ld, nullptr, off, n, h, dxa, s)) != cudaSuccess) return err;
  if ((err = segsum(rows, ld, perm, off_src, n, h, dxb, s)) != cudaSuccess) return err;
  // dx = dxa W1r^T + dxb W1s^T.
  const float* w1s = w1 + static_cast<size_t>(d) * h;
  if ((err = gemm<kNodeCotangent>(dxa, h, 1, w1, 1, h, dx, n, d, h, h, nullptr, 0, s)) != cudaSuccess) return err;
  if ((err = gemm<kNodeCotangent>(dxb, h, 1, w1s, 1, h, dx, n, d, h, h, nullptr, 1, s)) != cudaSuccess) return err;
  // Weight gradients as split-K partials over nodes and over kept edges.
  const size_t w1rs = static_cast<size_t>((n + kSplitRows - 1) / kSplitRows) * d * h;
  if ((err = gemm<kNodeWeightGrad>(x, 1, d, dxa, h, 1, p_w1rs, d, h, n, kSplitRows, nullptr, 0, s)) != cudaSuccess) return err;
  if ((err = gemm<kNodeWeightGrad>(x, 1, d, dxb, h, 1, p_w1rs + w1rs, d, h, n, kSplitRows, nullptr, 0, s)) != cudaSuccess) return err;
  if ((err = gemm<kEdgeWeightGrad>(ef, 1, de, rows, ld, 1, p_w1e, de, h, e, kSplitRows, off + n, 0, s)) != cudaSuccess) return err;
  return gemm<kEdgeWeightGrad>(rows + h, 1, ld, rows + 2 * h, ld, 1, p_w2, h, d2, e,
                               kSplitRows, off + n, 0, s);
}
