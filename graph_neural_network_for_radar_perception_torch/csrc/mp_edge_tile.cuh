// The edge-tile core shared by both message rounds (csrc/fused_mp.cu and
// csrc/csr_mp.cu): the forward and the backward apart from the node
// products.
//
// Both rounds compute, for every edge p with receiver dst[p] and sender
// src[p] (sentinels: dst = N drops the message, src = N gathers a zero
// row and keeps it),
//
//   pre1 = xa[dst] + xb[src] + ef[p] . W1e + b1                 [H]
//   m1   = lrelu(cnorm(pre1; g1, be1))
//   m2   = lrelu(cnorm(m1 . W2 + b2; g2, be2))                  [D2]
//   agg[dst] += m2
//
// with xa = x . W1r and xb = x . W1s per node.  Both walk the kept edges
// in receiver order: positions [0, off[N]) of that order, where position
// q is the edge q (the CSR round: its edges are sorted by destination
// already) or the edge order[q] (the fused round: a stable argsort of its
// receivers, ops/fused_mp.fused_layout).  Each edge kernel runs one block
// per SM, each a balanced contiguous run of positions in tiles of T = 32
// edges (16 or 8 where 32 rows would overflow the shared memory), not cut
// at segment boundaries, with W1e and W2 in shared memory once per block;
// the products are block-level register tiles on shared-memory operands
// (tile_gemm), the norms fixed-order row phases (centre_row).
//
// Forward, two launches (after the CSR round's node products):
// * fwd_edge_kernel (f32) or fwd_edge_kernel_bf16 (the TPU kernels' bf16
//   operands, both products on the bf16 tensor cores): each position's
//   message to its edge's row of a scratch msgs [E, D2];
// * segsum_kernel: agg[v] = the sum of v's receiver segment of msgs, in
//   order of position, dropped edges skipped; every agg row written once.
//
// Backward, three launches:
// * bwd_edge_kernel: per tile it recomputes the forward, applies the chain
//   rule of the TPU kernels' _bwd_kernel with the norm-backward guard of
//   ops/fused_mp._cnorm_act_bwd, writes gef and g_pre1 (to a per-edge
//   scratch, by edge), and accumulates dW1e = ef^T g_pre1, dW2 = a1^T
//   g_pre2, db1, db2 and the four scalar gradients into one partial per
//   block.  gef of every edge is written, zero for a dropped one.
// * segsum_kernel: dxa[v] = the sum of g_pre1 over v's receiver segment,
//   dxb[u] = over u's sender segment (edges in sender order from a stable
//   argsort), both in order of position, dropped edges skipped.
// * bwd_reduce_kernel: every partial summed in block order (and, for the
//   CSR round, its node-level partials).
//
// A batch of graphs (the JAX package vmaps the one-graph round, and the
// batching rule of pallas_call gives the kernel a leading grid axis over
// the graphs): every kernel takes a grid dimension over the graphs (y for
// the edge kernels, z for segsum_kernel and gemm_kernel), and graph g reads
// and writes its own slice of each array, at per-graph strides.  Its edge
// tiles, segments and sums are exactly those of a launch on graph g alone
// (gridDim.x and every run are per graph), so the per-graph outputs are
// those launches' bits; the weight gradients are the partials of every
// graph's blocks, summed in graph order (bwd_reduce_kernel).  With one
// graph the kernels do what they did before the graph axis.
//
// No atomics: every output is a fixed-order sum, so two launches give the
// same bits.  What bounds the f32 kernels: f32 FMAs on paper (the top of
// csrc/csr_mp.cu), shared-memory bandwidth for tile_gemm in practice (a
// lane's 16-byte load costs the same whether or not its warp shares the
// address); the bf16 forward: the bytes (its mma.sync products load about
// 16 times less from shared memory a multiply-add than tile_gemm).  The
// ablations behind the register tiles, stages and edge tiles:
// scripts/edge_tile_ablation.py (backward), scripts/fwd_tile_ablation.py
// (both forwards, f32 and bf16) and PERF.md.  Each source includes this header inside its own
// translation unit (each is its own library); ops/_build.py hashes it with
// the source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps per block of segsum_kernel
constexpr int kPad = 4;              // floats past each shared-memory row (4 mod 32)
constexpr float kEps = 1e-5f;        // reference modules/neural_net/constants.py
constexpr float kTiny = 1e-30f;      // ops/fused_mp.py _TINY
constexpr int kEdgeThreads = 256;    // threads per edge block (one block per SM)
constexpr int kReduceThreads = 256;  // bwd_reduce_kernel threads per block
constexpr int kReduceGroups = 8;     // bwd_reduce_kernel: groups of partials per output

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// Segmented sums, blockIdx.y = 0: dxa[v, :] = sum over q in [off[v],
// off[v+1]) of rows[order[q], :] (rows[q, :] where order is null: the CSR
// round's edges are in receiver order); blockIdx.y = 1: dxb[u, :] = the
// same over [off_src[u], off_src[u+1]) of rows[perm[q], :].  The forwards
// sum their messages into agg with blockIdx.y = 0 alone.  rows is indexed
// by edge.  Edges whose destination is out of range (dropped) are
// skipped: their rows are never read.  In order of q; one warp
// per node, lanes own columns, and the lanes load the next 32 edges'
// indices together; rows and out have width h.  blockIdx.z = g, the graph:
// dst, order and perm at g * e, off and off_src at g * (n + 1), rows at
// g * rows_gs and dxab at g * out_gs.
__global__ void __launch_bounds__(kWarps * 32)
segsum_kernel(const float* __restrict__ rows, const int* __restrict__ dst,
              const int* __restrict__ order, const int* __restrict__ perm,
              const int* __restrict__ off, const int* __restrict__ off_src,
              int n, int e, int h, long long rows_gs, long long out_gs,
              float* __restrict__ dxab) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (v >= n) return;
  const size_t g = blockIdx.z;
  rows += g * rows_gs;
  dst += g * e;
  if (order) order += g * e;
  if (perm) perm += g * e;
  off += g * (n + 1);
  if (off_src) off_src += g * (n + 1);
  dxab += g * out_gs;
  const bool by_src = blockIdx.y == 1;
  const int* seg = by_src ? off_src : off;
  float* out = dxab + (by_src ? static_cast<size_t>(n) * h : 0);
  const int lo = seg[v], hi = seg[v + 1];
  for (int cb = 0; cb < h; cb += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = lo; q0 < hi; q0 += 32) {
      int p = -1;  // the edge at q0 + lane, or -1 if there is none to add
      if (q0 + lane < hi) {
        p = by_src ? perm[q0 + lane] : order ? order[q0 + lane] : q0 + lane;
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
// Backward, per edge tile (bwd_edge_kernel).  Positions q of the receiver
// order: the edge q, or with ORDER the edge order[q].  Every position from
// off[n] on is a dropped edge (its receiver is out of range), so the work
// is the positions before it; block b of G takes the contiguous run
// [b off[n] / G, (b+1) off[n] / G) in tiles of T (the last one short: the row
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
// db1, db2 in shared memory.  g_pre1 goes to rows[p] of the tile row's
// edge p (zero for a dropped edge) for the segmented sums, gef[p] is
// written for every edge (zero from position off[n] on), and the block
// writes one partial [dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2].

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
// (128 busy) lost to 4 x 4 (scripts/edge_tile_ablation.py, PERF.md).
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
  return (items + kEdgeThreads - 1) / kEdgeThreads;
}

// The partial of one edge block of bwd_edge_kernel, in floats:
// dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2.
__host__ __device__ __forceinline__ size_t edge_partial_floats(int de, int h, int d2) {
  return static_cast<size_t>(de) * h + h + static_cast<size_t>(h) * d2 + d2 + 4;
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

// Dynamic shared memory of bwd_edge_kernel with tiles of T edges and
// `stages` input stages (the receivers and, with `order`, the edges of the
// staged rows after the floats).
size_t bwd_smem(int de, int h, int d2, int T, int stages, bool order) {
  const size_t lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  const size_t ldp = (h > d2 ? h : d2) + kPad;
  const size_t floats = de * ldh + h * ldd + stages * T * (lde + ldh + ldp + ldd) +
                        2 * T * ldh + 2 * (h + d2) + T + 4 * (kEdgeThreads / 32);
  return sizeof(float) * floats + (order ? 2 : 1) * sizeof(int) * stages * T;
}

// T edges a tile, RT = kEdgeThreads / T threads a row of the tile in the
// row phases (a warp holds 32 / RT rows), DWI register items a thread of
// each weight-gradient product (tile_xty); ORDER: position q is the edge
// order[q] (else the edge q, and order is not read).
template <int T, int DWI, bool ORDER>
__global__ void __launch_bounds__(kEdgeThreads, 1)
bwd_edge_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                    const float* __restrict__ ef, const int* __restrict__ src,
                    const int* __restrict__ dst, const int* __restrict__ order,
                    const int* __restrict__ off,
                    const float* __restrict__ w1e, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ scal,
                    const float* __restrict__ gout, float slope,
                    float* __restrict__ gef, float* __restrict__ g_rows,
                    float* __restrict__ partial, int n, int e, int de,
                    int h, int d2, long long x_gs, int stages) {
  constexpr int RT = kEdgeThreads / T, WR = 32 / RT;
  // blockIdx.y = g, the graph: its slices of every per-graph array (xa, xb
  // at g * x_gs), and its blocks' partials after those of graphs < g.
  {
    const size_t g = blockIdx.y;
    xa += g * x_gs;
    xb += g * x_gs;
    ef += g * e * de;
    gef += g * e * de;
    src += g * e;
    dst += g * e;
    if constexpr (ORDER) order += g * e;
    off += g * (n + 1);
    gout += g * n * d2;
    g_rows += g * e * h;
    partial += g * gridDim.x * edge_partial_floats(de, h, d2);
  }
  static_assert(RT * T == kEdgeThreads && RT >= 8 && RT <= 32, "8 to 32 threads a row");
  extern __shared__ __align__(16) float smem[];
  const int lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  const int ldp = (h > d2 ? h : d2) + kPad;  // rows of xb[src], then pre2
  const int stage_f = T * (lde + ldh + ldp + ldd);
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
  int* s_dst = reinterpret_cast<int*>(s_red + 4 * (kEdgeThreads / 32));  // [stages][T]
  int* s_edge = s_dst + stages * T;  // [stages][T] with ORDER: each row's edge

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
  // The edge at position q (q < e).
  auto edge_at = [&](int q) {
    if constexpr (ORDER) return order[q]; else return q;
  };
  auto next_index = [&](int i, int& dd, int& ss, int& pp) {
    const int q = e_lo + i * T + row_t;
    pp = q < e_hi ? edge_at(q) : 0;
    dd = q < e_hi ? dst[pp] : n;
    ss = q < e_hi ? src[pp] : n;
  };
  auto stage_in = [&](int i, int buf, int dd, int ss, int p) {
    float* st = s_stage + buf * stage_f;
    const bool live = e_lo + i * T + row_t < e_hi;
    const bool keep = in_range(dd, n), sok = in_range(ss, n);
    const float* g_ef = ef + static_cast<size_t>(live ? p : 0) * de;
    const float* g_xa = xa + static_cast<size_t>(keep ? dd : 0) * h;
    const float* g_xb = xb + static_cast<size_t>(sok ? ss : 0) * h;
    const float* g_go = gout + static_cast<size_t>(keep ? dd : 0) * d2;
    float* s_ef = st + row_t * lde;
    float* s_xa = st + T * lde + row_t * ldh;
    float* s_xb = st + T * (lde + ldh) + row_t * ldp;
    float* s_go = st + T * (lde + ldh + ldp) + row_t * ldd;
    for (int c = 4 * part; c < de; c += 4 * RT) cp_async16(s_ef + c, g_ef + c, live);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(s_xa + c, g_xa + c, keep);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(s_xb + c, g_xb + c, sok);
    for (int c = 4 * part; c < d2; c += 4 * RT) cp_async16(s_go + c, g_go + c, keep);
    if (part == 0) {
      s_dst[buf * T + row_t] = dd;
      if constexpr (ORDER) s_edge[buf * T + row_t] = p;
    }
  };

  // This block's partial: dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2.
  float* out = partial + static_cast<size_t>(blockIdx.x) * edge_partial_floats(de, h, d2);
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
  int dd = n, ss = n, pp = 0;  // the indices of the next tile to stage
  next_index(0, dd, ss, pp);
  if (two && nt > 0) {
    stage_in(0, 0, dd, ss, pp);
    next_index(1, dd, ss, pp);
  }
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    const int buf = two ? i & 1 : 0;
    const int staged = two ? i + 1 : i;
    if (staged < nt) {
      stage_in(staged, two ? buf ^ 1 : 0, dd, ss, pp);
      next_index(staged + 1, dd, ss, pp);  // in flight during this tile
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
    float* s_p2 = s_p1 + T * ldh;    // [T][ldp] xb[src], then pre2, then u2
    float* s_g2 = s_p2 + T * ldp;    // [T][ldd] gout[dst], then g_pre2
    const int* t_dst = s_dst + buf * T;
    const int* t_edge = s_edge + buf * T;
    const int p0 = e_lo + i * T, rows = min(T, e_hi - p0);
    // The edge of tile row t (t < rows).
    auto edge_of = [&](int t) {
      if constexpr (ORDER) return t_edge[t]; else return p0 + t;
    };
    // The products and the row phases take the rows before prows (`rows`
    // rounded up to the products' groups of 4 rows); a warp whose rows are
    // all past it skips the row phases.  Rows past `rows` are zero inputs
    // (added in exactly) or never read.
    const int prows = (rows + 3) & ~3;
    const bool warp_rows = warp * WR < prows;

    // ---- pre1 = b1 + xa[dst] + xb[src] + ef . W1e, over xa[dst] ----------
    tile_gemm<false>(
        s_ef, lde, s_w1e, ldh, de, h, prows,
        [&](int t, int c) { return s_b1[c] + s_p1[t * ldh + c] + s_p2[t * ldp + c]; },
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
        [&](int t, int c, float v) { s_p2[t * ldp + c] = v; });
    __syncthreads();

    // ---- norm 2 and its backward from gout[dst]: g_pre2 in place -----------
    if (warp_rows) {
      float* u = s_p2 + row_t * ldp;
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
        float* row = g_rows + static_cast<size_t>(edge_of(row_t)) * h;
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
            gef[static_cast<size_t>(edge_of(t)) * de + c] = in_range(t_dst[t], n) ? v : 0.f;
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
    for (int w = 0; w < kEdgeThreads / 32; ++w) v += s_red[w * 4 + tid];
    out[de * h + h + h * d2 + d2 + tid] = v;
  }

  // ---- gef of the edges at positions from off[n] on: zero ----------------
  float4* gef4 = reinterpret_cast<float4*>(gef);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(p_end) * ce + blockIdx.x * blockDim.x + tid;
       i < static_cast<size_t>(e) * ce; i += stride) {
    if constexpr (ORDER) {
      const size_t q = i / ce;
      gef4[static_cast<size_t>(order[q]) * ce + (i - q * ce)] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      gef4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// How bwd_edge_kernel runs at these widths on this device: edges a
// tile T (32, else 16, else 8: the largest whose shared memory fits a
// block, with two input stages where they fit, else one), edge blocks (one
// per SM, no more than there are tiles) and weight-gradient items a thread;
// widths whose 8-edge tiles would overflow it are refused.
struct BwdPlan {
  int tile, stages, blocks, items;
  size_t smem;
};

// The current device's shared memory a block may opt into, and its SMs.
cudaError_t device_limits(int& smem_max, int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// Edge blocks for `tiles` tiles: one per SM, no more than there are tiles.
int edge_blocks(int tiles, int sms) { return tiles < 1 ? 1 : (tiles < sms ? tiles : sms); }

cudaError_t bwd_plan(int e, int de, int h, int d2, bool order, BwdPlan& p) {
  int smem_max = 0, sms = 0;
  const cudaError_t err = device_limits(smem_max, sms);
  if (err != cudaSuccess) return err;
  for (int t = 32; t >= 8; t /= 2)
    for (int stages = 2; stages >= 1; --stages) {
      const size_t smem = bwd_smem(de, h, d2, t, stages, order);
      if (smem > static_cast<size_t>(smem_max)) continue;
      p = {t, stages, edge_blocks((e + t - 1) / t, sms), bwd_xty_items(de, h, d2), smem};
      return cudaSuccess;
    }
  return cudaErrorInvalidValue;
}

// One launch of bwd_edge_kernel as planned (p) over `graphs` graphs; xa,
// xb [n, h] the node products of graph g at g * x_gs, order the receiver
// order (ORDER) or null; the other arrays [graphs, ...], contiguous.
template <int T, int DWI, bool ORDER>
cudaError_t launch_bwd_edges(const BwdPlan& p, const float* xa, const float* xb,
                             const float* ef, const int* src, const int* dst,
                             const int* order, const int* off,
                             const float* w1e, const float* b1,
                             const float* w2, const float* b2,
                             const float* scal, const float* gout, float slope,
                             float* gef, float* rows, float* part, int n,
                             int e, int de, int h, int d2, int graphs,
                             long long x_gs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bwd_edge_kernel<T, DWI, ORDER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  bwd_edge_kernel<T, DWI, ORDER><<<dim3(p.blocks, graphs), kEdgeThreads, p.smem, stream>>>(
      xa, xb, ef, src, dst, order, off, w1e, b1, w2, b2, scal, gout, slope,
      gef, rows, part, n, e, de, h, d2, x_gs, p.stages);
  return cudaGetLastError();
}

// bwd_edge_kernel at the plan's tile and weight-gradient items.
template <bool ORDER>
cudaError_t bwd_edges(const BwdPlan& p, const float* xa, const float* xb,
                      const float* ef, const int* src, const int* dst,
                      const int* order, const int* off, const float* w1e,
                      const float* b1, const float* w2, const float* b2,
                      const float* scal, const float* gout, float slope,
                      float* gef, float* rows, float* part, int n, int e,
                      int de, int h, int d2, int graphs, long long x_gs,
                      cudaStream_t stream) {
  const int dwi = p.items > 1 ? 2 : 1;
#define MP_BWD(T, W)                                                         \
  if (p.tile == T && dwi == W)                                               \
    return launch_bwd_edges<T, W, ORDER>(p, xa, xb, ef, src, dst, order, off, \
                                         w1e, b1, w2, b2, scal, gout, slope, \
                                         gef, rows, part, n, e, de, h, d2,   \
                                         graphs, x_gs, stream);
  MP_BWD(32, 1) MP_BWD(32, 2) MP_BWD(16, 1) MP_BWD(16, 2) MP_BWD(8, 1) MP_BWD(8, 2)
#undef MP_BWD
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Forward, per edge tile (fwd_edge_kernel).  The backward's runs: block b
// of G takes the positions [b off[n] / G, (b+1) off[n] / G) of the
// receiver order in tiles of T (the last one short), so a hub's or a
// degree-20 node's segment spreads over tiles and blocks like any other
// run.  W1e, W2, b1 and b2 sit in shared memory for the whole block; each
// tile's ef rows and gathered xa[dst], xb[src] rows arrive by cp.async,
// the next tile's while this one computes (two stages when they fit, else
// one).  Per tile:
//
//   pre1 = b1 + xa + xb + ef . W1e     tile_gemm, in place over xa
//   a1   = lrelu(cnorm(pre1))          row phase, in place
//   pre2 = b2 + a1 . W2                tile_gemm
//   msgs[p] = lrelu(cnorm(pre2))       row phase, to the row's edge p
//
// A position whose destination is out of range (a dropped CSR edge)
// computes its message from zero rows, and segsum_kernel never reads it.
// This is the f32 forward; fwd_edge_kernel_bf16 (below) the bf16 one.

// Dynamic shared memory of fwd_edge_kernel with tiles of T edges and
// `stages` input stages.
size_t fwd_smem(int de, int h, int d2, int T, int stages) {
  const size_t lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  return sizeof(float) *
         (de * ldh + h * ldd + stages * T * (lde + 2 * ldh) + T * ldd + h + d2);
}

// T edges a tile, RT = kEdgeThreads / T threads a row in the row phases;
// ORDER: position q is the edge order[q] (else the edge q, and order is not
// read).
template <int T, bool ORDER>
__global__ void __launch_bounds__(kEdgeThreads, 1)
fwd_edge_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ ef, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ order,
                const int* __restrict__ off, const float* __restrict__ w1e,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ scal,
                float slope, float* __restrict__ msgs, int n, int e, int de,
                int h, int d2, long long x_gs, int stages) {
  constexpr int RT = kEdgeThreads / T, WR = 32 / RT;
  static_assert(RT * T == kEdgeThreads && RT >= 8 && RT <= 32, "8 to 32 threads a row");
  extern __shared__ __align__(16) float smem[];
  const int lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;
  const int stage_f = T * (lde + 2 * ldh);
  // blockIdx.y = g, the graph: its slices of every per-graph array (xa, xb
  // at g * x_gs).
  {
    const size_t g = blockIdx.y;
    xa += g * x_gs;
    xb += g * x_gs;
    ef += g * e * de;
    src += g * e;
    dst += g * e;
    if constexpr (ORDER) order += g * e;
    off += g * (n + 1);
    msgs += g * e * d2;
  }
  float* s_w1e = smem;                       // [de][ldh]
  float* s_w2 = s_w1e + de * ldh;            // [h][ldd]
  float* s_stage = s_w2 + h * ldd;           // [stages] of ef | xa | xb
  float* s_p2 = s_stage + stages * stage_f;  // [T][ldd] pre2, then the messages
  float* s_b1 = s_p2 + T * ldd;              // [h]
  float* s_b2 = s_b1 + h;                    // [d2]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q_end = off[n];
  const int q_lo = static_cast<int>(static_cast<long long>(blockIdx.x) * q_end / gridDim.x);
  const int q_hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * q_end / gridDim.x);
  const int tiles = (q_hi - q_lo + T - 1) / T;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  const float inv_h = 1.0f / static_cast<float>(h);
  const float inv_d2 = 1.0f / static_cast<float>(d2);
  const float inv_hm1 = 1.0f / static_cast<float>(h > 1 ? h - 1 : 1);
  const float inv_d2m1 = 1.0f / static_cast<float>(d2 > 1 ? d2 - 1 : 1);

  // The weights, once per block (their copies join the first tile's group).
  const int ch = h >> 2, cd = d2 >> 2;
  for (int i = tid; i < de * ch; i += blockDim.x) {
    const int r = i / ch, c = (i - r * ch) * 4;
    cp_async16(s_w1e + r * ldh + c, w1e + static_cast<size_t>(r) * h + c, true);
  }
  for (int i = tid; i < h * cd; i += blockDim.x) {
    const int r = i / cd, c = (i - r * cd) * 4;
    cp_async16(s_w2 + r * ldd + c, w2 + static_cast<size_t>(r) * d2 + c, true);
  }
  for (int i = tid; i < h; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = tid; i < d2; i += blockDim.x) s_b2[i] = b2[i];

  // Row t of a tile belongs to the RT threads tid / RT = t; `part` says
  // which of its float4s a thread copies and reduces.
  const int row_t = tid / RT, part = tid % RT;
  auto edge_at = [&](int q) {
    if constexpr (ORDER) return order[q]; else return q;
  };
  // The edge of this thread's row in tile i (-1 past the run) and its two
  // ends, read a tile ahead of its staging.
  auto fetch = [&](int i, int& pp, int& dd, int& ss) {
    const int q = q_lo + i * T + row_t;
    pp = q < q_hi ? edge_at(q) : -1;
    dd = pp >= 0 ? dst[pp] : n;
    ss = pp >= 0 ? src[pp] : n;
  };
  // Stage `buf` gets this row's ef row, xa[dst] and xb[src] (zero past the
  // run or for an index out of range).
  auto stage_rows = [&](int buf, int pp, int dd, int ss) {
    float* st = s_stage + buf * stage_f;
    const bool live = pp >= 0, keep = in_range(dd, n), sok = in_range(ss, n);
    const float* g_ef = ef + static_cast<size_t>(live ? pp : 0) * de;
    const float* g_xa = xa + static_cast<size_t>(keep ? dd : 0) * h;
    const float* g_xb = xb + static_cast<size_t>(sok ? ss : 0) * h;
    float* r_ef = st + row_t * lde;
    float* r_xa = st + T * lde + row_t * ldh;
    float* r_xb = r_xa + T * ldh;
    for (int c = 4 * part; c < de; c += 4 * RT) cp_async16(r_ef + c, g_ef + c, live);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(r_xa + c, g_xa + c, keep);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(r_xb + c, g_xb + c, sok);
  };
  // lrelu(gamma * u * inv_den + beta).
  auto act = [&](float u, float inv_den, float gamma, float beta) {
    const float y = gamma * (u * inv_den) + beta;
    return y >= 0.f ? y : slope * y;
  };

  const bool two = stages == 2;
  int pp = -1, dd = n, ss = n;  // the next tile to stage
  fetch(0, pp, dd, ss);
  if (two && tiles > 0) {
    stage_rows(0, pp, dd, ss);
    fetch(1, pp, dd, ss);
  }
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    const int buf = two ? i & 1 : 0;
    const int next = two ? i + 1 : i;
    if (next < tiles) {
      stage_rows(two ? buf ^ 1 : 0, pp, dd, ss);
      fetch(next + 1, pp, dd, ss);  // in flight during this tile
    }
    cp_async_commit();
    if (two)
      cp_async_wait<1>();  // every group but the next tile's has landed
    else
      cp_async_wait<0>();
    __syncthreads();
    float* st = s_stage + buf * stage_f;
    float* t_ef = st;              // [T][lde]
    float* t_p1 = st + T * lde;    // [T][ldh] xa[dst], then pre1, then a1
    float* t_xb = t_p1 + T * ldh;  // [T][ldh] xb[src]
    const int q0 = q_lo + i * T, rows = min(T, q_hi - q0);
    // The products and the row phases take the rows before prows (`rows`
    // rounded up to the products' groups of 4 rows: zero inputs past
    // `rows`); a warp whose rows are all past it skips the row phases.
    const int prows = (rows + 3) & ~3;
    const bool warp_rows = warp * WR < prows;
    const int edge = row_t < rows ? edge_at(q0 + row_t) : 0;  // for the store

    // ---- pre1 = b1 + xa[dst] + xb[src] + ef . W1e, over xa[dst] ----------
    tile_gemm<false>(
        t_ef, lde, s_w1e, ldh, de, h, prows,
        [&](int t, int c) { return s_b1[c] + t_p1[t * ldh + c] + t_xb[t * ldh + c]; },
        [&](int t, int c, float v) { t_p1[t * ldh + c] = v; });
    __syncthreads();

    // ---- a1 = lrelu(cnorm(pre1)) in place -----------------------------------
    if (warp_rows) {
      float* u1 = t_p1 + row_t * ldh;
      const float sd1 = centre_row<RT>(u1, h, part, inv_h, inv_hm1);
      const float inv1 = 1.0f / (sd1 + kEps);
      for (int c = 4 * part; c < h; c += 4 * RT) {
        const float4 v = ld4(u1 + c);
        *reinterpret_cast<float4*>(u1 + c) =
            make_float4(act(v.x, inv1, g1, be1), act(v.y, inv1, g1, be1),
                        act(v.z, inv1, g1, be1), act(v.w, inv1, g1, be1));
      }
    }
    __syncthreads();

    // ---- pre2 = b2 + a1 . W2 ------------------------------------------------
    tile_gemm<false>(
        t_p1, ldh, s_w2, ldd, h, d2, prows, [&](int, int c) { return s_b2[c]; },
        [&](int t, int c, float v) { s_p2[t * ldd + c] = v; });
    __syncthreads();

    // ---- the message, lrelu(cnorm(pre2)), to msgs[edge] -------------------
    if (warp_rows) {
      float* u2 = s_p2 + row_t * ldd;
      const float sd2 = centre_row<RT>(u2, d2, part, inv_d2, inv_d2m1);
      const float inv2 = 1.0f / (sd2 + kEps);
      if (row_t < rows) {
        float* out = msgs + static_cast<size_t>(edge) * d2;
        for (int c = 4 * part; c < d2; c += 4 * RT) {
          const float4 v = ld4(u2 + c);
          *reinterpret_cast<float4*>(out + c) =
              make_float4(act(v.x, inv2, g2, be2), act(v.y, inv2, g2, be2),
                          act(v.z, inv2, g2, be2), act(v.w, inv2, g2, be2));
        }
      }
    }
    // No barrier: the next tile writes s_p2 and this stage after two.
  }
  cp_async_wait<0>();  // a block without tiles still has the weights in flight
}

// ---------------------------------------------------------------------------
// Forward with the TPU kernels' bf16 operands (fwd_edge_kernel_bf16), on
// the bf16 tensor cores.  The TPU kernels' bf16 mode (ops/pallas/fused_mp.py
// and csr_mp.py with bf16=True) feeds the MXU bf16 operands and accumulates
// in f32 (preferred_element_type=float32); here the same products run on
// Hopper's bf16 tensor cores: mma.sync.m16n8k16 (bf16 x bf16 + f32), the
// operands loaded by ldmatrix from bf16 copies in shared memory.  The
// runs, tiles, stages, row phases and the message store are those of
// fwd_edge_kernel; per tile of T edges:
//
//   pre1 = b1 + xa + xb + bf16(ef) . bf16(W1e)   mma_tile, f32, over xa
//   a1   = bf16(lrelu(cnorm(pre1)))              row phase, into a bf16 tile
//                                                over xb (layer 2's A)
//   pre2 = b2 + a1 . bf16(W2)                    mma_tile, f32, over xa
//   msgs[p] = bf16(lrelu(cnorm(pre2)))           row phase, as f32
//
// with ROUND_X xa and xb rounded to bf16 as they are added (the fused round
// rounds its products x . W1r, x . W1s; the CSR round rounds x before its
// node products instead).  The rounding points are the TPU kernels' (b1,
// b2, the norms and every sum stay f32); a product of two bf16 values is
// exact in f32, and the tensor cores add the products in another order
// than a loop of FMAs: the same function up to summation order.  W1e and
// W2 are rounded once per block as they are copied in (round_into: batched
// loads, while the first tile's copies fly), each tile's ef rows land as
// f32 (cp.async) and each thread rounds the floats it copied into the bf16
// A tile of layer 1, so no barrier is added.  The products' depths are
// padded to 16 and their widths to 8 with zeros (exact: the function does
// not change), so De, H and D2 need only be multiples of 4.  Fixed k
// order, no atomics: two launches give the same bits.  A message depends
// on its own row and on T alone (T sets the threads that sum a row in the
// norms), so a batch gives each graph's one-graph bits.  What bounds it in
// practice: a block's fixed cost (the launch, the weights, the first
// tile's chain of index loads and gathers: ~6 us of the edge kernel's ~19
// at the main path's ~70 edges a block), then the products' and norms'
// latencies (scripts/fwd_tile_ablation.py's bf16_no_* variants, PERF.md);
// fwd_plan puts two blocks on an SM where they fit, to hide them.

using bf16 = __nv_bfloat16;

// v rounded to bf16 (nearest even, as JAX's astype) and back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four floats as four bf16 (nearest even) at p, 8-byte aligned.
__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// A row-major f32 matrix [rows_src][cols_src] in global memory (rows
// ld_src apart; 16-byte aligned, ld_src and cols_src multiples of 4)
// rounded into the bf16 tile [rows][ld] of shared memory, zero in rows
// [rows_src, rows) and columns [cols_src, cols) (cols a multiple of 4), by
// `threads` threads; each
// thread keeps kStageLoads 16-byte loads in flight before it stores any,
// so that a block pays one load latency a batch and not one a load.
constexpr int kStageLoads = 8;

template <int threads>
__device__ __forceinline__ void round_into(bf16* dst, int ld, int rows, int cols,
                                           const float* src, int ld_src,
                                           int rows_src, int cols_src) {
  const int c4 = cols >> 2, items = rows * c4;
  for (int i0 = threadIdx.x; i0 < items; i0 += threads * kStageLoads) {
    float4 v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = i0 + j * threads, r = i / c4, c = (i - r * c4) * 4;
      v[j] = i < items && r < rows_src && c < cols_src
                 ? ld4(src + static_cast<size_t>(r) * ld_src + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = i0 + j * threads, r = i / c4, c = (i - r * c4) * 4;
      if (i < items) store_bf16x4(dst + r * ld + c, v[j]);
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes); r[j] gets the j-th matrix's
// elements (l / 4, 2 (l % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// The same, transposed: r[j] gets the j-th matrix's elements (2 (l % 4) +
// {0, 1}, l / 4).
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// Two matrices, transposed (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)) : "memory");
}

// c += A . B for one 16 x 16 A fragment (a) and one 16 x 8 B fragment (b0,
// b1) of bf16, in f32: c[0], c[1] at row l / 4, columns 2 (l % 4) + {0, 1};
// c[2], c[3] at row l / 4 + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out(t, c) = init(t, c) + sum over k < K of A[t][k] W[k][c] for the rows t
// of the first ceil(rows / 16) m-tiles of 16 and the N columns c (N a
// multiple of 8, K of 16), from bf16 operands in shared memory (A row-major
// [.][lda], W row-major [K][ldw], both leading dimensions 8 mod 16: the
// ldmatrix rows fall on distinct banks), in f32 on the tensor cores.  A
// warp's item is one m-tile by up to kMmaTiles n-tiles of 8 columns: its
// A fragment once a k-step, the B fragments two n-tiles an ldmatrix (.trans:
// W is k-major).  k in order.  init(t, c) and store(t, c, v) take the
// column pair (c, c + 1) as a float2; rows from `rows` up to the m-tile's
// end are computed and stored too (the caller's shared rows hold them).
constexpr int kMmaTiles = 4;

template <typename Init, typename Store>
__device__ __forceinline__ void mma_tile(const bf16* A, int lda, const bf16* W,
                                         int ldw, int K, int N, int rows,
                                         Init init, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int nt = N >> 3, chunks = (nt + kMmaTiles - 1) / kMmaTiles;
  const int items = ((rows + 15) >> 4) * chunks;
  for (int it = warp; it < items; it += kEdgeThreads / 32) {
    const int m0 = (it / chunks) * 16, t0 = (it % chunks) * kMmaTiles;
    const int nc = min(kMmaTiles, nt - t0);  // n-tiles of this item
    float acc[kMmaTiles][4];
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) {
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (j < nc) {
        lo = init(m0 + g, (t0 + j) * 8 + c2);
        hi = init(m0 + g + 8, (t0 + j) * 8 + c2);
      }
      acc[j][0] = lo.x;
      acc[j][1] = lo.y;
      acc[j][2] = hi.x;
      acc[j][3] = hi.y;
    }
    // Lane l's rows: A row m0 + l % 16 at k + 8 (l / 16); W row k + l % 16
    // at column 8 (t0 + j) + 8 (l / 16).
    const bf16* a_row = A + (m0 + (lane & 15)) * lda + 8 * (lane >> 4);
    const bf16* w_row = W + (lane & 15) * ldw + 8 * t0 + 8 * (lane >> 4);
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, a_row + k0);
      const bf16* w_k = w_row + k0 * ldw;
#pragma unroll
      for (int j = 0; j < kMmaTiles; j += 2) {
        if (j + 1 < nc) {
          unsigned b[4];
          ldsm_x4_t(b, w_k + 8 * j);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        } else if (j < nc) {
          unsigned b[2];
          ldsm_x2_t(b, w_k + 8 * j);
          mma_bf16(acc[j], a, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j)
      if (j < nc) {
        store(m0 + g, (t0 + j) * 8 + c2, make_float2(acc[j][0], acc[j][1]));
        store(m0 + g + 8, (t0 + j) * 8 + c2, make_float2(acc[j][2], acc[j][3]));
      }
  }
}

// Leading dimensions: f32 rows 8 mod 32 floats (a half-warp's float2s of
// an mma fragment, 4 rows by 8 floats, fall on distinct banks), bf16 rows
// 8 mod 16 elements (ldmatrix's 8 rows of 16 bytes do); each at least w.
__host__ __device__ __forceinline__ int ld_f32(int w) { return w + (40 - w % 32) % 32; }
__host__ __device__ __forceinline__ int ld_b16(int w) { return w + (24 - w % 16) % 16; }
__host__ __device__ __forceinline__ int pad_to(int w, int m) { return (w + m - 1) / m * m; }

// The dynamic shared memory of fwd_edge_kernel_bf16 with tiles of T edges
// and `stages` input stages, in bytes from its start (each part a multiple
// of 16 bytes):
//   w1 [k1][ldw1], w2 [k2][ldw2]        bf16 weights, zero-padded
//   b1 [n1], b2 [n2]                    f32 biases, zero-padded
//   land [T][ldl]                       f32: the ef rows as they land
//   stages x { a1 [T][lda1]             bf16: the ef rows, layer 1's A
//              xa [T][ldx]              f32: xa[dst], then pre1, then pre2
//              xb [T][ldx] }            f32: xb[src], then layer 2's A
//                                       (bf16 [T][lda2])
struct Bf16Smem {
  int k1, n1, k2, n2;           // layer 1's depth and width, layer 2's (padded)
  int ldw1, ldw2, lda1, lda2, ldx, ldl;
  size_t w2, b1, b2, land, stage, a1, xa, xb, bytes;

  __host__ __device__ Bf16Smem(int de, int h, int d2, int T, int stages)
      : k1(pad_to(de, 16)), n1(pad_to(h, 8)), k2(pad_to(h, 16)), n2(pad_to(d2, 8)),
        ldw1(ld_b16(n1)), ldw2(ld_b16(n2)), lda1(ld_b16(k1)), lda2(ld_b16(k2)),
        ldx(ld_f32(h > d2 ? h : d2)), ldl(de + kPad) {
    const size_t xb_bytes = static_cast<size_t>(T) *
        (4 * ldx > 2 * lda2 ? 4 * ldx : 2 * lda2);
    w2 = 2 * static_cast<size_t>(k1) * ldw1;
    b1 = w2 + 2 * static_cast<size_t>(k2) * ldw2;
    b2 = b1 + 4 * static_cast<size_t>(n1);
    land = b2 + 4 * static_cast<size_t>(n2);
    a1 = land + 4 * static_cast<size_t>(T) * ldl;  // stage 0's; stage s at + s * stage
    xa = a1 + 2 * static_cast<size_t>(T) * lda1;
    xb = xa + 4 * static_cast<size_t>(T) * ldx;
    stage = xb + xb_bytes - a1;
    bytes = a1 + stages * stage;
  }
};

// T edges a tile (16 to 128, a multiple of 16), RT = kEdgeThreads / T
// threads a row in the row phases; ORDER: position q is the edge order[q];
// ROUND_X: xa and xb are rounded to bf16 (the fused round).  Registers for
// two blocks an SM (fwd_plan).
template <int T, bool ORDER, bool ROUND_X>
__global__ void __launch_bounds__(kEdgeThreads, 2)
fwd_edge_kernel_bf16(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ ef, const int* __restrict__ src,
                     const int* __restrict__ dst, const int* __restrict__ order,
                     const int* __restrict__ off, const float* __restrict__ w1e,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ scal,
                     float slope, float* __restrict__ msgs, int n, int e, int de,
                     int h, int d2, long long x_gs, int stages) {
  constexpr int RT = kEdgeThreads / T, WR = 32 / RT;
  static_assert(RT * T == kEdgeThreads && T % 16 == 0 && RT >= 2, "16 to 128 edges a tile");
  extern __shared__ __align__(16) float smem[];
  {  // blockIdx.y = g, the graph: its slices (xa, xb at g * x_gs)
    const size_t g = blockIdx.y;
    xa += g * x_gs;
    xb += g * x_gs;
    ef += g * e * de;
    src += g * e;
    dst += g * e;
    if constexpr (ORDER) order += g * e;
    off += g * (n + 1);
    msgs += g * e * d2;
  }
  const Bf16Smem S(de, h, d2, T, stages);
  char* base = reinterpret_cast<char*>(smem);
  bf16* s_w1 = reinterpret_cast<bf16*>(base);
  bf16* s_w2 = reinterpret_cast<bf16*>(base + S.w2);
  float* s_b1 = reinterpret_cast<float*>(base + S.b1);
  float* s_b2 = reinterpret_cast<float*>(base + S.b2);
  float* s_land = reinterpret_cast<float*>(base + S.land);
  const int ldx = S.ldx;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q_end = off[n];
  const int q_lo = static_cast<int>(static_cast<long long>(blockIdx.x) * q_end / gridDim.x);
  const int q_hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * q_end / gridDim.x);
  const int ntile = (q_hi - q_lo + T - 1) / T;
  const float g1 = scal[0], be1 = scal[1], g2 = scal[2], be2 = scal[3];
  const float inv_h = 1.0f / static_cast<float>(h);
  const float inv_d2 = 1.0f / static_cast<float>(d2);
  const float inv_hm1 = 1.0f / static_cast<float>(h > 1 ? h - 1 : 1);
  const float inv_d2m1 = 1.0f / static_cast<float>(d2 > 1 ? d2 - 1 : 1);

  const int row_t = tid / RT, part = tid % RT;
  auto a1_of = [&](int buf) { return reinterpret_cast<bf16*>(base + S.a1 + buf * S.stage); };
  auto xa_of = [&](int buf) { return reinterpret_cast<float*>(base + S.xa + buf * S.stage); };
  auto xb_of = [&](int buf) { return reinterpret_cast<float*>(base + S.xb + buf * S.stage); };
  auto edge_at = [&](int q) {
    if constexpr (ORDER) return order[q]; else return q;
  };
  // The edge of this thread's row in tile i (-1 past the run) and its two
  // ends, read a tile ahead of its staging.
  auto fetch = [&](int i, int& pp, int& dd, int& ss) {
    const int q = q_lo + i * T + row_t;
    pp = q < q_hi ? edge_at(q) : -1;
    dd = pp >= 0 ? dst[pp] : n;
    ss = pp >= 0 ? src[pp] : n;
  };
  // The row's ef row to the landing rows, xa[dst] and xb[src] to stage
  // `buf` (zero past the run or for an index out of range).
  auto stage_in = [&](int buf, int pp, int dd, int ss) {
    const bool live = pp >= 0, keep = in_range(dd, n), sok = in_range(ss, n);
    const float* g_ef = ef + static_cast<size_t>(live ? pp : 0) * de;
    const float* g_xa = xa + static_cast<size_t>(keep ? dd : 0) * h;
    const float* g_xb = xb + static_cast<size_t>(sok ? ss : 0) * h;
    float* l_ef = s_land + row_t * S.ldl;
    float* l_xa = xa_of(buf) + row_t * ldx;
    float* l_xb = xb_of(buf) + row_t * ldx;
    for (int c = 4 * part; c < de; c += 4 * RT) cp_async16(l_ef + c, g_ef + c, live);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(l_xa + c, g_xa + c, keep);
    for (int c = 4 * part; c < h; c += 4 * RT) cp_async16(l_xb + c, g_xb + c, sok);
  };
  // The floats this thread copied to the landing rows, once landed, rounded
  // into stage `buf`'s A tile (zero past De).
  auto round_ef = [&](int buf) {
    const float* l_ef = s_land + row_t * S.ldl;
    bf16* a = a1_of(buf) + row_t * S.lda1;
    for (int c = 4 * part; c < S.k1; c += 4 * RT)
      store_bf16x4(a + c, c < de ? ld4(l_ef + c) : make_float4(0.f, 0.f, 0.f, 0.f));
  };
  // lrelu(gamma * u * inv_den + beta) of four values.
  auto act4 = [&](float4 u, float inv_den, float gamma, float beta) {
    const float v[4] = {u.x, u.y, u.z, u.w};
    float y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[k] = gamma * (v[k] * inv_den) + beta;
      y[k] = y[k] >= 0.f ? y[k] : slope * y[k];
    }
    return make_float4(y[0], y[1], y[2], y[3]);
  };

  const bool two = stages == 2;
  int pp = -1, dd = n, ss = n;  // the next tile to stage
  // Tile 0's rows fly while the weights come in, with either stage count.
  fetch(0, pp, dd, ss);
  if (ntile > 0) {
    stage_in(0, pp, dd, ss);
    fetch(1, pp, dd, ss);
  }
  cp_async_commit();
  // The weights and biases, rounded once per block while they fly; zero in
  // the padding.
  for (int i = tid; i < S.n1; i += kEdgeThreads) s_b1[i] = i < h ? b1[i] : 0.f;
  for (int i = tid; i < S.n2; i += kEdgeThreads) s_b2[i] = i < d2 ? b2[i] : 0.f;
  round_into<kEdgeThreads>(s_w1, S.ldw1, S.k1, S.n1, w1e, h, de, h);
  round_into<kEdgeThreads>(s_w2, S.ldw2, S.k2, S.n2, w2, d2, h, d2);
  if (ntile > 0) {
    cp_async_wait<0>();
    round_ef(0);
  }

  for (int it = 0; it < ntile; ++it) {
    const int buf = two ? it & 1 : 0;
    if (two) {  // the next tile's rows fly during this one
      if (it + 1 < ntile) {
        stage_in(buf ^ 1, pp, dd, ss);
        fetch(it + 2, pp, dd, ss);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else if (it > 0) {  // this tile's rows (tile 0's came in above)
      stage_in(0, pp, dd, ss);
      fetch(it + 1, pp, dd, ss);
      cp_async_commit();
      cp_async_wait<0>();
      round_ef(0);
    }
    __syncthreads();
    const bf16* t_a1 = a1_of(buf);
    float* t_xa = xa_of(buf);  // xa[dst], then pre1 and a1's norm, then pre2
    const float* t_xb = xb_of(buf);
    bf16* t_a2 = reinterpret_cast<bf16*>(xb_of(buf));  // layer 2's A, over xb
    const int q0 = q_lo + it * T, rows = min(T, q_hi - q0);
    const bool warp_rows = warp * WR < rows;  // the row phases' warps
    const int edge = row_t < rows ? edge_at(q0 + row_t) : 0;  // for the store

    // ---- pre1 = b1 + xa[dst] + xb[src] + ef . W1e, over xa[dst] ----------
    mma_tile(t_a1, S.lda1, s_w1, S.ldw1, S.k1, S.n1, rows,
             [&](int t, int c) {
               if (c >= h) return make_float2(0.f, 0.f);
               const float2 a = *reinterpret_cast<const float2*>(t_xa + t * ldx + c);
               const float2 b = *reinterpret_cast<const float2*>(t_xb + t * ldx + c);
               if constexpr (ROUND_X)
                 return make_float2(s_b1[c] + round_bf16(a.x) + round_bf16(b.x),
                                    s_b1[c + 1] + round_bf16(a.y) + round_bf16(b.y));
               else
                 return make_float2(s_b1[c] + a.x + b.x, s_b1[c + 1] + a.y + b.y);
             },
             [&](int t, int c, float2 v) {
               *reinterpret_cast<float2*>(t_xa + t * ldx + c) = v;
             });
    __syncthreads();

    // ---- a1 = bf16(lrelu(cnorm(pre1))) into layer 2's A tile -------------
    if (warp_rows) {
      float* u = t_xa + row_t * ldx;
      const float sd_a = centre_row<RT>(u, h, part, inv_h, inv_hm1);
      const float inv_a = 1.0f / (sd_a + kEps);
      bf16* a2 = t_a2 + row_t * S.lda2;
      for (int c = 4 * part; c < S.k2; c += 4 * RT)
        store_bf16x4(a2 + c, c < h ? act4(ld4(u + c), inv_a, g1, be1)
                                   : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();

    // ---- pre2 = b2 + a1 . W2, over pre1 ----------------------------------
    mma_tile(t_a2, S.lda2, s_w2, S.ldw2, S.k2, S.n2, rows,
             [&](int, int c) { return make_float2(s_b2[c], s_b2[c + 1]); },
             [&](int t, int c, float2 v) {
               *reinterpret_cast<float2*>(t_xa + t * ldx + c) = v;
             });
    __syncthreads();

    // ---- the message, bf16(lrelu(cnorm(pre2))), to msgs[edge] -------------
    if (warp_rows) {
      float* u = t_xa + row_t * ldx;
      const float sd_b = centre_row<RT>(u, d2, part, inv_d2, inv_d2m1);
      const float inv_b = 1.0f / (sd_b + kEps);
      if (row_t < rows) {
        float* out = msgs + static_cast<size_t>(edge) * d2;
        for (int c = 4 * part; c < d2; c += 4 * RT) {
          const float4 y = act4(ld4(u + c), inv_b, g2, be2);
          *reinterpret_cast<float4*>(out + c) = make_float4(
              round_bf16(y.x), round_bf16(y.y), round_bf16(y.z), round_bf16(y.w));
        }
      }
    }
    // The next tile's ef rows, landed, into its A tile.
    if (two && it + 1 < ntile) {
      cp_async_wait<0>();
      round_ef(buf ^ 1);
    }
    __syncthreads();  // this stage's rows are free for the tile after next
  }
}

// How a forward edge kernel runs at these widths on this device: edges a
// tile, input stages and edge blocks (one per SM, no more than there are
// tiles).  fwd_edge_kernel (f32): 32, else 16, else 8 edges, the largest
// whose shared memory fits a block, with two input stages where they fit,
// else one.  fwd_edge_kernel_bf16: kBf16Tile edges in one input stage
// where two such blocks fit an SM's shared memory (its registers do:
// __launch_bounds__), else in two stages where they fit a block, else
// one; widths whose tile fits no block are refused.  A block's fixed cost
// (launch, weights, the first tile's gathers: 5-6 us) outweighs its tiles
// at the main path's ~70 edges a block, so two blocks an SM, each hiding
// the other's latencies, beat larger tiles and a second stage at B = 8:
// 32-edge tiles in one stage 74 us, two stages 117, 64 and 128 edges
// 106-110 (the edge kernel at the shipped widths, scripts/
// fwd_tile_ablation.py, PERF.md).
struct FwdPlan {
  int tile, stages, blocks;
  size_t smem;
};

constexpr int kBf16Tile = 32;  // fwd_edge_kernel_bf16's edges a tile

cudaError_t fwd_plan(int e, int de, int h, int d2, bool bf16, FwdPlan& p) {
  int smem_max = 0, sms = 0;
  cudaError_t err = device_limits(smem_max, sms);
  if (err != cudaSuccess) return err;
  if (bf16) {
    int dev = 0, per_sm = 0, reserved = 0;  // an SM's shared memory, a block's reserve
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      dev)) != cudaSuccess)
      return err;
    const int tile = kBf16Tile, blocks = edge_blocks((e + tile - 1) / tile, sms);
    const size_t one = Bf16Smem(de, h, d2, tile, 1).bytes;
    if (2 * (one + reserved) <= static_cast<size_t>(per_sm)) {  // two blocks an SM
      p = {tile, 1, blocks, one};
      return cudaSuccess;
    }
    for (int st = 2; st >= 1; --st) {
      const size_t bytes = Bf16Smem(de, h, d2, tile, st).bytes;
      if (bytes > static_cast<size_t>(smem_max)) continue;
      p = {tile, st, blocks, bytes};
      return cudaSuccess;
    }
    return cudaErrorInvalidValue;
  }
  for (int t = 32; t >= 8; t /= 2)
    for (int s = 2; s >= 1; --s) {
      const size_t smem = fwd_smem(de, h, d2, t, s);
      if (smem > static_cast<size_t>(smem_max)) continue;
      p = {t, s, edge_blocks((e + t - 1) / t, sms), smem};
      return cudaSuccess;
    }
  return cudaErrorInvalidValue;
}

// fwd_plan's tile, input stages and blocks into plan[3]; the forwards'
// plan entry points (fused_mp_forward_plan, csr_mp_forward_plan and their
// _bf16 twins).
cudaError_t fwd_plan_out(int e, int de, int h, int d2, bool bf16, int* plan) {
  FwdPlan p;
  const cudaError_t err = fwd_plan(e, de, h, d2, bf16, p);
  if (err != cudaSuccess) return err;
  plan[0] = p.tile;
  plan[1] = p.stages;
  plan[2] = p.blocks;
  return cudaSuccess;
}

// One launch of a forward edge kernel (fwd_edge_kernel<T, ORDER> or
// fwd_edge_kernel_bf16<T, ORDER, ROUND_X>) as planned, over `graphs` graphs.
template <typename Kernel>
cudaError_t launch_fwd_edges(Kernel kernel, const FwdPlan& p, const float* xa,
                             const float* xb, const float* ef, const int* src,
                             const int* dst, const int* order, const int* off,
                             const float* w1e, const float* b1,
                             const float* w2, const float* b2,
                             const float* scal, float slope, float* msgs,
                             int n, int e, int de, int h, int d2, int graphs,
                             long long x_gs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.blocks, graphs), kEdgeThreads, p.smem, stream>>>(
      xa, xb, ef, src, dst, order, off, w1e, b1, w2, b2, scal, slope, msgs, n,
      e, de, h, d2, x_gs, p.stages);
  return cudaGetLastError();
}

// A forward round's two launches over `graphs` graphs, graph g's node
// products xa, xb [n, h] at g * x_gs: the edge kernel at the plan's tile
// (fwd_edge_kernel, or with BF16 fwd_edge_kernel_bf16; messages into msgs
// [graphs, e, d2]), then segsum_kernel (agg [graphs, n, d2], every row
// written).  order: the receiver order (ORDER) or null; the index arrays
// [graphs, ...].  xa, xb, ef, w1e, w2 and msgs are 16-byte aligned.
// ROUND_X (with BF16): xa and xb are rounded to bf16.
template <bool ORDER, bool ROUND_X, bool BF16>
cudaError_t fwd_round(const FwdPlan& p, const float* xa, const float* xb,
                      const float* ef, const int* src, const int* dst,
                      const int* order, const int* off, const float* w1e,
                      const float* b1, const float* w2, const float* b2,
                      const float* scal, float slope, float* msgs, float* agg,
                      int n, int e, int de, int h, int d2, int graphs,
                      long long x_gs, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
#define MP_FWD_KERNEL(T, K)                                                    \
  if (p.tile == T)                                                             \
    err = launch_fwd_edges(K, p, xa, xb, ef, src, dst, order, off, w1e, b1,    \
                           w2, b2, scal, slope, msgs, n, e, de, h, d2, graphs, \
                           x_gs, stream);
#define MP_FWD(T) MP_FWD_KERNEL(T, (fwd_edge_kernel<T, ORDER>))
#define MP_FWD_BF16(T) MP_FWD_KERNEL(T, (fwd_edge_kernel_bf16<T, ORDER, ROUND_X>))
  if constexpr (BF16) {
    MP_FWD_BF16(kBf16Tile)
  } else {
    MP_FWD(32) MP_FWD(16) MP_FWD(8)
  }
#undef MP_FWD_BF16
#undef MP_FWD
#undef MP_FWD_KERNEL
  if (err != cudaSuccess) return err;
  segsum_kernel<<<dim3((n + kWarps - 1) / kWarps, 1, graphs), kWarps * 32, 0, stream>>>(
      msgs, dst, order, nullptr, off, nullptr, n, e, d2,
      static_cast<long long>(e) * d2, static_cast<long long>(n) * d2, agg);
  return cudaGetLastError();
}

// The partial of one edge block, in floats: dW1e | db1 | dW2 | db2 | 4.
long long edge_partial(int de, int h, int d2) {
  return static_cast<long long>(edge_partial_floats(de, h, d2));
}

// The final sums, in fixed order.  The edge blocks' partials
// [dW1e | db1 | dW2 | db2 | dg1 dbe1 dg2 dbe2]: a block takes kReduceOut
// outputs, kReduceGroups groups of its threads each sum a contiguous run
// of the partials in block order, then the group sums are added in group
// order (dw after the node part).  Then one thread an output: dw's node
// part [x^T dxa | x^T dxb], the sum of the node splits in order, and dx,
// the sum of the 2 x dx_splits partials of dxa W1r^T, dxb W1s^T in order.
// The fused round has no node part (d = 0): dw is the edge part alone.
// Over `graphs` graphs: `blocks` counts every graph's edge blocks, their
// partials in graph order; the node partials are [graphs, 2, splits, d, h]
// (dw sums them graph by graph, each graph's splits in order) and [graphs,
// 2, dx_splits, n, d] (dx [graphs, n, d], one graph's each).
__global__ void __launch_bounds__(kReduceThreads)
bwd_reduce_kernel(const float* __restrict__ p_w1rs, int splits,
                  const float* __restrict__ p_edge, int blocks,
                  const float* __restrict__ p_dx, int dx_splits, int n, int d,
                  int de, int h, int d2, int graphs, float* __restrict__ dw,
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
    float v = 0.f;
    for (int g = 0; g < graphs; ++g) {
      const float* p = p_w1rs + ((2LL * g + b) * splits) * dh + (i - b * dh);
      for (int z = 0; z < splits; ++z) v += p[z * dh];
    }
    dw[i] = v;
  } else if (i < node + graphs * ndx) {
    const long long k = i - node, g = k / ndx;
    const float* p = p_dx + g * 2 * dx_splits * ndx + (k - g * ndx);
    float v = 0.f;
    for (int z = 0; z < 2 * dx_splits; ++z) v += p[z * ndx];
    dx[k] = v;
  }
}

// The widths both rounds' kernels take: de, h, d2 positive multiples of 4
// (rows are moved as float4s).  How wide they may be is the plans' to say
// (fwd_plan, bwd_plan): the widths whose 8-edge tiles fit the shared
// memory of a block.
bool edge_widths_ok(int n, int e, int de, int h, int d2) {
  return n > 0 && e >= 0 && de > 0 && h > 0 && d2 > 0 && de % 4 == 0 &&
         h % 4 == 0 && d2 % 4 == 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace
