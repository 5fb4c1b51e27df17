// One GATv2 round for Hopper (sm_90a): forward (gat_mp_forward) and
// backward (gat_mp_backward) of the attention and the aggregate of
// models/gat.GATv2Conv, whose plain version is GATv2Conv._attend.
//
// It replaces no TPU kernel: the JAX package's GAT path reaches no Pallas
// kernel.  It was added because the plain round writes and reads again
// several [E, H*C] intermediates (the gathered projections, the edge
// projection, the leaky ReLU's input and output, the weighted messages)
// and their gradients: at the published widths (H*C = 512) that was most
// of a GATv2 training step.  For every edge e = (j -> i) that takes part
// (its mask set, both ends in [0, N)) and every head h:
//
//   z     = xl[j] + xr[i] + ef[e] . We^T + be          [H*C]   xl = W_l x, xr = W_r x
//   lg    = att_h . lrelu(z_h, slope)                  [H]
//   a     = exp(lg - m_ih) / max(l_ih, 1e-16)          m_ih, l_ih: the largest lg and the
//   out_i = bias + sum_j a xl_j (head by head)                     sum of exp(lg - m) over i's edges
//
// xl and xr are node products left to torch (F.linear), as the plain path
// computes them; We ([H*C, De], the layout of torch's Linear weight), be,
// att and bias are the conv's.  No [E, H*C] tensor is written: the edge
// projection, its leaky ReLU and its gradient live in shared memory, tile
// by tile.  The per-edge scratch is 8 H floats and H*C/32 words an edge.
//
// Order.  Both tile kernels walk the kept edges in receiver order: the
// receiver order of ops/fused_mp.fused_layout (a stable argsort; the edges
// that take no part carry the sentinel N and sort last), made once a step
// and shared by the 7 rounds.  Block b of G (a graph's blocks, the SMs
// over the graphs: one block of 16 warps an SM, since We alone takes 139
// KB of the 227 KB a block may hold) owns the receivers whose segment
// starts in its share [b K / G, (b+1) K / G) of the K kept positions, so
// that no receiver's segment is cut between blocks, and walks their
// positions in tiles of 32 edges.  A tile's edges, senders and receivers
// are loaded two and one tile ahead (RowPipe); its rows (ef, xl[j],
// xr[i]) by every thread, a few float4s' loads in flight before their
// stores (stage_tile).
//
// Forward (one launch).  Per tile: z as a block-level register tile on
// shared-memory operands (tile_gemm of csrc/mp_edge_tile.cuh, We read
// transposed from the one copy), lrelu in place, one thread a (edge, head)
// takes the logit into a scratch lg [E, H] by position.  Then one warp a
// receiver, 32 positions at a time, the logits staged in shared memory:
// lane h takes head h's largest logit, then its sum of exponentials in
// order of position (the plain path's two passes, not an online softmax:
// the same sums as the plain path's and no rescaling), and the lanes, 32
// channels apart, sum a xl_j over the positions in order.  It writes out
// [N, H*C] (bias for a receiver without edges) and the statistics [N, 2,
// H] = (m, l), which the backward reads.
//
// Backward (three launches).  (1) gat_bwd_edge_kernel, over the forward's
// blocks and tiles: per receiver D_ih = g_i . (out_i - bias) (= sum_j a
// (g_i . xl_j), so the softmax's backward needs one pass); per tile, while
// staging, da = g_i . xl_j of each (edge, head) (the lanes that load a
// head's float4s sum them); it recomputes z (the same tile_gemm: the same
// bits as the forward's), the logit and a from (m, l), and dlg = a (da -
// D_ih); per column (a thread's) ds = dlg att (z > 0 ? 1 : slope), the
// cotangent of z, over z in shared memory, summed over each receiver's
// edges into d(xr) [N, H*C] (each row written once), with dbe += ds and
// datt += dlg lrelu(z); dWe += ds^T ef (tile_xty: a thread's first 8 x 4
// item in registers, the others added into the block's partial in memory);
// d(ef) = ds . We for every edge (zero for one that takes no part), four
// lanes an item, each over a quarter of H*C, added by shuffles.  By edge
// it writes a, dlg and the signs of z (one bit a channel).  (2)
// gat_reduce_kernel: the blocks' partials (dWe, dbe, datt, dbias) in
// block order.  (3) gat_send_kernel: d(xl_j)
// = the sum over j's outgoing edges, in the sender order of the same
// layout, of a g_i + dlg att (sign ? 1 : slope): one warp a sender, 32
// edges' scratch staged at a time, the rows of g gathered (L2-resident).
// The edge projection is not recomputed there: its signs are all that
// d(xl) needs of it.  The two alternatives cost more, by the card's
// numbers at the published widths (PERF.md): a second pass in sender
// order that recomputes z repeats the edge projection (~150 us of the
// forward's ~390 at B = 8); a [E, H*C] scratch of ds + a g summed by
// sender moves 2 KB an edge twice (~90 us of HBM time alone), where this
// pass takes ~60 us from 128 bytes an edge.
//
// dbias, the sum of g over every row, joins the partials (a thread a
// column); dW_l, dW_r and dx are left to torch.
//
// Fixed-order sums, no atomics: every output is written once by one
// thread or warp, summing in a fixed order (positions, tiles, blocks in
// order), so two launches give the same bits.  Edges that take no part
// weigh 0, as in the plain path, whose masked softmax gives them weight 0:
// skipping them is the same function.  f32 on the FMA units throughout
// (no TF32), as the configuration states.
//
// What bounds it.  At the published widths (De = 64, H*C = 512) an edge's
// forward costs 2 * De * H*C = 65 536 FLOP in the edge projection, the
// backward three times the products: f32 FMAs on paper (67 TFLOP/s: ~74
// and ~217 us for the C calls' least work at B = 8, ~71 000 edges).  In
// practice shared-memory bandwidth bounds tile_gemm and tile_xty (a 4 x 4
// register tile loads 0.5 floats a FMA), and the latency of the gathered
// rows with one block an SM (PERF.md: each phase's share by ablation).
//
// A batch of graphs: every array [B, ...] (contiguous, graph g's slice at g
// times one graph's size), a grid dimension over the graphs.

#include "mp_edge_tile.cuh"

namespace {

constexpr int kGatThreads = 512;   // threads of a tile block (16 warps)
constexpr int kGatTile = 32;       // edges a tile
constexpr int kGatMaxCols = 512;   // widest H*C: a thread owns one column (column phase)
constexpr int kGatMaxJ = kGatMaxCols / 32;  // channels a lane of a receiver's warp
constexpr int kSendWarps = 8;      // warps (senders) a block of gat_send_kernel
constexpr float kDenMin = 1e-16f;  // ops/segment.segment_softmax's clamp of the denominator

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

// The first v in [0, n] with off[v] >= p (off nondecreasing, off[n] >= p).
__device__ int first_at_or_after(const int* off, int n, int p) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] >= p) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// Block b's receivers [v0, v1): those whose segment starts in its share
// of the kept positions [0, off[n]); the last block also takes the empty
// receivers past them.
__device__ void block_receivers(const int* off, int n, int& v0, int& v1) {
  const long long k = off[n], b = blockIdx.x, g = gridDim.x;
  v0 = first_at_or_after(off, n, static_cast<int>(b * k / g));
  v1 = b + 1 == g ? n : first_at_or_after(off, n, static_cast<int>((b + 1) * k / g));
}

// The shared memory of a tile block, in floats then ints.
struct GatSmem {
  float *w, *ef, *z, *att, *be, *dl, *st;
  int *edge, *src, *dst;
};

// Floats of a warp's buffers in the forward's softmax phase: the senders
// of 32 positions, their weights by head, and each head's largest logit
// and denominator.
__host__ __device__ __forceinline__ int softmax_floats(int heads) {
  return 32 + 32 * heads + 2 * heads;
}

size_t gat_smem_bytes(int de, int hc, int heads) {
  const size_t lw = de + kPad, lz = hc + kPad;
  const size_t floats = hc * lw + kGatTile * (lw + lz) + 2 * hc + 4 * kGatTile * heads;
  const size_t tiles = floats * sizeof(float) + 3 * kGatTile * sizeof(int);
  const size_t warps = sizeof(float) * (kGatThreads / 32) * softmax_floats(heads);
  return tiles > warps ? tiles : warps;
}

__device__ GatSmem gat_smem(float* smem, int de, int hc, int heads) {
  const int lw = de + kPad, lz = hc + kPad;
  GatSmem s;
  s.w = smem;                          // [hc][lw]: We as torch stores it
  s.ef = s.w + hc * lw;                // [T][lw]
  s.z = s.ef + kGatTile * lw;          // [T][lz]: z, s or ds of the tile's edges
  s.att = s.z + kGatTile * lz;         // [hc]
  s.be = s.att + hc;                   // [hc]
  s.dl = s.be + hc;                    // [T][heads] (backward: da, then dlg)
  s.st = s.dl + kGatTile * heads;      // [T][heads][3] (backward: m, l, D of the row's receiver)
  s.edge = reinterpret_cast<int*>(s.st + 3 * kGatTile * heads);  // [T]
  s.src = s.edge + kGatTile;           // [T]
  s.dst = s.src + kGatTile;            // [T]
  return s;
}

// We, att and be into shared memory, once a block.
__device__ void load_weights(const GatSmem& s, const float* we, const float* att,
                             const float* be, int de, int hc) {
  const int lw = de + kPad, c4 = de >> 2;
#pragma unroll 8
  for (int i = threadIdx.x; i < hc * c4; i += blockDim.x) {
    const int r = i / c4, k = (i - r * c4) * 4;
    *reinterpret_cast<float4*>(s.w + r * lw + k) = ld4(we + static_cast<size_t>(r) * de + k);
  }
  for (int i = threadIdx.x; i < hc; i += blockDim.x) {
    s.att[i] = att[i];
    s.be[i] = be[i];
  }
}

// The rows of the tiles, for the first T threads of a block: a tile's
// edges are loaded two tiles ahead and their senders and receivers one
// tile ahead, so that no tile waits on its indices.  advance() publishes
// the tile at q0 to shared memory (rows past q_end: edge -1).
struct RowPipe {
  int p_cur = -1, j_cur = 0, r_cur = 0, p_next = -1;

  __device__ void start(const int* order, const int* src, const int* dst, int q,
                        int q_end) {
    const int t = threadIdx.x;
    if (t < kGatTile) {
      p_cur = q + t < q_end ? order[q + t] : -1;
      if (p_cur >= 0) {
        j_cur = src[p_cur];
        r_cur = dst[p_cur];
      }
      p_next = q + kGatTile + t < q_end ? order[q + kGatTile + t] : -1;
    }
  }

  __device__ void advance(const GatSmem& s, const int* order, const int* src,
                          const int* dst, int q0, int q_end) {
    const int t = threadIdx.x;
    if (t < kGatTile) {
      s.edge[t] = p_cur;
      s.src[t] = j_cur;
      s.dst[t] = r_cur;
      int j = 0, r = 0;
      if (p_next >= 0) {
        j = src[p_next];
        r = dst[p_next];
      }
      const int q = q0 + 2 * kGatTile + t;
      p_cur = p_next;
      j_cur = j;
      r_cur = r;
      p_next = q < q_end ? order[q] : -1;
    }
  }
};

// The tile of `rows` rows whose edges, senders and receivers RowPipe has
// published: each row's ef row and xl[j] + xr[i] + be (xl's row zero for a
// sender outside [0, n)); with gout (the backward), also da = gout[i] .
// xl[j] of each (row, head) into s.dl, summed over a head's float4s by the
// C/4 neighbouring lanes that load them (a power of two up to 32: whole
// lane groups, since the rows' float4s run on across lanes), and the
// receiver's m, l (stats) and D (dsc, written by this block) into s.st.
// Each thread loads the rows of U of its float4s before it stores any.
// Starts and ends with the block synchronised.
template <int U>
__device__ void stage_tile(const GatSmem& s, const float* __restrict__ xl,
                           const float* __restrict__ xr, const float* __restrict__ ef,
                           const float* __restrict__ gout, const float* __restrict__ stats,
                           const float* dsc, int rows, int n, int de, int hc,
                           int heads) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();
  const int lw = de + kPad, lz = hc + kPad, c4 = de >> 2, h4 = hc >> 2;
  for (int i = tid; i < rows * c4; i += blockDim.x) {
    const int t = i / c4, k = (i - t * c4) * 4;
    *reinterpret_cast<float4*>(s.ef + t * lw + k) =
        ld4(ef + static_cast<size_t>(s.edge[t]) * de + k);
  }
  if (gout)
    for (int i = tid; i < rows * heads; i += blockDim.x) {
      const int t = i / heads, h = i - t * heads;
      const size_t r = s.dst[t];
      s.st[3 * i] = stats[2 * r * heads + h];
      s.st[3 * i + 1] = stats[(2 * r + 1) * heads + h];
      s.st[3 * i + 2] = dsc[r * heads + h];
    }
  const int c = hc / heads, group = c >> 2, total = rows * h4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = tid & ~31; b0 < total; b0 += U * blockDim.x) {
    float4 vr[U], vl[U], vg[U];
    int row[U], col[U];
    bool on[U], ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = b0 + u * blockDim.x + lane;
      on[u] = i < total;
      row[u] = on[u] ? i / h4 : 0;
      col[u] = on[u] ? (i - row[u] * h4) * 4 : 0;
      const int j = s.src[row[u]], r = s.dst[row[u]];
      ok[u] = on[u] && in_range(j, n);
      vr[u] = on[u] ? ld4(xr + static_cast<size_t>(r) * hc + col[u]) : zero;
      vl[u] = ok[u] ? ld4(xl + static_cast<size_t>(j) * hc + col[u]) : zero;
      vg[u] = ok[u] && gout ? ld4(gout + static_cast<size_t>(r) * hc + col[u]) : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (on[u]) {
        const float4 b = ld4(s.be + col[u]);
        float4 a = vr[u];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
        a.x += vl[u].x;
        a.y += vl[u].y;
        a.z += vl[u].z;
        a.w += vl[u].w;
        *reinterpret_cast<float4*>(s.z + row[u] * lz + col[u]) = a;
      }
      if (gout) {  // every lane of the warp: inactive ones hold 0
        float da = fmaf(vg[u].w, vl[u].w,
                        fmaf(vg[u].z, vl[u].z, fmaf(vg[u].y, vl[u].y, vg[u].x * vl[u].x)));
        for (int o = group >> 1; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
        if (on[u] && (lane & (group - 1)) == 0) s.dl[row[u] * heads + col[u] / c] = da;
      }
    }
  }
  __syncthreads();
}

// z of the staged tile: s.z (xl[j] + xr[i] + be) += ef . We^T, then stored
// through `act` (tile_gemm: We read transposed from its one copy).
template <typename Act>
__device__ __forceinline__ void edge_projection(const GatSmem& s, int rows, int de,
                                                int hc, Act act) {
  const int lw = de + kPad, lz = hc + kPad;
  float* z = s.z;
  tile_gemm<true>(
      s.ef, lw, s.w, lw, de, hc, rows, [&](int t, int c) { return z[t * lz + c]; },
      [&](int t, int c, float v) {
        if (t < rows) z[t * lz + c] = act(v);
      });
}

// The logit of head h of a staged row whose activations s are at zs.
__device__ __forceinline__ float head_logit(const float* zs, const float* att, int c,
                                            bool activate, float slope) {
  float acc = 0.f;
  for (int k = 0; k < c; k += 4) {
    const float4 v = ld4(zs + k), a = ld4(att + k);
    acc = fmaf(a.x, activate ? lrelu(v.x, slope) : v.x, acc);
    acc = fmaf(a.y, activate ? lrelu(v.y, slope) : v.y, acc);
    acc = fmaf(a.z, activate ? lrelu(v.z, slope) : v.z, acc);
    acc = fmaf(a.w, activate ? lrelu(v.w, slope) : v.w, acc);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Forward.  blockIdx.y = g, the graph.  lg: the logits by position [e, heads].
__global__ void __launch_bounds__(kGatThreads, 1)
gat_fwd_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
               const float* __restrict__ ef, const int* __restrict__ src,
               const int* __restrict__ dst, const int* __restrict__ order,
               const int* __restrict__ off, const float* __restrict__ we,
               const float* __restrict__ be, const float* __restrict__ att,
               const float* __restrict__ bias, float slope,
               float* __restrict__ out, float* __restrict__ stats, float* lg,
               int n, int e, int de, int hc, int heads) {
  {
    const size_t g = blockIdx.y;
    xl += g * n * hc;
    xr += g * n * hc;
    out += g * n * hc;
    ef += g * e * de;
    src += g * e;
    dst += g * e;
    order += g * e;
    off += g * (n + 1);
    stats += g * n * 2 * heads;
    lg += g * e * heads;
  }
  extern __shared__ __align__(16) float smem[];
  const GatSmem s = gat_smem(smem, de, hc, heads);
  const int tid = threadIdx.x, lz = hc + kPad, c = hc / heads;
  load_weights(s, we, att, be, de, hc);
  int v0, v1;
  block_receivers(off, n, v0, v1);
  const int q_end = off[v1];

  // (1) The logits of the block's positions, tile by tile.
  RowPipe rows_ahead;
  rows_ahead.start(order, src, dst, off[v0], q_end);
  for (int q0 = off[v0]; q0 < q_end; q0 += kGatTile) {
    const int rows = min(kGatTile, q_end - q0);
    rows_ahead.advance(s, order, src, dst, q0, q_end);
    stage_tile<4>(s, xl, xr, ef, nullptr, nullptr, nullptr, rows, n, de, hc, heads);
    edge_projection(s, rows, de, hc, [&](float v) { return lrelu(v, slope); });
    __syncthreads();
    for (int i = tid; i < rows * heads; i += blockDim.x) {
      const int t = i / heads, h = i - t * heads;
      lg[static_cast<size_t>(q0 + t) * heads + h] =
          head_logit(s.z + t * lz + h * c, s.att + h * c, c, false, slope);
    }
    __syncthreads();
  }

  // (2) One warp a receiver, in the shared memory the tiles used, 32
  // positions at a time, their logits staged by the lanes together: each
  // head's largest logit, then its sum of exponentials (lane h: head h, in
  // order of position), then the positions' senders and weights and the
  // weighted sum of xl_j (lanes 32 channels apart, positions in order).
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nj = hc >> 5;
  int* s_j = reinterpret_cast<int*>(smem) + warp * softmax_floats(heads);
  float* s_wt = reinterpret_cast<float*>(s_j + 32);  // [32][heads]
  float* s_m = s_wt + 32 * heads;                    // [heads]
  float* s_den = s_m + heads;                        // [heads]
  const int cshift = 31 - __clz(c);  // C is a power of two: channel ch is head ch >> cshift
  for (int v = v0 + warp; v < v1; v += blockDim.x >> 5) {
    const int lo = off[v], hi = off[v + 1];
    // the chunk's logits [cnt][heads], contiguous in lg
    auto stage_logits = [&](int q0, int cnt) {
      __syncwarp();
      for (int idx = lane; idx < cnt * heads; idx += 32)
        s_wt[idx] = lg[static_cast<size_t>(q0) * heads + idx];
      __syncwarp();
    };
    float mx = -INFINITY, sum = 0.f;
    for (int q0 = lo; q0 < hi; q0 += 32) {
      const int cnt = min(32, hi - q0);
      stage_logits(q0, cnt);
      if (lane < heads)
        for (int t = 0; t < cnt; ++t) mx = fmaxf(mx, s_wt[t * heads + lane]);
    }
    for (int q0 = lo; q0 < hi; q0 += 32) {
      const int cnt = min(32, hi - q0);
      if (hi - lo > 32) stage_logits(q0, cnt);  // else still staged
      if (lane < heads)
        for (int t = 0; t < cnt; ++t) sum += expf(s_wt[t * heads + lane] - mx);
    }
    if (lane < heads) {
      s_m[lane] = hi > lo ? mx : 0.f;
      s_den[lane] = sum;
    }
    __syncwarp();
    float acc[kGatMaxJ];
#pragma unroll
    for (int i = 0; i < kGatMaxJ; ++i) acc[i] = 0.f;
    for (int q0 = lo; q0 < hi; q0 += 32) {
      const int cnt = min(32, hi - q0);
      if (hi - lo > 32) stage_logits(q0, cnt);  // else still staged
      if (lane < cnt) {
        const int j = src[order[q0 + lane]];
        s_j[lane] = in_range(j, n) ? j : -1;
      }
      for (int idx = lane; idx < cnt * heads; idx += 32) {
        const int h = idx % heads;
        s_wt[idx] = expf(s_wt[idx] - s_m[h]) / fmaxf(s_den[h], kDenMin);
      }
      __syncwarp();
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const int j = s_j[t];
        if (j < 0) continue;
        const float* row = xl + static_cast<size_t>(j) * hc;
#pragma unroll
        for (int i = 0; i < kGatMaxJ; ++i) {
          if (i < nj) {
            const int ch = lane + 32 * i;
            acc[i] = fmaf(s_wt[t * heads + (ch >> cshift)], row[ch], acc[i]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kGatMaxJ; ++i) {
      if (i < nj) {
        const int ch = lane + 32 * i;
        out[static_cast<size_t>(v) * hc + ch] = acc[i] + bias[ch];
      }
    }
    if (lane < heads) {
      stats[(static_cast<size_t>(v) * 2) * heads + lane] = s_m[lane];
      stats[(static_cast<size_t>(v) * 2 + 1) * heads + lane] = s_den[lane];
    }
    __syncwarp();
  }
}

// d(ef) = ds . We of the staged tile (ds in s.z), for every row's edge:
// 4 x 4 register items (as tile_gemm), each over a quarter of H*C by the
// four lanes 8 apart that share it (a quarter-warp a quarter: its 8 items
// read one row group of ds and 128 contiguous bytes of We), the quarters
// added by two shuffles in a fixed order.  Needs (T/4) * De/4 items at
// most 8 a warp.
__device__ void edge_feature_grad(const GatSmem& s, float* gef, int rows, int de,
                                  int hc) {
  const int lw = de + kPad, lz = hc + kPad, ncg = de >> 2, lane = threadIdx.x & 31;
  const int it = (threadIdx.x >> 5) * 8 + (lane & 7), quarter = hc >> 2;
  const int items = ((rows + 3) >> 2) * ncg;
  const int cg = it % ncg, r0 = (it / ncg) * 4;
  float acc[4][4] = {};
  if (it < items) {
    const int k0 = (lane >> 3) * quarter;
#pragma unroll 2
    for (int k = k0; k < k0 + quarter; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(s.z + (r0 + i) * lz + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ld4(s.w + (k + q) * lw + cg * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // (q0 + q1) + (q2 + q3), on every lane of the four
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
    }
  if (lane < 8 && it < items)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < rows)
        *reinterpret_cast<float4*>(gef + static_cast<size_t>(s.edge[r0 + i]) * de + cg * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// Backward (1).  blockIdx.y = g.  dsc [n, heads]: D of the block's
// receivers; sa, sdl [e, heads] and sbits [e, hc/32]: by edge; part: this
// block's partial [hc * de (dWe) | hc (dbe) | hc (datt) | hc (dbias)].  dWe's
// product (tile_xty, hc/8 * de/4 items of 8 x 4) keeps a thread's first
// item in registers and adds the others into the partial in memory, each
// thread to its own elements, tile by tile.
__global__ void __launch_bounds__(kGatThreads, 1)
gat_bwd_edge_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
                    const float* __restrict__ ef, const int* __restrict__ src,
                    const int* __restrict__ dst, const int* __restrict__ order,
                    const int* __restrict__ off, const float* __restrict__ we,
                    const float* __restrict__ be, const float* __restrict__ att,
                    const float* __restrict__ bias, const float* __restrict__ out,
                    const float* __restrict__ gout, const float* __restrict__ stats,
                    float slope, float* dsc, float* __restrict__ sa,
                    float* __restrict__ sdl, unsigned* __restrict__ sbits,
                    float* __restrict__ gef, float* __restrict__ dxr,
                    float* __restrict__ part, int n, int e, int de, int hc,
                    int heads) {
  const int words = hc >> 5;
  {
    const size_t g = blockIdx.y;
    xl += g * n * hc;
    xr += g * n * hc;
    out += g * n * hc;
    gout += g * n * hc;
    dxr += g * n * hc;
    ef += g * e * de;
    gef += g * e * de;
    src += g * e;
    dst += g * e;
    order += g * e;
    off += g * (n + 1);
    stats += g * n * 2 * heads;
    dsc += g * n * heads;
    sa += g * e * heads;
    sdl += g * e * heads;
    sbits += g * e * words;
    part += (g * gridDim.x + blockIdx.x) * (static_cast<size_t>(hc) * de + 3 * hc);
  }
  extern __shared__ __align__(16) float smem[];
  const GatSmem s = gat_smem(smem, de, hc, heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lz = hc + kPad, lw = de + kPad, c = hc / heads, c4 = de >> 2;
  load_weights(s, we, att, be, de, hc);
  int v0, v1;
  block_receivers(off, n, v0, v1);
  const int q_end = off[v1];

  // D of each receiver (lanes 32 channels apart, a head's sum over them
  // in a fixed tree), and d(xr) of those without edges.
  {
    const int nj = hc >> 5;
    const int cshift = 31 - __clz(c);
    for (int v = v0 + warp; v < v1; v += blockDim.x >> 5) {
      const size_t row = static_cast<size_t>(v) * hc;
      float prod[kGatMaxJ];
#pragma unroll
      for (int i = 0; i < kGatMaxJ; ++i) {
        const int ch = lane + 32 * i;
        prod[i] = i < nj ? gout[row + ch] * (out[row + ch] - bias[ch]) : 0.f;
      }
      for (int h = 0; h < heads; ++h) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kGatMaxJ; ++i) d += (lane + 32 * i) >> cshift == h ? prod[i] : 0.f;
        d = warp_sum(d);
        if (lane == 0) dsc[static_cast<size_t>(v) * heads + h] = d;
      }
      if (off[v] == off[v + 1])
        for (int i = lane; i < hc; i += 32) dxr[row + i] = 0.f;
    }
  }
  // dbias over the block's receivers (a thread a column, receivers in order).
  if (tid < hc) {
    float db = 0.f;
#pragma unroll 8
    for (int v = v0; v < v1; ++v) db += gout[static_cast<size_t>(v) * hc + tid];
    part[static_cast<size_t>(hc) * de + 2 * hc + tid] = db;
  }
  // d(ef) of the edges that take no part (positions from off[n] on): zero.
  {
    const long long k = off[n], rest = e - k, b = blockIdx.x, G = gridDim.x;
    const int lo = static_cast<int>(k + b * rest / G), hi = static_cast<int>(k + (b + 1) * rest / G);
    for (int i = tid; i < (hi - lo) * c4; i += blockDim.x) {
      const int t = i / c4, kk = (i - t * c4) * 4;
      *reinterpret_cast<float4*>(gef + static_cast<size_t>(order[lo + t]) * de + kk) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  // A thread's columns (column phase): tid and tid + 256.
  float datt = 0.f, dbe = 0.f, dx = 0.f;
  int cur = -1;
  float wacc[1][8][4] = {};
  zero_spill<1>(part, hc, de);

  RowPipe rows_ahead;
  rows_ahead.start(order, src, dst, off[v0], q_end);
  for (int q0 = off[v0]; q0 < q_end; q0 += kGatTile) {
    const int rows = min(kGatTile, q_end - q0);
    rows_ahead.advance(s, order, src, dst, q0, q_end);
    stage_tile<2>(s, xl, xr, ef, gout, stats, dsc, rows, n, de, hc, heads);
    edge_projection(s, rows, de, hc, [](float v) { return v; });
    __syncthreads();
    // Per (edge, head): the logit, a and dlg from da (staged in s.dl).
    for (int i = tid; i < rows * heads; i += blockDim.x) {
      const int t = i / heads, h = i - t * heads;
      const int p = s.edge[t];
      const float lgt = head_logit(s.z + t * lz + h * c, s.att + h * c, c, true, slope);
      const float a = expf(lgt - s.st[3 * i]) / fmaxf(s.st[3 * i + 1], kDenMin);
      const float dl = a * (s.dl[i] - s.st[3 * i + 2]);
      s.dl[i] = dl;
      sa[static_cast<size_t>(p) * heads + h] = a;
      sdl[static_cast<size_t>(p) * heads + h] = dl;
    }
    __syncthreads();
    // Per column (a thread's: tid): ds over z, datt, dbe, the signs, d(xr)
    // by receiver.
    {
      const int col = tid;
      if (col < hc) {  // whole warps: hc is a multiple of 32
        const int h = col / c;
        const float at = s.att[col];
        for (int t0 = 0; t0 < rows; t0 += 4) {  // four rows' loads, then their sums in order
          float z[4], dl[4];
          int r[4], p[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = t0 + u < rows ? t0 + u : t0;
            z[u] = s.z[t * lz + col];
            dl[u] = s.dl[t * heads + h];
            r[u] = s.dst[t];
            p[u] = s.edge[t];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (t0 + u >= rows) break;
            const bool pos = z[u] > 0.f;
            datt = fmaf(dl[u], pos ? z[u] : z[u] * slope, datt);
            const float ds = dl[u] * at * (pos ? 1.f : slope);
            s.z[(t0 + u) * lz + col] = ds;
            dbe += ds;
            const unsigned bits = __ballot_sync(0xffffffffu, pos);
            if (lane == 0) sbits[static_cast<size_t>(p[u]) * words + (col >> 5)] = bits;
            if (r[u] != cur) {
              if (cur >= 0) dxr[static_cast<size_t>(cur) * hc + col] = dx;
              dx = 0.f;
              cur = r[u];
            }
            dx += ds;
          }
        }
      }
    }
    __syncthreads();
    // dWe += ds^T ef and d(ef) = ds . We.
    tile_xty<1>(wacc, part, s.z, lz, s.ef, lw, hc, de, rows);
    edge_feature_grad(s, gef, rows, de, hc);
    __syncthreads();
  }

  if (tid < hc) {
    if (cur >= 0) dxr[static_cast<size_t>(cur) * hc + tid] = dx;
    part[static_cast<size_t>(hc) * de + tid] = dbe;
    part[static_cast<size_t>(hc) * de + hc + tid] = datt;
  }
  store_xty<1>(wacc, part, hc, de);
}

// Backward (2): out[i] = the sum over the blocks' partials, in block order.
__global__ void gat_reduce_kernel(const float* __restrict__ part, int blocks, int len,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += part[static_cast<size_t>(b) * len + i];
  out[i] = acc;
}

// Backward (3): d(xl_j) over j's outgoing edges in sender order; one warp
// a sender, lanes 32 channels apart.  32 edges at a time, the lanes load
// the edges' receivers, a, dlg and sign words into the warp's shared
// memory together; then the edges in order.  blockIdx.y = g.
__host__ __device__ __forceinline__ int send_floats(int heads, int words) {
  return 64 + 64 * heads + 32 * words;
}

__global__ void __launch_bounds__(kSendWarps * 32)
gat_send_kernel(const float* __restrict__ gout, const float* __restrict__ att,
                const int* __restrict__ dst, const int* __restrict__ send_order,
                const int* __restrict__ send_off, const float* __restrict__ sa,
                const float* __restrict__ sdl, const unsigned* __restrict__ sbits,
                float slope, float* __restrict__ dxl, int n, int e, int hc,
                int heads) {
  extern __shared__ __align__(16) float smem[];
  const int words = hc >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_att = smem;  // [hc]
  for (int i = threadIdx.x; i < hc; i += blockDim.x) s_att[i] = att[i];
  __syncthreads();
  const int v = blockIdx.x * kSendWarps + warp;
  if (v >= n) return;
  {
    const size_t g = blockIdx.y;
    gout += g * n * hc;
    dxl += g * n * hc;
    dst += g * e;
    send_order += g * e;
    send_off += g * (n + 1);
    sa += g * e * heads;
    sdl += g * e * heads;
    sbits += g * e * words;
  }
  int* s_p = reinterpret_cast<int*>(smem + hc) + warp * send_floats(heads, words);
  int* s_r = s_p + 32;
  float* s_a = reinterpret_cast<float*>(s_r + 32);  // [32][heads]
  float* s_d = s_a + 32 * heads;                    // [32][heads]
  unsigned* s_b = reinterpret_cast<unsigned*>(s_d + 32 * heads);  // [32][words]
  const int nj = words, cshift = 31 - __clz(hc / heads);  // channel ch: head ch >> cshift
  float acc[kGatMaxJ];
#pragma unroll
  for (int i = 0; i < kGatMaxJ; ++i) acc[i] = 0.f;
  const int lo = send_off[v], hi = send_off[v + 1];
  for (int q0 = lo; q0 < hi; q0 += 32) {
    const int cnt = min(32, hi - q0);
    int p = -1, r = 0;
    if (lane < cnt) {
      p = send_order[q0 + lane];
      r = dst[p];
      if (!in_range(r, n)) p = -1;
    }
    s_p[lane] = p;
    s_r[lane] = r;
    __syncwarp();
    for (int idx = lane; idx < cnt * heads; idx += 32) {
      const int t = idx / heads, pe = s_p[t];
      const size_t at_e = static_cast<size_t>(pe) * heads + (idx - t * heads);
      s_a[idx] = pe >= 0 ? sa[at_e] : 0.f;
      s_d[idx] = pe >= 0 ? sdl[at_e] : 0.f;
    }
    for (int idx = lane; idx < cnt * words; idx += 32) {
      const int t = idx / words, pe = s_p[t];
      s_b[idx] = pe >= 0 ? sbits[static_cast<size_t>(pe) * words + (idx - t * words)] : 0u;
    }
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      if (s_p[t] < 0) continue;
      const float* gr = gout + static_cast<size_t>(s_r[t]) * hc;
#pragma unroll
      for (int i = 0; i < kGatMaxJ; ++i) {
        if (i < nj) {
          const int ch = lane + 32 * i;
          const float lk = (s_b[t * words + i] >> lane) & 1u ? 1.f : slope;
          const int h = ch >> cshift;
          acc[i] += s_a[t * heads + h] * gr[ch] + s_d[t * heads + h] * s_att[ch] * lk;
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < kGatMaxJ; ++i)
    if (i < nj) dxl[static_cast<size_t>(v) * hc + lane + 32 * i] = acc[i];
}

// Widths the kernels take: De a multiple of 4 up to 64; H*C a multiple of
// 32 up to 512; C/4 a power of two up to 32; H at most 32.
bool gat_widths_ok(int n, int e, int de, int hc, int heads, int graphs) {
  if (n < 1 || e < 0 || de < 4 || de % 4 || de > 64 || hc < 32 || hc % 32 ||
      hc > kGatMaxCols || heads < 1 || heads > 32 || hc % heads || graphs < 1 ||
      graphs > 65535)
    return false;
  const int group = hc / heads / 4;
  return group >= 1 && group <= 32 && (group & (group - 1)) == 0 && group * 4 * heads == hc;
}

struct GatPlan {
  int blocks;  // a graph's
  size_t smem;
};

cudaError_t gat_plan(int n, int e, int de, int hc, int heads, int graphs, GatPlan& p) {
  if (!gat_widths_ok(n, e, de, hc, heads, graphs)) return cudaErrorInvalidValue;
  int smem_max = 0, sms = 0;
  const cudaError_t err = device_limits(smem_max, sms);
  if (err != cudaSuccess) return err;
  p.smem = gat_smem_bytes(de, hc, heads);
  if (p.smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  p.blocks = sms / graphs > 1 ? sms / graphs : 1;
  return cudaSuccess;
}

// The backward's scratch, in floats, each part rounded up to 16 bytes:
// dsc [B, n, heads], sa and sdl [B, e, heads], sbits [B, e, hc/32], part
// [B * blocks, hc * de + 3 hc].
constexpr int kGatScratchParts = 5;
void gat_scratch(int n, int e, int de, int hc, int heads, int graphs, int blocks,
                 long long (&sz)[kGatScratchParts]) {
  sz[0] = static_cast<long long>(graphs) * n * heads;
  sz[1] = static_cast<long long>(graphs) * e * heads;
  sz[2] = sz[1];
  sz[3] = static_cast<long long>(graphs) * e * (hc / 32);
  sz[4] = static_cast<long long>(graphs) * blocks * (static_cast<long long>(hc) * de + 3 * hc);
  for (long long& v : sz) v = (v + 3) & ~3LL;
}

}  // namespace

// How the kernels run at these widths over `graphs` graphs on the current
// device: plan[2] gets a graph's tile blocks and the tile blocks' shared
// memory in bytes.  Returns 0, or the cudaError_t of widths the kernels do
// not take.  Loaded with ctypes.
extern "C" int gat_mp_plan(int n, int e, int de, int hc, int heads, int graphs,
                           int* plan) {
  GatPlan p;
  const cudaError_t err = gat_plan(n, e, de, hc, heads, graphs, p);
  if (err != cudaSuccess) return err;
  plan[0] = p.blocks;
  plan[1] = static_cast<int>(p.smem);
  return 0;
}

// Forward entry point, loaded with ctypes, over `graphs` = B graphs of n
// nodes and e edges each.  Device pointers to contiguous arrays: xl, xr
// [B, n, hc]; ef [B, e, de]; src, dst [B, e] int32 (n where the edge takes
// no part); order [B, e], off [B, n + 1] int32, the receiver order of
// their fused_layout; we [hc, de], be, att (head h's at h * hc/heads),
// bias [hc]; out [B, n, hc] and stats [B, n, 2, heads], every element
// written; lg [B, e, heads], a scratch.  xl, xr, ef, we, be, att, bias,
// out and gout are 16-byte aligned.  Returns the first failing
// cudaError_t (0 on success).
extern "C" int gat_mp_forward(const float* xl, const float* xr, const float* ef,
                              const int* src, const int* dst, const int* order,
                              const int* off, const float* we, const float* be,
                              const float* att, const float* bias, float slope,
                              float* out, float* stats, float* lg, int n, int e,
                              int de, int hc, int heads, int graphs, void* stream) {
  GatPlan p;
  cudaError_t err = gat_plan(n, e, de, hc, heads, graphs, p);
  if (err != cudaSuccess) return err;
  if (!aligned16(xl) || !aligned16(xr) || !(aligned16(ef) || e == 0) || !aligned16(we) ||
      !aligned16(be) || !aligned16(att) || !aligned16(bias) || !aligned16(out))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gat_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  gat_fwd_kernel<<<dim3(p.blocks, graphs), kGatThreads, p.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      xl, xr, ef, src, dst, order, off, we, be, att, bias, slope, out, stats, lg, n, e,
      de, hc, heads);
  return cudaGetLastError();
}

// The scratch of one gat_mp_backward call, in floats, or minus a
// cudaError_t.  Loaded with ctypes.
extern "C" long long gat_mp_backward_scratch(int n, int e, int de, int hc, int heads,
                                             int graphs) {
  GatPlan p;
  const cudaError_t err = gat_plan(n, e, de, hc, heads, graphs, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  long long sz[kGatScratchParts];
  gat_scratch(n, e, de, hc, heads, graphs, p.blocks, sz);
  long long total = 0;
  for (long long v : sz) total += v;
  return total;
}

// Backward entry point, loaded with ctypes.  Inputs as gat_mp_forward, plus
// send_order [B, e] and send_off [B, n + 1] (the layout's sender order),
// out and stats as the forward wrote them, and gout [B, n, hc], the
// cotangent of out.  scratch: gat_mp_backward_scratch's floats (16-byte
// aligned), never read before the call writes them.  Outputs, every
// element written: gef [B, e, de]; dxl, dxr [B, n, hc]; dw [hc * de + 3
// hc] = dWe | dbe | datt | dbias, summed over the graphs.  Returns the first
// failing cudaError_t (0 on success).
extern "C" int gat_mp_backward(const float* xl, const float* xr, const float* ef,
                               const int* src, const int* dst, const int* order,
                               const int* off, const int* send_order,
                               const int* send_off, const float* we, const float* be,
                               const float* att, const float* bias, const float* out,
                               const float* gout, const float* stats, float slope,
                               float* scratch, float* gef, float* dxl, float* dxr,
                               float* dw, int n, int e, int de, int hc, int heads,
                               int graphs, void* stream) {
  GatPlan p;
  cudaError_t err = gat_plan(n, e, de, hc, heads, graphs, p);
  if (err != cudaSuccess) return err;
  if (!aligned16(xl) || !aligned16(xr) || !(aligned16(ef) || e == 0) ||
      !(aligned16(gef) || e == 0) || !aligned16(we) || !aligned16(be) ||
      !aligned16(att) || !aligned16(bias) || !aligned16(out) || !aligned16(gout) ||
      !aligned16(scratch))
    return cudaErrorInvalidValue;
  long long sz[kGatScratchParts];
  gat_scratch(n, e, de, hc, heads, graphs, p.blocks, sz);
  float* dsc = scratch;
  float* sa = dsc + sz[0];
  float* sdl = sa + sz[1];
  unsigned* sbits = reinterpret_cast<unsigned*>(sdl + sz[2]);
  float* part = reinterpret_cast<float*>(sbits) + sz[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(gat_bwd_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  gat_bwd_edge_kernel<<<dim3(p.blocks, graphs), kGatThreads, p.smem, st>>>(
      xl, xr, ef, src, dst, order, off, we, be, att, bias, out, gout, stats, slope, dsc, sa,
      sdl, sbits, gef, dxr, part, n, e, de, hc, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int len = hc * de + 3 * hc;
  gat_reduce_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, graphs * p.blocks, len, dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int send_smem =
      static_cast<int>(sizeof(float)) * (hc + kSendWarps * send_floats(heads, hc >> 5));
  err = cudaFuncSetAttribute(gat_send_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             send_smem);
  if (err != cudaSuccess) return err;
  gat_send_kernel<<<dim3((n + kSendWarps - 1) / kSendWarps, graphs), kSendWarps * 32,
                    send_smem, st>>>(gout, att, dst, send_order, send_off, sa, sdl, sbits,
                                     slope, dxl, n, e, hc, heads);
  return cudaGetLastError();
}
