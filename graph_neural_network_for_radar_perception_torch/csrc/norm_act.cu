// Channel norm + activation for Hopper (sm_90a): forward (norm_act_forward)
// and backward (norm_act_backward) of ops/norms.channel_norm_act, whose
// plain version is ops/norms.channel_norm followed by F.leaky_relu.
//
// It replaces no TPU kernel: the JAX package leaves the norm to XLA, which
// fuses it.  It was added because the plain chain is a mean, a sum of
// squared deviations, a sqrt and about eight elementwise operations, and
// autograd's backward of each: ~39 launches and ~59 tensor-sized passes a
// site, over the encoders', update MLPs' and heads' activations (the
// message rounds fuse their own norms, csrc/fused_mp.cu).  For each row x
// of D channels (the last axis) and the scalar affine pair (gamma, beta):
//
//   mu    = sum(x) / D
//   sigma = sqrt(sum((x - mu)^2) / (D - 1))          Bessel, as torch.std
//   z     = (x - mu) / (sigma + eps)                 eps on the std
//   v     = gamma * z + beta
//   y     = v > 0 ? v : slope * v                    leaky ReLU; ReLU is slope 0,
//                                                    no activation slope 1
//
// the two-pass statistics in f32, as channel_norm computes them; z, v and
// y with the plain path's roundings (a division, a product and a sum, not
// fused).  The forward writes y and two floats a row, mu and 1/(sigma +
// eps).
//
// Backward, for the cotangent dy of y: dv = dy * (v > 0 ? 1 : slope) (at
// v = 0 the slope, as F.leaky_relu's backward), dz = gamma dv, and
//
//   dx = (dz - mean(dz)) / (sigma + eps)
//        - (x - mu) * sum(dz (x - mu)) / ((D - 1) sigma (sigma + eps)^2)
//   dgamma = sum over every row of dv z,    dbeta = sum of dv.
//
// It reads x, dy and the row's statistics, recomputes sigma from x and the
// stored mu with the forward's own code (the same bits), and z and the
// activation's mask from them.  A row's share of dgamma is its sum of dv
// (x - mu), exact products by fma, over (sigma + eps): one division a row
// where the plain path rounds z and each product.  A row with sigma = 0 (a
// constant row) gets dx NaN, as the plain path's through the sqrt's
// backward, while its share of dgamma and dbeta stays finite (x - mu = 0
// there).
//
// Rows.  The lanes of a warp split into groups of LPR lanes, a group a row:
// LPR the least power of two that covers the row's float4s, at most 32, so
// D = 128 takes a warp a row and D = 64 two rows a warp, 16 lanes each.  A
// lane holds V float4s of its row (D <= 32 * 4 * V), in registers: each
// element is read once and written once, 16 bytes a lane a load, and the
// row's sums are butterfly shuffles within the group, so every lane of it
// holds the same bits.
//
// Order.  Every sum is in a fixed order: a lane's elements in order, then
// the group's butterfly.  The backward's dgamma and dbeta are summed by a
// fixed persistent grid (the SMs times a whole number of blocks, from the
// device and the shapes alone), each block's rows in a fixed stride, a
// group's rows in order (its lane 0 keeps them), the block's lanes in a
// fixed tree, into a partial a block; norm_act_reduce_kernel sums the partials in a fixed order.  No
// atomics: two launches give the same bits.
//
// What bounds it.  Memory: a site moves 2 R D floats forward (x in, y out)
// and 3 R D backward (x and dy in, dx out), 20 R D bytes in all, against
// ~236 R D for the plain chain's ~59 passes; at 3.35 TB/s an edge-encoder
// site of knn.train ([8, 10240, 128], R D = 10.5 M) is 25 us forward and
// 38 us backward at best.  Compute is a few operations an element.
//
// A batch is rows: any leading axes flattened, contiguous, 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 8;       // float4s a lane: D <= 32 * 4 * 8 = 1024
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float group_sum(float s, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One row group's float4s: lane `sub` of the group holds columns (k * LPR +
// sub) * 4 .. + 3 for k < V; `valid[k]` whether that float4 is in the row.
template <int V, int LPR>
struct Row {
  float4 v[V];
  bool valid[V];
};

template <int V, int LPR>
__device__ __forceinline__ void load_row(const float* __restrict__ p, long long row,
                                         bool live, int d4, int sub, Row<V, LPR>& r) {
  const float4* q = reinterpret_cast<const float4*>(p) + row * d4;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = k * LPR + sub;
    r.valid[k] = live && c < d4;
    r.v[k] = r.valid[k] ? q[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The row's mean and sum of squared deviations from `mu`, each summed in
// the same order by every caller.
template <int V, int LPR>
__device__ __forceinline__ float row_sum(const Row<V, LPR>& r) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (r.valid[k]) s += ((r.v[k].x + r.v[k].y) + (r.v[k].z + r.v[k].w));
  }
  return group_sum(s, LPR);
}

template <int V, int LPR>
__device__ __forceinline__ float row_sq_dev(const Row<V, LPR>& r, float mu) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (r.valid[k]) {
      const float a = r.v[k].x - mu, b = r.v[k].y - mu, c = r.v[k].z - mu,
                  e = r.v[k].w - mu;
      s += (__fmul_rn(a, a) + __fmul_rn(b, b)) + (__fmul_rn(c, c) + __fmul_rn(e, e));
    }
  }
  return group_sum(s, LPR);
}

__device__ __forceinline__ float act(float v, float slope) {
  return v > 0.f ? v : __fmul_rn(v, slope);
}

__device__ __forceinline__ float affine(float x, float mu, float den, float g, float b) {
  return __fadd_rn(__fmul_rn(g, __fdiv_rn(x - mu, den)), b);
}

template <int V, int LPR>
__global__ void __launch_bounds__(kThreads)
norm_act_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float slope, float eps,
                    float* __restrict__ y, float2* __restrict__ stats, long long rows,
                    int d) {
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                            kRowsPerWarp + lane / LPR;
  const bool live = row < rows;
  const int d4 = d >> 2;
  Row<V, LPR> r;
  load_row<V, LPR>(x, live ? row : 0, live, d4, sub, r);
  const float mu = row_sum<V, LPR>(r) / static_cast<float>(d);
  const float sigma = sqrtf(row_sq_dev<V, LPR>(r, mu) / static_cast<float>(d - 1));
  const float den = sigma + eps;
  if (!live) return;
  const float g = *gamma, b = *beta;
  float4* out = reinterpret_cast<float4*>(y) + row * d4;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!r.valid[k]) continue;
    const float4 v = r.v[k];
    out[k * LPR + sub] = make_float4(act(affine(v.x, mu, den, g, b), slope),
                                     act(affine(v.y, mu, den, g, b), slope),
                                     act(affine(v.z, mu, den, g, b), slope),
                                     act(affine(v.w, mu, den, g, b), slope));
  }
  if (sub == 0) stats[row] = make_float2(mu, 1.f / den);
}

// One element's backward: dv, the cotangent of v = gamma z + beta, with
// the row's sums of dv and of dv (x - mu) accumulated.
__device__ __forceinline__ float elem_dv(float xv, float dyv, float mu, float den, float g,
                                         float b, float slope, float& sdv, float& sdvd) {
  const float v = affine(xv, mu, den, g, b);
  const float dv = v > 0.f ? dyv : dyv * slope;
  sdv += dv;
  sdvd = fmaf(dv, xv - mu, sdvd);
  return dv;
}

template <int V, int LPR>
__global__ void __launch_bounds__(kThreads)
norm_act_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float2* __restrict__ stats, float slope, float eps,
                    float* __restrict__ dx, float2* __restrict__ partials, long long rows,
                    int d) {
  constexpr int kRowsPerWarp = 32 / LPR;
  constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const int slot = (threadIdx.x >> 5) * kRowsPerWarp + lane / LPR;
  const int d4 = d >> 2;
  const float g = *gamma, b = *beta;
  const float dm1 = static_cast<float>(d - 1);
  // the block's dgamma and dbeta, a row's share added by its group's lane 0
  float pg = 0.f, pb = 0.f;
  // Every thread of the block takes the same number of turns (the bound is
  // the block's), so the shuffles see the whole warp.
  for (long long base = static_cast<long long>(blockIdx.x) * kRowsPerBlock; base < rows;
       base += static_cast<long long>(gridDim.x) * kRowsPerBlock) {
    const long long row = base + slot;
    const bool live = row < rows;
    Row<V, LPR> rx, rg;
    load_row<V, LPR>(x, live ? row : 0, live, d4, sub, rx);
    load_row<V, LPR>(dy, live ? row : 0, live, d4, sub, rg);
    const float2 st = live ? stats[row] : make_float2(0.f, 1.f);
    const float mu = st.x, rinv = st.y;
    const float sigma = sqrtf(row_sq_dev<V, LPR>(rx, mu) / dm1);
    const float den = sigma + eps;
    float sdv = 0.f, sdvd = 0.f;
    float4 dv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      dv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!rx.valid[k]) continue;
      const float4 xv = rx.v[k], gv = rg.v[k];
      dv[k].x = elem_dv(xv.x, gv.x, mu, den, g, b, slope, sdv, sdvd);
      dv[k].y = elem_dv(xv.y, gv.y, mu, den, g, b, slope, sdv, sdvd);
      dv[k].z = elem_dv(xv.z, gv.z, mu, den, g, b, slope, sdv, sdvd);
      dv[k].w = elem_dv(xv.w, gv.w, mu, den, g, b, slope, sdv, sdvd);
    }
    sdv = group_sum(sdv, LPR);
    sdvd = group_sum(sdvd, LPR);
    if (!live) continue;
    if (sub == 0) {  // sum(dv z) = sum(dv (x - mu)) / (sigma + eps): one rounding a row
      pg += __fdiv_rn(sdvd, den);
      pb += sdv;
    }
    // dz = gamma dv; sigma = 0 gives 0 / 0 in t: dx NaN, as the plain path's
    const float mdz = g * sdv / static_cast<float>(d);
    const float t = g * sdvd / (dm1 * sigma) * rinv * rinv;
    float4* out = reinterpret_cast<float4*>(dx) + row * d4;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!rx.valid[k]) continue;
      const float4 xv = rx.v[k];
      out[k * LPR + sub] = make_float4((g * dv[k].x - mdz) * rinv - (xv.x - mu) * t,
                                       (g * dv[k].y - mdz) * rinv - (xv.y - mu) * t,
                                       (g * dv[k].z - mdz) * rinv - (xv.z - mu) * t,
                                       (g * dv[k].w - mdz) * rinv - (xv.w - mu) * t);
    }
  }
  // the block's partials: the warp's lanes by butterfly, then the warps in order
  pg = group_sum(pg, 32);
  pb = group_sum(pb, 32);
  __shared__ float2 warp_part[kWarps];
  if (lane == 0) warp_part[threadIdx.x >> 5] = make_float2(pg, pb);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 s = warp_part[0];
    for (int w = 1; w < kWarps; ++w) {
      s.x += warp_part[w].x;
      s.y += warp_part[w].y;
    }
    partials[blockIdx.x] = s;
  }
}

// dgamma, dbeta = the sums of the n partials: a thread's in stride order,
// then a fixed tree over the block.
__global__ void __launch_bounds__(kReduceThreads)
norm_act_reduce_kernel(const float2* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float2 part[kReduceThreads];
  float2 s = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    s.x += partials[i].x;
    s.y += partials[i].y;
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      part[threadIdx.x].x += part[threadIdx.x + half].x;
      part[threadIdx.x].y += part[threadIdx.x + half].y;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = part[0].x;
    out[1] = part[0].y;
  }
}

// Lanes a row: the least power of two >= D / 4, at most 32.
int lanes_a_row(int d) {
  int lpr = 1;
  while (lpr < 32 && lpr < d / 4) lpr <<= 1;
  return lpr;
}

bool width_ok(int d) { return d >= 4 && d % 4 == 0 && d <= 32 * 4 * kMaxV; }

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

// K<V, LPR>::run(args...) for D's instantiation.
template <template <int, int> class K, typename... A>
cudaError_t dispatch(int d, A... args) {
  const int lpr = lanes_a_row(d);
  if (lpr < 32) {
    switch (lpr) {
      case 1: return K<1, 1>::run(args...);
      case 2: return K<1, 2>::run(args...);
      case 4: return K<1, 4>::run(args...);
      case 8: return K<1, 8>::run(args...);
      default: return K<1, 16>::run(args...);
    }
  }
  switch ((d / 4 + 31) / 32) {
    case 1: return K<1, 32>::run(args...);
    case 2: return K<2, 32>::run(args...);
    case 3: return K<3, 32>::run(args...);
    case 4: return K<4, 32>::run(args...);
    case 5: return K<5, 32>::run(args...);
    case 6: return K<6, 32>::run(args...);
    case 7: return K<7, 32>::run(args...);
    default: return K<8, 32>::run(args...);
  }
}

template <int V, int LPR>
struct Forward {
  static cudaError_t run(unsigned blocks, cudaStream_t st, const float* x, const float* gamma,
                         const float* beta, float slope, float eps, float* y, float2* stats,
                         long long rows, int d) {
    norm_act_fwd_kernel<V, LPR><<<blocks, kThreads, 0, st>>>(x, gamma, beta, slope, eps, y,
                                                              stats, rows, d);
    return cudaGetLastError();
  }
};

template <int V, int LPR>
struct Backward {
  static cudaError_t run(unsigned blocks, cudaStream_t st, const float* x, const float* dy,
                         const float* gamma, const float* beta, const float2* stats,
                         float slope, float eps, float* dx, float2* partials, long long rows,
                         int d) {
    norm_act_bwd_kernel<V, LPR><<<blocks, kThreads, 0, st>>>(x, dy, gamma, beta, stats, slope,
                                                              eps, dx, partials, rows, d);
    return cudaGetLastError();
  }
};

template <int V, int LPR>
struct BackwardOccupancy {
  static cudaError_t run(int* per_sm) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, norm_act_bwd_kernel<V, LPR>,
                                                         kThreads, 0);
  }
};

// Rows a block takes at a time.
long long rows_a_block(int d) { return static_cast<long long>(kWarps) * (32 / lanes_a_row(d)); }

// The backward's grid: the SMs times the blocks an SM holds, cut to whole
// multiples of the SMs that the rows need.  It depends on the device, the
// width and the rows only.
cudaError_t backward_grid(long long rows, int d, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = dispatch<BackwardOccupancy>(d, &per_sm);
  if (err != cudaSuccess) return err;
  const long long need = (rows + rows_a_block(d) - 1) / rows_a_block(d);
  long long per = (need + sms - 1) / sms;
  if (per > per_sm) per = per_sm;
  if (per < 1) per = 1;
  blocks = static_cast<int>(per * sms);
  return cudaSuccess;
}

}  // namespace

// The blocks (partials) of a norm_act_backward call over `rows` rows of
// width d on the current device, or minus a cudaError_t.  Loaded with
// ctypes.
extern "C" int norm_act_backward_blocks(long long rows, int d) {
  if (!width_ok(d) || rows < 0) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = backward_grid(rows, d, blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Forward entry point, loaded with ctypes.  Device pointers: x, y [rows, d]
// f32, contiguous and 16-byte aligned; gamma, beta one float each; stats
// [rows, 2] (mu, 1 / (sigma + eps)), every element written.  d a multiple
// of 4 from 4 to 1024.  Returns the first failing cudaError_t (0 on
// success).
extern "C" int norm_act_forward(const float* x, const float* gamma, const float* beta,
                                float slope, float eps, float* y, float* stats,
                                long long rows, int d, void* stream) {
  if (!width_ok(d) || rows < 0 || !aligned16(x) || !aligned16(y)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((rows + rows_a_block(d) - 1) / rows_a_block(d));
  return dispatch<Forward>(d, blocks, static_cast<cudaStream_t>(stream), x, gamma, beta, slope,
                           eps, y, reinterpret_cast<float2*>(stats), rows, d);
}

// Backward entry point, loaded with ctypes: two launches.  x, dy, dx
// [rows, d] f32, contiguous and 16-byte aligned; stats the forward's;
// partials [norm_act_backward_blocks(rows, d), 2], a scratch; dgb [2] gets
// (dgamma, dbeta).  Returns the first failing cudaError_t (0 on success).
extern "C" int norm_act_backward(const float* x, const float* dy, const float* gamma,
                                 const float* beta, const float* stats, float slope,
                                 float eps, float* dx, float* partials, float* dgb,
                                 long long rows, int d, void* stream) {
  if (!width_ok(d) || rows < 0 || !aligned16(x) || !aligned16(dy) || !aligned16(dx))
    return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = backward_grid(rows, d, blocks);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(partials);
  if (rows > 0) {
    err = dispatch<Backward>(d, static_cast<unsigned>(blocks), st, x, dy, gamma, beta,
                             reinterpret_cast<const float2*>(stats), slope, eps, dx, part,
                             rows, d);
    if (err != cudaSuccess) return err;
  }
  norm_act_reduce_kernel<<<1, kReduceThreads, 0, st>>>(part, rows > 0 ? blocks : 0, dgb);
  return cudaGetLastError();
}
