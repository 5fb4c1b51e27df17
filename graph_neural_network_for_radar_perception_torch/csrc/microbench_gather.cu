// Row gather and row scatter-add for Hopper (sm_90a): the kernels of the
// gather/scatter microbenchmark.
//
// Replaces the TPU kernels of scripts/microbench_gather.py:
//   make_gather  (:69, pallas_call :82; bodies _gather_onehot_kernel :47,
//                 _gather_take_kernel :55, _gather_loop_kernel :59)
//     out[i] = table[idx[i]]                    table [n, d], idx [m] -> [m, d]
//   make_scatter (:128, pallas_call :141; bodies _scatter_onehot_kernel :95,
//                 _scatter_loop_kernel :110)
//     out[idx[i]] += msg[i]                     msg [m, d], idx [m] -> [n, d]
// The TPU script compares three ways to express a gather (a one-hot matmul
// on the MXU, jnp.take, a loop of dynamic row slices) and two for the
// scatter.  On this card a gather is a gather: one kernel each.  Index
// semantics are the one-hot body's, the TPU baseline: an index outside
// [0, n) gathers a zero row, and its message is dropped.
//
// What bounds them.  Neither does arithmetic worth counting: each moves its
// inputs and output once, ~4.2 MB at the script's shapes (n = 768, d = 64,
// m = 15 360), about 1.25 us at 3.35 TB/s.  A launch of that size is
// dominated by its fixed cost, so the design is the plain one:
// * gather: one thread per 16-byte piece (float4) of the output, so that a
//   warp reads two table rows and writes two output rows with 16-byte
//   accesses on neighbouring addresses; the table (192 KB) stays in L2.
// * scatter: the output is zeroed (cudaMemsetAsync), then one thread per
//   float4 of msg adds its four values with atomicAdd at its row.  The order
//   of the additions into one row varies from run to run, so the last bits
//   of the result do too: not deterministic.
// Both need d a multiple of 4 and 16-byte aligned rows (checked by the
// wrappers in graph_neural_network_for_radar_perception_torch/scripts/
// microbench_gather.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, int n, long long pieces, int d4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pieces) return;
  const long long row = i / d4;
  const int c = static_cast<int>(i - row * d4);
  const int j = idx[row];
  out[i] = in_range(j, n) ? table[static_cast<long long>(j) * d4 + c]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float4* __restrict__ msg, const int* __restrict__ idx,
                        float* __restrict__ out, int n, long long pieces, int d4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pieces) return;
  const long long row = i / d4;
  const int c = static_cast<int>(i - row * d4);
  const int j = idx[row];
  if (!in_range(j, n)) return;  // the message is dropped
  const float4 v = msg[i];
  float* o = out + (static_cast<long long>(j) * d4 + c) * 4;
  atomicAdd(o + 0, v.x);
  atomicAdd(o + 1, v.y);
  atomicAdd(o + 2, v.z);
  atomicAdd(o + 3, v.w);
}

int grid_for(long long pieces) {
  return static_cast<int>((pieces + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  All pointers are device
// pointers to contiguous arrays with 16-byte aligned starts; d is a multiple
// of 4.  Each returns the first failing cudaError_t (0 on success).

// out [m, d] = table [n, d] rows at idx [m] int32 (zero rows outside [0, n)).
extern "C" int gather_rows(const float* table, const int* idx, float* out,
                           int n, int m, int d, void* stream) {
  if (n < 0 || m < 0 || d <= 0 || d % 4) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const long long pieces = static_cast<long long>(m) * (d / 4);
  gather_rows_kernel<<<grid_for(pieces), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), n, pieces, d / 4);
  return cudaGetLastError();
}

// out [n, d] = zero, then out[idx[i]] += msg[i] for i < m with idx [m] int32
// inside [0, n); the others are dropped.
extern "C" int scatter_add_rows(const float* msg, const int* idx, float* out,
                                int n, int m, int d, void* stream) {
  if (n < 0 || m < 0 || d <= 0 || d % 4) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n) * d * sizeof(float), s);
  if (err != cudaSuccess || m == 0) return err;
  const long long pieces = static_cast<long long>(m) * (d / 4);
  scatter_add_rows_kernel<<<grid_for(pieces), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(msg), idx, out, n, pieces, d / 4);
  return cudaGetLastError();
}
