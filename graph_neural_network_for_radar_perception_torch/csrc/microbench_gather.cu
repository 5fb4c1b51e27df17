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
// dominated by its fixed cost and its latencies.
// * gather: one thread per 16-byte piece (float4) of the output, so that a
//   warp reads two table rows and writes two output rows with 16-byte
//   accesses on neighbouring addresses, and every thread of the card has
//   its piece's chain (index load, row load, store) in flight at once; the
//   row is a shift of the piece's number where d / 4 is a power of two.
//   The table (192 KB) stays in L2.  At the script's shapes this is a
//   latency chain, not a rate: in a CUDA-graph replay an empty kernel on
//   this grid takes ~1.2 us and one that only stores the output ~2.4-2.5
//   us, so launch, the stores' drain and the two dependent round trips
//   (index, then row) add up to ~2.9 us whatever the design.  A persistent
//   grid of warps over runs of rows (indices shared by __shfl_sync, 4 row
//   loads a lane in flight, fewer memory instructions), Hopper's bulk
//   copies (cp.async.bulk rows into shared memory, one bulk store a tile)
//   and streaming stores (__stcs) were all slower;
//   scripts/gather_ablation.py holds them (PERF.md).
// * scatter: one launch, no zeroing and no atomics.  Block b owns R output
//   rows, one block an SM where the rows allow it (R = 6 at n = 768 on 132
//   SMs: R * d / 4 = 96 threads own one float4 of an output row each).
//   It copies idx (61 KB at the script's shapes, from L2 to every block)
//   into shared memory with cp.async, all of it in flight at once (up to
//   16 384 indices a stage); each warp lists, in order, the
//   positions of its contiguous eighth that land in the block's rows (4
//   ballots a 128 indices, no barrier), and a stable counting sort by row
//   turns the warps' lists into one list per row.  Each owner thread then
//   sums its row's messages in index order, 16 loads in flight at a time,
//   and writes its float4 once: zero where no index lands.  So each
//   row's sum is np.add.at's, in the same order, bit for bit, on every
//   launch (the TPU loop body's order).  Why each part: a row's sum is one
//   chain of loads (np.add.at's order allows no split), so parallelism
//   comes from the rows and from listing idx, and the work every block
//   repeats (staging and listing idx) is kept off the latency path: all
//   of idx in flight at once, warps listing without barriers, rows grouped
//   by __match_any_sync.  The batch of loads and its predication come from
//   scripts/scatter_ablation.py (PERF.md).
// Both need d a multiple of 4 and 16-byte aligned rows (checked by the
// wrappers in graph_neural_network_for_radar_perception_torch/scripts/
// microbench_gather.py); the scatter also d <= 1024.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherThreads = 256;

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// out [m, d4] float4 = table rows at idx (zero rows outside [0, n)): thread
// i writes piece i, column i % d4 of row i / d4 (shift = log2(d4) where d4
// is a power of two, else -1: no division on the chain before the loads).
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, int n, long long pieces, int d4, int shift) {
  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= pieces) return;
  const long long row = shift >= 0 ? i >> shift : i / d4;
  const int j = idx[row];
  const float4 v = in_range(j, n) ? table[static_cast<long long>(j) * d4 + (i - row * d4)]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  out[i] = v;
}

constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kScatterStage = 16384;  // indices a block sorts at once (64 KB)
constexpr int kScatterRows = 16;      // most output rows a block owns (4 bits below)
constexpr int kScatterBatch = 16;     // message loads an owner keeps in flight

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(gmem) : "memory");
}

// out[r0 + t] = sum over i with idx[i] = r0 + t, in order of i, of msg[i],
// for the rows t < rows of block b (r0 = b * rows).  Per stage of up to
// kScatterStage indices: (1) idx into shared memory (cp.async, all in
// flight); (2) warp w lists, in order, the positions of its contiguous
// slice that land in the block's rows (4 ballots a 128 indices, no
// barrier);
// (3) a stable counting sort of the warps' lists by row into one list per
// row (lanes of one row grouped by __match_any_sync); (4) each owner adds
// its row's messages in list order.
__global__ void __launch_bounds__(kScatterThreads)
scatter_add_rows_kernel(const float4* __restrict__ msg, const int* __restrict__ idx,
                        float4* __restrict__ out, int n, int m, int d4, int rows) {
  extern __shared__ __align__(16) int smem[];
  int* s_idx = smem;  // [stage] the staged indices, then the rows' lists
  int* s_wl = smem + (m < kScatterStage ? m : kScatterStage);  // [stage] the warps' lists
  __shared__ int s_cnt[kScatterWarps][kScatterRows];   // list entries a warp and row
  __shared__ int s_base[kScatterWarps][kScatterRows];  // where a warp's entries of a row go
  __shared__ int s_start[kScatterRows + 1];            // where each row's list starts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;  // the lanes before this one
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);  // this block's rows
  // This thread's output float4 (an owner's): row r0 + own_row, column own_col.
  const int own_row = tid / d4, own_col = tid - own_row * d4;
  const bool owner = own_row < nr;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int s0 = 0; s0 < m; s0 += kScatterStage) {
    const int len = min(kScatterStage, m - s0);
    __syncthreads();  // the previous stage's lists are read
    for (int i = tid; i < len; i += kScatterThreads) cp_async4(s_idx + i, idx + s0 + i);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    if (lane < kScatterRows) s_cnt[warp][lane] = 0;
    __syncthreads();

    // (2) This warp's slice [lo, hi), 128 indices a round, 4 consecutive a
    // lane: entries (q << 4) | row, in order of q.
    const int slice = ((len + 128 * kScatterWarps - 1) / (128 * kScatterWarps)) * 128;
    const int lo = warp * slice, hi = min(len, lo + slice);
    int* wl = s_wl + lo;  // at most hi - lo entries
    int hits = 0;         // this warp's entries (the same in every lane)
    for (int q0 = lo; q0 < hi; q0 += 128) {
      const int q = q0 + 4 * lane;
      int v[4];
      if (q + 3 < hi) {
        const int4 t = *reinterpret_cast<const int4*>(s_idx + q);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = q + k < hi ? s_idx[q + k] : -1;
      }
      unsigned r[4], mk[4];
      int pos = hits;  // the entries before this lane's first
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = static_cast<unsigned>(v[k]) - static_cast<unsigned>(r0);
        mk[k] = __ballot_sync(kFull, r[k] < static_cast<unsigned>(nr));
        pos += __popc(mk[k] & lt);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r[k] < static_cast<unsigned>(nr)) wl[pos++] = ((q + k) << 4) | static_cast<int>(r[k]);
        hits += __popc(mk[k]);
      }
    }
    __syncwarp();
    // This warp's entries a row: the first lane of each row's group adds.
    for (int k0 = 0; k0 < hits; k0 += 32) {
      const int row = k0 + lane < hits ? wl[k0 + lane] & 15 : -1;
      const unsigned grp = __match_any_sync(kFull, row);
      if (row >= 0 && (grp & lt) == 0) s_cnt[warp][row] += __popc(grp);
      __syncwarp();
    }
    __syncthreads();  // every list and count is done; s_idx is free
    if (warp == 0) {  // each row's list starts after the rows before it
      int t = 0;
      if (lane < kScatterRows)
        for (int w = 0; w < kScatterWarps; ++w) t += s_cnt[w][lane];
      int inc = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane < kScatterRows) s_start[lane] = inc - t;
      if (lane == kScatterRows - 1) s_start[kScatterRows] = inc;
    }
    __syncthreads();

    // (3) This warp's entries of a row go after the other warps' before it,
    // in list order.
    if (lane < kScatterRows) {
      int b = s_start[lane];
      for (int w = 0; w < warp; ++w) b += s_cnt[w][lane];
      s_base[warp][lane] = b;
    }
    __syncwarp();
    for (int k0 = 0; k0 < hits; k0 += 32) {
      const int e = k0 + lane < hits ? wl[k0 + lane] : -1;
      const int row = e >= 0 ? (e & 15) : -1;
      const unsigned grp = __match_any_sync(kFull, row);
      if (row >= 0) s_idx[s_base[warp][row] + __popc(grp & lt)] = s0 + (e >> 4);
      __syncwarp();
      if (row >= 0 && (grp & lt) == 0) s_base[warp][row] += __popc(grp);
      __syncwarp();
    }
    __syncthreads();  // the rows' lists are complete

    // (4) The owner's row: [s_start[row], s_start[row + 1]) of the lists,
    // added in order, kScatterBatch loads in flight at a time.
    if (owner) {
      const int* list = s_idx + s_start[own_row];
      const int cnt = s_start[own_row + 1] - s_start[own_row];
      for (int k = 0; k < cnt; k += kScatterBatch) {
        float4 v[kScatterBatch];
#pragma unroll
        for (int j = 0; j < kScatterBatch; ++j)
          v[j] = k + j < cnt ? msg[static_cast<size_t>(list[k + j]) * d4 + own_col]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kScatterBatch; ++j) {
          if (k + j >= cnt) break;
          acc.x += v[j].x;
          acc.y += v[j].y;
          acc.z += v[j].z;
          acc.w += v[j].w;
        }
      }
    }
  }
  if (owner) out[static_cast<size_t>(r0 + own_row) * d4 + own_col] = acc;
}

// The device's SM count (the scatter's grid), or an error.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
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
  const int d4 = d / 4;
  const int shift = (d4 & (d4 - 1)) ? -1 : __builtin_ctz(d4);
  const long long pieces = static_cast<long long>(m) * d4;
  gather_rows_kernel<<<static_cast<int>((pieces + kGatherThreads - 1) / kGatherThreads),
                       kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), n, pieces,
      d4, shift);
  return cudaGetLastError();
}

// out [n, d]: out[v] = the sum of msg[i] over the i < m with idx[i] = v, in
// order of i (zero where none lands), for idx [m] int32; indices outside
// [0, n) are dropped.  Every row is written once; d <= 1024.
extern "C" int scatter_add_rows(const float* msg, const int* idx, float* out,
                                int n, int m, int d, void* stream) {
  if (n < 0 || m < 0 || d <= 0 || d % 4 || d / 4 > kScatterThreads)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int d4 = d / 4;
  // One block an SM where the rows allow it: ceil(n / SMs) rows a block,
  // at most kScatterRows and as many as the block's threads can own.
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int rows = (n + sms - 1) / sms;
  const int most = kScatterThreads / d4 < kScatterRows ? kScatterThreads / d4 : kScatterRows;
  rows = rows < 1 ? 1 : (rows > most ? most : rows);
  const int smem = 2 * static_cast<int>(sizeof(int)) * (m < kScatterStage ? m : kScatterStage);
  err = cudaFuncSetAttribute(scatter_add_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scatter_add_rows_kernel<<<(n + rows - 1) / rows, kScatterThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(msg), idx, reinterpret_cast<float4*>(out),
      n, m, d4, rows);
  return cudaGetLastError();
}
