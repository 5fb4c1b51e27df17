"""Where the time of the microbenchmark's gather kernel goes, on a card.

    python -m graph_neural_network_for_radar_perception_torch.scripts.gather_ablation [VARIANT ...]

Builds variants of ``csrc/microbench_gather.cu`` by rewriting its
``gather_rows_kernel`` or its entry point, with one ``nvcc`` each, started
together, and times each in its own process (never two builds of one
library in one process) at the microbenchmark's shapes and inputs
(``microbench_gather.make_inputs``): the C call replayed from a CUDA graph
(``utils/timing.graph_ms``), beside ``index_select`` in the same process.

* ``empty``: the shipped grid launched with a kernel that returns at once,
  the launch floor of a graph replay;
* ``store_only``: no index or table loads, the same stores (zero rows);
* ``load_only``: the same loads, stores that the inputs never take;
* ``streaming_store``: ``__stcs`` in place of a plain store;
* ``div64``: the same layout with a 64-bit division for each piece's row
  (the kernel the shipped one replaced);
* ``warps``: a persistent grid (2 blocks an SM) of warps over runs of up
  to 32 rows, one coalesced index load a run handed on by ``__shfl_sync``,
  4 row loads a lane in flight, 512-byte contiguous stores;
* ``bulk``: Hopper's bulk copies: a block of one warp per tile of 32 rows,
  one ``cp.async.bulk`` a row from the table into shared memory completing
  on an mbarrier, zero rows written by the lanes, then one bulk store of
  the tile's contiguous output rows.

The variants that keep the function are checked against numpy indexing
bit for bit; the ablations compute wrong results on purpose.  Prints one
JSON line per variant.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import _build
from . import scatter_ablation as SA

OUT = _build.BUILD_DIR.parent / "gather_variants"

_START = ("  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;\n"
          "  if (i >= pieces) return;\n")
_IDX = "  const int j = idx[row];"
_STORE = "  out[i] = v;"
_ENTRY = "  if (m == 0) return cudaSuccess;\n  const int d4 = d / 4;\n"
_NAMESPACE_END = "}  // namespace\n"

# The kernel the shipped one replaced: one thread per float4 of the
# output, its row by a 64-bit division.
_DIV64 = r"""
__global__ void __launch_bounds__(256)
gather_rows_div64_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                         float4* __restrict__ out, int n, long long pieces, int d4) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= pieces) return;
  const long long row = i / d4;
  const int c = static_cast<int>(i - row * d4);
  const int j = idx[row];
  out[i] = in_range(j, n) ? table[static_cast<long long>(j) * d4 + c]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
}

int gather_rows_alt(const float* table, const int* idx, float* out, int n, int m, int d,
                    void* stream) {
  const long long pieces = static_cast<long long>(m) * (d / 4);
  gather_rows_div64_kernel<<<static_cast<int>((pieces + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), n,
      pieces, d / 4);
  return cudaGetLastError();
}
"""

# The persistent-warp design: runs of rows a warp, indices shared by
# __shfl_sync, kWarpBatch row loads a lane in flight.
_WARPS = r"""
constexpr int kWarpBlocksPerSM = 2;  // blocks an SM
constexpr int kWarpBatch = 4;        // row loads a lane keeps in flight

// out [m, d4] float4 = table rows at idx (zero rows outside [0, n)).  Warp w
// of the grid takes the runs t = w, w + warps, ... of `run` rows each (run
// <= 32); lane l of a run holds the index of its row l.  A run's output is
// rows * d4 contiguous pieces: piece p is column p % d4 of row p / d4
// (shift = log2(d4) where d4 is a power of two, else -1).
__global__ void __launch_bounds__(256)
gather_rows_warps_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                         float4* __restrict__ out, int n, int m, int d4, int shift, int run) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * 8;
  const int runs = (m + run - 1) / run;
  for (int t = blockIdx.x * 8 + (threadIdx.x >> 5); t < runs; t += warps) {
    const int r0 = t * run;
    const int rows = min(run, m - r0);
    const int j = lane < rows ? idx[r0 + lane] : -1;
    const int pieces = rows * d4;
    float4* dst = out + static_cast<long long>(r0) * d4;
    for (int p0 = 0; p0 < pieces; p0 += 32 * kWarpBatch) {
      float4 v[kWarpBatch];
#pragma unroll
      for (int u = 0; u < kWarpBatch; ++u) {
        const int p = p0 + 32 * u + lane;
        const int row = shift >= 0 ? p >> shift : p / d4;
        const int jr = __shfl_sync(kFull, j, row & 31);  // every lane shuffles
        const int c = p - row * d4;
        v[u] = p < pieces && in_range(jr, n) ? __ldg(table + static_cast<long long>(jr) * d4 + c)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kWarpBatch; ++u) {
        const int p = p0 + 32 * u + lane;
        if (p < pieces) dst[p] = v[u];
      }
    }
  }
}

int gather_rows_alt(const float* table, const int* idx, float* out, int n, int m, int d,
                    void* stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int d4 = d / 4;
  const int shift = (d4 & (d4 - 1)) ? -1 : __builtin_ctz(d4);
  const int warps = sms * kWarpBlocksPerSM * 8;
  const int run = (m + warps - 1) / warps > 32 ? 32 : (m + warps - 1) / warps;
  const int runs = (m + run - 1) / run;
  const int grid = sms * kWarpBlocksPerSM < (runs + 7) / 8 ? sms * kWarpBlocksPerSM
                                                            : (runs + 7) / 8;
  gather_rows_warps_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), n, m, d4,
      shift, run);
  return cudaGetLastError();
}
"""

# Hopper's bulk copies (the TMA without a tensor map).
_BULK = r"""
constexpr int kBulkRows = 32;  // rows a block (one warp): one index a lane

__global__ void __launch_bounds__(32)
gather_rows_bulk_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                        float4* __restrict__ out, int n, int m, int d4) {
  extern __shared__ __align__(128) float4 tile[];  // [kBulkRows, d4]
  __shared__ __align__(8) unsigned long long bar;
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kBulkRows;
  const int rows = min(kBulkRows, m - r0);
  const unsigned row_bytes = 16u * d4;
  const int j = lane < rows ? idx[r0 + lane] : -1;
  const bool live = lane < rows && in_range(j, n);
  const unsigned live_rows = __popc(__ballot_sync(kFull, live));
  const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  const unsigned row_s = static_cast<unsigned>(__cvta_generic_to_shared(tile + lane * d4));
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar_s), "r"(live_rows * row_bytes) : "memory");
  }
  __syncwarp();
  if (live) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(row_s), "l"(table + static_cast<long long>(j) * d4), "r"(row_bytes), "r"(bar_s)
        : "memory");
  } else if (lane < rows) {
    for (int c = 0; c < d4; ++c) tile[lane * d4 + c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The zero rows (generic proxy) before the bulk store (async proxy) reads them.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      " @!done bra WAIT_%=;\n}\n" :: "r"(bar_s) : "memory");
  __syncwarp();
  if (lane == 0) {
    const unsigned tile_s = static_cast<unsigned>(__cvta_generic_to_shared(tile));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(out + static_cast<long long>(r0) * d4), "r"(tile_s),
                    "r"(rows * row_bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

int gather_rows_alt(const float* table, const int* idx, float* out, int n, int m, int d,
                    void* stream) {
  const int smem = kBulkRows * d * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(gather_rows_bulk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_rows_bulk_kernel<<<(m + kBulkRows - 1) / kBulkRows, 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), n, m, d / 4);
  return cudaGetLastError();
}
"""

_ALT_CALL = ("  if (m == 0) return cudaSuccess;\n"
             "  return gather_rows_alt(table, idx, out, n, m, d, stream);\n"
             "  const int d4 = d / 4;\n")

# name -> (holds the gather's result?, [(old, new), ...])
VARIANTS = {
    "shipped": (True, []),
    "empty": (False, [(_START, "  return;\n" + _START)]),
    "store_only": (False, [(_IDX, "  const int j = -1;")]),
    "load_only": (False, [(_STORE, "  if (v.x == 1234.5f) out[i] = v;")]),
    "streaming_store": (True, [(_STORE, "  __stcs(out + i, v);")]),
    "div64": (True, [(_NAMESPACE_END, _DIV64 + "\n" + _NAMESPACE_END), (_ENTRY, _ALT_CALL)]),
    "warps": (True, [(_NAMESPACE_END, _WARPS + "\n" + _NAMESPACE_END), (_ENTRY, _ALT_CALL)]),
    "bulk": (True, [(_NAMESPACE_END, _BULK + "\n" + _NAMESPACE_END), (_ENTRY, _ALT_CALL)]),
}


def rewrite(name: str) -> str:
    """The variant's source (``scatter_ablation.rewrite`` over this table)."""
    return SA.rewrite(name, VARIANTS)


def build(name: str) -> str:
    """The variant's library, built from its rewritten source."""
    return SA.build(name, VARIANTS, OUT)


def time_one(name: str, lib_path: str) -> dict:
    """Times one built variant (in this process) at the microbenchmark's
    shapes; checks it against numpy indexing if it keeps the function."""
    import torch

    from ..utils.timing import graph_ms
    from . import microbench_gather as MB

    fn = ctypes.CDLL(lib_path).gather_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx_np, tab_np, _ = MB.make_inputs(0)
    dev = torch.device("cuda")
    idx = torch.from_numpy(idx_np[:, 0]).to(dev)
    tab = torch.from_numpy(tab_np).to(dev)
    out = torch.zeros(idx.shape[0], MB.D, device=dev)

    def launch():
        rc = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), MB.N, idx.shape[0], MB.D,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError_t {rc}")

    launch()
    torch.cuda.synchronize()
    row = {"variant": name, "device": torch.cuda.get_device_name(0)}
    if VARIANTS[name][0]:
        row["bitwise_numpy"] = bool(np.array_equal(out.cpu().numpy(), tab_np[idx_np[:, 0]]))
    row["ms"] = graph_ms(launch)
    row["library_ms"] = graph_ms(lambda: torch.index_select(tab, 0, idx))
    return row


def run_one(name: str, lib_path: str) -> dict:
    """Times a built variant in a process of its own; its row, with
    ``error`` where that process failed."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{__package__}.gather_ablation", "--one", name, lib_path],
        capture_output=True, text=True, cwd=_build.PACKAGE_DIR.parent)
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return {"variant": name, "error": proc.stderr[-2000:]}


def measure(names) -> list:
    """Builds the named variants in parallel and times each in its own
    process, one after another in the order given (a name given twice is
    built once and timed twice: ``shipped div64 div64 shipped`` times two
    designs in turns); one row per name."""
    unique = list(dict.fromkeys(names))
    with ThreadPoolExecutor(len(unique)) as pool:
        libs = dict(zip(unique, pool.map(build, unique)))
    return [run_one(name, libs[name]) for name in names]


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_one(argv[1], argv[2])), flush=True)
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    rc = 0
    for row in measure(names):
        print(json.dumps(row), flush=True)
        rc |= "error" in row or row.get("bitwise_numpy") is False
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
