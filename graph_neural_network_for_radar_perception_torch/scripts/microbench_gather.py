"""Microbenchmark: row gather and row scatter-add on the card.

The port of ``scripts/microbench_gather.py``, whose TPU kernels compared
ways to express a dynamic row gather inside a Pallas kernel (a one-hot
matmul, ``jnp.take``, a loop of row slices) and the matching scatter-add.
Here each is one hand-written CUDA kernel (``csrc/microbench_gather.cu``):

* ``gather_rows(table, idx)``: out[i] = table[idx[i]];
* ``scatter_add_rows(msg, idx, n)``: out[idx[i]] += msg[i] into [n, d] zeros,
  each row's messages added in index order (``np.add.at``'s sum, bit for
  bit, on every launch).

Index semantics are the one-hot body's (the TPU baseline): an index outside
[0, n) gathers a zero row, and its message is dropped.  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version (``gather_rows_reference``, ``scatter_add_rows_reference``).
Every launch issued from the host is counted where it is issued
(``gather_rows.launches``, ``scatter_add_rows.launches``): a call captured
into a CUDA graph counts once, at capture, and its replays do not.

``main()`` runs the benchmark at the TPU script's shapes (N=768 rows of D=64,
TILES·TE = 30·512 = 15 360 indices, inputs seeded with numpy as there),
checks both kernels against numpy (bitwise), times with CUDA events the kernel, the
plain version and the one PyTorch call that computes the same function
(``torch.index_select``, ``Tensor.index_add_``), and prints one JSON line.
These launches are shorter than the host needs to issue one, so ``ms``,
``plain_ms`` and ``library_ms`` are device times per call, replayed from a
CUDA graph; ``launch_ms``, ``wrapper_ms`` and ``library_launch_ms`` time
calls issued back to back from Python, host cost included.  It needs a CUDA
card:

    python -m graph_neural_network_for_radar_perception_torch.scripts.microbench_gather
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from ..ops._build import load
from ..utils.timing import PEAK_BYTES_PER_S, event_ms, graph_ms

N, D, TE, TILES = 768, 64, 512, 30  # the TPU script's shapes
# The kernel against its plain version on the card, whose index_add_ adds
# each row's ~20 messages in another order (atomics); against np.add.at the
# kernel is exact.
SCATTER_TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ plain versions
def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] = table [N, D] rows at idx [M]; zero rows outside [0, N)."""
    n, d = table.shape
    i = idx.long()
    i = torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    return torch.cat([table, table.new_zeros(1, d)]).index_select(0, i)


def scatter_add_rows_reference(msg: torch.Tensor, idx: torch.Tensor,
                               n: int) -> torch.Tensor:
    """out [n, D] = Σ_{i: idx[i]=v} msg[i]; messages outside [0, n) dropped."""
    i = idx.long()
    i = torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    return msg.new_zeros(n + 1, msg.shape[1]).index_add_(0, i, msg)[:n]


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _kernels():
    """The two C entry points, built and loaded on first use."""
    lib = load("microbench_gather")
    for fn in (lib.gather_rows, lib.scatter_add_rows):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, rows, idx, d_from):
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"{name}: {d_from} must be a contiguous 2-D float32 "
                         f"tensor, got {tuple(rows.shape)} {rows.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous 1-D int32 tensor, "
                         f"got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != rows.device:
        raise ValueError(f"{name}: idx on {idx.device}, {d_from} on {rows.device}")
    if rows.device.type == "cpu":
        return
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if rows.shape[1] % 4 or rows.data_ptr() % 16:
        raise ValueError(f"{name} kernel: rows of a multiple of 4 floats on a "
                         f"16-byte boundary, got D={rows.shape[1]}")


def _run(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_gather(table, idx, out) -> None:
    """One launch of the gather kernel into ``out``, counted in
    ``gather_rows.launches``."""
    n, d = table.shape
    with torch.cuda.device(table.device):
        _run(_kernels().gather_rows(table.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), n, idx.shape[0], d,
                                    _stream()), "gather_rows")
    gather_rows.launches += 1


def _launch_scatter(msg, idx, out) -> None:
    """One launch of the scatter kernel into ``out`` (every row written),
    counted in ``scatter_add_rows.launches``."""
    with torch.cuda.device(msg.device):
        _run(_kernels().scatter_add_rows(msg.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), out.shape[0],
                                         msg.shape[0], msg.shape[1],
                                         _stream()), "scatter_add_rows")
    scatter_add_rows.launches += 1


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [M, D] f32 = table [N, D] f32 rows at idx [M] int32; an index
    outside [0, N) gives a zero row.  CUDA tensors launch the kernel (or
    raise); CPU tensors run ``gather_rows_reference``."""
    _check("gather_rows", table, idx, "table")
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    out = torch.empty(idx.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    if idx.shape[0]:  # no rows, no launch
        _launch_gather(table, idx, out)
    return out


def scatter_add_rows(msg: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out [n, D] f32 with out[idx[i]] += msg[i] for msg [M, D] f32 and idx
    [M] int32; messages whose index lies outside [0, n) are dropped.  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    ``scatter_add_rows_reference``.  On the card each row's messages are
    added in index order, as ``np.add.at`` adds them: the same bits, on
    every launch."""
    _check("scatter_add_rows", msg, idx, "msg")
    if idx.shape[0] != msg.shape[0]:
        raise ValueError(f"scatter_add_rows: {idx.shape[0]} indices for "
                         f"{msg.shape[0]} messages")
    if msg.device.type == "cpu":
        return scatter_add_rows_reference(msg, idx, n)
    out = torch.empty(n, msg.shape[1], dtype=torch.float32, device=msg.device)
    _launch_scatter(msg, idx, out)
    return out


gather_rows.launches = 0
scatter_add_rows.launches = 0


# ------------------------------------------------------------ the benchmark
def make_inputs(seed: int = 0):
    """(idx [TILES·TE, 1] int32, table [N, D], msg [TILES·TE, D]) as the TPU
    script's ``main`` draws them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (TILES * TE, 1)).astype(np.int32)
    tab = rng.normal(size=(N, D)).astype(np.float32)
    msg = rng.normal(size=(TILES * TE, D)).astype(np.float32)
    return idx, tab, msg


def moved_bytes(n: int, m: int, d: int) -> int:
    """Bytes either function must move: m indices and m rows of d floats
    on one side, n rows of d floats on the other, each once."""
    return 4 * (m + m * d + n * d)


def run(seed: int = 0) -> dict:
    """The benchmark on the card: both kernels checked against numpy (the
    gather against indexing, the scatter against ``np.add.at``, bitwise),
    then timed beside their wrappers, plain versions and library calls.
    Raises without a card or on a wrong result."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmark measures the card: no CUDA device")
    idx_np, tab_np, msg_np = make_inputs(seed)
    dev = torch.device("cuda")
    idx = torch.from_numpy(idx_np[:, 0]).to(dev)
    tab, msg = torch.from_numpy(tab_np).to(dev), torch.from_numpy(msg_np).to(dev)
    m = idx.shape[0]
    want_g = tab_np[idx_np[:, 0]]
    want_s = np.zeros((N, D), np.float32)
    np.add.at(want_s, idx_np[:, 0], msg_np)

    got_g = gather_rows(tab, idx)
    got_s = scatter_add_rows(msg, idx, N)
    again_s = scatter_add_rows(msg, idx, N)
    torch.cuda.synchronize()
    err_g = float(np.abs(got_g.cpu().numpy() - want_g).max())
    err_s = float(np.abs(got_s.cpu().numpy() - want_s).max())
    if err_g != 0.0:
        raise AssertionError(f"gather_rows differs from numpy: {err_g}")
    if err_s != 0.0 or not torch.equal(got_s, again_s):
        raise AssertionError(f"scatter_add_rows differs from np.add.at ({err_s}) "
                             "or from launch to launch")

    def times(launch, wrapper, plain, library):
        return {"ms": graph_ms(launch), "plain_ms": graph_ms(plain),
                "library_ms": graph_ms(library), "launch_ms": event_ms(launch),
                "wrapper_ms": event_ms(wrapper),
                "library_launch_ms": event_ms(library),
                "bound_ms": moved_bytes(N, m, D) / PEAK_BYTES_PER_S * 1e3}

    out_g = torch.empty(m, D, device=dev)
    out_s = torch.empty(N, D, device=dev)
    gather = times(lambda: _launch_gather(tab, idx, out_g),
                   lambda: gather_rows(tab, idx),
                   lambda: gather_rows_reference(tab, idx),
                   lambda: torch.index_select(tab, 0, idx))
    scatter = times(lambda: _launch_scatter(msg, idx, out_s),
                    lambda: scatter_add_rows(msg, idx, N),
                    lambda: scatter_add_rows_reference(msg, idx, N),
                    lambda: torch.zeros(N, D, device=dev).index_add_(0, idx, msg))
    return {"device": torch.cuda.get_device_name(0),
            "shapes": {"N": N, "D": D, "rows": m, "TE": TE, "TILES": TILES},
            "bytes": moved_bytes(N, m, D),
            "gather": dict(gather, max_abs_err=err_g, deterministic=True),
            "scatter": dict(scatter, max_abs_err=err_s,
                            deterministic=bool(torch.equal(got_s, again_s)))}


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_gather: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
