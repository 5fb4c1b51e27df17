"""Where the time of the microbenchmark's scatter kernel goes, on a card.

    python -m graph_neural_network_for_radar_perception_torch.scripts.scatter_ablation [VARIANT ...]

Builds variants of ``csrc/microbench_gather.cu`` by rewriting its
``scatter_add_rows_kernel`` — ablations that drop one of its phases (the
message sums; the listing of the indices that land; the staging of idx in
shared memory), layout variants (8 or 16 rows a block in place of one
block an SM) and variants of the sums (8 or 32 message loads in flight in
place of 16; loads clamped to the list's end in place of predicated on
it) — with one ``nvcc`` each, started together.  Each variant is timed in its own process (never two builds of
one library in one process), at the microbenchmark's shapes and inputs
(``microbench_gather.make_inputs``): ``scatter_add_rows`` replayed from a
CUDA graph (``utils/timing.graph_ms``) beside ``zeros + index_add_`` in the
same process.  The variants that keep the function are checked against
``np.add.at`` bit for bit; the ablations compute wrong results on purpose.
Prints one JSON line per variant.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import _build

OUT = _build.BUILD_DIR.parent / "scatter_variants"

_SUMS = "      for (int k = 0; k < cnt; k += kScatterBatch) {"
_HIT = "        r[k] = static_cast<unsigned>(v[k]) - static_cast<unsigned>(r0);"
_STAGE = "cp_async4(s_idx + i, idx + s0 + i);"
_ROWS = "  int rows = (n + sms - 1) / sms;"
_BATCH = "constexpr int kScatterBatch = 16;"
_LOAD = ("          v[j] = k + j < cnt ? msg[static_cast<size_t>(list[k + j]) * d4 + own_col]\n"
         "                             : make_float4(0.f, 0.f, 0.f, 0.f);")
_CLAMPED = "          v[j] = msg[static_cast<size_t>(list[min(k + j, cnt - 1)]) * d4 + own_col];"

# name -> (holds np.add.at's result?, [(old, new), ...])
VARIANTS = {
    "shipped": (True, []),
    "rows_8": (True, [(_ROWS, "  int rows = 8;")]),
    "rows_16": (True, [(_ROWS, "  int rows = 16;")]),
    "batch_8": (True, [(_BATCH, "constexpr int kScatterBatch = 8;")]),
    "batch_32": (True, [(_BATCH, "constexpr int kScatterBatch = 32;")]),
    "clamped_16": (True, [(_LOAD, _CLAMPED)]),
    "clamped_32": (True, [(_LOAD, _CLAMPED), (_BATCH, "constexpr int kScatterBatch = 32;")]),
    "no_sums": (False, [(_SUMS, _SUMS.replace("k < cnt", "k < 0"))]),
    "no_hits": (False, [(_HIT, "        r[k] = 0xffffffffu;")]),
    "no_stage_no_hits": (False, [(_HIT, "        r[k] = 0xffffffffu;"),
                                 (_STAGE, "s_idx[i] = -1;")]),
}


def rewrite(name: str, variants: dict = VARIANTS) -> str:
    """``csrc/microbench_gather.cu`` as variant ``name`` of ``variants``
    has it: each pattern (which must occur exactly once) replaced."""
    text = (_build.CSRC_DIR / "microbench_gather.cu").read_text()
    for old, new in variants[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: pattern not once in microbench_gather.cu: {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, variants: dict = VARIANTS, out=OUT) -> str:
    """The variant's library, built from its rewritten source."""
    out_dir = out / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "microbench_gather.cu", out_dir / "libmicrobench_gather.so"
    src.write_text(rewrite(name, variants))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    return str(lib)


def time_one(name: str, lib_path: str) -> dict:
    """Times one built variant (in this process) at the microbenchmark's
    shapes; checks it against np.add.at if it keeps the function."""
    import torch

    from ..utils.timing import graph_ms
    from . import microbench_gather as MB

    fn = ctypes.CDLL(lib_path).scatter_add_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx_np, _, msg_np = MB.make_inputs(0)
    dev = torch.device("cuda")
    idx = torch.from_numpy(idx_np[:, 0]).to(dev)
    msg = torch.from_numpy(msg_np).to(dev)
    out = torch.empty(MB.N, MB.D, device=dev)

    def launch():
        rc = fn(msg.data_ptr(), idx.data_ptr(), out.data_ptr(), MB.N, idx.shape[0], MB.D,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError_t {rc}")

    launch()
    torch.cuda.synchronize()
    row = {"variant": name, "device": torch.cuda.get_device_name(0)}
    if VARIANTS[name][0]:
        want = np.zeros((MB.N, MB.D), np.float32)
        np.add.at(want, idx_np[:, 0], msg_np)
        row["bitwise_np_add_at"] = bool(np.array_equal(out.cpu().numpy(), want))
    row["ms"] = graph_ms(launch)
    row["library_ms"] = graph_ms(
        lambda: torch.zeros(MB.N, MB.D, device=dev).index_add_(0, idx, msg))
    return row


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_one(argv[1], argv[2])), flush=True)
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    rc = 0
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", f"{__package__}.scatter_ablation", "--one", name,
             libs[name]],
            capture_output=True, text=True, cwd=os.getcwd())
        print(proc.stdout.strip() or json.dumps({"variant": name, "error": proc.stderr[-2000:]}),
              flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
