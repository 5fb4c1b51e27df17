#!/usr/bin/env python3
"""Where the time of the port's fused message-pass kernel goes, on a card.

    python3 scripts/torch_fused_mp_ablation.py

Builds variants of ``csrc/fused_mp.cu`` by rewriting its source — launch
shapes (warps per block, edges per warp, blocks per SM) and ablations that
drop one part of the work (the two weight loops, the node gathers, the two
channel norms, the weight staging, the scatter) — and times each at the
deploy shapes (N=768, E=15360, D=De=D2=64, H=128) with every edge live and
with a frame-like padded tail (9216 live edges), each variant in its own
process so that a fault in one cannot hide the others.  Ablated variants
compute wrong results on purpose; only the launch-shape variants are
checked against the plain version.  Needs a CUDA card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "fused_mp_variants")
N, D, DE, H, D2 = 768, 64, 64, 128, 64
E = 15360

_LOOP1 = "for (int k = 0; k < de; k += 4) {"
_LOOP2 = "for (int k = 0; k < h; k += 4) {"
_XA = "if (rok) v += operand<BF16>(xa[static_cast<size_t>(recv[j]) * h + c]);"
_XB = "if (sok) v += operand<BF16>(xb[static_cast<size_t>(send[j]) * h + c]);"
_STAGE1 = ("reinterpret_cast<float4*>(s_w1e)[i] =\n"
           "        operand<BF16>(reinterpret_cast<const float4*>(w1e)[i]);")
_STAGE2 = ("reinterpret_cast<float4*>(s_w2)[i] =\n"
           "        operand<BF16>(reinterpret_cast<const float4*>(w2)[i]);")
_NORM1 = "cnorm_lrelu<HPL>(a1, lane, h, g1, be1, slope);"
_NORM2 = "cnorm_lrelu<DPL>(a2, lane, d2, g2, be2, slope);"
_ATOMIC = "if (c < d2) atomicAdd(row + c, operand<BF16>(a2[j][t]));"

# name -> (checked against the plain version?, [(old, new), ...])
VARIANTS = {
    "shipped": (True, []),
    "warps16": (True, [("kWarps = 8;", "kWarps = 16;")]),
    "edges_per_warp4": (True, [("kEdgesPerWarp = 8;", "kEdgesPerWarp = 4;")]),
    "edges_per_warp16": (True, [("kEdgesPerWarp = 8;", "kEdgesPerWarp = 16;")]),
    "one_block_per_sm": (True, [("if (grid > 2 * sms) grid = 2 * sms;",
                                 "if (grid > sms) grid = sms;")]),
    "no_weight_loops": (False, [(_LOOP1, "for (int k = 0; k < 0; k += 4) {"),
                                (_LOOP2, "for (int k = 0; k < 0; k += 4) {")]),
    "no_layer1_loop": (False, [(_LOOP1, "for (int k = 0; k < 0; k += 4) {")]),
    "no_layer2_loop": (False, [(_LOOP2, "for (int k = 0; k < 0; k += 4) {")]),
    "no_gathers": (False, [(_XA, ""), (_XB, "")]),
    "no_norms": (False, [(_NORM1, ""), (_NORM2, "")]),
    "no_weight_staging": (False, [(_STAGE1, "if (i < 0) " + _STAGE1),
                                  (_STAGE2, "if (i < 0) " + _STAGE2)]),
    "no_scatter": (False, [(_ATOMIC, "if (c < d2 && a2[j][t] == 12345.f) row[c] = 0.f;")]),
}


def build_all(nvcc_flags, nvcc):
    src = open(os.path.join(REPO, "graph_neural_network_for_radar_perception_torch",
                            "csrc", "fused_mp.cu")).read()
    os.makedirs(OUT, exist_ok=True)

    def one(name):
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise RuntimeError(f"{name}: pattern not in fused_mp.cu: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        proc = subprocess.run([nvcc, *nvcc_flags, "-o", os.path.join(OUT, f"{name}.so"), cu],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(one, VARIANTS))


def time_variant(name):
    """Child process: time one variant; prints one JSON line."""
    import torch

    sys.path.insert(0, REPO)
    from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM

    fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).fused_mp_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_float, ctypes.c_void_p] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    result = {"variant": name}
    for live in (E, 9216):
        s = rng.integers(0, N, E).astype(np.int32)
        r = rng.integers(0, N, E).astype(np.int32)
        s[live:] = N
        r[live:] = N
        arrays = [rng.normal(size=(N, D)), rng.normal(size=(E, DE)), s, r,
                  rng.normal(size=(2 * D + DE, H)) / np.sqrt(2 * D + DE),
                  0.1 * rng.normal(size=H), rng.normal(size=(H, D2)) / np.sqrt(H),
                  0.1 * rng.normal(size=D2)]
        x, ef, s_t, r_t, w1, b1, w2, b2 = [
            torch.from_numpy(np.asarray(a, np.int32 if a.dtype == np.int32
                                        else np.float32)).cuda() for a in arrays]
        scal = torch.tensor([1.1, 0.05, 0.9, -0.02], device="cuda")
        xa, xb, w1e = x @ w1[:D], x @ w1[D:2 * D], w1[2 * D:]
        agg = torch.zeros(N, D2, device="cuda")
        raw = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), s_t.data_ptr(),
               r_t.data_ptr(), w1e.data_ptr(), b1.data_ptr(), w2.data_ptr(),
               b2.data_ptr(), scal.data_ptr(), 0.01, agg.data_ptr(), N, E, DE,
               H, D2, torch.cuda.current_stream().cuda_stream)
        if fn(*raw):
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if VARIANTS[name][0]:
            want = FM.fused_message_pass_reference(
                x, ef, s_t, r_t, w1, b1, w2, b2, 1.1, 0.05, 0.9, -0.02)
            if not bool(((agg - want).abs() <= 2e-5 + 2e-4 * want.abs()).all()):
                raise AssertionError(f"{name}: disagrees with the plain version")
        for _ in range(10):
            fn(*raw)
        torch.cuda.synchronize()
        times = []
        for _ in range(50):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                fn(*raw)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 20 * 1e3)
        result[f"us_live{live}"] = float(np.median(times))
    print(json.dumps(result), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    sys.path.insert(0, REPO)
    from graph_neural_network_for_radar_perception_torch.ops import _build

    build_all(_build.NVCC_FLAGS, _build.find_nvcc())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    failed = 0
    for name in VARIANTS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", name],
                              capture_output=True, text=True)
        if proc.returncode:
            failed += 1
            print(f"{name}: FAILED\n{proc.stderr[-1500:]}")
        else:
            print(proc.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
