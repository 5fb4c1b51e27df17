#!/usr/bin/env python3
"""Where the time of the port's CSR backward edge kernel goes, on a card.

    python3 scripts/torch_csr_bwd_ablation.py [VARIANT ...]

Builds variants of ``csrc/csr_mp.cu`` by rewriting its source — ablations
that drop one part of ``csr_bwd_edge_kernel``'s work (the row products,
the weight-gradient products, both) and launch variants (one input stage,
16- and 8-edge tiles, no unrolling of the row products' k-loop, 2 x 4 and
8 x 4 register tiles for the row products in place of 4 x 4) — and times
each at the timing problem of ``chip_smoke.py --phase kernel-csr-bwd``
(kNN k=10, N=768, E=15360, D=De=D2=64, H=128): the C entry point with
CUDA events and each device
kernel of one call from ``torch.profiler``, each variant in its own
process so that a fault in one cannot hide the others.  Ablated variants
compute wrong results on purpose; the others are checked against the
plain version.  Prints one JSON line per variant.  Needs a CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "csr_bwd_variants")

_ROW_K = "for (int k = 0; k < K; k += 4) {"
_XTY_T = "for (int t = 0; t < rows; ++t) {\n    const float4 x0"
_UNROLL = "#pragma unroll 2\n    for (int k = 0; k < K; k += 4) {"
_RM = "constexpr int RM = 4;"
_NO_PRODUCTS = [(_ROW_K, "for (int k = 0; k < 0; k += 4) {"),
                (_XTY_T, _XTY_T.replace("t < rows", "t < 0"))]
_NORMS = [("const float sd = centre_row<RT>(u, h, part, inv_h, inv_hm1);", "const float sd = 1.f;"),
          ("const float sd = centre_row<RT>(u, d2, part, inv_d2, inv_d2m1);", "const float sd = 1.f;"),
          ("      cnorm_act_bwd_row<RT>(s_g2", "      if (part < 0) cnorm_act_bwd_row<RT>(s_g2"),
          ("      cnorm_act_bwd_row<RT>(g, s_p1", "      if (part < 0) cnorm_act_bwd_row<RT>(g, s_p1")]
_STAGES = "for (int stages = 2; stages >= 1; --stages) {"
_TILES = "for (int t = 32; t >= 8; t /= 2)"
_STAGE = [(f"for (int c = 4 * part; c < {w}; c += 4 * RT) cp_async16({dst}",
           f"for (int c = 4 * part; c < 0; c += 4 * RT) cp_async16({dst}")
          for w, dst in (("de", "s_ef"), ("h", "s_xa"), ("h", "s_xb"), ("d2", "s_go"))]

# name -> (checked against the plain version?, [(old, new), ...])
VARIANTS = {
    "shipped": (True, []),
    "one_stage": (True, [(_STAGES, _STAGES.replace("= 2", "= 1"))]),
    "tile_16": (True, [(_TILES, _TILES.replace("= 32", "= 16"))]),
    "tile_8": (True, [(_TILES, _TILES.replace("= 32", "= 8"))]),
    "no_unroll": (True, [(_UNROLL, "for (int k = 0; k < K; k += 4) {")]),
    "rows_2x4": (True, [(_RM, "constexpr int RM = 2;")]),
    "rows_8x4": (True, [(_RM, "constexpr int RM = 8;")]),
    "no_row_products": (False, _NO_PRODUCTS[:1]),
    "no_xty_products": (False, _NO_PRODUCTS[1:]),
    "no_products": (False, _NO_PRODUCTS),
    "no_products_no_norms": (False, _NO_PRODUCTS + _NORMS),
    "no_products_no_stage": (False, _NO_PRODUCTS + _STAGE),
    "no_tiles": (False, [("for (int i = 0; i < nt; ++i) {", "for (int i = 0; i < 0; ++i) {")]),
}


def build_all(nvcc_flags, nvcc, names):
    src = open(os.path.join(REPO, "graph_neural_network_for_radar_perception_torch",
                            "csrc", "csr_mp.cu")).read()
    os.makedirs(OUT, exist_ok=True)

    def one(name):
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise RuntimeError(f"{name}: pattern not in csr_mp.cu: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        proc = subprocess.run([nvcc, *nvcc_flags, "-o", os.path.join(OUT, f"{name}.so"), cu],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")

    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(one, names))


def time_variant(name):
    """Child process: time one variant; prints one JSON line."""
    import torch

    sys.path.insert(0, REPO)
    from chip_smoke import csr_bwd_timing_problem

    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C
    from graph_neural_network_for_radar_perception_torch.utils.timing import (
        event_ms,
        kernel_breakdown,
    )

    # Only this variant's library is loaded: two builds of one kernel in
    # one process have misbehaved on the card.
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    fn, plan = lib.csr_mp_backward, lib.csr_mp_backward_scratch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_float] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_longlong
    C._bwd_scratch = lambda: plan  # the buffers as this variant plans them
    args, g, _, raw, results = csr_bwd_timing_problem(torch, C)
    if VARIANTS[name][0]:
        # Against the plain version, without the edges at a leaky-ReLU kink.
        from chip_smoke import CSR_TILE, CSR_WINDOW, N, drop_kink_edges_csr

        kept, _ = drop_kink_edges_csr(torch, args)
        layout = C.csr_layout(kept[2], kept[3], N, CSR_TILE, CSR_WINDOW, 0)
        raw_k, results_k = C._backward_launch(
            kept[0], kept[1], layout, *kept[4:8], torch.cat(kept[8:]), g, 0.01)
        if fn(*raw_k):
            raise RuntimeError(f"{name}: launch failed")
        want = C.fused_message_pass_csr_backward_reference(
            *kept, g, 0.01, CSR_TILE, CSR_WINDOW)
        for a, b in zip(results_k(), want):
            if not bool(((a.reshape(b.shape) - b).abs() <= 5e-5 + 5e-4 * b.abs()).all()):
                raise AssertionError(f"{name}: disagrees with the plain version")
    if fn(*raw):
        raise RuntimeError(f"{name}: launch failed")
    torch.cuda.synchronize()
    launches = kernel_breakdown(lambda: fn(*raw))
    print(json.dumps({
        "variant": name,
        "entry_us": event_ms(lambda: fn(*raw)) * 1e3,
        "edge_kernel_us": sum(us for k, us in launches if "csr_bwd_edge_kernel" in k),
        "device_us": sum(us for _, us in launches),
    }), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    sys.path.insert(0, REPO)
    from chip_smoke import card

    from graph_neural_network_for_radar_perception_torch.ops import _build

    names = sys.argv[1:] or list(VARIANTS)
    build_all(_build.NVCC_FLAGS, _build.find_nvcc(), names)
    print(f"card: {card()}")
    failed = 0
    for name in names:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", name],
                              capture_output=True, text=True)
        if proc.returncode:
            failed += 1
            print(f"{name}: FAILED\n{proc.stderr[-1500:]}")
        else:
            print(proc.stdout.strip().splitlines()[-1])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
