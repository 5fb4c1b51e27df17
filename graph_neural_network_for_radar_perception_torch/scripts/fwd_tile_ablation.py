"""Where the time of the forward edge kernel goes, on a card.

    python -m graph_neural_network_for_radar_perception_torch.scripts.fwd_tile_ablation [VARIANT ...]

Builds variants of the forward edge-tile core that both forwards share
(``fwd_edge_kernel`` of ``csrc/mp_edge_tile.cuh``) by rewriting the header,
each compiled with ``csrc/fused_mp.cu`` and with ``csrc/csr_mp.cu`` into
libraries of its own (one ``nvcc`` each, all started together): launch
variants (16- and 64-edge tiles, 2 x 4 register tiles in place of 4 x 4)
and ablations that drop one part of the edge kernel's work (the products,
the norms, the input staging, every tile).  Each variant is timed in its
own process (never two builds of one library in one process) at the
forwards' timing problems, D=De=D2=64, H=128: the fused round on N=768,
E=15360 with 9216 live edges and random receivers, the CSR round on
``chip_smoke.py``'s [kernel-csr] timing problem, a kNN graph (k=10) of
N=768 nodes padded to E=15360 (so run it from the repo's root).  For
each: its f32 C entry
point with CUDA events, and the device kernels of one call from
``torch.profiler``.  The variants that keep the function are checked
against the shipped build's agg on the same problems (rtol 2e-4, atol
2e-5: other summation orders); the ablations compute wrong results on
purpose.  Prints one JSON line per variant.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import _build
from . import edge_tile_ablation as EA

OUT = _build.BUILD_DIR.parent / "fwd_tile_variants"
N, E, D, DE, H, D2 = 768, 15360, 64, 64, 128, 64
RTOL, ATOL = 2e-4, 2e-5
SOURCES = ("fused_mp", "csr_mp")

# fwd_plan's largest tile (bwd_plan's loop names its stages `stages`).
_TILE = "for (int t = 32; t >= 8; t /= 2)\n    for (int s = 2;"
_DISPATCH = "MP_FWD(32) MP_FWD(16) MP_FWD(8)"
# fwd_edge_kernel's threads-a-row assert (the lines after it are not the
# backward's).
_RT = "RT >= 8 && RT <= 32, \"8 to 32 threads a row\");\n  extern __shared__ __align__(16) float smem[];\n  const int lde = de + kPad, ldh = h + kPad, ldd = d2 + kPad;\n  const int stage_f = T * (lde + 2 * ldh);"
_STAGE = [(f"for (int c = 4 * part; c < {w}; c += 4 * RT) cp_async16({dst}",
           f"for (int c = 4 * part; c < 0; c += 4 * RT) cp_async16({dst}")
          for w, dst in (("de", "r_ef"), ("h", "r_xa"), ("h", "r_xb"))]

# name -> (keeps the function?, [(old, new), ...] in mp_edge_tile.cuh)
VARIANTS = {
    "shipped": (True, []),
    "tile_16": (True, [(_TILE, _TILE.replace("32", "16"))]),
    "tile_64": (True, [(_TILE, _TILE.replace("32", "64")),  # 4 threads a row
                       (_DISPATCH, "MP_FWD(64) " + _DISPATCH),
                       (_RT, _RT.replace("RT >= 8", "RT >= 4"))]),
    "rows_2x4": (True, [("constexpr int RM = 4;", "constexpr int RM = 2;")]),
    "no_products": (False, [("for (int k = 0; k < K; k += 4) {",
                             "for (int k = 0; k < 0; k += 4) {")]),
    "no_norms": (False, [
        ("const float sd1 = centre_row<RT>(u1, h, part, inv_h, inv_hm1);",
         "const float sd1 = 1.f;"),
        ("const float sd2 = centre_row<RT>(u2, d2, part, inv_d2, inv_d2m1);",
         "const float sd2 = 1.f;")]),
    "no_stage": (False, _STAGE),
    "no_tiles": (False, [("for (int i = 0; i < tiles; ++i) {",
                          "for (int i = 0; i < 0; ++i) {")]),
}


def time_one(name: str, fused_lib: str, csr_lib: str) -> dict:
    """Times one built variant's forwards (in this process); checks them
    against the shipped build's outputs (saved by the shipped variant's run)
    if it keeps the function."""
    import torch

    import chip_smoke
    from ..ops import csr_mp as C
    from ..ops import fused_mp as FM
    from ..utils.timing import event_ms, kernel_breakdown

    libs = {"fused_mp": ctypes.CDLL(fused_lib), "csr_mp": ctypes.CDLL(csr_lib)}
    FM.load = C.load = libs.__getitem__  # this variant's libraries, and only them
    dev = torch.device("cuda")
    emp = functools.partial(torch.empty, device=dev)

    (x, ef, s, r, w1, b1, w2, b2), scal, _ = EA.problem(torch)
    layout = FM.fused_layout(s, r, N)
    xa, xb, w1e = x @ w1[:D], x @ w1[D:2 * D], w1[2 * D:]
    msgs, agg = emp(E, D2), emp(N, D2)
    fused_raw = (xa.data_ptr(), xb.data_ptr(), ef.data_ptr(), s.data_ptr(), r.data_ptr(),
                 layout.recv_order.data_ptr(), layout.recv_off.data_ptr(), w1e.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), scal.data_ptr(), 0.01,
                 msgs.data_ptr(), agg.data_ptr(), N, E, DE, H, D2, 1,
                 torch.cuda.current_stream().cuda_stream)
    _, cargs, _ = chip_smoke.csr_problems(torch, np.random.default_rng(5))[0]
    cscal = torch.cat(cargs[8:])
    clayout = C.csr_layout(cargs[2], cargs[3], N, 512, 256, 0)
    xab, cmsgs, cagg = emp(2, N, H), emp(E, D2), emp(N, D2)
    csr_raw = (cargs[0].data_ptr(), cargs[1].data_ptr(), clayout.src.data_ptr(),
               clayout.dst.data_ptr(), clayout.off.data_ptr(), cargs[4].data_ptr(),
               cargs[5].data_ptr(), cargs[6].data_ptr(), cargs[7].data_ptr(),
               cscal.data_ptr(), xab.data_ptr(), 0.01, cmsgs.data_ptr(),
               cagg.data_ptr(), N, E, D, DE, H, D2, 1, torch.cuda.current_stream().cuda_stream)
    rounds = {"fused": (FM._kernel(False), fused_raw, agg),
              "csr": (C._kernel(False), csr_raw, cagg)}

    row = {"variant": name, "device": torch.cuda.get_device_name(0),
           "plan": FM._forward_plan(N, E, DE, H, D2, dev)._asdict()}
    got = {}
    for key, (fn, raw, out) in rounds.items():
        def launch(fn=fn, raw=raw):
            rc = fn(*raw)
            if rc != 0:
                raise RuntimeError(f"{name} {key}: cudaError_t {rc}")

        launch()
        torch.cuda.synchronize()
        got[key] = out.cpu()
        launches = kernel_breakdown(launch)
        row[key] = {"entry_us": event_ms(launch) * 1e3,
                    "edge_kernel_us": sum(us for k, us in launches if "fwd_edge_kernel" in k),
                    "device_us": sum(us for _, us in launches),
                    "device_kernels_us": [
                        [k.replace("void ", "").replace("(anonymous namespace)::", "")
                         .split("(")[0], us] for k, us in launches]}
    ref = OUT / "shipped_outputs.pt"
    if name == "shipped":
        torch.save(got, ref)
    elif VARIANTS[name][0]:
        want = torch.load(ref)
        for key, a in got.items():
            if not bool(((a - want[key]).abs() <= ATOL + RTOL * want[key].abs()).all()):
                raise AssertionError(f"{name}: the {key} forward disagrees with the shipped build")
        row["within_tolerance_of_shipped"] = True
    return row


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_one(*argv[1:4])), flush=True)
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    # The shipped build runs first: the others are checked against it.
    names = ["shipped"] + [n for n in names if n != "shipped"]
    jobs = [(n, s) for n in names for s in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: EA.build(j[0], j[1], VARIANTS, OUT), jobs))
    libs = dict(zip(jobs, built))
    rc = 0
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", f"{__package__}.fwd_tile_ablation", "--one", name,
             libs[name, "fused_mp"], libs[name, "csr_mp"]],
            capture_output=True, text=True, cwd=os.getcwd())
        print(proc.stdout.strip() or json.dumps({"variant": name, "error": proc.stderr[-2000:]}),
              flush=True)
        rc |= proc.returncode
        if name == "shipped" and proc.returncode:
            return rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
