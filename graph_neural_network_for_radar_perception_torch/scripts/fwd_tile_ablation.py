"""Where the time of the forward edge kernel goes, on a card.

    python -m graph_neural_network_for_radar_perception_torch.scripts.fwd_tile_ablation [VARIANT ...]

Builds variants of the forward edge-tile core that both forwards share
(``fwd_edge_kernel`` and ``fwd_edge_kernel_bf16`` of
``csrc/mp_edge_tile.cuh``) by rewriting the header, each compiled with
``csrc/fused_mp.cu`` and with ``csrc/csr_mp.cu`` into libraries of its own
(one ``nvcc`` each, all started together): f32 launch variants (16- and
64-edge tiles, 2 x 4 register tiles in place of 4 x 4), ablations that
drop one part of the f32 edge kernel's work (the products, the norms, the
input staging, every tile), the bf16 edge kernel's tiles (32, 64 or 128
edges, with one or two input stages: ``bf16_t<T>_s<S>``; 128 edges in two
stages do not fit a block at the shipped widths; ``bf16_t32_s1`` is the
shipped plan there, two blocks an SM; ``bf16_twice_the_blocks`` 2 x 132
blocks a graph) and its ablations
(``bf16_no_*``: the products, the norms, the input staging, the weights'
staging, every tile).  Each variant is
timed in its own process (never two builds of one library in one process)
at the forwards' timing problems, D=De=D2=64, H=128: the fused round on
N=768, E=15360 with 9216 live edges and random receivers, the CSR round on
``chip_smoke.py``'s [kernel-csr] timing problem, a kNN graph (k=10) of
N=768 nodes padded to E=15360 (so run it from the repo's root).  For each:
its f32 C entry points at B = 1 and its bf16 ones at B = 1 and at B = 8
(8 such graphs in one call, ``chip_smoke.batched_round``) with CUDA
events, and the device kernels of one call from ``torch.profiler``.  The
variants that keep the function are checked against the shipped build's
agg on the same problems: f32 at rtol 2e-4, atol 2e-5 (other summation
orders), bf16 at ``chip_smoke``'s bf16 tolerance but for a few flipped
roundings (another tile has other threads a row, so other norm sums), and
a variant that leaves the f32 kernel as it is must give its bits; the
ablations compute wrong results on purpose.  Prints one JSON line per
variant.  Needs a CUDA card and nvcc.
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

# fwd_plan's bf16 tile, its choice of one stage where two blocks fit an
# SM, its input stages and its blocks a graph.
_BF16_TILE = "constexpr int kBf16Tile = 32;"
_BF16_TWO = "if (2 * (one + reserved) <= static_cast<size_t>(per_sm)) {"
_BF16_STAGES = "for (int st = 2; st >= 1; --st) {"
_BF16_BLOCKS = "blocks = edge_blocks((e + tile - 1) / tile, sms);"


def _bf16(tile: int, stages: int) -> list:
    """The bf16 edge kernel at `tile` edges and `stages` input stages only
    (as many blocks an SM as its resources let share one)."""
    return [(_BF16_TILE, _BF16_TILE.replace("32", str(tile))),
            (_BF16_TWO, "if (false) {"),
            (_BF16_STAGES, _BF16_STAGES.replace("st = 2; st >= 1", f"st = {stages}; st >= {stages}"))]

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
    **{f"bf16_t{t}_s{s}": (True, _bf16(t, s))
       for t, s in ((32, 2), (32, 1), (64, 2), (64, 1), (128, 1))},
    "bf16_twice_the_blocks": (True, [(_BF16_BLOCKS, _BF16_BLOCKS.replace(", sms)", ", 2 * sms)"))]),
    # The bf16 edge kernel without one part of its work (its f32 twin's
    # ablations above).
    "bf16_no_products": (False, [("for (int k0 = 0; k0 < K; k0 += 16) {",
                                  "for (int k0 = 0; k0 < 0; k0 += 16) {")]),
    "bf16_no_norms": (False, [
        ("const float sd_a = centre_row<RT>(u, h, part, inv_h, inv_hm1);", "const float sd_a = 1.f;"),
        ("const float sd_b = centre_row<RT>(u, d2, part, inv_d2, inv_d2m1);",
         "const float sd_b = 1.f;")]),
    "bf16_no_stage": (False, [(f"for (int c = 4 * part; c < {w}; c += 4 * RT) cp_async16({dst}",
                               f"for (int c = 4 * part; c < 0; c += 4 * RT) cp_async16({dst}")
                              for w, dst in (("de", "l_ef"), ("h", "l_xa"), ("h", "l_xb"))]),
    "bf16_no_weights": (False, [(f"  round_into<kEdgeThreads>(s_w{i}, ",
                                 f"  if (de < 0) round_into<kEdgeThreads>(s_w{i}, ") for i in (1, 2)]),
    "bf16_no_tiles": (False, [("for (int it = 0; it < ntile; ++it) {",
                               "for (int it = 0; it < 0; ++it) {")]),
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
              "csr": (C._kernel(False), csr_raw, cagg),
              "fused_bf16": (FM._kernel(True), fused_raw, agg),
              "csr_bf16": (C._kernel(True), csr_raw, cagg)}
    # B = 8: 8 graphs of the same kinds in one call each (node products and
    # layouts made once).
    rng = np.random.default_rng(21)
    f8 = chip_smoke.batched_round(torch, [chip_smoke.kernel_problem(torch, rng, 9216 - 512 * g, E)
                                          for g in range(8)])
    fscal = torch.cat(f8[8:])
    f8_layout = FM.fused_layout(f8[2], f8[3], N)  # alive while the raw pointers are
    f8_raw, f8_out = FM._forward_launch(*f8[:8], fscal, 0.01, f8_layout)
    c8 = chip_smoke.batched_round(torch, [chip_smoke.csr_problem(torch, rng, chip_smoke.knn_edges(
        rng, N, 10), E) for _ in range(8)])
    c8_layout, c8_scal = C.csr_layout(c8[2], c8[3], N, 512, 256, 0), torch.cat(c8[8:])
    c8_raw, c8_out = C._forward_launch(c8[0], c8[1], c8_layout, *c8[4:8], c8_scal, 0.01)
    rounds["fused_bf16_b8"] = (FM._kernel(True), f8_raw, f8_out[1])
    rounds["csr_bf16_b8"] = (C._kernel(True), c8_raw, c8_out[1])

    row = {"variant": name, "device": torch.cuda.get_device_name(0),
           "plan": FM._forward_plan(N, E, DE, H, D2, dev)._asdict(),
           "plan_bf16": FM._plan("fused_mp", "fused_mp_forward_bf16_plan", dev,
                                 N, E, DE, H, D2)._asdict()}
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
            if "bf16" in key:
                _bf16_close(chip_smoke, a, want[key], f"{name} {key}")
            elif name.startswith("bf16"):  # the f32 kernel as shipped: its bits
                if not torch.equal(a, want[key]):
                    raise AssertionError(f"{name}: the {key} forward changed its bits")
            elif not bool(((a - want[key]).abs() <= ATOL + RTOL * want[key].abs()).all()):
                raise AssertionError(f"{name}: the {key} forward disagrees with the shipped build")
        row["within_tolerance_of_shipped"] = True
    return row


def _bf16_close(cs, got, want, what: str) -> None:
    """``got`` within chip_smoke's bf16 tolerance of ``want`` but for a
    few flipped roundings (BF16_FLIP_SHARE, each within 2^-7 of max |want|)."""
    tol = cs.BF16_ATOL + cs.BF16_RTOL * want.abs()
    err = (got - want).abs()
    allowed = max(4, int(cs.BF16_FLIP_SHARE * want.numel()))
    flip = 2.0 ** -7 * float(want.abs().max())
    if int((err > tol).sum()) > allowed or bool((err > tol + flip).any()):
        raise AssertionError(f"{what}: outside the bf16 tolerance of the shipped build")


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
