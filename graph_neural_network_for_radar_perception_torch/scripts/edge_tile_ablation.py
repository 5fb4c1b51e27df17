"""Where the time of the backward edge kernel goes, on a card.

    python -m graph_neural_network_for_radar_perception_torch.scripts.edge_tile_ablation [VARIANT ...]

Builds variants of the edge-tile core that both backwards share
(``bwd_edge_kernel`` of ``csrc/mp_edge_tile.cuh``) by rewriting the
header, each compiled with ``csrc/fused_mp.cu`` into a library of its own
(one ``nvcc`` each, started together): ablations that drop one part of
the edge kernel's work (the row products, the weight-gradient products,
both; then also the norms, the input staging or every tile) and launch
variants (one input stage, 16- and 8-edge tiles, no unrolling of the row
products' k-loop, 2 x 4 and 8 x 4 register tiles in place of 4 x 4).  Each
variant is timed in its own process (never two builds of one library in
one process) at the fused backward's timing problem (N=768, E=15360 with
9216 live edges and random receivers, D=De=D2=64, H=128): the
``fused_mp_backward`` C entry point with CUDA events and the edge kernel
of one call from ``torch.profiler``.  The variants that keep the function
are checked against the shipped build's outputs on the same problem (rtol
5e-4, atol 5e-5: other summation orders); the ablations compute wrong
results on purpose.  Prints one JSON line per variant.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import _build

OUT = _build.BUILD_DIR.parent / "edge_tile_variants"
N, E, E_LIVE, D, DE, H, D2 = 768, 15360, 9216, 64, 64, 128, 64
RTOL, ATOL = 5e-4, 5e-5

_ROW_K = "for (int k = 0; k < K; k += 4) {"
_XTY_T = "for (int t = 0; t < rows; ++t) {\n    const float4 x0"
_UNROLL = "#pragma unroll 2\n    for (int k = 0; k < K; k += 4) {"
_RM = "constexpr int RM = 4;"
_NO_PRODUCTS = [(_ROW_K, "for (int k = 0; k < 0; k += 4) {"),
                (_XTY_T, _XTY_T.replace("t < rows", "t < 0"))]
_NORMS = [("const float sd = centre_row<RT>(u, h, part, inv_h, inv_hm1);",
           "const float sd = 1.f;"),
          ("const float sd = centre_row<RT>(u, d2, part, inv_d2, inv_d2m1);",
           "const float sd = 1.f;"),
          ("      cnorm_act_bwd_row<RT>(s_g2", "      if (part < 0) cnorm_act_bwd_row<RT>(s_g2"),
          ("      cnorm_act_bwd_row<RT>(g, s_p1", "      if (part < 0) cnorm_act_bwd_row<RT>(g, s_p1")]
_STAGES = "for (int stages = 2; stages >= 1; --stages) {"
# bwd_plan's largest tile (fwd_plan's loop names its stages `s`).
_TILES = "for (int t = 32; t >= 8; t /= 2)\n    for (int stages = 2;"
_STAGE = [(f"for (int c = 4 * part; c < {w}; c += 4 * RT) cp_async16({dst}",
           f"for (int c = 4 * part; c < 0; c += 4 * RT) cp_async16({dst}")
          for w, dst in (("de", "s_ef"), ("h", "s_xa"), ("h", "s_xb"), ("d2", "s_go"))]

# name -> (keeps the function?, [(old, new), ...] in mp_edge_tile.cuh)
VARIANTS = {
    "shipped": (True, []),
    "one_stage": (True, [(_STAGES, _STAGES.replace("= 2", "= 1"))]),
    "tile_16": (True, [(_TILES, _TILES.replace("= 32", "= 16"))]),
    "tile_8": (True, [(_TILES, _TILES.replace("= 32", "= 8"))]),
    "no_unroll": (True, [(_UNROLL, _ROW_K)]),
    "rows_2x4": (True, [(_RM, "constexpr int RM = 2;")]),
    "rows_8x4": (True, [(_RM, "constexpr int RM = 8;")]),
    "no_row_products": (False, _NO_PRODUCTS[:1]),
    "no_xty_products": (False, _NO_PRODUCTS[1:]),
    "no_products": (False, _NO_PRODUCTS),
    "no_products_no_norms": (False, _NO_PRODUCTS + _NORMS),
    "no_products_no_stage": (False, _NO_PRODUCTS + _STAGE),
    "no_tiles": (False, [("for (int i = 0; i < nt; ++i) {", "for (int i = 0; i < 0; ++i) {")]),
}


def rewrite(name: str, variants: dict = VARIANTS) -> str:
    """The header as variant ``name`` of ``variants`` has it."""
    text = (_build.CSRC_DIR / "mp_edge_tile.cuh").read_text()
    for old, new in variants[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: pattern not once in mp_edge_tile.cuh: {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, source: str = "fused_mp", variants: dict = VARIANTS,
          out=OUT) -> str:
    """The variant's library of ``csrc/<source>.cu``: the source beside the
    rewritten header (a quoted include finds the source's own directory
    first), in a directory of its own under ``out``."""
    out_dir = out / name / source
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mp_edge_tile.cuh").write_text(rewrite(name, variants))
    src = out_dir / f"{source}.cu"
    shutil.copyfile(_build.CSRC_DIR / f"{source}.cu", src)
    lib = out_dir / f"lib{source}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
    return str(lib)


def problem(torch):
    """The timing problem on the card: the round's inputs (x, ef, senders,
    receivers, w1, b1, w2, b2, 4 scalars) with a padded tail (sentinel N at
    both ends, zero features) and a cotangent of a train step's scale."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ef = rng.normal(size=(E, DE)).astype(np.float32)
    s = rng.integers(0, N, size=E).astype(np.int32)
    r = rng.integers(0, N, size=E).astype(np.int32)
    s[E_LIVE:], r[E_LIVE:], ef[E_LIVE:] = N, N, 0.0
    w1 = (rng.normal(size=(2 * D + DE, H)) / np.sqrt(2 * D + DE)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=H)).astype(np.float32)
    w2 = (rng.normal(size=(H, D2)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D2)).astype(np.float32)
    g = (1e-2 * rng.normal(size=(N, D2))).astype(np.float32)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (x, ef, s, r, w1, b1, w2, b2)]
    scal = torch.tensor([1.1, 0.05, 0.9, -0.02], device=dev)
    return args, scal, torch.from_numpy(g).to(dev)


def time_one(name: str, lib_path: str) -> dict:
    """Times one built variant (in this process); checks it against the
    shipped build's outputs (saved by the shipped variant's run) if it
    keeps the function."""
    import torch

    from ..ops import fused_mp as FM
    from ..utils.timing import event_ms, kernel_breakdown

    lib = ctypes.CDLL(lib_path)
    FM.load = lambda _name: lib  # this variant's library, and only it
    (x, ef, s, r, w1, b1, w2, b2), scal, g = problem(torch)
    layout = FM.fused_layout(s, r, N)
    raw, results = FM._backward_launch(x, ef, s, r, layout, w1, b1, w2, b2, scal, g, 0.01)
    fn = FM._bwd_kernel()

    def launch():
        rc = fn(*raw)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError_t {rc}")

    launch()
    torch.cuda.synchronize()
    row = {"variant": name, "device": torch.cuda.get_device_name(0)}
    ref = OUT / "shipped_outputs.pt"
    got = [t.cpu() for t in results()]
    if name == "shipped":
        torch.save(got, ref)
    elif VARIANTS[name][0]:
        want = torch.load(ref)
        if len(got) != len(want) or not all(
                bool(((a - b).abs() <= ATOL + RTOL * b.abs()).all())
                for a, b in zip(got, want)):
            raise AssertionError(f"{name}: disagrees with the shipped build")
        row["within_tolerance_of_shipped"] = True
    plan = FM._backward_plan(N, E, DE, H, D2, x.device)
    row["plan"] = {"tile": plan.tile, "stages": plan.stages, "blocks": plan.blocks}
    row["entry_us"] = event_ms(launch) * 1e3
    launches = kernel_breakdown(launch)
    row["edge_kernel_us"] = sum(us for k, us in launches if "bwd_edge_kernel" in k)
    row["device_us"] = sum(us for _, us in launches)
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
    # The shipped build runs first: the others are checked against it.
    names = ["shipped"] + [n for n in names if n != "shipped"]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    rc = 0
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-m", f"{__package__}.edge_tile_ablation", "--one", name,
             libs[name]],
            capture_output=True, text=True, cwd=os.getcwd())
        print(proc.stdout.strip() or json.dumps({"variant": name, "error": proc.stderr[-2000:]}),
              flush=True)
        rc |= proc.returncode
        if name == "shipped" and proc.returncode:
            return rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
