"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the comparison with the reference.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, its mix
(``mixes/<traffic>.json``), its limits (``limits/<workload>.json``) and
its per-layer readers (``metrics/<metric>.py``, else
``metrics/<metric up to its first dot>.py``), and the modules its
configuration names (``resolve_modules``): the program's adapter, the
plain reference and the counts.  A mix's ``kind`` picks
the window: ``train`` re-enacts the loop of the program's trainer (the
captured train step on each batch, the metrics read to the host every
``log_period`` steps), ``eval`` its validation sweep (the captured eval
step on each batch, the metrics read to the host after each).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import time
import types
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import check, trace, traffic
from harness.weights import make_weights

BENCH_DIR = Path(__file__).resolve().parents[1]

# The modules a configuration may name by a top-level key of its file:
# key -> (the directory of the benchmark that holds them, the default, the
# names each has to offer).
MODULE_KEYS = {
    "program": ("harness", "program", ("Program", "as_batch")),
    "reference": ("reference", "model", ("Reference", "train_steps", "param_specs")),
    "counts": ("harness", "counts", ("model_flops", "round_work", "least_seconds",
                                     "PEAK_F32_FLOPS", "PEAK_BYTES_PER_S")),
}


def resolve_modules(config: dict) -> types.SimpleNamespace:
    """The configuration's ``program`` adapter, plain ``reference`` (which
    may also offer ``weight_rule``: ``harness/weights.py``) and ``counts``:
    the module ``<folder>/<name>.py`` that each key of ``MODULE_KEYS``
    names in the configuration's file, else its default.  A name with no
    such module, or a module that lacks a name it has to offer, fails
    here."""
    found = {}
    for key, (folder, default, offers) in MODULE_KEYS.items():
        name = config.get(key, default)
        path = BENCH_DIR / folder / f"{name}.py"
        if not (isinstance(name, str) and name.isidentifier() and path.is_file()):
            raise FileNotFoundError(
                f"the configuration's {key!r} names {name!r}: no module {path}")
        mod = importlib.import_module(f"{folder}.{name}")
        missing = [a for a in offers if not hasattr(mod, a)]
        if missing:
            raise AttributeError(f"the configuration's {key!r} names {name!r}: {path} "
                                 f"lacks {', '.join(missing)}")
        found[key] = mod
    return types.SimpleNamespace(**found)


def load_cell(bench: dict, workload: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((BENCH_DIR.parent / conf["file"]).read_text())
    mix = json.loads((BENCH_DIR / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())
    applies = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return dict(cell=cell, config=config, mix=mix, limits=limits, e2e=e2e,
                per_layer=per_layer, modules=resolve_modules(config))


def reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r}")


def to_device(batch: dict, device) -> dict:
    return {part: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in arrays.items()} for part, arrays in batch.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class Window:
    """Steps of the window: pool indices, host ms per call (traced runs),
    CUDA events after each train step (off the card, host times), and the
    program's outputs kept."""

    def __init__(self):
        self.index, self.host_ms, self.events, self.marks, self.kept = [], [], [], [], []
        self.elapsed = 0.0


def _loop(step, batches, first: int, seconds: float, mix: dict, device, traced: bool,
          window: Window, max_steps: Optional[int] = None):
    """Call ``step(batch)`` on the pool's batches in turn from ``first``
    until ``seconds`` have passed on the host clock (or ``max_steps``
    calls), then wait for the device.  ``step`` returns the program's
    metrics; every ``log_period`` calls they are read to the host."""
    period = mix["log_period"]
    timing = device.type == "cuda" and mix["kind"] == "train"
    n = len(batches)
    t0 = time.perf_counter()
    window.marks.append(t0)
    i = 0
    while True:
        b = (first + i) % n
        if traced:
            with record_function("bench.step"):
                a = time.perf_counter()
                out = step(batches[b])
                window.host_ms.append(1e3 * (time.perf_counter() - a))
        else:
            out = step(batches[b])
        if timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            window.events.append(ev)
        else:
            window.marks.append(time.perf_counter())
        window.index.append(b)
        i += 1
        if i % period == 0:
            if traced:
                with record_function("bench.read"):
                    host = _host(out)
            else:
                host = _host(out)
            window.kept.append((b, host))
        else:
            window.kept.append((b, out))
        if (max_steps is not None and i >= max_steps) or (
                max_steps is None and time.perf_counter() - t0 >= seconds):
            break
    _sync(device)
    window.elapsed = time.perf_counter() - t0


def _profiled(step, batches, first, mix, device):
    """A stretch of ``profile_steps`` calls under torch.profiler, reduced."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    stretch = Window()
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            _loop(step, batches, first, 0.0, mix, device, True, stretch,
                  max_steps=mix["profile_steps"])
    return trace.reduce(prof.events())


def reference_readings(reference, cfg: dict, mix: dict, pool, seed: int, device,
                       precision: str = "f32", graphs=None):
    """What the ``reference`` module makes of the cell's inputs: for
    ``train`` the checked steps' loss terms, first gradient and parameter
    change (what ``check.train_readings`` compares), for ``eval`` each
    pool batch's loss terms.  ``precision`` "tf32" is the control (TF32
    matmuls on the card); ``graphs`` the slots of each batch to take
    (default all)."""
    device = torch.device(device)
    ref = reference.Reference(cfg, precision)
    weights = make_weights(cfg, seed, device, reference)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        if mix["kind"] == "train":
            batches = [to_device(b, device) for b in pool[:mix["checked_steps"]]]
            losses, grad, after = reference.train_steps(ref, weights, batches, graphs)
            return {"losses": losses, "grad": grad,
                    "delta": {k: after[k] - weights[k] for k in weights}}
        with torch.no_grad():
            return [{k: float(v) for k, v in ref.batch_loss(
                weights, to_device(b, device), graphs)[1].items()} for b in pool]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device="cuda", config_override: Optional[dict] = None, mix_override: Optional[dict] = None,
             program_cls=None, detail: bool = False, bench: Optional[dict] = None) -> dict:
    """One run; returns the result line's fields (``checks`` last).
    ``program_cls`` stands in for the adapter's ``Program``; ``bench`` for
    the contents of ``BENCHMARK.json``."""
    if bench is None:
        bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    spec = load_cell(bench, workload)
    mods = spec["modules"]
    program_cls = program_cls or mods.program.Program
    cfg = dict(spec["config"]["gnn_config"], **(config_override or {}))
    mix = dict(spec["mix"], **(mix_override or {}))
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pool, _ = traffic.make_pool(cfg, mix, seed)
    batches = [mods.program.as_batch(b) for b in pool]
    program = program_cls(cfg, device)
    state = program.train_state(make_weights(cfg, seed, device, mods.reference))
    kind = mix["kind"]
    window = Window()
    if kind == "train":
        step_fn = program.train_step()
        prog_losses, mom1 = [], None
        for i in range(mix["checked_steps"]):
            state, m = step_fn(state, batches[i])
            prog_losses.append(_host(m))
            if i == 0:
                mom1 = program.momentum(state)
        after = program.params(state)

        def step(batch):
            return step_fn(state, batch)[1]

        first = mix["checked_steps"]
    elif kind == "eval":
        eval_fn = program.eval_step()
        model = state.model
        _host(eval_fn(model, batches[0]))  # captures the step

        def step(batch):
            return eval_fn(model, batch)

        first = 0
    else:
        raise ValueError(f"unknown mix kind {kind!r}")
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    setup_s = time.perf_counter() - t_start

    _loop(step, batches, first, seconds, mix, device, traced, window)
    steps = len(window.index)
    slots = mix["batch"]
    e2e = {"setup_s": setup_s}
    if kind == "train":
        e2e["train_graphs_per_s"] = steps * slots / window.elapsed
        if window.events:
            marks = [start] + window.events
            gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:  # off the card: the host clock
            gaps = [1e3 * (b - a) for a, b in zip(window.marks, window.marks[1:])]
        e2e["train_step_p95_ms"] = float(np.percentile(gaps, 95))
        skipped = sum(float(out["skipped"]) if torch.is_tensor(out.get("skipped"))
                      else out.get("skipped", 0.0) for _, out in window.kept)
        failed = int(round(skipped))
    else:
        e2e["eval_graphs_per_s"] = steps * slots / window.elapsed
        answers = [(b, out if isinstance(next(iter(out.values())), float) else _host(out))
                   for b, out in window.kept]
        failed = sum(1 for _, m in answers if not all(map(math.isfinite, m.values())))

    result = {"attempted": steps, "failed": failed}
    breakdown = device_info = None
    if traced:
        stretch = _profiled(step, batches, first + steps, mix, device)
        if device.type == "cuda" and stretch["busy_s"] <= 0:
            raise RuntimeError("no device operation ran in the profiled stretch")
        device_info = {"busy_s": stretch["busy_s"], "window_s": stretch["window_s"]}
        breakdown = {"device_ops": stretch["device_ops"], "idle_gaps": stretch["idle_gaps"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metric_specs = spec["per_layer"] if traced else spec["e2e"]
    metrics = {}
    if traced:
        live = [traffic.live_counts(b) for b in pool]
        ctx = types.SimpleNamespace(
            mode=kind, cfg=cfg, mix=mix, seed=seed, device=device, program=program,
            pool=pool, live=live, window=window, trace=stretch, counts=mods.counts,
            modules=mods)
        for m in metric_specs:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        del ctx
    else:
        for m in metric_specs:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # The program's state goes before the reference runs.
    del step, state, batches, program
    if kind == "train":
        del step_fn
    else:
        del eval_fn, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    refr = reference_readings(mods.reference, cfg, mix, pool, seed, device)
    if kind == "train":
        weights = make_weights(cfg, seed, device, mods.reference)
        wd = cfg["weight_decay"]
        prog = {"losses": prog_losses,
                "grad": {k: mom1[k] - wd * weights[k] for k in weights},
                "delta": {k: after[k] - weights[k] for k in weights}}
        readings = check.train_readings(prog, refr)
        numbers = {k: v for k, v in readings.items() if k in check.COMPARED}
        if detail:
            extra = dict(check.train_detail(prog, refr), readings=readings)
    else:
        numbers = check.eval_numbers(answers, refr)
    limits = spec["limits"]
    correct = check.verdict(numbers, limits) and failed == 0

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if device_info:
        dev.update(device_info)
    out = {"correct": bool(correct), **result, "metrics": metrics, "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    if detail and kind == "train":
        out["detail"] = extra
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return out
