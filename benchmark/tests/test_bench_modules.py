"""A configuration names its program adapter, plain reference and counts
(``cell.resolve_modules``): the defaults are the modules every cell used
before, naming them changes nothing, an unknown name fails at once, the
weights stay those of the frozen draw, and a model family joins the
benchmark as new files alone."""

import hashlib
import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from bench_support import BENCH_DIR, ROOT, SEED, TINY, TINY_MIX
from harness import cell, counts, program
from harness.weights import make_weights
from reference import model

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# sha256 over (name, float32 bytes) of every leaf of make_weights(TINY widths,
# SEED, "cpu"), drawn before configurations could name their modules.
FROZEN = {"radar_gnn_knn": "fb423a84cb6b0bb0423c20d8a8e4c895a6fa8d7420e14a446edf1060029302bc",
          "radar_gnn_ball": "fb423a84cb6b0bb0423c20d8a8e4c895a6fa8d7420e14a446edf1060029302bc"}


def _config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_defaults_are_the_modules_cells_used_before():
    mods = cell.resolve_modules({})
    assert (mods.program, mods.reference, mods.counts) == (program, model, counts)
    for conf in BENCH["configs"]:
        named = {k for k in cell.MODULE_KEYS if k in json.loads((ROOT / conf["file"]).read_text())}
        assert not named, (conf["name"], named)


def _run_train(bench):
    mix = dict(TINY_MIX, log_period=2)
    return cell.run_cell("knn.train", SEED, 0.3, False, t_start=time.perf_counter(),
                         device="cpu", config_override=TINY, mix_override=mix, bench=bench)


def test_naming_the_defaults_runs_bit_for_bit(tmp_path):
    named = dict(_config("radar_gnn_knn"), program="program", reference="model", counts="counts")
    path = tmp_path / "named.json"
    path.write_text(json.dumps(named))
    bench = json.loads(json.dumps(BENCH))
    for conf in bench["configs"]:
        if conf["name"] == "radar_gnn_knn":
            conf["file"] = str(path)
    plain, explicit = _run_train(None), _run_train(bench)
    assert explicit["correct"] is plain["correct"] is True
    assert explicit["checks"] == plain["checks"]


@pytest.mark.parametrize("key,name,folder", [("program", "program_nonesuch", "harness"),
                                             ("reference", "nonesuch", "reference"),
                                             ("counts", "../counts", "harness")])
def test_unknown_name_fails_with_key_and_path(key, name, folder):
    with pytest.raises(FileNotFoundError) as err:
        cell.resolve_modules({key: name})
    msg = str(err.value)
    assert repr(key) in msg and repr(name) in msg
    assert str(BENCH_DIR / folder / f"{name}.py") in msg


def test_module_without_its_interface_fails():
    with pytest.raises(AttributeError, match="Program, as_batch"):
        cell.resolve_modules({"program": "program_trace"})


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_weights_match_the_frozen_draw(name):
    cfg = dict(_config(name)["gnn_config"], **TINY)
    h = hashlib.sha256()
    for k, v in make_weights(cfg, SEED, "cpu", model).items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == FROZEN[name]


def _fake(specs, rule=None):
    ref = types.SimpleNamespace(param_specs=lambda cfg: specs)
    if rule is not None:
        ref.weight_rule = rule
    return ref


def test_weight_rule_places_the_other_leaves():
    linear = [("lin.weight", (4, 3)), ("lin.bias", (4,)), ("lin.norm.gamma", (1,))]
    extra = [("att.att", (1, 2, 4)), ("att.bias", (8,))]
    seen = []

    def rule(name, shape, fan_in):
        seen.append((name, shape, dict(fan_in)))
        return (0.5, 0.0) if name.endswith(".att") else (0.0, 0.25)

    plain = make_weights({}, SEED, "cpu", _fake(linear))
    both = make_weights({}, SEED, "cpu", _fake(linear + extra, rule))
    for k in plain:
        assert torch.equal(plain[k], both[k]), k
    assert seen == [("att.att", (1, 2, 4), {"lin": 3}), ("att.bias", (8,), {"lin": 3})]
    assert both["att.att"].abs().max() <= 0.5 and both["att.att"].std() > 0
    assert torch.equal(both["att.bias"], torch.full((8,), 0.25))
    with pytest.raises(KeyError, match="att.att"):
        make_weights({}, SEED, "cpu", _fake(linear + extra))


FAMILY = {
    "harness/program_echo.py": '''
from harness.program import Program as _Program, as_batch  # noqa: F401
from harness.program import steps  # noqa: F401

BUILT = []


class Program(_Program):
    def __init__(self, cfg, device):
        BUILT.append(cfg["msg_mlp_hidden_dim"])
        super().__init__(cfg, device)
''',
    "reference/echo.py": '''
from reference.model import Reference, param_specs as _specs, train_steps  # noqa: F401

RULED = []


def param_specs(cfg):
    return _specs(cfg)


def weight_rule(name, shape, fan_in):
    RULED.append(name)
    return 0.0, 0.0
''',
    "harness/counts_echo.py": '''
from harness.counts import *  # noqa: F401,F403
''',
}

DRIVE = '''
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness import cell
tiny, mix = json.loads(sys.argv[3]), json.loads(sys.argv[4])
out = cell.run_cell("echo.train", int(sys.argv[5]), 0.3, False, t_start=time.perf_counter(),
                    device="cpu", config_override=tiny, mix_override=mix)
mods = cell.load_cell(json.loads(open(sys.argv[6]).read()), "echo.train")["modules"]
print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                  "modules": [m.__name__ for m in vars(mods).values()],
                  "built": mods.program.BUILT, "ruled": mods.reference.RULED}))
'''


def test_a_family_joins_as_new_files(tmp_path):
    """A copy of the benchmark, its files as they are, plus a configuration
    that names an adapter, a reference and counts of its own, a cell and
    its limits: only new files, and the cell runs correct through them."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for rel, text in FAMILY.items():
        assert not (BENCH_DIR / rel).exists()
        (bench_dir / rel).write_text(text)
    conf = dict(_config("radar_gnn_knn"), name="echo", program="program_echo",
                reference="echo", counts="counts_echo")
    (bench_dir / "configs" / "echo.json").write_text(json.dumps(conf))
    shutil.copy(BENCH_DIR / "limits" / "knn.train.json", bench_dir / "limits" / "echo.train.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="echo",
                                 file="benchmark/configs/echo.json"))
    bench["workloads"].append(dict(name="echo.train", config="echo", traffic="train", chips=1,
                                   why="a family of its own files"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "knn.train" in m.get("workloads", []):
            m["workloads"].append("echo.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = subprocess.run(
        [sys.executable, "-c", DRIVE, str(bench_dir), str(ROOT), json.dumps(TINY),
         json.dumps(dict(TINY_MIX, log_period=2)), str(SEED), str(tmp_path / "BENCHMARK.json")],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["modules"] == ["harness.program_echo", "reference.echo", "harness.counts_echo"]
    assert out["built"] == [TINY["msg_mlp_hidden_dim"]]
    assert out["ruled"] == []  # every leaf of this model is a norm's or a Linear's
