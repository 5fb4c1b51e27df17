"""A static scan of the benchmark's imports: nothing imports JAX, Flax or
the JAX package (top-level names compared whole), the reference imports
nothing of the port or of the harness's adapters to it, and only those
adapters (``harness/program.py`` and ``harness/program_<family>.py``)
import the port."""

import ast
import fnmatch

from bench_support import BENCH_DIR

JAX_NAMES = {"jax", "jaxlib", "flax", "graph_neural_network_for_radar_perception_tpu"}
PORT = "graph_neural_network_for_radar_perception_torch"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & JAX_NAMES, (path, tops & JAX_NAMES)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH_DIR / "reference").rglob("*.py")):
        names = _imports(path)
        assert all(n.split(".")[0] != PORT for n in names), path
        assert not any(n.startswith(("harness", "benchmark")) for n in names), path


def test_only_the_adapter_imports_the_port():
    users = [p.relative_to(BENCH_DIR).as_posix() for p in sorted(BENCH_DIR.rglob("*.py"))
             if any(n.split(".")[0] == PORT for n in _imports(p))
             and not p.relative_to(BENCH_DIR).as_posix().startswith("tests/")]
    assert "harness/program.py" in users
    assert "harness/program_trace.py" not in users  # the spans' reader, not an adapter
    assert all(u == "harness/program.py" or fnmatch.fnmatch(u, "harness/program_*.py")
               for u in users), users
