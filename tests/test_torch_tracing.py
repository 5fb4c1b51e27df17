"""The port's tracer (``utils/profiling.Tracer``, ``TRACER``) on the CPU:
off it records nothing; spans nest and share their call's id; the one-off
spans of a capture are kept with tracing off; ``drain`` reads the existing
counters in place; host spans sit beside ``torch.profiler``'s ranges on one
clock; device spans and the spans captured into a graph on a stand-in card
(timing events on the host clock); the capture machinery's spans, counters
and keys on a stand-in card; and the benchmark's readers of these spans
(``benchmark/harness/program_trace.py``, ``benchmark/metrics/``)."""

import contextlib
import copy
import gc
import json
import statistics
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graph_neural_network_for_radar_perception_torch.core import capture as CP
from graph_neural_network_for_radar_perception_torch.ops import csr_mp as CM
from graph_neural_network_for_radar_perception_torch.ops import fused_mp as FM
from graph_neural_network_for_radar_perception_torch.ops import gat_mp as GM
from graph_neural_network_for_radar_perception_torch.parallel import collectives as P
from graph_neural_network_for_radar_perception_torch.utils import profiling as PR

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from harness import cell, program_trace as PT  # noqa: E402

CARD = torch.device("cuda", 0)


class _Event:
    """A stand-in CUDA timing event: recorded at the host clock."""

    def __init__(self, enable_timing=False, external=False):
        self.ns = None

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


@pytest.fixture
def tracer():
    yield PR.Tracer()


@pytest.fixture
def global_tracer():
    """``TRACER`` emptied before and after, and left off."""
    PR.TRACER.disable()
    PR.TRACER.drain()
    yield PR.TRACER
    PR.TRACER.disable()
    PR.TRACER.drain()


@pytest.fixture
def fake_card(monkeypatch):
    """The CUDA calls of the tracer and of ``CapturedGraphs`` as stand-ins
    on the CPU: events at the host clock, streams and graphs that do
    nothing, and every stream capturing."""
    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    cuda = torch.cuda
    for name, value in dict(
            Event=_Event, is_available=lambda: True, current_device=lambda: 0,
            current_stream=lambda *a: Stream(), Stream=Stream,
            stream=lambda s: contextlib.nullcontext(), synchronize=lambda *a: None,
            get_sync_debug_mode=lambda: 0, set_sync_debug_mode=lambda m: None,
            CUDAGraph=Graph, graph=lambda g, pool=None: contextlib.nullcontext(),
            is_current_stream_capturing=lambda: True).items():
        monkeypatch.setattr(cuda, name, value)
    monkeypatch.setattr(CP, "_pool", lambda device: None)


def _names(spans, where=None):
    return [s["name"] for s in spans if where is None or s["where"] == where]


def test_off_records_nothing_and_its_span_is_one_shared_noop(tracer):
    assert not tracer.enabled and not PR.TRACER.enabled
    a, b = tracer.span("x"), tracer.span("y", torch.device("cpu"), marks=[1])
    assert a is b is tracer.graph_span("z") is PR._OFF
    with a as s, tracer.graph_span("z"):
        assert s.id is None and s.call is None
    assert tracer.drain() == {"spans": [], "counters": {}}


def test_nested_spans_carry_their_parent_and_share_the_call(tracer):
    tracer.enable()
    with tracer.span("outer") as outer:
        with tracer.span("inner") as inner:
            pass
    with tracer.span("again", call=outer.call) as again:
        pass
    with tracer.span("alone") as alone:
        pass
    spans = {s["name"]: s for s in tracer.drain()["spans"]}
    assert spans["outer"]["parent"] is None and spans["inner"]["parent"] == outer.id
    assert spans["inner"]["call"] == spans["outer"]["call"] == spans["again"]["call"] == outer.id
    assert spans["alone"]["call"] == alone.id != outer.id and inner.id != outer.id
    assert spans["again"]["parent"] is None and again.id not in (outer.id, inner.id)
    for s in spans.values():
        assert s["where"] == "host" and s["start_ns"] <= s["end_ns"]
    assert spans["outer"]["start_ns"] <= spans["inner"]["start_ns"] <= spans["inner"]["end_ns"] \
        <= spans["outer"]["end_ns"] <= spans["again"]["start_ns"]
    assert tracer.drain()["spans"] == []


def test_one_off_spans_are_recorded_with_tracing_off(tracer):
    with tracer.once("captured.warmup"), tracer.span("hidden"):
        pass
    with tracer.once("captured.capture"):
        pass
    assert _names(tracer.drain()["spans"]) == ["captured.warmup", "captured.capture"]


def test_drain_reads_the_existing_counters_in_place(global_tracer, monkeypatch):
    monkeypatch.setattr(FM.fused_message_pass, "launches", 7)
    monkeypatch.setattr(FM.fused_message_pass_backward, "launches", 3)
    stats = copy.deepcopy(P.STATS)
    stats["all_reduce"]["calls"] += 2
    stats["all_reduce"]["bytes"] += 64
    monkeypatch.setattr(P, "STATS", stats)
    keep = copy.deepcopy(stats)
    got = global_tracer.drain()["counters"]
    assert got["launches"]["fused_message_pass.launches"] == 7
    assert got["launches"]["fused_message_pass_backward.launches"] == 3
    assert got["launches"] == {f"{f.__name__}.{a}": getattr(f, a) for f, a in (
        (FM.fused_message_pass, "launches"), (FM.fused_message_pass, "launches_bf16"),
        (FM.fused_message_pass_backward, "launches"), (CM.fused_message_pass_csr, "launches"),
        (CM.fused_message_pass_csr, "launches_bf16"),
        (CM.fused_message_pass_csr_backward, "launches"), (GM.gat_round, "launches"),
        (GM.gat_round, "backward_launches"))}
    assert got["collectives"] == keep and P.STATS == keep
    assert (FM.fused_message_pass.launches, FM.fused_message_pass_backward.launches) == (7, 3)
    assert set(got["captured_graphs"]) == {"replays", "warmups"}
    assert global_tracer.drain()["counters"] == got  # read, not moved


def test_host_spans_sit_beside_the_profiler_ranges_on_one_clock(tracer):
    """Under torch.profiler on the CPU every host span matches the
    profiler range of its name, start and end, at one offset, within
    50 us."""
    tracer.enable()
    gc.disable()  # a collection between two adjacent calls is not the clock's
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracer.span("warm.x"):  # the profiler's first range costs its set-up
                pass
            for _ in range(8):
                with tracer.span("trace.outer"):
                    time.sleep(0.002)
                    with tracer.span("trace.inner"):
                        time.sleep(0.001)
    finally:
        gc.enable()
    ours = [s for s in tracer.drain()["spans"] if s["name"].startswith("trace.")]
    ranges = {name: sorted((e for e in prof.events() if e.name == name),
                           key=lambda e: e.time_range.start)
              for name in ("trace.outer", "trace.inner")}
    pairs, seen = [], {name: 0 for name in ranges}
    for s in sorted(ours, key=lambda s: s["start_ns"]):
        e = ranges[s["name"]][seen[s["name"]]]
        seen[s["name"]] += 1
        pairs.append((s, e))
    assert len(pairs) == 16 and all(n == 8 for n in seen.values())
    offset = statistics.median(s["start_ns"] / 1e3 - e.time_range.start for s, e in pairs)
    for s, e in pairs:
        assert abs(s["start_ns"] / 1e3 - offset - e.time_range.start) < 50, s
        assert abs(s["end_ns"] / 1e3 - offset - e.time_range.end) < 50, s


def test_device_spans_and_graph_spans_on_a_stand_in_card(tracer, fake_card):
    """A device span beside its host span, and spans captured into a graph
    read after one complete replay in ``SAMPLE_EVERY``: that replay's
    in-graph spans hang under its device span, nested as captured, and
    share its call."""
    tracer.enable()
    with tracer.marking() as marks:
        with tracer.graph_span("train_step.forward"):
            with tracer.graph_span("mp.forward"):
                pass
        with tracer.graph_span("train_step.backward"):
            pass
    assert [m[0] for m in marks] == ["train_step.forward", "mp.forward", "train_step.backward"]
    assert tracer.graph_span("mp.forward") is PR._OFF  # outside a capture
    n = tracer.SAMPLE_EVERY + 1
    for _ in range(n):
        with tracer.span("captured.copy", CARD) as copy_span:
            pass
        with tracer.span("train_step.replay", CARD, call=copy_span.call, marks=marks):
            for m in marks:  # the replay records the graph's events again
                m[2].record()
                m[3].record()
    out = tracer.drain()
    spans = out["spans"]
    assert out["counters"] == {"captured.sampled_replays": 2}
    replays = [s for s in spans if s["name"] == "train_step.replay" and s["where"] == "device"]
    hosts = {s["id"]: s for s in spans if s["where"] == "host"}
    assert len(replays) == n and all(hosts[r["parent"]]["name"] == "train_step.replay"
                                     for r in replays)
    for i, r in enumerate(replays):
        copies = [s for s in spans if s["call"] == r["call"] and s["name"] == "captured.copy"]
        assert _names(copies, "host") == _names(copies, "device") == ["captured.copy"]
        inner = [s for s in spans if s["call"] == r["call"] and s["where"] == "device"
                 and s["parent"] not in hosts]
        if i % tracer.SAMPLE_EVERY:
            assert inner == []
            continue
        by = {s["name"]: s for s in inner}
        assert sorted(by) == ["mp.forward", "train_step.backward", "train_step.forward"]
        assert by["train_step.forward"]["parent"] == by["train_step.backward"]["parent"] == r["id"]
        assert by["mp.forward"]["parent"] == by["train_step.forward"]["id"]
    for s in spans:
        assert s["start_ns"] is not None and s["start_ns"] <= s["end_ns"]


def test_captured_graphs_spans_counters_and_keys_on_a_stand_in_card(global_tracer, fake_card):
    """``CapturedGraphs.run`` on a stand-in card: the capture's warm-ups
    and capture are spans with tracing off; while it is on, a new key
    (another capture, with the body's graph spans), the copy as a span
    with its bytes (pageable: numpy), the replay sharing its call; off
    again, the first graph."""
    cap = CP.CapturedGraphs()
    leaves = [np.arange(6, dtype=np.float32).reshape(2, 3), np.ones(4, np.int32)]

    def body(inputs):
        with PR.TRACER.graph_span("train_step.forward"):
            return {"y": inputs[0] * 2}

    cpu = torch.device("cpu")
    for _ in range(2):
        cap.run("k", leaves, body, cpu, label="train_step.replay")
    out = global_tracer.drain()
    assert _names(out["spans"]) == ["captured.warmup", "captured.warmup", "captured.capture"]
    assert len(cap.graphs) == 1 and not next(iter(cap.graphs.values())).marks
    assert out["counters"]["captured_graphs"]["replays"] >= 2

    global_tracer.enable()
    for _ in range(2):
        cap.run("k", leaves, body, cpu, label="train_step.replay")
    out = global_tracer.drain()
    assert len(cap.graphs) == 2 and cap.warmups == 2 * CP.CapturedGraphs.WARMUP_RUNS
    traced = cap.graphs[("k", True)]
    assert [m[0] for m in traced.marks] == ["train_step.forward"]
    assert _names(out["spans"]) == ["captured.warmup", "captured.warmup", "captured.capture",
                                    "train_step.replay", "captured.copy", "train_step.replay"]
    copy_span, replay = out["spans"][-2:]
    assert replay["call"] == copy_span["call"] and replay["parent"] is None
    assert out["counters"]["captured.copy_bytes"] == 6 * 4 + 4 * 4
    assert out["counters"]["captured.pageable_bytes"] == 6 * 4 + 4 * 4
    assert out["counters"]["captured.traced_replays"] == 2

    global_tracer.disable()
    cap.run("k", leaves, body, cpu, label="train_step.replay")
    assert len(cap.graphs) == 2 and cap.replays == 5
    assert _names(global_tracer.drain()["spans"]) == []


class _Tally:
    """A counter source of ints: ``read`` and ``add`` for ``register_counters``."""

    def __init__(self, n: int):
        self.values = [0] * n

    def read(self):
        return list(self.values)

    def add(self, deltas):
        self.values = [v + d for v, d in zip(self.values, deltas)]


def test_registered_counters_advance_once_a_replay_on_a_stand_in_card(fake_card, monkeypatch):
    """A source registered with ``core/capture``: the two warm-ups advance
    it, the capture's own advance is taken back, and each replay adds what
    the capture recorded.  A source registered while the capture ran counts
    from zero."""
    monkeypatch.setattr(CP, "_SOURCES", list(CP._SOURCES))
    tally, late = _Tally(2), _Tally(1)
    CP.register_counters(["test.calls", "test.bytes"], tally.read, tally.add)
    runs = []

    def body(inputs):
        runs.append(len(runs))
        tally.add([1, 8])
        if len(runs) == CP.CapturedGraphs.WARMUP_RUNS + 1:  # the capture
            CP.register_counters(["test.late"], late.read, late.add)
            late.add([3])
        return {"y": inputs[0] * 2}

    cap = CP.CapturedGraphs()
    leaves = [np.arange(6, dtype=np.float32)]
    cap.run("k", leaves, body, torch.device("cpu"))
    warm = CP.CapturedGraphs.WARMUP_RUNS
    assert len(runs) == warm + 1 and cap.warmups == warm and cap.replays == 1
    assert tally.values == [warm + 1, 8 * (warm + 1)] and late.values == [3]
    entry = next(iter(cap.graphs.values()))
    assert {k: v for k, v in entry.launches.items() if v} == {
        "test.calls": 1, "test.bytes": 8, "test.late": 3}
    for _ in range(3):
        cap.run("k", leaves, body, torch.device("cpu"))
    assert len(runs) == warm + 1 and cap.replays == 4
    assert tally.values == [warm + 4, 8 * (warm + 4)] and late.values == [12]


# ------------------------------------------------------------ the readers
def test_gap_attribution_on_synthetic_spans():
    assert PT.union([(5, 7), (0, 2), (1, 3), (3, 4), (8, 8)]) == [(0, 4), (5, 7)]
    assert PT.measure([(0, 4), (2, 6), (10, 20)], 1, 15) == 5 + 5
    # host in spans [0, 10) and [20, 30); device busy [2, 5) and [8, 25)
    host, busy = [(0, 10), (20, 30)], [(2, 5), (8, 25)]
    assert PT.idle_within(host, busy, 0, 100) == (2 + 3) + 5
    assert PT.idle_within(host, busy, 4, 28) == 3 + 3
    assert PT.idle_within(host, [], 0, 100) == 20
    assert PT.idle_within([], busy, 0, 100) == 0


def _span(name, sid, parent, call, where, start, end):
    return dict(name=name, id=sid, parent=parent, call=call, where=where, start_ns=start,
                end_ns=end)


def _synthetic(mode):
    """Two calls of a stretch of the window [0, 100 000) ns: a copy (host
    and device) then a replay (host and device) with its in-graph spans;
    the second replay's in-graph spans were not read."""
    step = PT.STEP[mode]
    spans = []
    for k, t in enumerate((0, 50_000)):
        c = 10 * k + 1
        spans += [_span("captured.copy", c, None, c, "host", t, t + 10_000),
                  _span("captured.copy", c + 1, c, c, "device", t + 6_000, t + 12_000),
                  _span(f"{step}.replay", c + 2, None, c, "host", t + 10_000, t + 11_000),
                  _span(f"{step}.replay", c + 3, c + 2, c, "device", t + 12_000, t + 42_000)]
        if k == 0:
            spans += [_span(f"{step}.forward", c + 4, c + 3, c, "device", t + 12_500, t + 20_000),
                      _span("mp.forward", c + 5, c + 4, c, "device", t + 13_000, t + 15_000),
                      _span(f"{step}.backward", c + 6, c + 3, c, "device", t + 20_000, t + 35_000),
                      _span("mp.backward", c + 7, c + 6, c, "device", t + 21_000, t + 27_000),
                      _span(f"{step}.update", c + 8, c + 3, c, "device", t + 35_000, t + 41_000)]
    setup = [_span("captured.warmup", 90, None, 90, "host", 0, 2_000_000_000),
             _span("captured.warmup", 91, None, 91, "host", 2_000_000_000, 2_500_000_000),
             _span("captured.capture", 92, None, 92, "host", 2_500_000_000, 3_000_000_000),
             _span("other", 93, None, 93, "host", 0, 7)]
    return {"setup": {"spans": setup, "counters": {}}, "capture": {"spans": [], "counters": {}},
            "stretch": {"spans": spans, "counters": {"captured.copy_bytes": 48_000}},
            "window_ns": (0, 100_000)}


# per reader: the value of the synthetic stretch (None: the mode has no such span)
EXPECTED = {
    "copy_host_ms": 10_000 / 1e6,
    # device copies 2 x 6000; host in copy and device idle: [0, 6000) and [50000, 56000)
    "copy_stall_share": 100.0 * (12_000 + 12_000) / 100_000,
    "copy_gbps": 48_000 / 12_000,
    "fwd_device_ms": 7_500 / 1e6,
    "bwd_device_ms": 15_000 / 1e6,
    "update_device_ms": 6_000 / 1e6,
    "mp_step_share": 100.0 * (2_000 + 6_000) / 30_000,
    "capture_s": 3.0,
}
NEW = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
       if m["name"].split(".")[0] in EXPECTED]


def test_the_new_metrics_are_in_the_benchmark():
    assert sorted(NEW) == sorted(f"{n}.{m}" for n in EXPECTED for m in ("train", "eval")
                                 if not (m == "eval" and n in ("bwd_device_ms", "update_device_ms")))


@pytest.mark.parametrize("metric", NEW)
def test_reader_is_none_off_the_card_and_reads_a_fake_trace(metric):
    read = cell.reader(metric)
    mode = metric.split(".")[1]
    off = types.SimpleNamespace(mode=mode, device=torch.device("cpu"))
    assert read(off) is None and off.program_trace is None
    fake = types.SimpleNamespace(mode=mode, device=torch.device("cpu"),
                                 program_trace=_synthetic(mode))
    assert read(fake) == pytest.approx(EXPECTED[metric.split(".")[0]], rel=1e-12)
    fake.program_trace["stretch"]["spans"] = []
    fake.program_trace["setup"]["spans"] = []
    assert read(fake) is None


# ------------------------------------------------------------ the staged copy
class _InFlight:
    """A stand-in event of a pinned buffer: in flight from its record until
    waited for."""

    def __init__(self):
        self.pending, self.waited = False, 0

    def record(self, stream=None):
        self.pending = True

    def query(self):
        return not self.pending

    def synchronize(self):
        self.waited += 1
        self.pending = False


def test_captured_graphs_stage_host_leaves_on_a_stand_in_card(global_tracer, fake_card,
                                                              monkeypatch):
    """``CapturedGraphs.run`` on a stand-in card: the host leaves are views
    of one flat buffer and reach it through two host buffers in turn; a
    leaf on the card keeps a buffer of its own.  A copy waits only for a
    buffer still in flight, once, before its span; the caller may overwrite
    its arrays as soon as ``run`` returns.  With the tracer on,
    ``captured.staged_bytes`` counts the host leaves' bytes a copy and
    ``captured.staging_waits`` the waits, beside ``captured.copy_bytes`` and
    ``captured.pageable_bytes``."""
    rng = np.random.default_rng(3)
    card_leaf = torch.arange(3, dtype=torch.float32)
    monkeypatch.setattr(CP, "_on_card", lambda a: a is card_leaf)

    def batch():
        return [rng.normal(size=(2, 3)).astype(np.float32), card_leaf,
                rng.integers(0, 9, (4,), dtype=np.int32), rng.random(5) < 0.5,
                torch.from_numpy(rng.normal(size=(3,)))]

    cap = CP.CapturedGraphs()
    global_tracer.enable()
    cap.run("k", batch(), lambda inputs: {"y": inputs[0] * 2}, torch.device("cpu"))
    entry = next(iter(cap.graphs.values()))
    staging = entry.staging
    staging.done = [_InFlight(), _InFlight()]
    flat = staging.flat.untyped_storage().data_ptr()
    assert [t.untyped_storage().data_ptr() == flat for t in entry.staging.inputs] == [
        True, False, True, True, True]
    global_tracer.drain()
    calls = 4
    for _ in range(calls):
        leaves = batch()
        want = [CP._as_tensor(a).clone() for a in leaves]
        spans_before = len(global_tracer._spans)
        cap.run("k", leaves, lambda inputs: {"y": inputs[0] * 2}, torch.device("cpu"))
        assert global_tracer._spans[spans_before]["name"] == "captured.copy"
        for a in leaves[0], leaves[2], leaves[3], leaves[4]:
            a[...] = 0  # the caller reuses its arrays at once
        assert all(torch.equal(t, w) for t, w in zip(entry.staging.inputs, want))
    assert [e.waited for e in staging.done] == [1, 1]  # turns 1, 0, then each waited for
    counters = global_tracer.drain()["counters"]
    host = 2 * 3 * 4 + 4 * 4 + 5 + 3 * 8
    assert counters["captured.staged_bytes"] == calls * host
    assert counters["captured.staging_waits"] == 2
    assert counters["captured.copy_bytes"] == calls * (host + 3 * 4)
    assert counters["captured.pageable_bytes"] == calls * (host + 3 * 4)


def test_a_sampled_replay_still_in_flight_is_waited_for_and_read(tracer, fake_card,
                                                                 monkeypatch):
    """A replay sampled for its in-graph spans and not yet complete when
    its graph is replayed again is waited for and read, not lost: the host
    may run ahead of the card."""
    waits = []

    class Late(_Event):
        def query(self):
            return False

        def synchronize(self):
            waits.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Late)
    tracer.enable()
    waits.clear()  # the clock's anchor
    with tracer.marking() as marks:
        with tracer.graph_span("train_step.forward"):
            pass
    for _ in range(2):
        with tracer.span("train_step.replay", CARD, marks=marks):
            for m in marks:
                m[2].record()
                m[3].record()
    spans = tracer.drain()["spans"]
    assert len(waits) == 1
    replay = next(s for s in spans if s["name"] == "train_step.replay" and s["where"] == "device")
    inner = [s for s in spans if s["name"] == "train_step.forward"]
    assert len(inner) == 1 and inner[0]["parent"] == replay["id"]
