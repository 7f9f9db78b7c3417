"""The port's observability plane (``repro_torch.obs``).

* ``tests/test_obs.py``'s unit tests on the port: disabled spans are
  no-ops; nesting, close order and attributes; the transfer counter counts
  calls and bytes only while tracing; a manifest round trip sums to the
  run's totals; a non-manifest is rejected; ``maybe_profile`` writes a
  Chrome trace (with the spans' ranges) and ignores a nested region;
  ``enable_from_env``; the compile counter counts a kernel library's first
  load once (a stub library, no ``nvcc``).
* Each side reads the other's manifests: the port's ``phase_table`` equals
  ``tools/trace_report.py``'s field by field on the committed JAX manifest,
  and ``tools/trace_report.py`` renders a port-written manifest.
* The orchestrator's contracts at the small size (the port's counterparts
  of ``test_orchestrator_obs_contracts`` and
  ``test_scan_chunk_compile_contract``): one transfer per run, inside
  ``metrics-materialize``; with ``checkpoint_every=2`` the scan's chunks
  are [(1, 1), (2, 2), (4, 1)] and no named span sits inside a
  ``scan-chunk``; a resumed run makes one transfer, also when every
  segment was restored.

The span trees against the JAX package's are compared in
``test_torch_orchestrator.py`` and ``test_torch_scan.py``, on the JAX runs
those files already make.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.dynamics import SeededDraws, get_scenario
from repro_torch.dynamics import run_orchestrator as t_run
from repro_torch.faults import Preempted
from repro_torch.kernels import _build
from repro_torch.obs import report as port_report
from repro_torch.obs.counters import device_get
from repro_torch.obs.profile import TRACE_NAME
from tools import trace_report as jax_report

from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_orchestrator import TC
from test_torch_scan import scan_configs, small  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_MANIFEST = ROOT / "runs" / "bench" / \
    "BENCH_2026-08-09_obs_smoke.manifest.jsonl"


@pytest.fixture(autouse=True)
def _tracer_off_after():
    """Every test leaves the module-level tracer disabled and empty."""
    yield
    if obs.enabled():
        obs.disable()
    obs.drain()


# ---------------------------------------------------------------------------
# tracer, counters, manifest, profile
# ---------------------------------------------------------------------------

def test_span_disabled_is_noop():
    assert not obs.enabled()
    before = obs.events()
    with obs.span("phantom", k=1):
        x = 41 + 1
    assert x == 42
    assert obs.events() == before

    @obs.span.wrap("phantom-fn")
    def f(a):
        return a * 2

    assert f(21) == 42
    assert obs.events() == before


def test_span_nesting_close_order_and_attrs():
    obs.enable()
    with obs.span("outer", segment=0):
        with obs.span("inner", kind="child"):
            pass
    with obs.span("sibling"):
        pass

    @obs.span.wrap("wrapped", stage="fn")
    def f():
        return 1

    assert f() == 1
    rec = obs.disable()
    evs = rec["events"]
    # children close before parents: inner, outer, sibling
    assert [e.name for e in evs] == ["inner", "outer", "sibling", "wrapped"]
    assert [e.depth for e in evs] == [1, 0, 0, 0]
    assert evs[1].attrs == {"segment": 0}
    assert evs[0].attrs == {"kind": "child"}
    assert evs[3].attrs == {"stage": "fn"}
    assert evs[0].dur <= evs[1].dur          # nested window is contained
    assert evs[0].t0 >= evs[1].t0
    assert rec["totals"]["wall"] == pytest.approx(
        evs[1].dur + evs[2].dur + evs[3].dur)   # top-level spans only
    totals = obs.phase_totals(evs)
    assert totals["outer"]["count"] == 1
    assert totals["inner"]["mean"] == pytest.approx(evs[0].dur)


def test_device_get_counts_calls_and_bytes_only_while_active():
    x = torch.arange(8, dtype=torch.float32)
    before = obs.counters()
    host = device_get(x)            # tracing off: not counted
    assert obs.counters() == before
    np.testing.assert_array_equal(host, x.numpy())
    obs.enable()
    with obs.span("fetch"):
        device_get(x)
        device_get(torch.zeros((0,), dtype=torch.float64))
    with obs.span("idle"):
        pass
    rec = obs.disable()
    by = {e.name: e for e in rec["events"]}
    assert by["fetch"].transfers == 2
    assert by["fetch"].bytes_fetched == x.nbytes
    assert by["idle"].transfers == 0
    assert rec["totals"]["transfers"] == 2
    device_get(x)                   # off again
    assert obs.counters()["transfers"] == before["transfers"] + 2


def test_compile_counter_counts_a_first_library_load_once(monkeypatch):
    class StubFn:
        argtypes = restype = None

        def __call__(self, *args):
            return 0

    class StubLib:
        def __getattr__(self, name):
            return StubFn()

    def stub_kernel():
        k = _build.CudaKernel("kmeans_assign", "stub_launch", [])
        monkeypatch.setattr(k, "start_build", lambda: None)
        monkeypatch.setattr(k, "finish_build", lambda proc: None)
        return k

    loads = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loads.append(path) or StubLib())
    obs.enable()
    with obs.span("first"):
        k = stub_kernel()
        k.function()
        k.function()
        k.launch()
    with obs.span("again"):
        k.launch()
    rec = obs.disable()
    by = {e.name: e for e in rec["events"]}
    assert len(loads) == 1 and k.launches == 2
    assert by["first"].compiles == 1
    assert by["again"].compiles == 0
    before = obs.counters()["compiles"]
    stub_kernel().function()                 # tracing off: not counted
    assert obs.counters()["compiles"] == before


def test_manifest_round_trip_sums_to_run_total(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    obs.enable(manifest=path, meta={"test": "round-trip"})
    with obs.span("a"):
        with obs.span("b"):
            pass
        with obs.span("b"):
            pass
    with obs.span("c"):
        pass
    obs.mark("row", row="0")
    rec = obs.disable()

    man = obs.read_manifest(path)
    run = man["run"]
    assert run["schema"] == "obs-manifest/v1"
    assert run["meta"] == {"test": "round-trip"}
    assert run["torch_version"] == torch.__version__
    assert run["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert run["device_count"] >= 1 and run["mesh"] is None
    assert len(man["spans"]) == 4
    assert man["marks"] == [{"type": "mark", "name": "row", "row": "0"}]
    assert man["end"] is not None

    # tree reconstruction: b,b close under a; c is top level
    parents = port_report.assign_parents(man["spans"])
    assert [s["name"] for s in man["spans"]] == ["b", "b", "a", "c"]
    assert parents == [2, 2, None, None]

    # self time telescopes: summed over every span it equals the summed
    # top-level wall, which is what obs.disable() reported as the total
    self_t = port_report.self_times(man["spans"], parents)
    top = sum(s["dur"] for s in man["spans"] if s["depth"] == 0)
    assert sum(self_t) == pytest.approx(top, rel=1e-9)
    assert rec["totals"]["wall"] == pytest.approx(top, rel=1e-9)
    assert port_report.run_wall(man) >= top * (1 - 1e-6)

    table = {r["phase"]: r for r in port_report.phase_table(man["spans"])}
    assert table["b"]["count"] == 2
    assert table["a"]["total"] == pytest.approx(
        next(s["dur"] for s in man["spans"] if s["name"] == "a"))
    text = port_report.report(path)
    for phase in ("a", "b", "c"):
        assert phase in text
    assert "run wall" in text and f"torch {torch.__version__}" in text


def test_read_manifest_rejects_non_manifest(tmp_path):
    p = tmp_path / "not_a_manifest.jsonl"
    p.write_text('{"type": "span", "name": "x"}\n')
    with pytest.raises(ValueError, match="no run header"):
        obs.read_manifest(str(p))
    p.write_text('{"type": "run", "schema": "obs-manifest/v0"}\n')
    with pytest.raises(ValueError, match="unsupported manifest schema"):
        obs.read_manifest(str(p))


def test_maybe_profile_writes_a_trace_and_ignores_a_nested_region(tmp_path):
    with obs.maybe_profile("nowhere"):       # no directory: a no-op
        pass
    obs.enable()
    with obs.maybe_profile("outer", out_dir=str(tmp_path)):
        with obs.maybe_profile("inner", out_dir=str(tmp_path)):
            with obs.span("profiled-phase"):
                torch.ones(4).sum()
    rec = obs.disable()
    assert [e.name for e in rec["events"]] == ["profiled-phase"]
    assert sorted(os.listdir(tmp_path)) == ["outer"]
    with open(tmp_path / "outer" / TRACE_NAME) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the span opened a profiler range of its name
    assert "profiled-phase" in names
    # closed regions leave spans as plain flag checks again
    with obs.span("after"):
        pass
    assert [e.name for e in obs.events()] == ["profiled-phase"]


def test_maybe_profile_reads_repro_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE", str(tmp_path))
    assert obs.profile_dir() == str(tmp_path)
    before = obs.events()
    with obs.maybe_profile("from-env"):
        with obs.span("untraced"):          # a range, but no event
            torch.ones(2)
    with open(tmp_path / "from-env" / TRACE_NAME) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "untraced" in names
    assert obs.events() == before


def test_enable_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert obs.enable_from_env() is False and not obs.enabled()
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_OBS", str(path))
    assert obs.enable_from_env() is True and obs.enabled()
    with obs.span("kept"):
        pass
    assert obs.enable_from_env() is True      # a running trace is kept
    assert [e.name for e in obs.events()] == ["kept"]
    obs.disable()
    assert [s["name"] for s in obs.read_manifest(str(path))["spans"]] == \
        ["kept"]
    monkeypatch.setenv("REPRO_OBS", "1")
    monkeypatch.setenv("REPRO_OBS_MEM", "1")
    assert obs.enable_from_env() is True
    with obs.span("mem"):
        keep = torch.zeros(16)
    ev = obs.disable()["events"][0]
    assert ev.live_arrays >= 1 and ev.live_bytes >= keep.nbytes


# ---------------------------------------------------------------------------
# each side reads the other's manifests
# ---------------------------------------------------------------------------

def test_phase_table_matches_trace_report_on_the_jax_manifest():
    man = jax_report.read_manifest(str(JAX_MANIFEST))
    assert port_report.read_manifest(str(JAX_MANIFEST)) == man
    want = jax_report.phase_table(man["spans"])
    got = port_report.phase_table(man["spans"])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for field in w:
            assert g[field] == w[field], (w["phase"], field)
    assert port_report.assign_parents(man["spans"]) == \
        jax_report.assign_parents(man["spans"])
    assert port_report.run_wall(man) == jax_report.run_wall(man)
    text = port_report.report(str(JAX_MANIFEST))
    assert "jax 0.4.37" in text and "run wall" in text


def test_trace_report_reads_a_port_manifest(tmp_path, small):
    xs, ys, ev = small
    _, cfg = scan_configs("eager", retry=False, n_segments=2)
    path = str(tmp_path / "port.jsonl")
    obs.enable(manifest=path, meta={"scenario": "fading"})
    t_run(xs, ys, TC, cfg, "fading", ev, draws=SeededDraws(3, "cpu"),
          device="cpu")
    obs.disable()
    text = jax_report.report(path)
    for phase in ("orchestrator", "segment", "metrics-materialize"):
        assert phase in text
    assert "transfers 1" in text
    man = jax_report.read_manifest(path)
    assert port_report.phase_table(man["spans"]) == \
        jax_report.phase_table(man["spans"])


# ---------------------------------------------------------------------------
# the orchestrator's contracts, small size
# ---------------------------------------------------------------------------

def _traced_run(xs, ys, ev, cfg, scenario, **kw):
    obs.enable()
    try:
        res = t_run(xs, ys, TC, cfg, scenario, ev,
                    draws=SeededDraws(21, "cpu"), device="cpu", **kw)
    finally:
        rec = obs.disable()
    return res, rec


def _one_transfer(rec):
    assert rec["totals"]["transfers"] == 1
    mat = [e for e in rec["events"] if e.name == "metrics-materialize"]
    assert len(mat) == 1 and mat[0].transfers == 1
    assert [e.name for e in rec["events"] if e.transfers] == \
        ["metrics-materialize", "orchestrator"]


def test_eager_run_makes_one_transfer(small):
    xs, ys, ev = small
    _, cfg = scan_configs("eager", retry=False, n_segments=3)
    res, rec = _traced_run(xs, ys, ev, cfg, "fading")
    _one_transfer(rec)
    segs = [e.attrs["segment"] for e in rec["events"] if e.name == "segment"]
    assert segs == [0, 1, 2]
    assert sum(e.name == "fl" for e in rec["events"]) == 3
    assert rec["events"][-1].name == "orchestrator"
    assert rec["events"][-1].attrs == {"mode": "online", "scenario": "fading",
                                       "n_segments": 3, "resumed": False}
    assert len(res.trace.segments) == 3


def test_scan_chunks_and_transfers_at_checkpoint_every_2(small,
                                                         tmp_path):
    xs, ys, ev = small
    _, cfg = scan_configs(retry=False, n_segments=5,
                          checkpoint_dir=str(tmp_path), checkpoint_every=2)
    res, rec = _traced_run(xs, ys, ev, cfg, "fading")
    evs = rec["events"]
    chunks = [e for e in evs if e.name == "scan-chunk"]
    assert [(e.attrs["start"], e.attrs["n_segments"]) for e in chunks] == \
        [(1, 1), (2, 2), (4, 1)]
    assert [(a, b - a) for a, b, _ in res.chunk_seconds] == \
        [(1, 1), (2, 2), (4, 1)]
    # no named span inside a chunk: no span's parent is a scan-chunk
    spans = [e.to_dict() for e in evs]
    parents = port_report.assign_parents(spans)
    assert not [s["name"] for s, p in zip(spans, parents)
                if p is not None and spans[p]["name"] == "scan-chunk"]
    assert all(e.depth == 1 for e in chunks)
    saves = [e.attrs["segment"] for e in evs if e.name == "checkpoint-save"]
    assert saves == [1, 3, 4]
    _one_transfer(rec)

    # resumed from the final checkpoint: every segment is restored and the
    # one transfer is empty
    _, rec = _traced_run(xs, ys, ev, cfg, "fading",
                         resume_from=cfg.checkpoint_path)
    _one_transfer(rec)
    assert rec["totals"]["bytes_fetched"] == 0
    assert [e.name for e in rec["events"]] == \
        ["checkpoint-load", "metrics-materialize", "orchestrator"]


def test_resumed_run_makes_one_transfer(small, tmp_path):
    xs, ys, ev = small
    _, cfg = scan_configs("eager", retry=False, n_segments=3,
                          checkpoint_dir=str(tmp_path))
    scn = get_scenario("preempt-resume")
    with pytest.raises(Preempted):
        _traced_run(xs, ys, ev, cfg, scn)
    res, rec = _traced_run(xs, ys, ev, cfg, scn,
                           resume_from=cfg.checkpoint_path)
    _one_transfer(rec)
    names = [e.name for e in rec["events"]]
    assert names[0] == "checkpoint-load"
    assert [e.attrs["segment"] for e in rec["events"]
            if e.name == "segment"] == [2]
    assert rec["events"][-1].attrs["resumed"] is True
    assert [s.segment for s in res.trace.segments] == [0, 1, 2]
