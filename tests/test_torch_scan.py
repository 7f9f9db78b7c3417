"""The port's scan engine (``OrchestratorConfig(segment_impl="scan")``).

* ``_chunk_bounds`` and ``_eval_rounds`` equal the reference's over a grid
  of configs (pure Python, cheap).
* Against the port's eager engine (the reference's ``test_scan_fuse``
  contract): ``static``/``fading``/``churn`` x ``online``/``uniform`` with
  ``overflow="drop"`` and ``reserve_selector="device"`` on both sides,
  retries off. Integer metrics, graphs and the final client data exactly;
  float metrics and final parameters within 1e-6 relative.
* Against the JAX package's scan engine on :class:`JaxReplayDraws`:
  ``burst-outage`` in mode ``online`` with retries, UCB discovery, with
  ``test_torch_orchestrator``'s tolerances. The gate margins are read from
  the port's own scores (JAX's chunk is one traced program), which agree
  with JAX's to ~1e-5; every one must exceed 1e-4 relative.
* The same ``burst-outage`` scan runs traced on both sides: equal span
  lists in close order in (name, depth, attrs, transfers), no named span
  inside a ``scan-chunk``, equal ``retry-outcome`` marks, one transfer per
  run; the traced port run equals an untraced one bit for bit.
* Kill and resume: a scan run preempted at segment 2 and resumed from its
  checkpoint ends bit-identical to the uninterrupted scan run.
* The validation errors.

The world's clients are cut to unequal sizes, so that the fixed-cap
exchange (the cap is the largest client's size) has room to move data.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core import exchange as jex
from repro.dynamics import orchestrator as jorch
from repro.dynamics import run_orchestrator as j_run
from repro.dynamics.scenarios import get_scenario as j_scenario
from repro_torch import obs as port_obs
from repro_torch.core import exchange as tex
from repro_torch.dynamics import SeededDraws, get_scenario
from repro_torch.dynamics import orchestrator as torch_orch
from repro_torch.dynamics import run_orchestrator as t_run
from repro_torch.faults import Preempted
from repro_torch.models.common import tree_leaves

from test_torch_draws import JaxReplayDraws, one_torch_thread  # noqa: F401
from test_torch_orchestrator import (JC, TC, assert_runs_identical,
                                     compare_runs, compare_traces, configs,
                                     traced, world)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CUT = 3
SCAN_EXCHANGE = dict(overflow="drop", reserve_selector="device")
INT_FIELDS = ("segment", "n_available", "moved", "n_live", "n_failed",
              "retried", "retry_delivered", "rediscovered")
FLOAT_FIELDS = ("eval_loss", "link_churn", "mean_pfail", "expected_delivery")


def scan_configs(impl="scan", **kw):
    """(JAX, port) configs of ``test_torch_orchestrator`` on the exchange
    the scan engine needs."""
    jcfg, tcfg = configs(**kw)

    def on_scan(cfg, exc_mod):
        exc = dataclasses.replace(cfg.pipeline.exchange, **SCAN_EXCHANGE)
        assert isinstance(exc, exc_mod.ExchangeConfig)
        return dataclasses.replace(
            cfg, segment_impl=impl,
            pipeline=dataclasses.replace(cfg.pipeline, exchange=exc))
    return on_scan(jcfg, jex), on_scan(tcfg, tex)


@pytest.fixture(scope="module")
def small():
    """``test_torch_orchestrator``'s world, client i cut by ``CUT * i``
    rows."""
    xs, ys, ev = world()
    return ([x[:len(x) - CUT * i] for i, x in enumerate(xs)],
            [y[:len(y) - CUT * i] for i, y in enumerate(ys)], ev)


# ---------------------------------------------------------------------------
# chunk bounds and eval rounds: the reference's, over a grid
# ---------------------------------------------------------------------------

def test_chunk_bounds_and_eval_rounds_match_reference():
    jcfg, tcfg = configs()
    grid = itertools.product((1, 3, 6), (1, 2, 3), (True, False),
                             ("online", "oneshot"), (None, 2, 4),
                             (False, True), (10, 20, 40))
    n_cases = 0
    for (n_seg, every, retry, mode, preempt, ckpt, eval_every) in grid:
        change = dict(n_segments=n_seg, rediscover_every=every, mode=mode,
                      checkpoint_every=every + 1,
                      fl=dataclasses.replace(jcfg.fl, eval_every=eval_every))
        jc = dataclasses.replace(jcfg, retry=dataclasses.replace(
            jcfg.retry, enabled=retry), **change)
        tc = dataclasses.replace(tcfg, retry=dataclasses.replace(
            tcfg.retry, enabled=retry), **{
                **change, "fl": dataclasses.replace(tcfg.fl,
                                                    eval_every=eval_every)})
        jplan = dataclasses.replace(j_scenario("preempt-resume").faults,
                                    preempt_at=preempt)
        tplan = dataclasses.replace(get_scenario("preempt-resume").faults,
                                    preempt_at=preempt)
        path = "ckpt" if ckpt else None
        for start in range(0, n_seg):
            assert torch_orch._chunk_bounds(tc, tplan, start, path) == \
                jorch._chunk_bounds(jc, jplan, start, path)
        for s in range(n_seg):
            assert torch_orch._eval_rounds(tc, s) == \
                jorch._eval_rounds(jc, s)
        n_cases += 1
    assert n_cases == 3 * 3 * 2 * 2 * 3 * 2 * 3


# ---------------------------------------------------------------------------
# scan against the port's eager engine
# ---------------------------------------------------------------------------

def _assert_scan_equals_eager(eager, scan):
    assert len(eager.trace.segments) == len(scan.trace.segments)
    for e, s in zip(eager.trace.segments, scan.trace.segments):
        seg = f"segment {e.segment}"
        np.testing.assert_array_equal(e.in_edge, s.in_edge, seg)
        for f in INT_FIELDS:
            assert getattr(e, f) == getattr(s, f), (seg, f)
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(s, f), getattr(e, f),
                                       rtol=1e-6, atol=0, err_msg=seg)
        if e.realized_delivery is None:
            assert s.realized_delivery is None, seg
        else:
            np.testing.assert_allclose(s.realized_delivery,
                                       e.realized_delivery, rtol=1e-6)
        np.testing.assert_array_equal(e.eval_iters, s.eval_iters)
        np.testing.assert_allclose(s.eval_curve, e.eval_curve, rtol=1e-6,
                                   atol=0, err_msg=seg)
    for a, b in zip(tree_leaves(eager.global_params),
                    tree_leaves(scan.global_params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)
    assert torch.equal(eager.client_data.sizes, scan.client_data.sizes)
    assert torch.equal(eager.client_data.data, scan.client_data.data)


@pytest.mark.parametrize("scenario", ["static", "fading", "churn"])
@pytest.mark.parametrize("mode", ["online", "uniform"])
def test_scan_matches_eager(small, scenario, mode):
    _, eager_cfg = scan_configs("eager", retry=False, mode=mode,
                                policy="mixed", n_segments=3)
    scan_cfg = dataclasses.replace(eager_cfg, segment_impl="scan")
    xs, ys, ev = small
    eager = t_run(xs, ys, TC, eager_cfg, scenario, ev,
                  draws=SeededDraws(11, "cpu"), device="cpu")
    scan = t_run(xs, ys, TC, scan_cfg, scenario, ev,
                 draws=SeededDraws(11, "cpu"), device="cpu")
    _assert_scan_equals_eager(eager, scan)
    # one chunk holds every segment after the first
    assert [c[:2] for c in scan.chunk_seconds] == [(1, 3)]
    assert len(scan.segment_seconds) == 1
    if mode == "online":
        assert sum(s.moved for s in scan.trace.segments) > 0


# ---------------------------------------------------------------------------
# scan against the JAX package's scan
# ---------------------------------------------------------------------------

class PortGateMargins:
    """Wraps the port's exchange program and records, per call, the
    smallest relative gate margin over the pairs whose decision rests on
    ``base < score`` (trusted, live, with reserves, channel held)."""

    def __init__(self):
        self.margins = []
        self._orig = tex._exchange_device

    def __call__(self, *args):
        out = self._orig(*args)
        _, _, base, scores, fail, _, _ = out
        sel_mask, trust_s, in_edge = args[5], args[6], args[9].long()
        rows = torch.arange(in_edge.shape[0])
        allowed = (trust_s[in_edge, rows] != 0) \
            & (in_edge != rows)[:, None] & (sel_mask[in_edge] > 0).any(-1) \
            & ~fail[:, None]
        rel = (scores - base[:, None]).abs() / base[:, None].abs()
        self.margins.append(float(rel[allowed].min()) if bool(allowed.any())
                            else float("inf"))
        return out


@pytest.fixture(scope="module")
def burst_outage_scan(small, tmp_path_factory):
    """Both scans traced: (port result, JAX result, margins, port
    manifest, JAX manifest, untraced port run)."""
    xs, ys, ev = small
    key = jax.random.PRNGKey(7)
    jcfg, tcfg = scan_configs()
    d = tmp_path_factory.mktemp("burst_outage_scan")
    want, jax_man = traced(jax_obs, d / "jax.jsonl", lambda: j_run(
        key, xs, ys, JC, jcfg, "burst-outage", ev))

    def port():
        return t_run(xs, ys, TC, tcfg, "burst-outage", ev,
                     draws=JaxReplayDraws(key), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        gm = PortGateMargins()
        mp.setattr(tex, "_exchange_device", gm)
        got, port_man = traced(port_obs, d / "port.jsonl", port)
    return got, want, gm.margins, port_man, jax_man, port()


def test_burst_outage_scan_with_retry_matches_jax(burst_outage_scan):
    got, want, margins = burst_outage_scan[:3]
    compare_runs(got, want, margins)
    summary = want.trace.summary()
    assert summary["total_failed_links"] > 0 and summary["total_retried"] > 0
    assert summary["total_moved"] > 0
    assert got.trace.summary() == pytest.approx(summary, rel=2e-4, abs=1e-6)
    # retries on: every rediscovery ends a chunk
    assert [c[:2] for c in got.chunk_seconds] == [(1, 2), (2, 3), (3, 4)]


def test_burst_outage_scan_span_tree_matches_jax(burst_outage_scan):
    got, _, _, port_man, jax_man, untraced = burst_outage_scan
    compare_traces(port_man, jax_man)
    spans = port_man["spans"]
    chunks = [s for s in spans if s["name"] == "scan-chunk"]
    assert [(s["attrs"]["start"], s["attrs"]["start"]
             + s["attrs"]["n_segments"]) for s in chunks] == \
        [c[:2] for c in got.chunk_seconds]
    # no named span inside a chunk: each scan-chunk's predecessor in close
    # order is no deeper than it
    for i, s in enumerate(spans):
        if s["name"] == "scan-chunk" and i:
            assert spans[i - 1]["depth"] <= s["depth"]
    assert "retry-exchange" in [s["name"] for s in spans]
    assert_runs_identical(got, untraced)


# ---------------------------------------------------------------------------
# kill and resume, and validation
# ---------------------------------------------------------------------------

def test_scan_kill_and_resume_is_bit_identical(small, tmp_path):
    xs, ys, ev = small
    _, cfg = scan_configs(retry=True, checkpoint_dir=str(tmp_path),
                          checkpoint_every=2)
    # burst-outage, preempted at segment 2: the resumed part retries
    whole = get_scenario("burst-outage")
    scn = dataclasses.replace(whole, faults=dataclasses.replace(
        whole.faults, preempt_at=2))

    def run(scenario, **kw):
        return t_run(xs, ys, TC, cfg, scenario, ev,
                     draws=SeededDraws(5, "cpu"), device="cpu", **kw)

    ref = run(whole)
    with pytest.raises(Preempted) as info:
        run(scn)
    assert info.value.segment == 2
    resumed = run(scn, resume_from=cfg.checkpoint_path)
    assert [s.segment for s in resumed.trace.segments] == [0, 1, 2, 3]
    assert_runs_identical(ref, resumed)
    assert sum(s.retried for s in ref.trace.segments) > 0


def test_scan_validates_config(small):
    xs, ys, ev = small
    _, cfg = scan_configs()
    for bad, match in ((dict(reserve_selector="host"), "reserve_selector"),
                       (dict(overflow="grow"), "overflow"),
                       (dict(method="loop"), "method")):
        exc = dataclasses.replace(cfg.pipeline.exchange, **bad)
        with pytest.raises(ValueError, match=match):
            t_run(xs, ys, TC, dataclasses.replace(
                cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                  exchange=exc)),
                  "static", ev, device="cpu")
    with pytest.raises(ValueError, match="segment_impl"):
        t_run(xs, ys, TC, dataclasses.replace(cfg, segment_impl="fused"),
              "static", ev, device="cpu")
    # oneshot never re-exchanges: any exchange configuration is accepted
    oneshot = dataclasses.replace(cfg, mode="oneshot", n_segments=2,
                                  pipeline=dataclasses.replace(
                                      cfg.pipeline,
                                      exchange=tex.ExchangeConfig(
                                          reserve_per_cluster=8)))
    res = t_run(xs, ys, TC, oneshot, "static", ev,
                draws=SeededDraws(2, "cpu"), device="cpu")
    assert [s.rediscovered for s in res.trace.segments] == [True, False]
