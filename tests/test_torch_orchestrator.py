"""The port's online orchestrator.

* ``static`` + ``oneshot`` is exactly the port's own ``run_pipeline`` +
  ``fl_train`` on the same draws (the reference's ``test_dynamics_parity``
  contract).
* Against the JAX package on :class:`JaxReplayDraws`: ``burst-outage`` in
  mode ``online`` with retries, and ``regional-failure`` in mode
  ``online``, both under UCB discovery. Before any gate decision is
  compared exactly, every exchange of the reference's run (re-exchanges and
  retries included) must show a smallest relative gate margin
  |score - base| / |base| above 1e-4 over the pairs the gate decides; the
  port's scores agree to ~1e-5. Per segment: ``in_edge``, moved,
  ``n_available``, retried, delivered, ``n_live`` and ``n_failed`` exact;
  ``mean_pfail`` and ``expected_delivery`` within 1e-6 absolute; eval losses
  and final parameters within 2e-4 relative + 2e-5 absolute
  (``test_torch_fl``'s tolerance); the final client data exact.
* The same two runs traced on both sides (``repro.obs`` around the JAX
  run, ``repro_torch.obs`` around the port's): equal span lists in close
  order in (name, depth, attrs, transfers), equal ``retry-outcome`` marks,
  one transfer per run inside ``metrics-materialize``; and the traced port
  run equals an untraced one bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core import exchange as jex
from repro.core import pipeline as jpl
from repro.core import qlearning as jql
from repro.data.partition import partition_by_classes
from repro.data.synthetic import make_split_dataset
from repro.dynamics import OrchestratorConfig as JOC
from repro.dynamics import run_orchestrator as j_run
from repro.faults import RetryPolicy as JRP
from repro.fl import FLConfig as JFL
from repro.models import autoencoder as jae
from repro_torch import obs as port_obs
from repro_torch.core import exchange as tex
from repro_torch.core import pipeline as tpl
from repro_torch.core import qlearning as tql
from repro_torch.dynamics import OrchestratorConfig as TOC
from repro_torch.dynamics import SeededDraws
from repro_torch.dynamics import run_orchestrator as t_run
from repro_torch.faults import RetryPolicy as TRP
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import fl_train as t_fl_train
from repro_torch.models.autoencoder import AEConfig as TAE
from repro_torch.models.common import tree_leaves

from test_torch_draws import JaxReplayDraws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JC = jae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
TC = TAE(8, 8, 1, widths=(4, 8), latent_dim=8)
MARGIN = 1e-4


def world():
    key = jax.random.PRNGKey(0)
    tr, ev = make_split_dataset(key, n_train_per_class=30,
                                n_eval_per_class=6, height=8, width=8,
                                channels=1)
    xs, ys, _ = partition_by_classes(0, np.asarray(tr.images),
                                     np.asarray(tr.labels), n_clients=6,
                                     classes_per_client=3, circular=True)
    return xs, ys, np.asarray(ev.images)


def configs(policy="ucb", channel_failure=True, retry=True, n_segments=4,
            mode="online", **extra):
    """(JAX, port) orchestrator configs at the tests' small size."""
    kw = dict(n_pca=4, kmeans_iters=5)
    rl = dict(n_episodes=30, buffer_size=10, policy=policy)
    exc = dict(reserve_per_cluster=8, apply_channel_failure=channel_failure)
    fl = dict(tau_a=10, batch_size=8, eval_every=10)
    orch = dict(n_segments=n_segments, iters_per_segment=10, mode=mode,
                rediscover_every=1, burst_episodes=20, **extra)
    return (JOC(pipeline=jpl.PipelineConfig(rl=jql.RLConfig(**rl),
                                            exchange=jex.ExchangeConfig(**exc),
                                            **kw),
                fl=JFL(**fl), retry=JRP(enabled=retry), **orch),
            TOC(pipeline=tpl.PipelineConfig(rl=tql.RLConfig(**rl),
                                            exchange=tex.ExchangeConfig(**exc),
                                            **kw),
                fl=TFL(**fl), retry=TRP(enabled=retry), **orch))


class GateMargins:
    """Wraps the reference's exchange program and records, per call, the
    smallest relative gate margin over the (receiver, cluster) pairs whose
    decision rests on ``base < score``: trusted, live, with reserves, and
    whose channel held."""

    def __init__(self):
        self.margins = []
        self._orig = jex._exchange_device

    def __call__(self, *args):
        out = self._orig(*args)
        _, _, base, scores, fail, _, _ = out
        sel_mask, trust_s, in_edge = (np.asarray(args[9]),
                                      np.asarray(args[10]),
                                      np.asarray(args[13]))
        n = in_edge.shape[0]
        rows = np.arange(n)
        allowed = (trust_s[in_edge, rows] != 0) \
            & (in_edge != rows)[:, None] & sel_mask[in_edge].any(-1) \
            & ~np.asarray(fail)[:, None]
        base, scores = np.asarray(base), np.asarray(scores)
        rel = np.abs(scores - base[:, None]) / np.abs(base[:, None])
        self.margins.append(float(rel[allowed].min()) if allowed.any()
                            else float("inf"))
        return out


def jax_run(monkeypatch_ctx, key, xs, ys, ev, jcfg, scenario, **kw):
    gm = GateMargins()
    monkeypatch_ctx.setattr(jex, "_exchange_device", gm)
    res = j_run(key, xs, ys, JC, jcfg, scenario, ev, **kw)
    monkeypatch_ctx.undo()
    return res, gm.margins


def compare_runs(got, want, margins):
    """The per-segment comparison of a port run against a JAX run."""
    assert min(margins) > MARGIN, \
        f"the reference's gate margins {margins} leave a decision to rounding"
    assert len(got.trace.segments) == len(want.trace.segments)
    for g, w in zip(got.trace.segments, want.trace.segments):
        seg = f"segment {w.segment}"
        np.testing.assert_array_equal(g.in_edge, np.asarray(w.in_edge), seg)
        for f in ("segment", "moved", "n_available", "retried",
                  "retry_delivered", "n_live", "n_failed", "rediscovered"):
            assert getattr(g, f) == getattr(w, f), (seg, f)
        assert g.realized_delivery == w.realized_delivery, seg
        assert g.link_churn == w.link_churn, seg
        for f in ("mean_pfail", "expected_delivery"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=0,
                                       atol=1e-6, err_msg=seg)
        np.testing.assert_array_equal(g.eval_iters, w.eval_iters)
        np.testing.assert_allclose(g.eval_curve, w.eval_curve, rtol=2e-4,
                                   atol=2e-5, err_msg=seg)
        np.testing.assert_allclose(g.eval_loss, w.eval_loss, rtol=2e-4,
                                   atol=2e-5, err_msg=seg)
    for a, b in zip(tree_leaves(got.global_params),
                    jax.tree.leaves(want.global_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_array_equal(got.client_data.sizes.numpy(),
                                  np.asarray(want.client_data.sizes))
    for a, b in zip(got.datasets, want.datasets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.labels, want.labels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def traced(obs_mod, path, fn):
    """``fn()`` under ``obs_mod``'s tracer with a manifest at ``path``;
    returns (fn's result, the manifest). The tracer's module-level event
    list is drained after, so later tests in the process start empty."""
    obs_mod.enable(manifest=str(path))
    try:
        out = fn()
    finally:
        obs_mod.disable()
        obs_mod.drain()
    return out, obs_mod.read_manifest(str(path))


def span_list(man) -> list:
    return [(s["name"], s["depth"], s.get("attrs", {}), s["transfers"])
            for s in man["spans"]]


def compare_traces(port_man, jax_man):
    """The port's span tree and marks against the JAX package's."""
    got, want = span_list(port_man), span_list(jax_man)
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"span {i}: port {g} JAX {w}"
    assert port_man["marks"] == jax_man["marks"]
    for man in (port_man, jax_man):
        assert man["end"]["transfers"] == 1
        assert [(s["name"], s["transfers"]) for s in man["spans"]
                if s["transfers"]] == [("metrics-materialize", 1),
                                       ("orchestrator", 1)]


def assert_runs_identical(a, b):
    """Two port runs' results, bit for bit."""
    assert len(a.trace.segments) == len(b.trace.segments)
    for x, y in zip(a.trace.segments, b.trace.segments):
        for f in dataclasses.fields(x):
            vx, vy = getattr(x, f.name), getattr(y, f.name)
            if isinstance(vx, np.ndarray):
                np.testing.assert_array_equal(vx, vy)
            else:
                assert vx == vy or (vx != vx and vy != vy), \
                    (x.segment, f.name)
    for u, v in zip(tree_leaves(a.global_params),
                    tree_leaves(b.global_params)):
        assert torch.equal(u, v)
    for u, v in zip(a.client_data, b.client_data):
        assert torch.equal(u, v)
    assert torch.equal(a.in_edge, b.in_edge)


@pytest.fixture(scope="module")
def small():
    return world()


# ---------------------------------------------------------------------------
# static + oneshot is run_pipeline + fl_train, bit for bit
# ---------------------------------------------------------------------------

def test_static_oneshot_matches_pipeline_bit_for_bit(small):
    xs, ys, ev = small
    _, cfg = configs(policy="mixed", channel_failure=False, retry=False,
                     n_segments=2, mode="oneshot")
    draws = SeededDraws(42, "cpu")
    res = t_run(xs, ys, TC, cfg, "static", ev, draws=draws, device="cpu")

    pcfg = cfg.pipeline
    sizes = [x.shape[0] for x in xs]
    pipe = tpl.run_pipeline(xs, ys, TC, pcfg,
                            draws=draws.pipeline(sizes, None, pcfg, TC),
                            device="cpu")
    flcfg = dataclasses.replace(cfg.fl, total_iters=cfg.total_iters)
    ref = t_fl_train(pipe.client_data, TC, flcfg, ev,
                     init_params=draws.fl_init(TC),
                     batch_idx=[draws.fl_batch(r, pipe.client_data.sizes,
                                               flcfg) for r in range(2)],
                     device="cpu")

    np.testing.assert_array_equal(ref.eval_iters, res.eval_iters)
    np.testing.assert_array_equal(ref.eval_loss, res.eval_loss)
    for a, b in zip(tree_leaves(ref.global_params),
                    tree_leaves(res.global_params)):
        assert torch.equal(a, b)
    assert torch.equal(pipe.in_edge, res.in_edge)
    assert torch.equal(pipe.client_data.data, res.client_data.data)
    assert torch.equal(pipe.client_data.sizes, res.client_data.sizes)
    segs = res.trace.segments
    assert [s.rediscovered for s in segs] == [True, False]
    assert [s.moved for s in segs] == [int(pipe.moved_counts.sum()), 0]
    assert len(res.segment_seconds) == 2 and len(res.stage_seconds) == 2


def test_modes_and_engines_are_checked(small):
    xs, ys, ev = small
    _, cfg = configs(n_segments=1)
    for bad, err in ((dict(mode="sometimes"), ValueError),
                     (dict(segment_impl="fused"), ValueError),
                     (dict(iters_per_segment=15), ValueError)):
        with pytest.raises(err):
            t_run(xs, ys, TC, dataclasses.replace(cfg, **bad), "static", ev,
                  device="cpu")
    # the scan engine refuses, as the reference does, every exchange
    # configuration its chunks cannot run without reading the device
    scan = dataclasses.replace(cfg, segment_impl="scan")
    ok = dict(overflow="drop", reserve_selector="device")
    for bad, match in ((dict(method="loop"), "method"),
                       (dict(overflow="grow"), "overflow"),
                       (dict(reserve_selector="host"), "reserve_selector")):
        exc = dataclasses.replace(cfg.pipeline.exchange, **{**ok, **bad})
        with pytest.raises(ValueError, match=match):
            t_run(xs, ys, TC, dataclasses.replace(
                scan, pipeline=dataclasses.replace(cfg.pipeline,
                                                   exchange=exc)),
                  "static", ev, device="cpu")
    with pytest.raises(ValueError, match="eval_data"):
        t_run(xs, ys, TC, cfg, "static", None, device="cpu")


def test_uniform_mode_redraws_graphs_without_self_links(small):
    xs, ys, ev = small
    _, cfg = configs(mode="uniform", n_segments=3)
    res = t_run(xs, ys, TC, cfg, "fading", ev, draws=SeededDraws(3, "cpu"),
                device="cpu")
    for seg in res.trace.segments:
        assert (seg.in_edge != np.arange(6)).all()
        assert seg.rediscovered and np.isfinite(seg.eval_loss)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def traced_pair(small, tmp_path_factory, key, scenario, **kw):
    """The JAX run and the port's, each traced: (port result, JAX
    result, margins, port manifest, JAX manifest, untraced port run)."""
    xs, ys, ev = small
    jcfg, tcfg = configs(**kw)
    d = tmp_path_factory.mktemp(scenario)
    with pytest.MonkeyPatch.context() as mp:
        (want, margins), jax_man = traced(
            jax_obs, d / "jax.jsonl",
            lambda: jax_run(mp, key, xs, ys, ev, jcfg, scenario))

    def port():
        return t_run(xs, ys, TC, tcfg, scenario, ev,
                     draws=JaxReplayDraws(key), device="cpu")
    got, port_man = traced(port_obs, d / "port.jsonl", port)
    return got, want, margins, port_man, jax_man, port()


@pytest.fixture(scope="module")
def burst_outage(small, tmp_path_factory):
    return traced_pair(small, tmp_path_factory, jax.random.PRNGKey(7),
                       "burst-outage")


@pytest.fixture(scope="module")
def regional_failure(small, tmp_path_factory):
    return traced_pair(small, tmp_path_factory, jax.random.PRNGKey(8),
                       "regional-failure", retry=False)


def test_burst_outage_online_with_retry_matches_jax(burst_outage):
    got, want, margins = burst_outage[:3]
    compare_runs(got, want, margins)
    summary = want.trace.summary()
    # the burst fails live links and the queue retries them
    assert summary["total_failed_links"] > 0 and summary["total_retried"] > 0
    assert got.trace.summary() == pytest.approx(summary, rel=2e-4, abs=1e-6)


def test_regional_failure_online_matches_jax(regional_failure):
    got, want, margins = regional_failure[:3]
    compare_runs(got, want, margins)
    # the blackout and the crash pulse take clients offline
    assert min(s.n_available for s in want.trace.segments[1:]) < 6


def test_retry_edges_never_land_self_links(burst_outage):
    got = burst_outage[0]
    for seg in got.trace.segments:
        assert (seg.in_edge != np.arange(6)).all()
        assert seg.n_failed <= seg.n_live


@pytest.mark.parametrize("run", ["burst_outage", "regional_failure"])
def test_span_tree_matches_jax_and_tracing_changes_nothing(run, request):
    got, _, _, port_man, jax_man, untraced = request.getfixturevalue(run)
    compare_traces(port_man, jax_man)
    names = [s["name"] for s in port_man["spans"]]
    for name in ("pipeline", "cluster", "trust-channel", "discover",
                 "exchange", "pretrain", "gate", "segment", "env-step",
                 "fault-inject", "re-cluster", "re-discover", "re-exchange",
                 "fl-segment", "fl", "metrics-materialize", "orchestrator"):
        assert name in names, name
    if run == "burst_outage":
        # the burst fails links and the queue retries them
        assert "retry-exchange" in names
        assert [m["name"] for m in port_man["marks"]] == \
            ["retry-outcome"] * names.count("retry-exchange")
    assert_runs_identical(got, untraced)
