"""The exchange's second data plane and second reserve selector against
``repro.core.exchange``, and the port's two planes against each other.

* ``select_reserves_device`` on JAX's own uniforms
  (``uniform(k_sel, (n, k_max, cap))``): ``sel_idx``/``sel_mask`` exactly
  equal, with an empty cluster and with a cap below the reserve budget.
* The loop plane against JAX's: gate decisions exactly where the relative
  gate margin |score - base| / |base| (read from the port's batched scores,
  which agree with JAX's to ~1e-5) exceeds 1e-4, and the world is built so
  that every margin does; moved counts and the post-exchange data exactly.
* The port's loop plane against its batched plane on the same draws:
  identical ``gate_decisions`` and ``moved_counts``.
* The device selector through ``run_exchange``: decisions and moved counts
  equal JAX's, ``gate_decisions`` readable from the selector's tensors.
* ``run_exchange``'s validation errors, as the reference raises them.
* The list-form ``pretrain_autoencoders`` within 1e-5 relative.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.core.batching import as_client_data
from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.core import exchange as tex
from repro_torch.models.common import tree_leaves

from test_torch_draws import exchange_draws, t, one_torch_thread  # noqa: F401
from test_torch_exchange import JC, K, N, R, TC, _world

pytestmark = pytest.mark.usefixtures("one_torch_thread")
MARGIN = 1e-4


def _args(world):
    xs, ys, assign, trust, in_edge, pf = world
    return (torch.as_tensor(assign), torch.as_tensor(np.stack(trust)),
            torch.as_tensor(in_edge.copy()), torch.as_tensor(pf.copy()))


def _port(world, key, cfg, method=None, sel_shape=None):
    xs, ys = world[:2]
    assign, trust, in_edge, pf = _args(world)
    return tex.run_exchange(xs, ys, assign, trust, in_edge, pf, TC, cfg,
                            draws=exchange_draws(key, N, JC, sel_shape),
                            method=method, device="cpu")


def _margins_clear(batched) -> bool:
    """Every decided pair's relative margin exceeds MARGIN."""
    base, scores = batched.base, batched.scores
    rel = (scores - base[:, None]).abs() / base[:, None].abs()
    decided = [(i, m) for i, _, m, _ in batched.gate_decisions if m >= 0]
    return all(float(rel[i, m]) > MARGIN for i, m in decided)


# ---------------------------------------------------------------------------
# the device selector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [4, 40])       # 40: above every cap here
def test_select_reserves_device_matches_jax(r):
    rng = np.random.default_rng(3)
    sizes = np.array([14, 9, 20, 11, 16])
    cap = 22
    assign = rng.integers(0, K, size=(N, cap)).astype(np.int32)
    assign[1, :sizes[1]] = np.where(assign[1, :sizes[1]] == 2, 0,
                                    assign[1, :sizes[1]])   # empty cluster
    assign[3, :sizes[3]] = 1                               # one cluster only
    key = jax.random.PRNGKey(5)
    want_idx, want_mask = jax.jit(
        jex.select_reserves_device, static_argnums=(3, 4))(
            key, assign, sizes, K, r)
    u = jax.random.uniform(key, (N, K, cap))
    got_idx, got_mask = tex.select_reserves_device(
        t(u), torch.as_tensor(assign), torch.as_tensor(sizes), K, r)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_idx.shape == (N, K, r)
    assert got_mask[1, 2].sum() == 0                 # the empty cluster
    counts = got_mask.sum(-1).numpy()
    for j in range(N):
        for m in range(K):
            members = int((assign[j, :sizes[j]] == m).sum())
            assert counts[j, m] == min(r, members)


# ---------------------------------------------------------------------------
# the loop plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", [False, True])
def test_loop_plane_matches_jax(channel):
    world = _world(0)
    xs, ys, assign, trust, in_edge, pf = world
    key = jax.random.PRNGKey(4)
    kw = dict(reserve_per_cluster=R, apply_channel_failure=channel)
    want = jex.run_exchange(key, xs, ys, assign, trust, in_edge, pf, JC,
                            jex.ExchangeConfig(**kw), method="loop")
    got = _port(world, key, tex.ExchangeConfig(**kw), method="loop")
    batched = _port(world, key, tex.ExchangeConfig(**kw))
    assert _margins_clear(batched), "this world is built with clear margins"
    assert got.gate_decisions == want.gate_decisions
    np.testing.assert_array_equal(got.moved_counts, want.moved_counts)
    assert got.failed_links() == want.failed_links()
    for a, b in zip(got.datasets, want.datasets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.labels, want.labels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.moved_counts.sum() > 0


@pytest.mark.parametrize("seed,channel", [(0, False), (1, True), (2, False)])
def test_loop_and_batched_planes_agree(seed, channel):
    world = _world(seed)
    key = jax.random.PRNGKey(10 + seed)
    cfg = tex.ExchangeConfig(reserve_per_cluster=R,
                             apply_channel_failure=channel)
    loop = _port(world, key, cfg, method="loop")
    batched = _port(world, key, dataclasses.replace(cfg, method="batched"))
    assert loop.gate_decisions == batched.gate_decisions
    np.testing.assert_array_equal(loop.moved_counts, batched.moved_counts)
    for a, b in zip(loop.datasets, batched.datasets):
        assert torch.equal(a, b)


def test_device_selector_exchange_matches_jax():
    world = _world(1)
    xs, ys, assign, trust, in_edge, pf = world
    key = jax.random.PRNGKey(6)
    kw = dict(reserve_per_cluster=R, reserve_selector="device",
              overflow="drop", apply_channel_failure=True)
    want = jex.run_exchange(key, xs, ys, assign, trust, in_edge, pf, JC,
                            jex.ExchangeConfig(**kw))
    got = _port(world, key, tex.ExchangeConfig(**kw),
                sel_shape=(K, max(x.shape[0] for x in xs)))
    assert _margins_clear(got)
    assert got.gate_decisions == want.gate_decisions
    np.testing.assert_array_equal(got.moved_counts, want.moved_counts)
    np.testing.assert_array_equal(got.client_data.sizes.numpy(),
                                  np.asarray(want.client_data.sizes))


# ---------------------------------------------------------------------------
# validation and the list-form pretraining
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad,method,match", [
    (dict(overflow="spill"), None, "overflow policy"),
    (dict(reserve_selector="gpu"), None, "reserve selector"),
    (dict(overflow="drop"), "loop", "'grow' semantics"),
    (dict(reserve_selector="device"), "loop", "host-selector"),
    (dict(), "scatter", "unknown exchange method"),
])
def test_run_exchange_validation_matches_reference(bad, method, match):
    world = _world(0)
    xs, ys, assign, trust, in_edge, pf = world
    key = jax.random.PRNGKey(4)
    with pytest.raises(ValueError, match=match):
        jex.run_exchange(key, xs, ys, assign, trust, in_edge, pf, JC,
                         jex.ExchangeConfig(reserve_per_cluster=R, **bad),
                         method=method)
    with pytest.raises(ValueError, match=match):
        _port(world, key, tex.ExchangeConfig(reserve_per_cluster=R, **bad),
              method=method)


def test_loop_plane_needs_labels():
    world = _world(0)
    xs, _, assign, trust, in_edge, pf = world
    key = jax.random.PRNGKey(4)
    with pytest.raises(ValueError, match="needs labels"):
        jex.run_exchange(key, as_client_data(xs), None, assign, trust,
                         in_edge, pf, JC,
                         jex.ExchangeConfig(reserve_per_cluster=R),
                         method="loop")
    a, tr, e, p = _args(world)
    with pytest.raises(ValueError, match="needs labels"):
        tex.run_exchange(xs, None, a, tr, e, p, TC,
                         tex.ExchangeConfig(reserve_per_cluster=R),
                         draws=exchange_draws(key, N, JC), method="loop",
                         device="cpu")


def test_list_pretrain_matches_reference():
    # equal sizes: the reference's per-client grad compiles once
    xs = [x[:9] for x in _world(2)[0]]
    key = jax.random.PRNGKey(8)
    want = jex.pretrain_autoencoders(
        key, xs, JC, jex.ExchangeConfig(pretrain_steps=2))
    got = tex.pretrain_autoencoders(
        _init_from(key), [torch.as_tensor(x) for x in xs], TC,
        tex.ExchangeConfig(pretrain_steps=2))
    assert len(got) == N
    for g, w in zip(got, want):
        for a, b in zip(tree_leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def _init_from(key):
    """The stacked init ``pretrain_autoencoders(key, ...)`` starts from:
    ``init_ae`` on each of ``split(key, N)``."""
    init = jax.jit(jax.vmap(lambda kk: jae.init_ae(kk, JC)))(
        jax.random.split(key, N))
    return convert.ae_params(jax.device_get(init))


def test_orchestrator_runs_the_loop_plane_like_the_batched_one():
    """The eager engine on the loop plane: realized delivery from the
    host decisions, failed links for the retry queue from them too; the
    graphs, moved counts, realized delivery and retries equal the batched
    plane's on the same draws."""
    from repro_torch.dynamics import SeededDraws
    from repro_torch.dynamics import run_orchestrator as t_run
    from test_torch_orchestrator import TC as OTC
    from test_torch_orchestrator import configs, world
    xs, ys, ev = world()
    _, cfg = configs(n_segments=3)
    loop = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, exchange=dataclasses.replace(cfg.pipeline.exchange,
                                                   method="loop")))
    runs = [t_run(xs, ys, OTC, c, "burst-outage", ev,
                  draws=SeededDraws(9, "cpu"), device="cpu")
            for c in (cfg, loop)]
    batched, looped = (r.trace.segments for r in runs)
    for b, lp in zip(batched, looped):
        np.testing.assert_array_equal(b.in_edge, lp.in_edge)
        for f in ("moved", "retried", "retry_delivered", "n_available"):
            assert getattr(b, f) == getattr(lp, f), (b.segment, f)
        # the device computes realized delivery in float32, the host in
        # float64
        assert b.realized_delivery == pytest.approx(lp.realized_delivery,
                                                    rel=1e-6)
    assert any(s.realized_delivery is not None for s in looped)
    assert sum(s.moved for s in looped) > 0
