"""The port's batched exchange against ``repro.core.exchange``.

Both sides start from the same AE init (replayed draws) and the same reserve
seed, so reserve subsets are exactly equal. Gate scores are compared within
1e-5 relative (float32 convolutions summed in another order); accept
decisions only where |base - score| exceeds 1e-4 relative, because the
gate's strict ``base < score`` flips on ulp-level differences. Data moved
under a decision that agrees is compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jb
from repro.core import channel as jch
from repro.core import exchange as jex
from repro.core import trust as jtr
from repro.models import autoencoder as jae
from repro.models.autoencoder import AEConfig as JAE
from repro_torch import convert
from repro_torch.core import batching as tb
from repro_torch.core import exchange as tex
from repro_torch.models.autoencoder import AEConfig as TAE
from repro_torch.models.common import tree_leaves

from test_torch_draws import exchange_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, K, R = 5, 3, 6
JC = JAE(8, 8, 1, widths=(4, 8), latent_dim=8)
TC = TAE(8, 8, 1, widths=(4, 8), latent_dim=8)


def _world(seed=0):
    rng = np.random.default_rng(seed)
    sizes = [14, 9, 20, 11, 16]
    xs = [rng.uniform(size=(s, 8, 8, 1)).astype(np.float32) * (1 + i % 3)
          for i, s in enumerate(sizes)]
    ys = [rng.integers(0, 10, size=s).astype(np.int32) for s in sizes]
    cap = max(sizes)
    assign = np.full((N, cap), 0, np.int32)
    for i, s in enumerate(sizes):
        assign[i, :s] = rng.integers(0, K, size=s)
    trust = [np.asarray(m) for m in
             jtr.make_trust(jax.random.PRNGKey(seed), N, K, 0.8)]
    in_edge = np.array([2, 0, 4, 3, 1])       # client 3 keeps its own data
    pf = np.asarray(jch.failure_prob(jch.make_rss(jax.random.PRNGKey(9), N)))
    return xs, ys, assign, trust, in_edge, pf


def _reference_device(key, xs, ys, assign, trust, in_edge, pf, cfg):
    """The reference's gate internals: (new stack, moved, base, scores,
    fail, accept, overflowed)."""
    cd = jb.client_data_from_lists(xs, ys)
    k_pre, k_sel, k_ch = jax.random.split(key, 3)
    params = jex.pretrain_autoencoders_batched(k_pre, cd, JC, cfg)
    sel = jex._select_reserves(k_sel, assign, [K] * N, R, sizes=cd.sizes)
    sel_idx, sel_mask = jex._sel_tensors(sel, N, K, R)
    out_cap = cd.cap + int(sel_mask.sum(axis=(1, 2)).max()) \
        if cfg.overflow == "grow" else cd.cap
    return jex._exchange_device(
        JC, cfg.apply_channel_failure, out_cap, None, params, cd.data,
        cd.sizes, cd.labels, jnp.asarray(sel_idx), jnp.asarray(sel_mask),
        jnp.asarray(jex._stack_trust_padded(trust, N, K)),
        jax.random.uniform(k_ch, (N,)), jnp.asarray(pf), jnp.asarray(in_edge))


def _cfgs(**kw):
    return (jex.ExchangeConfig(reserve_per_cluster=R, **kw),
            tex.ExchangeConfig(reserve_per_cluster=R, **kw))


@pytest.mark.parametrize("overflow,channel", [("grow", False),
                                              ("drop", False),
                                              ("grow", True)])
def test_gate_and_scatter_match_reference(overflow, channel):
    xs, ys, assign, trust, in_edge, pf = _world()
    key = jax.random.PRNGKey(4)
    jcfg, tcfg = _cfgs(overflow=overflow, apply_channel_failure=channel)
    want_cd, want_moved, base, scores, fail, accept, _ = _reference_device(
        key, xs, ys, assign, trust, in_edge, pf, jcfg)
    got = tex.run_exchange(xs, ys, torch.as_tensor(assign),
                           torch.as_tensor(np.stack(trust)),
                           torch.as_tensor(in_edge), torch.as_tensor(pf), TC,
                           tcfg, draws=exchange_draws(key, N, JC),
                           device="cpu")
    np.testing.assert_allclose(got.base.numpy(), np.asarray(base), rtol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(scores),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(fail))
    margin = np.abs(np.asarray(scores) - np.asarray(base)[:, None]) \
        > 1e-4 * np.abs(np.asarray(base))[:, None]
    np.testing.assert_array_equal(got.accept.numpy()[margin],
                                  np.asarray(accept)[margin])
    assert margin.all(), "this world is built with clear gate margins"
    np.testing.assert_array_equal(got.moved_counts, np.asarray(want_moved))
    np.testing.assert_array_equal(got.client_data.sizes.numpy(),
                                  np.asarray(want_cd.sizes))
    for a, b in zip(got.datasets, want_cd.data_list()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.labels, want_cd.label_list()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if overflow == "grow":
        assert got.moved_counts.sum() > 0


def test_public_entry_point_matches_reference():
    xs, ys, assign, trust, in_edge, pf = _world(1)
    key = jax.random.PRNGKey(6)
    jcfg, tcfg = _cfgs()
    want = jex.run_exchange(key, xs, ys, assign, trust, in_edge, pf, JC,
                            jcfg)
    got = tex.run_exchange(xs, ys, torch.as_tensor(assign), trust,
                           torch.as_tensor(in_edge), torch.as_tensor(pf), TC,
                           tcfg, draws=exchange_draws(key, N, JC),
                           device="cpu")
    np.testing.assert_array_equal(got.moved_counts, want.moved_counts)
    assert got.gate_decisions == want.gate_decisions


def test_error_policy_raises_like_reference():
    xs, ys, assign, trust, in_edge, pf = _world()
    key = jax.random.PRNGKey(4)
    jcfg, tcfg = _cfgs(overflow="error")
    with pytest.raises(ValueError, match="overflow"):
        jex.run_exchange(key, xs, ys, assign, trust, in_edge, pf, JC, jcfg)
    with pytest.raises(ValueError, match="overflow"):
        tex.run_exchange(xs, ys, torch.as_tensor(assign), trust,
                         torch.as_tensor(in_edge), torch.as_tensor(pf), TC,
                         tcfg, draws=exchange_draws(key, N, JC),
                         device="cpu")


def test_pretrain_matches_reference():
    xs, *_ = _world(2)
    key = jax.random.PRNGKey(8)
    cfg_j, cfg_t = _cfgs(pretrain_steps=2)
    want = jex.pretrain_autoencoders_batched(
        key, jb.client_data_from_lists(xs), JC, cfg_j)
    init = jax.jit(jax.vmap(lambda kk: jae.init_ae(kk, JC)))(
        jax.random.split(key, N))
    got = tex.pretrain_autoencoders_batched(
        convert.ae_params(jax.device_get(init)),
        tb.client_data_from_lists(xs), TC, cfg_t)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_bad_overflow_policy_rejected():
    xs, ys, assign, trust, in_edge, pf = _world()
    with pytest.raises(ValueError, match="overflow"):
        tex.run_exchange(xs, ys, torch.as_tensor(assign), trust,
                         torch.as_tensor(in_edge), torch.as_tensor(pf), TC,
                         tex.ExchangeConfig(overflow="spill"),
                         generator=torch.Generator(), device="cpu")
