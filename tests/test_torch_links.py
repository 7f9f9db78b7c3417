"""Trust, channel, lambda and rewards of the port against the reference.
All are deterministic given their draws, so tolerances are tight: 1e-6
relative for float32 closed forms, exact for integer outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import dissimilarity as jds
from repro.core import pipeline as jpl
from repro.core import rewards as jrw
from repro.core import trust as jtr
from repro_torch.core import channel as tch
from repro_torch.core import dissimilarity as tds
from repro_torch.core import pipeline as tpl
from repro_torch.core import rewards as trw
from repro_torch.core import trust as ttr

from test_torch_draws import t, trust_uniforms

N = 7


def test_make_trust_matches_reference():
    key = jax.random.PRNGKey(1)
    want = jtr.make_trust(key, N, 3, 0.6)
    got = ttr.make_trust(trust_uniforms(key, N, 3), 0.6)
    assert got.dtype == torch.int8
    for j in range(N):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want[j]))


def test_channel_matches_reference():
    kp, kf = jax.random.split(jax.random.PRNGKey(2))
    pos = jch.make_positions(kp, N)
    fade = jch.init_fading(kf, N)
    want_w = jch.rss_from_state(pos, fade)
    got_w = tch.rss_from_state(t(pos), t(fade))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    # P_D = 1 - exp(-x) cancels for small x: 1e-6 absolute
    np.testing.assert_allclose(tch.failure_prob(got_w).numpy(),
                               np.asarray(jch.failure_prob(want_w)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tch.path_loss(t(pos)).numpy(),
                               np.asarray(jch.path_loss(pos)), rtol=1e-6)


def test_channel_draws_in_range():
    g = torch.Generator().manual_seed(0)
    pos = tch.make_positions(g, 50)
    fade = tch.init_fading(g, 50)
    assert float(pos.min()) >= 0 and float(pos.max()) <= 1
    assert float(fade.min()) >= 0.75 and abs(float(fade.mean()) - 1.25) < 0.1


def _cents(seed, n=N, k=3, d=4):
    return np.random.default_rng(seed).normal(size=(n, k, d)).astype(
        np.float32)


@pytest.mark.parametrize("n", [N, 6])
def test_lambda_and_beta_match_reference(n):
    cents = _cents(n, n)
    trust = np.stack([np.asarray(m) for m in
                      jtr.make_trust(jax.random.PRNGKey(n), n, 3, 0.7)])
    beta_j = jds.median_heuristic_beta(jnp.asarray(cents), 0.8)
    beta_t = tds.median_heuristic_beta(torch.as_tensor(cents), 0.8)
    np.testing.assert_allclose(float(beta_t), float(beta_j), rtol=1e-6)
    want = jds.lambda_matrix(jnp.asarray(cents), jnp.asarray(trust), beta_j)
    got = tds.lambda_matrix(torch.as_tensor(cents), torch.as_tensor(trust),
                            beta_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["paper", "expected"])
def test_rewards_match_reference(kind):
    rng = np.random.default_rng(3)
    lam = rng.integers(0, 4, size=(N, N)).astype(np.int32)
    pf = rng.uniform(size=(N, N)).astype(np.float32)
    got = trw.local_reward_matrix(torch.as_tensor(lam), torch.as_tensor(pf),
                                  trw.RewardConfig(kind=kind))
    want = jrw.local_reward_matrix(jnp.asarray(lam), jnp.asarray(pf),
                                   jrw.RewardConfig(kind=kind))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_episode_rewards_match_reference():
    rng = np.random.default_rng(4)
    r = rng.normal(size=N).astype(np.float32)
    np.testing.assert_allclose(
        trw.global_rewards(torch.as_tensor(r), 0.45, 0.2).numpy(),
        np.asarray(jrw.global_rewards(jnp.asarray(r), 0.45, 0.2)), rtol=1e-6)
    acts = rng.integers(0, N, size=(N, 12)).astype(np.int32)
    loc = rng.normal(size=(N, 12)).astype(np.float32)
    np.testing.assert_allclose(
        trw.frequent_local_reward(torch.as_tensor(acts), torch.as_tensor(loc),
                                  N).numpy(),
        np.asarray(jrw.frequent_local_reward(jnp.asarray(acts),
                                             jnp.asarray(loc), N)),
        rtol=1e-6)


def test_link_rewards_match_reference():
    cents = _cents(9)
    trust = jtr.make_trust(jax.random.PRNGKey(9), N, 3, 0.8)
    pf = np.asarray(jch.failure_prob(jch.make_rss(jax.random.PRNGKey(5), N)))
    beta_j, lam_j, r_j = jpl.link_rewards(jnp.asarray(cents), trust,
                                          jnp.asarray(pf),
                                          jpl.PipelineConfig())
    beta_t, lam_t, r_t = tpl.link_rewards(
        torch.as_tensor(cents), torch.as_tensor(np.stack(trust)),
        torch.as_tensor(pf), tpl.PipelineConfig())
    np.testing.assert_allclose(float(beta_t), float(beta_j), rtol=1e-6)
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6)
