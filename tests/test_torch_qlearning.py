"""The port's Q-learning graph discovery against ``repro.core.qlearning``.

UCB draws nothing and is the exact anchor: actions, counts and ``in_edge``
must be equal and the Q-table equal to 1e-5 (float32 sums of episode means
taken in another order). The mixed policy runs on the reference's replayed
uniforms and Gumbel noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import qlearning as jql
from repro.core import rewards as jrw
from repro_torch import convert
from repro_torch.core import qlearning as tql

from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_draws import rl_draws

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 6


def _world(seed):
    rng = np.random.default_rng(seed)
    lam = rng.integers(0, 4, size=(N, N)).astype(np.int32)
    np.fill_diagonal(lam, 0)
    pf = np.asarray(jch.failure_prob(jch.make_rss(jax.random.PRNGKey(seed),
                                                  N)))
    local_r = np.asarray(jrw.local_reward_matrix(jnp.asarray(lam),
                                                 jnp.asarray(pf)))
    return local_r, pf


@pytest.mark.parametrize("policy,episodes,buffer", [
    ("ucb", 40, 10), ("mixed", 40, 10), ("mixed", 33, 8)])
def test_discover_matches_reference(policy, episodes, buffer):
    local_r, pf = _world(episodes + buffer)
    key = jax.random.PRNGKey(episodes)
    jcfg = jql.RLConfig(n_episodes=episodes, buffer_size=buffer,
                        policy=policy)
    tcfg = tql.RLConfig(n_episodes=episodes, buffer_size=buffer,
                        policy=policy)
    want = jql.discover_graph(key, jnp.asarray(local_r), jnp.asarray(pf),
                              jcfg)
    draws = None if policy == "ucb" else rl_draws(key, N, episodes)
    got = tql.discover_graph(torch.as_tensor(local_r), torch.as_tensor(pf),
                             tcfg, draws=draws)
    np.testing.assert_array_equal(got.in_edge.numpy(),
                                  np.asarray(want.in_edge))
    np.testing.assert_array_equal(got.state.counts.numpy(),
                                  np.asarray(want.state.counts))
    np.testing.assert_array_equal(got.state.buf_actions.numpy(),
                                  np.asarray(want.state.buf_actions))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.ep_mean_local.numpy(),
                               np.asarray(want.ep_mean_local), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.ep_mean_pfail.numpy(),
                               np.asarray(want.ep_mean_pfail), rtol=1e-5)
    assert int(got.state.t) == int(want.state.t)


def test_warm_start_from_converted_state():
    local_r, pf = _world(3)
    key = jax.random.PRNGKey(3)
    cfg_j = jql.RLConfig(n_episodes=12, buffer_size=5, policy="ucb")
    cfg_t = tql.RLConfig(n_episodes=12, buffer_size=5, policy="ucb")
    first = jql.discover_graph(key, jnp.asarray(local_r), jnp.asarray(pf),
                               cfg_j)
    want = jql.discover_graph(key, jnp.asarray(local_r), jnp.asarray(pf),
                              cfg_j, init_state=first.state, n_episodes=7)
    got = tql.discover_graph(torch.as_tensor(local_r), torch.as_tensor(pf),
                             cfg_t, n_episodes=7,
                             init_state=convert.rl_state(
                                 jax.device_get(first.state)))
    np.testing.assert_array_equal(got.in_edge.numpy(),
                                  np.asarray(want.in_edge))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=1e-5)


def test_policy_pieces_match_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(N, N)).astype(np.float32)
    u = rng.uniform(size=(N, N)).astype(np.float32)
    np.testing.assert_allclose(
        tql.policy_probs(torch.as_tensor(q), 0.45, torch.as_tensor(u)).numpy(),
        np.asarray(jql.policy_probs(jnp.asarray(q), 0.45, jnp.asarray(u))),
        rtol=1e-5)
    counts = rng.integers(0, 3, size=(N, N)).astype(np.float32)
    np.testing.assert_array_equal(
        tql.ucb_actions(torch.as_tensor(q), torch.as_tensor(counts), 4,
                        1.5).numpy(),
        np.asarray(jql.ucb_actions(jnp.asarray(q), jnp.asarray(counts),
                                   jnp.asarray(4), 1.5)))
    acts = rng.integers(0, N, size=(N, 9)).astype(np.int32)
    rew = rng.normal(size=(N, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tql._q_update(torch.as_tensor(q), torch.as_tensor(acts),
                      torch.as_tensor(rew)).numpy(),
        np.asarray(jql._q_update(jnp.asarray(q), jnp.asarray(acts),
                                 jnp.asarray(rew))), rtol=1e-5)


def test_mixed_policy_needs_draws_and_generator_path_runs():
    local_r, pf = _world(5)
    cfg = tql.RLConfig(n_episodes=10, buffer_size=5)
    with pytest.raises(ValueError):
        tql.discover_graph(torch.as_tensor(local_r), torch.as_tensor(pf), cfg)
    g = torch.Generator().manual_seed(0)
    res = tql.discover_graph(torch.as_tensor(local_r), torch.as_tensor(pf),
                             cfg, generator=g)
    assert (res.in_edge != torch.arange(N)).all()
    base = tql.uniform_graph(g, N)
    assert (base != torch.arange(N)).all() and base.max() < N
