"""The port's dynamics and fault plane against the reference, function by
function, on replayed draws: the channel steps, ``env_init``/``env_step``
for every preset (and a flash-crowd ramp that rounds half to even, and the
churn guard with every client offline), both fault injectors (and their
all-dead floor), the metrics functions, ``ExchangeResult.failed_links``, a
scripted ``RetryQueue`` sequence and the scenario registry.

Tolerances: positions, fading and P_D within 1e-6 absolute plus 1e-6
relative (exp/log of float32 in two libraries, up to a few ulp on fading
values of a few units); RSS within 4e-6 relative (its values span four
decades, and the path loss d^-2.5 multiplies a distance's relative error by
2.5); mean P_D and expected delivery within 1e-6 absolute; masks, graphs,
counts and queues exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import exchange as jex
from repro.dynamics import environment as jenv
from repro.dynamics import metrics as jmet
from repro.dynamics import scenarios as jscn
from repro.faults import inject as jinj
from repro.faults import plan as jplan
from repro.faults import retry as jretry
from repro.models import autoencoder as jae
from repro_torch.core import channel as tch
from repro_torch.core import exchange as tex
from repro_torch.dynamics import environment as tenv
from repro_torch.dynamics import metrics as tmet
from repro_torch.dynamics import scenarios as tscn
from repro_torch.faults import inject as tinj
from repro_torch.faults import plan as tplan
from repro_torch.faults import retry as tretry
from repro_torch.models.autoencoder import AEConfig as TAE

from test_torch_draws import (JaxReplayDraws, exchange_draws,
                              one_torch_thread, t)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEY = jax.random.PRNGKey(11)
CH = tch.ChannelConfig()
JCH = jch.ChannelConfig()


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# channel steps
# ---------------------------------------------------------------------------

def test_positions_step_reflects_like_the_reference():
    k0, k1 = jax.random.split(KEY)
    pos = jax.random.uniform(k0, (50, 2))
    # a large step sends walkers past both walls
    want = jax.jit(jch.positions_step, static_argnums=(2, 3))(k1, pos, 0.4,
                                                               JCH)
    got = tch.positions_step(t(pos), t(jax.random.normal(k1, (50, 2))), 0.4,
                             CH)
    _close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= CH.area


@pytest.mark.parametrize("rho,sigma", [(0.7, 0.6), (0.9, 0.3), (1.0, 0.5),
                                       (1.2, 0.5)])
def test_fading_step_matches(rho, sigma):
    k0, k1 = jax.random.split(KEY)
    fade = jax.random.exponential(k0, (20, 20)) * 0.5 + 0.75
    want = jax.jit(jch.fading_step, static_argnums=(2, 3))(k1, fade, rho,
                                                           sigma)
    got = tch.fading_step(t(fade), t(jax.random.normal(k1, (20, 20))), rho,
                          sigma)
    _close(got, want)


def test_degrade_links_per_link_and_per_transmitter():
    k0, k1, k2 = jax.random.split(KEY, 3)
    pf = jax.random.uniform(k0, (7, 7))
    for mask in (jax.random.uniform(k1, (7, 7)) < 0.5,
                 jax.random.uniform(k2, (7,)) < 0.5):
        want = jch.degrade_links(pf, mask, 0.9)
        got = tch.degrade_links(t(pf), t(mask), 0.9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a per-transmitter mask hits whole columns
    col = torch.tensor([False, True] + [False] * 5)
    got = tch.degrade_links(torch.zeros(7, 7), col, 0.5)
    assert (got[:, 1] == 0.5).all() and (got[:, 0] == 0).all()


def test_make_rss_is_positions_then_fading(monkeypatch):
    """make_rss and rss_from_positions against the reference's, with the
    port's draw helpers replaying JAX's: make_rss splits its key into the
    positions' and the fading's, rss_from_positions draws the fading from
    its key. RSS within 4e-6 relative; the diagonal is inf in both."""
    n = 9
    kp, kf = jax.random.split(KEY)
    pos, fade = t(jch.make_positions(kp, n, JCH)), t(jch.init_fading(kf, n))
    monkeypatch.setattr(tch, "make_positions", lambda g, m, cfg: pos)
    monkeypatch.setattr(tch, "init_fading", lambda g, m: fade)
    g = torch.Generator()
    for got, want in ((tch.make_rss(g, n, CH), jch.make_rss(KEY, n, JCH)),
                      (tch.rss_from_positions(g, pos, CH),
                       jch.rss_from_positions(kf, jnp.asarray(pos.numpy()),
                                              JCH))):
        assert torch.isinf(torch.diagonal(got)).all()
        _close(got, want, rtol=4e-6, atol=0)


# ---------------------------------------------------------------------------
# the environment process
# ---------------------------------------------------------------------------

EXTRA = {
    # 0.625 * 4 = 2.5 rounds to 2 (half to even), not 3
    "flash-half": dict(flash_crowd=True, flash_initial_frac=0.625,
                       flash_ramp_segments=4),
    # every uniform falls below 1: the guard keeps the argmax client
    "all-offline": dict(churn_prob=1.0),
}
CASES = [(name, 6) for name in tscn.available_scenarios()] + \
    [(name, 4) for name in EXTRA]


def _scenarios(name):
    if name in EXTRA:
        return (jscn.ScenarioConfig(name, **EXTRA[name]),
                tscn.ScenarioConfig(name, **EXTRA[name]))
    return jscn.get_scenario(name), tscn.get_scenario(name)


@pytest.mark.parametrize("name,n", CASES)
def test_env_init_and_steps_match(name, n):
    jscn_, tscn_ = _scenarios(name)
    draws = JaxReplayDraws(KEY)
    k_ch = jax.random.split(KEY)[0]
    kp, kf = jax.random.split(k_ch)
    want = jax.jit(jenv.env_init, static_argnums=(1, 2, 3))(k_ch, n, JCH,
                                                           jscn_)
    got = tenv.env_init(t(jch.make_positions(kp, n, JCH)),
                        t(jch.init_fading(kf, n)), CH, tscn_)
    step = jax.jit(jenv.env_step, static_argnums=(2, 3))
    avail_seen = []
    for s in range(5):
        if s:
            want = step(jax.random.fold_in(draws.k_env, s), want, jscn_, JCH)
            got = tenv.env_step(got, draws.env(s, n), tscn_, CH)
        _close(got.positions, want.positions)
        _close(got.fading, want.fading)
        _close(got.rss, want.rss, rtol=4e-6, atol=0.0)
        _close(tch.failure_prob(got.rss, CH),
               jch.failure_prob(want.rss, JCH))
        np.testing.assert_array_equal(got.available.numpy(),
                                      np.asarray(want.available))
        assert int(got.t) == int(want.t) == s
        avail_seen.append(int(got.available.sum()))
    if name == "flash-half":
        assert avail_seen == [2, 3, 3, 4, 4]
    if name == "all-offline":
        assert avail_seen[1:] == [1] * 4
    assert tenv.stragglers_from(got.available) == \
        jenv.stragglers_from(want.available)


# ---------------------------------------------------------------------------
# fault injectors
# ---------------------------------------------------------------------------

PLANS = {
    **{name: (jscn.get_scenario(name).faults, tscn.get_scenario(name).faults)
       for name in ("burst-outage", "regional-failure", "preempt-resume")},
    "all-dead": (
        jplan.FaultPlan(crashes=(jplan.CrashPulse(1, 2, frac=1.0),),
                        regions=(jplan.RegionalOutage(3, 1, radius=2.0),)),
        tplan.FaultPlan(crashes=(tplan.CrashPulse(1, 2, frac=1.0),),
                        regions=(tplan.RegionalOutage(3, 1, radius=2.0),))),
    "two-events": (
        jplan.FaultPlan(
            crashes=(jplan.CrashPulse(1, 1, 0.5), jplan.CrashPulse(2, 2, 0.3)),
            link_bursts=(jplan.LinkBurst(1, 2, 0.6, 0.97),
                         jplan.LinkBurst(2, 1, 0.3, 0.5))),
        tplan.FaultPlan(
            crashes=(tplan.CrashPulse(1, 1, 0.5), tplan.CrashPulse(2, 2, 0.3)),
            link_bursts=(tplan.LinkBurst(1, 2, 0.6, 0.97),
                         tplan.LinkBurst(2, 1, 0.3, 0.5)))),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_injectors_match(name):
    jp, tp = PLANS[name]
    n = 12
    draws = JaxReplayDraws(KEY)
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(3), 3)
    pos = jax.random.uniform(k0, (n, 2))
    avail = jax.random.uniform(k1, (n,)) < 0.8
    pf = jch.failure_prob(jax.random.uniform(k2, (n, n)) * 0.5 + 0.01, JCH)
    j_av = jax.jit(jinj.apply_availability, static_argnums=(1, 2))
    j_pf = jax.jit(jinj.apply_pfail, static_argnums=(1, 2))
    floors = 0
    for s in range(5):
        want = j_av(draws.k_fault, jp, s, pos, avail)
        got = tinj.apply_availability(
            tp, s, t(pos), t(avail), [draws.crash(c.start, n)
                                      for c in tp.crashes])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(got.any())
        floors += int(got.sum() == 1 and bool(got[0]))
        want = j_pf(draws.k_fault, jp, s, pf)
        got = tinj.apply_pfail(tp, s, t(pf), [draws.burst(b.start, n)
                                              for b in tp.link_bursts])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tp.active(s) == jp.active(s)
    if name == "all-dead":
        assert floors == 3     # segments 1, 2 (crash) and 3 (region)


def test_injectors_refuse_missing_uniforms():
    tp = PLANS["all-dead"][1]
    n = 4
    pos, avail = torch.zeros(n, 2), torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="crash_u: 0 uniform draws for 1"):
        tinj.apply_availability(tp, 1, pos, avail, [])
    plan = tplan.FaultPlan(link_bursts=(
        tplan.LinkBurst(start=0, duration=1, frac=1.0, p_fail=0.9),))
    with pytest.raises(ValueError, match="burst_u: 2 uniform draws for 1"):
        tinj.apply_pfail(plan, 0, torch.zeros(n, n), [torch.zeros(n, n)] * 2)


def test_preempted_carries_segment_and_checkpoint():
    e = tplan.Preempted(2, "/ckpt.npz")
    assert (e.segment, e.checkpoint) == (2, "/ckpt.npz")
    assert str(e) == str(jplan.Preempted(2, "/ckpt.npz"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

EDGES = [np.array([3, 0, 1, 2, 5, 4]), np.array([0, 0, 2, 2, 5, 5]),
         np.arange(6)]


@pytest.mark.parametrize("edge", EDGES, ids=["live", "some-self", "all-self"])
def test_metrics_functions_match(edge):
    k0, k1 = jax.random.split(KEY)
    pf = jch.failure_prob(jax.random.uniform(k0, (6, 6)) * 0.3 + 0.01, JCH)
    fail = jax.random.uniform(k1, (6,)) < 0.5
    prev = np.array([1, 0, 1, 0, 5, 4])
    je, te = jnp.asarray(edge), torch.as_tensor(edge)
    assert tmet.link_churn(prev, te) == jmet.link_churn(prev, je)
    assert tmet.link_churn(None, te) == 0.0
    assert float(tmet.link_churn_dev(torch.as_tensor(prev), te)) == \
        float(jmet.link_churn_dev(prev, je))
    assert float(tmet.link_churn_dev(None, te)) == 0.0
    got = tmet.delivery_stats_dev(te, t(pf))
    want = jmet.delivery_stats_dev(je, pf)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        float(tmet.realized_delivery_dev(te, t(fail))),
        float(jmet.realized_delivery_dev(je, fail)))
    decisions = [(i, int(edge[i]), -1 if bool(fail[i]) else 0, True)
                 for i in range(6) if edge[i] != i]
    host_t = tmet.delivery_stats(te, t(pf), decisions)
    host_j = jmet.delivery_stats(je, pf, decisions)
    np.testing.assert_allclose(host_t[:2], host_j[:2], rtol=0, atol=1e-6)
    assert host_t[2] == host_j[2]
    assert tmet.realized_delivery(te, None) is None


def test_trace_summary_matches():
    rng = np.random.default_rng(0)
    recs = []
    for s in range(4):
        kw = dict(segment=s, eval_loss=float(rng.uniform()),
                  in_edge=rng.integers(0, 6, 6),
                  link_churn=float(rng.uniform()) if s else 0.0,
                  mean_pfail=float(rng.uniform()),
                  expected_delivery=float(rng.uniform()),
                  realized_delivery=None if s == 2 else float(rng.uniform()),
                  n_available=int(rng.integers(1, 7)),
                  moved=int(rng.integers(0, 50)), rediscovered=s != 3,
                  eval_iters=np.array([10 * (s + 1)]),
                  eval_curve=rng.uniform(size=1), n_live=5, n_failed=s % 2,
                  retried=s // 2, retry_delivered=s // 3)
        recs.append(kw)
    jt, tt = jmet.Trace(), tmet.Trace()
    for kw in recs:
        jt.add(jmet.SegmentRecord(**kw))
        tt.add(tmet.SegmentRecord(**kw))
    assert tt.summary() == jt.summary()
    np.testing.assert_array_equal(tt.eval_curve, jt.eval_curve)
    np.testing.assert_array_equal(tt.eval_curve_iters, jt.eval_curve_iters)
    np.testing.assert_array_equal(tt.eval_losses, jt.eval_losses)


# ---------------------------------------------------------------------------
# failed_links: live links only
# ---------------------------------------------------------------------------

def test_failed_links_lists_only_live_links():
    from repro_torch.core.batching import client_data_from_lists
    rng = np.random.default_rng(1)
    n = 6
    xs = [rng.uniform(size=(10 + i, 8, 8, 1)).astype(np.float32)
          for i in range(n)]
    assigns = rng.integers(0, 3, (n, 15)).astype(np.int32)
    trust = [np.ones((n, 3), np.int8) for _ in range(n)]
    in_edge = np.array([1, 1, 3, 2, 4, 0])         # 1 and 4 are self-links
    pf = np.full((n, n), 0.6, np.float32)
    np.fill_diagonal(pf, 1.0)
    cfg = dict(reserve_per_cluster=4, apply_channel_failure=True)
    key = jax.random.PRNGKey(2)
    jc = jae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    want = jex.run_exchange(key, xs, [np.zeros(len(x), np.int32) for x in xs],
                            assigns, trust, jnp.asarray(in_edge),
                            jnp.asarray(pf), jc, jex.ExchangeConfig(**cfg))
    got = tex.run_exchange(
        client_data_from_lists(xs), None, torch.as_tensor(assigns),
        torch.as_tensor(np.stack(trust)), torch.as_tensor(in_edge),
        torch.as_tensor(pf), TAE(8, 8, 1, widths=(4, 8), latent_dim=8),
        tex.ExchangeConfig(**cfg), draws=exchange_draws(key, n, jc),
        device="cpu")
    # P_D(i, i) = 1: both self-links "fail" on the channel ...
    assert bool(got.fail[1]) and bool(got.fail[4])
    # ... and neither reaches the retry queue
    links = got.failed_links()
    assert links == want.failed_links()
    assert all(rx != tx for rx, tx in links)
    assert {rx for rx, _ in links} == \
        {i for i in range(n) if bool(got.fail[i]) and in_edge[i] != i}


# ---------------------------------------------------------------------------
# retry queue and registry: host code, compared exactly
# ---------------------------------------------------------------------------

def test_retry_queue_scripted_sequence():
    kw = dict(enabled=True, max_attempts=3, backoff_base=1, backoff_factor=2)
    jpol, tpol = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    jq, tq = jretry.RetryQueue(), tretry.RetryQueue()
    script = [("offer", 0, [(1, 2), (3, 4), (1, 2)]),
              ("offer", 1, [(1, 5), (3, 4), (0, 2)]),
              ("take", 1, [True, False, False]),
              ("take", 2, [False]),
              ("offer", 2, [(2, 0)]),
              ("take", 3, [False, True, False]),
              ("take", 5, [False, False]),
              ("take", 8, [False, False, False]),
              ("take", 20, [])]
    for op, s, arg in script:
        if op == "offer":
            assert tq.offer(s, arg, tpol) == jq.offer(s, arg, jpol)
        else:
            jd, td = jq.take_due(s), tq.take_due(s)
            assert [(e.rx, e.tx, e.attempts, e.due) for e in td] == \
                [(e.rx, e.tx, e.attempts, e.due) for e in jd]
            for je, te, ok in zip(jd, td, arg):
                assert tq.resolve(s, te, ok, tpol) == \
                    jq.resolve(s, je, ok, jpol)
        np.testing.assert_array_equal(tq.to_array(), jq.to_array())
        assert len(tq) == len(jq) and tq.links == jq.links
    back = tretry.RetryQueue.from_array(jq.to_array())
    np.testing.assert_array_equal(back.to_array(), jq.to_array())
    assert tretry.RetryQueue().offer(0, [(1, 2)], tretry.RetryPolicy()) == 0
    with pytest.raises(ValueError, match=r"\(M, 4\)"):
        tretry.RetryQueue.from_array(np.zeros((2, 3), np.int32))


def test_scenario_registry_matches():
    assert tscn.available_scenarios() == jscn.available_scenarios()
    assert len(tscn.available_scenarios()) == 8
    for name in tscn.available_scenarios():
        a, b = tscn.get_scenario(name), jscn.get_scenario(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.channel_is_static == b.channel_is_static
        assert tscn.get_scenario(a) is a
    with pytest.raises(KeyError, match="unknown scenario"):
        tscn.get_scenario("nope")
    extra = tscn.register_scenario(tscn.ScenarioConfig("test-extra",
                                                       churn_prob=0.5))
    assert tscn.get_scenario("test-extra") is extra
    tscn._REGISTRY.pop("test-extra")
