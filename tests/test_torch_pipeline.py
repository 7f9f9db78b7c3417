"""The whole first slice against the reference: ``run_pipeline`` (UCB
discovery) + ``fl_train`` + ``linear_evaluation`` at a small size, with the
reference's draws replayed and its weights converted, compared stage by
stage.

Tolerances: centroids 1e-4 after aligning each PCA axis's sign; P_D 1e-6
absolute;
Q-table 1e-5; FL eval losses 2e-4 relative (see test_torch_fl); integer
outputs (trust, lambda, in_edge, moved counts) and the exchanged data
exact; accuracy within one sample."""
import jax
import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.core import pipeline as jpl
from repro.core import qlearning as jql
from repro.data.partition import partition_by_classes
from repro.data.synthetic import make_split_dataset
from repro.fl import FLConfig as JFL
from repro.fl import fl_train as j_fl_train
from repro.fl import linear_evaluation as j_linear_eval
from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.core import exchange as tex
from repro_torch.core import pipeline as tpl
from repro_torch.core import qlearning as tql
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import fl_train as t_fl_train
from repro_torch.fl import linear_evaluation as t_linear_eval
from repro_torch.models.autoencoder import AEConfig as TAE

from test_torch_draws import (batch_indices, one_torch_thread,  # noqa: F401
                              pipeline_draws)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JC = jae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
TC = TAE(8, 8, 1, widths=(4, 8), latent_dim=8)


def _configs():
    kw = dict(n_pca=4, kmeans_iters=5)
    rl = dict(n_episodes=30, buffer_size=10, policy="ucb")
    return (jpl.PipelineConfig(rl=jql.RLConfig(**rl),
                               exchange=jex.ExchangeConfig(
                                   reserve_per_cluster=8), **kw),
            tpl.PipelineConfig(rl=tql.RLConfig(**rl),
                               exchange=tex.ExchangeConfig(
                                   reserve_per_cluster=8), **kw))


@pytest.fixture(scope="module")
def runs():
    key = jax.random.PRNGKey(0)
    tr, ev = make_split_dataset(key, n_train_per_class=30,
                                n_eval_per_class=6, height=8, width=8,
                                channels=1)
    xs, ys, _ = partition_by_classes(0, np.asarray(tr.images),
                                     np.asarray(tr.labels), n_clients=6,
                                     classes_per_client=3, circular=True)
    ev_x, ev_y = np.asarray(ev.images), np.asarray(ev.labels)
    jcfg, tcfg = _configs()
    jres = jpl.run_pipeline(key, xs, ys, JC, jcfg)
    draws = pipeline_draws(key, jcfg, JC, [x.shape[0] for x in xs],
                           np.asarray(jres.client_data.sizes))
    tres = tpl.run_pipeline(xs, ys, TC, tcfg, draws=draws, device="cpu")

    fl_key = jax.random.PRNGKey(5)
    jfl_cfg = JFL(total_iters=20, tau_a=10, eval_every=10, batch_size=8)
    tfl_cfg = TFL(total_iters=20, tau_a=10, eval_every=10, batch_size=8)
    init = jax.device_get(jax.jit(lambda k: jae.init_ae(k, JC))(fl_key))
    jfl = j_fl_train(fl_key, jres.client_data, JC, jfl_cfg, ev_x,
                     init_params=init)
    tfl = t_fl_train(tres.client_data, TC, tfl_cfg, ev_x,
                     init_params=convert.ae_params(init),
                     batch_idx=batch_indices(
                         fl_key, np.asarray(jres.client_data.sizes), jfl_cfg),
                     device="cpu")
    jacc = j_linear_eval(key, jfl.global_params, JC, ev_x[:30], ev_y[:30],
                         ev_x[30:], ev_y[30:], iters=300)
    tacc = t_linear_eval(tfl.global_params, TC, torch.as_tensor(ev_x[:30]),
                         torch.as_tensor(ev_y[:30]),
                         torch.as_tensor(ev_x[30:]),
                         torch.as_tensor(ev_y[30:]), iters=300,
                         device="cpu")
    return dict(jres=jres, tres=tres, jfl=jfl, tfl=tfl, jacc=jacc,
                tacc=tacc, xs=xs, ys=ys, tcfg=tcfg)


def test_slice_centroids(runs):
    j, t = np.asarray(runs["jres"].centroids), runs["tres"].centroids.numpy()
    sign = np.sign((j * t).sum(axis=(0, 1)))
    np.testing.assert_allclose(t * sign, j, atol=1e-4)


def test_slice_trust_and_channel(runs):
    for a, b in zip(runs["jres"].trust, runs["tres"].trust):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # P_D = 1 - exp(-x) cancels for small x: 1e-6 absolute
    np.testing.assert_allclose(runs["tres"].p_fail.numpy(),
                               np.asarray(runs["jres"].p_fail), rtol=1e-6,
                               atol=1e-6)


def test_slice_lambda_before_and_after(runs):
    np.testing.assert_array_equal(runs["tres"].lam_before.numpy(),
                                  np.asarray(runs["jres"].lam_before))
    np.testing.assert_array_equal(runs["tres"].lam_after.numpy(),
                                  np.asarray(runs["jres"].lam_after))
    assert float(np.asarray(runs["jres"].lam_after).mean()) < \
        float(np.asarray(runs["jres"].lam_before).mean())


def test_slice_in_edge_exact_under_ucb(runs):
    np.testing.assert_array_equal(runs["tres"].in_edge.numpy(),
                                  np.asarray(runs["jres"].in_edge))
    np.testing.assert_allclose(runs["tres"].graph.q.numpy(),
                               np.asarray(runs["jres"].graph.q), rtol=1e-5,
                               atol=1e-5)


def test_slice_exchange(runs):
    np.testing.assert_array_equal(runs["tres"].moved_counts,
                                  runs["jres"].moved_counts)
    assert runs["tres"].moved_counts.sum() > 0
    for a, b in zip(runs["tres"].datasets, runs["jres"].datasets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert runs["tres"].exchange.gate_decisions == \
        runs["jres"].exchange.gate_decisions


def test_slice_fl_eval_losses(runs):
    np.testing.assert_array_equal(runs["tfl"].eval_iters,
                                  runs["jfl"].eval_iters)
    np.testing.assert_allclose(runs["tfl"].eval_loss, runs["jfl"].eval_loss,
                               rtol=2e-4)


def test_slice_linear_eval_accuracy(runs):
    assert abs(runs["tacc"][0] - runs["jacc"][0]) <= 1 / 30 + 1e-6
    assert abs(runs["tacc"][1] - runs["jacc"][1]) <= 1 / 30 + 1e-6


def test_slice_records_its_draws_and_stages(runs):
    tres = runs["tres"]
    assert set(tres.stage_seconds) == {"cluster", "trust_channel",
                                       "discover", "exchange",
                                       "cluster_after"}
    again = tpl.run_pipeline(runs["xs"], runs["ys"], TC, runs["tcfg"],
                             draws=tres.draws, device="cpu")
    assert torch.equal(again.in_edge, tres.in_edge)
    assert torch.equal(again.client_data.data, tres.client_data.data)


def test_generator_path_runs_and_is_seeded(runs):
    a = tpl.run_pipeline(runs["xs"], runs["ys"], TC, runs["tcfg"],
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
    b = tpl.run_pipeline(runs["xs"], runs["ys"], TC, runs["tcfg"],
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
    assert torch.equal(a.lam_after, b.lam_after)
    assert (a.in_edge != torch.arange(6)).all()
