"""``repro_torch.examples.quickstart`` on the CPU at toy sizes (12 training
and 4 eval images a class, 20 RL episodes, 20 FL iterations, 20 linear-
evaluation steps): the fields ``main`` returns and prints, the reference's
label domains, and its pipeline result equal, bit for bit, to
``run_pipeline`` called directly with a generator of the same seed after
the same world draws (same draws, same device: exact).
"""
import re

import numpy as np
import pytest
import torch

from repro.data import partition_by_classes as jpartition
from repro_torch.core.pipeline import PipelineConfig, run_pipeline
from repro_torch.core.qlearning import RLConfig
from repro_torch.data import fmnist_like_split, partition_by_classes
from repro_torch.examples import quickstart as qs
from repro_torch.models.autoencoder import AEConfig
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOY = dict(n_train_per_class=12, n_eval_per_class=4, n_episodes=20,
           total_iters=20, eval_every=10, linear_iters=20)


@pytest.fixture(scope="module")
def run():
    return qs.main(["--device", "cpu", "--seed", "3"], **TOY)


def test_main_returns_what_it_prints(run, capsys):
    qs.main(["--device", "cpu", "--seed", "3"], **TOY)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("== building non-i.i.d. federated world")
    assert out[1] == f"   client label domains: {run['domains']}"
    assert f"{list(enumerate(run['in_edge']))}" in out[3]
    assert f"before={run['lam_before']:.3f} after={run['lam_after']:.3f}" \
        in out[4]
    assert f"P_D={run['pd_chosen']:.4f} vs all-links mean=" \
        f"{run['pd_all']:.4f}" in out[5]
    assert re.fullmatch(r"   datapoints received per client: \[[\d ]+\]",
                        out[6])
    evals = [line for line in out if line.startswith("   iter")]
    assert evals == [f"   iter {it:4d}  non-iid={lb:.5f}  smart-D2D="
                     f"{ls:.5f}" for it, lb, ls in run["eval"]]
    assert out[-2] == (f"== linear evaluation: non-iid="
                       f"{run['acc_non_iid']:.3f}  smart-D2D="
                       f"{run['acc_smart']:.3f}")
    assert out[-1] == "done."


def test_fields(run):
    n = 8
    assert run["domains"] == [[(i - 1) % 10, i, (i + 1) % 10]
                              for i in range(n)]
    ie = run["in_edge"]
    assert len(ie) == n and all(0 <= t < n and t != r
                                for r, t in enumerate(ie))
    assert len(run["moved"]) == n and all(m >= 0 for m in run["moved"])
    assert [r[0] for r in run["eval"]] == [10, 20]
    assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in run["eval"])
    assert 0.0 <= run["pd_chosen"] <= 1.0 and 0.0 <= run["pd_all"] <= 1.0
    assert 0.0 <= run["acc_non_iid"] <= 1.0
    assert 0.0 <= run["acc_smart"] <= 1.0
    res = run["pipeline"]
    sizes = res.client_data.sizes.tolist()
    assert sizes == [15 + m for m in run["moved"]]   # 120 images / 8 clients


def test_pipeline_equals_run_pipeline_with_the_same_generator(run):
    gen = torch.Generator().manual_seed(3)
    ds, _ = fmnist_like_split(gen, n_train_per_class=12, n_eval_per_class=4)
    images, labels = ds.images.numpy(), ds.labels.numpy()
    xs, ys, domains = partition_by_classes(3, images, labels, n_clients=8,
                                           classes_per_client=3,
                                           circular=True)
    # the reference's partitioner gives the same clients from the seed
    jxs, _, jdomains = jpartition(3, images, labels, n_clients=8,
                                  classes_per_client=3, circular=True)
    assert domains == jdomains == run["domains"]
    assert all(np.array_equal(a, b) for a, b in zip(xs, jxs))
    ae_cfg = AEConfig(28, 28, 1, widths=(8, 16), latent_dim=32)
    cfg = PipelineConfig(rl=RLConfig(n_episodes=20, buffer_size=50))
    want = run_pipeline(xs, ys, ae_cfg, cfg, generator=gen, device="cpu")
    got = run["pipeline"]
    for name in ("in_edge", "lam_before", "lam_after", "p_fail",
                 "centroids", "centroids_after"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.moved_counts, want.moved_counts)
    assert torch.equal(got.client_data.data, want.client_data.data)
    assert torch.equal(got.client_data.sizes, want.client_data.sizes)
