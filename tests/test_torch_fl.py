"""The port's FL trainer and linear evaluation against ``repro.fl``.

Both sides start from the same converted weights and the reference's
replayed minibatch indices. Tolerance: eval losses and global parameters
within 2e-4 relative + 2e-5 absolute after 2 rounds (float32 convolution
gradients summed in another order, compounded by 10 local steps; Adam
divides by the gradient's running RMS, which amplifies differences where
gradients are near zero)."""
import jax
import numpy as np
import pytest
import torch

from repro.fl import linear_eval as jle
from repro.fl import trainer as jtr
from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.fl import linear_eval as tle
from repro_torch.fl import trainer as ttr
from repro_torch.models import autoencoder as tae
from repro_torch.models.common import tree_leaves

from test_torch_draws import batch_indices, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JC = jae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
TC = tae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)


def _world(seed=0):
    rng = np.random.default_rng(seed)
    sizes = [12, 7, 15, 9]
    xs = [rng.uniform(size=(s, 8, 8, 1)).astype(np.float32) * (1 + i)
          / 4 for i, s in enumerate(sizes)]
    ev = rng.uniform(size=(10, 8, 8, 1)).astype(np.float32)
    return xs, sizes, ev


def _init(seed):
    return jax.device_get(jax.jit(lambda k: jae.init_ae(k, JC))(
        jax.random.PRNGKey(seed)))


def _run_both(stragglers=(), **kw):
    xs, sizes, ev = _world()
    key = jax.random.PRNGKey(5)
    jcfg = jtr.FLConfig(total_iters=20, tau_a=10, batch_size=6,
                        eval_every=10, **kw)
    tcfg = ttr.FLConfig(total_iters=20, tau_a=10, batch_size=6,
                        eval_every=10, **kw)
    init = _init(1)
    want = jtr.fl_train(key, xs, JC, jcfg, ev, stragglers=stragglers,
                        init_params=init)
    got = ttr.fl_train(xs, TC, tcfg, ev, stragglers=stragglers,
                       init_params=convert.ae_params(init),
                       batch_idx=batch_indices(key, sizes, jcfg),
                       device="cpu")
    return want, got


def _assert_close(want, got):
    np.testing.assert_array_equal(got.eval_iters, want.eval_iters)
    np.testing.assert_allclose(got.eval_loss, want.eval_loss, rtol=2e-4,
                               atol=2e-5)
    for a, b in zip(tree_leaves(got.global_params),
                    jax.tree.leaves(want.global_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    for a, b in zip(tree_leaves(got.client_params),
                    jax.tree.leaves(want.client_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("scheme", ["fedavg", "fedsgd", "fedprox"])
@pytest.mark.parametrize("local_opt", ["sgd", "adam"])
def test_fl_train_matches_reference(scheme, local_opt):
    _assert_close(*_run_both(scheme=scheme, local_opt=local_opt))


@pytest.mark.parametrize("scheme", ["fedavg", "fedsgd"])
def test_participation_floor_matches_reference(scheme):
    # 2 of 4 clients up, floor ceil(0.75 * 4) = 3: the round keeps the last
    # global model (fedavg) or local gradients (fedsgd)
    want, got = _run_both(stragglers=(1, 3), scheme=scheme,
                          min_participation=0.75)
    _assert_close(want, got)
    if scheme == "fedavg":
        for a in tree_leaves(got.global_params):
            assert torch.isfinite(a).all()


def test_segmented_resume_equals_one_run():
    xs, sizes, ev = _world(1)
    cfg = ttr.FLConfig(total_iters=30, tau_a=10, batch_size=5, eval_every=10)
    g = torch.Generator().manual_seed(0)
    init = tae.init_ae(g, TC)
    idx = ttr.draw_batch_indices(g, sizes, cfg, 3)
    whole = ttr.fl_train(xs, TC, cfg, ev, init_params=init, batch_idx=idx,
                         device="cpu")
    first = ttr.fl_train(xs, TC, cfg, ev, init_params=init, batch_idx=idx,
                         stop_iter=10, device="cpu")
    rest = ttr.fl_train(xs, TC, cfg, ev, init_carry=first.carry,
                        batch_idx=idx, start_iter=10, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([first.eval_loss, rest.eval_loss]), whole.eval_loss)
    with pytest.raises(ValueError):
        ttr.fl_train(xs, TC, cfg, ev, init_params=init, batch_idx=idx,
                     start_iter=5, device="cpu")


def test_linear_evaluation_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(60, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=60).astype(np.int32)
    x += y[:, None, None, None] * 0.05
    init = _init(3)
    want = jle.linear_evaluation(jax.random.PRNGKey(0), init, JC, x[:40],
                                 y[:40], x[40:], y[40:], iters=200)
    got = tle.linear_evaluation(convert.ae_params(init), TC,
                                torch.as_tensor(x[:40]),
                                torch.as_tensor(y[:40]),
                                torch.as_tensor(x[40:]),
                                torch.as_tensor(y[40:]), iters=200,
                                device="cpu")
    # accuracies are counts over 20 and 40 samples: at most one sample may
    # sit on the decision boundary
    assert abs(got[0] - want[0]) <= 1 / 20 + 1e-6
    assert abs(got[1] - want[1]) <= 1 / 40 + 1e-6


def test_fl_carry_converts():
    init = _init(4)
    stacked = jax.tree.map(lambda a: np.stack([a, a]), init)
    carry = convert.fl_carry((stacked, init, stacked, stacked,
                              np.float32(3.0)))
    assert float(carry.step) == 3.0
    assert tuple(carry.client_params["enc"]["conv1"].shape) == (2, 3, 3, 1, 4)
