"""Small helpers of the reference the benches call, and the FL round body's
device-side participation floor.

* ``trust.full_trust``, ``rewards.network_performance``: exactly /
  within 1e-6 of the reference.
* ``synthetic.fmnist_like``, ``cifar_like`` and ``cifar_like_split``: the
  reference's shapes, dtypes and value range (the two generators upsample
  their noise with different bicubic kernels, so only the kind matches).
* ``trainer._round_body`` with ``min_participation > 0`` selects on the
  device (no host read) and is bit-identical to the round body that read
  the floor test back to the host, above and below the floor, for every
  scheme.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rewards as jrw
from repro.core import trust as jtr
from repro.data import synthetic as jsyn
from repro_torch.core import rewards as trw
from repro_torch.core import trust as ttr
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import trainer as ttrainer
from repro_torch.models import autoencoder as ae
from repro_torch.models.autoencoder import AEConfig
from repro_torch.models.common import tree_leaves, tree_map, value_and_grad

from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n_clusters", [3, [2, 3, 1, 4]])
def test_full_trust_matches_reference(n_clusters):
    want = jtr.full_trust(4, n_clusters)
    got = ttr.full_trust(4, n_clusters, device="cpu")
    if isinstance(n_clusters, int):
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
    else:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.dtype == torch.int8


def test_network_performance_matches_reference():
    rng = np.random.default_rng(0)
    acts = rng.integers(0, 5, size=(5, 12)).astype(np.int32)
    rew = rng.normal(size=(5, 12)).astype(np.float32)
    want = jrw.network_performance(jnp.asarray(acts), jnp.asarray(rew), 5)
    got = trw.network_performance(torch.as_tensor(acts),
                                  torch.as_tensor(rew), 5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,shape", [("fmnist_like", (28, 28, 1)),
                                        ("cifar_like", (32, 32, 3))])
def test_synthetic_datasets_match_reference_shapes(name, shape):
    want = jax.jit(getattr(jsyn, name), static_argnums=1)(
        jax.random.PRNGKey(0), 3)
    got = getattr(tsyn, name)(torch.Generator().manual_seed(0), 3)
    assert tuple(got.images.shape) == want.images.shape == (30,) + shape
    assert tuple(got.labels.shape) == want.labels.shape == (30,)
    assert got.images.dtype == torch.float32
    assert float(got.images.min()) > 0.0 and float(got.images.max()) < 1.0
    assert sorted(torch.bincount(got.labels).tolist()) == [3] * 10


def test_cifar_like_split_matches_reference_shapes():
    jt, je = jax.jit(jsyn.cifar_like_split, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), 4, 2)
    tt, te = tsyn.cifar_like_split(torch.Generator().manual_seed(1), 4, 2)
    assert tuple(tt.images.shape) == jt.images.shape == (40, 32, 32, 3)
    assert tuple(te.images.shape) == je.images.shape == (20, 32, 32, 3)
    assert torch.bincount(tt.labels, minlength=10).sum() == 40


# ---------------------------------------------------------------------------
# the participation floor as a device select
# ---------------------------------------------------------------------------

def _round_body_host_floor(cfg, ae_cfg, carry, data, agg_mask, batch_idx):
    """The round body as it was: the floor test read back to the host."""
    cp, gp, mu, nu, t = carry
    n = data.shape[0]
    rows = torch.arange(n, device=data.device)[:, None]
    floor = (max(1, math.ceil(cfg.min_participation * n - 1e-9))
             if cfg.min_participation > 0.0 else 0)
    ok = bool(torch.sum(agg_mask) >= floor) if floor else True

    def loss(p, x):
        return ae.recon_loss_stacked(p, x, ae_cfg).sum()

    for it in range(cfg.tau_a):
        t = t + 1.0
        _, grads = value_and_grad(loss, cp, data[rows, batch_idx[it]])
        if cfg.scheme == "fedprox":
            grads = tree_map(lambda g, p, q: g + cfg.prox_mu * (p - q[None]),
                             grads, cp, gp)
        if cfg.scheme == "fedsgd" and ok:
            grads = ttrainer._broadcast(
                ttrainer._masked_mean(grads, agg_mask), n)
        if cfg.local_opt == "sgd":
            cp = tree_map(lambda p, g: p - cfg.lr * g, cp, grads)
        else:
            b1, b2 = cfg.adam_b1, cfg.adam_b2
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, mu, grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, nu, grads)
            c1 = 1 - torch.pow(b1, t)
            c2 = 1 - torch.pow(b2, t)
            cp = tree_map(lambda p, m, v: p - cfg.adam_lr * (m / c1)
                          / (torch.sqrt(v / c2) + cfg.adam_eps), cp, mu, nu)
    if ok:
        gp = ttrainer._masked_mean(cp, agg_mask)
        cp = ttrainer._broadcast(gp, n)
    return ttrainer.FLCarry(cp, gp, mu, nu, t)


@pytest.mark.parametrize("scheme", ["fedavg", "fedsgd", "fedprox"])
@pytest.mark.parametrize("online", [4, 1])     # of 5; the floor is 3
def test_round_body_floor_is_bit_identical(scheme, online):
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    cfg = ttrainer.FLConfig(scheme=scheme, tau_a=3, batch_size=4,
                            min_participation=0.5)
    g = torch.Generator().manual_seed(0)
    n = 5
    data = torch.rand((n, 9, 8, 8, 1), generator=g)
    init = ae.init_ae(g, ae_cfg)
    cp = ttrainer._broadcast(init, n)
    # distinct client parameters, so keeping them differs from the mean
    cp = tree_map(lambda p: p + 0.01 * torch.randn(p.shape, generator=g), cp)
    carry = ttrainer.FLCarry(cp, init, tree_map(torch.zeros_like, cp),
                             tree_map(torch.zeros_like, cp), torch.zeros(()))
    idx = ttrainer.draw_batch_indices(g, torch.full((n,), 9), cfg, 1)[0]
    mask = (torch.arange(n) < online).float()
    want = _round_body_host_floor(cfg, ae_cfg, carry, data, mask, idx)
    got = ttrainer._round_body(cfg, ae_cfg, carry, data, mask, idx)
    for a, b in zip(tree_leaves(tuple(got)), tree_leaves(tuple(want))):
        assert torch.equal(a, b)
    if online == 1:     # below the floor the old global model stays
        for a, b in zip(tree_leaves(got.global_params), tree_leaves(init)):
            assert torch.equal(a, b)
