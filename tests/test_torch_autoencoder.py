"""The port's autoencoder against ``repro.models.autoencoder``: forward
(encode, reconstruct) and the per-client gradients of the masked loss, with
weights carried across by ``repro_torch.convert``.

Tolerance: forward 1e-5 (float32 convolutions summed in another order),
gradients 1e-5 relative + 1e-6 absolute."""
import jax
import numpy as np
import pytest
import torch

from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.models import autoencoder as tae
from repro_torch.models.common import tree_leaves, value_and_grad

from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(8, 8, 1, (4, 8), 8), (28, 28, 1, (4, 8), 8),
          (32, 32, 3, (4, 8), 6)]


def _cfgs(h, w, c, widths, latent):
    return (jae.AEConfig(h, w, c, widths=widths, latent_dim=latent),
            tae.AEConfig(h, w, c, widths=widths, latent_dim=latent))


def _params(jc, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    p = jax.device_get(jax.jit(jax.vmap(lambda k: jae.init_ae(k, jc)))(keys))
    # non-zero biases, so every parameter is exercised
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), p)


@pytest.mark.parametrize("shape", SHAPES)
def test_reconstruct_matches_reference(shape):
    jc, tc = _cfgs(*shape)
    p = _params(jc, 3)
    x = np.random.default_rng(2).uniform(size=(3, 5) + shape[:3]).astype(
        np.float32)
    want = jax.jit(jax.vmap(lambda pp, xx: jae.reconstruct(pp, xx, jc)))(p, x)
    got = tae.reconstruct_stacked(convert.ae_params(p),
                                  torch.as_tensor(x), tc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_single_model_forms_match_reference():
    jc, tc = _cfgs(*SHAPES[0])
    p = jax.tree.map(lambda a: a[0], _params(jc, 1))
    x = np.random.default_rng(3).uniform(size=(6, 8, 8, 1)).astype(np.float32)
    tp = convert.ae_params(p)
    tx = torch.as_tensor(x)
    want = jax.jit(lambda pp, xx: (jae.encode(pp, xx, jc),
                                   jae.recon_loss(pp, xx, jc),
                                   jae.per_sample_loss(pp, xx, jc)))(p, x)
    np.testing.assert_allclose(tae.encode(tp, tx, tc).numpy(),
                               np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tae.recon_loss(tp, tx, tc)),
                               float(want[1]), rtol=1e-5)
    one = {k: {kk: v[None] for kk, v in d.items()} for k, d in tp.items()}
    np.testing.assert_allclose(
        tae.per_sample_loss_stacked(one, tx[None], tc)[0].numpy(),
        np.asarray(want[2]), rtol=1e-5)


def test_masked_loss_grads_are_per_client_and_match():
    jc, tc = _cfgs(*SHAPES[1])
    p = _params(jc, 3, seed=4)
    x = np.random.default_rng(5).uniform(size=(3, 6, 28, 28, 1)).astype(
        np.float32)
    m = (np.arange(6)[None] < np.array([6, 2, 4])[:, None]).astype(
        np.float32)
    want = jax.jit(jax.vmap(lambda pp, xx, mm: jax.grad(
        jae.masked_recon_loss)(pp, xx, mm, jc)))(p, x, m)
    tp = convert.ae_params(p)

    def loss(pp):
        return tae.masked_recon_loss_stacked(
            pp, torch.as_tensor(x), torch.as_tensor(m), tc).sum()
    _, got = value_and_grad(loss, tp)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_init_shapes_follow_specs():
    _, tc = _cfgs(*SHAPES[0])
    g = torch.Generator().manual_seed(0)
    one = tae.init_ae(g, tc)
    many = tae.init_ae(g, tc, n_clients=4)
    assert tuple(one["enc"]["conv1"].shape) == (3, 3, 1, 4)
    assert tuple(many["dec"]["proj"].shape) == (4, 8, 2 * 2 * 8)
    assert float(one["enc"]["b1"].abs().sum()) == 0.0
