"""The port's recon-gate score (``repro_torch.kernels``): its plain version
against the JAX oracle and the interpret-mode Pallas kernel, leading dims, an
all-masked group, and the CUDA wrapper's guards.

Tolerance: rtol 1e-5, atol 1e-6 (float32 means over up to 40 x 784 terms
summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import recon_gate as rg_kernel


def _case(seed, shape, mask_p=0.7):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    m = (rng.uniform(size=shape[:-1]) < mask_p).astype(np.float32)
    return y, x, m


@pytest.mark.parametrize("shape", [(1, 3, 10), (6, 12, 784), (5, 40, 37),
                                   (9, 1, 128)])
def test_plain_matches_jax_oracle_and_pallas(shape):
    y, x, m = _case(sum(shape), shape)
    got = ops.recon_gate_score(*map(torch.as_tensor, (y, x, m)))
    assert got.shape == shape[:1] and got.dtype == torch.float32
    want = jref.recon_gate_ref(jnp.asarray(y), jnp.asarray(x), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    pallas = jops.recon_gate_score(jnp.asarray(y), jnp.asarray(x),
                                   jnp.asarray(m), use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_leading_dims_receiver_by_cluster():
    y, x, m = _case(2, (4, 3, 8, 64))
    got = ops.recon_gate_score(*map(torch.as_tensor, (y, x, m)))
    assert got.shape == (4, 3)
    want = jref.recon_gate_ref(jnp.asarray(y), jnp.asarray(x), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_all_masked_group_scores_zero():
    y, x, m = _case(1, (4, 8, 128))
    m[1] = 0.0
    got = ops.recon_gate_score(*map(torch.as_tensor, (y, x, m)))
    assert float(got[1]) == 0.0
    pallas = jops.recon_gate_score(jnp.asarray(y), jnp.asarray(x),
                                   jnp.asarray(m), use_pallas=True)
    assert float(pallas[1]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_unmasked_equals_plain_mse():
    y, x, _ = _case(3, (3, 16, 784))
    got = ops.recon_gate_score(torch.as_tensor(y), torch.as_tensor(x),
                               torch.ones(3, 16))
    np.testing.assert_allclose(got.numpy(), ((y - x) ** 2).mean((1, 2)),
                               rtol=1e-5)


def test_cuda_wrapper_refuses_host_tensors():
    y, x, m = _case(0, (2, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        rg_kernel.recon_gate_cuda(*map(torch.as_tensor, (y, x, m)))
