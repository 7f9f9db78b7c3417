"""The port's K-means assignment (``repro_torch.kernels``): its plain
version against the JAX oracle and the interpret-mode Pallas kernel, the
batched (N, n, d) form, exact ties, and the CUDA wrapper's guards.

Tolerance: min_d2 within 1e-5 relative + 1e-5 absolute (float32 sums of
d <= 32 products in another order); assignments exactly equal except on rows
whose two smallest d2 lie within that tolerance of each other."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import kmeans_assign as km_kernel


def _case(seed, n, d, k, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (n, d)).astype(np.float32)
    c = rng.normal(size=lead + (k, d)).astype(np.float32)
    return x, c


def _near_tie(x, c, tol):
    d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    s = np.sort(d2, axis=1)
    return (s[:, 1] - s[:, 0]) < tol if c.shape[0] > 1 else \
        np.zeros(x.shape[0], bool)


def _assert_matches(a, m, want_a, want_m, x, c):
    a, m = np.asarray(a), np.asarray(m)
    want_a, want_m = np.asarray(want_a), np.asarray(want_m)
    np.testing.assert_allclose(m, want_m, rtol=1e-5, atol=1e-5)
    tol = 1e-5 * (np.abs(want_m) + 1.0)
    differ = a != want_a
    assert not (differ & ~_near_tie(x, c, tol)).any()


@pytest.mark.parametrize("n,d,k", [(1, 32, 3), (37, 32, 3), (517, 32, 3),
                                   (100, 11, 11), (64, 5, 9)])
def test_plain_matches_jax_oracle_and_pallas(n, d, k):
    x, c = _case(n * 100 + d * 10 + k, n, d, k)
    a, m = ops.kmeans_assign(torch.as_tensor(x), torch.as_tensor(c))
    assert a.dtype == torch.int32 and m.dtype == torch.float32
    assert a.shape == (n,) and m.shape == (n,)
    want = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    _assert_matches(a, m, *want, x, c)
    pallas = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                use_pallas=True)
    _assert_matches(a, m, *pallas, x, c)


def test_batched_form_matches_per_client_oracle():
    x, c = _case(7, 45, 32, 3, lead=(4,))
    a, m = ops.kmeans_assign(torch.as_tensor(x), torch.as_tensor(c))
    assert a.shape == (4, 45)
    for i in range(4):
        want = jref.kmeans_assign_ref(jnp.asarray(x[i]), jnp.asarray(c[i]))
        _assert_matches(a[i], m[i], *want, x[i], c[i])


def test_planted_ties_pick_the_first_centroid():
    x, c = _case(3, 50, 32, 4)
    c[2] = c[0]          # exact duplicate: d2 ties bit for bit
    c[3] = c[1]
    a, _ = ops.kmeans_assign(torch.as_tensor(x), torch.as_tensor(c))
    want, _ = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    assert set(a.tolist()) <= {0, 1}


def test_min_d2_clamped_at_zero():
    x = np.ones((3, 8), np.float32) * 1e3
    a, m = ops.kmeans_assign(torch.as_tensor(x), torch.as_tensor(x[:2]))
    assert (m >= 0).all() and (a == 0).all()


def test_cuda_wrapper_refuses_host_tensors():
    x, c = _case(0, 4, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        km_kernel.kmeans_assign_cuda(torch.as_tensor(x), torch.as_tensor(c))


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_plain_version_is_the_oracle_formula():
    x, c = _case(11, 20, 6, 3)
    a, m = ref.kmeans_assign_ref(torch.as_tensor(x), torch.as_tensor(c))
    d2 = ((x[:, None] - c[None]) ** 2).sum(-1)
    np.testing.assert_allclose(m.numpy(), d2.min(1), rtol=1e-4, atol=1e-4)
