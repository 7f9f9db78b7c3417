"""The port's plain flash-attention oracle against the JAX one (the CUDA
kernel is held against it on the card: tests/test_torch_gpu.py).
Tolerance: rtol/atol 1e-5 (float32 softmax attention over <= 24 keys)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref


@pytest.mark.parametrize("causal,window,q_offset,h,kv", [
    (True, None, 0, 4, 4), (True, 5, 0, 4, 2), (False, None, 0, 2, 1),
    (True, None, 8, 4, 2)])
def test_flash_attention_ref_matches_jax(causal, window, q_offset, h, kv):
    rng = np.random.default_rng(h * 10 + kv)
    s = 16 if q_offset == 0 else 8
    q = rng.normal(size=(2, s, h, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16 + q_offset, kv, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16 + q_offset, kv, 8)).astype(np.float32)
    got = ref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                  causal=causal, window=window,
                                  q_offset=q_offset)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window,
                                    q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
