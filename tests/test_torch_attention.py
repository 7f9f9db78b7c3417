"""The port's attention against the JAX package on the CPU.

``ops.flash_attention`` on a CPU tensor runs the kernel's plain version; it
is held against JAX's oracle and against JAX's Pallas kernel in interpret
mode. The attention module's routes (plain, flash, chunked), decode
attention and the KV-cache helpers are each held against their JAX
function.

Tolerances. float32: 1e-5 against the oracle (the same sums in another
order), 2e-5 against the Pallas kernel (online softmax). bfloat16: 1e-2
against the oracle (one bf16 rounding of the output, whose values reach
~2), 3e-2 against the Pallas kernel, which keeps p in f32 where the plain
route rounds it to bf16 (the JAX package's own kernel test allows 3e-2).
Cache helpers are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

TOL = {"float32": (1e-5, 2e-5), "bfloat16": (1e-2, 3e-2)}


def _qkv(seed, b, s, lk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, lk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, lk, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    tt = tuple(torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays)
    jj = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    return tt, jj


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


FLASH_CASES = [  # s, lk, h, kv, hd, window, q_offset
    (64, 64, 4, 4, 32, None, 0),     # GQA ratio 1
    (64, 64, 8, 2, 32, None, 0),     # GQA ratio 4
    (48, 48, 8, 1, 64, None, 0),     # GQA ratio 8 (MQA), ragged blocks
    (64, 64, 4, 2, 32, 16, 0),       # sliding window
    (32, 96, 4, 2, 32, None, 64),    # chunked prefill: q_offset
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_on_cpu_matches_jax_kernel_and_oracle(case, dtype):
    s, lk, h, kv, hd, window, q_offset = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(s + h + kv, 2, s, lk, h, kv, hd),
                                    dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol_ref, tol_kernel = TOL[dtype]
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), tol_ref)
    pallas = jops.flash_attention(jq, jk, jv, use_pallas=True, block_q=32,
                                  block_k=32, **kw)
    _close(got, pallas, tol_kernel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_routes_match_jax(use_flash, dtype):
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 2, 40, 40, 8, 2, 32), dtype)
    got = attn.attention(q, k, v, window=24, use_flash=use_flash)
    want = jax.jit(lambda a, b, c: jattn.attention(
        a, b, c, window=24, use_flash=use_flash))(jq, jk, jv)
    _close(got, want, TOL[dtype][0])


def test_long_kv_takes_the_chunked_route_as_in_jax():
    """Beyond CHUNKED_THRESHOLD keys both packages switch to the chunked
    online softmax; 2,100 keys make three 1,024-key chunks, the last short."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 1, 16, 2100, 4, 2, 32), "float32")
    got = attn.attention(q, k, v, q_offset=2084)
    want = jax.jit(lambda a, b, c: jattn.attention(a, b, c, q_offset=2084))(
        jq, jk, jv)
    _close(got, want, 1e-5)
    _close(got, jref.flash_attention_ref(jq, jk, jv, q_offset=2084), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0),
                                                    (True, 10, 0),
                                                    (False, None, 0),
                                                    (True, None, 20)])
def test_chunked_attention_matches_jax(causal, window, q_offset, dtype):
    (q, k, v), (jq, jk, jv) = _both(_qkv(3, 2, 30, 30 + q_offset, 8, 4, 32),
                                    dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=16)
    got = attn.chunked_attention(q, k, v, **kw)
    want = jax.jit(lambda a, b, c: jattn.chunked_attention(a, b, c, **kw))(
        jq, jk, jv)
    _close(got, want, TOL[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,w", [(5, 16), (15, 16), (23, 16)])
def test_decode_attention_matches_jax(pos, w, dtype):
    (q, k, v), (jq, jk, jv) = _both(_qkv(pos, 2, 1, w, 8, 2, 64), dtype)
    slot = attn.cache_slot_positions(pos, w)
    got = attn.decode_attention(q, k, v, slot, pos=pos)
    want = jax.jit(lambda a, b, c: jattn.decode_attention(
        a, b, c, jattn.cache_slot_positions(pos, w), pos=pos))(jq, jk, jv)
    _close(got, want, TOL[dtype][0])


@pytest.mark.parametrize("pos,w", [(0, 8), (7, 8), (8, 8), (19, 8), (3, 5)])
def test_cache_helpers_match_jax(pos, w):
    assert attn.cache_slot(pos, w) == int(jattn.cache_slot(pos, w))
    np.testing.assert_array_equal(attn.cache_slot_positions(pos, w).numpy(),
                                  np.asarray(jattn.cache_slot_positions(pos, w)))
    rng = np.random.default_rng(pos)
    kc, vc = (rng.normal(size=(2, w, 2, 4)).astype(np.float32) for _ in "kv")
    kn, vn = (rng.normal(size=(2, 1, 2, 4)).astype(np.float32) for _ in "kv")
    got = attn.cache_write(*map(torch.as_tensor, (kc.copy(), vc.copy(), kn,
                                                   vn)), pos, w)
    want = jattn.cache_write(*map(jnp.asarray, (kc, vc, kn, vn)), pos, w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_flash_kernel_wrapper_refuses_what_it_cannot_run():
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 8, 8, 2, 2, 48))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 8, 8, 2, 2, 64))
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_cuda(q, k[:, :, :1].expand(1, 8, 3, 64), v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
