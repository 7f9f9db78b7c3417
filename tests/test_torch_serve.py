"""The port's serving launcher against the JAX package's on the CPU.

``serve`` is fed the Gumbel draws that ``jax.random.categorical`` makes from
the JAX launcher's keys (``key`` for the first token, ``fold_in(key, i)``
after it), so both sample from the same noise. In float32 the tokens must
agree wherever JAX's top-two margin of logits / T + noise exceeds 1e-4 (the
logits agree to ~1e-6); after the first token where the margin is smaller
the two sequences may part, and the comparison stops there. Every row must
still compare at least one token, and three quarters of all tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as srv
from repro_torch.models.registry import build_model

MARGIN = 1e-4


def _jax_serve(jm, params, tokens, gen, temperature, key):
    """The JAX launcher's loop (repro/launch/serve.py), returning its tokens,
    the Gumbel draws of each step's key and each step's top-two margin."""
    b, s = tokens.shape
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                              max_len=s + gen))
    decode = jax.jit(lambda p, c, t: jm.decode(p, c, {"token": t}))
    step = jax.jit(lambda lg, kk: (
        jax.random.categorical(kk, lg / max(temperature, 1e-4), axis=-1),
        jax.random.gumbel(kk, lg.shape)))
    logits, cache = prefill(params, tokens)
    first = logits
    keys = [key] + [jax.random.fold_in(key, i) for i in range(gen - 1)]
    toks, noise, margins = [], [], []
    for i, kk in enumerate(keys):
        if i:
            logits, cache = decode(params, cache, toks[-1])
        tok, g = step(logits, kk)
        noisy = np.asarray(logits / max(temperature, 1e-4) + g)
        # the Gumbel-max identity the port's sampler relies on
        np.testing.assert_array_equal(np.asarray(tok), noisy.argmax(-1))
        top2 = np.sort(noisy, axis=-1)[..., -2:]
        toks.append(tok)
        noise.append(np.asarray(g))
        margins.append(top2[..., 1] - top2[..., 0])
    return (np.concatenate([np.asarray(t) for t in toks], 1), np.stack(noise),
            np.concatenate(margins, 1), first)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_serve_with_replayed_noise_samples_jax_tokens(temperature):
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
    jm, m = jbuild(jcfg), build_model(cfg)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(jm.init)(key)
    tokens = jax.random.randint(key, (2, 16), 0, cfg.vocab_size)
    gen = 8
    want, noise, margins, first = _jax_serve(jm, jp, tokens, gen, temperature,
                                             key)
    res = srv.serve(m, convert.lm_params(jax.tree.map(np.asarray, jp)),
                    torch.as_tensor(np.array(tokens)).long(), gen,
                    temperature=temperature, gumbel=torch.as_tensor(noise),
                    device="cpu")
    np.testing.assert_allclose(res.logits.numpy(), np.asarray(first),
                               rtol=1e-5, atol=1e-5)
    got = res.tokens.numpy()
    assert got.shape == want.shape == (2, gen)
    compared = []
    for row in range(2):
        n = 0
        for i in range(gen):
            if margins[row, i] <= MARGIN:
                break
            assert got[row, i] == want[row, i], (row, i, got[row], want[row])
            n += 1
        compared.append(n)
    # the comparison must cover real work: at least one token of every row
    # and three quarters of all tokens agree before any small margin
    assert min(compared) >= 1 and sum(compared) >= 0.75 * 2 * gen, compared
    assert (margins > MARGIN).mean() > 0.9


def test_serve_draws_its_own_noise_reproducibly():
    cfg = get_smoke_config("llama3.2-1b")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 12),
                           generator=torch.Generator().manual_seed(1))
    runs = [srv.serve(m, params, tokens, 5, device="cpu",
                      generator=torch.Generator().manual_seed(2))
            for _ in range(2)]
    a, b = runs
    assert a.tokens.shape == (3, 5) and a.tokens.dtype == torch.int64
    assert bool(((a.tokens >= 0) & (a.tokens < cfg.vocab_size)).all())
    assert torch.equal(a.tokens, b.tokens)
    assert a.logits.shape == (3, 1, cfg.vocab_size)
    assert bool(torch.isfinite(a.logits).all())
    assert a.prefill_s > 0 and a.decode_s > 0


def test_gumbel_noise_matches_jax_in_distribution():
    g = srv.gumbel_noise(torch.Generator().manual_seed(0), (200_000,))
    j = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, (200_000,)))(
        jax.random.PRNGKey(0)))
    # mean is Euler's gamma, variance pi^2 / 6; both sides within 0.01
    for x in (g.numpy(), j):
        assert abs(x.mean() - 0.5772) < 0.01
        assert abs(x.var() - np.pi ** 2 / 6) < 0.02


def test_main_runs_on_the_host():
    res = srv.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "1",
                    "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert res.tokens.shape == (1, 3)
