"""The recurrent families served by the port against the JAX package on the
CPU: xlstm-125m's smoke config (mlstm, slstm) and recurrentgemma-2b reduced
to 4 layers (one (rglru, rglru, local_attn) unit and an rglru tail, d_model
256, local window 64), with JAX's own initial parameters carried across by
``convert.lm_params`` and its caches by ``convert.lm_cache``.

Checked: the prefill's last logits and every cache leaf (recurrent states,
conv histories, the local-attention ring); teacher-forced decode from JAX's
prefill cache, recurrentgemma's prompt (72) longer than its window so the
prefill takes the ring branch and decode running past a ring wrap (position
128), xLSTM's prompt (300) over one mLSTM chunk and ragged; the port's own
prefill + decode against its full forward; the cache dtypes; and serve's
CLI on both smoke configs.

Tolerances. float32: 1e-5 relative with a 1e-5 absolute floor on logits
and states of size ~1 (measured: logits 3e-7 and 8e-7, cache leaves 7e-7
and 2e-6), the same for the port's prefill-then-decode against its own full
forward (measured 7e-7). bfloat16: 2e-2 on logits, as for the dense family
in ``test_torch_transformer.py``.
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
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
B = 2
# arch -> (config overrides, prompt length, last decoded position + 1)
CASES = {"xlstm-125m": ({}, 300, 306),
         "recurrentgemma-2b": ({"n_layers": 4}, 72, 131)}


def _cfgs(arch, dtype):
    over, _, _ = CASES[arch]
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))


def _t(a):
    return torch.as_tensor(np.array(a)).long()


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=list(CASES))
def lm(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch, "float32")
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    _, n_pre, end = CASES[arch]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, end)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             max_len=end))(jp, tokens[:, :n_pre])
    return dict(arch=arch, jm=jm, m=m, jp=jp, tokens=tokens, n_pre=n_pre,
                end=end, jl=jl, jc=jax.tree.map(np.asarray, jc),
                tp=convert.lm_params(jax.tree.map(np.asarray, jp)))


def _leaves(cache):
    return cm.tree_leaves((cache["scan"], cache["tail"]))


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_logits_and_every_cache_leaf_match_jax(lm, use_flash):
    """The port's flash route on the host is the plain version, which is
    JAX's plain attention; recurrentgemma's 72-token prompt fills its
    64-slot ring past the window."""
    tl, tc = lm["m"].prefill(lm["tp"], {"tokens": _t(lm["tokens"][:, :lm["n_pre"]])},
                             max_len=lm["end"], use_flash=use_flash)
    assert tl.shape == (B, 1, 512) and tl.dtype == torch.float32
    _close(tl, lm["jl"], TOL)
    assert tc["pos"] == int(lm["jc"]["pos"]) == lm["n_pre"]
    got, want = _leaves(tc), jax.tree.leaves((lm["jc"]["scan"],
                                             lm["jc"]["tail"]))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [str(g.dtype)[6:] for g in got] == [str(w.dtype) for w in want]
    for g, w in zip(got, want):
        _close(g, w, TOL)
    if lm["arch"] == "recurrentgemma-2b":
        assert tc["scan"][2]["k"].shape == (1, B, 64, 1, 64)


def test_decode_from_jax_cache_matches_jax(lm):
    """Teacher-forced steps from JAX's prefill cache to position end - 1;
    for recurrentgemma that writes ring slots 8..63 and wraps to 0..2."""
    jm, m, toks = lm["jm"], lm["m"], lm["tokens"]
    decode = jax.jit(lambda p, c, t: jm.decode(p, c, {"token": t}))
    jc, cache = lm["jc"], convert.lm_cache(lm["jc"])
    for t in range(lm["n_pre"], lm["end"]):
        jl, jc = decode(lm["jp"], jc, toks[:, t:t + 1])
        tl, cache = m.decode(lm["tp"], cache, {"token": _t(toks[:, t:t + 1])})
        _close(tl, jl, TOL)
    assert cache["pos"] == int(jc["pos"]) == lm["end"]
    for g, w in zip(_leaves(cache), jax.tree.leaves((jc["scan"],
                                                     jc["tail"]))):
        _close(g, np.asarray(w), TOL)


def test_prefill_plus_decode_matches_own_full_forward(lm):
    """As the JAX package's tests/test_decode_parity.py: prefill(t[:n])
    then decode(t[n:]) reproduces the full-sequence forward's logits."""
    cfg, params = lm["m"].cfg, lm["tp"]
    toks = _t(lm["tokens"])
    x, positions, _ = tf.embed_inputs(params, {"tokens": toks}, cfg)
    full = tf.logits_from_hidden(
        params, tf._run_stack(params, None, x, cfg, positions,
                              mode="train")[0], cfg)
    n = lm["n_pre"]
    logits, cache = lm["m"].prefill(params, {"tokens": toks[:, :n]},
                                    max_len=lm["end"], use_flash=True)
    torch.testing.assert_close(logits[:, 0], full[:, n - 1], rtol=TOL,
                               atol=TOL)
    for t in range(n, lm["end"]):
        logits, cache = lm["m"].decode(params, cache,
                                       {"token": toks[:, t:t + 1]})
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", list(CASES))
def test_bf16_prefill_and_decode_match_jax(arch):
    """The configs' own bf16 activations: conv histories and K/V in bf16,
    every state in f32 on both sides; logits within 2e-2."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    n_pre = CASES[arch][1]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, n_pre + 4)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                             max_len=n_pre + 4))(
        jp, toks[:, :n_pre])
    tl, tc = m.prefill(tp, {"tokens": _t(toks[:, :n_pre])}, max_len=n_pre + 4,
                       use_flash=True)
    _close(tl, jl, 2e-2)
    got, want = _leaves(tc), jax.tree.leaves((jc["scan"], jc["tail"]))
    assert [str(g.dtype)[6:] for g in got] == [str(w.dtype) for w in want]
    decode = jax.jit(lambda p, c, t: jm.decode(p, c, {"token": t}))
    for t in range(n_pre, n_pre + 4):
        jl, jc = decode(jp, jc, toks[:, t:t + 1])
        tl, tc = m.decode(tp, tc, {"token": _t(toks[:, t:t + 1])})
        _close(tl, jl, 2e-2)


@pytest.mark.parametrize("arch", list(CASES))
def test_serve_main_runs_the_smoke_config_on_the_host(arch):
    m = build_model(get_smoke_config(arch))
    assert m.n_active_params() == m.n_params()
    res = srv.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "12", "--gen", "3", "--device", "cpu"])
    assert res.tokens.shape == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert bool(torch.isfinite(res.logits).all())
