"""The port's RG-LRU (``repro_torch.models.rglru``), its Λ initialiser and
the new config fields against the JAX package on the CPU, on inputs drawn
from a seed with numpy, at toy sizes.

Tolerance: float32, 1e-5 relative with a 1e-5 absolute floor (states and
outputs of size ~1). The port's scan combines in another tree than
``lax.associative_scan`` (Hillis-Steele), so its products of a_t round in
another order; over a few hundred steps of a_t < 1 that stays far inside
the bound.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import common as jcm
from repro.models import rglru as jr
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import common as cm
from repro_torch.models import rglru as tr
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
B, DR = 2, 24


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(rng, d=16, dr=DR, cw=4):
    """One block's parameters: the weights at their init scale, biases
    and norms redrawn away from 0, Λ from JAX's own initialiser."""
    lam = jax.jit(lambda k: jcm._init_leaf(
        k, jcm.Spec((dr,), (None,), "lambda_init"), np.float32))(
            jax.random.PRNGKey(3))
    return {"ln": _n(rng, d, scale=0.1), "w_x": _n(rng, d, dr, scale=0.3),
            "w_gate": _n(rng, d, dr, scale=0.3),
            "conv_w": _n(rng, cw, dr, scale=0.5),
            "conv_b": _n(rng, dr, scale=0.1), "lam": np.asarray(lam),
            "w_a": _n(rng, dr, dr, scale=dr ** -0.5),
            "b_a": _n(rng, dr, scale=0.1),
            "w_i": _n(rng, dr, dr, scale=dr ** -0.5),
            "b_i": _n(rng, dr, scale=0.1),
            "w_out": _n(rng, dr, d, scale=0.1)}


def _tp(p):
    return {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("s", [2, 37, 300])
def test_rglru_scan_matches_jax(s):
    """s = 2: one combine step; 37 and 300: ragged powers of two."""
    rng = np.random.default_rng(s)
    p = _params(rng)
    x, h0 = _n(rng, B, s, DR), _n(rng, B, DR)
    jh, jlast = jax.jit(jr.rglru_scan)(x, p, h0)
    h, last = tr.rglru_scan(_t(x), _tp(p), _t(h0))
    assert h.shape == (B, s, DR) and h.dtype == torch.float32
    _close(h, jh)
    _close(last, jlast)


def test_rglru_scan_equals_its_steps():
    """The log-depth scan against 300 decode steps of the port's own."""
    rng = np.random.default_rng(5)
    p = _tp(_params(rng))
    x, h = _t(_n(rng, B, 300, DR)), _t(_n(rng, B, DR))
    hs, last = tr.rglru_scan(x, p, h)
    for t in range(300):
        _, h = tr.rglru_step(x[:, t], p, h)
    torch.testing.assert_close(last, h, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hs[:, -1], h, rtol=TOL, atol=TOL)


def test_rglru_step_matches_jax():
    rng = np.random.default_rng(1)
    p = _params(rng)
    x, h0 = _n(rng, B, DR), _n(rng, B, DR)
    jh, _ = jax.jit(jr.rglru_step)(x, p, h0)
    h, same = tr.rglru_step(_t(x), _tp(p), _t(h0))
    _close(h, jh)
    assert same is h


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_smoke("recurrentgemma-2b"), dtype=dtype,
                               rglru_d_rnn=DR, d_model=16)
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              dtype=dtype, rglru_d_rnn=DR, d_model=16)
    return jcfg, cfg


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_jax(s, with_state):
    """With no state the block starts from zeros with an f32 conv history;
    its returned history is in the activation dtype either way."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    p = _params(rng)
    x = _n(rng, B, s, 16)
    st = (_n(rng, B, DR), _n(rng, B, 3, DR)) if with_state else None
    jy, jst = jax.jit(lambda p, x, st: jr.rglru_block(
        p, x, jcfg, None if st is None else jr.RGLRUState(*st)))(p, x, st)
    y, new = tr.rglru_block(_tp(p), _t(x), cfg,
                            None if st is None else tr.RGLRUState(*map(_t, st)))
    _close(y, jy)
    _close(new.h, jst.h)
    _close(new.conv, jst.conv)
    assert new.h.dtype == torch.float32 and new.conv.dtype == torch.float32


def test_rglru_block_bf16_state_dtypes_match_jax():
    """bf16 activations: the conv history comes back in bf16, h in f32, as
    in JAX; values within bf16 rounding (2e-2 on outputs of size ~1)."""
    jcfg, cfg = _cfgs("bfloat16")
    rng = np.random.default_rng(4)
    p = _params(rng)
    x = _n(rng, B, 20, 16)
    jy, jst = jax.jit(lambda p, x: jr.rglru_block(
        p, x.astype(jcfg.act_dtype), jcfg))(p, x)
    y, new = tr.rglru_block(_tp(p), _t(x).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16 and new.conv.dtype == torch.bfloat16
    assert new.h.dtype == torch.float32
    assert str(jst.conv.dtype) == "bfloat16" and str(jst.h.dtype) == "float32"
    _close(y, np.asarray(jy, np.float32), 2e-2)
    _close(new.h, jst.h, 2e-2)


def test_lambda_init_draws_a_in_its_range():
    lam = cm._init_leaf(torch.Generator().manual_seed(0),
                        cm.Spec((50_000,), (None,), "lambda_init"), (),
                        torch.float32, 1)
    a = torch.sigmoid(lam) ** 8
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    # uniform on [0.9, 0.999]: mean 0.9495, as JAX's draw
    jlam = jax.jit(lambda k: jcm._init_leaf(
        k, jcm.Spec((50_000,), (None,), "lambda_init"), np.float32))(
            jax.random.PRNGKey(0))
    ja = (1 / (1 + np.exp(-np.asarray(jlam)))) ** 8
    assert abs(float(a.mean()) - 0.9495) < 2e-3
    assert abs(float(ja.mean()) - 0.9495) < 2e-3


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-2b"])
def test_configs_match_jax_on_every_ported_field(arch):
    """CONFIG, smoke_config() and reduced(n_layers=4): the port's fields
    equal JAX's, the rglru_d_rnn default and the hybrid reduction
    included."""
    assert arch in ARCH_IDS
    pairs = [(get_config(arch), jget_config(arch)),
             (get_smoke_config(arch), jget_smoke(arch)),
             (get_config(arch).reduced(n_layers=4),
              jget_config(arch).reduced(n_layers=4))]
    for cfg, jcfg in pairs:
        got = dataclasses.asdict(cfg)
        want = dataclasses.asdict(jcfg)
        assert got == {k: want[k] for k in got}
    assert get_config("recurrentgemma-2b").rglru_d_rnn == 2560
    assert get_smoke_config("recurrentgemma-2b").rglru_d_rnn == 256
