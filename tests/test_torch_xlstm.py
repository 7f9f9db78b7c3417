"""The port's xLSTM cells and blocks (``repro_torch.models.xlstm``) and the
group norm they use against the JAX package on the CPU, on inputs drawn
from a seed with numpy, at toy sizes.

Tolerance: float32 throughout, 1e-5 relative with a 1e-5 absolute floor
(outputs and states of size ~1; the two sides sum the same f32 products in
other orders). The carried mLSTM states hold a stabiliser m of size ~1, so
the same bound holds for C, n and m.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import common as jcm
from repro.models import xlstm as jx
from repro_torch.configs import get_smoke_config
from repro_torch.models import common as cm
from repro_torch.models import xlstm as tx
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
B, H, DH = 2, 2, 16


def _rng(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _mstate(rng):
    return (_n(rng, B, H, DH, DH, scale=0.5), _n(rng, B, H, DH, scale=0.5),
            _n(rng, B, H))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = _rng(0)
    x, w, b = _n(rng, B, 11, 8), _n(rng, 4, 8), _n(rng, 8)
    st = _n(rng, B, 3, 8) if with_state else None
    jy, jst = jax.jit(jx.causal_conv)(x, w, b, st)
    y, new = tx.causal_conv(_t(x), _t(w), _t(b),
                            None if st is None else _t(st))
    _close(y, jy)
    _close(new, jst)


@pytest.mark.parametrize("s", [64, 300])
def test_mlstm_chunkwise_matches_jax_with_a_carried_state(s):
    """S = 64: one short chunk; S = 300: a full chunk and a padded one."""
    rng = _rng(s)
    q, k, v = (_n(rng, B, s, H, DH, scale=DH ** -0.5) for _ in range(3))
    i_pre, f_pre = _n(rng, B, s, H), _n(rng, B, s, H) + 3.0
    st = _mstate(rng)
    jh, jst = jax.jit(jx.mlstm_chunkwise)(q, k, v, i_pre, f_pre,
                                          jx.MLSTMState(*st))
    h, new = tx.mlstm_chunkwise(_t(q), _t(k), _t(v), _t(i_pre), _t(f_pre),
                                tx.MLSTMState(*map(_t, st)))
    assert h.shape == (B, s, H, DH) and h.dtype == torch.float32
    _close(h, jh)
    for got, want in zip(new, jst):
        _close(got, want)


def test_mlstm_chunkwise_padding_moves_no_state():
    """S = 300 pads 212 steps: the final state equals 300 single steps of
    the port's own recurrent form."""
    rng = _rng(7)
    s = 300
    q, k, v = (_n(rng, B, s, H, DH, scale=DH ** -0.5) for _ in range(3))
    i_pre, f_pre = _n(rng, B, s, H), _n(rng, B, s, H) + 3.0
    st = tx.MLSTMState(*map(_t, _mstate(rng)))
    h, final = tx.mlstm_chunkwise(_t(q), _t(k), _t(v), _t(i_pre), _t(f_pre),
                                  st)
    hs = []
    for t in range(s):
        y, st = tx.mlstm_step(_t(q[:, t]), _t(k[:, t]), _t(v[:, t]),
                              _t(i_pre[:, t]), _t(f_pre[:, t]), st)
        hs.append(y)
    # 1e-4: 300 recurrent steps against the chunked sums
    torch.testing.assert_close(h, torch.stack(hs, 1), rtol=1e-4, atol=1e-4)
    for got, want in zip(final, st):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_mlstm_step_matches_jax():
    rng = _rng(1)
    q, k, v = (_n(rng, B, H, DH, scale=DH ** -0.5) for _ in range(3))
    i_pre, f_pre = _n(rng, B, H), _n(rng, B, H)
    st = _mstate(rng)
    jh, jst = jax.jit(jx.mlstm_step)(q, k, v, i_pre, f_pre,
                                     jx.MLSTMState(*st))
    h, new = tx.mlstm_step(_t(q), _t(k), _t(v), _t(i_pre), _t(f_pre),
                           tx.MLSTMState(*map(_t, st)))
    _close(h, jh)
    for got, want in zip(new, jst):
        _close(got, want)


def _slstm_params(rng, d, nh):
    dh = d // nh
    return {"w_gates": _n(rng, d, 4 * d, scale=d ** -0.5),
            "r_gates": _n(rng, nh, dh, 4 * dh, scale=dh ** -0.5),
            "b_gates": _n(rng, 4 * d, scale=0.1)}


def _sstate(rng, d):
    return (_n(rng, B, d), np.abs(_n(rng, B, d)) + 0.5, _n(rng, B, d),
            _n(rng, B, d))


def test_slstm_sequence_matches_jax():
    rng = _rng(2)
    d, nh, s = 32, 4, 40
    p = _slstm_params(rng, d, nh)
    x, st = _n(rng, B, s, d), _sstate(rng, d)
    jh, jst = jax.jit(lambda x, st, p: jx.slstm_sequence(
        x, jx.SLSTMState(*st), p, nh))(x, st, p)
    h, new = tx.slstm_sequence(_t(x), tx.SLSTMState(*map(_t, st)),
                               {k: _t(v) for k, v in p.items()}, nh)
    _close(h, jh)
    for got, want in zip(new, jst):
        _close(got, want)


def test_slstm_step_matches_jax():
    rng = _rng(3)
    d, nh = 32, 4
    p = _slstm_params(rng, d, nh)
    x, st = _n(rng, B, d), _sstate(rng, d)
    jst, jh = jax.jit(lambda x, st, p: jx.slstm_step(
        x, jx.SLSTMState(*st), p, nh))(x, st, p)
    new, h = tx.slstm_step(_t(x), tx.SLSTMState(*map(_t, st)),
                           {k: _t(v) for k, v in p.items()}, nh)
    _close(h, jh)
    for got, want in zip(new, jst):
        _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads_matches_jax(dtype):
    """bfloat16 out: within one bf16 rounding (8e-3 relative)."""
    rng = _rng(4)
    x = _n(rng, B, 5, H, DH, scale=3.0) + 1.0
    scale = _n(rng, H, DH)
    jy = jax.jit(lambda x, s: jcm.group_norm_heads(
        x.astype(dtype), s, H))(x, scale)
    y = cm.group_norm_heads(_t(x).to(getattr(torch, dtype)), _t(scale), H)
    assert y.dtype == getattr(torch, dtype)
    _close(y, jy.astype(jnp.float32), TOL if dtype == "float32" else 8e-3)


def _block_params(jm_specs, seed):
    """Parameters for one block from JAX's initialiser, with the zero
    leaves redrawn so biases and norms are exercised."""
    leaves, tree = jax.tree.flatten(jm_specs, is_leaf=jcm.is_spec)
    rng = _rng(seed)
    vals = [(_n(rng, *s.shape, scale=0.1) + (1.0 if s.init == "ones" else 0))
            if s.init in ("zeros", "ones")
            else _n(rng, *s.shape, scale=0.1) for s in leaves]
    return jax.tree.unflatten(tree, vals)


def _cfgs():
    return (dataclasses.replace(jget_smoke("xlstm-125m"), dtype="float32"),
            dataclasses.replace(get_smoke_config("xlstm-125m"),
                                dtype="float32"))


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_block_matches_jax(s, carried):
    """s = 1 takes the step form, 37 one padded chunk, 300 two chunks."""
    jcfg, cfg = _cfgs()
    p = _block_params(jx.mlstm_specs(jcfg), 5)
    di = p["wq"].shape[0]
    dh = di // cfg.n_heads
    rng = _rng(6)
    x = _n(rng, B, s, cfg.d_model)
    st = conv = None
    if carried:
        st = (_n(rng, B, cfg.n_heads, dh, dh, scale=0.1),
              _n(rng, B, cfg.n_heads, dh, scale=0.1), _n(rng, B, cfg.n_heads))
        conv = _n(rng, B, cfg.xlstm_conv_width - 1, di)
    jy, (jst, jconv) = jax.jit(lambda p, x, st, conv: jx.mlstm_block(
        p, x, jcfg, None if st is None else jx.MLSTMState(*st), conv))(
            p, x, st, conv)
    y, (new, nconv) = tx.mlstm_block(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg,
        None if st is None else tx.MLSTMState(*map(_t, st)),
        None if conv is None else _t(conv))
    _close(y, jy)
    _close(nconv, jconv)
    for got, want in zip(new, jst):
        _close(got, want)


@pytest.mark.parametrize("s", [1, 19])
def test_slstm_block_matches_jax(s):
    jcfg, cfg = _cfgs()
    p = _block_params(jx.slstm_specs(jcfg), 8)
    rng = _rng(9)
    x = _n(rng, B, s, cfg.d_model)
    st = _sstate(rng, cfg.d_model)
    jy, jst = jax.jit(lambda p, x, st: jx.slstm_block(
        p, x, jcfg, jx.SLSTMState(*st)))(p, x, st)
    y, new = tx.slstm_block({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                            tx.SLSTMState(*map(_t, st)))
    _close(y, jy)
    for got, want in zip(new, jst):
        _close(got, want)
