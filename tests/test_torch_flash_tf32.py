"""The float32 flash kernel's arithmetic (``csrc/flash_attention.cu``), on the
CPU: 3xTF32 products on the tensor cores.

The kernel cannot run here, so :func:`emulate_3xtf32` repeats its
arithmetic in torch: ``cvt.rna.tf32.f32`` as integer ops on the float's
bits; q scaled by hd^-0.5 and split into hi = tf32(x) and lo = tf32(x - hi);
each product as the kernel issues it, in k-steps of 8 with the passes
q_lo.k_hi, q_hi.k_lo, q_hi.k_hi, each pass one mma added up as the tensor
cores add it (``tools.mma_tf32_probe.mma_tf32``: every term aligned to the
largest and cut toward zero, the sum cut toward zero to float32; the probe
holds that model to the card bit for bit); S's small passes in an
accumulator of their own, its hi.hi pass in a fresh one for each 8
k-steps, joined in float32; the online softmax over the kernel's KV tiles
of 32 keys in exp2 with the -1e30 sentinel and masked p = 0; p split again,
each tile's P.V summed in one accumulator from 0 and joined to the rescaled
O by one FMA; the denominator max(l, 1e-30). Held against the plain version
(``kernels/ref.flash_attention_ref``) and JAX's reference with the float32
tolerance of ``chip_smoke.check_flash`` and ``tests/test_torch_gpu.py``,
2e-5 + 2e-5 * |want|, and where q is scaled up so that scores reach ~30,
against float64 too. Two controls: one TF32 pass (q_hi.k_hi, p_hi.v_hi)
misses the tolerance, which is why the kernel splits; S summed in one
accumulator drifts at large scores, which is why it has three.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_draws import one_torch_thread  # noqa: F401
from tools.mma_tf32_probe import mma_tf32

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEG_INF = -1e30
BK = 32  # keys a KV tile, as in the kernel
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def tf32(x):
    """cvt.rna.tf32.f32: round float32 x to 10 mantissa bits, to nearest,
    ties away from zero (the sign bit is untouched: the float is
    sign-magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, passes, *, chunk=None):
    """a (..., M, K) @ b (..., K, N) as the kernel's mmas give it: k-steps
    of 8, each 3 passes (small terms first) or 1 (hi.hi). With ``chunk``,
    S's scheme: the small passes sum in an accumulator of their own over
    every k-step, and the hi.hi pass in a fresh one for each ``chunk``
    k-steps, added to the total in float32, which takes the small sum
    last. Without, one accumulator takes every pass and k-step (a tile's
    P.V)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    small = torch.zeros_like(out)
    for k0 in range(0, a.shape[-1], 8):
        x_hi, x_lo = a_hi[..., k0:k0 + 8], a_lo[..., k0:k0 + 8]
        y_hi, y_lo = b_hi[..., k0:k0 + 8, :], b_lo[..., k0:k0 + 8, :]
        if chunk is None:
            if passes == 3:
                out = mma_tf32(out, x_lo, y_hi)
                out = mma_tf32(out, x_hi, y_lo)
            out = mma_tf32(out, x_hi, y_hi)
            continue
        if passes == 3:
            small = mma_tf32(small, x_lo, y_hi)
            small = mma_tf32(small, x_hi, y_lo)
        if k0 // 8 % chunk == 0:
            part = torch.zeros_like(out)
        part = mma_tf32(part, x_hi, y_hi)
        if k0 // 8 % chunk == chunk - 1 or k0 + 8 >= a.shape[-1]:
            out = out + part
    return out + small if chunk else out


def emulate_3xtf32(q, k, v, *, causal=True, window=None, q_offset=0,
                   passes=3, s_chunk=8):
    """The kernel's arithmetic on float32 q (B,S,H,hd), k, v (B,L,Kv,hd)
    -> (B,S,H,hd)."""
    b, s, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    qs = (q * torch.tensor(hd ** -0.5, dtype=torch.float32)).transpose(1, 2)
    kh = k.repeat_interleave(h // n_kv, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(h // n_kv, dim=2).transpose(1, 2)
    m = torch.full((b, h, s, 1), NEG_INF)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, hd))
    pos = (torch.arange(s) + q_offset)[:, None]
    # S of every key at once: its sums run along hd, not along the keys
    s_all = product(qs, kh.transpose(-1, -2), passes, chunk=s_chunk)
    for k0 in range(0, lk, BK):
        kj = torch.arange(k0, min(k0 + BK, lk))[None, :]
        ok = torch.ones((s, kj.shape[1]), dtype=torch.bool)
        if causal:
            ok &= pos >= kj
        if window is not None:
            ok &= pos - kj < window
        sc = torch.where(ok, s_all[..., k0:k0 + BK], NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        # p = ex2(fma(s, log2e, -m log2e)), alpha = ex2((m - m_new) log2e)
        arg = (sc.double() * LOG2E.double() - (m_new * LOG2E).double())
        p = torch.where(ok, torch.exp2(arg.float().double()).float(), 0.0)
        alpha = torch.exp2(((m - m_new) * LOG2E).double()).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = product(p, vh[:, :, k0:k0 + BK], passes)
        o = (o.double() * alpha.double() + pv.double()).float()
        m = m_new
    return (o / torch.clamp(l, min=1e-30)).transpose(1, 2)


def _inputs(b, s, lk, h, kv, hd, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, hd), (b, lk, kv, hd), (b, lk, kv, hd)))
    return q * np.float32(q_scale), k, v


def _visible(s, lk, causal, window, q_offset):
    """Rows of q that see at least one key."""
    pos = np.arange(s)[:, None] + q_offset
    kj = np.arange(lk)[None, :]
    ok = np.ones((s, lk), bool)
    if causal:
        ok &= pos >= kj
    if window is not None:
        ok &= pos - kj < window
    return ok.any(-1)


CASES = {  # b, s, lk, h, kv, hd, causal, window, q_offset, q scale
    "hd32": (1, 96, 96, 2, 2, 32, True, None, 0, 1),
    "hd64 GQA": (1, 96, 96, 4, 2, 64, True, None, 0, 1),
    "hd128 MQA window": (1, 80, 80, 4, 1, 128, True, 24, 0, 1),
    "hd256 MQA window": (1, 70, 70, 2, 1, 256, True, 16, 0, 1),
    "q_offset": (1, 32, 96, 4, 2, 64, True, None, 64, 1),
    "non-causal": (2, 40, 72, 2, 2, 64, False, None, 0, 1),
    # rows 11..31 (positions 71..91) see no key of L = 64 through window 8
    "rows with no visible key": (1, 32, 64, 2, 2, 64, True, 8, 60, 1),
    # q x 8: scores reach ~30, where a truncating sum's drift shows
    "hd256 scores to ~30": (1, 96, 96, 2, 1, 256, True, None, 0, 8),
}


@functools.lru_cache(maxsize=None)
def _case(name, passes=3, s_chunk=8):
    """(emulated kernel, plain version, rows that see a key, inputs)."""
    b, s, lk, h, kv, hd, causal, window, q_offset, scale = CASES[name]
    qn, kn, vn = _inputs(b, s, lk, h, kv, hd, seed=len(name), q_scale=scale)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = emulate_3xtf32(q, k, v, **kw, passes=passes, s_chunk=s_chunk)
    want = ref.flash_attention_ref(q, k, v, **kw)
    seen = torch.from_numpy(_visible(s, lk, causal, window, q_offset))
    return got, want, seen, (qn, kn, vn, kw)


def _attention_f64(qn, kn, vn, causal=True, window=None, q_offset=0):
    """Plain attention in float64: the truth the float32 routes miss."""
    q, k, v = (torch.from_numpy(a).double() for a in (qn, kn, vn))
    h, n_kv = q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(h // n_kv, dim=2) for t in (k, v))
    sc = torch.einsum("bshd,blhd->bhsl", q, k) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])[:, None] + q_offset
    kj = torch.arange(k.shape[1])[None, :]
    ok = torch.ones(sc.shape[-2:], dtype=torch.bool)
    if causal:
        ok &= pos >= kj
    if window is not None:
        ok &= pos - kj < window
    sc = torch.where(ok, sc, -torch.inf)
    return torch.einsum("bhsl,blhd->bshd", torch.softmax(sc, -1), v)


def _within(got, want):
    return (got - want).abs() <= 2e-5 + 2e-5 * want.abs()


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_within_float32_tolerance(name):
    """3 passes stay within 2e-5 of the plain float32 version on rows that
    see a key; a row that sees none comes out 0, as the Pallas body's
    max(l, 1e-30) makes it (the plain version's softmax would average v)."""
    got, want, seen, (qn, kn, vn, kw) = _case(name)
    assert bool(_within(got, want)[:, seen].all()), \
        float((got - want).abs()[:, seen].max())
    assert bool((got[:, ~seen] == 0).all())
    if name == "hd128 MQA window":
        jwant = torch.from_numpy(np.array(jax.jit(
            lambda *a: jref.flash_attention_ref(*a, **kw))(
                jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))))
        assert bool(_within(got, jwant).all())


@pytest.mark.parametrize("name", list(CASES))
def test_1xtf32_misses_float32_tolerance(name):
    """The control: one TF32 pass per product misses 2e-5 (by ~50x at
    these sizes), so the split is needed."""
    got, want, seen, _ = _case(name, passes=1)
    assert not bool(_within(got, want)[:, seen].all())
    assert float((got - want).abs()[:, seen].max()) > 2e-4


def test_3xtf32_at_large_scores_against_float64():
    """Where scores reach ~30, the float32 plain version itself is ~1e-5
    off the truth (float64). The kernel's arithmetic stays within 2e-5 of
    that truth, and less than half as far from it as the plain version."""
    got, want, _, (qn, kn, vn, kw) = _case("hd256 scores to ~30")
    truth = _attention_f64(qn, kn, vn, **kw)
    err = float((got.double() - truth).abs().max())
    plain = float((want.double() - truth).abs().max())
    assert bool(_within(got.double(), truth).all()), err
    assert err < 0.5 * plain, (err, plain)


def test_s_in_one_accumulator_drifts_at_large_scores():
    """The control for S's accumulators: every pass and k-step summed in
    one, as a tile's P.V is, the 96 truncating mmas of head_dim 256 drift
    toward zero by ~1e-6 of |S|: at scores to ~30 that lands farther from
    the float64 truth than the plain float32 version, and over 4x as far
    as the kernel's accumulators."""
    one, want, _, (qn, kn, vn, kw) = _case("hd256 scores to ~30",
                                           s_chunk=None)
    got = _case("hd256 scores to ~30")[0]
    truth = _attention_f64(qn, kn, vn, **kw)
    err_one, err, plain = (float((x.double() - truth).abs().max())
                           for x in (one, got, want))
    assert err_one > plain and err_one > 4 * err, (err_one, plain, err)


def test_mma_model_cuts_toward_zero():
    """The tensor cores' sum, as modelled: exact where every term lies on
    the grid of the largest, and cut toward zero where float32 would round
    up (1 + 0.75 ulp stays 1), on either sign."""
    a = torch.zeros((1, 8))
    b = torch.zeros((8, 1))
    a[0, :3] = torch.tensor([0.5, 0.25, -0.125])
    b[:3, 0] = torch.tensor([2.0, 4.0, 8.0])
    c = torch.tensor([[3.0]])
    assert float(mma_tf32(c, a, b)) == 4.0
    a[0, :3] = torch.tensor([3 * 2.0 ** -25, 0.0, 0.0])
    b[:3, 0] = 1.0
    for sign in (1.0, -1.0):
        got = mma_tf32(torch.tensor([[sign]]), sign * a, b)
        assert float(got) == sign
        assert float(torch.tensor(sign + sign * 3 * 2.0 ** -25)) != sign


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna keeps 10 mantissa bits, rounds to nearest with
    ties away from zero on either sign, and hi + lo recovers x to 2^-22."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi, lo = split(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi + lo - r).abs() <= 2.0 ** -22 * r.abs()).all())
