"""The choice between the port's two flash kernels, and the tensor-core
kernel's numerics, on the CPU.

``flash_attention.route`` reads only the operands' metadata, so it is tested
on CPU tensors: bf16 with head_dim 64 or 128 whose views TMA can address go
to ``csrc/flash_attention_sm90.cu``; float32, other head dims, misaligned
storage and strides that are not multiples of 16 bytes go to
``csrc/flash_attention.cu``.

The CUDA kernel cannot run here, so :func:`emulate_sm90` repeats its
arithmetic in torch: bf16 operands, S = Q.K^T in f32 scaled in the log2
domain, online softmax over tiles of 128 keys (64 at head_dim 128), p split
into bf16 p_hi + p_lo for two P.V products, l floored at 1e-30. It is held
against JAX's Pallas kernel in interpret mode and against the plain version
on the f32 values, with ``chip_smoke.py``'s bf16 tolerance: 1e-3 + 8e-3 *
|want| (one bf16 rounding of the output).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def emulate_sm90(q, k, v, *, causal=True, window=None, q_offset=0,
                 split=True):
    """The tensor-core kernel's arithmetic on bf16 q (B,S,H,hd), k, v
    (B,L,Kv,hd) -> bf16 (B,S,H,hd). ``split=False`` rounds p once to bf16
    instead of splitting it."""
    b, s, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    bk = 128 if hd == 64 else 64
    qf = q.float()
    kf = k.float().repeat_interleave(h // n_kv, dim=2)
    vf = v.float().repeat_interleave(h // n_kv, dim=2)
    scale = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((b, s, h), NEG_INF)
    l = torch.zeros((b, s, h))
    o = torch.zeros((b, s, h, hd))
    qpos = torch.arange(s) + q_offset
    for k0 in range(0, lk, bk):
        kpos = torch.arange(k0, k0 + bk)
        ok = (kpos < lk)[None, :].expand(s, bk)
        if causal:
            ok = ok & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        ok = ok[None, :, None, :]
        kt = torch.zeros((b, bk, h, hd))
        vt = torch.zeros((b, bk, h, hd))
        n = min(bk, lk - k0)
        kt[:, :n], vt[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]
        sc = torch.einsum("bshd,blhd->bshl", qf, kt)
        sc = torch.where(ok, sc * scale, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(ok, torch.exp2(sc - m_new[..., None]),
                        torch.tensor(0.0))
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        o = o * alpha[..., None] + torch.einsum("bshl,blhd->bshd", p_hi, vt)
        if split:
            p_lo = (p - p_hi).bfloat16().float()
            o = o + torch.einsum("bshl,blhd->bshd", p_lo, vt)
        m = m_new
    return (o / torch.clamp_min(l, 1e-30)[..., None]).bfloat16()


def _bf16(*shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape)
                           .astype(np.float32)).bfloat16()


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def _route_cases():
    q64, k64 = _bf16(2, 16, 8, 64, seed=0), _bf16(2, 16, 2, 64, seed=1)
    q128, k128 = _bf16(1, 16, 4, 128, seed=2), _bf16(1, 16, 4, 128, seed=3)
    fused = _bf16(2, 16, 8 + 2 + 2, 64, seed=4)
    odd = _bf16(2, 16, 4, 68, seed=5)[..., :64]
    one = torch.as_strided(_bf16(16 * 4 * 64 + 8, seed=6), (1, 16, 4, 64),
                           (3, 256, 64, 1))       # batch of 1, odd stride
    wide = _bf16(1, 16, 4, 64, seed=10).expand(3, 16, 4, 64)
    return {
        "bf16 hd 64": ((q64, k64, k64), "sm90"),
        "bf16 hd 128": ((q128, k128, k128), "sm90"),
        "fused qkv view": ((fused[:, :, :8], fused[:, :, 8:10],
                            fused[:, :, 10:]), "sm90"),
        "f32": ((q64.float(), k64.float(), k64.float()), "simt"),
        "mixed dtypes": ((q64, k64.float(), k64), "simt"),
        "bf16 hd 32": ((q64[..., :32].contiguous(), k64[..., :32]
                        .contiguous(), k64[..., :32].contiguous()), "simt"),
        "bf16 hd 256": ((_bf16(1, 8, 2, 256, seed=7),) * 3, "simt"),
        "misaligned storage": ((_misaligned(q64), k64, k64), "simt"),
        "head stride of 68 elements": ((odd, odd[:, :, :2], odd[:, :, 2:]),
                                       "simt"),
        "expanded kv heads": ((q64, k64[:, :, :1].expand(2, 16, 2, 64), k64),
                              "simt"),
        "expanded batch (stride 0)": ((wide, wide[:, :, :2], wide[:, :, 2:]),
                                      "simt"),
        "odd stride on a length-1 dim": ((one, one, one), "simt"),
        "hd not the last unit stride": ((q64.transpose(1, 3).contiguous()
                                         .transpose(1, 3), k64, k64),
                                        "simt"),
    }


ROUTE_CASES = _route_cases()


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_route_picks_kernel_from_metadata(name):
    (q, k, v), want = ROUTE_CASES[name]
    assert fa.route(q, k, v) == want


def test_route_ignores_device_and_values():
    """The route is a function of dtype, head_dim, alignment and strides
    only: the same metadata with other values routes the same way."""
    q, k = _bf16(1, 8, 4, 64, seed=8), _bf16(1, 8, 2, 64, seed=9)
    assert fa.route(q, k, k) == fa.route(torch.zeros_like(q),
                                         torch.ones_like(k), k) == "sm90"


def test_ops_on_cpu_runs_plain_version_on_either_route():
    """CPU tensors never reach a kernel: both routes' inputs give the plain
    version's output, and no launch counter moves."""
    from repro_torch.kernels import ops
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    for name in ("bf16 hd 64", "f32"):
        (q, k, v), _ = ROUTE_CASES[name]
        torch.testing.assert_close(ops.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v))
    assert before == {n: k.launches for n, k in ops.KERNELS.items()}


EMU_CASES = [  # b, s, lk, h, kv, hd, causal, window, q_offset
    (1, 100, 100, 4, 4, 64, True, None, 0),     # ragged, GQA group 1
    (1, 200, 200, 4, 1, 64, True, None, 0),     # MQA, two key tiles
    (1, 130, 130, 4, 2, 128, True, None, 0),    # hd 128, 64-key tiles
    (1, 256, 256, 2, 1, 64, True, 8, 0),        # window 8
    (1, 160, 160, 4, 2, 128, True, 100, 0),     # window 100
    (1, 32, 128, 4, 4, 64, True, None, 96),     # q_offset
    (1, 64, 256, 4, 2, 64, False, None, 0),     # non-causal, L a block
]


def _close_bf16(got, want):
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    err = (got - want).abs()
    assert bool((err <= 1e-3 + 8e-3 * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_emulated_sm90_matches_pallas_interpret(case, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    b, s, lk, h, kv, hd, causal, window, q_offset = case
    q, k, v = (_bf16(b, s, h, hd, seed=s), _bf16(b, lk, kv, hd, seed=lk + 1),
               _bf16(b, lk, kv, hd, seed=lk + 2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = emulate_sm90(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    _close_bf16(got, jops.flash_attention(jq, jk, jv, **kw))
    _close_bf16(got, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             **kw))


def test_p_split_keeps_rows_with_few_keys_within_tolerance():
    """Rows that see two keys have outputs near 0 when their values cancel;
    one bf16 rounding of p then misses the tolerance there, p_hi + p_lo does
    not."""
    q, k = _bf16(1, 256, 4, 64, seed=20), _bf16(1, 256, 4, 64, seed=21)
    v = _bf16(1, 256, 4, 64, seed=22) * 4
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=2)
    tol = 1e-3 + 8e-3 * want.abs()
    split = (emulate_sm90(q, k, v, window=2).float() - want).abs()
    single = (emulate_sm90(q, k, v, window=2, split=False).float()
              - want).abs()
    assert bool((split <= tol).all())
    assert int((single > tol).sum()) > 0
    assert math.isfinite(float(split.max()))
