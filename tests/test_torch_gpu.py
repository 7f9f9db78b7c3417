"""Card-only checks of the port's CUDA kernels and of the device path.

Marked ``gpu``; each test decides at run time whether a card is present and
skips here otherwise. On a machine with an H100:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file needs neither.)

Tolerances as in ``chip_smoke.py``: kmeans_assign min_d2 1e-5 relative to
||x||^2 + max ||c||^2 and assignments exact off near-ties; recon_gate 1e-5
relative; flash_attention as stated in its tests. Each flash test asserts
which of the two flash kernels (``flash_attention.route``) launched."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(30, 1998, 32, 3), (5, 37, 11, 11),
                                   (1, 1, 4, 2)])
def test_kmeans_assign_kernel_matches_plain(dev, shape):
    n, rows, d, k = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, rows, d), generator=g, device=dev)
    c = torch.randn((n, k, d), generator=g, device=dev)
    before = ops.KERNELS["kmeans_assign"].launches
    a, m = ops.kmeans_assign(x, c)
    assert ops.KERNELS["kmeans_assign"].launches == before + 1
    ra, rm = ref.kmeans_assign_ref(x, c)
    scale = (x * x).sum(-1) + (c * c).sum(-1).amax(-1, keepdim=True)
    assert bool(((m - rm).abs() <= 1e-5 * scale + 1e-6).all())
    d2 = torch.cdist(x, c) ** 2
    top2 = torch.topk(d2, min(2, k), dim=-1, largest=False).values
    near = (top2[..., -1] - top2[..., 0]) < 1e-5 * scale + 1e-6
    assert bool(((a == ra) | near).all())


@pytest.mark.parametrize("shape", [(30, 1998, 784), (90, 40, 784),
                                   (7, 13, 10)])
def test_recon_gate_kernel_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    y = torch.rand(shape, generator=g, device=dev)
    x = torch.rand(shape, generator=g, device=dev)
    m = (torch.rand(shape[:2], generator=g, device=dev) < 0.8).float()
    m[0] = 0.0
    out = ops.recon_gate_score(y, x, m)
    want = ref.recon_gate_ref(y, x, m)
    assert float(out[0]) == 0.0
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-7)


def test_kernels_refuse_bad_inputs(dev):
    from repro_torch.kernels import kmeans_assign, recon_gate
    x = torch.zeros((2, 8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        kmeans_assign.kmeans_assign_cuda(x, x[:, :3])
    y = torch.zeros((2, 8, 4), device=dev)
    with pytest.raises(ValueError):
        recon_gate.recon_gate_cuda(y, y, torch.zeros((2, 7), device=dev))


FLASH_CASES = [  # b, s, lk, h, kv, hd, window, q_offset
    (1, 100, 100, 2, 2, 64, None, 0),      # ragged S = L
    (2, 64, 64, 8, 1, 64, None, 0),        # MQA
    (1, 128, 128, 4, 2, 32, 8, None),      # window 8
    (1, 128, 128, 4, 2, 32, 100, None),    # window 100
    (1, 32, 128, 4, 4, 32, None, 96),      # chunked prefill
    (1, 200, 200, 4, 2, 128, None, 0),
    (1, 130, 130, 2, 1, 256, None, 0),
    (2, 300, 300, 32, 8, 64, None, 0),     # the served model's heads
]


@contextlib.contextmanager
def _launched(name):
    """Asserts that the block launched kernel ``name`` once and no other."""
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    yield
    after = {n: k.launches for n, k in ops.KERNELS.items()}
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {name: 1}


def _flash_inputs(dev, b, s, lk, h, kv, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=dev)
    k = torch.randn((b, lk, kv, hd), generator=g, device=dev)
    v = torch.randn((b, lk, kv, hd), generator=g, device=dev)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    """f32: 2e-5 (the same f32 sums in another order, online softmax).
    bf16: held against the plain version on the f32 values of the same bf16
    inputs, to one bf16 rounding of the output (rtol 8e-3, atol 1e-3), since
    the kernel keeps p in f32 where the plain bf16 route rounds it."""
    b, s, lk, h, kv, hd, window, q_offset = case
    q, k, v = (t.to(dtype) for t in _flash_inputs(dev, b, s, lk, h, kv, hd))
    kw = dict(causal=True, window=window, q_offset=q_offset or 0)
    sm90 = dtype == torch.bfloat16 and hd in (64, 128)
    with _launched("flash_attention_sm90" if sm90 else "flash_attention"):
        out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 1e-3)
    torch.testing.assert_close(out.float(), want, rtol=tol[0], atol=tol[1])


def test_flash_attention_kernel_strided_and_non_causal(dev):
    """Strided views (q sliced out of a fused qkv buffer) and a non-causal
    call whose KV length is a block multiple; a padded one refuses."""
    qkv = torch.randn((2, 64, 3, 4, 64), device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with _launched("flash_attention"):
        out = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q[:, :60], k[:, :60], v[:, :60], causal=False)


def _misaligned(t):
    """A copy of t whose storage starts one element past a 16-byte line."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_misaligned_views(dev, dtype):
    """Pointers off the 16-byte line take the kernel's element-by-element
    loads; same tolerances as test_flash_attention_kernel_matches_plain."""
    q, k, v = (_misaligned(t.to(dtype))
               for t in _flash_inputs(dev, 2, 100, 100, 4, 2, 64, seed=3))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    with _launched("flash_attention"):
        out = ops.flash_attention(q, k, v, window=40)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=40)
    tol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 1e-3)
    torch.testing.assert_close(out.float(), want, rtol=tol[0], atol=tol[1])


def test_flash_attention_refuses_bad_inputs(dev):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(dev, 1, 8, 8, 2, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = (t.double() for t in _flash_inputs(dev, 1, 8, 8, 2, 2, 64))
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k, v)


SM90_CASES = [  # b, s, lk, h, kv, hd, causal, window, q_offset
    (1, 100, 100, 4, 4, 64, True, None, 0),     # GQA group 1, ragged
    (2, 300, 300, 8, 2, 64, True, None, 0),     # group 4
    (1, 257, 257, 8, 1, 64, True, None, 0),     # group 8 (MQA)
    (1, 200, 200, 4, 4, 128, True, None, 0),
    (1, 300, 300, 8, 2, 128, True, None, 0),
    (1, 256, 256, 8, 1, 128, True, None, 0),
    (1, 256, 256, 4, 2, 64, True, 8, 0),        # window
    (1, 300, 300, 4, 2, 128, True, 100, 0),
    (1, 32, 128, 4, 4, 64, True, None, 96),     # chunked prefill
    (1, 64, 200, 4, 2, 128, True, None, 136),
    (2, 256, 256, 8, 2, 64, False, None, 0),    # non-causal, L a block
    (1, 128, 512, 4, 1, 128, False, None, 0),   # multiple
]


@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_flash_attention_sm90_matches_plain(dev, case):
    """The tensor-core kernel (bf16, head_dim 64 and 128) against the plain
    version on the f32 values of the same inputs, within one bf16 rounding
    of the output (rtol 8e-3, atol 1e-3): it keeps p in f32 as p_hi + p_lo."""
    b, s, lk, h, kv, hd, causal, window, q_offset = case
    q, k, v = (t.bfloat16()
               for t in _flash_inputs(dev, b, s, lk, h, kv, hd, seed=4))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with _launched("flash_attention_sm90"):
        out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), want, rtol=8e-3, atol=1e-3)


def test_flash_attention_sm90_strided_views(dev):
    """q, k and v sliced out of one fused (B, S, H + 2 Kv, hd) buffer reach
    the tensor-core kernel through their strides; a view whose head stride
    is not a multiple of 16 bytes goes to the CUDA-core kernel."""
    buf = torch.randn((2, 300, 8 + 2 + 2, 64), device=dev).bfloat16()
    q, k, v = buf[:, :, :8], buf[:, :, 8:10], buf[:, :, 10:]
    with _launched("flash_attention_sm90"):
        out = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=8e-3, atol=1e-3)
    odd = torch.randn((2, 100, 4, 68), device=dev).bfloat16()[..., :64]
    with _launched("flash_attention"):
        out = ops.flash_attention(odd, odd[:, :, :2], odd[:, :, 2:])
    want = ref.flash_attention_ref(odd.float(), odd[:, :, :2].float(),
                                   odd[:, :, 2:].float())
    torch.testing.assert_close(out.float(), want, rtol=8e-3, atol=1e-3)


def test_flash_attention_sm90_refuses_other_inputs(dev):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(dev, 1, 8, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="flash_attention_sm90"):
        fa.flash_attention_sm90(q, k, v)                    # float32
    q, k, v = (t.bfloat16() for t in _flash_inputs(dev, 1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="flash_attention_sm90"):
        fa.flash_attention_sm90(q, k, v)                    # head_dim 32


def test_small_pipeline_card_matches_host(dev):
    from repro_torch.core import exchange as ex
    from repro_torch.core import pipeline as pl
    from repro_torch.core import qlearning as ql
    from repro_torch.models.autoencoder import AEConfig
    rng = np.random.default_rng(0)
    xs = [rng.uniform(size=(20 + i, 8, 8, 1)).astype(np.float32) * (1 + i)
          for i in range(5)]
    cfg = pl.PipelineConfig(n_pca=4, kmeans_iters=5,
                            rl=ql.RLConfig(n_episodes=30, buffer_size=10),
                            exchange=ex.ExchangeConfig(reserve_per_cluster=6))
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    host = pl.run_pipeline(xs, None, ae_cfg, cfg, device="cpu")
    card = pl.run_pipeline(xs, None, ae_cfg, cfg, draws=host.draws,
                           device=dev)
    assert torch.equal(host.in_edge, card.in_edge.cpu())
    assert torch.equal(host.lam_after, card.lam_after.cpu())
    assert (host.moved_counts == card.moved_counts).all()
