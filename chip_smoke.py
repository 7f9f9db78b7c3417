#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints ``nvcc --version``, builds every CUDA kernel of both paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and prints
   ptxas's resource lines.
2. Holds each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at edge shapes, and times both with CUDA events. Each
   flash check asserts which of the two flash kernels ``route`` sent it to.
3. Runs the pipeline, then the smoke Llama's prefill and decode, at a small
   size on the card and on the host with the same inputs: the card's run
   (kernels) must agree with the host's (plain versions, which the CPU tests
   hold against the JAX reference).
4. Drives the smart-exchange main path at full width: the paper's AE on an
   FMNIST-sized synthetic world (10 classes x 6,000 train images), N = 30
   clients, ``PipelineConfig()`` defaults, then ``fl_train`` and
   ``linear_evaluation``.
5. Drives the serving path at full width: Llama-3.2-1B (its config
   unchanged, weights drawn from a seed), batch 4, 2,048-token prompts, 32
   sampled tokens, through ``launch.serve.serve`` (bf16 activations: the
   tensor-core flash kernel); then serves the same weights with float32
   activations (the CUDA-core flash kernel) and holds that prefill's kernel
   route against its plain route.

Phases 4 and 5 set every kernel's launch count to 0 just before each run
they drive (the main path, the bf16 serve, the f32 serve) and read the
counts just after.

Prints the card's name and power limit, a JSON line of the kernels and, as
the last line, ``{"ok": true, "device": {...}}``. Any failure ends the run
with a non-zero exit code and no result line. Imports nothing of JAX.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters=50, replays=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's enqueue cost between calls (which
    ``cuda_ms`` includes when a kernel is shorter than its Python call) is
    left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def bound(bytes_moved, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kmeans(ops, ref, x, c, label):
    """Kernel vs plain on one input. Assignments must be equal except on
    rows whose two smallest d2 lie within the float32 rounding of the
    expansion (tol = 1e-5 * (||x||^2 + max ||c||^2) + 1e-6); min_d2 must
    agree within that tol. Returns the max abs error of min_d2."""
    import torch
    a, m = ops.kmeans_assign(x, c)
    ra, rm = ref.kmeans_assign_ref(x, c)
    torch.cuda.synchronize()
    x2 = torch.sum(x * x, -1)
    scale = x2 + torch.sum(c * c, -1).amax(-1, keepdim=True)
    tol = 1e-5 * scale + 1e-6
    d2 = x2[..., None] - 2.0 * (x @ c.transpose(-1, -2)) \
        + torch.sum(c * c, -1)[..., None, :]
    top2 = torch.topk(d2, min(2, c.shape[-2]), dim=-1, largest=False).values
    gap = (top2[..., 1] - top2[..., 0]) if c.shape[-2] > 1 else \
        torch.full_like(tol, float("inf"))
    bad = (a != ra)
    near = int((bad & (gap < tol)).sum())
    far = int((bad & (gap >= tol)).sum())
    err = (m - rm).abs()
    if far or bool((err > tol).any()):
        raise AssertionError(f"kmeans_assign {label}: {far} rows assigned "
                             f"apart beyond tol, max |min_d2 err| "
                             f"{float(err.max())}")
    log(f"  kmeans_assign {label}: rows {a.numel()}, near-tie mismatches "
        f"{near}, max |min_d2 err| {float(err.max()):.3e}")
    if near > max(1, a.numel() // 10000):
        raise AssertionError(f"kmeans_assign {label}: {near} near-tie "
                             "mismatches")
    return float(err.max())


def check_recon(ops, ref, y, x, m, label):
    """Kernel vs plain within rtol 1e-5, atol 1e-7 (two float32 sums of up
    to ~2,000 x 784 terms in different orders)."""
    import torch
    o = ops.recon_gate_score(y, x, m)
    r = ref.recon_gate_ref(y, x, m)
    torch.cuda.synchronize()
    err = (o - r).abs()
    if not bool((err <= 1e-7 + 1e-5 * r.abs()).all()):
        raise AssertionError(f"recon_gate {label}: max err {float(err.max())}")
    log(f"  recon_gate {label}: groups {o.numel()}, max err "
        f"{float(err.max()):.3e}")
    return float(err.max())


def check_flash(ops, ref, q, k, v, label, kernel, **kw):
    """Kernel vs plain on the same inputs. float32: rtol = atol = 2e-5 (the
    same f32 sums in another order). bfloat16: against the plain version on
    the f32 values of the same inputs within one bf16 rounding of the output
    (rtol 8e-3, atol 1e-3), and against the plain bf16 route, which rounds p
    to bf16 before p.v, within 3e-2. Returns the max abs error against the
    plain version on the f32 values. ``kernel`` names the flash kernel that
    must launch, once."""
    import torch
    before = {n: k_.launches for n, k_ in ops.KERNELS.items()}
    out = ops.flash_attention(q, k, v, **kw)
    moved = {n for n, k_ in ops.KERNELS.items()
             if k_.launches != before[n]}
    if moved != {kernel} or ops.KERNELS[kernel].launches != before[kernel] + 1:
        raise AssertionError(f"flash_attention {label}: launched {moved}, "
                             f"expected {kernel} once")
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    if q.dtype == torch.float32:
        ok = bool((err <= 2e-5 + 2e-5 * want.abs()).all())
        err_plain = err
    else:
        ok = bool((err <= 1e-3 + 8e-3 * want.abs()).all())
        err_plain = (out.float() - ref.flash_attention_ref(q, k, v, **kw)
                     .float()).abs()
        ok = ok and bool((err_plain <= 3e-2).all())
    if not ok or out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"flash_attention {label}: max err "
                             f"{float(err.max())}, against the plain "
                             f"{q.dtype} route {float(err_plain.max())}")
    log(f"  {kernel} {label}: max err {float(err.max()):.3e} (plain "
        f"{str(q.dtype)[6:]} route {float(err_plain.max()):.3e})")
    return float(err.max())


def flash_phase(torch, ops, ref, fa_mod, dev):
    """Phase 2, flash attention: both kernels against their plain version at
    the served prefills' shapes and at edge shapes, each check asserting the
    kernel that ``route`` picked; then each kernel timed at the shape of the
    prefill that launches it in phase 5 (the tensor-core one at batch 4 in
    bf16, the CUDA-core one at batch 1 in float32) beside its bound and SDPA
    as a yardstick. Returns the two kernels' rows."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(2)
    sm90, simt = "flash_attention_sm90", "flash_attention"

    def qkv(b, s, lk, h, kv, hd, dtype=torch.bfloat16):
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, s, h, hd), (b, lk, kv, hd),
                                   (b, lk, kv, hd)))

    def misaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    # the served prefill: Llama-3.2-1B, batch 4, 2,048-token prompts
    q, k, v = qkv(4, 2048, 2048, 32, 8, 64)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    err = check_flash(ops, ref, q, k, v, "served (4,2048,32,64) bf16", sm90)
    check_flash(ops, ref, q32, k32, v32, "served (4,2048,32,64) f32", simt)
    # the f32 serve's prefill: batch 1
    q32, k32, v32 = (t[:1] for t in (q32, k32, v32))
    err32 = check_flash(ops, ref, q32, k32, v32,
                        "f32 served (1,2048,32,64) f32", simt)

    # the tensor-core kernel's edges: bf16, head_dim 64 and 128
    check_flash(ops, ref, *qkv(1, 2048, 2048, 24, 8, 128),
                "Llama-3.2-3B-like (1,2048,24,128) Kv 8 bf16", sm90)
    for n in (100, 2047):
        check_flash(ops, ref, *qkv(1, n, n, 4, 2, 64),
                    f"ragged S = L = {n} bf16", sm90)
    check_flash(ops, ref, *qkv(1, 300, 300, 4, 2, 128),
                "ragged S = L = 300 hd 128 bf16", sm90)
    check_flash(ops, ref, *qkv(2, 128, 128, 8, 1, 64), "MQA Kv=1 bf16", sm90)
    for window in (8, 100):
        check_flash(ops, ref, *qkv(1, 256, 256, 4, 2, 64),
                    f"window {window} bf16", sm90, window=window)
    check_flash(ops, ref, *qkv(1, 32, 128, 4, 4, 64),
                "q_offset 96, S 32, L 128 bf16", sm90, q_offset=96)
    for hd in (64, 128):
        check_flash(ops, ref, *qkv(2, 256, 256, 8, 2, hd),
                    f"non-causal L 256 hd {hd} bf16", sm90, causal=False)
    fused = torch.randn((2, 300, 8 + 2 + 2, 64), generator=g,
                        device=dev).bfloat16()
    check_flash(ops, ref, fused[:, :, :8], fused[:, :, 8:10],
                fused[:, :, 10:], "strided fused-qkv view (H 8, Kv 2) bf16",
                sm90)

    # the CUDA-core kernel: float32, and bf16 that TMA or wgmma cannot take
    check_flash(ops, ref, *qkv(1, 100, 100, 4, 2, 64, torch.float32),
                "ragged S = L = 100 f32", simt)
    check_flash(ops, ref, *qkv(2, 128, 128, 8, 1, 64, torch.float32),
                "MQA Kv=1 f32", simt)
    for window in (8, 100):
        check_flash(ops, ref, *qkv(1, 256, 256, 4, 2, 64, torch.float32),
                    f"window {window} f32", simt, window=window)
    check_flash(ops, ref, *qkv(1, 32, 128, 4, 4, 64, torch.float32),
                "q_offset 96, S 32, L 128 f32", simt, q_offset=96)
    for hd in (32, 128, 256):
        check_flash(ops, ref, *qkv(1, 200, 200, 4, 2, hd, torch.float32),
                    f"hd {hd} f32", simt)
    for hd in (32, 256):
        check_flash(ops, ref, *qkv(1, 200, 200, 4, 2, hd),
                    f"hd {hd} bf16", simt)
    odd = torch.randn((2, 100, 4, 68), generator=g, device=dev).bfloat16()
    check_flash(ops, ref, odd[..., :64], odd[:, :, :2, :64],
                odd[:, :, 2:, :64], "strides of 68 elements bf16", simt)
    for dtype in (torch.bfloat16, torch.float32):
        # storage one element off the 16-byte line: element-by-element loads
        off = tuple(misaligned(t) for t in qkv(2, 100, 100, 4, 2, 64, dtype))
        assert all(t.data_ptr() % 16 for t in off)
        check_flash(ops, ref, *off, f"misaligned views {str(dtype)[6:]}",
                    simt)

    rows = {}
    for name, src, args, fn, peak, e in (
            (sm90, "flash_attention_sm90.cu", (q, k, v),
             fa_mod.flash_attention_sm90, BF16_FLOPS_PER_S, err),
            (simt, "flash_attention.cu", (q32, k32, v32),
             fa_mod.flash_attention_cuda, F32_FLOPS_PER_S, err32)):
        b, s, h, hd = args[0].shape
        # causal, q_offset 0, S = L: every (b, h) row i sees i + 1 keys
        flops = 4 * hd * (b * h * s * (s + 1) // 2)
        # q, k, v read once, out written once
        moved = args[0].element_size() * (2 * args[0].numel()
                                          + 2 * args[1].numel())
        b_ms, b_by = bound(moved, flops, peak)
        fast = name == sm90
        qt, kt, vt = (t.transpose(1, 2) for t in args)
        rows[name] = r = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces="src/repro/kernels/flash_attention.py:91",
            max_abs_err=e,
            ms=graph_ms(lambda: fn(*args), iters=20 if fast else 5,
                        replays=3),
            plain_ms=graph_ms(lambda: ref.flash_attention_ref(*args),
                              iters=3, replays=3),
            call_ms=cuda_ms(lambda: fn(*args), iters=50 if fast else 10),
            plain_call_ms=cuda_ms(lambda: ref.flash_attention_ref(*args),
                                  iters=5, warmup=2),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
                iters=10 if fast else 5, replays=3),
            bound_ms=b_ms, bound_by=b_by)
        log(f"  {name} {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: "
            f"{flops / 1e9:.1f} GFLOP unmasked, kernel "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s; SDPA (yardstick, never "
            f"called by the port) {r['library_ms']:.5f} ms")
    # the CUDA-core kernel on the bf16 served inputs, beside the tensor-core
    # one in the same run
    simt_bf16 = graph_ms(lambda: fa_mod.flash_attention_cuda(q, k, v),
                         iters=5, replays=3)
    log(f"  flash_attention (CUDA cores) {tuple(q.shape)} bf16: device "
        f"{simt_bf16:.5f} ms")
    return rows


def kernel_phase(torch, ops, ref, km_mod, rg_mod, dev):
    """Phase 2: every kernel against its plain version, then timed."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}

    # kmeans_assign at the main path's first Lloyd shapes: N=30 clients,
    # cap=1998 rows, d=n_pca=32, k=3 (one launch for all clients)
    x = torch.randn((30, 1998, 32), generator=g, device=dev)
    c = torch.randn((30, 3, 32), generator=g, device=dev)
    err = check_kmeans(ops, ref, x, c, "main (30,1998,32)x(30,3,32)")
    # edge shapes: ragged n and d, k > 8, the 2-D call, planted exact ties
    check_kmeans(ops, ref, torch.randn((5, 37, 11), generator=g, device=dev),
                 torch.randn((5, 11, 11), generator=g, device=dev),
                 "k=11 d=11 n=37")
    check_kmeans(ops, ref, torch.randn((1001, 32), generator=g, device=dev),
                 torch.randn((3, 32), generator=g, device=dev), "2-D n=1001")
    ct = torch.randn((4, 3, 32), generator=g, device=dev)
    ct[:, 2] = ct[:, 0]          # duplicate centroid: exact ties, 0 wins
    xt = torch.randn((4, 333, 32), generator=g, device=dev)
    a, _ = ops.kmeans_assign(xt, ct)
    if bool((a == 2).any()):
        raise AssertionError("kmeans_assign: a tie went to the later index")
    log("  kmeans_assign planted ties: first index wins")
    n_, nr, d_ = x.shape
    k_ = c.shape[1]
    b_ms, b_by = bound(4 * (x.numel() + c.numel()) + 8 * n_ * nr,
                       n_ * nr * (2 * d_ + 2 * k_ * d_ + 3 * k_))
    rows["kmeans_assign"] = dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:40",
        max_abs_err=err,
        ms=graph_ms(lambda: km_mod.kmeans_assign_cuda(x, c)),
        plain_ms=graph_ms(lambda: ref.kmeans_assign_ref(x, c)),
        call_ms=cuda_ms(lambda: km_mod.kmeans_assign_cuda(x, c), iters=200),
        plain_call_ms=cuda_ms(lambda: ref.kmeans_assign_ref(x, c), iters=200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # recon_gate at the gate's shapes: base (G=30, R=1998, P=784) and
    # candidates (G=90, R=40, P=784)
    y = torch.rand((30, 1998, 784), generator=g, device=dev)
    xb = torch.rand((30, 1998, 784), generator=g, device=dev)
    mb = (torch.rand((30, 1998), generator=g, device=dev) < 0.9).float()
    err_b = check_recon(ops, ref, y, xb, mb, "base (30,1998,784)")
    yc = torch.rand((30, 3, 40, 784), generator=g, device=dev)
    xc = torch.rand((30, 3, 40, 784), generator=g, device=dev)
    mc = (torch.rand((30, 3, 40), generator=g, device=dev) < 0.9).float()
    err_c = check_recon(ops, ref, yc, xc, mc, "candidates (30,3,40,784)")
    ye = torch.rand((7, 13, 10), generator=g, device=dev)
    xe = torch.rand((7, 13, 10), generator=g, device=dev)
    me = (torch.rand((7, 13), generator=g, device=dev) < 0.5).float()
    me[2] = 0.0
    check_recon(ops, ref, ye, xe, me, "ragged (7,13,10), empty group")
    if float(ops.recon_gate_score(ye, xe, me)[2]) != 0.0:
        raise AssertionError("recon_gate: an empty group must score 0")
    gb, rb, pb = y.shape
    b_ms, b_by = bound(8 * y.numel() + 4 * gb * rb + 4 * gb,
                       3 * y.numel() + 3 * gb * rb)
    rows["recon_gate"] = dict(
        name="recon_gate", route="cuda",
        source="src/repro_torch/csrc/recon_gate.cu",
        replaces="src/repro/kernels/recon_gate.py:43",
        max_abs_err=max(err_b, err_c),
        ms=graph_ms(lambda: rg_mod.recon_gate_cuda(y, xb, mb), iters=20),
        plain_ms=graph_ms(lambda: ref.recon_gate_ref(y, xb, mb), iters=20),
        call_ms=cuda_ms(lambda: rg_mod.recon_gate_cuda(y, xb, mb)),
        plain_call_ms=cuda_ms(lambda: ref.recon_gate_ref(y, xb, mb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    ycf, xcf, mcf = (yc.reshape(90, 40, 784), xc.reshape(90, 40, 784),
                     mc.reshape(90, 40))
    cand_bound, _ = bound(8 * ycf.numel() + 4 * 90 * 40 + 4 * 90,
                          3 * ycf.numel())
    log(f"  recon_gate candidates (90,40,784): device "
        f"{graph_ms(lambda: rg_mod.recon_gate_cuda(ycf, xcf, mcf)):.5f} ms, "
        f"plain {graph_ms(lambda: ref.recon_gate_ref(ycf, xcf, mcf)):.5f} ms; "
        f"per call {cuda_ms(lambda: rg_mod.recon_gate_cuda(ycf, xcf, mcf), 200):.5f}"
        f" ms, plain {cuda_ms(lambda: ref.recon_gate_ref(ycf, xcf, mcf), 200):.5f}"
        f" ms; bound {cand_bound:.5f} ms")
    for r in rows.values():
        log(f"  {r['name']}: device {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms; per call (host enqueue included) "
            f"{r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} ms; "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


def small_world(torch, n_clients=6):
    """A small world (8x8 images) shared by the host and card runs."""
    from repro_torch.data import make_split_dataset, partition_by_classes
    g = torch.Generator().manual_seed(0)
    tr, ev = make_split_dataset(g, n_train_per_class=30, n_eval_per_class=6,
                                height=8, width=8, channels=1)
    xs, ys, _ = partition_by_classes(0, tr.images.numpy(), tr.labels.numpy(),
                                     n_clients=n_clients,
                                     classes_per_client=3, circular=True)
    return xs, ys, ev


def reference_phase(torch, dev):
    """Phase 3: the card's run agrees with the host's plain-version run."""
    from repro_torch.core import exchange as ex
    from repro_torch.core import pipeline as pl
    from repro_torch.core import qlearning as ql
    from repro_torch.fl import FLConfig, fl_train
    from repro_torch.fl.trainer import draw_batch_indices
    from repro_torch.models.autoencoder import AEConfig, init_ae
    xs, ys, ev = small_world(torch)
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    cfg = pl.PipelineConfig(n_pca=4, kmeans_iters=5,
                            rl=ql.RLConfig(n_episodes=40, buffer_size=10),
                            exchange=ex.ExchangeConfig(reserve_per_cluster=8))
    host = pl.run_pipeline(xs, ys, ae_cfg, cfg, device="cpu")
    card = pl.run_pipeline(xs, ys, ae_cfg, cfg, draws=host.draws, device=dev)
    for name in ("in_edge", "lam_before", "lam_after"):
        a, b = getattr(host, name), getattr(card, name).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"small run: {name} differs\n{a}\n{b}")
    if not (host.moved_counts == card.moved_counts).all():
        raise AssertionError(f"small run: moved {host.moved_counts} vs "
                             f"{card.moved_counts}")
    # scores: 5e-4 relative covers cuDNN's convolution sums against the
    # host's (TF32 is off)
    for name in ("base", "scores"):
        a = getattr(host.exchange, name)
        b = getattr(card.exchange, name).cpu()
        if not torch.allclose(a, b, rtol=5e-4, atol=1e-6):
            raise AssertionError(f"small run: gate {name} differ\n{a}\n{b}")
    fl_cfg = FLConfig(total_iters=20, tau_a=10, batch_size=8, eval_every=10)
    gen = torch.Generator().manual_seed(5)
    init = init_ae(gen, ae_cfg)
    idx = draw_batch_indices(gen, host.client_data.sizes, fl_cfg, 2)
    fh = fl_train(host.client_data, ae_cfg, fl_cfg, ev.images,
                  init_params=init, batch_idx=idx, device="cpu")
    fc = fl_train(card.client_data, ae_cfg, fl_cfg, ev.images,
                  init_params=init, batch_idx=idx, device=dev)
    # 1e-3 relative: 20 Adam steps on convolution gradients summed in
    # different orders on the two devices
    if not torch.allclose(torch.as_tensor(fh.eval_loss),
                          torch.as_tensor(fc.eval_loss), rtol=1e-3):
        raise AssertionError(f"small run: FL eval {fh.eval_loss} vs "
                             f"{fc.eval_loss}")
    log(f"  small run agrees: in_edge {host.in_edge.tolist()}, moved "
        f"{host.moved_counts.tolist()}, lam mean "
        f"{host.lam_before.float().mean():.3f} -> "
        f"{host.lam_after.float().mean():.3f}, FL eval "
        f"{fh.eval_loss.tolist()}")


def transformer_reference_phase(torch, ops, dev):
    """Phase 3, transformer: the smoke Llama (2 layers, d_model 256, vocab
    512) with the same parameters and tokens; prefill logits through the
    kernel on the card against the plain route on the host, then 8
    teacher-forced decode steps. Tolerances, absolute on logits of size ~1:
    float32 1e-4 (f32 sums in other orders); bfloat16 3e-2 (the kernel keeps
    p in f32 where the plain route rounds it to bf16, and bf16 activations
    round at other places on the two devices). The f32 prefill runs the
    CUDA-core flash kernel, the bf16 one the tensor-core kernel (head_dim
    64)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    for dtype, tol, kernel in (("float32", 1e-4, "flash_attention"),
                               ("bfloat16", 3e-2, "flash_attention_sm90")):
        flash = ops.KERNELS[kernel]
        cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype=dtype)
        model = build_model(cfg)
        host_p = model.init(torch.Generator().manual_seed(0), device="cpu")
        card_p = tree_map(lambda a: a.to(dev), host_p)
        toks = torch.randint(0, cfg.vocab_size, (2, 48),
                             generator=torch.Generator().manual_seed(1))
        hl, hc = model.prefill(host_p, {"tokens": toks[:, :40]}, max_len=48)
        before = flash.launches
        cl, cc = model.prefill(card_p, {"tokens": toks[:, :40].to(dev)},
                               max_len=48, use_flash=True)
        if flash.launches != before + cfg.n_layers:
            raise AssertionError(f"small {dtype} prefill did not launch "
                                 f"{kernel} once per layer")
        errs = [float((cl.cpu() - hl).abs().max())]
        for t in range(40, 48):
            hl, hc = model.decode(host_p, hc, {"token": toks[:, t:t + 1]})
            cl, cc = model.decode(card_p, cc,
                                  {"token": toks[:, t:t + 1].to(dev)})
            errs.append(float((cl.cpu() - hl).abs().max()))
        if max(errs) > tol:
            raise AssertionError(f"small transformer {dtype}: logits differ "
                                 f"by {errs} (tol {tol})")
        log(f"  small transformer {dtype} agrees: prefill max err "
            f"{errs[0]:.3e}, decode max err {max(errs[1:]):.3e} "
            f"(|logits| <= {float(hl.abs().max()):.3f})")


def device_profile(torch, label, fn):
    """Runs ``fn`` once under ``torch.profiler`` and prints its wall time
    (ending in a device sync, profiler overhead included), the device's busy
    time (the sum of its kernel, copy and set durations: one stream, so they
    do not overlap), the count of device events and the kernels with the
    most device time. Returns fn's result and the busy ms (None when the
    profiler saw no device events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log(f"  profile {label}: wall {wall:.2f} ms; device time not "
            "measured (the profiler saw no device events)")
        return out, None
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    log(f"  profile {label}: wall {wall:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms over {len(events)} device events")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return out, busy


def serve_phase(torch, ops, dev):
    """Phase 5: Llama-3.2-1B served at full width; returns the launch counts
    of the bf16 serve and of the f32 serve."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    batch, prompt, gen = 4, 2048, 32
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                           device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {model.n_params():,} parameters "
        f"({cfg.param_dtype}), drawn in {time.perf_counter() - t0:.2f} s")
    serve(model, params, tokens, 2, generator=g, device=dev)   # warm-up

    for k in ops.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve(model, params, tokens, gen, temperature=1.0, generator=g,
                device=dev)
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the same weights served with float32 activations, batch 1: the
    # CUDA-core flash kernel
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    serve(m32, params, tokens[:1], 2, generator=g, device=dev)   # warm-up
    for k in ops.KERNELS.values():
        k.launches = 0
    res32 = serve(m32, params, tokens[:1], 2, generator=g, device=dev)
    launches32 = {name: k.launches for name, k in ops.KERNELS.items()}

    # its prefill's kernel route against its plain route; one decode step
    lk, cache = m32.prefill(params, {"tokens": tokens[:1]}, use_flash=True,
                            max_len=prompt + 1)
    lp, _ = m32.prefill(params, {"tokens": tokens[:1]}, use_flash=False)
    n0 = {name: k.launches for name, k in ops.KERNELS.items()}
    m32.decode(params, cache, {"token": tokens[:1, :1]})
    decode_launches = sum(k.launches - n0[name]
                          for name, k in ops.KERNELS.items())
    err32 = float((lk - lp).abs().max())
    scale = float(lp.abs().max())

    toks = res.tokens
    others = ("kmeans_assign", "recon_gate")
    checks = {
        "bf16 serve: flash_attention_sm90 launched 16 times (once per layer"
        " of the prefill, none in decode)":
            launches["flash_attention_sm90"] == cfg.n_layers,
        "bf16 serve: no other kernel launched":
            launches["flash_attention"] == 0
            and all(launches[n] == 0 for n in others),
        "f32 serve: flash_attention launched 16 times, no other kernel":
            launches32["flash_attention"] == cfg.n_layers
            and launches32["flash_attention_sm90"] == 0
            and all(launches32[n] == 0 for n in others),
        "f32 decode step launched no kernel": decode_launches == 0,
        f"tokens ({batch}, {gen}) in [0, vocab)":
            tuple(toks.shape) == (batch, gen)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "prefill logits finite": bool(torch.isfinite(res.logits).all())
            and tuple(res.logits.shape) == (batch, 1, cfg.vocab_size)
            and bool(torch.isfinite(res32.logits).all()),
        # f32: the routes differ only in the order of attention's f32 sums
        "f32 kernel route agrees with the plain route within 1e-3":
            err32 <= 1e-3,
    }
    steps = gen - 1
    log(f"  prefill {batch}x{prompt}: {res.prefill_s * 1e3:.2f} ms "
        f"({batch * prompt / res.prefill_s:.0f} tok/s)")
    log(f"  decode {steps} steps x {batch} seqs: {res.decode_s * 1e3:.2f} ms "
        f"({steps * batch / res.decode_s:.0f} tok/s, "
        f"{res.decode_s * 1e3 / steps:.3f} ms per step)")
    log(f"  peak device memory {peak:.2f} GiB")
    log(f"  f32 last-token logits, kernel vs plain route: max err "
        f"{err32:.3e} (|logits| <= {scale:.3f})")
    log(f"  f32 serve, prefill 1x{prompt}: {res32.prefill_s * 1e3:.2f} ms")
    log(f"  sampled tokens[0][:8] {toks[0, :8].tolist()}")
    log(f"  launches, bf16 serve {launches}; f32 serve {launches32}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving checks failed: {failed}")

    # where the served path's device time goes, and how idle the card is
    (_, cache), busy = device_profile(
        torch, f"prefill {batch}x{prompt}", lambda: model.prefill(
            params, {"tokens": tokens}, max_len=prompt + gen, use_flash=True))
    if busy is not None:
        log(f"  prefill device idle share {1 - busy / (res.prefill_s * 1e3):.3f}"
            f" of the unprofiled prefill's {res.prefill_s * 1e3:.2f} ms")
    _, busy = device_profile(torch, "one decode step", lambda: model.decode(
        params, cache, {"token": toks[:, :1]}))
    if busy is not None:
        step = res.decode_s * 1e3 / steps
        log(f"  decode device idle share {1 - busy / step:.3f} of the "
            f"unprofiled serve loop's {step:.3f} ms per step")
    return launches, launches32


def main_path(torch, ops, dev):
    """Phase 4: the full-width main path; returns the launch counts."""
    from repro_torch.core.pipeline import PipelineConfig, run_pipeline
    from repro_torch.data import fmnist_like_split, partition_by_classes
    from repro_torch.fl import FLConfig, fl_train, linear_evaluation
    from repro_torch.models.autoencoder import AEConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    train, ev = fmnist_like_split(gen, n_train_per_class=6000,
                                  n_eval_per_class=30)
    xs, ys, _ = partition_by_classes(0, train.images.cpu().numpy(),
                                     train.labels.cpu().numpy(),
                                     n_clients=30, classes_per_client=3,
                                     circular=True)
    torch.cuda.synchronize()
    log(f"  world: {sum(x.shape[0] for x in xs)} images over {len(xs)} "
        f"clients, eval {ev.images.shape[0]}; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    ae_cfg = AEConfig()
    cfg = PipelineConfig()

    for k in ops.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_pipeline(xs, ys, ae_cfg, cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl_cfg = FLConfig(total_iters=20, tau_a=10, batch_size=64, eval_every=10)
    fl = fl_train(res.client_data, ae_cfg, fl_cfg, ev.images, generator=gen,
                  device=dev)
    torch.cuda.synchronize()
    t_fl = time.perf_counter() - t0
    t0 = time.perf_counter()
    half = ev.images.shape[0] // 2
    acc, acc_tr = linear_evaluation(fl.global_params, ae_cfg,
                                    ev.images[:half], ev.labels[:half],
                                    ev.images[half:], ev.labels[half:],
                                    device=dev)
    t_le = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}

    n = 30
    moved = res.moved_counts
    sizes = res.client_data.sizes.cpu()
    in_edge = res.in_edge.cpu()
    checks = {
        "in_edge is a graph without self links":
            in_edge.shape == (n,) and bool((in_edge != torch.arange(n)).all())
            and bool(((in_edge >= 0) & (in_edge < n)).all()),
        "sizes grew by the moved counts":
            torch.equal(sizes, torch.full((n,), 1998) + torch.as_tensor(moved)),
        "lambda shapes": tuple(res.lam_before.shape) == (n, n)
            and tuple(res.lam_after.shape) == (n, n),
        "exchanged data is finite":
            bool(torch.isfinite(res.client_data.data).all()),
        "centroids (30, 3, 32) finite":
            tuple(res.centroids.shape) == (n, 3, 32)
            and bool(torch.isfinite(res.centroids).all()),
        "eval losses finite": len(fl.eval_loss) == 2
            and all(math.isfinite(v) for v in fl.eval_loss),
        "accuracy in [0, 1]": 0.0 <= acc <= 1.0,
        "kmeans_assign launched 50 times": launches["kmeans_assign"] == 50,
        "recon_gate launched 2 times": launches["recon_gate"] == 2,
    }
    for name, val in res.stage_seconds.items():
        log(f"  stage {name}: {val:.3f} s")
    log(f"  run_pipeline {t_pipe:.3f} s, fl_train (2 rounds) {t_fl:.3f} s, "
        f"linear_evaluation {t_le:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  moved_counts {moved.tolist()}")
    log(f"  lambda mean before {res.lam_before.float().mean():.4f} after "
        f"{res.lam_after.float().mean():.4f}")
    log(f"  eval loss {fl.eval_loss.tolist()} at iters "
        f"{fl.eval_iters.tolist()}; linear-eval accuracy test {acc:.4f} "
        f"train {acc_tr:.4f}")
    log(f"  launches {launches}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import kmeans_assign as km_mod
    from repro_torch.kernels import recon_gate as rg_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("== phase 1: build")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("  " + " / ".join(line.strip() for line in nvcc[-2:]))
    t0 = time.perf_counter()
    _build.build_all(list(ops.KERNELS.values()))
    log(f"  built {list(ops.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for k in ops.KERNELS.values():
        for line in k.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  [{k.name}] {line.strip()}")

    log("== phase 2: kernels against their plain versions")
    rows = kernel_phase(torch, ops, ref, km_mod, rg_mod, dev)
    flash_rows = flash_phase(torch, ops, ref, fa_mod, dev)
    rows.update(flash_rows)
    for r in flash_rows.values():
        log(f"  {r['name']}: device {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms; per call {r['call_ms']:.5f} ms, plain "
            f"{r['plain_call_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); SDPA {r['library_ms']:.5f} ms")

    log("== phase 3: small runs, card against host")
    reference_phase(torch, dev)
    transformer_reference_phase(torch, ops, dev)

    log("== phase 4: smart-exchange main path at full width")
    launches = main_path(torch, ops, dev)

    log("== phase 5: serving Llama-3.2-1B at full width")
    served, served32 = serve_phase(torch, ops, dev)
    launches["flash_attention_sm90"] = served["flash_attention_sm90"]
    launches["flash_attention"] = served32["flash_attention"]
    log(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s")

    for name, row in rows.items():
        row["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
