#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the main path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and prints ptxas's resource lines.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes, and times both with CUDA events.
3. Runs the pipeline at a small size on the card and on the host with the
   same draws: the card's run (kernels) must agree with the host's (plain
   versions, which the CPU tests hold against the JAX reference).
4. Drives the main path at full width: the paper's AE on an FMNIST-sized
   synthetic world (10 classes x 6,000 train images), N = 30 clients,
   ``PipelineConfig()`` defaults, then ``fl_train`` and
   ``linear_evaluation``, with every kernel's launch count set to 0 just
   before and read just after.

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


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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
    from repro_torch.kernels import kmeans_assign as km_mod
    from repro_torch.kernels import recon_gate as rg_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("== phase 1: build")
    t0 = time.perf_counter()
    _build.build_all(list(ops.KERNELS.values()))
    log(f"  built {list(ops.KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for k in ops.KERNELS.values():
        for line in k.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  [{k.name}] {line.strip()}")

    log("== phase 2: kernels against their plain versions")
    rows = kernel_phase(torch, ops, ref, km_mod, rg_mod, dev)

    log("== phase 3: small run, card against host")
    reference_phase(torch, dev)

    log("== phase 4: main path at full width")
    launches = main_path(torch, ops, dev)

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
