#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints ``nvcc --version``, builds every CUDA kernel of both paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and prints
   ptxas's resource lines.
2. Holds each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at edge shapes, and times both with CUDA events. Each
   flash check asserts which of the two flash kernels ``route`` sent it to.
   ``kmeans_assign`` is checked and timed at four shapes: (a) the main
   path's, (b) ``benchmarks/kernel_bench.py``'s 2-D one, (c) d = 4 and (d)
   d = 1024, k = 256; each warm (the same inputs every call) and cold (calls
   cycling through copies more than the L2 apart), beside the CUDA graph's
   per-launch floor, which no kernel design can remove. The tensor-core
   flash kernel is also checked and timed at recurrentgemma-2b's local
   attention (q (4, 4096, 10, 256), k/v (4, 4096, 1, 256) bf16, window
   2,048), beside its bound and one SDPA call with the window as a boolean
   mask, and the 3xTF32 kernel is timed there too. The 3xTF32 kernel is
   checked and timed at the five float32 prefills' shapes of phases 5 and
   10-12 (``F32_FLASH``) and held to float64 attention where q drawn x 4
   makes scores reach ~20-25.
3. Runs the pipeline, then the smoke Llama's prefill and decode, then
   recurrentgemma-2b reduced to 4 layers (a prompt longer than its window)
   and xlstm-125m's smoke config, at a small size on the card and on the
   host with the same inputs: the card's run (kernels) must agree with the
   host's (plain versions, which the CPU tests hold against the JAX
   reference).
4. Drives the smart-exchange main path at full width: the paper's AE on an
   FMNIST-sized synthetic world (10 classes x 6,000 train images), N = 30
   clients, ``PipelineConfig()`` defaults, then ``fl_train`` and
   ``linear_evaluation``.
5. Drives the serving path at full width: Llama-3.2-1B (its config
   unchanged, weights drawn from a seed), batch 4, 2,048-token prompts, 32
   sampled tokens, through ``launch.serve.serve`` (bf16 activations: the
   tensor-core flash kernel); then serves the same weights with float32
   activations (the 3xTF32 flash kernel) and holds that prefill's kernel
   route against its plain route.
6. Drives the online orchestrator: (a) ``run_orchestrator`` at full width
   on phase 4's world, scenario ``burst-outage``, 5 segments of 20 FL
   iterations with an RL burst, a re-exchange and retries every segment,
   printing each segment's seconds, stages and metrics; then holds both
   kernels against their plain versions at the shapes that run grew to,
   and runs a copy of the scenario whose burst hits every link, where the
   retry exchange must run; (b) a small run on
   the card against the host from the same draws; (c) a small run killed
   at segment 2 and resumed from its checkpoint on the card, bit-identical
   to the uninterrupted run.
7. Trains and runs the federated-LLM example: (a) Llama-3.2-1B (its config
   unchanged, weights drawn from seed 0) through ``launch.train.main``:
   AdamW at 3e-4, 2 warmup steps, block remat; 10 steps at 4 x 2,048
   tokens (the plain attention route), then 3 at 2 x 4,096 (the chunked
   route), each step writing the parameters and moments in place,
   printing every step (loss, grad norm, lr, seconds) and per shape the
   median step seconds after the first, tokens/s, the model FLOPs' share
   of 989 TFLOP/s and the peak; the lr must rise over the warmup and no
   hand kernel may launch, as training follows the JAX package's routes;
   (b)
   ``examples.federated_llm`` at the example's size, which must launch
   ``kmeans_assign`` 25 times, then the kernel against its plain version
   at that run's shape (6, 64, 16) x (6, 2, 16), and both timed there;
   (c) 3 training steps of
   the smoke Llama in float32 on the card against the host.
8. Drives the scan engine and the other modules of the fifth slice: (a)
   ``run_orchestrator`` at full width on phase 4's world, ``burst-outage``,
   5 segments of 20 FL iterations, the exchange with channel failures,
   ``overflow="drop"`` and the device reserve selector, retries off, once
   with ``segment_impl="eager"`` and once with ``"scan"`` from the same
   draws (segments 1-4 are one chunk): graphs and counts exact, eval losses
   within 5e-4, equal kernel launch counts; prints each run's seconds, the
   chunk's, the peaks, and every synchronizing call made inside the chunk
   under ``torch.cuda.set_sync_debug_mode("warn")``, by op; none may come
   from the port's own code; (b) the scan at phase 6's small size with
   retries on and ``checkpoint_every=2`` on the every-link copy of
   ``burst-outage``: killed at segment 2 and resumed, bit-identical, with
   a retry drained at a chunk boundary; (c) the one-shot main path on a
   CIFAR-like world (5,000 train images per class, N = 30, the AE of
   ``benchmarks/common.py``), then ``recon_gate`` against its plain
   version at that run's (30, cap, 3072) shape, both timed there; (d)
   ``cluster_clients_loop`` and ``wcss_elbow`` on phase 3's small world,
   card against host, counting ``kmeans_assign``'s 2-D launches, then the
   kernel against its plain version at that 2-D shape (f), both timed.
9. Drives the observability plane (``repro_torch.obs``): (a) phase 6's
   full-width ``burst-outage`` run under ``obs.enable`` with a manifest at
   ``runs/obs/chip_online.jsonl``, printing the per-phase report and
   asserting the span counts the config implies, one transfer (inside
   ``metrics-materialize``), no compile, phase 6's launch counts, graphs,
   moved and retry counts, and eval losses within 5e-4 relative; (b)
   phase 8 (a)'s scan run traced (``runs/obs/chip_scan.jsonl``): one
   ``scan-chunk`` span at the bounds ``chunk_seconds`` reports, no named
   span inside it, one transfer, phase 8's launch counts; (c) both runs
   again under ``obs.maybe_profile`` (``runs/obs/profile/<tag>/``), and
   from each Chrome trace the device's busy ms, idle share and top kernels
   over the online run and over the scan chunk; (d) the disabled tracer's
   cost: 10^6 disabled spans timed on the host, times (a)'s span count,
   must be under 1% of (a)'s seconds.
10. Serves the recurrent families at full width through
   ``launch.serve.serve``: recurrentgemma-2b (26 layers, d_model 2,560) at
   batch 4 with 4,096-token prompts, whose 8 local-attention layers must
   launch the tensor-core flash kernel once each per prefill (the CUDA-core
   one with float32 activations), and xlstm-125m
   (12 layers, d_model 768) at batch 4 with 2,048-token prompts, which
   launches no kernel; 32 sampled tokens each, weights drawn from seed 0.
   Prints prefill ms, decode ms per step, the peak, the prefill's last
   logits against the plain route's on the card (recurrentgemma also with
   float32 activations, where the routes must agree within 1e-3) and one
   profiled decode step's device idle share.
11. Serves the MoE family at full width through ``launch.serve.serve``:
   (a) qwen2-moe-a2.7b (its config unchanged: 24 layers, d_model 2,048, 60
   experts top-4 and 4 shared, capacity factor 1.25, the einsum dispatch;
   14,315,587,584 float32 parameters from seed 0) at batch 4, 2,048-token
   prompts, 32 tokens, whose prefill must launch the tensor-core flash
   kernel once a layer and decode nothing; the draw's and the serve's
   peaks, a profiled prefill and decode step, and the share of layer 0's
   (token, expert) choices the capacity dropped; (b) that prefill in
   float32 (the 3xTF32 kernel) and in bf16 through the kernel route and
   the plain route, and the plain route again with its routing pinned to
   the kernel route's: pinned, the f32 routes within 1e-3 and the bf16
   ones within 0.3; as served, their distance and the routing flips
   between them, and both bf16 routes' distance from the f32 logits, are
   printed as readings; (d) layer 0's MoE on its served input in float32 with
   nothing dropped, the gather dispatch (one group, groups of 2,048)
   against the einsum dispatch within 1e-4 relative; (c)
   phi3.5-moe-42b-a6.6b and moonshot-v1-16b-a3b at full width cut to 8
   layers (their full depths do not fit one card in float32), at 4 x 2,048
   + 8 tokens, each prefill launching the tensor-core kernel 8 times.
   Phase 2 also checks and times the tensor-core kernel at qwen2-moe's
   attention (q/k/v (4, 2048, 16, 128) bf16, MHA), checks it at
   phi3.5-moe's (q (4, 2048, 32, 128), k/v (4, 2048, 8, 128) bf16) and the
   CUDA-core kernel at (b)'s float32 shape (4, 2048, 16, 128); phase 3
   runs the smoke qwen2-moe in float32, card against host.
12. Serves the vision-stub and audio-codec families through
   ``launch.serve.serve``: (a) qwen2-vl-72b at full width cut to 8 of its
   80 layers (9,523,306,496 float32 parameters, 35.48 GiB; full depth is
   270.89 GiB) at batch 4 on 2,048-token prompts (256 bf16 patch
   embeddings of width 1,280 ahead of 1,792 text tokens, with Qwen2-VL's
   (t, h, w) position grid, so M-RoPE's three streams differ) + 32 tokens;
   (c) musicgen-medium at full depth (48 layers, 4 codebooks of 2,048;
   1,837,254,144 parameters) at batch 4 on 1,500-frame prompts + 32
   frames. Each prefill must launch the tensor-core flash kernel once a
   layer (8, 48) and a decode step nothing; prefill ms, decode ms a step,
   the draw's and the serve's peaks, a profiled prefill and decode step;
   (b) each prefill's bf16 kernel route against its plain route (printed),
   and the f32 routes at batch 1 (the 3xTF32 kernel) within 1e-3, the
   bf16 kernel route at most 3e-2 farther from those f32 logits than the
   bf16 plain route. Phase 2 also checks and times the tensor-core kernel
   at qwen2-vl's attention (q (4, 2048, 64, 128), k/v (4, 2048, 8, 128),
   GQA group 8) and musicgen's (q/k/v (4, 1500, 24, 64), MHA) and checks
   the 3xTF32 kernel at their float32 batch-1 shapes; phase 3 runs the
   smoke qwen2-vl (distinct position streams) and the smoke musicgen in
   float32, card against host.
13. Trains the MoE, vision, audio and recurrent families: (a) 3 float32
   AdamW steps with block remat of each smoke config (qwen2-moe's einsum
   dispatch with every router call's top-2 margin above 1e-5 on both
   sides, qwen2-vl on Qwen2-VL's grid, musicgen, xlstm over 300 positions,
   recurrentgemma cut to 4 layers past its window) on the card and on the
   host from the same weights and batches, losses and grad norms within
   1e-5 relative; (b) at full width with bf16 activations and float32
   parameters, AdamW with the parameters and moments written in place, a
   warm-up step and 3 timed steps each: qwen2-moe-a2.7b cut to 4 of 24
   layers at 2 x 2,048, qwen2-vl-72b cut to 1 of 80 layers at 1 x 2,048
   (64 patches on an 8 x 8 grid, 1,984 text tokens), and recurrentgemma-2b
   at 1 x 2,048 and musicgen-medium at 4 x 1,500 frames at full depth
   through ``launch.train.main``: each step's loss, grad norm, lr and
   seconds, the median step, tokens/s, the model FLOPs' share of 989
   TFLOP/s, the peak and a profiled step; finite losses, a rising lr and
   no hand-kernel launch asserted (phase 7 (a)'s reporter; the depths:
   ``FAMILY_FULL``); (c) ``examples.train_e2e --quick --steps
   100`` (full xlstm-125m), whose own rule (the last 10 steps' mean loss
   below the first 10's) must hold, with its seconds, tokens/s and peak.
14. Drives the last entry points: (a) ``examples.quickstart`` at its full
   size on the card, through ``kmeans_assign`` (50 launches) and
   ``recon_gate`` (2), held to the same quickstart on the host from the
   same draws (``quickstart_phase``), with its seconds, peak and the three
   signs of a healthy run; (b) moonshot-v1-16b-a3b at full width and all
   48 layers with bf16 parameters (the ``bf16_params`` variant) served at
   4 x 2,048 + 8 tokens (48 ``flash_attention_sm90`` launches a prefill),
   and on an 8-layer cut its bf16-parameter logits held to the
   f32-parameter ones within one bf16 ulp with the routing pinned; (c)
   ``launch.dryrun``'s count of the steps the smoke times (phase 5's
   prefill, phase 7's 4 x 2,048 train step, (b)'s prefill) at their own
   shapes, each roofline bound beside the measured time, and the train
   step's counted peak held to the card's within 5%.
15. Drives the sharded client plane (``repro_torch.sharding``) on a
   one-rank NCCL group (a ``HashStore``) and its one-rank "data" mesh:
   (a) ``meshlab.parity_report`` at the lab size on the card, every digest
   of the mesh-1 run (pretrain, gate, FL, cluster, the three discovery
   bursts) equal to ``rules=None``'s, and the lab's clustering and gate
   launching ``kmeans_assign`` and ``recon_gate`` as often with the rules
   as without; (b) phase 4's main path with the mesh-1 rules (its
   ``in_edge``, moved counts, gate decisions and both lambda matrices held
   to phase 4's, the kernels' launches too; each stage's seconds printed
   beside a warm unsharded run's and phase 4's; the FL global parameters
   within 1e-5 of an unsharded FL on the same data with
   ``cudnn.deterministic``, and of phase 4's unless two unsharded runs in
   cuDNN's default mode differ by more, both gaps printed); (c) phase
   6's ``burst-outage`` run with the mesh-1 rules (each segment's
   ``in_edge`` and moved held to phase 6's, its seconds printed beside
   them). Each part counts every ``torch.distributed`` call and fails if
   one ran: over a one-rank client axis every collective is the identity.
   The kernels get local CUDA tensors, never a DTensor; the phase
   destroys its process group.
16. Drives the model plane (``models.transformer`` under ``rules=``):
   (a) on a one-rank NCCL mesh from ``launch.mesh.host_rules``,
   Llama-3.2-1B at full width and depth served (4 x 2,048 prompt, 32
   decode steps, one Gumbel draw) and trained (3 donated AdamW steps at
   2 x 2,048) once with ``rules=None`` and once under the rules: logits,
   tokens, losses and final parameters equal bit for bit, 16
   ``flash_attention_sm90`` launches, each run's seconds printed, and no
   collective run by a prefill, a decode step or a train step (a one-rank
   axis's collectives are the identity); (b)
   both flash kernels at Llama's per-rank heads for model 2, 4 and 16
   against the plain version, timed; (c) the KV_SEQ decode combine
   (``attention.decode_attention_kv_seq``) over 16 slices of a 4 x 2,080
   cache, one thread a slice, against ``decode_attention``; (d) the dry
   run of Llama-3.2-1B's four shapes on both production meshes.
17. The MoE family on the model plane: qwen2-moe-a2.7b at full depth
   served and trained at 4 of 24 layers, moonshot's 8-layer cut with the
   gather dispatch served, each on a one-rank NCCL mesh against
   ``rules=None`` bit for bit; the tensor-core flash kernel at
   qwen2-moe's per-rank heads; the dry run of two MoE steps.
18. The recurrent families on the model plane, on a one-rank NCCL mesh
   against ``rules=None`` from one parameter tree: (a) recurrentgemma-2b
   at full width and depth served at 4 x 4,096 + 32 tokens (8
   ``flash_attention_sm90`` launches a prefill, nothing else) and
   trained at phase 13's cut (26 layers, 1 x 2,048, 3 donated AdamW
   steps); (b) xlstm-125m served at 4 x 2,048 + 32 (no launch) and
   trained at 2 x 64; logits, tokens, losses and final parameters bit for
   bit, no collective; (c) the tensor-core flash kernel at
   recurrentgemma's per-rank local attention for model 2, 4 and 16 (5, 3
   and 1 of its 10 query heads, window 2,048) against the plain version,
   timed beside its bound and one SDPA call.
19. The vision and audio frontends on the model plane, on a one-rank NCCL
   mesh against ``rules=None`` from one parameter tree: (a) qwen2-vl-72b
   at full width cut to 8 of 80 layers served at phase 12's 4 x 2,048
   (256 bf16 patches on Qwen2-VL's grid positions) + 32 tokens (8
   ``flash_attention_sm90`` launches a prefill, nothing else) and trained
   at phase 13's cut (1 layer, 1 x 2,048, 3 donated AdamW steps); (b)
   musicgen-medium at full depth served at 4 x 1,500 frames + 32 (48
   launches a prefill) and trained at 4 x 1,500; logits, tokens, losses
   and final parameters bit for bit, no collective; (c) the tensor-core
   flash kernel at both models' per-rank attention for model 2, 4 and 16
   against the plain version, timed beside its bound and one SDPA call;
   (d) the dry run of musicgen-medium served at 1,500 + 32 frames on one
   rank of 16 x 16, whose 1,532-slot cache the model axis does not divide:
   the cache lies whole on every rank and a decode step counts no softmax
   combine (its collectives over "model" asserted, the rank's bytes
   printed).

Phases 4, 5, 6 (a), 7 (a, b), 8 (a, c, d), 9 (a, b), 10, 11, 12, 13
(b, c), 14 (a, b), 15 (a, b, c), 16 (a), 17 (a, b), 18 (a, b) and 19 (a,
b) set every
kernel's launch count to 0
just before each run they drive
(the main path, the bf16 serve, the f32 serve, the two online runs, the two
training runs, the federated-LLM run, the eager and scan runs, the
CIFAR-like main path, the clustering loop on the card, the traced online
and scan runs, the two recurrent serves, the three MoE serves, the vision
and audio serves, the four family training runs, train_e2e, the quickstart
and the full-depth moonshot serve) and read the counts just after. Before
the main path, each serve, each online run and each training run they reset the
peak-memory counter and print what is allocated then; each peak is printed
absolute and above that allocation.

Prints the card's name and power limit, a JSON line of the kernels (with
each kernel's launches on the main path and, as ``online_launches``, on the
``burst-outage`` run, as ``train_launches`` in phase 7 (a) and as
``federated_llm_launches`` in phase 7 (b), as ``scan_launches`` and
``cifar_launches`` in phase 8 (a, c), as ``traced_online_launches`` and
``traced_scan_launches`` in phase 9 (a, b), as
``recurrentgemma_serve_launches`` and ``xlstm_serve_launches`` in phase 10,
as ``qwen2_moe_serve_launches``, ``phi35_moe_serve_launches`` and
``moonshot_serve_launches`` in phase 11, as ``qwen2_vl_serve_launches``
and ``musicgen_serve_launches`` in phase 12, as ``family_train_launches``
(per arch, train_e2e's under xlstm-125m) in phase 13, as
``quickstart_launches`` and ``moonshot_full_serve_launches`` in phase 14,
as ``client_plane_launches`` (its lab, main path and online runs) in phase
15, as ``model_plane_launches`` in phase 16 (a), ``moe_plane_launches`` in
phase 17 (a), ``recurrent_plane_launches`` in phase 18 (a) and
``frontend_plane_launches`` (per arch) in phase 19 (a, b), the online
shapes' errors, the
federated shape (e) and the clustering loop's (f) among the kmeans row's
``shapes``, the CIFAR-like shape among the recon_gate row's,
recurrentgemma's among both flash rows', qwen2-moe's, qwen2-vl's and
musicgen's among the tensor-core row's, the float32 prefills' among the
3xTF32 row's, each with ``launches_in_phase``, the launches its phase
counted in that prefill) and, as the last line, ``{"ok": true, "device": {...}}``. Any failure ends the run
with a non-zero exit code and no result line. Imports nothing of JAX.
"""
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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


def bound(bytes_moved, flops, dtype="float32"):
    """(ms, "bytes" or "operations"): ``repro_torch.roofline.bound_ms``, the
    H100 SXM datasheet's rates (3.35 TB/s; 67 TFLOP/s float32, 989 bf16,
    495 tf32, a third of that for 3xTF32)."""
    from repro_torch import roofline
    return roofline.bound_ms(bytes_moved, flops, dtype)


def reset_peak(torch, label):
    """Resets the peak-memory counter before a run and prints what is
    allocated at that moment (the base the run's peak sits on); returns
    the base in bytes.

    PyTorch keeps a cuBLAS workspace for every stream that has run a
    matmul, allocated from the caching allocator and never freed: each
    ``graph_ms`` call of a plain version leaves one for its side stream.
    No tensor of the earlier phases stays alive, but those workspaces did
    and sat under the peaks of phases 4 and 5; they are dropped here, as
    PyTorch's own memory-leak checks do, and the run makes the one it uses
    anew."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    log(f"  {label}: {base / 2**30:.3f} GiB allocated at the peak reset")
    torch.cuda.reset_peak_memory_stats()
    return base


def peak_text(torch, base):
    peak = torch.cuda.max_memory_allocated()
    return (f"peak device memory {peak / 2**30:.2f} GiB, "
            f"{(peak - base) / 2**30:.2f} GiB above the reset")


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
    bf16, the 3xTF32 one at batch 1 in float32) beside its bound and SDPA
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
    # the f32 serve's prefill: batch 1. Each f32 prefill's inputs and error
    # are kept for ``f32_flash``, which times them.
    q32, k32, v32 = (t[:1] for t in (q32, k32, v32))
    f32_checked = {"llama3.2-1b": (q32, k32, v32, check_flash(
        ops, ref, q32, k32, v32, "f32 served (1,2048,32,64) f32", simt))}

    # the tensor-core kernel's edges: bf16, head_dim 64 and 128
    check_flash(ops, ref, *qkv(1, 2048, 2048, 24, 8, 128),
                "Llama-3.2-3B-like (1,2048,24,128) Kv 8 bf16", sm90)
    # phi3.5-moe's prefill in phase 11 (c): GQA group 4
    check_flash(ops, ref, *qkv(4, 2048, 2048, 32, 8, 128),
                "phi3.5-moe (4,2048,32/8,128) bf16", sm90)
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
    # head_dim 256 (recurrentgemma's local attention): 64-key tiles, no
    # producer warp
    check_flash(ops, ref, *qkv(1, 300, 300, 4, 2, 256),
                "ragged S = L = 300 hd 256 bf16", sm90)
    check_flash(ops, ref, *qkv(2, 200, 200, 10, 1, 256),
                "MQA Kv=1 H 10 hd 256 bf16", sm90)
    for window in (8, 100):
        check_flash(ops, ref, *qkv(1, 256, 256, 4, 1, 256),
                    f"window {window} hd 256 bf16", sm90, window=window)
    check_flash(ops, ref, *qkv(1, 32, 128, 4, 4, 256),
                "q_offset 96, S 32, L 128 hd 256 bf16", sm90, q_offset=96)
    check_flash(ops, ref, *qkv(2, 256, 256, 4, 1, 256),
                "non-causal L 256 hd 256 bf16", sm90, causal=False)
    fused = torch.randn((2, 300, 10 + 1 + 1, 256), generator=g,
                        device=dev).bfloat16()
    check_flash(ops, ref, fused[:, :, :10], fused[:, :, 10:11],
                fused[:, :, 11:],
                "strided fused-qkv view (H 10, Kv 1) hd 256 bf16", sm90)

    # the 3xTF32 kernel: float32, and bf16 that TMA or wgmma cannot take
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
    # phase 11 (b)'s float32 route of qwen2-moe's prefill, phase 12 (b)'s
    # of qwen2-vl's and musicgen's (batch 1)
    for model, label, shape in (
            ("qwen2-moe-a2.7b", "qwen2-moe f32 route (4,2048,16,128) f32",
             (4, 2048, 2048, 16, 16, 128)),
            ("qwen2-vl-72b", "qwen2-vl f32 route (1,2048,64/8,128) f32",
             (1, 2048, 2048, 64, 8, 128)),
            ("musicgen-medium", "musicgen f32 route (1,1500,24,64) f32",
             (1, 1500, 1500, 24, 24, 64))):
        t = qkv(*shape, torch.float32)
        f32_checked[model] = (*t, check_flash(ops, ref, *t, label, simt))
    check_flash(ops, ref, *qkv(1, 200, 200, 4, 2, 32), "hd 32 bf16", simt)
    off = tuple(misaligned(t) for t in qkv(1, 200, 200, 4, 1, 256))
    check_flash(ops, ref, *off, "misaligned views hd 256 bf16", simt)
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
    b, s, h, hd = q.shape
    # causal, q_offset 0, S = L: every (b, h) row i sees i + 1 keys; q, k,
    # v read once, out written once
    flops, moved = flash_work(b, s, h, k.shape[2], hd, None,
                              q.element_size())
    b_ms, b_by = bound(moved, flops, "bfloat16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows[sm90] = r = dict(
        name=sm90, route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:91", max_abs_err=err,
        ms=graph_ms(lambda: fa_mod.flash_attention_sm90(q, k, v), iters=20,
                    replays=3),
        plain_ms=graph_ms(lambda: ref.flash_attention_ref(q, k, v), iters=3,
                          replays=3),
        call_ms=cuda_ms(lambda: fa_mod.flash_attention_sm90(q, k, v),
                        iters=50),
        plain_call_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v),
                              iters=5, warmup=2),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10,
            replays=3),
        bound_ms=b_ms, bound_by=b_by)
    log(f"  {sm90} {tuple(q.shape)} bf16: {flops / 1e9:.1f} GFLOP unmasked, "
        f"kernel {flops / r['ms'] / 1e9:.1f} TFLOP/s; SDPA (yardstick, never "
        f"called by the port) {r['library_ms']:.5f} ms")
    # the 3xTF32 kernel on the bf16 served inputs, beside the
    # tensor-core one in the same run
    simt_bf16 = graph_ms(lambda: fa_mod.flash_attention_cuda(q, k, v),
                         iters=5, replays=3)
    log(f"  flash_attention (3xTF32 route) {tuple(q.shape)} bf16: device "
        f"{simt_bf16:.5f} ms")
    del q, k, v, q32, k32, v32, qt, kt, vt
    fast, slow = recurrentgemma_flash(torch, F, ops, ref, fa_mod, qkv)
    rows[sm90]["shapes"] = [fast] + [
        served_flash(torch, F, ops, ref, fa_mod, qkv, *shape)
        for shape in SERVED_FLASH]
    f32 = [f32_flash(torch, F, ops, ref, fa_mod, qkv, f32_checked, *shape)
           for shape in F32_FLASH]
    del f32_checked
    large_score_flash(torch, ops, ref, qkv)
    llama = f32[0]
    rows[simt] = dict(
        {k_: llama[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "call_ms",
                                  "plain_call_ms", "library_ms", "bound_ms",
                                  "bound_by")},
        name=simt, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91",
        shapes=f32 + [slow])
    return rows


# the served prefills' attention shapes that phase 2 times on the tensor-core
# kernel: name, b, s, h, kv, hd (causal, L = S)
SERVED_FLASH = (
    ("qwen2-moe", 4, 2048, 16, 16, 128),    # phase 11 (a); moonshot's too
    ("qwen2-vl", 4, 2048, 64, 8, 128),      # phase 12 (a): GQA group 8
    ("musicgen", 4, 1500, 24, 24, 64),      # phase 12 (c): ragged S
)


def served_flash(torch, F, ops, ref, fa_mod, qkv, label, b, s, h, kv, hd):
    """A served prefill's attention: q (b, s, h, hd), k/v (b, s, kv, hd)
    bf16, causal, which ``route`` sends to the tensor-core kernel. Checked
    as the other shapes (one launch), then timed beside the plain version,
    one SDPA call (``enable_gqa`` where kv < h) and the bound (causal:
    every (b, h) row i sees i + 1 keys, at the bf16 tensor-core rate).
    Returns the shape's entry of the tensor-core kernel's row."""
    q, k, v = qkv(b, s, s, h, kv, hd)
    if fa_mod.route(q, k, v) != "sm90":
        raise AssertionError(f"route did not send {label}'s shape to the "
                             "tensor-core kernel")
    heads = f"{h}/{kv}" if kv < h else f"{h}"
    label = f"{label} ({b},{s},{heads},{hd}) " + \
        ("MHA bf16" if kv == h else f"GQA group {h // kv} bf16")
    err = check_flash(ops, ref, q, k, v, label, "flash_attention_sm90")
    flops = 4 * hd * (b * h * s * (s + 1) // 2)
    moved = q.element_size() * (2 * q.numel() + 2 * k.numel())
    b_ms, b_by = bound(moved, flops, "bfloat16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return fa_mod.flash_attention_sm90(q, k, v)

    def plain():
        return ref.flash_attention_ref(q, k, v)
    shape = (f"q/k/v ({b}, {s}, {h}, {hd})" if kv == h else
             f"q ({b}, {s}, {h}, {hd}), k/v ({b}, {s}, {kv}, {hd})")
    r = dict(shape=f"{shape} bf16, causal, "
             + ("MHA" if kv == h else f"GQA group {h // kv}"),
             max_abs_err=err, ms=graph_ms(kernel, iters=20, replays=3),
             call_ms=cuda_ms(kernel, iters=50),
             plain_ms=graph_ms(plain, iters=3, replays=3),
             plain_call_ms=cuda_ms(plain, iters=5, warmup=2),
             library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=kv < h), iters=10,
                 replays=3),
             bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=moved)
    log(f"  flash_attention_sm90 {label}: {flops / 1e9:.1f} GFLOP unmasked, "
        f"{moved / 1e6:.1f} MB; kernel {flops / r['ms'] / 1e9:.1f} TFLOP/s; "
        f"device {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms; per call "
        f"{r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}); SDPA {r['library_ms']:.5f} ms")
    return r


# the float32 prefills' attention shapes, which ``route`` sends to the
# 3xTF32 kernel: label, the model whose f32 prefill launches it (phases 5,
# 10-12 count those launches), b, s, h, kv, hd, window (causal, L = S)
F32_FLASH = (
    ("Llama-3.2-1B f32 serve (phase 5)", "llama3.2-1b",
     1, 2048, 32, 8, 64, None),
    ("musicgen f32 route (phase 12)", "musicgen-medium",
     1, 1500, 24, 24, 64, None),
    ("qwen2-moe f32 route (phase 11)", "qwen2-moe-a2.7b",
     4, 2048, 16, 16, 128, None),
    ("qwen2-vl f32 route (phase 12)", "qwen2-vl-72b",
     1, 2048, 64, 8, 128, None),
    ("recurrentgemma f32 prefill (phase 10)", "recurrentgemma-2b",
     4, 4096, 10, 1, 256, 2048),
)


def flash_work(b, s, h, kv, hd, window, itemsize):
    """Causal attention with L = S: the flops of the keys each query sees
    (min(i + 1, window)) and the bytes of q, k, v read once and out written
    once (``repro_torch.roofline.flash_attention_work``)."""
    from repro_torch import roofline
    return roofline.flash_attention_work(b, s, s, h, kv, hd, window=window,
                                         itemsize=itemsize)


def f32_flash(torch, F, ops, ref, fa_mod, qkv, checked, label, model, b, s, h,
              kv, hd, window):
    """A float32 prefill's attention: q (b, s, h, hd), k/v (b, s, kv, hd),
    causal (and windowed), which ``route`` sends to ``flash_attention.cu``.
    The inputs and error of phase 2's check of this shape where ``checked``
    holds them under ``model``, else drawn and checked against the plain
    version (one launch, 2e-5). Timed beside the plain version, one float32
    SDPA call (``enable_gqa``; the window as a boolean mask) and two bounds
    over the keys each query sees: 3xTF32 (3 x flops at the tf32
    tensor-core rate; the row's ``bound_ms``) and the CUDA cores' f32 rate
    (printed). Returns the shape's entry of the kernel's row."""
    heads = f"{h}/{kv}" if kv < h else f"{h}"
    tag = f"{label} ({b},{s},{heads},{hd})" + \
        (f" window {window}" if window else "") + " f32"
    if model in checked:
        q, k, v, err = checked[model]
    else:
        q, k, v = qkv(b, s, s, h, kv, hd, torch.float32)
        err = check_flash(ops, ref, q, k, v, tag, "flash_attention",
                          window=window)
    if fa_mod.route(q, k, v) != "simt" or q.shape != (b, s, h, hd):
        raise AssertionError(f"route did not send {label}'s shape to "
                             "flash_attention.cu")
    flops, moved = flash_work(b, s, h, kv, hd, window, q.element_size())
    b_ms, b_by = bound(moved, flops, "3xtf32")
    f32_ms, _ = bound(moved, flops)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        sdpa = dict(is_causal=True)
    else:
        pos = torch.arange(s, device=q.device)
        sdpa = dict(attn_mask=(pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))
    slow = hd == 256

    def kernel():
        return fa_mod.flash_attention_cuda(q, k, v, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window)
    shape = (f"q/k/v ({b}, {s}, {h}, {hd})" if kv == h else
             f"q ({b}, {s}, {h}, {hd}), k/v ({b}, {s}, {kv}, {hd})")
    r = dict(shape=f"{shape} f32, causal"
             + (f", window {window}" if window else "")
             + (", MHA" if kv == h else f", GQA group {h // kv}"),
             model=model, max_abs_err=err,
             ms=graph_ms(kernel, iters=3 if slow else 10, replays=2),
             call_ms=cuda_ms(kernel, iters=5 if slow else 20, warmup=2),
             plain_ms=graph_ms(plain, iters=2, replays=2),
             plain_call_ms=cuda_ms(plain, iters=2, warmup=1),
             library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, enable_gqa=kv < h, **sdpa),
                 iters=2 if slow else 5, replays=2),
             bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=moved)
    log(f"  flash_attention {tag}: {flops / 1e9:.2f} GFLOP of visible keys, "
        f"{moved / 1e6:.1f} MB; kernel {flops / r['ms'] / 1e9:.1f} TFLOP/s; "
        f"device {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms; per call "
        f"{r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}, 3xTF32), {f32_ms:.5f} ms on the CUDA cores; "
        f"SDPA f32 {r['library_ms']:.5f} ms")
    return r


def attention_f64(q, k, v, window=None):
    """Causal attention in float64 (q (B, S, H, hd), k/v (B, S, Kv, hd)):
    the truth that float32 routes are held to where their own error grows
    with the scores. Returns (out, the largest |score|)."""
    import torch
    q, k, v = (t.double() for t in (q, k, v))
    h, n_kv = q.shape[2], k.shape[2]
    k, v = (t.repeat_interleave(h // n_kv, dim=2) for t in (k, v))
    sc = torch.einsum("bshd,blhd->bhsl", q, k) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1], device=q.device)
    ok = pos[:, None] >= pos[None, :]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    sc = torch.where(ok, sc, -torch.inf)
    top = float(sc.abs().where(ok, 0).max())
    return torch.einsum("bhsl,blhd->bshd", torch.softmax(sc, -1), v), top


def large_score_flash(torch, ops, ref, qkv):
    """The 3xTF32 kernel where scores reach ~20-25 (q drawn x 4): the tensor
    cores cut each mma's sum toward zero, a drift that grows with |S|. At
    head_dim 256 (recurrentgemma's f32 prefill at batch 1, window 2,048)
    and 128 (GQA group 4), one launch each must stay within 2e-5 + 2e-5 *
    |want| of float64 attention; the plain f32 version's distance from it
    is printed beside (its own error grows with the scores too)."""
    for b, s, h, kv, hd, window in ((1, 4096, 10, 1, 256, 2048),
                                    (1, 2048, 8, 2, 128, None)):
        q, k, v = qkv(b, s, s, h, kv, hd, torch.float32)
        q = q * 4
        before = ops.KERNELS["flash_attention"].launches
        out = ops.flash_attention(q, k, v, window=window)
        if ops.KERNELS["flash_attention"].launches != before + 1:
            raise AssertionError("flash_attention did not launch once")
        truth, top = attention_f64(q, k, v, window)
        plain = ref.flash_attention_ref(q, k, v, window=window)
        err = (out.double() - truth).abs()
        label = (f"({b},{s},{h}/{kv},{hd})"
                 + (f" window {window}" if window else "")
                 + f" f32, q x 4 (|scores| <= {top:.1f})")
        log(f"  flash_attention {label}: max err against float64 "
            f"{float(err.max()):.3e} (plain f32 version "
            f"{float((plain.double() - truth).abs().max()):.3e})")
        if not bool((err <= 2e-5 + 2e-5 * truth.abs()).all()):
            raise AssertionError(f"flash_attention {label}: max err "
                                 f"{float(err.max())} against float64")
        del q, k, v, out, truth, plain


def recurrentgemma_flash(torch, F, ops, ref, fa_mod, qkv):
    """recurrentgemma-2b's local attention at phase 10's prefill: q (4,
    4096, 10, 256), k/v (4, 4096, 1, 256) bf16, causal, window 2,048, which
    ``route`` sends to the tensor-core kernel. Checked as the other shapes,
    then timed as the table times them; ``flash_attention.cu``, this
    shape's route before head_dim 256 reached the wgmma kernel, is held to
    the same plain version and timed beside it through
    ``flash_attention_cuda`` (bf16 values: two TF32 passes a product). The
    library call is one SDPA with the window as a boolean mask and
    ``enable_gqa``. The bound counts the keys each query sees, min(i + 1,
    2,048), at the bf16 tensor-core rate. Returns the shape's entries of
    the tensor-core and the 3xTF32 kernel's rows."""
    b, s, h, kv, hd, window = 4, 4096, 10, 1, 256, 2048
    q, k, v = qkv(b, s, s, h, kv, hd)
    if fa_mod.route(q, k, v) != "sm90":
        raise AssertionError("route did not send recurrentgemma's shape to "
                             "the tensor-core kernel")
    label = f"recurrentgemma ({b},{s},{h},{hd}) Kv {kv} window {window} bf16"
    err = check_flash(ops, ref, q, k, v, label, "flash_attention_sm90",
                      window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=window)
    got = fa_mod.flash_attention_cuda(q, k, v, window=window).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err_slow = float(diff.max())
    if not bool((diff <= 1e-3 + 8e-3 * want.abs()).all()):
        raise AssertionError(f"flash_attention {label}: max err {err_slow}")
    log(f"  flash_attention (3xTF32 route) {label}: max err {err_slow:.3e}")
    del want, got, diff
    flops, moved = flash_work(b, s, h, kv, hd, window, q.element_size())
    b_ms, b_by = bound(moved, flops, "bfloat16")
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                             < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window)
    common = dict(
        shape=f"q ({b}, {s}, {h}, {hd}), k/v ({b}, {s}, {kv}, {hd}) bf16, "
        f"causal, window {window}",
        plain_ms=graph_ms(plain, iters=2, replays=2),
        plain_call_ms=cuda_ms(plain, iters=2, warmup=1),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=3, replays=2),
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=moved)
    out = []
    for name, fn, e, iters in (
            ("flash_attention_sm90", fa_mod.flash_attention_sm90, err, 10),
            ("flash_attention (3xTF32 route)", fa_mod.flash_attention_cuda,
             err_slow, 3)):
        def kernel():
            return fn(q, k, v, window=window)
        r = dict(common, max_abs_err=e,
                 ms=graph_ms(kernel, iters=iters, replays=2),
                 call_ms=cuda_ms(kernel, iters=iters, warmup=1))
        log(f"  {name} {label}: {flops / 1e9:.1f} GFLOP of visible keys, "
            f"{moved / 1e6:.1f} MB; kernel {flops / r['ms'] / 1e9:.1f} "
            f"TFLOP/s; device {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} "
            f"ms; per call {r['call_ms']:.5f} ms, plain "
            f"{r['plain_call_ms']:.5f} ms; bound {b_ms:.5f} ms ({b_by}); "
            f"SDPA {r['library_ms']:.5f} ms")
        out.append(r)
    return tuple(out)


def kmeans_bound(x, c):
    """Each input read once, each output written once; 2d flops for ||x||^2,
    2kd for the cross terms, 3k to combine and compare."""
    rows, d, k = x.numel() // x.shape[-1], x.shape[-1], c.shape[-2]
    return bound(4 * (x.numel() + c.numel()) + 8 * rows,
                 rows * (2 * d + 2 * k * d + 3 * k))


def cold_graph_ms(fn, x, c, l2_bytes=64 * 2**20):
    """graph_ms of fn(x, c) with the captured calls cycling through copies
    of (x, c), more than the card's 50 MB L2 apart: each call finds its
    inputs in device memory, not in L2."""
    import itertools
    import torch
    each = 4 * (x.numel() + c.numel())
    m = max(2, -(-l2_bytes // each))
    copies = itertools.cycle([(x.clone(), c.clone()) for _ in range(m)])
    ms = graph_ms(lambda: fn(*next(copies)), iters=m * -(-50 // m))
    del copies
    torch.cuda.empty_cache()
    return ms


def kmeans_phase(torch, ops, ref, km_mod, dev):
    """Phase 2, kmeans_assign: the kernel against its plain version at the
    main path's shape, the shapes (b)-(d) and edge shapes; then timed at
    (a)-(d) warm (the same inputs every call, so they sit in L2) and cold.
    Returns the kernel's row."""
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # (a) the main path's Lloyd step: N=30 clients, cap=1998 rows,
    # d=n_pca=32, k=3 (one launch for all clients); (b) the kernel bench's
    # 2-D shape; (c) d = n_pca = 4; (d) the Pallas docstring's budget
    timed = {"(a) main (30,1998,32)x(30,3,32)": (randn(30, 1998, 32),
                                                 randn(30, 3, 32)),
             "(b) 2-D (20000,128)x(10,128)": (randn(20000, 128),
                                              randn(10, 128)),
             "(c) d=4 (30,1998,4)x(30,3,4)": (randn(30, 1998, 4),
                                              randn(30, 3, 4)),
             "(d) (2,4096,1024)x(2,256,1024)": (randn(2, 4096, 1024),
                                                randn(2, 256, 1024))}
    errs = {label: check_kmeans(ops, ref, x, c, label)
            for label, (x, c) in timed.items()}
    # edge shapes: ragged n and d, k > 8, the 2-D call, a chunk of
    # centroids narrower than d
    check_kmeans(ops, ref, randn(5, 37, 11), randn(5, 11, 11),
                 "k=11 d=11 n=37")
    check_kmeans(ops, ref, randn(1001, 32), randn(3, 32), "2-D n=1001")
    check_kmeans(ops, ref, randn(1, 300, 1100), randn(1, 10, 1100),
                 "d=1100 k=10 (chunks of 8 x 1024)")
    # planted exact ties: a duplicate centroid in the same register group,
    # and copies of a first-chunk centroid placed in a later chunk
    for (nb, n, d, k, first, dup) in ((4, 333, 32, 3, 0, 2),
                                      (2, 500, 1024, 20, 2, 17),
                                      (2, 500, 1100, 10, 1, 9)):
        ct = randn(nb, k, d)
        ct[:, dup] = ct[:, first]
        xt = randn(nb, n, d)
        check_kmeans(ops, ref, xt, ct, f"planted ties j={first}, {dup} d={d}")
        a, _ = ops.kmeans_assign(xt, ct)
        if bool((a == dup).any()) or not bool((a == first).any()):
            raise AssertionError(f"kmeans_assign d={d}: a tie between "
                                 f"{first} and {dup} went to the later index")
        log(f"  kmeans_assign planted ties j={first}, {dup} (d={d}, k={k}): "
            "first index wins")

    shapes = []
    for label, (x, c) in timed.items():
        b_ms, b_by = kmeans_bound(x, c)
        shapes.append(dict(
            shape=label, ms=graph_ms(lambda: km_mod.kmeans_assign_cuda(x, c)),
            cold_ms=cold_graph_ms(km_mod.kmeans_assign_cuda, x, c),
            plain_ms=graph_ms(lambda: ref.kmeans_assign_ref(x, c)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[label]))
        nb, n, d = (x if x.dim() == 3 else x[None]).shape
        r = shapes[-1]
        log(f"  kmeans_assign {label}: device {r['ms']:.5f} ms warm, "
            f"{r['cold_ms']:.5f} ms cold, plain {r['plain_ms']:.5f} ms; "
            f"bound {b_ms:.5f} ms ({b_by})")
        log(f"    {km_mod._plan(dev.index, n, d, c.shape[-2], nb, 1)}")
    z = torch.zeros(1, device=dev)
    floor = graph_ms(lambda: z.zero_())
    log(f"  graph launch floor (1-element zero_, captured as above): "
        f"{floor:.5f} ms per call")
    x, c = timed["(a) main (30,1998,32)x(30,3,32)"]
    main = shapes[0]
    return dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:40",
        max_abs_err=main["max_abs_err"], ms=main["ms"],
        cold_ms=main["cold_ms"], plain_ms=main["plain_ms"],
        call_ms=cuda_ms(lambda: km_mod.kmeans_assign_cuda(x, c), iters=200),
        plain_call_ms=cuda_ms(lambda: ref.kmeans_assign_ref(x, c), iters=200),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, floor_ms=floor, shapes=shapes[1:])


def kernel_phase(torch, ops, ref, km_mod, rg_mod, dev):
    """Phase 2: every kernel against its plain version, then timed."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {"kmeans_assign": kmeans_phase(torch, ops, ref, km_mod, dev)}

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


def recurrent_reference_phase(torch, ops, dev):
    """Phase 3, the recurrent families: recurrentgemma-2b reduced to 4
    layers (one (rglru, rglru, local_attn) unit and an rglru tail, d_model
    256, window 64) with a 72-token prompt, so the prefill fills its ring
    past the window, and xlstm-125m's smoke config (mlstm, slstm) with a
    300-token prompt (a full mLSTM chunk and a ragged one); the same
    parameters and tokens on the card (kernels) and on the host (plain
    versions), prefill then 8 teacher-forced decode steps. Tolerances as
    the dense family's: float32 1e-4, bfloat16 3e-2, absolute on logits of
    size ~1. recurrentgemma's f32 prefill launches the CUDA-core flash
    kernel once (its one local_attn layer), the bf16 one the tensor-core
    kernel (head_dim 64 here)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    for arch, over, prompt in (("recurrentgemma-2b", {"n_layers": 4}, 72),
                               ("xlstm-125m", {}, 300)):
        for dtype, tol, kernel in (("float32", 1e-4, "flash_attention"),
                                   ("bfloat16", 3e-2, "flash_attention_sm90")):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                      **over)
            n_attn = cfg.layer_kinds.count("local_attn")
            model = build_model(cfg)
            host_p = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            card_p = tree_map(lambda a: a.to(dev), host_p)
            toks = torch.randint(0, cfg.vocab_size, (2, prompt + 8),
                                 generator=torch.Generator().manual_seed(1))
            hl, hc = model.prefill(host_p, {"tokens": toks[:, :prompt]},
                                   max_len=prompt + 8, use_flash=True)
            before = {n: k.launches for n, k in ops.KERNELS.items()}
            cl, cc = model.prefill(card_p, {"tokens": toks[:, :prompt].to(dev)},
                                   max_len=prompt + 8, use_flash=True)
            moved = {n: k.launches - before[n]
                     for n, k in ops.KERNELS.items()}
            want = {n: (n_attn if n == kernel else 0) for n in moved}
            if moved != want:
                raise AssertionError(f"small {arch} {dtype} prefill launched "
                                     f"{moved}, expected {want}")
            errs = [float((cl.cpu() - hl).abs().max())]
            for t in range(prompt, prompt + 8):
                hl, hc = model.decode(host_p, hc, {"token": toks[:, t:t + 1]})
                cl, cc = model.decode(card_p, cc,
                                      {"token": toks[:, t:t + 1].to(dev)})
                errs.append(float((cl.cpu() - hl).abs().max()))
            state = max(float((a.cpu().float() - b.float()).abs().max())
                        for a, b in zip(tree_leaves((cc["scan"], cc["tail"])),
                                        tree_leaves((hc["scan"], hc["tail"]))))
            if max(errs) > tol:
                raise AssertionError(f"small {arch} {dtype}: logits differ "
                                     f"by {errs} (tol {tol})")
            log(f"  small {arch} {dtype} ({cfg.n_layers} layers) agrees: "
                f"prefill max err {errs[0]:.3e}, decode max err "
                f"{max(errs[1:]):.3e} (|logits| <= "
                f"{float(hl.abs().max()):.3f}); cache leaves max diff "
                f"{state:.3e}; flash launches {moved}")


def moe_reference_phase(torch, ops, dev):
    """Phase 3, the MoE family: the smoke qwen2-moe (2 layers, d_model 256,
    4 experts top-2, one shared expert) in float32 (TF32 off) with the same
    parameters and tokens on the card (the 3xTF32 flash kernel once a
    layer) and on the host (plain versions), prefill then 8 teacher-forced
    decode steps, logits within 1e-3 absolute (f32 sums in other orders;
    a routing flip would show far above it)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              dtype="float32")
    model = build_model(cfg)
    host_p = model.init(torch.Generator().manual_seed(0), device="cpu")
    card_p = tree_map(lambda a: a.to(dev), host_p)
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(1))
    hl, hc = model.prefill(host_p, {"tokens": toks[:, :40]}, max_len=48)
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    cl, cc = model.prefill(card_p, {"tokens": toks[:, :40].to(dev)},
                           max_len=48, use_flash=True)
    moved = {n: k.launches - before[n] for n, k in ops.KERNELS.items()}
    want = {n: (cfg.n_layers if n == "flash_attention" else 0) for n in moved}
    if moved != want:
        raise AssertionError(f"small qwen2-moe prefill launched {moved}, "
                             f"expected {want}")
    errs = [float((cl.cpu() - hl).abs().max())]
    for t in range(40, 48):
        hl, hc = model.decode(host_p, hc, {"token": toks[:, t:t + 1]})
        cl, cc = model.decode(card_p, cc, {"token": toks[:, t:t + 1].to(dev)})
        errs.append(float((cl.cpu() - hl).abs().max()))
    if max(errs) > 1e-3:
        raise AssertionError(f"small qwen2-moe float32: logits differ by "
                             f"{errs} (tol 1e-3)")
    log(f"  small qwen2-moe float32 ({cfg.n_layers} layers, "
        f"{cfg.n_experts} experts top-{cfg.experts_per_token}, "
        f"{cfg.n_shared_experts} shared) agrees: prefill max err "
        f"{errs[0]:.3e}, decode max err {max(errs[1:]):.3e} (|logits| <= "
        f"{float(hl.abs().max()):.3f}); flash launches {moved}")


def vl_positions(torch, b, n_img, n_txt, grid_w, dev):
    """Qwen2-VL's (t, h, w) positions (b, n_img + n_txt, 3) for one image
    of n_img patches in rows of ``grid_w`` followed by n_txt text tokens:
    patch i at (0, i // grid_w, i % grid_w), text token j at m + j in all
    three streams, m one past the grid's largest index
    (``meshlab.grid_positions``), on ``dev``."""
    from repro_torch.meshlab import grid_positions
    return grid_positions(b, n_img, n_txt, grid_w).to(dev)


def frontend_prompt(torch, cfg, b, s, g, dev, grid_w=16):
    """A served prompt of the config's frontend drawn from ``g``: vision
    min(256, s // 2) bf16 patch embeddings, s - n_img text tokens and the
    position grid (``vl_positions``); audio (b, s, nq) codes."""
    if cfg.frontend == "audio_codec":
        return {"codes": torch.randint(0, cfg.vocab_size,
                                       (b, s, cfg.n_codebooks), generator=g,
                                       device=dev)}
    n_img = min(256, s // 2)
    return {"embeds": torch.randn((b, n_img, cfg.frontend_dim), generator=g,
                                  device=dev).bfloat16(),
            "tokens": torch.randint(0, cfg.vocab_size, (b, s - n_img),
                                    generator=g, device=dev),
            "positions": vl_positions(torch, b, n_img, s - n_img, grid_w,
                                      dev)}


def frontend_reference_phase(torch, ops, dev):
    """Phase 3, the frontends: the smoke qwen2-vl (2 layers, d_model 256,
    GQA 4/2, M-RoPE (8, 12, 12), 128-wide patch embeddings; 20 patches in
    rows of 4 and 20 text tokens, so the three position streams differ)
    and the smoke musicgen (2 layers, 2 codebooks of 512; 40 frames) in
    float32 (TF32 off), the same parameters and prompt on the card (the
    CUDA-core flash kernel once a layer) and on the host (plain versions),
    prefill then 8 teacher-forced decode steps, logits within 1e-3
    absolute (phase 3's f32 bound)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    for arch in ("qwen2-vl-72b", "musicgen-medium"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg)
        host_p = model.init(torch.Generator().manual_seed(0), device="cpu")
        card_p = tree_map(lambda a: a.to(dev), host_p)
        g = torch.Generator().manual_seed(1)
        prompt = frontend_prompt(torch, cfg, 2, 40, g, "cpu", grid_w=4)
        if cfg.frontend == "audio_codec":
            steps = [{"codes": torch.randint(0, cfg.vocab_size,
                                             (2, 1, cfg.n_codebooks),
                                             generator=g)} for _ in range(8)]
        else:
            steps = [{"token": torch.randint(0, cfg.vocab_size, (2, 1),
                                             generator=g)} for _ in range(8)]
        hl, hc = model.prefill(host_p, prompt, max_len=48)
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        cl, cc = model.prefill(card_p, {k: v.to(dev) for k, v in
                                        prompt.items()}, max_len=48,
                               use_flash=True)
        moved = {n: k.launches - before[n] for n, k in ops.KERNELS.items()}
        want = {n: (cfg.n_layers if n == "flash_attention" else 0)
                for n in moved}
        if moved != want:
            raise AssertionError(f"small {arch} prefill launched {moved}, "
                                 f"expected {want}")
        errs = [float((cl.cpu() - hl).abs().max())]
        for step in steps:
            hl, hc = model.decode(host_p, hc, step)
            cl, cc = model.decode(card_p, cc,
                                  {k: v.to(dev) for k, v in step.items()})
            errs.append(float((cl.cpu() - hl).abs().max()))
        if max(errs) > 1e-3:
            raise AssertionError(f"small {arch} float32: logits differ by "
                                 f"{errs} (tol 1e-3)")
        log(f"  small {arch} float32 ({cfg.n_layers} layers, logits "
            f"{tuple(hl.shape)}) agrees: prefill max err {errs[0]:.3e}, "
            f"decode max err {max(errs[1:]):.3e} (|logits| <= "
            f"{float(hl.abs().max()):.3f}); flash launches {moved}")


def device_profile(torch, label, fn, top=6):
    """Runs ``fn`` once under ``torch.profiler`` and prints its wall time
    (ending in a device sync, profiler overhead included), the device's busy
    time (the sum of its kernel, copy and set durations: one stream, so they
    do not overlap), the count of device events and the ``top`` kernels
    with the most device time. Returns fn's result and the busy ms (None when the
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
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")
    return out, busy


def serve_phase(torch, ops, dev):
    """Phase 5: Llama-3.2-1B served at full width; returns the launch counts
    of the bf16 serve and of the f32 serve, and the bf16 prefill's
    seconds."""
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

    base = reset_peak(torch, "bf16 serve")
    for k in ops.KERNELS.values():
        k.launches = 0
    res = serve(model, params, tokens, gen, temperature=1.0, generator=g,
                device=dev)
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    peak = peak_text(torch, base)

    # the same weights served with float32 activations, batch 1: the
    # 3xTF32 flash kernel
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
    log(f"  bf16 serve: {peak}")
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
    return launches, launches32, res.prefill_s


def full_world(torch, dev):
    """The full-width world of phases 4 and 6: FMNIST-sized synthetic data
    (10 classes x 6,000 train images, 30 eval per class) over N = 30
    clients with 3 circular classes each. Returns (xs, ys, ev, generator)."""
    from repro_torch.data import fmnist_like_split, partition_by_classes
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
    return xs, ys, ev, gen


def main_path(torch, ops, dev):
    """Phase 4: the full-width main path; returns the launch counts."""
    from repro_torch.core.pipeline import PipelineConfig, run_pipeline
    from repro_torch.fl import FLConfig, fl_train, linear_evaluation
    from repro_torch.models.autoencoder import AEConfig

    xs, ys, ev, gen = full_world(torch, dev)
    ae_cfg = AEConfig()
    cfg = PipelineConfig()

    base = reset_peak(torch, "main path")
    for k in ops.KERNELS.values():
        k.launches = 0
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
        f"linear_evaluation {t_le:.3f} s, {peak_text(torch, base)}")
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
    return launches, main_record(torch, res, fl, t_pipe, t_fl, t_le)


def main_record(torch, res, fl, t_pipe, t_fl, t_le):
    """What phase 15 (b) holds its sharded main path to: the graph, moved
    counts, gate decisions, lambdas and FL global parameters on the host,
    and the seconds."""
    from repro_torch import sharding as sh
    from repro_torch.models.common import tree_leaves
    return {"in_edge": res.in_edge.cpu(),
            "moved": torch.as_tensor(res.moved_counts),
            "accept": sh.full_tensor(res.exchange.accept).cpu(),
            "lam_before": res.lam_before.cpu(),
            "lam_after": res.lam_after.cpu(),
            "fl_global": torch.cat([p.reshape(-1).cpu() for p in
                                    tree_leaves(fl.global_params)]),
            "stages": dict(res.stage_seconds), "run_pipeline": t_pipe,
            "fl_train": t_fl, "linear_evaluation": t_le}


def _online_run(torch, ops, dev, world, cfg, scenario, rules=None):
    """One full-width ``run_orchestrator`` call with the launch counts set
    to 0 just before it and read just after; prints its segments and
    checks what every full-width online run must show. Returns (result,
    launch counts, seconds)."""
    from repro_torch import sharding as sh
    from repro_torch.dynamics import run_orchestrator
    from repro_torch.models.autoencoder import AEConfig
    xs, ys, ev = world
    name = getattr(scenario, "name", scenario)
    base = reset_peak(torch, f"online orchestrator, {name}")
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = run_orchestrator(xs, ys, AEConfig(), cfg, scenario, ev.images,
                           device=dev, rules=rules)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    peak = peak_text(torch, base)

    segs = res.trace.segments
    for seg, sec, st in zip(segs, res.segment_seconds, res.stage_seconds):
        stages = ", ".join(f"{k} {v:.3f}" for k, v in st.items())
        log(f"  segment {seg.segment}: {sec:.3f} s ({stages}); eval loss "
            f"{seg.eval_loss:.5f}, available {seg.n_available}, moved "
            f"{seg.moved}, failed {seg.n_failed} of {seg.n_live} live, "
            f"retried {seg.retried}, delivered {seg.retry_delivered}, "
            f"link churn {seg.link_churn:.3f}, mean P_D "
            f"{seg.mean_pfail:.4f}")
    log(f"  run_orchestrator ({name}) {total:.3f} s; final cap "
        f"{res.client_data.cap}, sizes {res.client_data.sizes.min().item()}-"
        f"{res.client_data.sizes.max().item()}; {peak}")
    log(f"  summary {res.trace.summary()}")
    log(f"  launches {launches}")
    retries = sum(seg.retried > 0 for seg in segs)
    n = 30
    checks = {
        "kmeans_assign launched 50 + 25 x 4 = 150 times":
            launches["kmeans_assign"] == 150,
        f"recon_gate launched 2 x (5 + {retries} retry exchanges) times":
            launches["recon_gate"] == 2 * (5 + retries),
        "no flash kernel launched":
            launches["flash_attention"] == launches["flash_attention_sm90"]
            == 0,
        "every eval loss finite": len(segs) == 5
            and all(math.isfinite(seg.eval_loss) for seg in segs),
        "every segment's in_edge has no self-link":
            all((seg.in_edge != list(range(n))).all() for seg in segs),
        "data finite": bool(torch.isfinite(
            sh.full_tensor(res.client_data.data)).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"online orchestrator ({name}) checks failed: "
                             f"{failed}")
    return res, launches, total


def online_kernel_checks(torch, ops, ref, res, cfg, dev):
    """Both kernels against their plain versions, at phase 2's tolerances,
    on the client stack the online run ended with (its cap grown by every
    re-exchange): ``kmeans_assign`` on the PCA features and centroids of a
    re-cluster of that stack, ``recon_gate`` on its reconstructions by the
    final global model, with the own-data mask the gate gives it (each
    client's size) and with every group but two empty. Returns the max
    errors."""
    from repro_torch.core.pipeline import cluster_clients
    from repro_torch.models import autoencoder as ae
    from repro_torch.models.autoencoder import AEConfig
    from repro_torch.models.common import tree_map
    cd = res.client_data
    n, cap = cd.n_clients, cd.cap
    flats = cd.data.reshape(n, cap, -1)
    pca, cents, _ = cluster_clients(
        cd, cfg.pipeline, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    err_km = check_kmeans(ops, ref, pca.transform(flats), cents,
                          f"online final cap ({n},{cap},"
                          f"{cfg.pipeline.n_pca})x{tuple(cents.shape)}")
    stacked = tree_map(lambda p: p.expand((n,) + tuple(p.shape)).contiguous(),
                       res.global_params)
    with torch.no_grad():
        y = ae.reconstruct_stacked(stacked, cd.data, AEConfig()).reshape(
            n, cap, -1)
    own = (torch.arange(cap, device=dev)[None, :]
           < cd.sizes[:, None]).float()
    err_rg = check_recon(ops, ref, y, flats, own,
                         f"online final cap ({n},{cap},{flats.shape[-1]}), "
                         "own-data mask")
    sparse = torch.zeros_like(own)
    sparse[[3, 17]] = own[[3, 17]]
    check_recon(ops, ref, y, flats, sparse,
                f"online final cap ({n},{cap},{flats.shape[-1]}), all but "
                "2 groups empty")
    scores = ops.recon_gate_score(y, flats, sparse)
    if bool((scores[sparse.sum(-1) == 0] != 0).any()):
        raise AssertionError("recon_gate: an empty group must score 0")
    return {"kmeans_assign": err_km, "recon_gate": err_rg}


def orchestrator_full(torch, ops, ref, dev):
    """Phase 6 (a): the online orchestrator at full width on phase 4's
    world, 5 segments of 20 FL iterations, a 150-episode RL burst and a
    re-exchange every segment, retries on; two runs.

    ``burst-outage`` is the timed run whose launch counts the JSON line
    reports; both kernels are then held against their plain versions at
    the shapes it grew to. Its RL burst may steer clear of every failing
    link, so the retry path is shown by a second run on a copy of the
    scenario whose burst floors every link at P_D 0.97 in segments 1-2:
    each of segment 1's 30 live links fails with probability >= 0.97, and
    segment 2 must retry. Returns (launch counts, online max errors, the
    ``burst-outage`` run's segment records and seconds)."""
    import dataclasses
    from repro_torch.dynamics import get_scenario
    xs, ys, ev, _ = full_world(torch, dev)
    cfg = _online_cfg()

    res, launches, secs = _online_run(torch, ops, dev, (xs, ys, ev), cfg,
                                      "burst-outage")
    errs = online_kernel_checks(torch, ops, ref, res, cfg, dev)
    segs = res.trace.segments
    seg_secs = res.segment_seconds
    del res

    scn = get_scenario("burst-outage")
    every_link = dataclasses.replace(
        scn, name="burst-outage, every link", faults=dataclasses.replace(
            scn.faults, link_bursts=tuple(
                dataclasses.replace(b, frac=1.0)
                for b in scn.faults.link_bursts)))
    res, _, _ = _online_run(torch, ops, dev, (xs, ys, ev), cfg, every_link)
    hit = res.trace.segments
    if not (hit[1].n_failed >= 1 and hit[2].retried >= 1
            and res.trace.summary()["total_failed_links"] >= 1):
        raise AssertionError("every link burst: the retry queue saw no "
                             "failed live link, or segment 2 retried none")
    return launches, errs, segs, (secs, seg_secs)


def _online_cfg():
    """Phase 6's full-width online config: 5 segments of 20 FL iterations,
    a 150-episode burst, a re-exchange and retries every segment."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.dynamics import OrchestratorConfig
    from repro_torch.faults import RetryPolicy
    from repro_torch.fl import FLConfig
    return OrchestratorConfig(
        n_segments=5, iters_per_segment=20, mode="online", rediscover_every=1,
        burst_episodes=150, retry=RetryPolicy(enabled=True),
        pipeline=PipelineConfig(exchange=ExchangeConfig(
            apply_channel_failure=True)),
        fl=FLConfig(tau_a=10, batch_size=64, eval_every=20))


def _small_online(n_segments=4, **kw):
    from repro_torch.core import exchange as ex
    from repro_torch.core import pipeline as pl
    from repro_torch.core import qlearning as ql
    from repro_torch.dynamics import OrchestratorConfig
    from repro_torch.fl import FLConfig
    return OrchestratorConfig(
        n_segments=n_segments, iters_per_segment=20, mode="online",
        burst_episodes=20,
        pipeline=pl.PipelineConfig(
            n_pca=4, kmeans_iters=5,
            rl=ql.RLConfig(n_episodes=40, buffer_size=10, policy="ucb"),
            exchange=ex.ExchangeConfig(reserve_per_cluster=8,
                                       apply_channel_failure=True)),
        fl=FLConfig(tau_a=10, batch_size=8, eval_every=10), **kw)


def orchestrator_reference(torch, dev):
    """Phase 6 (b): the orchestrator on the card against the host, small
    (UCB discovery, ``regional-failure``, 4 segments), from the same seeded
    draws (the card's source draws on a CPU generator). Graphs,
    availability, moved counts and failed links exact; eval losses within
    1e-3 relative (phase 3's FL tolerance)."""
    from repro_torch.dynamics import SeededDraws, run_orchestrator
    from repro_torch.models.autoencoder import AEConfig
    xs, ys, ev = small_world(torch)
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    cfg = _small_online()
    host = run_orchestrator(xs, ys, ae_cfg, cfg, "regional-failure",
                            ev.images, draws=SeededDraws(3, "cpu"),
                            device="cpu")
    card = run_orchestrator(xs, ys, ae_cfg, cfg, "regional-failure",
                            ev.images, draws=SeededDraws(3, dev, "cpu"),
                            device=dev)
    for h, c in zip(host.trace.segments, card.trace.segments):
        same = ((h.in_edge == c.in_edge).all() and (h.n_available, h.moved,
                h.n_failed) == (c.n_available, c.moved, c.n_failed))
        if not same or not math.isclose(c.eval_loss, h.eval_loss,
                                        rel_tol=1e-3):
            raise AssertionError(f"small online run, segment {h.segment}: "
                                 f"host {h} card {c}")
    log(f"  small online run agrees over {len(host.trace.segments)} "
        f"segments: available {[s.n_available for s in host.trace.segments]}"
        f", moved {[s.moved for s in host.trace.segments]}, eval "
        f"{[round(s.eval_loss, 5) for s in host.trace.segments]} (card "
        f"{[round(s.eval_loss, 5) for s in card.trace.segments]})")


def orchestrator_resume(torch, dev):
    """Phase 6 (c): kill and resume on the card (``preempt-resume``, small).
    Two uninterrupted card runs must be bit-identical; then a run preempted
    at segment 2 and resumed from its checkpoint must end bit-identical to
    them (trace, final global parameters, final ClientData). If two runs
    differ, cuDNN's deterministic algorithms are switched on for this phase
    and the runs are repeated; the setting needed is printed."""
    import dataclasses
    import shutil
    from repro_torch.dynamics import (SeededDraws, get_scenario,
                                      run_orchestrator)
    from repro_torch.faults import Preempted
    from repro_torch.models.autoencoder import AEConfig
    from repro_torch.models.common import tree_leaves
    xs, ys, ev = small_world(torch)
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = _small_online(checkpoint_dir=ckpt)
    scn = get_scenario("preempt-resume")
    whole = dataclasses.replace(scn, faults=dataclasses.replace(
        scn.faults, preempt_at=None))

    def run(scenario, **kw):
        return run_orchestrator(xs, ys, ae_cfg, cfg, scenario, ev.images,
                                draws=SeededDraws(4, dev), device=dev, **kw)

    def fingerprint(res):
        recs = [(s.segment, s.eval_loss, s.in_edge.tolist(), s.link_churn,
                 s.mean_pfail, s.expected_delivery, s.realized_delivery,
                 s.n_available, s.moved, s.eval_curve.tolist(), s.n_live,
                 s.n_failed) for s in res.trace.segments]
        return recs, [t.cpu() for t in tree_leaves(res.global_params)], \
            [t.cpu() for t in res.client_data]

    def equal(a, b):
        return a[0] == b[0] and all(
            torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))

    setting = "none"
    cudnn_det = torch.backends.cudnn.deterministic
    try:
        first = fingerprint(run(whole))
        if not equal(first, fingerprint(run(whole))):
            setting = "torch.backends.cudnn.deterministic = True"
            torch.backends.cudnn.deterministic = True
            first = fingerprint(run(whole))
            if not equal(first, fingerprint(run(whole))):
                raise AssertionError("two uninterrupted card runs differ, "
                                     "with cuDNN's deterministic algorithms "
                                     "too")
        try:
            run(scn)
            raise AssertionError("preempt-resume did not preempt")
        except Preempted as e:
            if e.segment != 2 or not os.path.exists(e.checkpoint):
                raise AssertionError(f"preempted at {e.segment}, "
                                     f"checkpoint {e.checkpoint}")
        resumed = run(scn, resume_from=cfg.checkpoint_path)
        if not equal(first, fingerprint(resumed)):
            raise AssertionError("the resumed card run differs from the "
                                 "uninterrupted one")
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"  kill at segment 2 and resume: bit-identical to the "
        f"uninterrupted run (trace, global parameters, ClientData); "
        f"determinism setting needed: {setting}")


def profile_train_step(torch, model, b, s, dev, step_s):
    """One training step (after a warm-up step) under ``device_profile``:
    where its device time goes, and the device's idle share of the
    unprofiled median step."""
    from repro_torch import optim
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.registry import make_train_step
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, device=dev)
    state = optim.init_opt_state(params, "adamw")
    step = make_train_step(model, TrainConfig(total_steps=10,
                                              warmup_steps=2), donate=True)
    batch = synth_batch(model.cfg, g, b, s)
    params, state, _ = step(params, state, batch)
    _, busy = device_profile(torch, f"train step {b} x {s:,}",
                             lambda: step(params, state, batch), top=14)
    if busy is not None:
        log(f"  train step device idle share {1 - busy / (step_s * 1e3):.3f}"
            f" of the unprofiled median step's {step_s * 1e3:.2f} ms")


def launch_train(torch, ops, dev, model, label, steps, b, s, profile=True):
    """``launch.train.main`` on ``model``'s full config: ``steps`` steps of
    b x s, the first a warm-up, with every launch count set to 0 and the
    peak counter reset before it; ``_report_steps``; then, if ``profile``,
    one more step profiled (``profile_train_step``). Returns (the launch
    counts, the median step seconds, the peak bytes above the reset)."""
    from repro_torch.launch import train
    base = reset_peak(torch, label)
    for k in ops.KERNELS.values():
        k.launches = 0
    res = train.main(["--arch", model.cfg.name, "--steps", str(steps),
                      "--batch", str(b), "--seq", str(s), "--log-every",
                      str(steps), "--device", str(dev)])
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    med = _report_steps(label, model, b, s,
                        list(zip(res.loss, res.grad_norm, res.lr,
                                 res.seconds)),
                        launches, peak_text(torch, base))
    peak = torch.cuda.max_memory_allocated() - base
    _release(torch)
    if profile:
        profile_train_step(torch, model, b, s, dev, med)
        _release(torch)
    return launches, med, peak


def train_full(torch, ops, dev):
    """Phase 7 (a): Llama-3.2-1B trained at full width through
    ``launch.train.main`` (``launch_train``): 10 steps at 4 x 2,048 tokens
    (the plain attention route, one more step profiled), then 3 at 2 x
    4,096 (the chunked route, the sequence length of
    ``INPUT_SHAPES["train_4k"]``). Returns the launch counts, summed over
    both runs (every hand kernel must stay at 0), and {(b, s): (median step
    seconds, peak bytes above the reset)}."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.models.registry import build_model
    model = build_model(get_config("llama3.2-1b"))
    total = {name: 0 for name in ops.KERNELS}
    steps_at = {}
    for steps, b, s in ((10, 4, 2048),
                        (3, 2, INPUT_SHAPES["train_4k"].seq_len)):
        launches, med, peak = launch_train(torch, ops, dev, model,
                                           f"train {b} x {s:,}", steps, b, s,
                                           profile=s == 2048)
        steps_at[b, s] = med, peak
        for name, v in launches.items():
            total[name] += v
    return total, steps_at


def federated_llm_phase(torch, ops, ref, km_mod, dev):
    """Phase 7 (b): ``examples.federated_llm`` at the example's own size (6
    clients x 64 sequences of 64 tokens, PCA to 16, k = 2, 300 RL episodes,
    2 x 30 FedAvg steps of the smoke Llama), then ``kmeans_assign`` against
    its plain version at that run's shape, and both timed there. Returns
    (launch counts, the shape's entry for the kernel row's ``shapes``)."""
    from repro_torch.examples import federated_llm as fed
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = fed.main(["--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    disc = res.discovery
    n = fed.N_CLIENTS
    log(f"  federated LLM: {secs:.3f} s; perplexity non-iid "
        f"{res.ppl_base:.4f}, smart-D2D {res.ppl_smart:.4f}; moved "
        f"{disc.moved.tolist()}; launches {launches}")
    checks = {
        "kmeans_assign launched 25 times (one per Lloyd step, all clients)":
            launches["kmeans_assign"] == 25,
        "no other kernel launched": all(
            v == 0 for name, v in launches.items() if name != "kmeans_assign"),
        "perplexities finite": math.isfinite(res.ppl_base)
            and math.isfinite(res.ppl_smart),
        "links without self links": bool(
            (disc.graph.in_edge.cpu() != torch.arange(n)).all()),
        "centroids (6, 2, 16) finite": tuple(disc.centroids.shape) ==
            (n, fed.K, fed.N_PCA) and bool(torch.isfinite(disc.centroids).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"federated LLM checks failed: {failed}")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n, fed.N_SEQS, fed.N_PCA), generator=g, device=dev)
    c = torch.randn((n, fed.K, fed.N_PCA), generator=g, device=dev)
    label = f"(e) federated LLM ({n},{fed.N_SEQS},{fed.N_PCA})x" \
        f"({n},{fed.K},{fed.N_PCA})"
    err = check_kmeans(ops, ref, x, c, label)
    b_ms, b_by = kmeans_bound(x, c)
    row = dict(shape=label,
               ms=graph_ms(lambda: km_mod.kmeans_assign_cuda(x, c)),
               plain_ms=graph_ms(lambda: ref.kmeans_assign_ref(x, c)),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    log(f"  kmeans_assign {label}: device {row['ms']:.5f} ms, plain "
        f"{row['plain_ms']:.5f} ms; bound {b_ms:.5f} ms ({b_by})")
    return launches, row


def train_reference(torch, dev):
    """Phase 7 (c): 3 training steps of the smoke Llama (float32
    activations, AdamW, block remat) on the card and on the host from the
    same weights and batches: losses and grad norms within 1e-5 relative,
    the CPU tests' tolerance for the float32 step."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model, make_train_step
    model = build_model(dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                            dtype="float32"))
    step = make_train_step(model, TrainConfig(total_steps=10,
                                              warmup_steps=2))
    host = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(dev), host)
    hs, cs = (optim.init_opt_state(p, "adamw") for p in (host, card))
    g = torch.Generator().manual_seed(1)
    rows = []
    for _ in range(3):
        toks = torch.randint(0, model.cfg.vocab_size, (4, 128), generator=g)
        host, hs, hm = step(host, hs, {"tokens": toks, "labels": toks})
        tc = toks.to(dev)
        card, cs, cm_ = step(card, cs, {"tokens": tc, "labels": tc})
        rows.append([(float(hm[k]), float(cm_[k])) for k in ("loss",
                                                             "grad_norm")])
    worst = max(abs(c - h) / abs(h) for r in rows for h, c in r)
    if worst > 1e-5:
        raise AssertionError(f"train step card vs host: {rows}")
    log(f"  small train step agrees over 3 steps: loss "
        f"{[round(r[0][0], 6) for r in rows]}, grad norm "
        f"{[round(r[1][0], 6) for r in rows]}; worst relative difference "
        f"{worst:.3e}")


# ---------------------------------------------------------------------------
# phase 8: the scan engine, the CIFAR-like main path, the clustering loop
# ---------------------------------------------------------------------------

# library calls whose own error check synchronises; a sync inside a chunk is
# allowed only on a line that calls one of these
LIBRARY_SYNCS = ("torch.linalg.eigh",)


class SyncRecorder:
    """Records every synchronizing CUDA call made inside a wrapped function
    under ``torch.cuda.set_sync_debug_mode("warn")``: the innermost Python
    line that made it and the port's line that led to it."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.syncs = torch, fn, []

    def __call__(self, *args, **kw):
        import linecache
        import traceback
        import warnings
        port = os.path.join("src", "repro_torch") + os.sep

        def hook(message, category, filename, lineno, file=None, line=None):
            # the sync debug mode's own warning (PyTorch appends where it
            # was raised); its one-time notice that the mode is
            # experimental is not a sync
            if not str(message).startswith(
                    "called a synchronizing CUDA operation"):
                return
            frames = traceback.extract_stack()[:-1]
            mine = [f for f in frames if port in f.filename]
            site = mine[-1] if mine else frames[-1]
            self.syncs.append((
                f"{os.path.relpath(filename, ROOT)}:{lineno}",
                linecache.getline(filename, lineno).strip(),
                f"{os.path.relpath(site.filename, ROOT)}:{site.lineno}",
                (site.line or "").strip()))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            self.torch.cuda.set_sync_debug_mode("warn")
            try:
                return self.fn(*args, **kw)
            finally:
                self.torch.cuda.set_sync_debug_mode(0)

    def by_op(self):
        """{(op line, port line): count}, and the entries from the port's
        own code (no listed library call on the port's line)."""
        counts = {}
        for _, op, site, site_line in self.syncs:
            key = (op, f"{site}: {site_line}")
            counts[key] = counts.get(key, 0) + 1
        own = {k: v for k, v in counts.items()
               if not any(lib in k[1] for lib in LIBRARY_SYNCS)}
        return counts, own


def _scan_cfg(impl, **kw):
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.dynamics import OrchestratorConfig
    from repro_torch.fl import FLConfig
    return OrchestratorConfig(
        n_segments=5, iters_per_segment=20, mode="online", rediscover_every=1,
        burst_episodes=150, segment_impl=impl,
        pipeline=PipelineConfig(exchange=ExchangeConfig(
            apply_channel_failure=True, overflow="drop",
            reserve_selector="device")),
        fl=FLConfig(tau_a=10, batch_size=64, eval_every=20), **kw)


def scan_full(torch, ops, dev):
    """Phase 8 (a): ``run_orchestrator`` at full width on phase 4's world
    (N = 30, ``AEConfig()``, ``PipelineConfig()`` but for the scan's
    exchange: channel failures, ``overflow="drop"``, the device reserve
    selector), ``burst-outage``, 5 segments of 20 FL iterations, retries
    off, no checkpoint: segments 1-4 are one chunk. Once eager, once scan,
    from the same ``SeededDraws``. Per segment in_edge, moved, available,
    live and failed links exact and eval losses within 5e-4 relative; equal,
    non-zero kernel launch counts. The chunk runs under the sync debug
    mode, and no synchronizing call may come from the port's own code.
    Returns the scan run's launch counts."""
    from repro_torch.dynamics import SeededDraws, run_orchestrator
    from repro_torch.dynamics import orchestrator as orch
    from repro_torch.models.autoencoder import AEConfig
    xs, ys, ev, _ = full_world(torch, dev)
    runs, recorder = {}, SyncRecorder(torch, orch._chunk)
    for impl in ("eager", "scan"):
        base = reset_peak(torch, f"orchestrator {impl}, burst-outage")
        for k in ops.KERNELS.values():
            k.launches = 0
        if impl == "scan":
            orch._chunk = recorder
        t0 = time.perf_counter()
        try:
            res = run_orchestrator(xs, ys, AEConfig(), _scan_cfg(impl),
                                   "burst-outage", ev.images,
                                   draws=SeededDraws(0, dev), device=dev)
            torch.cuda.synchronize()
        finally:
            orch._chunk = recorder.fn
        secs = time.perf_counter() - t0
        launches = {name: k.launches for name, k in ops.KERNELS.items()}
        runs[impl] = (res, launches)
        chunks = ", ".join(f"segments {a}-{b - 1} {t:.3f} s"
                           for a, b, t in res.chunk_seconds)
        log(f"  {impl}: {secs:.3f} s; segment seconds "
            f"{[round(t, 3) for t in res.segment_seconds]}"
            + (f"; chunk: {chunks}" if chunks else "")
            + f"; {peak_text(torch, base)}; launches {launches}")
    (eager, le), (scan, ls) = runs["eager"], runs["scan"]
    for e, s in zip(eager.trace.segments, scan.trace.segments):
        log(f"  segment {e.segment}: eval loss eager {e.eval_loss:.6f} scan "
            f"{s.eval_loss:.6f}; available {s.n_available}, moved {s.moved}, "
            f"failed {s.n_failed} of {s.n_live} live, churn "
            f"{s.link_churn:.3f}")
        same = ((e.in_edge == s.in_edge).all() and
                (e.moved, e.n_available, e.n_live, e.n_failed) ==
                (s.moved, s.n_available, s.n_live, s.n_failed))
        if not same or not math.isclose(s.eval_loss, e.eval_loss,
                                        rel_tol=5e-4):
            raise AssertionError(f"scan vs eager, segment {e.segment}: "
                                 f"eager {e} scan {s}")
    counts, own = recorder.by_op()
    log(f"  synchronizing calls inside the chunk: {len(recorder.syncs)}")
    for (op, site), k in counts.items():
        log(f"    {k} x {op}  <- {site}")
    checks = {
        "one chunk, segments 1-4": [c[:2] for c in scan.chunk_seconds]
            == [(1, 5)],
        "equal launch counts": le == ls,
        "kmeans_assign and recon_gate launched": ls["kmeans_assign"] > 0
            and ls["recon_gate"] > 0,
        "kmeans_assign 150, recon_gate 10": ls["kmeans_assign"] == 150
            and ls["recon_gate"] == 10,
        "no synchronizing call from the port's own code": not own,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"scan phase (a) checks failed: {failed}; "
                             f"own syncs {own}")
    return ls


def _cut_world(torch):
    """Phase 3's small world with client i cut by 3 i rows, so that the
    fixed-cap exchange has room to move data."""
    xs, ys, ev = small_world(torch)
    return ([x[:len(x) - 3 * i] for i, x in enumerate(xs)],
            [y[:len(y) - 3 * i] for i, y in enumerate(ys)], ev)


def scan_resume(torch, dev):
    """Phase 8 (b): the scan engine at phase 6's small size with retries on
    and ``checkpoint_every=2``, on the every-link copy of ``burst-outage``
    (segment 1's live links fail, and a drain at a chunk boundary retries
    them): killed at segment 2 and resumed from its checkpoint on the card,
    bit-identical (trace, global parameters, ClientData) to the
    uninterrupted scan run."""
    import dataclasses
    import shutil
    from repro_torch.dynamics import SeededDraws, get_scenario, \
        run_orchestrator
    from repro_torch.dynamics import orchestrator as orch
    from repro_torch.faults import Preempted, RetryPolicy
    from repro_torch.models.autoencoder import AEConfig
    from repro_torch.models.common import tree_leaves
    xs, ys, ev = _cut_world(torch)
    ae_cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_scan_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = _small_online(checkpoint_dir=ckpt, checkpoint_every=2,
                        retry=RetryPolicy(enabled=True), segment_impl="scan")
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, exchange=dataclasses.replace(
            cfg.pipeline.exchange, overflow="drop",
            reserve_selector="device")))
    scn = get_scenario("burst-outage")
    whole = dataclasses.replace(
        scn, name="burst-outage, every link", faults=dataclasses.replace(
            scn.faults, link_bursts=tuple(dataclasses.replace(b, frac=1.0)
                                          for b in scn.faults.link_bursts)))
    killed = dataclasses.replace(whole, faults=dataclasses.replace(
        whole.faults, preempt_at=2))

    def run(scenario, **kw):
        return run_orchestrator(xs, ys, ae_cfg, cfg, scenario, ev.images,
                                draws=SeededDraws(4, dev), device=dev, **kw)

    def fingerprint(res):
        recs = [(s.segment, s.eval_loss, s.in_edge.tolist(), s.link_churn,
                 s.mean_pfail, s.expected_delivery, s.realized_delivery,
                 s.n_available, s.moved, s.eval_curve.tolist(), s.n_live,
                 s.n_failed, s.retried, s.retry_delivered)
                for s in res.trace.segments]
        return recs, [t.cpu() for t in tree_leaves(res.global_params)] + \
            [t.cpu() for t in res.client_data]

    try:
        ref = run(whole)
        first = fingerprint(ref)
        try:
            run(killed)
            raise AssertionError("the scan run did not preempt")
        except Preempted as e:
            if e.segment != 2 or not os.path.exists(e.checkpoint):
                raise AssertionError(f"preempted at {e.segment}, "
                                     f"checkpoint {e.checkpoint}")
        again = fingerprint(run(killed, resume_from=cfg.checkpoint_path))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if first[0] != again[0] or not all(
            torch.equal(a, b) for a, b in zip(first[1], again[1])):
        raise AssertionError("the resumed scan run differs from the "
                             "uninterrupted one")
    segs = ref.trace.segments
    bounds = {b - 1 for b in
              (c[1] for c in orch._chunk_bounds(cfg, killed.faults, 1,
                                                cfg.checkpoint_path))}
    drained = [s.segment for s in segs if s.retried]
    if not drained or not set(drained) <= bounds or segs[1].n_failed < 1:
        raise AssertionError(f"no retry drained at a chunk boundary: "
                             f"failed {[s.n_failed for s in segs]}, retried "
                             f"{[s.retried for s in segs]}")
    log(f"  scan, kill at segment 2 and resume: bit-identical to the "
        f"uninterrupted scan run; chunks {[c[:2] for c in ref.chunk_seconds]}"
        f", failed {[s.n_failed for s in segs]}, retried "
        f"{[s.retried for s in segs]} (drained at {drained}), moved "
        f"{[s.moved for s in segs]}")


def cifar_main_path(torch, ops, ref, rg_mod, dev):
    """Phase 8 (c): the one-shot main path on a CIFAR-like world:
    ``cifar_like_split`` at 5,000 train and 30 eval images per class, N = 30
    with 3 circular classes each, ``AEConfig(32, 32, 3, widths=(8, 16),
    latent_dim=32)``, ``PipelineConfig()``; then 2 FL rounds and linear
    evaluation. ``recon_gate`` is then held against its plain version at
    the gate's (30, cap, 3072) base shape, on the final model's
    reconstructions of the exchanged stack, and both are timed there.
    Returns (launch counts, the shape's entry for the kernel row)."""
    from repro_torch.core.pipeline import PipelineConfig, run_pipeline
    from repro_torch.data import cifar_like_split, partition_by_classes
    from repro_torch.fl import FLConfig, fl_train, linear_evaluation
    from repro_torch.models import autoencoder as ae
    from repro_torch.models.autoencoder import AEConfig
    from repro_torch.models.common import tree_map
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    train, ev = cifar_like_split(gen, n_train_per_class=5000,
                                 n_eval_per_class=30)
    xs, ys, _ = partition_by_classes(0, train.images.cpu().numpy(),
                                     train.labels.cpu().numpy(),
                                     n_clients=30, classes_per_client=3,
                                     circular=True)
    del train
    log(f"  CIFAR-like world: {sum(x.shape[0] for x in xs)} images of "
        f"{xs[0].shape[1:]} over {len(xs)} clients; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    ae_cfg = AEConfig(32, 32, 3, widths=(8, 16), latent_dim=32)
    base = reset_peak(torch, "CIFAR-like main path")
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = run_pipeline(xs, ys, ae_cfg, PipelineConfig(), generator=gen,
                       device=dev)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = fl_train(res.client_data, ae_cfg, FLConfig(
        total_iters=20, tau_a=10, batch_size=64, eval_every=10), ev.images,
        generator=gen, device=dev)
    torch.cuda.synchronize()
    t_fl = time.perf_counter() - t0
    half = ev.images.shape[0] // 2
    acc, _ = linear_evaluation(fl.global_params, ae_cfg, ev.images[:half],
                               ev.labels[:half], ev.images[half:],
                               ev.labels[half:], device=dev)
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    log(f"  run_pipeline {t_pipe:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items())
        + f"), fl_train (2 rounds) {t_fl:.3f} s; {peak_text(torch, base)}")
    log(f"  moved {res.moved_counts.tolist()}; eval loss "
        f"{fl.eval_loss.tolist()}; linear-eval accuracy {acc:.4f}; "
        f"launches {launches}")

    cd = res.client_data
    n, cap = cd.n_clients, cd.cap
    stacked = tree_map(lambda p: p.expand((n,) + tuple(p.shape)).contiguous(),
                       fl.global_params)
    with torch.no_grad():
        y = ae.reconstruct_stacked(stacked, cd.data, ae_cfg).reshape(
            n, cap, -1)
    own = (torch.arange(cap, device=dev)[None, :]
           < cd.sizes[:, None]).float()
    xf = cd.data.reshape(n, cap, -1).contiguous()
    label = f"CIFAR-like ({n},{cap},{y.shape[-1]}), own-data mask"
    err = check_recon(ops, ref, y, xf, own, label)
    b_ms, b_by = bound(8 * y.numel() + 4 * n * cap + 4 * n,
                       3 * y.numel() + 3 * n * cap)
    row = dict(shape=label, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               ms=graph_ms(lambda: rg_mod.recon_gate_cuda(y, xf, own),
                           iters=20),
               plain_ms=graph_ms(lambda: ref.recon_gate_ref(y, xf, own),
                                 iters=20))
    log(f"  recon_gate {label}: device {row['ms']:.5f} ms, plain "
        f"{row['plain_ms']:.5f} ms; bound {b_ms:.5f} ms ({b_by})")
    checks = {
        "kmeans_assign 50, recon_gate 2": launches["kmeans_assign"] == 50
            and launches["recon_gate"] == 2,
        "eval losses finite": all(math.isfinite(v) for v in fl.eval_loss),
        "pixels 3072": y.shape[-1] == 3072,
        "centroids (30, 3, 32) finite": tuple(res.centroids.shape)
            == (30, 3, 32) and bool(torch.isfinite(res.centroids).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"CIFAR-like main path checks failed: {failed}")
    return launches, row


def clustering_loop_phase(torch, ops, ref, km_mod, dev):
    """Phase 8 (d): ``cluster_clients_loop`` and ``wcss_elbow`` on phase 3's
    small world, card against host from the same draws: assignments
    exact, centroids within 1e-4 after aligning each PCA column's sign, the
    same elbow k. Counts ``kmeans_assign``'s 2-D launches on the card (one
    per client and Lloyd step, one per candidate and Lloyd step), then
    holds the kernel against its plain version at the loop's 2-D shape and
    times both there. Returns the shape's entry for the kernel row."""
    from repro_torch.core import kmeans as km
    from repro_torch.core import pipeline as pl
    xs, _, _ = small_world(torch)
    cfg = pl.PipelineConfig(n_pca=4, kmeans_iters=5)
    g = torch.Generator().manual_seed(6)
    draws = km.draw_kmeans(g, [len(x) for x in xs], cfg.n_clusters)
    ks = [1, 2, 3, 4, 5, 6]
    single = {k: km.draw_kmeans(g, [len(xs[0])], k) for k in ks}

    def run(device):
        d = km.KMeansDraws(*(a.to(device) for a in draws))
        pca, cents, assigns = pl.cluster_clients_loop(xs, cfg, d,
                                                      device=device)
        z = pca.transform(torch.as_tensor(xs[0], device=device).reshape(
            len(xs[0]), -1))
        k = km.wcss_elbow(z, ks, lambda k: km.KMeansDraws(
            single[k].first[0].to(device), single[k].u[0].to(device)))
        return pca, cents.cpu(), assigns.cpu(), k

    hp, hc, ha, hk = run("cpu")
    for kern in ops.KERNELS.values():
        kern.launches = 0
    cp, cc, ca, ck = run(dev)
    launches = ops.KERNELS["kmeans_assign"].launches
    signs = torch.sign(torch.sum(hp.components * cp.components.cpu(), 0))
    sizes = [len(x) for x in xs]
    same_assign = all(torch.equal(ha[i, :s], ca[i, :s])
                      for i, s in enumerate(sizes))
    cent_err = float((cc * signs - hc).abs().max())
    want = len(xs) * cfg.kmeans_iters + 25 * len(ks)
    log(f"  cluster_clients_loop and wcss_elbow, card vs host: assignments "
        f"equal {same_assign}, max centroid difference {cent_err:.2e}, "
        f"elbow k host {hk} card {ck}; kmeans_assign 2-D launches "
        f"{launches} (want {want})")
    if not (same_assign and cent_err < 1e-4 and hk == ck
            and launches == want and bool((signs != 0).all())):
        raise AssertionError("clustering loop phase failed")
    x = cp.transform(torch.as_tensor(xs[1], device=dev).reshape(
        len(xs[1]), -1)).contiguous()
    c = x[:cfg.n_clusters].contiguous()
    label = f"(f) clustering loop, 2-D ({len(xs[1])},{x.shape[1]})x" \
        f"({cfg.n_clusters},{x.shape[1]})"
    err = check_kmeans(ops, ref, x, c, label)
    b_ms, b_by = kmeans_bound(x, c)
    row = dict(shape=label, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               ms=graph_ms(lambda: km_mod.kmeans_assign_cuda(x, c)),
               plain_ms=graph_ms(lambda: ref.kmeans_assign_ref(x, c)))
    log(f"  kmeans_assign {label}: device {row['ms']:.5f} ms, plain "
        f"{row['plain_ms']:.5f} ms; bound {b_ms:.3e} ms ({b_by})")
    return row


# ---------------------------------------------------------------------------
# phase 9: the observability plane
# ---------------------------------------------------------------------------

OBS_DIR = os.path.join(ROOT, "runs", "obs")
# span counts of phase 6's config (5 segments, the burst-outage plan over
# segments 1-4, a rediscovery and re-exchange in each)
ONLINE_SPANS = {"orchestrator": 1, "pipeline": 1, "segment": 5,
                "fl-segment": 5, "fl": 5, "env-step": 4, "fault-inject": 4,
                "re-cluster": 4, "re-discover": 4, "re-exchange": 4,
                "metrics-materialize": 1}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _traced(torch, ops, dev, cfg, manifest):
    """One full-width ``burst-outage`` run under ``obs.enable`` (a manifest
    at ``manifest``), the launch counts set to 0 just before it and read
    just after. Returns (result, obs record, launches, seconds)."""
    from repro_torch import obs
    from repro_torch.dynamics import SeededDraws, run_orchestrator
    from repro_torch.models.autoencoder import AEConfig
    xs, ys, ev, _ = full_world(torch, dev)
    for k in ops.KERNELS.values():
        k.launches = 0
    obs.enable(manifest=manifest, meta={
        "scenario": "burst-outage", "segment_impl": cfg.segment_impl,
        "card": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    try:
        res = run_orchestrator(xs, ys, AEConfig(), cfg, "burst-outage",
                               ev.images, draws=SeededDraws(0, dev),
                               device=dev)
        torch.cuda.synchronize()
    finally:
        rec = obs.disable()
    secs = time.perf_counter() - t0
    return res, rec, {n: k.launches for n, k in ops.KERNELS.items()}, secs


def _log_report(path):
    from repro_torch.obs import report
    for line in report.report(path).splitlines():
        log(f"    {line}")


def _one_transfer(rec):
    """One counted transfer, inside ``metrics-materialize``."""
    carriers = [(e.name, e.transfers) for e in rec["events"] if e.transfers]
    return rec["totals"]["transfers"] == 1 and carriers == [
        ("metrics-materialize", 1), ("orchestrator", 1)]


def traced_online(torch, ops, dev, online, online_segs):
    """Phase 9 (a): phase 6's full-width ``burst-outage`` run, traced.
    Prints the report table; asserts the span counts the config implies,
    one transfer inside ``metrics-materialize``, no compile (phase 1
    loaded every library), phase 6's launch counts, and phase 6's graphs,
    moved and retry counts, with eval losses within 5e-4 relative (two
    card runs differ by cuDNN's sums). Returns (launches, seconds, span
    count)."""
    path = os.path.join(OBS_DIR, "chip_online.jsonl")
    res, rec, launches, secs = _traced(torch, ops, dev, _online_cfg(), path)
    log(f"  traced online run: {secs:.3f} s, {len(rec['events'])} spans, "
        f"launches {launches}; report of {os.path.relpath(path, ROOT)}:")
    _log_report(path)
    counts = {}
    for e in rec["events"]:
        counts[e.name] = counts.get(e.name, 0) + 1
    retries = sum(seg.retried > 0 for seg in online_segs)
    checks = {
        f"span counts {ONLINE_SPANS}":
            all(counts.get(k) == v for k, v in ONLINE_SPANS.items()),
        f"retry-exchange spans == segments that retried ({retries})":
            counts.get("retry-exchange", 0) == retries,
        "one transfer, inside metrics-materialize": _one_transfer(rec),
        "no compile": rec["totals"]["compiles"] == 0,
        "kmeans_assign and recon_gate launches as phase 6":
            all(launches[k] == online[k]
                for k in ("kmeans_assign", "recon_gate")),
    }
    for a, b in zip(online_segs, res.trace.segments):
        same = ((a.in_edge == b.in_edge).all() and
                (a.moved, a.retried, a.retry_delivered, a.n_failed) ==
                (b.moved, b.retried, b.retry_delivered, b.n_failed))
        checks[f"segment {a.segment}: graph, moved, retries as phase 6; "
               "eval loss within 5e-4"] = bool(same) and math.isclose(
                   a.eval_loss, b.eval_loss, rel_tol=5e-4)
        log(f"  segment {a.segment}: eval loss phase 6 {a.eval_loss:.6f} "
            f"traced {b.eval_loss:.6f}; moved {b.moved}, retried "
            f"{b.retried}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 9 (a) checks failed: {failed}; "
                             f"span counts {counts}")
    return launches, secs, len(rec["events"])


def traced_scan(torch, ops, dev, scanned):
    """Phase 9 (b): phase 8 (a)'s scan run, traced. Asserts ``scan-chunk``
    spans at the bounds ``chunk_seconds`` reports, no named span inside a
    chunk, one transfer, and phase 8's launch counts. Returns (launches,
    seconds, the chunk's seconds)."""
    from repro_torch.obs import report
    path = os.path.join(OBS_DIR, "chip_scan.jsonl")
    res, rec, launches, secs = _traced(torch, ops, dev, _scan_cfg("scan"),
                                       path)
    log(f"  traced scan run: {secs:.3f} s, {len(rec['events'])} spans, "
        f"chunks {[c[:2] for c in res.chunk_seconds]}, launches "
        f"{launches}; report of {os.path.relpath(path, ROOT)}:")
    _log_report(path)
    spans = [e.to_dict() for e in rec["events"]]
    parents = report.assign_parents(spans)
    chunks = [(s["attrs"]["start"], s["attrs"]["start"]
               + s["attrs"]["n_segments"]) for s in spans
              if s["name"] == "scan-chunk"]
    inside = [s["name"] for s, p in zip(spans, parents)
              if p is not None and spans[p]["name"] == "scan-chunk"]
    checks = {
        "scan-chunk spans at chunk_seconds' bounds":
            chunks == [c[:2] for c in res.chunk_seconds] == [(1, 5)],
        "no named span inside a chunk": not inside,
        "one transfer, inside metrics-materialize": _one_transfer(rec),
        "launches as phase 8": launches == scanned,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 9 (b) checks failed: {failed}; "
                             f"inside {inside}")
    return launches, secs, res.chunk_seconds[0][2]


def _busy(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def trace_shares(path, windows, top=6):
    """From a Chrome trace: for each named window (the host range a span
    opened while profiling), the device's busy ms (the union of kernel,
    copy and set intervals inside it, so that events the trace shows
    overlapping count once), its idle share, the summed event ms, and the
    ``top`` kernels by summed device time. Returns {window: (window ms,
    busy ms, idle share)}; busy is None when the trace holds no device
    event."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    dev_evs = [e for e in evs if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
    log(f"  trace {os.path.relpath(path, ROOT)}: "
        f"{os.path.getsize(path) / 2**20:.1f} MiB, {len(evs)} events, "
        f"{len(dev_evs)} on the device")
    out = {}
    for name in windows:
        rng = [e for e in evs if e.get("ph") == "X" and e.get("name") == name
               and e.get("cat") != "gpu_user_annotation"]
        if len(rng) != 1:
            raise AssertionError(f"trace: {len(rng)} ranges named {name}")
        lo, hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
        inside = [e for e in dev_evs if e["ts"] < hi
                  and e["ts"] + e["dur"] > lo]
        if not inside:
            log(f"  {name}: window {(hi - lo) / 1e3:.3f} ms; device time "
                "not measured (the profiler saw no device events)")
            out[name] = ((hi - lo) / 1e3, None, None)
            continue
        busy = _busy([(e["ts"], e["ts"] + e["dur"]) for e in inside],
                     lo, hi)
        summed = sum(e["dur"] for e in inside)
        streams = {}
        for e in inside:
            sid = e.get("args", {}).get("stream")
            streams[sid] = streams.get(sid, 0.0) + e["dur"] / 1e3
        out[name] = ((hi - lo) / 1e3, busy / 1e3, 1 - busy / (hi - lo))
        log(f"  {name}: window {(hi - lo) / 1e3:.3f} ms (profiled), device "
            f"busy {busy / 1e3:.3f} ms over {len(inside)} device events "
            f"(their durations sum to {summed / 1e3:.3f} ms; ms by stream "
            f"{ {k: round(v, 3) for k, v in streams.items()} }), idle "
            f"share {1 - busy / (hi - lo):.4f}")
        by_name = {}
        for e in inside:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            log(f"    {us / 1e3:9.3f} ms  {100 * us / summed:5.1f}%  "
                f"{k[:90]}")
    return out


def profiled_runs(torch, ops, dev, online_secs, scan_secs, chunk_secs):
    """Phase 9 (c): the runs of (a) and (b) again, traced and under
    ``obs.maybe_profile`` (each span opens a profiler range). From each
    written Chrome trace: device busy ms, idle share and top kernels of
    the whole online run, the whole scan run and its chunk; each idle share
    is also given against the unprofiled window's seconds from (a) and (b)
    (the profiler slows the host, not the device)."""
    from repro_torch import obs
    prof_dir = os.path.join(OBS_DIR, "profile")
    for tag, cfg, unprofiled in (
            ("online", _online_cfg(), {"orchestrator": online_secs}),
            ("scan", _scan_cfg("scan"), {"orchestrator": scan_secs,
                                         "scan-chunk": chunk_secs})):
        with obs.maybe_profile(tag, out_dir=prof_dir):
            _, _, _, psecs = _traced(
                torch, ops, dev, cfg, os.path.join(OBS_DIR,
                                                   f"chip_{tag}_prof.jsonl"))
        log(f"  profiled {tag} run: {psecs:.3f} s (unprofiled "
            f"{online_secs if tag == 'online' else scan_secs:.3f} s)")
        got = trace_shares(os.path.join(prof_dir, tag, "trace.json"),
                           tuple(unprofiled))
        for name, (_, busy, _) in got.items():
            if busy is not None:
                ms = unprofiled[name] * 1e3
                log(f"  {tag} {name}: device busy {busy:.3f} ms of the "
                    f"unprofiled {ms:.3f} ms: idle share {1 - busy / ms:.4f}")


def disabled_span_cost(n_spans, online_secs, reps=10**6):
    """Phase 9 (d): ``reps`` disabled span enters and exits on the host,
    scaled to (a)'s span count, must stay under 1% of (a)'s seconds."""
    from repro_torch import obs
    if obs.enabled():
        raise AssertionError("the tracer is still on")
    t0 = time.perf_counter()
    for _ in range(reps):
        with obs.span("segment", segment=0):
            pass
    per = (time.perf_counter() - t0) / reps
    cost = per * n_spans
    log(f"  disabled span: {per * 1e9:.1f} ns per enter and exit; x "
        f"{n_spans} spans = {cost * 1e6:.2f} us, "
        f"{100 * cost / online_secs:.5f}% of the traced run's "
        f"{online_secs:.3f} s")
    if cost >= 0.01 * online_secs:
        raise AssertionError("disabled spans cost 1% of the run or more")


# ---------------------------------------------------------------------------
# phase 10: the recurrent families served at full width
# ---------------------------------------------------------------------------

# arch, batch, prompt, generated tokens, the flash kernel its bf16 prefill
# launches and how often (head_dim 256: the tensor-core kernel)
RECURRENT_SERVES = (
    ("recurrentgemma-2b", 4, 4096, 32, "flash_attention_sm90", 8),
    ("xlstm-125m", 4, 2048, 32, None, 0))


def _routes_against_f32(torch, ops, model, params, batch, lk, lp, n_flash,
                        f32_launches, rows=None, by="max"):
    """The served prefill's kernel route held to its plain route at full
    width. In bf16 the two differ by more than the kernel does: its output
    agrees with the plain (chunked, f32) route's to a bf16 rounding (phase
    2), but 26 bf16 layers amplify one-ulp differences (0.119 on logits up
    to 5 on an H100). So the same weights and tokens run once
    more with float32 activations through both routes, which must agree
    within 1e-3 (phase 5's f32 bound: the routes differ only in the order
    of f32 sums), and against those f32 plain logits the bf16 kernel route
    may be at most 3e-2 farther than the bf16 plain route: by the largest
    error (``by="max"``) or by the root mean square over the logits
    (``by="rms"``, phase 12: on a wider model one logit of the chaotic
    bf16 amplification decides the largest error, see PERF.md). Both are
    printed. ``batch`` is the prefill batch of the bf16 logits lk (kernel)
    and lp (plain); with ``rows`` the f32 prefills take its first ``rows``
    rows (the f32 route at batch 1, as phase 5 serves it) and are held to
    those rows of lk and lp. The f32 kernel route's ``flash_attention``
    launches go into ``f32_launches`` under the model's name. Returns the
    checks; prints the errors."""
    import dataclasses
    from repro_torch.models.registry import build_model
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    if rows is not None:
        batch = {k: v[:rows] for k, v in batch.items()}
        lk, lp = lk[:rows], lp[:rows]
    before = ops.KERNELS["flash_attention"].launches
    lk32, _ = m32.prefill(params, batch, use_flash=True)
    launched = ops.KERNELS["flash_attention"].launches - before
    f32_launches[model.cfg.name] = launched
    lp32, _ = m32.prefill(params, batch, use_flash=False)
    err32 = float((lk32 - lp32).abs().max())
    err = {route: (float((lb - lp32).abs().max()),
                   float((lb - lp32).square().mean().sqrt()))
           for route, lb in (("kernel", lk), ("plain", lp))}
    log(f"  {model.cfg.name} f32 prefill, kernel vs plain route: max err "
        f"{err32:.3e} ({launched} flash_attention launches); bf16 routes "
        f"against the f32 plain logits: kernel max {err['kernel'][0]:.3e} "
        f"rms {err['kernel'][1]:.3e}, plain max {err['plain'][0]:.3e} rms "
        f"{err['plain'][1]:.3e}")
    i = 0 if by == "max" else 1
    return {
        f"f32 prefill launched flash_attention {n_flash} times":
            launched == n_flash,
        "f32 prefill: kernel route vs plain route within 1e-3": err32 <= 1e-3,
        f"bf16 prefill: kernel route at most 3e-2 farther ({by}) from the f32 "
        "plain logits than the bf16 plain route":
            err["kernel"][i] <= err["plain"][i] + 3e-2,
    }


def recurrent_serve_phase(torch, ops, dev, f32_launches):
    """Phase 10: recurrentgemma-2b and xlstm-125m (their configs unchanged,
    weights drawn from seed 0) served through ``launch.serve.serve`` at
    batch 4 (a 4,096- and a 2,048-token prompt, 32 sampled tokens each);
    recurrentgemma's 8 local-attention layers launch the tensor-core flash
    kernel once each in the prefill and nothing in decode, xLSTM launches
    no kernel. Then the same prefill with ``use_flash=False`` on the card,
    held to the kernel route as ``_routes_against_f32`` says, and one
    profiled decode step from its cache.
    Returns {arch: launch counts of the serve}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    out = {}
    for arch, batch, prompt, gen, kernel, n_flash in RECURRENT_SERVES:
        cfg = get_config(arch)
        model = build_model(cfg)
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(0)
        params = model.init(g, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                               generator=g, device=dev)
        torch.cuda.synchronize()
        log(f"  {arch}: {model.n_params():,} parameters ({cfg.param_dtype}, "
            f"{cfg.dtype} activations), drawn in "
            f"{time.perf_counter() - t0:.2f} s")
        serve(model, params, tokens[:, :256], 2, generator=g,
              device=dev)   # warm-up
        base = reset_peak(torch, f"{arch} serve")
        for k in ops.KERNELS.values():
            k.launches = 0
        res = serve(model, params, tokens, gen, temperature=1.0,
                    generator=g, device=dev)
        launches = {name: k.launches for name, k in ops.KERNELS.items()}
        peak = peak_text(torch, base)
        lp, cache = model.prefill(params, {"tokens": tokens},
                                  max_len=prompt + gen, use_flash=False)
        err = float((res.logits - lp).abs().max())
        scale = float(lp.abs().max())
        toks = res.tokens
        checks = {
            f"{kernel} launched {n_flash} times (once per local_attn layer "
            "of the prefill, none in decode), no other kernel":
                launches == {n: (n_flash if n == kernel else 0)
                             for n in launches},
            f"tokens ({batch}, {gen}) in [0, vocab)":
                tuple(toks.shape) == (batch, gen)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "prefill logits finite":
                bool(torch.isfinite(res.logits).all())
                and tuple(res.logits.shape) == (batch, 1, cfg.vocab_size),
        }
        if n_flash:
            checks.update(_routes_against_f32(torch, ops, model, params,
                                              {"tokens": tokens}, res.logits,
                                              lp, n_flash, f32_launches))
        steps = gen - 1
        step_ms = res.decode_s * 1e3 / steps
        log(f"  {arch} prefill {batch}x{prompt}: {res.prefill_s * 1e3:.2f} "
            f"ms ({batch * prompt / res.prefill_s:.0f} tok/s)")
        log(f"  {arch} decode {steps} steps x {batch} seqs: "
            f"{res.decode_s * 1e3:.2f} ms ({steps * batch / res.decode_s:.0f}"
            f" tok/s, {step_ms:.3f} ms per step)")
        log(f"  {arch} serve: {peak}")
        log(f"  {arch} last-token logits, kernel route vs plain route: max "
            f"err {err:.3e} (|logits| <= {scale:.3f})")
        log(f"  {arch} sampled tokens[0][:8] {toks[0, :8].tolist()}; "
            f"launches {launches}")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{arch} serving checks failed: {failed}")
        _, busy = device_profile(torch, f"{arch} one decode step",
                                 lambda: model.decode(
                                     params, cache, {"token": toks[:, :1]}))
        if busy is not None:
            log(f"  {arch} decode device idle share {1 - busy / step_ms:.3f}"
                f" of the unprofiled serve loop's {step_ms:.3f} ms per step")
        out[arch] = launches
        del params, cache, res, lp
    return out


# ---------------------------------------------------------------------------
# phase 11: the MoE family served at full width
# ---------------------------------------------------------------------------

# qwen2-moe-a2.7b's parameters and active parameters a token (JAX's counts)
QWEN2_MOE_COUNTS = (14_315_587_584, 2_688_976_896)
# arch, the layers served of its config's: full depth does not fit one
# 80 GB card in float32 (phi3.5-moe 155.99 GiB, moonshot 107.62 GiB);
# phase 14 (b) serves moonshot's 48 layers with bf16 parameters (53.81 GiB)
MOE_CUT = (("phi3.5-moe-42b-a6.6b", 8), ("moonshot-v1-16b-a3b", 8))
# bf16 kernel route vs plain route with the routing pinned: twice the
# 0.147 an H100 showed (the two routes round attention at other places,
# one bf16 rounding of its output by phase 2, amplified over 24 layers, as
# recurrentgemma's 26 layers amplify it to 0.119 in phase 10)
BF16_PINNED = 0.3


def _release(torch):
    """Frees what the last model left in the caching allocator, so the
    next model's draw starts from an empty card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _draw(torch, model, dev):
    """The model's weights drawn from seed 0 on the card, with the draw's
    seconds and peak (each leaf is scaled in place: the peak is the
    weights); returns (params, the generator, now past the draws)."""
    cfg = model.cfg
    base = reset_peak(torch, f"{cfg.name} ({cfg.n_layers} layers) draw")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, device=dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}, {cfg.n_layers} layers: {model.n_params():,} "
        f"parameters ({cfg.param_dtype}, {cfg.dtype} activations), "
        f"{model.n_active_params():,} active a token; drawn in "
        f"{time.perf_counter() - t0:.2f} s; draw {peak_text(torch, base)}")
    return params, g


def _timed_serve(torch, ops, model, params, g, dev, prompt, warm, gen):
    """A warm-up serve of ``warm``, then the serve of ``prompt`` (a (B, S)
    token tensor or a frontend's prefill batch) + ``gen`` tokens with every
    launch count set to 0 just before it and read just after; prints
    prefill ms, tokens/s, decode ms a step and the peak. Checks that the
    tensor-core flash kernel launched once per layer and nothing else did,
    and the tokens' and logits' shapes (an audio model's carry the
    codebook axis). Returns (result, launches, checks)."""
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    b = next(iter(batch.values())).shape[0]
    s = sum(batch[k].shape[1] for k in ("embeds", "tokens", "codes")
            if k in batch)
    serve(model, params, warm, 2, generator=g, device=dev)
    base = reset_peak(torch, f"{cfg.name} serve")
    for k in ops.KERNELS.values():
        k.launches = 0
    res = serve(model, params, prompt, gen, temperature=1.0, generator=g,
                device=dev)
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    peak = peak_text(torch, base)
    steps = gen - 1
    log(f"  {cfg.name} prefill {b}x{s}: {res.prefill_s * 1e3:.2f} ms"
        f" ({b * s / res.prefill_s:.0f} tok/s)")
    log(f"  {cfg.name} decode {steps} steps x {b} seqs: "
        f"{res.decode_s * 1e3:.2f} ms ({steps * b / res.decode_s:.0f} "
        f"tok/s, {res.decode_s * 1e3 / steps:.3f} ms per step)")
    log(f"  {cfg.name} serve: {peak}")
    log(f"  {cfg.name} sampled tokens[0][:8] {res.tokens[0, :8].tolist()}; "
        f"launches {launches}")
    toks = res.tokens
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    checks = {
        f"flash_attention_sm90 launched {cfg.n_layers} times (once per "
        "layer of the prefill), no other kernel":
            launches == {n: (cfg.n_layers if n == "flash_attention_sm90"
                             else 0) for n in launches},
        f"tokens {(b, gen) + nq} in [0, vocab)":
            tuple(toks.shape) == (b, gen) + nq
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "prefill logits finite": bool(torch.isfinite(res.logits).all())
            and tuple(res.logits.shape) == (b, 1) + nq + (cfg.vocab_size,),
    }
    return res, launches, checks


def _moe_serve(torch, ops, model, params, g, dev, batch, prompt, gen):
    """``_timed_serve`` of ``batch`` x ``prompt`` tokens drawn from ``g``,
    warmed up on their first 256. Returns (result, tokens, launches,
    checks)."""
    tokens = torch.randint(0, model.cfg.vocab_size, (batch, prompt),
                           generator=g, device=dev)
    res, launches, checks = _timed_serve(torch, ops, model, params, g, dev,
                                         tokens, tokens[:, :256], gen)
    return res, tokens, launches, checks


def _first_layer_routing(torch, moe, cfg, probs, groups):
    """Prints, from layer 0's router probabilities as a served prefill
    computed them (``router_tape``), the share of (token, expert) choices
    that the einsum dispatch's capacity dropped, the largest load of an
    expert in a group against the capacity and the smallest margin between
    a token's k-th and (k+1)-th router probability."""
    r = moe.decide(probs.reshape(groups, -1, cfg.n_experts), cfg)
    chosen, dropped = int(r.mask.sum()), int((r.mask & ~r.keep).sum())
    top = torch.sort(r.probs, dim=-1, descending=True).values
    k = cfg.experts_per_token
    margin = float((top[..., k - 1] - top[..., k]).min())
    load = int(r.mask.sum(1).max())
    log(f"  {cfg.name} layer 0 routing ({r.probs.shape[0]} groups of "
        f"{r.probs.shape[1]} tokens, capacity {r.cap}): dropped {dropped} of "
        f"{chosen} (token, expert) choices ({dropped / chosen:.4f}); the "
        f"busiest expert drew {load} in a group; smallest top-{k} margin "
        f"{margin:.3e}")


@contextlib.contextmanager
def first_moe_input(moe):
    """Inside the block, the first MoE layer called stores its (parameters,
    input) under "first" in the dict it yields."""
    got, real = {}, moe.moe_forward

    def taped(params, x, cfg):
        got.setdefault("first", (params, x))
        return real(params, x, cfg)
    moe.moe_forward = taped
    try:
        yield got
    finally:
        moe.moe_forward = real


@contextlib.contextmanager
def router_tape(moe, replay=None):
    """Inside the block, every MoE layer's router probabilities, in call
    order, are appended to the list it yields. Given ``replay`` (such a
    list from another run), each call returns the recorded probabilities
    instead: the routing decisions (top-k, ranks, capacity drops) and the
    gates of the recorded run are pinned."""
    tape, real = [], moe.router_probs
    recorded = None if replay is None else iter(replay)

    def taped(params, x2d):
        probs = real(params, x2d) if recorded is None else next(recorded)
        tape.append(probs)
        return probs
    moe.router_probs = taped
    try:
        yield tape
    finally:
        moe.router_probs = real


def _flips(moe, cfg, tape_a, tape_b, groups):
    """Routing differences of two runs, layer by layer: (tokens whose top-k
    set differs, (token, expert) choices whose capacity keep differs, the
    first layer with either, or None)."""
    tokens = choices = 0
    first = None
    for i, (pa, pb) in enumerate(zip(tape_a, tape_b)):
        ra = moe.decide(pa.reshape(groups, -1, cfg.n_experts), cfg)
        rb = moe.decide(pb.reshape(groups, -1, cfg.n_experts), cfg)
        t = int((ra.mask != rb.mask).any(-1).sum())
        c = int((ra.keep != rb.keep).sum())
        tokens, choices = tokens + t, choices + c
        if first is None and (t or c):
            first = i
    return tokens, choices, first


def qwen2_moe_routes(torch, ops, model, params, tokens, f32_launches):
    """The served prefill's kernel route held to its plain route at full
    width, in float32 activations (the 3xTF32 flash kernel, 24
    launches) and in bf16 (the tensor-core one). Routing is discontinuous:
    the two routes' f32 sums in other orders move a router probability by
    ~1e-7, layer 0's closest top-4 margin is ~3e-7 (phase 11 (a) prints
    it), and a flipped choice shifts the capacity rank of every later
    choice of its expert in the row. So each route is run as served, and
    the plain route once more with its routing pinned to the kernel
    route's (``router_tape``): pinned, the f32 routes must agree within
    1e-3 (phase 5's bound: f32 sums in other orders), and in bf16 within
    ``BF16_PINNED``. As served, the routes' distance and the routing flips
    between them (``_flips``) are printed as a reading, and so are both
    served bf16 routes' distances from the f32 plain logits. The served
    bf16 kernel route also gives layer 0's routing
    (``_first_layer_routing``) and its MoE parameters and input; the f32
    kernel route's ``flash_attention`` launches go into ``f32_launches``
    under the model's name. Returns (the checks, those parameters, that
    input)."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    cfg = model.cfg
    groups, n = tokens.shape[0], cfg.n_layers
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    got = {}
    for label, m in (("bf16", model), ("f32", m32)):
        before = {k: v.launches for k, v in ops.KERNELS.items()}
        with router_tape(moe) as tape_k, first_moe_input(moe) as tap:
            lk, _ = m.prefill(params, {"tokens": tokens}, use_flash=True)
        launched = {k: v.launches - before[k] for k, v in ops.KERNELS.items()}
        with router_tape(moe) as tape_p:
            lp, _ = m.prefill(params, {"tokens": tokens}, use_flash=False)
        with router_tape(moe, replay=tape_k):
            pinned, _ = m.prefill(params, {"tokens": tokens}, use_flash=False)
        flips = _flips(moe, cfg, tape_k, tape_p, groups)
        got[label] = dict(kernel=lk, plain=lp, launched=launched, flips=flips,
                          err=float((lk - lp).abs().max()),
                          pinned=float((lk - pinned).abs().max()))
        if label == "bf16":
            _first_layer_routing(torch, moe, cfg, tape_k[0], groups)
            moe_p, xin = tap["first"]
        del tape_k, tape_p, tap
        log(f"  {cfg.name} {label} prefill, kernel vs plain route: max err "
            f"{got[label]['err']:.3e} as served, {got[label]['pinned']:.3e} "
            f"with the routing pinned (|logits| <= "
            f"{float(lp.abs().max()):.3f}); routing flips between the "
            f"routes: {flips[0]} tokens' top-{cfg.experts_per_token} sets, "
            f"{flips[1]} capacity keeps, first in layer {flips[2]}; "
            f"launches {launched}")
    f32, bf16 = got["f32"], got["bf16"]
    f32_launches[cfg.name] = f32["launched"]["flash_attention"]
    err_k = float((bf16["kernel"] - f32["plain"]).abs().max())
    err_p = float((bf16["plain"] - f32["plain"]).abs().max())
    log(f"  {cfg.name} bf16 routes against the f32 plain logits: kernel "
        f"{err_k:.3e}, plain {err_p:.3e}")
    return {
        f"f32 prefill launched flash_attention {n} times, no other kernel":
            f32["launched"] == {k: (n if k == "flash_attention" else 0)
                                for k in f32["launched"]},
        f"bf16 prefill launched flash_attention_sm90 {n} times":
            bf16["launched"] == {k: (n if k == "flash_attention_sm90" else 0)
                                 for k in bf16["launched"]},
        "f32, routing pinned: kernel route vs plain route within 1e-3":
            f32["pinned"] <= 1e-3,
        f"bf16, routing pinned: kernel route vs plain route within "
        f"{BF16_PINNED}": bf16["pinned"] <= BF16_PINNED,
    }, moe_p, xin


def moe_dispatch_phase(torch, moe_p, xin, cfg):
    """Phase 11 (d): one qwen2-moe MoE layer (layer 0's weights) on its
    served input (4 x 2,048 tokens) in float32 with capacity_factor = E / k,
    so no choice drops: the einsum dispatch (batch-row groups), the gather
    dispatch (one group of 8,192 tokens) and the gather dispatch in groups
    of 2,048 must agree within 1e-4 of the output's largest |y|. Each is
    timed once more with CUDA events. Returns the checks."""
    import dataclasses
    from repro_torch.models import moe
    e, k = cfg.n_experts, cfg.experts_per_token
    base = dataclasses.replace(cfg, dtype="float32", capacity_factor=e / k)
    x = xin.float()
    r = moe.routing(moe_p, x, base)
    nothing_drops = bool(torch.equal(r.keep, r.mask))
    del r
    outs, times = {}, {}
    for name, over in (("einsum", {}), ("gather", {"moe_dispatch": "gather"}),
                       ("gather, groups of 2048",
                        {"moe_dispatch": "gather", "moe_group_size": 2048})):
        c = dataclasses.replace(base, **over)
        outs[name] = moe.moe_forward(moe_p, x, c)
        times[name] = cuda_ms(lambda: moe.moe_forward(moe_p, x, c), iters=2,
                              warmup=0)
    scale = float(outs["einsum"].y.abs().max())
    errs = {name: float((o.y - outs["einsum"].y).abs().max()) / scale
            for name, o in outs.items() if name != "einsum"}
    aux = {name: float(o.aux_loss) for name, o in outs.items()}
    log(f"  qwen2-moe layer 0 in f32, capacity factor {e / k:g} (capacity "
        f"{moe.capacity(k, x.shape[1], e / k, e)} a batch row, nothing "
        f"dropped: {nothing_drops}): gather vs einsum max err / max|y| "
        f"{errs} (max|y| {scale:.3f}); aux {aux}; ms {times}")
    return {
        "dispatch check: capacity factor E / k drops nothing": nothing_drops,
        "gather (one group and groups of 2048) equals einsum within 1e-4 "
        "relative": all(v <= 1e-4 for v in errs.values()),
        "aux equal across dispatches within 1e-5 relative":
            all(abs(v - aux["einsum"]) <= 1e-5 * aux["einsum"]
                for v in aux.values()),
    }


def moe_serve_phase(torch, ops, dev, f32_launches):
    """Phase 11: (a) qwen2-moe-a2.7b (its config unchanged: 24 layers,
    d_model 2,048, 60 experts top-4, 4 shared, capacity factor 1.25, the
    einsum dispatch; weights drawn from seed 0) served through
    ``launch.serve.serve`` at batch 4, 2,048-token prompts, 32 tokens:
    ``flash_attention_sm90`` once per layer in the prefill, nothing in
    decode, no other kernel; a profiled prefill and decode step; layer 0's
    dropped share; (b) the prefill's routes (``qwen2_moe_routes``); (d) the
    two dispatches at full width (``moe_dispatch_phase``); (c)
    phi3.5-moe-42b-a6.6b and moonshot-v1-16b-a3b at full width, cut to 8
    layers, at 4 x 2,048 + 8 tokens. Returns {arch: the serve's launch
    counts}."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    out = {}
    cfg = get_config("qwen2-moe-a2.7b")
    model = build_model(cfg)
    params, g = _draw(torch, model, dev)
    batch, prompt, gen = 4, 2048, 32
    res, tokens, launches, checks = _moe_serve(torch, ops, model, params, g,
                                               dev, batch, prompt, gen)
    checks["n_params and n_active_params equal JAX's"] = \
        (model.n_params(), model.n_active_params()) == QWEN2_MOE_COUNTS
    step_ms = res.decode_s * 1e3 / (gen - 1)
    (_, cache), busy = device_profile(
        torch, f"{cfg.name} prefill {batch}x{prompt}", lambda: model.prefill(
            params, {"tokens": tokens}, max_len=prompt + gen, use_flash=True))
    if busy is not None:
        log(f"  {cfg.name} prefill device idle share "
            f"{1 - busy / (res.prefill_s * 1e3):.3f} of the unprofiled "
            f"prefill's {res.prefill_s * 1e3:.2f} ms")
    n0 = {n: k.launches for n, k in ops.KERNELS.items()}
    _, busy = device_profile(torch, f"{cfg.name} one decode step",
                             lambda: model.decode(
                                 params, cache,
                                 {"token": res.tokens[:, :1]})[0])
    checks["a decode step launched no kernel"] = \
        n0 == {n: k.launches for n, k in ops.KERNELS.items()}
    if busy is not None:
        log(f"  {cfg.name} decode device idle share {1 - busy / step_ms:.3f}"
            f" of the unprofiled serve loop's {step_ms:.3f} ms per step")
    del cache
    routes, moe_p, xin = qwen2_moe_routes(torch, ops, model, params, tokens,
                                          f32_launches)
    checks.update(routes)
    moe_p = tree_map(lambda a: a.clone(), moe_p)
    out[cfg.name] = launches
    del params, res
    _release(torch)
    checks.update(moe_dispatch_phase(torch, moe_p, xin, cfg))
    del moe_p, xin
    _release(torch)
    failed = [k_ for k_, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.name} checks failed: {failed}")

    for arch, layers in MOE_CUT:
        full = get_config(arch)
        model = build_model(dataclasses.replace(full, n_layers=layers))
        log(f"  {arch}: {layers} of its {full.n_layers} layers "
            f"({build_model(full).n_params():,} parameters at full depth)")
        params, g = _draw(torch, model, dev)
        _, _, launches, checks = _moe_serve(torch, ops, model, params, g, dev,
                                            4, 2048, 8)
        failed = [k_ for k_, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{arch} serving checks failed: {failed}")
        out[arch] = launches
        del params
        _release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 12: the vision-stub and audio-codec families served at full width
# ---------------------------------------------------------------------------

# arch, the layers served of its config's (qwen2-vl-72b's 80 layers are
# 72,715,870,208 float32 parameters, 270.89 GiB; 8 are 35.48 GiB), batch,
# prompt, generated tokens, and its parameter count at full depth (JAX's)
FRONTEND_SERVES = (
    ("qwen2-vl-72b", 8, 4, 2048, 32, 72_715_870_208),
    ("musicgen-medium", 48, 4, 1500, 32, 1_837_254_144))


def frontend_serve_phase(torch, ops, dev, f32_launches):
    """Phase 12: (a) qwen2-vl-72b at full width cut to 8 of its 80 layers
    and (c) musicgen-medium at full depth and width, weights drawn from
    seed 0, served through ``launch.serve.serve`` at batch 4 with 32
    sampled tokens: qwen2-vl on 2,048-token prompts of 256 bf16 patch
    embeddings (width 1,280) and 1,792 text tokens with Qwen2-VL's
    position grid (patch i at (0, i // 16, i % 16), text token j at 16 + j
    in all three streams), decode continuing at ``pos`` in all three as
    the JAX package does; musicgen on 1,500 frames of 4 codebooks (30 s of
    50 Hz EnCodec codes), each step sampling all four. Each prefill must
    launch ``flash_attention_sm90`` once a layer, a decode step nothing;
    a profiled prefill and decode step. (b) The routes as
    ``_routes_against_f32`` holds them, the f32 prefills at batch 1.
    Returns {arch: the serve's launch counts}."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    _release(torch)
    out = {}
    for arch, layers, batch, prompt, gen, n_full in FRONTEND_SERVES:
        full = get_config(arch)
        model = build_model(dataclasses.replace(full, n_layers=layers))
        log(f"  {arch}: {layers} of its {full.n_layers} layers "
            f"({build_model(full).n_params():,} parameters at full depth)")
        params, g = _draw(torch, model, dev)
        cfg = model.cfg
        batch_in = frontend_prompt(torch, cfg, batch, prompt, g, dev)
        warm = frontend_prompt(torch, cfg, batch, 256, g, dev)
        res, launches, checks = _timed_serve(torch, ops, model, params, g,
                                             dev, batch_in, warm, gen)
        checks["n_params at full depth equals JAX's"] = \
            build_model(full).n_params() == n_full
        if "positions" in batch_in:
            p = batch_in["positions"]
            checks["the three position streams differ"] = bool(
                (p[..., 1] != p[..., 2]).any() and (p[..., 0] != p[..., 1])
                .any())
        step_ms = res.decode_s * 1e3 / (gen - 1)
        (lk, cache), busy = device_profile(
            torch, f"{arch} prefill {batch}x{prompt}", lambda: model.prefill(
                params, batch_in, max_len=prompt + gen, use_flash=True))
        if busy is not None:
            log(f"  {arch} prefill device idle share "
                f"{1 - busy / (res.prefill_s * 1e3):.3f} of the unprofiled "
                f"prefill's {res.prefill_s * 1e3:.2f} ms")
        feed = "codes" if cfg.frontend == "audio_codec" else "token"
        n0 = {n: k.launches for n, k in ops.KERNELS.items()}
        _, busy = device_profile(torch, f"{arch} one decode step",
                                 lambda: model.decode(
                                     params, cache,
                                     {feed: res.tokens[:, :1]})[0])
        checks["a decode step launched no kernel"] = \
            n0 == {n: k.launches for n, k in ops.KERNELS.items()}
        if busy is not None:
            log(f"  {arch} decode device idle share {1 - busy / step_ms:.3f}"
                f" of the unprofiled serve loop's {step_ms:.3f} ms per step")
        del cache
        lp = model.prefill(params, batch_in, use_flash=False)[0]
        err = float((lk - lp).abs().max())
        log(f"  {arch} bf16 prefill, kernel vs plain route: max err "
            f"{err:.3e} (|logits| <= {float(lp.abs().max()):.3f})")
        checks.update(_routes_against_f32(torch, ops, model, params,
                                          batch_in, lk, lp, layers,
                                          f32_launches, rows=1, by="rms"))
        failed = [k_ for k_, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{arch} serving checks failed: {failed}")
        out[arch] = launches
        del params, res, lk, lp
        _release(torch)
    return out



# ---------------------------------------------------------------------------
# phase 13: training the MoE, vision, audio and recurrent families
# ---------------------------------------------------------------------------

# arch, config overrides and batch x positions of phase 13 (a)'s smoke runs
# (card against host): qwen2-moe's einsum dispatch at its default capacity,
# qwen2-vl on Qwen2-VL's grid (16 patches in rows of 4, 16 text tokens),
# musicgen's 2 codebooks, xlstm over an mLSTM chunk and a ragged one,
# recurrentgemma cut to 4 layers past its 64-token window
FAMILY_SMOKE = (("qwen2-moe-a2.7b", {}, 2, 32),
                ("qwen2-vl-72b", {}, 2, 32),
                ("musicgen-medium", {}, 2, 32),
                ("xlstm-125m", {}, 2, 300),
                ("recurrentgemma-2b", {"n_layers": 4}, 2, 72))

# phase 13 (b): arch, layers trained of its config's, batch, positions.
# The launcher's step writes the parameters and moments in place
# (``donate=True``), so AdamW holds 16 bytes a float32 parameter and the
# largest leaf's temporaries at the update: qwen2-moe's 4 layers 43.28 GiB
# of state, qwen2-vl's one layer 50.36 (its untied embedding and head are
# 2.49 of its 3.38 B parameters; 4.64 GiB a leaf), recurrentgemma's 26
# 52.90, musicgen's 48 27.38. Depths are the ones that fit one 80 GB card;
# widths are the configs'.
FAMILY_FULL = (("qwen2-moe-a2.7b", 4, 2, 2048),
               ("qwen2-vl-72b", 1, 1, 2048),
               ("recurrentgemma-2b", 26, 1, 2048),
               ("musicgen-medium", 48, 4, 1500))


def _family_batch(torch, cfg, b, s, g, dev, grid_w):
    """``launch.train.synth_batch`` drawn from ``g``; a vision batch also
    carries Qwen2-VL's position grid (``vl_positions``), so M-RoPE's three
    streams differ."""
    from repro_torch.launch.train import synth_batch
    batch = synth_batch(cfg, g, b, s)
    if cfg.frontend == "vision_stub":
        n_img = batch["embeds"].shape[1]
        batch["positions"] = vl_positions(torch, b, n_img, s - n_img, grid_w,
                                          dev)
    return batch


def _min_margin(torch, tape, k):
    return min(float((top[..., k - 1] - top[..., k]).min()) for top in (
        torch.sort(p.detach(), dim=-1, descending=True).values for p in tape))


def family_train_reference(torch, dev):
    """Phase 13 (a): 3 float32 training steps (AdamW, block remat) of each
    family's smoke config on the card and on the host, from the same
    weights and batches (``FAMILY_SMOKE``): losses and grad norms within
    1e-5 relative (phase 7 (c)'s rule). For qwen2-moe every router call of
    every step (forward and remat recompute) on both sides has its top-2
    margin above 1e-5, so both sides route alike."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model, make_train_step
    for arch, over, b, s in FAMILY_SMOKE:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  **over)
        model = build_model(cfg)
        step = make_train_step(model, TrainConfig(total_steps=10,
                                                  warmup_steps=2))
        host = model.init(torch.Generator().manual_seed(0), device="cpu")
        card = tree_map(lambda a: a.to(dev), host)
        hs, cs = (optim.init_opt_state(p, "adamw") for p in (host, card))
        g = torch.Generator().manual_seed(1)
        rows, margins = [], []
        for _ in range(3):
            batch = _family_batch(torch, cfg, b, s, g, "cpu", grid_w=4)
            with router_tape(moe) as tape:
                host, hs, hm = step(host, hs, batch)
                if cfg.is_moe:
                    margins.append(_min_margin(torch, tape,
                                               cfg.experts_per_token))
            with router_tape(moe) as tape:
                card, cs, cm_ = step(card, cs, {k: v.to(dev) for k, v in
                                                batch.items()})
                if cfg.is_moe:
                    margins.append(_min_margin(torch, tape,
                                               cfg.experts_per_token))
            rows.append([(float(hm[k]), float(cm_[k]))
                         for k in ("loss", "grad_norm")])
        worst = max(abs(c - h) / abs(h) for r in rows for h, c in r)
        routed = (f"; smallest top-{cfg.experts_per_token} margin "
                  f"{min(margins):.3e}" if margins else "")
        if worst > 1e-5 or (margins and min(margins) <= 1e-5):
            raise AssertionError(f"{arch} train step card vs host: {rows}"
                                 f"{routed}")
        log(f"  small {arch} float32 train step ({cfg.n_layers} layers, "
            f"{b} x {s}) agrees over 3 steps: loss "
            f"{[round(r[0][0], 6) for r in rows]}, grad norm "
            f"{[round(r[1][0], 6) for r in rows]}; worst relative "
            f"difference {worst:.3e}{routed}")


def _report_steps(label, model, b, s, rows, launches, peak):
    """Prints each step's (loss, grad norm, lr, seconds) of ``rows`` (the
    first a warm-up), the median step after it, tokens/s, the model FLOPs'
    share of 989 TFLOP/s, the peak and the launch counts; asserts finite
    losses and grad norms, an lr rising over the warmup and no hand-kernel
    launch. Returns the median."""
    for i, (loss, gnorm, lr, secs) in enumerate(rows):
        log(f"  {label} step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.4f}, grad norm {gnorm:.4f}, lr {lr:.3e}, {secs:.4f} s")
    from repro_torch import roofline
    med = statistics.median(r[3] for r in rows[1:])
    flops = roofline.train_step_flops(model, b, s)[1]
    peak_bf16 = roofline.PEAK_FLOPS["bfloat16"]
    log(f"  {label}: median step {med:.4f} s after the warm-up, "
        f"{b * s / med:.0f} tokens/s, {flops / 1e12:.2f} TFLOP a step = "
        f"{flops / med / 1e12:.1f} TFLOP/s, "
        f"{flops / med / peak_bf16:.4f} of 989 TFLOP/s (bound "
        f"{flops / peak_bf16:.4f} s); {peak}")
    log(f"  {label} launches {launches}")
    checks = {
        "every loss and grad norm finite": all(
            math.isfinite(v) for r in rows for v in r[:2]),
        "no hand kernel launched": all(v == 0 for v in launches.values()),
        "lr follows the warmup": rows[0][2] < rows[1][2],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} checks failed: {failed}")
    return med


def _timed_steps(torch, ops, model, tc, batches, b, s, dev, label):
    """Weights drawn from seed 0 on the card, then one donated step per
    batch of ``batches`` (the first a warm-up), with every launch count set
    to 0
    and the peak counter reset before the first; ``_report_steps``, then
    one more step profiled. Returns the launch counts."""
    from repro_torch import optim
    from repro_torch.models.registry import make_train_step
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, device=dev)
    state = optim.init_opt_state(params, tc.optimizer)
    step = make_train_step(model, tc, donate=True)
    base = reset_peak(torch, label)
    for k in ops.KERNELS.values():
        k.launches = 0
    rows = []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        torch.cuda.synchronize(dev)
        rows.append((float(met["loss"]), float(met["grad_norm"]),
                     float(met["lr"]), time.perf_counter() - t0))
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    med = _report_steps(label, model, b, s, rows, launches,
                        peak_text(torch, base))
    _, busy = device_profile(torch, f"{label} one step",
                             lambda: step(params, state, batches[-1]),
                             top=10)
    if busy is not None:
        log(f"  {label} device idle share {1 - busy / (med * 1e3):.3f} of "
            f"the unprofiled median step's {med * 1e3:.2f} ms")
    del params, state
    _release(torch)
    return launches


def family_train_full(torch, ops, dev):
    """Phase 13 (b): each family at full width (``FAMILY_FULL``), weights
    drawn from seed 0 on the card, float32 parameters and the config's
    bfloat16 activations, AdamW with block remat: a warm-up step and 3
    timed steps. A full-depth run goes through ``launch.train.main``
    (``launch_train``); a depth-cut run builds its model from the cut
    config and drives ``make_train_step`` and ``synth_batch`` itself
    (``_timed_steps``). No hand kernel may launch (training takes the plain
    attention route, as the JAX package's does). Returns {arch: launch
    counts}."""
    import dataclasses
    from repro_torch import roofline
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.registry import build_model
    _release(torch)
    out = {}
    for arch, layers, b, s in FAMILY_FULL:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        model = build_model(cfg)
        label = f"train {arch} ({layers} of {full.n_layers} layers) " \
            f"{b} x {s:,}"
        n_active, flops = roofline.train_step_flops(model, b, s)
        log(f"  {label}: {model.n_params():,} parameters, {n_active:,} "
            f"active a token, {flops / 1e12:.2f} model TFLOP a step")
        if layers == full.n_layers:
            launches = launch_train(torch, ops, dev, model, label, 4, b,
                                    s)[0]
        else:
            g = torch.Generator(device=dev).manual_seed(1)
            batches = [_family_batch(torch, cfg, b, s, g, dev, grid_w=8)
                       for _ in range(4)]
            tc = TrainConfig(total_steps=10, warmup_steps=2)
            launches = _timed_steps(torch, ops, model, tc, batches, b, s,
                                    dev, label)
        out[arch] = launches
    return out


def train_e2e_phase(torch, ops, dev):
    """Phase 13 (c): ``examples.train_e2e --quick --steps 100`` on the card
    (full xlstm-125m, 2 x 64 tokens a step, checkpoint under ``build/``):
    its own rule (the mean loss of the last 10 steps below the first 10's)
    must hold. Prints the run's seconds, tokens/s and peak. Returns the
    launch counts."""
    from repro_torch.examples import train_e2e
    ckpt = os.path.join(ROOT, "build", "train_e2e", "xlstm125m_torch.npz")
    base = reset_peak(torch, "train_e2e")
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    losses = train_e2e.main(["--quick", "--steps", "100", "--device",
                             str(dev), "--ckpt", ckpt])
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    log(f"  train_e2e --quick --steps 100: {secs:.3f} s, "
        f"{100 * 2 * 64 / secs:.0f} tokens/s ({secs / 100:.4f} s a step); "
        f"mean loss first 10 {sum(losses[:10]) / 10:.4f}, last 10 "
        f"{sum(losses[-10:]) / 10:.4f}; {peak_text(torch, base)}; "
        f"launches {launches}")
    if not all(map(math.isfinite, losses)) or any(launches.values()):
        raise AssertionError("train_e2e checks failed")
    _release(torch)
    return launches


# ---------------------------------------------------------------------------
# phase 14: the quickstart, moonshot at full depth in bf16, the dry run
# ---------------------------------------------------------------------------

# the quickstart's card run against its host run (same draws): eval losses
# after 200 Adam steps on convolution gradients summed in other orders
# (phase 3 holds 20 steps to 1e-3), and linear-evaluation accuracies on 100
# test images, two of which may land on the other side
QUICKSTART_EVAL_RTOL = 1e-2
QUICKSTART_ACC_ATOL = 0.02
# the dry run's peak (arguments + live bytes) against the card's
# max_memory_allocated above the reset, for Llama's train step: the
# caching allocator rounds each block up to 512 bytes, and the cuBLAS
# workspace and any scratch an op allocates inside its kernel are not
# tensors the count sees
PEAK_BAND = 0.05


def _gate_margins_ok(res, rel=1e-4):
    """Whether every gate decision of a pipeline run has its candidate
    score more than ``rel`` relative away from the receiver's base score
    (ROADMAP, "Gate decisions"): then the card's decisions must equal the
    host's."""
    ex = res.exchange
    base = ex.base.float().cpu()[:, None]
    scores = ex.scores.float().cpu()
    return bool(((scores - base).abs() > rel * base.abs()).all())


def quickstart_phase(torch, ops, dev):
    """Phase 14 (a): ``examples.quickstart`` at its full size on the card
    (8 clients, 100 training images a class, 400 RL episodes, 200 FedAvg
    iterations on raw and exchanged data, linear evaluation of both), every
    launch count set to 0 and the peak reset just before it: it must launch
    ``kmeans_assign`` 50 times (25 Lloyd steps before and after the
    exchange) and ``recon_gate`` twice. Then the same seed on the host
    (the same draws, from one host generator): ``in_edge`` equal, the
    datapoints received equal where every gate margin exceeds 1e-4
    relative, mean λ before and after within 1e-6 relative, P_D within
    1e-6, the eval losses within ``QUICKSTART_EVAL_RTOL`` relative and the
    accuracies within ``QUICKSTART_ACC_ATOL``. Prints the card run's wall
    seconds (ending in a sync), its peak, the host run's seconds and the
    three signs of a healthy run (the verify skill's): datapoints received,
    mean λ falling, smart-D2D eval loss at most the non-i.i.d. one at the
    later iterations. Returns the launch counts."""
    from repro_torch.examples import quickstart
    base = reset_peak(torch, "quickstart")
    for k in ops.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    card = quickstart.main(["--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    peak = peak_text(torch, base)
    t0 = time.perf_counter()
    host = quickstart.main(["--device", "cpu"])
    host_s = time.perf_counter() - t0
    margins_ok = (_gate_margins_ok(card["pipeline"])
                  and _gate_margins_ok(host["pipeline"]))
    eval_err = max(abs(c - h) / abs(h) for rc, rh in
                   zip(card["eval"], host["eval"])
                   for c, h in zip(rc[1:], rh[1:]))
    acc_err = max(abs(card[k] - host[k]) for k in ("acc_non_iid",
                                                   "acc_smart"))
    later = card["eval"][len(card["eval"]) // 2:]
    log(f"  quickstart on the card: {secs:.3f} s, {peak}; on the host "
        f"{host_s:.3f} s; launches {launches}")
    log(f"  card against host: in_edge {card['in_edge']} / "
        f"{host['in_edge']}; moved {card['moved']} / {host['moved']} (every "
        f"gate margin above 1e-4: {margins_ok}); mean lambda "
        f"{card['lam_before']:.6f} -> {card['lam_after']:.6f} / "
        f"{host['lam_before']:.6f} -> {host['lam_after']:.6f}; P_D chosen "
        f"{card['pd_chosen']:.6f} / {host['pd_chosen']:.6f}; eval losses "
        f"max rel err {eval_err:.3e}; accuracies {card['acc_non_iid']:.3f}, "
        f"{card['acc_smart']:.3f} / {host['acc_non_iid']:.3f}, "
        f"{host['acc_smart']:.3f}")
    log(f"  healthy-run signs: datapoints received {card['moved']} (total "
        f"{sum(card['moved'])}); mean lambda {card['lam_before']:.3f} -> "
        f"{card['lam_after']:.3f} (falls: "
        f"{card['lam_after'] < card['lam_before']}); smart-D2D <= non-iid "
        f"eval loss at iters {[r[0] for r in later]}: "
        f"{[r[2] <= r[1] for r in later]}")
    checks = {
        "kmeans_assign launched 50 times, recon_gate twice, nothing else":
            launches == {n: {"kmeans_assign": 50, "recon_gate": 2}.get(n, 0)
                         for n in launches},
        "in_edge equal": card["in_edge"] == host["in_edge"],
        "datapoints received equal (margins above 1e-4)":
            not margins_ok or card["moved"] == host["moved"],
        "mean lambda before and after within 1e-6 relative": all(
            abs(card[k] - host[k]) <= 1e-6 * abs(host[k])
            for k in ("lam_before", "lam_after")),
        "P_D within 1e-6": all(abs(card[k] - host[k]) <= 1e-6
                               for k in ("pd_chosen", "pd_all")),
        "eval iterations equal": [r[0] for r in card["eval"]]
            == [r[0] for r in host["eval"]],
        f"eval losses within {QUICKSTART_EVAL_RTOL} relative":
            eval_err <= QUICKSTART_EVAL_RTOL,
        f"accuracies within {QUICKSTART_ACC_ATOL}":
            acc_err <= QUICKSTART_ACC_ATOL,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"quickstart checks failed: {failed}")
    return launches


def moonshot_full_phase(torch, ops, dev):
    """Phase 14 (b): moonshot-v1-16b-a3b at full width and all 48 layers
    with bf16 parameters (``param_dtype="bfloat16"``, ``launch.perf``'s
    ``bf16_params``), served through ``launch.serve.serve`` at phase 11's
    4 x 2,048 + 8 tokens (``_moe_serve``: the tensor-core flash kernel
    once a layer, 48, nothing else). Then, on a cut to 8 layers that fits
    in float32, the f32-parameter model's prefill against the same weights
    rounded to bf16 (bf16 activations: each layer casts its f32 weights to
    bf16, so only the router's float32 product sees the rounding): with the
    routing pinned to the f32 route's (``router_tape``) within one bf16 ulp
    of the largest |logit|; as served, the distance and the routing flips
    are printed. Returns (the serve's launch counts, its prefill seconds,
    the config)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    full = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, param_dtype="bfloat16")
    model = build_model(cfg)
    log(f"  {cfg.name}: {model.n_params():,} parameters, "
        f"{model.n_params() * 2 / 2**30:.2f} GiB in bf16")
    params, g = _draw(torch, model, dev)
    res, _, launches, checks = _moe_serve(torch, ops, model, params, g, dev,
                                          4, 2048, 8)
    del params
    _release(torch)

    cut = dataclasses.replace(full, n_layers=8)
    m32 = build_model(cut)
    m16 = build_model(dataclasses.replace(cut, param_dtype="bfloat16"))
    g = torch.Generator(device=dev).manual_seed(0)
    p32 = m32.init(g, device=dev)
    p16 = tree_map(lambda a: a.to(torch.bfloat16), p32)
    tokens = torch.randint(0, cut.vocab_size, (4, 2048), generator=g,
                           device=dev)
    batch = {"tokens": tokens}
    with router_tape(moe) as tape32:
        l32, _ = m32.prefill(p32, batch, use_flash=True)
    with router_tape(moe, replay=tape32):
        pinned, _ = m16.prefill(p16, batch, use_flash=True)
    with router_tape(moe) as tape16:
        served, _ = m16.prefill(p16, batch, use_flash=True)
    flips = _flips(moe, cut, tape32, tape16, 4)
    scale = float(l32.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    err_pinned = float((pinned - l32).abs().max())
    err_served = float((served - l32).abs().max())
    log(f"  {cut.name} (8 layers) prefill, bf16 parameters against f32 "
        f"parameters: max err {err_pinned:.3e} with the routing pinned, "
        f"{err_served:.3e} as served (one bf16 ulp at |logits| <= "
        f"{scale:.3f} is {ulp:.3e}); routing flips as served: {flips[0]} "
        f"tokens' top-{cut.experts_per_token} sets, {flips[1]} capacity "
        f"keeps, first in layer {flips[2]}")
    checks["8-layer cut, routing pinned: bf16 parameters within one bf16 "
           "ulp of the f32 parameters' logits"] = err_pinned <= ulp
    del p32, p16, tape32, tape16, l32, pinned, served
    _release(torch)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.name} (48 layers, bf16) checks failed: "
                             f"{failed}")
    return launches, res.prefill_s, cfg


def dryrun_phase(torch, llama_prefill_s, llama_steps, moonshot_prefill_s,
                 moonshot_cfg):
    """Phase 14 (c): ``launch.dryrun``'s count of each step the smoke
    times, at that step's own shape and depth, beside the measured time:
    Llama-3.2-1B's 4 x 2,048 prefill (phase 5: a cache of 2,080), its
    train step at 4 x 2,048 (phase 7 (a); the count's FLOPs also beside
    ``roofline.train_step_flops``) and (b)'s moonshot prefill (a cache of
    2,056). Each bound is the larger roofline term from the H100 SXM
    datasheet's rates. The train step's counted peak (arguments + live
    bytes) is held to phase 7's ``max_memory_allocated`` above its reset
    within ``PEAK_BAND``. Returns the checks."""
    from repro_torch import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import build_model
    llama = get_config("llama3.2-1b")
    step_s, peak = llama_steps[4, 2048]
    rows = (("Llama-3.2-1B prefill 4 x 2,048 (phase 5)", llama,
             InputShape("prefill", 2048, 4, "prefill"), 2048 + 32,
             llama_prefill_s),
            ("Llama-3.2-1B train step 4 x 2,048 (phase 7)", llama,
             InputShape("train", 2048, 4, "train"), None, step_s),
            ("moonshot-v1-16b-a3b 48 layers bf16 prefill 4 x 2,048 "
             "(phase 14 (b))", moonshot_cfg,
             InputShape("prefill", 2048, 4, "prefill"), 2048 + 8,
             moonshot_prefill_s))
    checks = {}
    for label, cfg, shape, max_len, secs in rows:
        # the train step is launch.train's, under a one-rank mesh's rules
        rec = dryrun.count_step(cfg, shape, max_len=max_len, rules=(
            dryrun.mesh_rules("h100") if shape.kind == "train" else None))
        terms = dryrun.roofline_record(cfg, shape, rec)
        bound_s = max(terms["t_compute_s"], terms["t_memory_s"])
        by = {k: f"{v / 1e12:.3f}" for k, v in
              terms["flops_by_dtype"].items()}
        log(f"  dry run, {label}: {rec['cost']['flops'] / 1e12:.3f} TFLOP "
            f"(by dtype {by}), {rec['cost']['bytes'] / 1e9:.2f} GB, "
            f"kernels {rec['kernels']}, counted in {rec['count_s']:.2f} s; "
            f"bound {bound_s * 1e3:.3f} ms ({terms['bottleneck']}: compute "
            f"{terms['t_compute_s'] * 1e3:.3f} ms, memory "
            f"{terms['t_memory_s'] * 1e3:.3f} ms); measured "
            f"{secs * 1e3:.3f} ms = {secs / bound_s:.2f} x the bound")
        if shape.kind == "train":
            model = build_model(cfg)
            analytic = roofline.train_step_flops(model, shape.global_batch,
                                                 shape.seq_len)[1]
            counted = (rec["memory"]["argument_size_in_bytes"]
                       + rec["memory"]["temp_size_in_bytes"])
            log(f"  dry run, {label}: counted FLOPs "
                f"{rec['cost']['flops'] / analytic:.4f} of "
                f"train_step_flops' {analytic / 1e12:.3f} TFLOP (that "
                f"counts the embedding as a product and every remat "
                f"product); peak {counted / 2**30:.3f} GiB (arguments "
                f"{rec['memory']['argument_size_in_bytes'] / 2**30:.3f}) "
                f"against the card's {peak / 2**30:.3f} GiB above the "
                f"reset: {counted / peak:.4f}")
            checks[f"{label}: counted peak within {PEAK_BAND} of the "
                   "card's"] = abs(counted / peak - 1) <= PEAK_BAND
        if shape.kind == "prefill":
            n_attn = sum(k in ("attn", "local_attn")
                         for k in cfg.layer_kinds)
            checks[f"{label}: {n_attn} flash_attention_sm90 launches "
                   "counted"] = rec["kernels"].get(
                       "flash_attention_sm90", {}).get("launches") == n_attn
    return checks


# ---------------------------------------------------------------------------
# phase 15: the sharded client plane on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

def _launch_counts(ops):
    return {name: k.launches for name, k in ops.KERNELS.items()}


def _zero_launches(ops):
    for k in ops.KERNELS.values():
        k.launches = 0


def lab_parity_phase(torch, ops, dev):
    """Phase 15 (a): ``meshlab.parity_report`` at the lab size on the card
    (mesh 1 against ``rules=None``, every digest equal; every
    ``torch.distributed`` call counted, and none may run at mesh 1, where
    each collective is the identity), then the lab's clustering and gate
    programs once without and once with the rules, launch counts read
    around each. Returns the rules run's launches.

    cuDNN's default backward algorithms at the lab's shapes are not
    deterministic run to run: two ``rules=None`` pretrainings differ in a
    few bias bits (printed). The parity report runs with
    ``torch.backends.cudnn.deterministic`` on, restored after."""
    from repro_torch import meshlab
    from repro_torch.models.common import tree_leaves
    cfg = meshlab.LabConfig()
    world = meshlab.build_world(cfg, dev)
    a, b = (tree_leaves(meshlab.run_pretrain(world, None)) for _ in range(2))
    gap = max(float((x - y).abs().max()) for x, y in zip(a, b))
    log("  cuDNN default algorithms: two rules=None lab pretrainings differ "
        f"by at most {gap:.3e}; the parity report runs with "
        "cudnn.deterministic on")
    t0 = time.perf_counter()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rep = meshlab.parity_report(cfg, 1, device=dev, count=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    paths = ("pretrain", "gate", "fl", "cluster", "disc", "disc_ucb",
             "disc_warm")
    same = {p: rep[f"{p}_digest_mesh1"] == rep[f"{p}_digest_base"]
            for p in paths}
    calls = {stage: sum(c.values())
             for stage, c in rep["collectives_mesh1"].items()}
    log(f"  lab parity (N={cfg.n_clients}, {cfg.rl_episodes}-episode "
        f"bursts) at mesh 1 on the card: {time.perf_counter() - t0:.2f} s; "
        f"digests equal to rules=None: {same}")
    log(f"  torch.distributed calls at mesh 1 by stage: {calls}")
    counts = {}
    for tag, rules in (("base", None), ("mesh1", meshlab.make_rules(1, dev))):
        _zero_launches(ops)
        meshlab.run_cluster(world, rules)
        params = meshlab.run_pretrain(world, rules)
        meshlab.run_gate(world, params, meshlab.gate_operands(world, rules),
                         rules)
        torch.cuda.synchronize()
        counts[tag] = _launch_counts(ops)
    log(f"  lab clustering + gate launches: rules=None {counts['base']}, "
        f"mesh 1 {counts['mesh1']}")
    failed = [p for p, ok in same.items() if not ok]
    failed += [f"{stage}: {n} collectives at mesh 1"
               for stage, n in calls.items() if n]
    if counts["base"] != counts["mesh1"]:
        failed.append("launch counts differ")
    if counts["mesh1"]["kmeans_assign"] < 1 or \
            counts["mesh1"]["recon_gate"] != 2:
        failed.append("the lab paths did not launch both kernels")
    if failed:
        raise AssertionError(f"phase 15 (a) checks failed: {failed}")
    return counts["mesh1"]


def warm_pipeline(torch, dev, main_rec, gen=None, world=None):
    """One unsharded ``run_pipeline`` over phase 4's world, warm: its
    seconds, each stage's, and whether its graph and moved counts are
    phase 4's. Restores ``gen``'s state after (a fresh world's when
    none is given)."""
    from repro_torch.core.pipeline import PipelineConfig, run_pipeline
    from repro_torch.models.autoencoder import AEConfig
    xs, ys, ev, gen = world or full_world(torch, dev)
    start = gen.get_state()
    t0 = time.perf_counter()
    res = run_pipeline(xs, ys, AEConfig(), PipelineConfig(), generator=gen,
                       device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = torch.equal(res.in_edge.cpu(), main_rec["in_edge"]) and \
        torch.equal(torch.as_tensor(res.moved_counts), main_rec["moved"])
    gen.set_state(start)
    return {"run_pipeline": secs, "stages": dict(res.stage_seconds),
            "same": same}


def sharded_main_path(torch, ops, dev, rules, main_rec, before):
    """Phase 15 (b): phase 4's main path (same world, same generator) with
    the mesh-1 rules, held to phase 4's record. Returns the launches.

    Phase 4 ran cold (first use of every stage), so ``run_pipeline`` runs
    once more unsharded here, warm, from the same generator state; the
    sharded run's seconds are printed beside that run's, beside ``before``
    (a warm unsharded run made before the process group existed) and
    beside phase 4's.

    FL: the sharded rounds run as phase 4's did (cuDNN's default
    algorithms), and their distance to phase 4's parameters is printed
    beside the distance between two unsharded runs in the same mode on the
    same data from the same generator state (how far phase 4's own FL
    repeats on the card). The sharded and unsharded rounds then run once
    more each with ``cudnn.deterministic`` on and are held within 1e-5;
    the sharded rounds are held within 1e-5 of phase 4's too unless phase
    4's own FL does not repeat within 1e-5."""
    from collections import Counter
    from repro_torch import meshlab
    from repro_torch.core.pipeline import PipelineConfig, run_pipeline
    from repro_torch.fl import FLConfig, fl_train, linear_evaluation
    from repro_torch.models.autoencoder import AEConfig
    from repro_torch.models.common import tree_leaves
    xs, ys, ev, gen = full_world(torch, dev)
    ae_cfg = AEConfig()
    warm = warm_pipeline(torch, dev, main_rec, world=(xs, ys, ev, gen))
    base = reset_peak(torch, "sharded main path")
    _zero_launches(ops)
    calls = Counter()
    t0 = time.perf_counter()
    with meshlab.count_collectives(calls):
        res = run_pipeline(xs, ys, ae_cfg, PipelineConfig(), generator=gen,
                           device=dev, rules=rules)
        torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    fl_cfg = FLConfig(total_iters=20, tau_a=10, batch_size=64,
                      eval_every=10)
    state = gen.get_state()
    t0 = time.perf_counter()
    with meshlab.count_collectives(calls):
        fl = fl_train(res.client_data, ae_cfg, fl_cfg, ev.images,
                      generator=gen, device=dev, rules=rules)
        torch.cuda.synchronize()
    t_fl = time.perf_counter() - t0
    after = gen.get_state()
    t0 = time.perf_counter()
    half = ev.images.shape[0] // 2
    acc, _ = linear_evaluation(fl.global_params, ae_cfg, ev.images[:half],
                               ev.labels[:half], ev.images[half:],
                               ev.labels[half:], device=dev)
    t_le = time.perf_counter() - t0
    launches = _launch_counts(ops)
    rec = main_record(torch, res, fl, t_pipe, t_fl, t_le)

    whole = res.client_data.whole(rules)

    def fl_params(r, deterministic):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            gen.set_state(state)
            out = fl_train(res.client_data if r is not None else whole,
                           ae_cfg, fl_cfg, ev.images, generator=gen,
                           device=dev, rules=r)
            return torch.cat([p.reshape(-1).cpu()
                              for p in tree_leaves(out.global_params)])
        finally:
            torch.backends.cudnn.deterministic = saved

    def gap(a, b):
        return float((a - b).abs().max())

    plain = [fl_params(None, False) for _ in range(2)]
    det_err = gap(fl_params(rules, True), fl_params(None, True))
    gen.set_state(after)
    fl_err4 = gap(rec["fl_global"], main_rec["fl_global"])
    repeat = gap(plain[0], plain[1])
    plain4 = [gap(p, main_rec["fl_global"]) for p in plain]
    lam_err = max(float((rec[k] - main_rec[k]).abs().max())
                  for k in ("lam_before", "lam_after"))
    for name, val in rec["stages"].items():
        log(f"  stage {name}: {val:.3f} s (warm rules=None "
            f"{warm['stages'][name]:.3f} s, before the group "
            f"{before['stages'][name]:.3f} s; phase 4, cold: "
            f"{main_rec['stages'][name]:.3f} s)")
    log(f"  run_pipeline {t_pipe:.3f} s (warm rules=None "
        f"{warm['run_pipeline']:.3f} s, before the group "
        f"{before['run_pipeline']:.3f} s, graph and moved as phase 4 "
        f"{warm['same'] and before['same']}; phase 4, cold: "
        f"{main_rec['run_pipeline']:.3f} s)")
    for name in ("fl_train", "linear_evaluation"):
        log(f"  {name} {rec[name]:.3f} s (phase 4: {main_rec[name]:.3f} s)")
    log(f"  FL global max diff, cuDNN default algorithms: sharded to phase 4 "
        f"{fl_err4:.3e}; two unsharded runs on the same data {repeat:.3e}, "
        f"each to phase 4 {plain4[0]:.3e}, {plain4[1]:.3e}; with "
        f"cudnn.deterministic, sharded to unsharded {det_err:.3e}")
    log(f"  {peak_text(torch, base)}; accuracy {acc:.4f}; lambda max diff "
        f"{lam_err:.3e}")
    log(f"  launches {launches}; torch.distributed calls in run_pipeline "
        f"and fl_train at mesh 1: {dict(calls)}")
    checks = {
        "no collective at mesh 1": not calls,
        "in_edge as phase 4": torch.equal(rec["in_edge"], main_rec["in_edge"]),
        "moved as phase 4": torch.equal(rec["moved"], main_rec["moved"]),
        "gate decisions as phase 4":
            torch.equal(rec["accept"], main_rec["accept"]),
        "lambda within 1e-6": lam_err <= 1e-6,
        "FL global parameters within 1e-5 of rules=None, deterministic":
            det_err <= 1e-5,
        "FL global parameters within 1e-5 of phase 4, unless phase 4's "
        "FL does not repeat within 1e-5": fl_err4 <= 1e-5 or repeat > 1e-5,
        "kmeans_assign 50 and recon_gate 2 launches":
            launches["kmeans_assign"] == 50 and launches["recon_gate"] == 2,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 (b) checks failed: {failed}")
    return launches


def sharded_online(torch, ops, dev, rules, online_segs, online_secs):
    """Phase 15 (c): phase 6's ``burst-outage`` run with the mesh-1 rules;
    each segment's graph and moved count held to phase 6's. Returns the
    launches."""
    from collections import Counter
    from repro_torch import meshlab
    xs, ys, ev, _ = full_world(torch, dev)
    calls = Counter()
    with meshlab.count_collectives(calls):
        res, launches, total = _online_run(torch, ops, dev, (xs, ys, ev),
                                           _online_cfg(), "burst-outage",
                                           rules)
    secs, seg_secs = online_secs
    for a, b, t, t6 in zip(res.trace.segments, online_segs,
                           res.segment_seconds, seg_secs):
        log(f"  segment {a.segment}: {t:.3f} s (phase 6: {t6:.3f} s); "
            f"in_edge as phase 6 {bool((a.in_edge == b.in_edge).all())}, "
            f"moved {a.moved} (phase 6: {b.moved})")
    log(f"  run_orchestrator {total:.3f} s (phase 6: {secs:.3f} s); "
        f"torch.distributed calls at mesh 1: {dict(calls)}")
    checks = {f"segment {a.segment}: in_edge and moved as phase 6":
              bool((a.in_edge == b.in_edge).all()) and a.moved == b.moved
              for a, b in zip(res.trace.segments, online_segs)}
    checks["no collective at mesh 1"] = not calls
    checks["5 segments"] = len(res.trace.segments) == len(online_segs) == 5
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 (c) checks failed: {failed}")
    return launches


def client_plane_phase(torch, ops, dev, main_rec, online_segs, online_secs):
    """Phase 15: (a), (b) and (c) on a one-rank NCCL group made over a
    ``HashStore`` by ``make_client_mesh(1)``; the group is destroyed
    after. Returns each run's launch counts."""
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import make_client_mesh
    torch.cuda.set_device(0)
    before = warm_pipeline(torch, dev, main_rec)
    rules = sh.ShardingRules.default(make_client_mesh(1, device=dev))
    log(f"  mesh {rules.shape} on backend {dist.get_backend()}, "
        f"{dist.get_world_size()} rank")
    try:
        lab = lab_parity_phase(torch, ops, dev)
        main = sharded_main_path(torch, ops, dev, rules, main_rec, before)
        online = sharded_online(torch, ops, dev, rules, online_segs,
                                online_secs)
    finally:
        dist.destroy_process_group()
    log(f"  launches: lab {lab}, main path {main}, online {online}")
    return {"lab": lab, "main_path": main, "online": online}


# ---------------------------------------------------------------------------
# phase 16: the model plane on a one-rank NCCL mesh
# ---------------------------------------------------------------------------

# Llama-3.2-1B's per-rank attention at model 2, 4 and 16: q heads, KV heads
PLANE_HEADS = (("model 2", 16, 4), ("model 4", 8, 2), ("model 16", 2, 1))


def _collectives(torch, fn):
    """``fn()`` with every ``torch.distributed`` collective counted by kind:
    (result, calls, result bytes)."""
    from collections import Counter
    from repro_torch import meshlab
    calls, nbytes = Counter(), Counter()
    with meshlab.record_collectives(calls, nbytes):
        out = fn()
        torch.cuda.synchronize()
    return out, dict(calls), dict(nbytes)


def _train_llama(torch, model, tc, batches, dev, rules):
    """Three donated AdamW steps from seed 0's weights, under ``rules``:
    (losses, final parameters, step seconds, the last step's
    collectives)."""
    from repro_torch import optim
    from repro_torch import sharding as sh
    from repro_torch.models.registry import make_train_step
    g = torch.Generator(device=dev).manual_seed(0)
    params = sh.place_params(model.init(g, device=dev), model.param_logical(),
                             rules)
    state = optim.init_opt_state(params, tc.optimizer)
    step = make_train_step(model, tc, donate=True, rules=rules)
    losses, secs, coll = [], [], None
    for batch in batches:
        t0 = time.perf_counter()
        (params, state, m), calls, nbytes = _collectives(
            torch, lambda: step(params, state, batch))
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        coll = (calls, nbytes)
    del state
    return torch.stack(losses), params, secs, coll


def _plane_serves(torch, ops, model, params, placed, rules, tokens, noise,
                  dev, warm=None):
    """``launch.serve.serve`` of ``tokens`` (a (B, S) token tensor, or a
    frontend's prefill batch with its 256-position ``warm`` prompt) +
    ``len(noise)`` tokens with ``rules=None`` on ``params`` and under
    ``rules`` on ``placed`` (each after a warm-up on the first 256
    positions and 2 tokens, its launch counts set to 0 just before and read
    just after), then a prefill and a decode step under the rules with
    their collectives counted. Returns ({tag: (result, launches)},
    (prefill calls, bytes), (decode calls, bytes))."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import batch_rows_len
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    warm = tokens[:, :256] if warm is None else warm
    b, s = batch_rows_len(batch)
    gen = noise.shape[0]
    runs = {}
    for tag, r, p in (("rules=None", None, params), ("mesh (1, 1)", rules,
                                                     placed)):
        serve(model, p, warm, 2, gumbel=noise[:2], device=dev, rules=r)
        _zero_launches(ops)
        res = serve(model, p, tokens, gen, gumbel=noise, device=dev, rules=r)
        runs[tag] = (res, _launch_counts(ops))
        log(f"  serve {tag}: prefill {b}x{s} {res.prefill_s * 1e3:.2f} ms, "
            f"decode {res.decode_s * 1e3 / (gen - 1):.3f} ms a step over "
            f"{gen - 1} steps; launches {runs[tag][1]}")
    (_, cache), pre_calls, pre_bytes = _collectives(torch, lambda: model.prefill(
        placed, batch, max_len=s + gen, use_flash=True, rules=rules))
    feed = {"codes": batch["codes"][:, :1]} if "codes" in batch else \
        {"token": batch["tokens"][:, :1]}
    _, dec_calls, dec_bytes = _collectives(torch, lambda: model.decode(
        placed, cache, feed, rules=rules))
    del cache
    return runs, (pre_calls, pre_bytes), (dec_calls, dec_bytes)


def plane_llama(torch, ops, dev, rules):
    """Phase 16 (a): Llama-3.2-1B at full width and depth served (4 x 2,048
    prompt, 32 decode steps, Gumbel noise drawn once) and trained (3
    donated AdamW steps at 2 x 2,048) once with ``rules=None`` and once
    under the one-rank mesh's rules; logits, tokens, losses and the final
    parameters must be equal bit for bit, and a prefill, a decode step and
    a train step must run no collective (over one-rank axes each is the
    identity). Prints each run's seconds. Returns the rules serve's
    launches."""
    from repro_torch import sharding as sh
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build_model
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    b, s, gen = 4, 2048, 33
    params, g = _draw(torch, model, dev)
    placed = sh.place_params(params, model.param_logical(), rules)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    noise = gumbel_noise(g, (gen, b, 1, cfg.vocab_size))
    runs, pre, dec = _plane_serves(torch, ops, model, params, placed, rules,
                                   tokens, noise, dev)
    (pre_calls, pre_bytes), (dec_calls, dec_bytes) = pre, dec
    del params, placed
    _release(torch)
    tc = TrainConfig(learning_rate=3e-4, total_steps=3, warmup_steps=2)
    bt = 2
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (bt, s), generator=g, device=dev)
        for _ in range(3))]
    l0, p0, sec0, _ = _train_llama(torch, model, tc, batches, dev, None)
    base = reset_peak(torch, "mesh (1, 1) train")
    _zero_launches(ops)
    l1, p1, sec1, (tr_calls, tr_bytes) = _train_llama(torch, model, tc,
                                                      batches, dev, rules)
    train_launches = _launch_counts(ops)
    peak = peak_text(torch, base)
    same_params = all(torch.equal(a, c) for a, c in zip(tree_leaves(p0),
                                                        tree_leaves(p1)))
    del p0, p1
    _release(torch)
    log(f"  train {bt}x{s}, 3 donated AdamW steps: rules=None losses "
        f"{[round(float(x), 6) for x in l0]}, seconds "
        f"{[round(x, 3) for x in sec0]}; mesh (1, 1) losses "
        f"{[round(float(x), 6) for x in l1]}, seconds "
        f"{[round(x, 3) for x in sec1]}; {peak}; launches {train_launches}")
    log(f"  one-rank collectives: prefill {pre_calls} ({pre_bytes} bytes); "
        f"decode step {dec_calls} ({dec_bytes} bytes); train step "
        f"{tr_calls} ({tr_bytes} bytes)")
    (r0, _), (r1, launches) = runs["rules=None"], runs["mesh (1, 1)"]
    checks = {
        "prefill logits bit for bit": torch.equal(r0.logits, r1.logits),
        "32 decode steps' tokens bit for bit": torch.equal(r0.tokens,
                                                           r1.tokens),
        "train losses bit for bit": torch.equal(l0, l1),
        "no collective in a prefill, a decode step or a train step":
            not (pre_calls or dec_calls or tr_calls),
        "final parameters bit for bit": same_params,
        f"flash_attention_sm90 launched {cfg.n_layers} times in the mesh "
        "serve, nothing else": launches == {
            n: (cfg.n_layers if n == "flash_attention_sm90" else 0)
            for n in launches},
        "training launched no kernel": not any(train_launches.values()),
        "logits finite": bool(torch.isfinite(r1.logits).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 16 (a) checks failed: {failed}")
    return launches


def plane_flash(torch, ops, ref, fa_mod, dev, heads=PLANE_HEADS, hd=64,
                arch="Llama-3.2-1B", s=2048, f32_heads=16, seed=16):
    """Phase 16 (b), 17 (c), 19 (c): both flash kernels at a model's
    per-rank attention (4 x ``s`` tokens; ``heads``: (label, query heads,
    KV heads) a rank; Llama-3.2-1B's at model 2, 4 and 16 by default), the
    tensor-core kernel against the plain version at phase 2's tolerances
    (``check_flash``), each timed beside its plain version, one SDPA call
    (``enable_gqa``) and its bound; the CUDA-core kernel at ``f32_heads``
    heads (None: none) in float32."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for label, h, kv in heads:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for shape in
                   ((4, s, h, hd), (4, s, kv, hd), (4, s, kv, hd)))
        if fa_mod.route(q, k, v) != "sm90":
            raise AssertionError(f"{label}: route did not pick sm90")
        err = check_flash(ops, ref, q, k, v, f"{arch} {label} per rank "
                          f"(4,{s},{h}/{kv},{hd}) bf16",
                          "flash_attention_sm90")
        flops = 4 * hd * 4 * h * s * (s + 1) // 2
        moved = 2 * (2 * q.numel() + 2 * k.numel())
        b_ms, b_by = bound(moved, flops, "bfloat16")
        ms = graph_ms(lambda: fa_mod.flash_attention_sm90(q, k, v), iters=20,
                      replays=3)
        call = cuda_ms(lambda: fa_mod.flash_attention_sm90(q, k, v), iters=50)
        plain = graph_ms(lambda: ref.flash_attention_ref(q, k, v), iters=3,
                         replays=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10, replays=3)
        log(f"  flash_attention_sm90 {arch} {label} per rank: device "
            f"{ms:.5f} ms, per call {call:.5f} ms, plain {plain:.5f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}); SDPA {sdpa:.5f} ms")
        out.append({"shape": f"{arch} {label}: q (4, {s}, {h}, {hd}), k/v "
                    f"(4, {s}, {kv}, {hd}) bf16, causal",
                    "max_abs_err": err, "ms": ms,
                    "call_ms": call, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": sdpa})
        if h == f32_heads:
            q32, k32, v32 = (t[:1].float() for t in (q, k, v))
            check_flash(ops, ref, q32, k32, v32, f"{label} per rank "
                        "(1,2048,16/4,64) f32", "flash_attention")
    return out


def plane_kv_seq(torch, dev):
    """Phase 16 (c): ``attention.decode_attention_kv_seq`` at Llama-3.2-1B's
    widths at model 16: a 4 x 2,080 cache (32 query heads, 8 KV heads,
    head_dim 64) in 16 slices of 130 slots, one thread a slice on the card,
    whose all-reduces meet in a barrier and sum in rank order; held against
    ``decode_attention`` over the whole cache (1e-5 float32, 3e-2 bf16)."""
    import threading
    from repro_torch.models import attention as attn
    m, b, w, h, kv, hd = 16, 4, 2080, 32, 8, 64
    pos = w + 37                      # the ring has wrapped
    g = torch.Generator(device=dev).manual_seed(160)

    class Lab:
        def __init__(self):
            self.bar, self.parts = threading.Barrier(m), [None] * m

        def all_reduce(self, x, axis, op="sum", rank=None):
            self.parts[rank] = x
            self.bar.wait()
            stack = torch.stack(self.parts)
            out = stack.amax(0) if op == "max" else stack.sum(0)
            self.bar.wait()
            return out

    class RankPlane:
        def __init__(self, lab, rank):
            self.lab, self.rank = lab, rank

        def all_reduce(self, x, axis, op="sum"):
            return self.lab.all_reduce(x, axis, op, self.rank)

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        q = torch.randn((b, 1, h, hd), generator=g, device=dev).to(dtype)
        kc, vc = (torch.randn((b, w, kv, hd), generator=g, device=dev)
                  .to(dtype) for _ in range(2))
        held = attn.cache_slot_positions(pos, w, dev)
        want = attn.decode_attention(q, kc, vc, held, pos=pos)
        lab, outs, n = Lab(), [None] * m, w // m

        def rank_fn(r):
            outs[r] = attn.decode_attention_kv_seq(
                q, kc[:, r * n:(r + 1) * n], vc[:, r * n:(r + 1) * n],
                held[r * n:(r + 1) * n], pos=pos, plane=RankPlane(lab, r))
        threads = [threading.Thread(target=rank_fn, args=(r,))
                   for r in range(m)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads) or any(o is None for o in outs):
            raise AssertionError("phase 16 (c): a slice did not finish")
        err = max(float((o.float() - want.float()).abs().max())
                  for o in outs)
        errs[str(dtype)[6:]] = err
        if err > tol or not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"phase 16 (c) {dtype}: max err {err} > "
                                 f"{tol}, or the slices' results differ")
    log(f"  KV_SEQ decode combine, 16 slices of a {b}x{w} cache (32/8 heads, "
        f"hd 64) against decode_attention: max err {errs}")
    return errs


def plane_dryrun():
    """Phase 16 (d): ``launch.dryrun`` of Llama-3.2-1B's four shapes on both
    production meshes with the roofline (one rank's count), each line
    printed by ``dryrun.run_one``."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun
    out = os.path.join(ROOT, "runs", "dryrun_torch")
    recs = [dryrun.run_one("llama3.2-1b", shape, out, True, mesh)
            for shape in INPUT_SHAPES for mesh in ("pod16x16", "pod2x16x16")]
    failed = [f"{r['shape']} {r['mesh']}" for r in recs if r["status"] != "ok"]
    cache = next(r for r in recs if r["shape"] == "decode_32k"
                 and r["mesh"] == "pod16x16")["memory"]["cache_size_in_bytes"]
    log(f"  decode_32k at 16 x 16: {cache / 2**30:.3f} GiB of KV cache a "
        "rank")
    if failed or cache != 2 ** 29:
        raise AssertionError(f"phase 16 (d): failed {failed}, cache {cache}")


def model_plane_phase(torch, ops, ref, fa_mod, dev):
    """Phase 16: (a) under ``launch.mesh.host_rules`` (a one-rank NCCL group
    made over a ``HashStore``, destroyed after), then (b), (c) and (d).
    Returns (a)'s launches and (b)'s rows."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_rules
    torch.cuda.set_device(0)
    with host_rules(device=dev) as rules:
        log(f"  mesh {rules.shape} on backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank")
        launches = plane_llama(torch, ops, dev, rules)
    shapes = plane_flash(torch, ops, ref, fa_mod, dev)
    plane_kv_seq(torch, dev)
    plane_dryrun()
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 17: the MoE family on the model plane
# ---------------------------------------------------------------------------

# qwen2-moe-a2.7b's per-rank attention (16 heads, MHA, head_dim 128) at
# model 2, 4 and 16: (label, query heads, KV heads) a rank
MOE_PLANE_HEADS = (("model 2", 8, 8), ("model 4", 4, 4), ("model 16", 1, 1))


def _plane_checks(torch, label, runs, pre, dec, n_flash):
    """The bit-for-bit and launch checks of two ``_plane_serves`` runs."""
    (r0, _), (r1, launches) = runs["rules=None"], runs["mesh (1, 1)"]
    return {
        f"{label}: prefill logits bit for bit": torch.equal(r0.logits,
                                                            r1.logits),
        f"{label}: decode steps' tokens bit for bit": torch.equal(r0.tokens,
                                                                  r1.tokens),
        f"{label}: no collective in a prefill or a decode step":
            not (pre[0] or dec[0]),
        f"{label}: flash_attention_sm90 launched {n_flash} times in the "
        "mesh serve, nothing else": launches == {
            n: (n_flash if n == "flash_attention_sm90" else 0)
            for n in launches},
        f"{label}: logits finite": bool(r1.logits.isfinite().all()),
    }


def moe_plane_qwen2(torch, ops, dev, rules):
    """Phase 17 (a): qwen2-moe-a2.7b at full width and depth (phase 11's
    f32 weights and bf16 activations) served at 4 x 2,048 + 33 tokens (32
    decode steps, Gumbel noise drawn once) with ``rules=None`` and under
    the one-rank mesh's rules from one parameter tree (``place_params``
    returns views of the same storage at one rank), then trained at phase
    13's cut (4 of 24 layers, 2 x 2,048, 3 donated AdamW steps) both ways,
    the first run's final parameters kept on the host. Everything bit for
    bit; 24 sm90 launches a prefill; no collective in a prefill, a decode
    step or a train step. Returns the rules serve's launches."""
    import dataclasses
    from repro_torch import sharding as sh
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-moe-a2.7b")
    model = build_model(cfg)
    b, s, gen = 4, 2048, 33
    params, g = _draw(torch, model, dev)
    placed = sh.place_params(params, model.param_logical(), rules)
    same_tree = all(a.data_ptr() == c.data_ptr() and a.shape == c.shape
                    for a, c in zip(tree_leaves(params), tree_leaves(placed)))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    noise = gumbel_noise(g, (gen, b, 1, cfg.vocab_size))
    runs, pre, dec = _plane_serves(torch, ops, model, params, placed, rules,
                                   tokens, noise, dev)
    launches = runs["mesh (1, 1)"][1]
    checks = _plane_checks(torch, cfg.name, runs, pre, dec, cfg.n_layers)
    checks["place_params copied nothing"] = same_tree
    del params, placed, runs
    _release(torch)
    tm = build_model(dataclasses.replace(cfg, n_layers=4))
    tc = TrainConfig(total_steps=10, warmup_steps=2)
    bt = 2
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (bt, s), generator=g, device=dev)
        for _ in range(3))]
    l0, p0, sec0, _ = _train_llama(torch, tm, tc, batches, dev, None)
    p0 = tree_map(lambda a: a.cpu(), p0)
    _release(torch)
    base = reset_peak(torch, "qwen2-moe (4 of 24 layers) mesh (1, 1) train")
    _zero_launches(ops)
    l1, p1, sec1, (tr_calls, tr_bytes) = _train_llama(torch, tm, tc,
                                                      batches, dev, rules)
    train_launches = _launch_counts(ops)
    peak = peak_text(torch, base)
    checks["train: final parameters bit for bit"] = all(
        torch.equal(a, c.cpu()) for a, c in zip(tree_leaves(p0),
                                                tree_leaves(p1)))
    checks["train: losses bit for bit"] = torch.equal(l0, l1)
    checks["train: no collective in a step"] = not tr_calls
    checks["train: no kernel launched"] = not any(train_launches.values())
    del p0, p1
    _release(torch)
    log(f"  train {cfg.name} (4 of 24 layers) {bt}x{s}, 3 donated AdamW "
        f"steps: rules=None losses {[round(float(x), 6) for x in l0]}, "
        f"seconds {[round(x, 3) for x in sec0]}; mesh (1, 1) losses "
        f"{[round(float(x), 6) for x in l1]}, seconds "
        f"{[round(x, 3) for x in sec1]}; {peak}; launches {train_launches}")
    log(f"  one-rank collectives: prefill {pre[0]} ({pre[1]} bytes); decode "
        f"step {dec[0]} ({dec[1]} bytes); train step {tr_calls} "
        f"({tr_bytes} bytes)")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 17 (a) checks failed: {failed}")
    return launches


def moe_plane_moonshot(torch, ops, dev, rules):
    """Phase 17 (b): moonshot-v1-16b-a3b cut to 8 layers (``MOE_CUT``) with
    the gather dispatch (one group of the batch's 8,192 tokens), served at
    4 x 2,048 + 9 tokens with ``rules=None`` and under the one-rank rules:
    the expert-parallel layout's code (its 64 experts split along E over a
    model axis of one) and the gather dispatch's ``Part`` path on the
    card, bit for bit."""
    import dataclasses
    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    layers = dict(MOE_CUT)["moonshot-v1-16b-a3b"]
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              n_layers=layers, moe_dispatch="gather")
    model = build_model(cfg)
    params, g = _draw(torch, model, dev)
    placed = sh.place_params(params, model.param_logical(), rules)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device=dev)
    noise = gumbel_noise(g, (9, 4, 1, cfg.vocab_size))
    plan = tf._plan(cfg, rules, "prefill", {"tokens": tokens})
    log(f"  {cfg.name} ({layers} layers, gather dispatch): the plan's "
        f"experts {plan.experts} of {cfg.n_experts}, expert-parallel "
        f"{plan.moe_ep}")
    runs, pre, dec = _plane_serves(torch, ops, model, params, placed, rules,
                                   tokens, noise, dev)
    checks = _plane_checks(torch, cfg.name, runs, pre, dec, layers)
    checks["the expert-parallel layout"] = plan.moe_ep
    del params, placed, runs
    _release(torch)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 17 (b) checks failed: {failed}")


def moe_plane_dryrun():
    """Phase 17 (d): ``launch.dryrun`` of qwen2-moe's train_4k and
    moonshot's decode_32k on both production meshes with the roofline (one
    rank's count), each line printed by ``dryrun.run_one``."""
    from repro_torch.launch import dryrun
    out = os.path.join(ROOT, "runs", "dryrun_torch")
    recs = [dryrun.run_one(arch, shape, out, True, mesh)
            for arch, shape in (("qwen2-moe-a2.7b", "train_4k"),
                                ("moonshot-v1-16b-a3b", "decode_32k"))
            for mesh in ("pod16x16", "pod2x16x16")]
    failed = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in recs
              if r["status"] != "ok"]
    if failed:
        raise AssertionError(f"phase 17 (d): failed {failed}")


def moe_plane_phase(torch, ops, ref, fa_mod, dev):
    """Phase 17: (a) and (b) under ``launch.mesh.host_rules`` (a one-rank
    NCCL group made over a ``HashStore``, destroyed after), then (c) the
    tensor-core flash kernel at qwen2-moe's per-rank heads and (d).
    Returns (a)'s launches and (c)'s rows."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_rules
    torch.cuda.set_device(0)
    with host_rules(device=dev) as rules:
        log(f"  mesh {rules.shape} on backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank")
        t0 = time.perf_counter()
        launches = moe_plane_qwen2(torch, ops, dev, rules)
        log(f"  phase 17 (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe_plane_moonshot(torch, ops, dev, rules)
        log(f"  phase 17 (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shapes = plane_flash(torch, ops, ref, fa_mod, dev, MOE_PLANE_HEADS, 128,
                         "qwen2-moe-a2.7b")
    log(f"  phase 17 (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_plane_dryrun()
    log(f"  phase 17 (d) {time.perf_counter() - t0:.1f} s")
    return launches, shapes



# ---------------------------------------------------------------------------
# phase 18: the recurrent families on the model plane
# ---------------------------------------------------------------------------

# recurrentgemma-2b's local attention a rank at model 2, 4 and 16: 10 query
# heads over the ranks (split_range's largest part), its one KV head whole
RECURRENT_PLANE_HEADS = (("model 2", 5), ("model 4", 3), ("model 16", 1))
# the serves (arch, batch, prompt, decode steps + 1, sm90 launches a
# prefill: phase 10's) and the train steps at phase 13's cuts (arch,
# batch, tokens: recurrentgemma at full depth, xlstm at train_e2e --quick's
# shape)
RECURRENT_PLANE_SERVES = (("recurrentgemma-2b", 4, 4096, 33, 8),
                          ("xlstm-125m", 4, 2048, 33, 0))
RECURRENT_PLANE_TRAIN = (("recurrentgemma-2b", 1, 2048), ("xlstm-125m", 2, 64))


def recurrent_plane_serve(torch, ops, dev, rules, arch, b, s, gen, n_flash):
    """Phase 18 (a, b): ``arch`` at full width and depth (seed 0's f32
    weights, bf16 activations) served at ``b`` x ``s`` + ``gen`` tokens
    (one Gumbel draw) with ``rules=None`` and under the one-rank mesh's
    rules from one parameter tree: logits and tokens bit for bit,
    ``n_flash`` sm90 launches a prefill and nothing else, no collective in
    a prefill or a decode step. Returns (the rules serve's launches, the
    checks)."""
    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    params, g = _draw(torch, model, dev)
    placed = sh.place_params(params, model.param_logical(), rules)
    same_tree = all(a.data_ptr() == c.data_ptr() and a.shape == c.shape
                    for a, c in zip(tree_leaves(params), tree_leaves(placed)))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    noise = gumbel_noise(g, (gen, b, 1, cfg.vocab_size))
    runs, pre, dec = _plane_serves(torch, ops, model, params, placed, rules,
                                   tokens, noise, dev)
    checks = _plane_checks(torch, arch, runs, pre, dec, n_flash)
    checks[f"{arch}: place_params copied nothing"] = same_tree
    log(f"  one-rank collectives: prefill {pre[0]} ({pre[1]} bytes); decode "
        f"step {dec[0]} ({dec[1]} bytes)")
    launches = runs["mesh (1, 1)"][1]
    del params, placed, runs
    _release(torch)
    return launches, checks


def recurrent_plane_train(torch, ops, dev, rules, arch, b, s):
    """Phase 18 (a, b): ``plane_train`` of ``arch`` at full depth on ``b``
    x ``s`` tokens drawn from seed 1. Returns the checks."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{"tokens": t, "labels": t} for t in (
        torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
        for _ in range(3))]
    return plane_train(torch, ops, dev, rules, build_model(cfg), batches)


def plane_train(torch, ops, dev, rules, model, batches):
    """Phases 18 (a, b), 19 (a, b): 3 donated AdamW steps of ``model`` on
    ``batches`` with ``rules=None`` and under the rules (the first run's
    final parameters kept on the host): losses and parameters bit for bit,
    no collective in a step, no kernel launched. Returns the checks."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import batch_rows_len
    cfg = model.cfg
    arch = cfg.name
    b, s = batch_rows_len(batches[0])
    tc = TrainConfig(total_steps=10, warmup_steps=2)
    l0, p0, sec0, _ = _train_llama(torch, model, tc, batches, dev, None)
    p0 = tree_map(lambda a: a.cpu(), p0)
    _release(torch)
    base = reset_peak(torch, f"{arch} mesh (1, 1) train")
    _zero_launches(ops)
    l1, p1, sec1, (calls, nbytes) = _train_llama(torch, model, tc, batches,
                                                 dev, rules)
    launches = _launch_counts(ops)
    peak = peak_text(torch, base)
    checks = {
        f"train {arch}: final parameters bit for bit": all(
            torch.equal(a, c.cpu()) for a, c in zip(tree_leaves(p0),
                                                    tree_leaves(p1))),
        f"train {arch}: losses bit for bit": torch.equal(l0, l1),
        f"train {arch}: no collective in a step": not calls,
        f"train {arch}: no kernel launched": not any(launches.values()),
        f"train {arch}: losses finite": bool(l1.isfinite().all()),
    }
    del p0, p1
    _release(torch)
    log(f"  train {arch} ({cfg.n_layers} layers) {b}x{s}, 3 donated AdamW "
        f"steps: rules=None losses {[round(float(x), 6) for x in l0]}, "
        f"seconds {[round(x, 3) for x in sec0]}; mesh (1, 1) losses "
        f"{[round(float(x), 6) for x in l1]}, seconds "
        f"{[round(x, 3) for x in sec1]}; {peak}; launches {launches}; "
        f"collectives {calls} ({nbytes} bytes)")
    return checks


def recurrent_plane_flash(torch, ops, ref, fa_mod, dev):
    """Phase 18 (c): the tensor-core flash kernel at recurrentgemma-2b's
    local attention a rank would launch at model 2, 4 and 16 (q (4, 4,096,
    h, 256), k/v (4, 4,096, 1, 256) bf16, causal, window 2,048;
    ``RECURRENT_PLANE_HEADS``) against the plain version (``check_flash``),
    timed beside the plain version, one SDPA call (the window as a boolean
    mask, ``enable_gqa``) and the bound of the keys each query sees.
    Returns the rows for the sm90 row's ``shapes``."""
    import torch.nn.functional as F
    b, s, kv, hd, window = 4, 4096, 1, 256, 2048
    g = torch.Generator(device=dev).manual_seed(18)
    pos = torch.arange(s, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                             < window)
    out = []
    for label, h in RECURRENT_PLANE_HEADS:
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for shape in
                   ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        if fa_mod.route(q, k, v) != "sm90":
            raise AssertionError(f"{label}: route did not pick sm90")
        err = check_flash(ops, ref, q, k, v, f"recurrentgemma-2b {label} per "
                          f"rank ({b},{s},{h}/{kv},{hd}) window {window} bf16",
                          "flash_attention_sm90", window=window)
        flops, moved = flash_work(b, s, h, kv, hd, window, q.element_size())
        b_ms, b_by = bound(moved, flops, "bfloat16")

        def kernel():
            return fa_mod.flash_attention_sm90(q, k, v, window=window)
        ms = graph_ms(kernel, iters=10, replays=3)
        call = cuda_ms(kernel, iters=20)
        plain = graph_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         window=window),
                         iters=2, replays=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=3, replays=2)
        log(f"  flash_attention_sm90 recurrentgemma-2b {label} per rank: "
            f"{flops / 1e9:.1f} GFLOP of visible keys; device {ms:.5f} ms, "
            f"per call {call:.5f} ms, plain {plain:.5f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}); SDPA {sdpa:.5f} ms")
        out.append({"shape": f"recurrentgemma-2b {label}: q ({b}, {s}, {h}, "
                    f"{hd}), k/v ({b}, {s}, {kv}, {hd}) bf16, causal, "
                    f"window {window}",
                    "max_abs_err": err, "ms": ms, "call_ms": call,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": sdpa})
        del q, k, v, qt, kt, vt
    return out


def recurrent_plane_phase(torch, ops, ref, fa_mod, dev):
    """Phase 18: (a) recurrentgemma-2b and (b) xlstm-125m served and
    trained under ``launch.mesh.host_rules`` (a one-rank NCCL group made
    over a ``HashStore``, destroyed after), then (c). Returns (a)'s serve
    launches and (c)'s rows."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_rules
    torch.cuda.set_device(0)
    checks, launches = {}, None
    with host_rules(device=dev) as rules:
        log(f"  mesh {rules.shape} on backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank")
        for (arch, b, s, gen, n_flash), (_, tb, ts), part in zip(
                RECURRENT_PLANE_SERVES, RECURRENT_PLANE_TRAIN, "ab"):
            t0 = time.perf_counter()
            served, c = recurrent_plane_serve(torch, ops, dev, rules, arch,
                                              b, s, gen, n_flash)
            checks.update(c)
            checks.update(recurrent_plane_train(torch, ops, dev, rules,
                                                arch, tb, ts))
            launches = launches or served
            log(f"  phase 18 ({part}) {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 18 (a, b) checks failed: {failed}")
    t0 = time.perf_counter()
    shapes = recurrent_plane_flash(torch, ops, ref, fa_mod, dev)
    log(f"  phase 18 (c) {time.perf_counter() - t0:.1f} s")
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 19: the vision and audio frontends on the model plane
# ---------------------------------------------------------------------------

# the per-rank attention a model-N mesh launches: (arch, head_dim, prompt,
# ((label, query heads, KV heads), ...)). qwen2-vl's 8 KV heads do not
# divide 16: every rank computes them all and reads its 4 query heads' one;
# musicgen's 24 heads split 1 or 2 a rank at model 16 (KV_SEQ too)
FRONTEND_PLANE_HEADS = (
    ("qwen2-vl-72b", 128, 2048, (("model 2", 32, 4), ("model 4", 16, 2),
                                 ("model 16", 4, 1))),
    ("musicgen-medium", 64, 1500, (("model 2", 12, 12), ("model 4", 6, 6),
                                   ("model 16, 2 heads", 2, 2),
                                   ("model 16, 1 head", 1, 1))))


def frontend_plane_serve(torch, ops, dev, rules, arch, layers, b, s, gen):
    """Phase 19 (a, b): ``arch`` at full width cut to ``layers`` (phase
    12's seed 0 f32 weights, bf16 activations and prompt: ``frontend_prompt``
    with Qwen2-VL's grid positions, or codes) served at ``b`` x ``s`` +
    ``gen`` tokens (one Gumbel draw) with ``rules=None`` and under the
    one-rank mesh's rules from one parameter tree: logits and tokens bit
    for bit, one sm90 launch a layer in the prefill and nothing else, no
    collective. Returns (the rules serve's launches, the checks)."""
    import dataclasses
    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build_model
    model = build_model(dataclasses.replace(get_config(arch),
                                            n_layers=layers))
    cfg = model.cfg
    params, g = _draw(torch, model, dev)
    placed = sh.place_params(params, model.param_logical(), rules)
    same_tree = all(a.data_ptr() == c.data_ptr() and a.shape == c.shape
                    for a, c in zip(tree_leaves(params), tree_leaves(placed)))
    prompt = frontend_prompt(torch, cfg, b, s, g, dev)
    warm = frontend_prompt(torch, cfg, b, 256, g, dev)
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    noise = gumbel_noise(g, (gen, b, 1) + nq + (cfg.vocab_size,))
    runs, pre, dec = _plane_serves(torch, ops, model, params, placed, rules,
                                   prompt, noise, dev, warm)
    checks = _plane_checks(torch, arch, runs, pre, dec, layers)
    checks[f"{arch}: place_params copied nothing"] = same_tree
    log(f"  one-rank collectives: prefill {pre[0]} ({pre[1]} bytes); decode "
        f"step {dec[0]} ({dec[1]} bytes)")
    launches = runs["mesh (1, 1)"][1]
    del params, placed, runs
    _release(torch)
    return launches, checks


def frontend_dryrun():
    """Phase 19 (d): one rank of 16 x 16 counted (``dryrun.count_step`` on
    meta tensors) serving musicgen-medium as phase 12 does, 4 x 1,500
    frames + 32: the prefill into a cache of 1,532 slots and a decode
    step on it. Its 24 KV heads do not divide the model axis and 16 does
    not divide the 1,532 slots, so the cache lies whole on every rank and
    a decode step runs no softmax combine: over "model" it all-reduces
    2L + 1 times (each block's two row-parallel sums and the embedding)
    and all-gathers L + 2 (each block's KV columns, the codec head's
    columns, the logits). Prints the rank's bytes and each kind of
    collective."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    cfg = get_config("musicgen-medium")
    b, s, gen = 4, 1500, 32
    layers = cfg.n_layers
    t0 = time.perf_counter()
    recs = {}
    for kind, shape, max_len in (
            ("prefill", InputShape("serve", s, b, "prefill"), s + gen),
            ("decode", InputShape("serve", s + gen, b, "decode"), None)):
        rec = dryrun.count_step(cfg, shape, max_len=max_len,
                                rules=dryrun.mesh_rules("pod16x16"))
        mem = rec["memory"]
        calls = {f"{r['kind']} {'x'.join(r['axes'])}": r["calls"]
                 for r in rec["collective_calls"]}
        cache = (f", {mem['cache_size_in_bytes'] / 2**30:.3f} GiB of them "
                 "the cache") if kind == "decode" else ""
        log(f"  dry run, musicgen-medium {kind} {b} x {s} + {gen} on one "
            f"rank of 16 x 16: arguments "
            f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB{cache}, peak "
            f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB above them; "
            f"collectives {calls}, bytes {rec['collectives']}")
        recs[kind] = calls
    log(f"  phase 19 (d) {time.perf_counter() - t0:.1f} s")
    dec = recs["decode"]
    want = {"all-reduce model": 2 * layers + 1,
            "all-gather model": layers + 2}
    got = {k: dec.get(k) for k in want}
    if got != want:
        raise AssertionError(f"phase 19 (d): the decode step's collectives "
                             f"over model {got}, not {want} (a softmax "
                             "combine over a whole cache?)")


def frontend_plane_phase(torch, ops, ref, fa_mod, dev):
    """Phase 19: (a) qwen2-vl-72b (8 of 80 layers) and (b) musicgen-medium
    served at phase 12's shapes (``FRONTEND_SERVES``) and trained at phase
    13's cuts (``FAMILY_FULL``, seed 1's batches, a vision batch on
    Qwen2-VL's grid) under ``launch.mesh.host_rules`` (a one-rank NCCL
    group made over a ``HashStore``, destroyed after), each against
    ``rules=None``; then (c) the tensor-core flash kernel at both models'
    per-rank attention (``FRONTEND_PLANE_HEADS``) and (d) the dry run of
    musicgen-medium served on one rank of 16 x 16 (``frontend_dryrun``).
    Returns {arch: the serve's launches} and (c)'s rows."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import host_rules
    from repro_torch.models.registry import build_model
    torch.cuda.set_device(0)
    trains = {arch: (layers, b, s) for arch, layers, b, s in FAMILY_FULL}
    checks, launches = {}, {}
    with host_rules(device=dev) as rules:
        log(f"  mesh {rules.shape} on backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank")
        for (arch, layers, b, s, gen, _), part in zip(FRONTEND_SERVES, "ab"):
            t0 = time.perf_counter()
            launches[arch], c = frontend_plane_serve(
                torch, ops, dev, rules, arch, layers, b, s, gen)
            checks.update(c)
            layers, b, s = trains[arch]
            model = build_model(dataclasses.replace(get_config(arch),
                                                    n_layers=layers))
            g = torch.Generator(device=dev).manual_seed(1)
            batches = [_family_batch(torch, model.cfg, b, s, g, dev,
                                     grid_w=8) for _ in range(3)]
            checks.update(plane_train(torch, ops, dev, rules, model,
                                      batches))
            del batches
            _release(torch)
            log(f"  phase 19 ({part}) {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 19 (a, b) checks failed: {failed}")
    t0 = time.perf_counter()
    shapes = []
    for arch, hd, s, heads in FRONTEND_PLANE_HEADS:
        shapes += plane_flash(torch, ops, ref, fa_mod, dev, heads, hd, arch,
                              s, f32_heads=None, seed=19)
    log(f"  phase 19 (c) {time.perf_counter() - t0:.1f} s")
    frontend_dryrun()
    return launches, shapes


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
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line or "C75" in line):
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
    recurrent_reference_phase(torch, ops, dev)
    moe_reference_phase(torch, ops, dev)
    frontend_reference_phase(torch, ops, dev)

    log("== phase 4: smart-exchange main path at full width")
    launches, main_rec = main_path(torch, ops, dev)

    log("== phase 5: serving Llama-3.2-1B at full width")
    served, served32, llama_prefill_s = serve_phase(torch, ops, dev)
    # each f32 prefill's flash_attention launches, by model (phases 5, 10-12)
    f32_launches = {"llama3.2-1b": served32["flash_attention"]}
    launches["flash_attention_sm90"] = served["flash_attention_sm90"]
    launches["flash_attention"] = served32["flash_attention"]

    log("== phase 6: the online orchestrator")
    online, online_errs, online_segs, online_secs = orchestrator_full(
        torch, ops, ref, dev)
    orchestrator_reference(torch, dev)
    orchestrator_resume(torch, dev)

    log("== phase 7: training Llama-3.2-1B, and the federated-LLM example")
    trained, llama_steps = train_full(torch, ops, dev)
    fed_launches, fed_shape = federated_llm_phase(torch, ops, ref, km_mod,
                                                  dev)
    train_reference(torch, dev)

    log("== phase 8: the scan engine, a CIFAR-like main path, the "
        "clustering loop")
    scanned = scan_full(torch, ops, dev)
    scan_resume(torch, dev)
    cifar, cifar_shape = cifar_main_path(torch, ops, ref, rg_mod, dev)
    loop_shape = clustering_loop_phase(torch, ops, ref, km_mod, dev)

    log("== phase 9: the observability plane")
    traced_on, on_secs, n_spans = traced_online(torch, ops, dev, online,
                                                online_segs)
    traced_sc, sc_secs, chunk_secs = traced_scan(torch, ops, dev, scanned)
    profiled_runs(torch, ops, dev, on_secs, sc_secs, chunk_secs)
    disabled_span_cost(n_spans, on_secs)

    log("== phase 10: serving recurrentgemma-2b and xlstm-125m at full width")
    recurrent = recurrent_serve_phase(torch, ops, dev, f32_launches)

    log("== phase 11: serving the MoE family at full width")
    moe_served = moe_serve_phase(torch, ops, dev, f32_launches)

    log("== phase 12: serving qwen2-vl-72b (8 layers) and musicgen-medium "
        "at full width")
    t12 = time.perf_counter()
    frontends = frontend_serve_phase(torch, ops, dev, f32_launches)
    log(f"  phase 12 {time.perf_counter() - t12:.1f} s")

    log("== phase 13: training the MoE, vision, audio and recurrent "
        "families")
    t13 = time.perf_counter()
    family_train_reference(torch, dev)
    family_trained = family_train_full(torch, ops, dev)
    family_trained["xlstm-125m"] = train_e2e_phase(torch, ops, dev)
    log(f"  phase 13 {time.perf_counter() - t13:.1f} s")

    log("== phase 14: the quickstart, moonshot-v1-16b-a3b at 48 layers in "
        "bf16, the dry run against the card")
    t14 = time.perf_counter()
    quick = quickstart_phase(torch, ops, dev)
    moonshot_full, moonshot_prefill_s, moonshot_cfg = moonshot_full_phase(
        torch, ops, dev)
    checks = dryrun_phase(torch, llama_prefill_s, llama_steps,
                          moonshot_prefill_s, moonshot_cfg)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dry run checks failed: {failed}")
    log(f"  phase 14 {time.perf_counter() - t14:.1f} s")

    log("== phase 15: the sharded client plane on a one-rank NCCL mesh")
    t15 = time.perf_counter()
    plane = client_plane_phase(torch, ops, dev, main_rec, online_segs,
                               online_secs)
    log(f"  phase 15 {time.perf_counter() - t15:.1f} s")

    log("== phase 16: the model plane (dense Llama) on a one-rank NCCL mesh")
    t16 = time.perf_counter()
    plane_launches, plane_shapes = model_plane_phase(torch, ops, ref, fa_mod,
                                                     dev)
    log(f"  phase 16 {time.perf_counter() - t16:.1f} s")

    log("== phase 17: the model plane (MoE family) on a one-rank NCCL mesh")
    t17 = time.perf_counter()
    moe_plane_launches, moe_plane_shapes = moe_plane_phase(torch, ops, ref,
                                                           fa_mod, dev)
    log(f"  phase 17 {time.perf_counter() - t17:.1f} s")

    log("== phase 18: the model plane (recurrent families) on a one-rank "
        "NCCL mesh")
    t18 = time.perf_counter()
    rec_plane_launches, rec_plane_shapes = recurrent_plane_phase(
        torch, ops, ref, fa_mod, dev)
    log(f"  phase 18 {time.perf_counter() - t18:.1f} s")

    log("== phase 19: the model plane (vision and audio frontends) on a "
        "one-rank NCCL mesh")
    t19 = time.perf_counter()
    front_plane_launches, front_plane_shapes = frontend_plane_phase(
        torch, ops, ref, fa_mod, dev)
    log(f"  phase 19 {time.perf_counter() - t19:.1f} s")
    log(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s")

    for name, row in rows.items():
        row["launches"] = launches[name]
        row["online_launches"] = online[name]
        row["train_launches"] = trained[name]
        row["federated_llm_launches"] = fed_launches[name]
        row["scan_launches"] = scanned[name]
        row["cifar_launches"] = cifar[name]
        row["traced_online_launches"] = traced_on[name]
        row["traced_scan_launches"] = traced_sc[name]
        row["recurrentgemma_serve_launches"] = \
            recurrent["recurrentgemma-2b"][name]
        row["xlstm_serve_launches"] = recurrent["xlstm-125m"][name]
        row["qwen2_moe_serve_launches"] = moe_served["qwen2-moe-a2.7b"][name]
        row["phi35_moe_serve_launches"] = \
            moe_served["phi3.5-moe-42b-a6.6b"][name]
        row["moonshot_serve_launches"] = \
            moe_served["moonshot-v1-16b-a3b"][name]
        row["qwen2_vl_serve_launches"] = frontends["qwen2-vl-72b"][name]
        row["musicgen_serve_launches"] = frontends["musicgen-medium"][name]
        row["family_train_launches"] = {arch: v[name] for arch, v in
                                        family_trained.items()}
        row["quickstart_launches"] = quick[name]
        row["moonshot_full_serve_launches"] = moonshot_full[name]
        row["client_plane_launches"] = {k: v[name] for k, v in
                                        plane.items()}
        row["model_plane_launches"] = plane_launches[name]
        row["moe_plane_launches"] = moe_plane_launches[name]
        row["recurrent_plane_launches"] = rec_plane_launches[name]
        row["frontend_plane_launches"] = {arch: v[name] for arch, v in
                                          front_plane_launches.items()}
        if name in online_errs:
            row["online_max_abs_err"] = online_errs[name]
    rows["kmeans_assign"]["shapes"].append(fed_shape)
    rows["kmeans_assign"]["shapes"].append(loop_shape)
    rows["recon_gate"]["shapes"] = [cifar_shape]
    rows["flash_attention_sm90"]["shapes"].extend(plane_shapes)
    rows["flash_attention_sm90"]["shapes"].extend(moe_plane_shapes)
    rows["flash_attention_sm90"]["shapes"].extend(rec_plane_shapes)
    rows["flash_attention_sm90"]["shapes"].extend(front_plane_shapes)
    for shape in rows["flash_attention"]["shapes"]:
        if "model" in shape:
            shape["launches_in_phase"] = f32_launches[shape["model"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "online_launches", "train_launches", "federated_llm_launches",
            "scan_launches", "cifar_launches", "traced_online_launches",
            "traced_scan_launches", "recurrentgemma_serve_launches",
            "xlstm_serve_launches", "qwen2_moe_serve_launches",
            "phi35_moe_serve_launches", "moonshot_serve_launches",
            "qwen2_vl_serve_launches", "musicgen_serve_launches",
            "family_train_launches", "quickstart_launches",
            "moonshot_full_serve_launches", "client_plane_launches",
            "model_plane_launches", "moe_plane_launches",
            "recurrent_plane_launches", "frontend_plane_launches",
            "max_abs_err",
            "online_max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "cold_ms",
            "floor_ms", "shapes")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
