"""Generic training launcher (mirrors ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 20 --batch 4 --seq 128 [--device cpu]

Runs real steps of ``make_train_step`` (AdamW, cosine warmup, global-norm
clipping, block remat) on synthetic token batches drawn from a generator on
the run's device, each step writing the parameters and moments in place
(``donate=True``, as the reference jits its step with
``donate_argnums``). --smoke selects the reduced config; the full config is
for the card. Each step ends in a device sync, so the printed seconds are
the device's. ``main`` returns a :class:`TrainResult`.

As the reference does, the run builds the host mesh (``launch.mesh.
host_rules``: the process group's ranks, one rank made on the spot when
there is none: NCCL on the card, gloo with ``--device cpu``) and passes
``ShardingRules.default`` of it to the step; the parameters and each
batch are placed on it (``sharding.place_params``); every family runs
on the model plane, the frontends included. On one rank that is the
unsharded run, bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import optim, resolve_device
from repro_torch import sharding as sh
from repro_torch.configs import (ARCH_IDS, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.launch.mesh import host_rules
from repro_torch.launch.specs import place_batch
from repro_torch.models.registry import build_model, make_train_step


@dataclasses.dataclass
class TrainResult:
    loss: list          # per step
    grad_norm: list     # per step, before clipping
    lr: list            # per step
    seconds: list       # per step, host clock ending in a device sync


def synth_batch(cfg, generator: torch.Generator, b: int, s: int) -> dict:
    """A batch of sequence length s drawn on the generator's device, in the
    reference's shapes and dtypes: (b, s) uniform token ids as their own
    labels; audio (b, s, nq) codes as their own labels; vision min(64,
    s // 2) standard normal bf16 patch embeddings, s - n_img text tokens
    and (b, s) uniform labels."""
    dev = generator.device

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                             device=dev)
    if cfg.frontend == "audio_codec":
        c = ids(b, s, cfg.n_codebooks)
        return {"codes": c, "labels": c}
    if cfg.frontend == "vision_stub":
        n_img = min(64, s // 2)
        return {"embeds": torch.randn((b, n_img, cfg.frontend_dim),
                                      generator=generator, device=dev
                                      ).to(torch.bfloat16),
                "tokens": ids(b, s - n_img), "labels": ids(b, s)}
    t = ids(b, s)
    return {"tokens": t, "labels": t}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(2, args.steps // 10), seed=args.seed)
    dev = resolve_device(args.device)
    with host_rules(device=dev) as rules:
        return _run(args, cfg, model, tc, dev, rules)


def _run(args, cfg, model, tc, dev, rules) -> TrainResult:
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    params = sh.place_params(model.init(gen, device=dev),
                             model.param_logical(), rules)
    opt_state = optim.init_opt_state(params, tc.optimizer)
    step = make_train_step(model, tc, donate=True, rules=rules)

    print(f"arch={cfg.name} params={model.n_params():,} "
          f"active={model.n_active_params():,} device={dev}")
    res = TrainResult([], [], [], [])
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        batch = place_batch(synth_batch(cfg, gen, args.batch, args.seq),
                            rules)
        params, opt_state, metrics = step(params, opt_state, batch,
                                          global_batch=args.batch)
        _sync(dev)
        res.seconds.append(time.perf_counter() - ts)
        res.loss.append(float(metrics["loss"]))
        res.grad_norm.append(float(metrics["grad_norm"]))
        res.lr.append(float(metrics["lr"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={res.loss[-1]:.4f} "
                  f"gnorm={res.grad_norm[-1]:.3f} lr={res.lr[-1]:.2e} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print("done")
    return res


if __name__ == "__main__":
    main()
