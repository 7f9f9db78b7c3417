"""End-to-end training driver (mirrors ``examples/train_e2e.py``): trains
xlstm-125m, the full config, for a few hundred steps on synthetic
topic-skewed tokens.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 30 \
        --quick [--device cpu]

--quick shrinks the batch to 2 x 64 tokens. Step i trains on one batch of
``data.tokens`` draws from topic i % 8 (a token from the topic's slice of
the vocabulary with probability 0.85, else from the whole vocabulary).
AdamW at 6e-4 with max(5, steps // 20) warmup steps and block remat, as
``make_train_step`` runs it, each step writing the parameters and moments in
place (``donate=True``: the reference's ``donate_argnums``). Weights and
every batch come from one generator on the run's device, seeded 0. A run of 100 steps or more must
end with a lower mean loss over its last max(5, steps // 10) steps than
over its first. The final parameters go to ``--ckpt`` (``save_pytree``).
``main`` returns the per-step losses.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim, resolve_device
from repro_torch import sharding as sh
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.tokens import draw_topic_tokens, topic_token_batch
from repro_torch.launch.mesh import host_rules
from repro_torch.launch.specs import place_batch
from repro_torch.models.registry import build_model, make_train_step


def step_tokens(generator: torch.Generator, i: int, *, batch: int,
                seq_len: int, vocab: int) -> torch.Tensor:
    """Step i's (batch, seq_len) int32 tokens, drawn from topic i % 8."""
    return topic_token_batch(draw_topic_tokens(
        generator, i % 8, batch=batch, seq_len=seq_len, vocab=vocab))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt", default="runs/train_e2e/xlstm125m_torch.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.seq, args.batch = 64, 2

    cfg = get_config("xlstm-125m")   # the full config
    model = build_model(cfg)
    tc = TrainConfig(optimizer="adamw", learning_rate=6e-4,
                     total_steps=args.steps,
                     warmup_steps=max(5, args.steps // 20))
    dev = resolve_device(args.device)
    with host_rules(device=dev) as rules:
        return _train(args, cfg, model, tc, dev, rules)


def _train(args, cfg, model, tc, dev, rules) -> list:
    gen = torch.Generator(device=dev).manual_seed(0)
    params = sh.place_params(model.init(gen, device=dev),
                             model.param_logical(), rules)
    opt = optim.init_opt_state(params, tc.optimizer)
    step = make_train_step(model, tc, donate=True, rules=rules)
    print(f"model={cfg.name} params={model.n_params():,} "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        toks = step_tokens(gen, i, batch=args.batch, seq_len=args.seq,
                           vocab=cfg.vocab_size).long()
        params, opt, m = step(params, opt, place_batch(
            {"tokens": toks, "labels": toks}, rules), global_batch=args.batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            rate = (i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({rate:.0f} tok/s)", flush=True)
    w = max(5, args.steps // 10)
    first = sum(losses[:w]) / w
    last = sum(losses[-w:]) / w
    print(f"mean loss first {w} steps {first:.4f} -> last {w} steps "
          f"{last:.4f}")
    if args.steps >= 100:   # short demo runs are too noisy to gate on
        assert last < first, "loss did not decrease"
    save_pytree(args.ckpt, params)
    print(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
