"""Serving launcher: batched prefill + decode loop (mirrors
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``--arch`` takes every ported config: the Llama family, the MoE family
(``qwen2-moe-a2.7b``, ``phi3.5-moe-42b-a6.6b``, ``moonshot-v1-16b-a3b``),
``xlstm-125m`` and ``recurrentgemma-2b``. The prefill runs attention through
the flash kernel (``use_flash=True``): on the card the hand-written kernel,
on the host its plain version. xLSTM has no attention; the MoE family's
attention (bf16, head_dim 128) and recurrentgemma's local attention (bf16,
head_dim 256) take the tensor-core flash kernel, their float32 variants the
CUDA-core one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.registry import Model, build_model


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor     # (B, gen) sampled token ids
    prefill_s: float         # prefill, host clock ending in a device sync
    decode_s: float          # gen - 1 decode steps with their sampling
    logits: torch.Tensor     # (B, 1, V) the prefill's last-token logits


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) as
    ``jax.random.gumbel`` makes them, on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample(logits, temperature: float, noise):
    """Categorical draw by the Gumbel-max trick: what
    ``jax.random.categorical(key, logits / T)`` computes from the Gumbel
    draws of that key."""
    return torch.argmax(logits / max(temperature, 1e-4) + noise, dim=-1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Model, params, tokens, gen: int, *, temperature=1.0,
          gumbel: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None,
          device="cuda") -> ServeResult:
    """Prefill ``tokens`` (B, S) into a cache of capacity S + gen, then
    sample ``gen`` tokens, one decode step per token after the first.

    ``gumbel`` (gen, B, 1, V) is the sampling noise, step by step (the JAX
    launcher's draws from ``key`` for the first token, then from
    ``fold_in(key, i)``); without it the noise is drawn from ``generator``
    (seeded 0 on the device when not given)."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    if gumbel is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def noise(i, shape):
        if gumbel is not None:
            return gumbel[i].to(dev)
        return gumbel_noise(generator, shape).to(dev)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len=s + gen,
                                  use_flash=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    first_logits = logits
    tok = sample(logits, temperature, noise(0, logits.shape))
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode(params, cache, {"token": tok})
        tok = sample(logits, temperature, noise(i + 1, logits.shape))
        out.append(tok)
    _sync(dev)
    return ServeResult(torch.cat(out, dim=1), prefill_s,
                       time.perf_counter() - t0, first_logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(args.device)
    generator = torch.Generator(device=dev).manual_seed(0)
    params = model.init(generator, device=dev)
    b, s = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=generator,
                           device=dev)
    res = serve(model, params, tokens, args.gen,
                temperature=args.temperature, generator=generator, device=dev)
    print(f"prefill {b}x{s}: {res.prefill_s*1e3:.1f} ms "
          f"({b*s/res.prefill_s:.0f} tok/s)")
    steps = args.gen - 1
    print(f"decode {steps} steps x {b} seqs: {res.decode_s*1e3:.1f} ms "
          f"({steps * b / max(res.decode_s, 1e-9):.0f} tok/s)")
    print("sampled tokens[0][:16]:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
