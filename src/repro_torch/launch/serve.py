"""Serving launcher: batched prefill + decode loop (mirrors
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --batch 4 --prompt-len 64 --gen 32 [--device cpu]

``--arch`` takes every config: the Llama family, the MoE family
(``qwen2-moe-a2.7b``, ``phi3.5-moe-42b-a6.6b``, ``moonshot-v1-16b-a3b``),
``xlstm-125m``, ``recurrentgemma-2b``, the vision stub ``qwen2-vl-72b`` and
the audio codec ``musicgen-medium``. The prefill runs attention through the
flash kernel (``use_flash=True``): on the card the hand-written kernel, on
the host its plain version. xLSTM has no attention; the other families'
bf16 attention (head_dim 64, 128 or 256) takes the tensor-core flash
kernel, their float32 variants the 3xTF32 one.

For qwen2-vl, ``main`` builds the prefill batch its ``prefill`` takes:
min(256, S // 2) random bf16 patch embeddings of width ``frontend_dim``,
then S - n_img text tokens, all drawn from the run's generator (the JAX
launcher feeds every non-audio family ``{"tokens"}`` alone, which its
vision model cannot take). For musicgen it draws (B, S, nq) codes; each
step samples every codebook, so its tokens are (B, gen, nq).

``main`` builds the host mesh and ``ShardingRules.default`` of it, as the
reference does (``launch.mesh.host_rules``: one rank made on the spot when
no process group exists, NCCL on the card and gloo with ``--device cpu``),
and serves under those rules (every family on the model plane, the
frontends included): on one rank the unsharded run, bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import host_rules
from repro_torch.launch.specs import place_batch
from repro_torch.models.registry import Model, build_model

VLM_IMG_TOKENS = 256  # patch embeddings ahead of the text in main's batch


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor     # (B, gen) sampled token ids; audio (B, gen, nq)
    prefill_s: float         # prefill, host clock ending in a device sync
    decode_s: float          # gen - 1 decode steps with their sampling
    logits: torch.Tensor     # (B, 1, V) the prefill's last-token logits;
                             # audio (B, 1, nq, V)


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) as
    ``jax.random.gumbel`` makes them, on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample(logits, temperature: float, noise):
    """Categorical draw by the Gumbel-max trick over the last axis (an
    audio model's (B, 1, nq, V) logits: one draw per codebook): what
    ``jax.random.categorical(key, logits / T)`` computes from the Gumbel
    draws of that key."""
    return torch.argmax(logits / max(temperature, 1e-4) + noise, dim=-1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Model, params, prompt, gen: int, *, temperature=1.0,
          gumbel: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None,
          device="cuda", rules=None) -> ServeResult:
    """Prefill ``prompt`` into a cache of capacity S + gen, then sample
    ``gen`` tokens, one decode step per token after the first.

    ``prompt`` is a (B, S) token tensor or the batch ``model.prefill``
    takes: {"embeds" (B, S_img, F), "tokens" (B, S - S_img)[, "positions"
    (B, S, 3)]} for the vision stub, {"codes" (B, S, nq)} for the audio
    codec. Decode is fed each sampled token as the JAX launcher feeds it:
    {"codes": (B, 1, nq)} for audio, else {"token": (B, 1)}.

    ``gumbel`` (gen, B, 1, V), audio (gen, B, 1, nq, V), is the sampling
    noise, step by step (the JAX launcher's draws from ``key`` for the
    first token, then from ``fold_in(key, i)``); without it the noise is
    drawn from ``generator`` (seeded 0 on the device when not given).

    Under ``rules`` (``params`` this rank's shards) the prompt and
    ``gumbel`` are whole and each rank serves its rows of the batch; the
    result holds this rank's rows."""
    dev = resolve_device(device)
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    rows = next(iter(batch.values())).shape[0]
    if rules is not None:
        batch = place_batch(batch, rules)
        if gumbel is not None:
            gumbel = sh.place_params(gumbel, (None, sh.BATCH) + (None,) * (
                gumbel.dim() - 2), rules)
    s = sum(batch[k].shape[1] for k in ("embeds", "tokens", "codes")
            if k in batch)
    feed = "codes" if model.cfg.frontend == "audio_codec" else "token"
    if gumbel is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def noise(i, shape):
        if gumbel is not None:
            return gumbel[i].to(dev)
        return gumbel_noise(generator, shape).to(dev)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=s + gen,
                                  use_flash=True, rules=rules,
                                  global_batch=rows)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    first_logits = logits
    tok = sample(logits, temperature, noise(0, logits.shape))
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode(params, cache, {feed: tok},
                                     rules=rules, global_batch=rows)
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
    with host_rules(device=dev) as rules:
        return _main(args, cfg, model, dev, rules)


def _main(args, cfg, model, dev, rules) -> ServeResult:
    generator = torch.Generator(device=dev).manual_seed(0)
    params = sh.place_params(model.init(generator, device=dev),
                             model.param_logical(), rules)
    b, s = args.batch, args.prompt_len
    if cfg.frontend == "audio_codec":
        prompt = {"codes": torch.randint(0, cfg.vocab_size,
                                         (b, s, cfg.n_codebooks),
                                         generator=generator, device=dev)}
    elif cfg.frontend == "vision_stub":
        n_img = min(VLM_IMG_TOKENS, s // 2)
        prompt = {
            "embeds": torch.randn((b, n_img, cfg.frontend_dim),
                                  generator=generator, device=dev
                                  ).to(torch.bfloat16),
            "tokens": torch.randint(0, cfg.vocab_size, (b, s - n_img),
                                    generator=generator, device=dev)}
    else:
        prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=generator,
                               device=dev)
    res = serve(model, params, prompt, args.gen,
                temperature=args.temperature, generator=generator, device=dev,
                rules=rules)
    print(f"prefill {b}x{s}: {res.prefill_s*1e3:.1f} ms "
          f"({b*s/res.prefill_s:.0f} tok/s)")
    steps = args.gen - 1
    print(f"decode {steps} steps x {b} seqs: {res.decode_s*1e3:.1f} ms "
          f"({steps * b / max(res.decode_s, 1e-9):.0f} tok/s)")
    print("sampled tokens[0][:16]:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
