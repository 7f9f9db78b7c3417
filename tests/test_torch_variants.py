"""The bf16 parameter and logits variants (``launch.perf``'s
``bf16_params``, ``bf16_logits`` and ``bf16_all``) against the JAX package
on the CPU: the smoke Llama and the smoke qwen2-moe (einsum dispatch, every
router call's top-k margin above 1e-5) in float32 activations, from JAX's
own initial parameters (under ``param_dtype="bfloat16"`` JAX's float32 draw
rounded to bf16, as its init rounds it): a prefill of 16 tokens, 2
teacher-forced decode steps from JAX's cache, and three AdamW steps (the
AdamW moments are bf16 too under ``bf16_params``: both packages'
``init_opt_state`` zeros them like the parameters).

Tolerances, in bf16 ulps (ulp(x) = 2^(floor(log2 |x|) - 7)):
  * bf16 logits (``bf16_logits``, ``bf16_all``): 1 ulp of the largest
    |logit| (measured 0.5-1). Both frameworks round float32 product sums to
    bf16, and the sums differ in their last bits.
  * float32 logits (``bf16_params``): 1e-5 absolute, the float32 bound of
    ``test_torch_transformer.py``, under 1/256 of a bf16 ulp at |logits|
    ~1 (measured 8.4e-7).
  * Three AdamW steps: each step's loss and grad norm within 2^-13
    relative, 1/32 of a bf16 ulp (measured 8.2e-5); every parameter leaf
    within 6 lr (3e-4) of JAX's, plus one ulp of the leaf's largest |value|
    when it is bf16 (measured 1.0e-3 for Llama's float32 parameters under
    ``bf16_logits``, 2.5e-4 in bf16). AdamW's first steps move an entry by
    about lr whatever its gradient's size, so an entry whose gradient sits
    at rounding level can move up to 2 lr apart a step
    (``test_torch_train.py``); bf16 logits put more gradients there.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import perf as jperf
from repro.models.registry import build_model as jbuild
from repro.models.registry import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import perf
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model, make_train_step
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_moe import margins, _assert_seen_margins  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, N_PRE, S = 2, 16, 18
VARIANTS = ("bf16_params", "bf16_logits", "bf16_all")


def bf16_ulp(want) -> float:
    """One bf16 ulp at the largest |value| of ``want``."""
    mag = float(np.abs(np.asarray(want, np.float32)).max())
    return float(np.exp2(np.floor(np.log2(max(mag, 1e-30))) - 7))


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy().astype(np.float64)
                        - np.asarray(want, np.float32)).max())


def _close_logits(got, want, cfg):
    if cfg.logits_dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        assert _err(got, want) <= bf16_ulp(want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2-moe-a2.7b"])
def base(request):
    """JAX's float32 initial parameters of the smoke config and a token
    batch."""
    jcfg = dataclasses.replace(jget_smoke(request.param), dtype="float32")
    jp = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (B, S)).astype(np.int32)
    return dict(arch=request.param, jp=jp, tokens=tokens)


def _variant(base, variant):
    arch = base["arch"]
    jcfg = jperf.VARIANTS[variant](dataclasses.replace(jget_smoke(arch),
                                                       dtype="float32"))
    cfg = perf.VARIANTS[variant](dataclasses.replace(get_smoke_config(arch),
                                                     dtype="float32"))
    jp = jax.tree.map(lambda a: a.astype(jcfg.param_dtype), base["jp"])
    return dict(cfg=cfg, jm=jbuild(jcfg), m=build_model(cfg), jp=jp,
                tokens=base["tokens"],
                tp=convert.lm_params(jax.tree.map(np.asarray, jp)))


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_jax(base, variant, margins):  # noqa: F811
    lm = _variant(base, variant)
    jm, m, cfg, toks = lm["jm"], lm["m"], lm["cfg"], lm["tokens"]
    assert all(p.dtype == cfg.p_dtype for p in cm.tree_leaves(lm["tp"]))
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=S))(
        lm["jp"], toks[:, :N_PRE])
    logits, _ = m.prefill(lm["tp"], {"tokens": _t(toks[:, :N_PRE])},
                          max_len=S, use_flash=True)
    _close_logits(logits, jl, cfg)
    cache = convert.lm_cache(jax.tree.map(np.asarray, jc))
    jdecode = jax.jit(lambda p, c, t: jm.decode(p, c, {"token": t}))
    for t in range(N_PRE, S):
        jl, jc = jdecode(lm["jp"], jc, toks[:, t:t + 1])
        logits, cache = m.decode(lm["tp"], cache,
                                 {"token": _t(toks[:, t:t + 1])})
        _close_logits(logits, jl, cfg)
    if cfg.is_moe:
        _assert_seen_margins(margins, cfg.experts_per_token)


@pytest.mark.parametrize("variant", VARIANTS)
def test_three_adamw_steps_match_jax(base, variant, margins):  # noqa: F811
    lm = _variant(base, variant)
    jm, m, cfg, toks = lm["jm"], lm["m"], lm["cfg"], lm["tokens"]
    tc = dict(optimizer="adamw", learning_rate=3e-4, total_steps=10,
              warmup_steps=2)
    jstep = jax.jit(jmake_train_step(jm, JTrainConfig(**tc)))
    step = make_train_step(m, TrainConfig(**tc))
    jp, js = lm["jp"], joptim.init_opt_state(lm["jp"], "adamw")
    tp = lm["tp"]
    ts = convert.opt_state(jax.tree.map(np.asarray, js))
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jp, js, jmet = jstep(jp, js, {"tokens": b, "labels": b})
        tp, ts, met = step(tp, ts, {"tokens": _t(b), "labels": _t(b)})
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=2.0 ** -13)
    if cfg.is_moe:
        _assert_seen_margins(margins, cfg.experts_per_token)
    bf16 = cfg.param_dtype == "bfloat16"
    for got, want in zip(cm.tree_leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == cfg.p_dtype
        assert _err(got, want) <= 6 * 3e-4 + (bf16_ulp(want) if bf16
                                              else 0.0)
    for got in cm.tree_leaves((ts.mu, ts.nu)):
        assert got.dtype == cfg.p_dtype
