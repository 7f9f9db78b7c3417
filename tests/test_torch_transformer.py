"""The port's dense transformer against the JAX package on the CPU, at the
smoke Llama's size (2 layers, d_model 256, vocab 512), with JAX's own
initial parameters carried across by ``convert.lm_params``.

Checked: spec trees and parameter counts for every ported config (the
recurrent families' too; their parity is in ``test_torch_xlstm.py``,
``test_torch_rglru.py`` and ``test_torch_recurrent_serve.py``); the
prefill's last logits and KV cache with the flash route on and off; 8
teacher-forced decode steps from JAX's own prefill cache (linear and ring
caches); and the port's prefill + decode against its own full forward.

Tolerances. float32 (``dtype="float32"``): 1e-5 (measured ~1e-6). The
config's bfloat16: logits 2e-2 for |logits| ~1 (measured 6e-3: bf16
products rounded at other places, e.g. inside the framework matmuls) and
K/V cache 2e-2 relative (two bf16 ulps). With the flash route, the JAX side
runs its Pallas kernel in interpret mode, which keeps p in f32 where the
port's host route (the plain version) rounds it to bf16; the same bounds
hold (measured 6.4e-3).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {"float32": dict(logits=1e-5, cache=1e-5),
       "bfloat16": dict(logits=2e-2, cache=2e-2)}
B, S, N_PRE, CAP = 2, 24, 16, 32


def _cfgs(dtype, **over):
    return (dataclasses.replace(jget_smoke("llama3.2-1b"), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype=dtype,
                                **over))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, S)).astype(np.int32)
    return dict(dtype=dtype, jm=jm, m=m, jp=jp, tokens=tokens,
                tp=convert.lm_params(jax.tree.map(np.asarray, jp)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_param_counts_match_jax(arch):
    jm, m = jbuild(jget_config(arch)), build_model(get_config(arch))
    jleaves = jax.tree.leaves(jm.specs, is_leaf=jcm.is_spec)
    leaves = cm.tree_leaves(m.specs)
    assert [(s.shape, s.init) for s in leaves] == \
        [(s.shape, s.init) for s in jleaves]
    assert m.n_params() == jm.n_params()
    assert [tuple(t.shape) for t in cm.tree_leaves(m.param_shapes())] == \
        [s.shape for s in jleaves]
    want = {"llama3.2-1b": 1_498_482_688, "xlstm-125m": 168_266_544,
            "recurrentgemma-2b": 3_549_934_080,
            "qwen2-moe-a2.7b": 14_315_587_584,
            "phi3.5-moe-42b-a6.6b": 41_872_527_360,
            "moonshot-v1-16b-a3b": 28_888_467_456,
            "qwen2-vl-72b": 72_715_870_208,
            "musicgen-medium": 1_837_254_144}
    if arch in want:
        assert m.n_params() == want[arch]


def test_init_draws_every_leaf_at_its_scale():
    cfg = get_smoke_config("llama3.2-1b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    unit = params["scan"][0]
    assert unit["wq"].shape == (2, 256, 256) and unit["wq"].dtype == torch.float32
    assert float(unit["ln1"].abs().max()) == 0.0
    assert abs(float(unit["wq"].std()) - 0.02) < 1e-3
    assert abs(float(unit["wo"].std()) - 0.02 / np.sqrt(4)) < 1e-3


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_logits_and_cache_match_jax(lm, use_flash, monkeypatch):
    if use_flash:   # JAX's flash route: its Pallas kernel in interpret mode
        monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jm, toks = lm["jm"], lm["tokens"]
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=CAP,
                                             use_flash=use_flash))(lm["jp"],
                                                                   toks)
    tl, tc = lm["m"].prefill(lm["tp"], {"tokens": _t(toks)}, max_len=CAP,
                             use_flash=use_flash)
    tol = TOL[lm["dtype"]]
    assert tl.shape == (B, 1, 512) and tl.dtype == torch.float32
    _close(tl, jl, tol["logits"])
    assert tc["pos"] == int(jc["pos"]) == S
    for name in ("k", "v"):
        assert tc["scan"][0][name].shape == jc["scan"][0][name].shape
        _close(tc["scan"][0][name], jc["scan"][0][name], tol["cache"])


@pytest.mark.parametrize("attention", ["causal", "sliding"])
def test_decode_from_jax_cache_matches_jax(lm, attention):
    """8 teacher-forced steps; "sliding" (window 12 < the 16-token prompt)
    exercises the rolled prefill cache and ring writes."""
    jm, m = lm["jm"], lm["m"]
    if attention == "sliding":
        jcfg, cfg = _cfgs(lm["dtype"], attention="sliding", window=12)
        jm, m = jbuild(jcfg), build_model(cfg)
    toks, tol = lm["tokens"], TOL[lm["dtype"]]
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=S))(
        lm["jp"], toks[:, :N_PRE])
    tl, tc = m.prefill(lm["tp"], {"tokens": _t(toks[:, :N_PRE])}, max_len=S)
    _close(tl, jl, tol["logits"])
    for name in ("k", "v"):
        _close(tc["scan"][0][name], jc["scan"][0][name], tol["cache"])
    cache = convert.lm_cache(jax.tree.map(np.asarray, jc))
    decode = jax.jit(lambda p, c, t: jm.decode(p, c, {"token": t}))
    for t in range(N_PRE, S):
        jl, jc = decode(lm["jp"], jc, toks[:, t:t + 1])
        tl, cache = m.decode(lm["tp"], cache, {"token": _t(toks[:, t:t + 1])})
        _close(tl, jl, tol["logits"])
    assert cache["pos"] == int(jc["pos"]) == S
    _close(cache["scan"][0]["k"], jc["scan"][0]["k"], tol["cache"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_plus_decode_matches_own_full_forward(lm, use_flash):
    """As the JAX package's tests/test_decode_parity.py: prefill(t[:16])
    then decode(t[16:]) reproduces the full-sequence forward's logits."""
    cfg, params = lm["m"].cfg, lm["tp"]
    toks = _t(lm["tokens"])
    x, positions, _ = tf.embed_inputs(params, {"tokens": toks}, cfg)
    x, _ = tf._run_stack(params, None, x, cfg, positions, mode="train")
    full = tf.logits_from_hidden(params, x, cfg)
    tol = TOL[lm["dtype"]]["logits"]
    logits, cache = lm["m"].prefill(params, {"tokens": toks[:, :N_PRE]},
                                    max_len=S, use_flash=use_flash)
    torch.testing.assert_close(logits[:, 0], full[:, N_PRE - 1], rtol=tol,
                               atol=tol)
    for t in range(N_PRE, S):
        logits, cache = lm["m"].decode(params, cache,
                                       {"token": toks[:, t:t + 1]})
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=tol,
                                   atol=tol)


def test_unported_families_raise_naming_the_roadmap():
    """``act_seq_shard`` without a mesh changes nothing (as the reference's
    constraint returns x outside a model axis); an audio-codec, a
    recurrent and an MoE prefill on a model axis above one rank are
    counted (no family is left unported there); MoE, the recurrent
    kinds
    (rglru, mlstm, slstm), the vision stub with M-RoPE and the audio codec
    build, MoE and the frontends with JAX's parameter counts."""
    moe = dataclasses.replace(get_smoke_config("llama3.2-1b"), n_experts=4,
                              experts_per_token=2, moe_d_ff=256)
    jmoe = dataclasses.replace(jget_smoke("llama3.2-1b"), n_experts=4,
                               experts_per_token=2, moe_d_ff=256)
    m, jm = build_model(moe), jbuild(jmoe)
    assert "moe" in m.specs["scan"][0] and "mlp" not in m.specs["scan"][0]
    assert m.n_params() == jm.n_params()
    assert m.n_active_params() == jm.n_active_params() < m.n_params()
    for kind in ("rglru", "mlstm", "slstm"):
        cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                  block_pattern=(kind,))
        assert build_model(cfg).n_params() > 0
    over = {"vision_stub": dict(frontend="vision_stub", frontend_dim=128,
                                mrope_sections=(8, 12, 12)),
            "audio_codec": dict(frontend="audio_codec", n_codebooks=2)}
    for kw in over.values():
        m = build_model(dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                            **kw))
        jm = jbuild(dataclasses.replace(jget_smoke("llama3.2-1b"), **kw))
        assert m.n_params() == jm.n_params()
    assert "proj" in build_model(dataclasses.replace(
        get_smoke_config("llama3.2-1b"), **over["vision_stub"])).specs["embed"]
    q = torch.randn(1, 5, 4, 64)
    pos3 = torch.arange(5)[None, :, None].expand(1, 5, 3)
    mrope = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                mrope_sections=(8, 12, 12))
    rq, rk = tf._apply_rope(q, q, pos3, mrope)
    assert rq.shape == q.shape and torch.equal(rq, rk)
    assert get_config("qwen2-vl-72b").mrope_sections == (16, 24, 24)
    assert get_config("musicgen-medium").n_codebooks == 4
    seq = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              act_seq_shard=True)
    sm = build_model(seq)
    params = sm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    plain = build_model(get_smoke_config("llama3.2-1b"))
    assert torch.equal(sm.prefill(params, toks)[0],
                       plain.prefill(params, toks)[0])
    from repro_torch import sharding as sh
    pod = sh.ShardingRules.default(sh.CountingMesh({"data": 16,
                                                    "model": 16}))
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long, device="meta")}
    am = build_model(get_smoke_config("musicgen-medium"))
    # 16 positions: the 2 KV heads lie over the cache's slots, 1 a rank
    codes = {"codes": torch.zeros((1, 16, am.cfg.n_codebooks),
                                  dtype=torch.long, device="meta")}
    # the codebooks' logits: the head gathered over "model" and cut to the
    # rank's columns of each codebook, then all-gathered along V
    apod = sh.ShardingRules.default(sh.CountingMesh({"data": 16,
                                                     "model": 16}))
    alogits, _ = am.prefill(am.param_shapes(apod), codes, rules=apod,
                            global_batch=1)
    assert tuple(alogits.shape) == (1, 1, am.cfg.n_codebooks,
                                    am.cfg.vocab_size)
    assert apod.mesh.calls[("all-gather", ("model",))] == \
        am.cfg.n_layers + 2
    # the smoke recurrentgemma's two RG-LRU blocks: each reduce-scatters
    # its gates' sums over "model"
    rpod = sh.ShardingRules.default(sh.CountingMesh({"data": 16,
                                                     "model": 16}))
    rm = build_model(get_smoke_config("recurrentgemma-2b"))
    logits, _ = rm.prefill(rm.param_shapes(rpod), toks, rules=rpod,
                           global_batch=1)
    assert tuple(logits.shape) == (1, 1, rm.cfg.vocab_size)
    assert rpod.mesh.calls[("reduce-scatter", ("model",))] == 2
    # 16 heads: one a rank of the model axis
    mm = build_model(dataclasses.replace(moe, n_heads=16, n_kv_heads=16))
    logits, _ = mm.prefill(mm.param_shapes(pod), toks, rules=pod,
                           global_batch=1)
    assert tuple(logits.shape) == (1, 1, moe.vocab_size)
    assert pod.mesh.calls[("all-reduce", ("model",))] == 2 * moe.n_layers + 1


def test_plane_above_one_data_rank_requires_global_batch():
    """Above one data rank a rank's rows do not say whether the batch is
    split over the data axes or replicated there, so an entry point
    without ``global_batch`` raises instead of guessing (a replicated
    batch taken as split misroutes the MoE's gather dispatch); with it,
    and on one data rank without it, the step runs."""
    from repro_torch import sharding as sh
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    m = build_model(cfg)
    toks = {"tokens": torch.zeros((1, 16), dtype=torch.long, device="meta")}
    for data, model in ((2, 1), (16, 16)):
        rules = sh.ShardingRules.default(sh.CountingMesh(
            {"data": data, "model": model}))
        params = m.param_shapes(rules)
        with pytest.raises(ValueError, match="global_batch"):
            m.prefill(params, toks, rules=rules)
        with pytest.raises(ValueError, match="global_batch"):
            m.loss_fn(params, dict(toks, labels=toks["tokens"]), rules=rules)
        logits, _ = m.prefill(params, toks, rules=rules, global_batch=1)
        assert tuple(logits.shape) == (1, 1, cfg.vocab_size)
    one = sh.ShardingRules.default(sh.CountingMesh({"data": 1, "model": 2}))
    logits, _ = m.prefill(m.param_shapes(one), toks, rules=one)
    assert tuple(logits.shape) == (1, 1, cfg.vocab_size)


def test_tree_helpers_walk_tuples_in_jax_order():
    tree = {"b": (np.arange(2), {"z": np.arange(3), "a": np.arange(4)}),
            "a": np.arange(5), "n": None, "e": ()}
    want = jax.tree.leaves(tree)
    got = cm.tree_leaves(tree)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    back = cm.tree_unflatten(tree, [g * 2 for g in got])
    assert back["b"][1]["a"].tolist() == [0, 2, 4, 6] and back["n"] is None
    assert cm.tree_map(lambda a: a + 1, tree)["b"][0].tolist() == [1, 2]
    jcache = jax.jit(lambda: jtf.init_cache(jget_smoke("llama3.2-1b"), 1, 8))()
    cache = convert.lm_cache(jax.tree.map(np.asarray, jcache))
    assert cache["pos"] == 0 and cache["scan"][0]["k"].dtype == torch.bfloat16
    assert tuple(cache["scan"][0]["k"].shape) == (2, 1, 8, 2, 64)
    assert cache["tail"] == ()
