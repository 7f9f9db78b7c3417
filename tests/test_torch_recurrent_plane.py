"""The recurrent families on the model plane (the RG-LRU, mLSTM and sLSTM
blocks of ``repro_torch.models`` under ``rules=``) against the unsharded
port and the reference.

* Gloo ranks (``meshlab.spawn``, one spawn of world 4): the float32 smoke
  recurrentgemma at 3 layers (one rglru, rglru, local_attn unit: 2 query
  heads, 1 KV head, a 64-token local window) and the smoke xlstm (an
  mLSTM and an sLSTM block), each also under ``act_seq_shard``
  (``meshlab.RECURRENT``), at meshes (1, 1), (2, 2) and (1, 4); a
  72-token prompt (past the window: the local attention's ring wraps in
  the prefill and again while decoding; a ragged mLSTM chunk), 4 sampled
  tokens (3 decode steps) and 2 donated AdamW steps. Logits, tokens,
  losses and every leaf's first-step gradient equal ``rules=None``'s bit
  for bit at (1, 1) and within 1e-5 elsewhere; the parameters after the
  AdamW steps within 1e-5 wherever the first gradient exceeds
  ``meshlab.GRAD_FLOOR``. (1, 4) puts 2 query heads on 4 ranks (two ranks
  hold none) and the sLSTM's 2 heads whole on every rank. Each step's
  collectives equal the recurrent table in ``repro_torch.sharding``'s
  docstring.
* The (2, 2) prefill logits and loss from JAX's parameters (through
  ``convert.lm_params``) equal JAX's unsharded ``model.prefill`` and
  ``loss_fn`` within 1e-5, for both families.
* The dry run's counted collective bytes at a shape-only (2, 2) mesh equal
  the gloo (2, 2) run's; one rank of the 16 x 16 production mesh counts
  both families' decode steps.
* In the same spawn, two widths that 4 does not divide on mesh (1, 4),
  each within 1e-5 of ``rules=None`` and with the collectives of
  ``test_torch_uneven_plane.uneven_counts``: the smoke Llama served from
  a 61-token prompt into a 65-slot cache (whole on every rank) and
  trained, and recurrentgemma at 3 layers with 250 RG-LRU channels (the
  blocks whole on every rank, the local window's 64 slots over them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import registry as jreg
from repro_torch import meshlab
from repro_torch import sharding as sh
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_lib
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_uneven_plane import uneven_counts

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
MESHES = ((1, 1), (2, 2), (1, 4))
CFGS = meshlab.plane_configs()
FAMILIES = ("recurrentgemma", "xlstm")
# the widths 4 does not divide: a 65-slot cache, 250 RG-LRU channels
UNEVEN = ((1, 4), ("base", "recurrentgemma_250"), meshlab.UNEVEN_S)
ARCH = {"recurrentgemma": "recurrentgemma-2b", "xlstm": "xlstm-125m"}


def _jax_setup():
    """Per family, JAX's parameters (numpy) of its lab config, and JAX's
    prefill logits and loss on the lab's prompt."""
    params, ref = {}, {}
    for name in FAMILIES:
        cfg = CFGS[name]
        jcfg = dataclasses.replace(jget_smoke(ARCH[name]), dtype="float32",
                                   n_layers=cfg.n_layers)
        assert (jcfg.d_model, jcfg.block_pattern) == (cfg.d_model,
                                                      cfg.block_pattern)
        jm = jreg.build_model(jcfg)
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(3))
        _, toks, _ = meshlab.plane_inputs(cfg)
        toks = jnp.asarray(toks.numpy())
        logits, _ = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(
            jparams, toks)
        loss, _ = jax.jit(lambda p, t: jm.loss_fn(
            p, {"tokens": t, "labels": t}))(jparams, toks)
        params[name] = jax.tree.map(np.asarray, jparams)
        ref[name] = (np.asarray(logits), float(loss))
    return params, ref


@pytest.fixture(scope="module")
def world():
    jparams, ref = _jax_setup()
    out = meshlab.spawn(meshlab.plane_world, 4, MESHES, jparams, None,
                        meshlab.RECURRENT, None, None, UNEVEN)
    out["reports"] = {tuple(r["mesh"]): r for r in out["plane"]}
    out["jax"] = ref
    return out


def test_the_plane_takes_both_families():
    """The plane runs every config of the package, both recurrent ones
    among them: each builds a prefill plan for one rank of 16 x 16 from
    the dry run's batch (a vision batch's S the patches and the text
    together)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import specs as sp
    shape = INPUT_SHAPES["prefill_32k"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert tf.plane_supported(cfg), arch
        rules = dr.mesh_rules("pod16x16")
        plan = tf._plan(cfg, rules, "prefill",
                        sp.input_specs(cfg, shape, rules),
                        shape.global_batch)
        assert plan.plane.m == 16 and plan.vocab == sh.split_range(
            cfg.vocab_size, 16, 0), arch


def test_one_rank_cache_equals_the_unsharded_cache():
    """A cache made under one rank's rules holds what ``init_cache`` makes
    without them, the xLSTM stabilisers' -1e9 included (a prefill starts
    from it)."""
    from repro_torch.launch.mesh import host_rules
    from repro_torch.models import common as cm
    with host_rules(device="cpu") as rules:
        for name in FAMILIES:
            cfg = CFGS[name]
            whole = tf.init_cache(cfg, 2, 80, torch.float32)
            local = tf.init_cache(cfg, 2, 80, torch.float32, rules=rules)
            pairs = zip(cm.tree_leaves((whole["scan"], whole["tail"])),
                        cm.tree_leaves((local["scan"], local["tail"])))
            assert all(torch.equal(a, b) for a, b in pairs), name


@pytest.mark.parametrize("name", FAMILIES)
def test_one_rank_mesh_is_bit_identical(name, world):
    rep = world["reports"][(1, 1)]
    assert rep[f"{name}_logits_bitwise"] and rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_train_bitwise"]
    assert rep[f"{name}_grad_diff"] == 0.0
    assert rep[f"{name}_serve_counts"] == {"prefill": ({}, {}),
                                           "decode": ({}, {})}


@pytest.mark.parametrize("name", meshlab.RECURRENT)
@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_matches_unsharded(mesh, name, world):
    rep = world["reports"][mesh]
    assert rep[f"{name}_logits"] <= TOL
    assert rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_loss_diff"] <= TOL
    assert rep[f"{name}_param_diff_above_floor"] <= TOL
    diffs = rep[f"{name}_grad_diffs"]
    family = name.removesuffix("_seq")
    leaves = {"recurrentgemma": {"scan/0/w_a", "scan/0/b_i", "scan/1/lam",
                                 "scan/2/wk", "scan/2/mlp/wo"},
              "xlstm": {"scan/0/w_up", "scan/0/gn", "scan/0/w_if",
                        "scan/1/r_gates", "scan/1/b_gates",
                        "scan/1/ffn_down"}}[family]
    assert leaves <= set(diffs)
    assert max(diffs.values()) <= TOL, diffs


def test_each_path_is_taken(world):
    """(1, 4): recurrentgemma's 2 query heads split 0, 1, 0, 1 over the
    model ranks, its 1 KV head whole on each and the cache over its slots;
    the 72-token prompt wraps the 64-slot ring. The sLSTM's 2 heads of
    ``r_gates`` are stored split at model 2 and whole at model 4."""
    paths = world["reports"][(1, 4)]["paths"]
    assert paths == {"kv_seq": True, "ring": True, "heads": [0, 0, 1, 1],
                     "slstm_heads_split": False}
    paths = world["reports"][(2, 2)]["paths"]
    assert paths["heads"] == [1, 1, 1, 1] and paths["slstm_heads_split"]


# the table's terms: (axes, kind) of each collective; "D" the data axes,
# "M" the model axis, "DM" both
def _enter(seq):
    return ([("M", "all-gather")] if seq else []), \
        [("M", "reduce-scatter" if seq else "all-reduce")]


def _exit(seq):
    return [("M", "reduce-scatter" if seq else "all-reduce")], \
        ([("M", "all-gather")] if seq else [])


def _block(kind, cfg, m, seq, decode):
    """(forward, backward) collectives of one block, as the recurrent
    table in ``repro_torch.sharding`` lists them."""
    (ef, eb), (xf, xb) = _enter(seq), _exit(seq)
    fwd, bwd = [("D", "all-gather")], [("D", "reduce-scatter")]
    if kind == "rglru":
        fwd += ef + [("M", "reduce-scatter")] + xf + ef + xf
        bwd += [("M", "all-gather"), ("M", "all-reduce")] + 2 * (eb + xb)
    elif kind == "mlstm":
        di = xlstm_lib._round64(cfg.xlstm_proj_factor * cfg.d_model)
        gg = int(di % m == 0)
        fwd += ef + [("M", "all-gather")] * (1 + gg) + \
            [("M", "all-reduce")] + xf
        bwd += eb + [("M", "reduce-scatter"), ("M", "all-gather")] + xb
    elif kind == "slstm":
        rgh = int(cfg.n_heads % m == 0)
        fwd += ef + [("M", "all-gather")] * (2 + rgh) + ef + xf
        bwd += 2 * eb + xb + ([("M", "all-gather")] if seq else [])
    else:  # local_attn, one KV head: its columns gathered above one rank
        kvg = int(cfg.n_kv_heads % m != 0)
        fwd += ef + [("M", "all-gather")] * kvg + xf + ef + xf
        if decode:
            fwd += [("M", "all-gather")] * kvg + [("M", "all-reduce")] * \
                (3 * kvg)
        bwd += 2 * (eb + xb) + [("M", "reduce-scatter")] * kvg
    return fwd, bwd


def expected_counts(step: str, cfg, mesh) -> dict:
    """{kind: calls} of one step of ``cfg`` (whole units, no tail) on a
    (data, model) ``mesh``, whose one-rank axes run nothing."""
    data, m = mesh
    seq = cfg.act_seq_shard and m > 1 and step != "decode"
    (ef, eb), (xf, xb) = _enter(seq), _exit(seq)
    period, n_units, tail = tf.scan_meta(cfg)
    calls = []
    for i, kind in enumerate(cfg.layer_kinds):
        fwd, bwd = _block(kind, cfg, m, seq, step == "decode")
        calls += fwd
        if step == "train":
            # block remat recomputes a unit's forward but its last exit
            again = fwd[:-1] if i % period == period - 1 else fwd
            calls += bwd + (again if i < n_units * period else [])
    # the step: the embedding (a row-parallel sum), the final norm and head
    calls += [("D", "all-gather")] * 2 + xf + ef
    if step != "train":
        calls += [("M", "all-gather")]            # the logits
    else:
        calls += [("D", "reduce-scatter")] * 2 + xb + eb
        calls += [("M", "all-reduce")] * (2 + seq) + [("D", "all-reduce")] * 2
        calls += [("DM", "all-reduce")]
    size = {"D": data, "M": m, "DM": data * m}
    out = {}
    for axes, kind in calls:
        if size[axes] > 1:
            out[kind] = out.get(kind, 0) + 1
    return out


@pytest.mark.parametrize("name", meshlab.RECURRENT)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_equal_the_docstring_table(mesh, name, world):
    rep = world["reports"][mesh]
    cfg = CFGS[name]
    if cfg.act_seq_shard and mesh[1] == 1:
        assert f"{name}_serve_counts" not in rep
        return
    serve = rep[f"{name}_serve_counts"]
    for step in ("prefill", "decode"):
        assert serve[step][0] == expected_counts(step, cfg, mesh), step
    assert rep[f"{name}_train_counts"]["train"][0] == expected_counts(
        "train", cfg, mesh)


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_prefill_and_loss_at_2x2(name, world):
    rep = world["reports"][(2, 2)]
    logits, loss = world["jax"][name]
    np.testing.assert_allclose(rep[f"{name}_jax_prefill_logits"], logits,
                               rtol=0, atol=TOL)
    assert abs(rep[f"{name}_jax_loss"] - loss) <= TOL


@pytest.mark.parametrize("name", FAMILIES)
def test_counted_bytes_equal_the_gloo_run(name, world):
    """The dry run's count of each step at a ``CountingMesh`` (data 2,
    model 2) equals, kind by kind, the calls and bytes of the gloo (2, 2)
    ranks (the sLSTM's train and prefill counted at 2 and 3 steps and
    multiplied out)."""
    rep = world["reports"][(2, 2)]
    cfg = CFGS[name]
    b, s = meshlab.PLANE_B, meshlab.RECURRENT_S
    cap = s + meshlab.PLANE_GEN
    runs = {"prefill": (InputShape("plane", s, b, "prefill"), cap),
            "decode": (InputShape("plane", cap, b, "decode"), None),
            "train": (InputShape("plane", s, b, "train"), None)}
    real = dict(rep[f"{name}_serve_counts"], **rep[f"{name}_train_counts"])
    for step, (shape, max_len) in runs.items():
        rules = sh.ShardingRules.default(sh.CountingMesh({"data": 2,
                                                          "model": 2}))
        rec = dr.count_step(cfg, shape, max_len=max_len, rules=rules)
        counted = {k: v for k, v in rec["collectives"].items() if v}
        assert counted == real[step][1], step
        calls = {}
        for row in rec["collective_calls"]:
            calls[row["kind"]] = calls.get(row["kind"], 0) + row["calls"]
        assert calls == real[step][0], step


@pytest.mark.parametrize("arch", ARCH.values())
def test_production_mesh_counts_recurrent_decode(arch):
    """One rank of 16 x 16 decoding 32,768 tokens: recurrentgemma's 10
    query heads split 1 or 0 a rank, its KV head whole (the local window's
    2,048 slots over the 16 ranks), 8 local-attention layers of 26; the
    recurrent blocks' state on the rank's channels (RG-LRU) or whole
    (xLSTM)."""
    cfg = get_config(arch)
    rules = dr.mesh_rules("pod16x16")
    rec = dr.count_step(cfg, INPUT_SHAPES["decode_32k"], rules=rules)
    calls = {(r["kind"], tuple(r["axes"])): r["calls"]
             for r in rec["collective_calls"]}
    assert calls[("all-gather", ("data",))] == cfg.n_layers + 2
    kinds = cfg.layer_kinds
    if arch == "recurrentgemma-2b":
        n_attn = kinds.count("local_attn")
        assert n_attn == 8
        assert calls[("reduce-scatter", ("model",))] == kinds.count("rglru")
        assert calls[("all-gather", ("model",))] == 2 * n_attn + 1
        k = rec["memory"]["cache_size_in_bytes"]
        assert k > 0
    else:
        # mLSTM: w_up and gn; sLSTM: W x, b_gates (4 heads do not divide
        # 16: r_gates whole); the logits
        assert calls[("all-gather", ("model",))] == \
            2 * kinds.count("mlstm") + 2 * kinds.count("slstm") + 1


@pytest.mark.parametrize("name", UNEVEN[1])
def test_widths_four_ranks_do_not_divide(name, world):
    rep = world["uneven"]
    assert rep[f"{name}_logits"] <= TOL and rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_loss_diff"] <= TOL
    assert rep[f"{name}_param_diff_above_floor"] <= TOL
    assert max(rep[f"{name}_grad_diffs"].values()) <= TOL
    assert rep[f"{name}_paths"] == {
        "base": {"whole": [], "cache": "whole"},
        "recurrentgemma_250": {"whole": ["rglru"], "cache": "slots"}}[name]
    cfg = meshlab.plane_configs()[name]
    counts = dict(rep[f"{name}_serve_counts"], **rep[f"{name}_train_counts"])
    for step, (calls, _) in counts.items():
        assert calls == uneven_counts(step, cfg, 4, UNEVEN[2]), step
