"""The model plane on a model axis that divides none of a config's widths
(``repro_torch.models.transformer`` under ``rules=``) against the
unsharded port and the reference.

* Gloo ranks (``meshlab.spawn``, one spawn of world 3): every family's
  float32 smoke config of ``meshlab.plane_configs`` (``meshlab.UNEVEN``:
  the dense Llama, its sliding-window and ``act_seq_shard`` variants, the
  three qwen2-moe configs, recurrentgemma at 3 layers and xlstm, qwen2-vl
  and musicgen, each recurrent and frontend one also under
  ``act_seq_shard``) on mesh (1, 3). 3 divides none of their KV heads,
  cache slots (a 61-token prompt and 4 sampled tokens: 65 slots, the local
  window's 64), RG-LRU channels, mLSTM inner width or sLSTM gate columns,
  so each cache lies whole on every rank and each recurrent block runs
  whole there. The ``act_seq_shard`` configs take 60 tokens, which 3
  divides, so the flag takes effect. Logits, tokens, losses and every
  leaf's first-step gradient within 1e-5 of ``rules=None``; the
  parameters after 2 AdamW steps within 1e-5 wherever the first gradient
  exceeds ``meshlab.GRAD_FLOOR``. Each step's collectives equal the rows
  for a model axis that does not divide a width in
  ``repro_torch.sharding``'s docstring (``uneven_counts``).
* xlstm's prefill logits and loss from JAX's parameters (through
  ``convert.lm_params``) at (1, 3) equal JAX's unsharded ``model.prefill``
  and ``loss_fn`` within 1e-5.
* In the same spawn, a (3, 1) mesh (``meshlab.moe_segments_report``): the
  smoke qwen2-moe in groups of 24 tokens over 3 data ranks of 16 tokens
  each, with both dispatches; a rank routes segments of 8 tokens, a
  group's across two ranks, and drops choices for the lower rank's. The
  reference runs this shape (its groups tile the batch's 48 tokens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.models import registry as jreg
from repro_torch import meshlab
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_lib
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
MESH = (1, 3)
CFGS = meshlab.plane_configs()
S = meshlab.UNEVEN_S


def prompt_len(cfg, m: int) -> int:
    """The prompt ``plane_mesh_report`` gives ``cfg`` at model ``m``."""
    return S - S % m if cfg.act_seq_shard else S


def _jax_setup():
    """JAX's parameters (numpy) of the smoke xlstm, and JAX's prefill
    logits and loss on its 61-token prompt."""
    cfg = CFGS["xlstm"]
    jcfg = dataclasses.replace(jget_smoke("xlstm-125m"), dtype="float32")
    jm = jreg.build_model(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(3))
    _, toks, _ = meshlab.plane_inputs(cfg, s=S)
    toks = jnp.asarray(toks.numpy())
    logits, _ = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(
        jparams, toks)
    loss, _ = jax.jit(lambda p, t: jm.loss_fn(
        p, {"tokens": t, "labels": t}))(jparams, toks)
    return ({"xlstm": jax.tree.map(np.asarray, jparams)},
            (np.asarray(logits), float(loss)))


@pytest.fixture(scope="module")
def world():
    jparams, ref = _jax_setup()
    out = meshlab.spawn(meshlab.plane_world, 3, (MESH,), jparams, None,
                        meshlab.UNEVEN, None, S, None, True)
    out["report"] = out["plane"][0]
    out["jax"] = ref
    return out


@pytest.mark.parametrize("name", meshlab.UNEVEN)
def test_mesh_matches_unsharded(name, world):
    rep = world["report"]
    assert rep[f"{name}_logits"] <= TOL
    assert rep[f"{name}_tokens_equal"]
    if name == "sliding":       # serves only
        return
    assert rep[f"{name}_loss_diff"] <= TOL
    assert rep[f"{name}_param_diff_above_floor"] <= TOL
    diffs = rep[f"{name}_grad_diffs"]
    assert len(diffs) == len(cm.tree_leaves(tf.model_specs(CFGS[name])))
    assert max(diffs.values()) <= TOL, diffs


def test_each_whole_path_is_taken(world):
    """Every attention config's cache lies whole on the 3 ranks; the
    RG-LRU, mLSTM and sLSTM run whole (the sLSTM's 2 heads of ``r_gates``
    stored whole too)."""
    rep = world["report"]
    for name in meshlab.UNEVEN:
        cfg = CFGS[name]
        paths = rep[f"{name}_paths"]
        attn = {"attn", "local_attn"} & set(cfg.layer_kinds)
        assert paths["cache"] == ("whole" if attn else None), name
        want = {"recurrentgemma": ["rglru"],
                "xlstm": ["mlstm", "slstm"]}.get(name.removesuffix("_seq"),
                                                 [])
        assert paths["whole"] == want, name


def test_router_margins_exceed_the_float_noise(world):
    """Top-k and capacity are discontinuous: the smallest router margin of
    each MoE config's ``rules=None`` runs stays above 1e-6, some 10x the
    router input's float32 differences between the meshes (the router
    reads rows summed in another order), so every top-k set is fixed."""
    rep = world["report"]
    for name in meshlab.MOE:
        assert rep[f"{name}_margin"] > 1e-6, name


# -- the docstring rows: {kind: calls} of one step on a (1, m) mesh --------

def _pair(seq):
    """((enter forward, enter backward), (exit forward, exit backward)) of
    a column/row-parallel pair."""
    return ((["AG"] if seq else [], ["RS"] if seq else ["AR"]),
            (["RS"] if seq else ["AR"], ["AG"] if seq else []))


def _block(kind, cfg, m, seq, step, cap):
    """(forward, backward) collectives over "model" of one block."""
    (ef, eb), (xf, xb) = _pair(seq)
    # a whole block: its input replicated along S, its output split
    wf, wb = (["AG"], ["AG"]) if seq else ([], [])
    d, hd = cfg.d_model, cfg.head_dim

    def div(w):
        return w % m == 0
    if kind in ("attn", "local_attn"):
        kv_seq = not div(cfg.n_kv_heads)
        kvg = kv_seq and div(cfg.n_kv_heads * hd)
        # the widths whose weights a rank cuts (copied where stored whole)
        cut = [cfg.n_heads * hd] + ([cfg.n_kv_heads * hd] if kv_seq else [])
        fwd, bwd = ef + ["AG"] * kvg + xf, eb + ["RS"] * kvg + xb
        if step == "decode" and kv_seq and \
                div(tf.attn_cache_len(cfg, kind, cap)):
            fwd += ["AG"] + ["AR"] * 3        # the KV_SEQ combine (kvs)
        if cfg.is_moe:
            f = cfg.moe_d_ff or cfg.d_ff
            ep = div(cfg.n_experts)
            cut += [cfg.n_shared_experts * f] + ([] if ep else [f])
            fwd += ["AG"] * ep + ["AG"] * seq + xf
            bwd += ["AR", "AR"] + xb          # the input's and gates' copy
        else:
            cut.append(cfg.d_ff)
            fwd += ef + xf
            bwd += eb + xb
        return fwd, bwd + ["AR"] * (not all(div(w) for w in cut))
    if kind == "rglru":
        if not div(cfg.rglru_d_rnn):
            return wf + ef + xf, wb + eb + xb + ["AR"] * (not div(cfg.d_ff))
        return ef + ["RS"] + xf + ef + xf, ["AG", "AR"] + 2 * (eb + xb)
    if kind == "mlstm":
        di = xlstm_lib._round64(cfg.xlstm_proj_factor * d)
        if not div(di):
            return wf + ["AG"] * div(2 * di), wb
        return (ef + ["AG"] * 2 + ["AR"] + xf,
                eb + ["RS", "AG"] + xb)
    rgh = div(cfg.n_heads)                    # slstm
    fu = xlstm_lib._round64(4 * d / 3)
    if not div(4 * d):
        return (wf + ["AG"] * rgh + ef + xf,
                wb + eb + xb + ["AR"] * (not div(fu)))
    return (ef + ["AG"] * (2 + rgh) + ef + xf,
            2 * eb + xb + (["AG"] if seq else []))


KINDS = {"AG": "all-gather", "RS": "reduce-scatter", "AR": "all-reduce"}


def uneven_counts(step: str, cfg, m: int, s: int) -> dict:
    """{kind: calls} of one step of ``cfg`` with ``s``-position prompts
    (and 4 decode positions) on a (1, ``m``) mesh, by the docstring's
    rows: each block's terms, a unit's forward recomputed under remat but
    its closing exit, the embedding's sum and the head's pair, the loss's
    two all-reduces, the norm scales' under seq and the global norm's;
    the embedding's and the head's copies where m does not divide the
    vocab (the vision projector's joins the embedding's under seq)."""
    if m == 1:
        return {}
    seq = cfg.act_seq_shard and step != "decode" and s % m == 0
    (ef, eb), (xf, xb) = _pair(seq)
    period, n_units, _ = tf.scan_meta(cfg)
    calls = []
    for i, kind in enumerate(cfg.layer_kinds):
        fwd, bwd = _block(kind, cfg, m, seq, step, s + meshlab.PLANE_GEN)
        calls += fwd
        if step == "train":
            again = fwd[:-1] if i % period == period - 1 else fwd
            calls += bwd + (again if i < n_units * period else [])
    v, nq = cfg.vocab_size, cfg.n_codebooks
    cut_vocab = v % m != 0
    # an audio head stored split is gathered and cut (the frontend table)
    head_gather = bool(nq) and (nq * v) % m == 0 and cut_vocab
    calls += xf + ef + ["AG"] * head_gather
    if step != "train":
        calls += ["AG"]                                  # the logits
    else:
        vision_seq = cfg.frontend == "vision_stub" and seq
        calls += xb + ["AR"] * (cut_vocab or vision_seq)
        calls += eb + ["AR"] * (cut_vocab and not head_gather)
        calls += ["RS"] * head_gather
        calls += ["AR"] * (2 + seq) + ["AR"]
    out = {}
    for c in calls:
        out[KINDS[c]] = out.get(KINDS[c], 0) + 1
    return out


@pytest.mark.parametrize("name", meshlab.UNEVEN)
def test_collectives_equal_the_docstring_rows(name, world):
    rep = world["report"]
    cfg = CFGS[name]
    s = prompt_len(cfg, MESH[1])
    serve = rep[f"{name}_serve_counts"]
    for step in ("prefill", "decode"):
        assert serve[step][0] == uneven_counts(step, cfg, MESH[1], s), step
    if name != "sliding":
        assert rep[f"{name}_train_counts"]["train"][0] == uneven_counts(
            "train", cfg, MESH[1], s)


def test_jax_prefill_and_loss(world):
    rep = world["report"]
    logits, loss = world["jax"]
    np.testing.assert_allclose(rep["xlstm_jax_prefill_logits"], logits,
                               rtol=0, atol=TOL)
    assert abs(rep["xlstm_jax_loss"] - loss) <= TOL


@pytest.mark.parametrize("dispatch", ("gather", "einsum"))
def test_moe_groups_across_rank_segments(dispatch, world):
    rep = world["segments"][dispatch]
    assert rep["margin"] > TOL
    assert rep["dropped_across"] > 0
    assert rep["logits"] <= TOL
    assert rep["loss"] <= TOL
    assert rep["grads"] <= TOL
