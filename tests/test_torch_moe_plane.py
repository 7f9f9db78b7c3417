"""The MoE family on the model plane (``repro_torch.models.transformer``'s
``_Plan.moe`` under ``rules=``) against the unsharded port and the
reference.

* Gloo ranks (``meshlab.spawn``, one spawn of world 4): the three float32
  smoke qwen2-moe configs of ``meshlab.plane_configs`` (``meshlab.MOE``:
  the gather dispatch in one group across the data ranks with 3 experts,
  the d_ff layout; the einsum dispatch, expert-parallel; the gather
  dispatch in groups of 16 under ``act_seq_shard``) at meshes (1, 1),
  (2, 2) and (1, 4); a prefill, 4 sampled tokens (3 decode steps) and 2
  donated AdamW steps. Logits, tokens, losses and every leaf's first-step
  gradient (the router's included) equal ``rules=None``'s bit for bit at
  (1, 1) and within 1e-5 elsewhere; the parameters after the AdamW steps
  within 1e-5 wherever the first gradient exceeds ``meshlab.GRAD_FLOOR``.
  The capacity factor 0.5 drops choices, and a group across data ranks
  drops some only for the lower rank's choices (counted in the ranks), so
  a wrong rank offset shows. Top-k and capacity are discontinuous: every
  router margin of the ``rules=None`` runs exceeds the tolerance. Each
  step's collectives equal the tables in ``repro_torch.sharding``'s
  docstring.
* One batch row on a gloo (2, 1) mesh, replicated over the data ranks:
  the gather dispatch's logits, loss and aux loss equal ``rules=None``'s
  within 1e-5 (``meshlab.replicated_batch_report``, in the same spawn).
* The (2, 2) prefill logits and loss from JAX's parameters (through
  ``convert.lm_params``) equal JAX's unsharded ``model.prefill`` and
  ``loss_fn`` within 1e-5.
* The dry run's counted collective bytes at a shape-only (2, 2) mesh equal
  the gloo (2, 2) run's; one rank of the 16 x 16 production mesh counts
  an MoE decode step and ``perf``'s ``moe_gather_grouped_seq`` prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.models import registry as jreg
from repro_torch import meshlab
from repro_torch import sharding as sh
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.models import moe as moe_lib
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_model_plane import expected_counts

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
MESHES = ((1, 1), (2, 2), (1, 4))
CFGS = meshlab.plane_configs()


def _jax_setup():
    """JAX's parameters (numpy) of ``meshlab.MOE[0]``'s config, and JAX's
    prefill logits and loss on the lab's prompt."""
    cfg = CFGS[meshlab.MOE[0]]
    jcfg = dataclasses.replace(
        jget_smoke("qwen2-moe-a2.7b"), dtype="float32", n_experts=3,
        moe_dispatch="gather", capacity_factor=0.5)
    assert (jcfg.n_experts, jcfg.moe_d_ff, jcfg.d_model) == \
        (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    jm = jreg.build_model(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(3))
    _, toks, _ = meshlab.plane_inputs(cfg)
    toks = jnp.asarray(toks.numpy())
    logits, _ = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(jparams,
                                                                   toks)
    loss, _ = jax.jit(lambda p, t: jm.loss_fn(
        p, {"tokens": t, "labels": t}))(jparams, toks)
    return (jax.tree.map(np.asarray, jparams), np.asarray(logits),
            float(loss))


@pytest.fixture(scope="module")
def world():
    jparams, logits, loss = _jax_setup()
    out = meshlab.spawn(meshlab.plane_world, 4, MESHES,
                        {meshlab.MOE[0]: jparams}, None, meshlab.MOE,
                        meshlab.MOE[0])
    out["reports"] = {tuple(r["mesh"]): r for r in out["plane"]}
    out["jax"] = (logits, loss)
    return out


@pytest.mark.parametrize("name", meshlab.MOE)
def test_one_rank_mesh_is_bit_identical(name, world):
    rep = world["reports"][(1, 1)]
    assert rep[f"{name}_logits_bitwise"] and rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_train_bitwise"]
    assert rep[f"{name}_grad_diff"] == 0.0


@pytest.mark.parametrize("name", meshlab.MOE)
@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_matches_unsharded(mesh, name, world):
    rep = world["reports"][mesh]
    assert rep[f"{name}_logits"] <= TOL
    assert rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_loss_diff"] <= TOL
    assert rep[f"{name}_param_diff_above_floor"] <= TOL
    diffs = rep[f"{name}_grad_diffs"]
    moe_leaves = [k for k in diffs if "/moe/" in k]
    assert {"scan/0/moe/router", "scan/0/moe/wi_gate",
            "scan/0/moe/shared/wo"} <= set(moe_leaves)
    assert max(diffs.values()) <= TOL, diffs


def test_replicated_batch_routes_as_unsharded(world):
    """One batch row on a (2, 1) mesh: the data axes do not divide it, so
    each data rank holds it whole. Given the whole batch's rows, each
    rank's capacity groups are the whole batch's and nothing ranks after
    another rank's copy: the prefill's and a decode step's logits, and a
    train step's loss and aux loss, equal ``rules=None``'s within 1e-5.
    Taken for a split batch (the default), the gather dispatch's one
    group holds both ranks' copies and the logits differ."""
    rep = world["replicated"]
    assert rep["replicated"]
    assert rep["logits"] <= TOL
    assert rep["loss"] <= TOL
    assert rep["aux"] <= TOL and rep["aux_value"] > 0
    assert rep["logits_as_split"] > 100 * TOL


def test_router_margins_exceed_the_tolerance(world):
    """Every token's k-th router probability exceeds its (k+1)-th by more
    than the tolerance in the ``rules=None`` runs and the JAX-parameter
    prefill, so the compared runs route alike."""
    rep = world["reports"][(1, 1)]
    for name in meshlab.MOE:
        assert rep[f"{name}_margin"] > TOL, name
    assert world["reports"][(2, 2)][f"{meshlab.MOE[0]}_jax_margin"] > TOL


def test_both_expert_layouts_are_taken(world):
    """4 experts split over model 2 and 4; 3 do not divide them, so their
    d_ff (256 columns) does."""
    for mesh in ((2, 2), (1, 4)):
        assert world["reports"][mesh]["paths"] == {
            "moe_gather": "d_ff", "moe_einsum": "experts",
            "moe_grouped_seq": "experts"}


def test_choices_drop_for_a_lower_data_rank(world):
    """At data 2 the gather dispatch's one group spans both ranks: rank 1
    drops choices its own tokens would have kept, for rank 0's; so does a
    decode step of the grouped config. Within a row (einsum) or on one
    data rank nothing spans."""
    rep = world["reports"][(2, 2)]
    assert rep["moe_gather_dropped_across"] > 0
    assert rep["moe_grouped_seq_dropped_across"] > 0
    assert rep["moe_einsum_dropped_across"] == 0
    assert all(world["reports"][(1, 4)][f"{n}_dropped_across"] == 0
               for n in meshlab.MOE)


def _spans(cfg, mesh, s) -> int:
    """1 when a capacity group of a (PLANE_B, s) batch holds more tokens
    than a data rank's."""
    b = meshlab.PLANE_B
    return int(moe_lib.group_size(cfg, b, s) > b // mesh[0] * s)


@pytest.mark.parametrize("name", meshlab.MOE)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_equal_the_docstring_table(mesh, name, world):
    rep = world["reports"][mesh]
    cfg = CFGS[name]
    kvg = int(cfg.n_kv_heads % mesh[1] != 0)
    rg = int(cfg.n_experts % mesh[1] == 0)
    seq = cfg.act_seq_shard and mesh[1] > 1
    serve = rep[f"{name}_serve_counts"]
    s = meshlab.PLANE_S
    assert serve["prefill"][0] == expected_counts(
        "prefill", cfg.n_layers, kvg, seq, mesh,
        (rg, _spans(cfg, mesh, s))), "prefill"
    assert serve["decode"][0] == expected_counts(
        "decode", cfg.n_layers, kvg, False, mesh,
        (rg, _spans(cfg, mesh, 1))), "decode"
    assert rep[f"{name}_train_counts"]["train"][0] == expected_counts(
        "train", cfg.n_layers, kvg, seq, mesh,
        (rg, _spans(cfg, mesh, s))), "train"


def test_jax_prefill_and_loss_at_2x2(world):
    rep = world["reports"][(2, 2)]
    logits, loss = world["jax"]
    name = meshlab.MOE[0]
    np.testing.assert_allclose(rep[f"{name}_jax_prefill_logits"], logits,
                               rtol=0, atol=TOL)
    assert abs(rep[f"{name}_jax_loss"] - loss) <= TOL


@pytest.mark.parametrize("name", meshlab.MOE)
def test_counted_bytes_equal_the_gloo_run(name, world):
    """The dry run's count of each step at a ``CountingMesh`` (data 2,
    model 2) equals, kind by kind, the calls and bytes of the gloo (2, 2)
    ranks."""
    rep = world["reports"][(2, 2)]
    cfg = CFGS[name]
    b, s, cap = meshlab.PLANE_B, meshlab.PLANE_S, \
        meshlab.PLANE_S + meshlab.PLANE_GEN
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


def test_production_mesh_counts_moe_steps(tmp_path):
    """moonshot's decode_32k at one rank of 16 x 16: 64 experts over 16
    ranks (expert-parallel), the router all-gathered over "model" once a
    layer, no counts gathered (a decode token is its own einsum group);
    then ``perf``'s ``moe_gather_grouped_seq`` on qwen2-moe's prefill_32k
    there, whose 4,096-token groups tile a rank's 32,768 tokens."""
    cfg = get_config("moonshot-v1-16b-a3b")
    rules = dr.mesh_rules("pod16x16")
    rec = dr.count_step(cfg, INPUT_SHAPES["decode_32k"], rules=rules)
    calls = {(r["kind"], tuple(r["axes"])): r["calls"]
             for r in rec["collective_calls"]}
    kvg = int(cfg.n_kv_heads % 16 != 0)
    assert calls[("all-gather", ("model",))] == \
        cfg.n_layers * (1 + 2 * kvg) + 1
    assert calls[("all-gather", ("data",))] == cfg.n_layers + 2
    var = perf.run("qwen2-moe-a2.7b", "prefill_32k", "moe_gather_grouped_seq",
                   str(tmp_path), mesh="pod16x16")
    assert var["mesh"] == "pod16x16" and var["collectives"]["all-gather"]
    assert var["t_collective_s"] > 0
