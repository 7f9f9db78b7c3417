"""The vision-stub and audio-codec frontends on the model plane (the
projector, M-RoPE's positions and the codebook embedding and head of
``repro_torch.models.transformer`` under ``rules=``) against the unsharded
port and the reference.

* Gloo ranks (``meshlab.spawn``, one spawn of world 4): the float32 smoke
  qwen2-vl (4 query heads, 2 KV heads: model 4 takes the KV_SEQ cache) on
  8 patch embeddings with Qwen2-VL's grid positions and 8 text tokens, and
  the smoke musicgen (2 codebooks of 512), each also under
  ``act_seq_shard`` (``meshlab.FRONTEND``), at meshes (1, 1), (2, 2) and
  (1, 4); a 16-position prompt, 4 sampled tokens (3 decode steps) and 2
  donated AdamW steps. Logits, tokens, losses and every leaf's first-step
  gradient equal ``rules=None``'s bit for bit at (1, 1) and within 1e-5
  elsewhere; the parameters after the AdamW steps within 1e-5 wherever the
  first gradient exceeds ``meshlab.GRAD_FLOOR``. Under ``act_seq_shard``
  at model 4 the image rows fall into the first two ranks' parts of S.
  Each step's collectives equal the dense table and the frontend table in
  ``repro_torch.sharding``'s docstring.
* The (2, 2) prefill logits and loss from JAX's parameters (through
  ``convert.lm_params``) equal JAX's unsharded ``model.prefill`` and
  ``loss_fn`` within 1e-5, the vision batch with its grid positions.
* The dry run's counted collective bytes at a shape-only (2, 2) mesh equal
  the gloo (2, 2) run's; one rank of the 16 x 16 production mesh counts
  both frontends' decode steps.
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
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_model_plane import expected_counts as dense_counts

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
MESHES = ((1, 1), (2, 2), (1, 4))
CFGS = meshlab.plane_configs()
FAMILIES = ("vlm", "audio")
ARCH = {"vlm": "qwen2-vl-72b", "audio": "musicgen-medium"}


def _jax_setup():
    """Per family, JAX's parameters (numpy) of its lab config, and JAX's
    prefill logits and loss on the lab's prompt."""
    params, ref = {}, {}
    for name in FAMILIES:
        cfg = CFGS[name]
        jcfg = dataclasses.replace(jget_smoke(ARCH[name]), dtype="float32")
        assert (jcfg.d_model, jcfg.n_layers, jcfg.n_codebooks,
                jcfg.frontend_dim) == (cfg.d_model, cfg.n_layers,
                                       cfg.n_codebooks, cfg.frontend_dim)
        jm = jreg.build_model(jcfg)
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(3))
        _, prompt, _ = meshlab.plane_inputs(cfg)
        pre = {k: jnp.asarray(v.numpy())
               for k, v in meshlab.prefill_batch(prompt).items()}
        train = {k: jnp.asarray(v.numpy())
                 for k, v in meshlab.train_batch(prompt).items()}
        logits, _ = jax.jit(lambda p, b: jm.prefill(p, b))(jparams, pre)
        loss, _ = jax.jit(lambda p, b: jm.loss_fn(p, b))(jparams, train)
        params[name] = jax.tree.map(np.asarray, jparams)
        ref[name] = (np.asarray(logits), float(loss))
    return params, ref


@pytest.fixture(scope="module")
def world():
    jparams, ref = _jax_setup()
    out = meshlab.spawn(meshlab.plane_world, 4, MESHES, jparams, None,
                        meshlab.FRONTEND)
    out["reports"] = {tuple(r["mesh"]): r for r in out["plane"]}
    out["jax"] = ref
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_one_rank_mesh_is_bit_identical(name, world):
    rep = world["reports"][(1, 1)]
    assert rep[f"{name}_logits_bitwise"] and rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_train_bitwise"]
    assert rep[f"{name}_grad_diff"] == 0.0
    assert rep[f"{name}_serve_counts"] == {"prefill": ({}, {}),
                                           "decode": ({}, {})}
    assert rep[f"{name}_train_counts"] == {"train": ({}, {})}


@pytest.mark.parametrize("name", meshlab.FRONTEND)
@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_matches_unsharded(mesh, name, world):
    rep = world["reports"][mesh]
    assert rep[f"{name}_logits"] <= TOL
    assert rep[f"{name}_tokens_equal"]
    assert rep[f"{name}_loss_diff"] <= TOL
    assert rep[f"{name}_param_diff_above_floor"] <= TOL
    diffs = rep[f"{name}_grad_diffs"]
    leaves = {"embed/tok", "head", "final_norm", "scan/0/wq", "scan/0/wk",
              "scan/0/mlp/wo"}
    if name.startswith("vlm"):
        leaves.add("embed/proj")
    assert leaves <= set(diffs)
    assert max(diffs.values()) <= TOL, diffs


def test_each_path_is_taken(world):
    """(1, 4): the smoke qwen2-vl's 2 KV heads over 4 ranks (KV_SEQ), the
    image rows over the first two ranks' parts of S under
    ``act_seq_shard``, the audio head gathered and cut to one range a
    codebook; (2, 2): KV heads split, the image rows in rank 0's part."""
    assert world["reports"][(1, 4)]["paths"] == {
        "kv_seq": True, "image_ranks": 2, "head_ranges": 2}
    assert world["reports"][(2, 2)]["paths"] == {
        "kv_seq": False, "image_ranks": 1, "head_ranges": 2}
    assert world["reports"][(1, 1)]["paths"]["head_ranges"] == 1


def expected_counts(step: str, cfg, mesh) -> dict:
    """{kind: calls} of one step of a frontend config on a (data, model)
    ``mesh``: the dense table's (its units are dense units) plus the
    frontend table's terms, which run over "model" only."""
    seq = cfg.act_seq_shard and mesh[1] > 1 and step != "decode"
    kvg = int(cfg.n_kv_heads % mesh[1] != 0)
    out = dense_counts(step, cfg.n_layers, kvg, seq, mesh)
    add = {}
    if cfg.n_codebooks:         # the head gathered over M; backward its RS
        add = {"all-gather": 1}
        if step == "train":
            add["reduce-scatter"] = 1
    elif seq and step == "train":   # the projector's copy: its gradient
        add = {"all-reduce": 1}
    if mesh[1] > 1:
        for kind, n in add.items():
            out[kind] = out.get(kind, 0) + n
    return out


@pytest.mark.parametrize("name", meshlab.FRONTEND)
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


@pytest.mark.parametrize("name", meshlab.FRONTEND)
def test_counted_bytes_equal_the_gloo_run(name, world):
    """The dry run's count of each step at a ``CountingMesh`` (data 2,
    model 2) equals, kind by kind, the calls and bytes of the gloo (2, 2)
    ranks (the dry run's vision batch has the lab's 8 patches at S 16)."""
    rep = world["reports"][(2, 2)]
    cfg = CFGS[name]
    b, s = meshlab.PLANE_B, meshlab.PLANE_S
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
def test_production_mesh_counts_frontend_decode(arch):
    """One rank of 16 x 16 decoding 32,768 tokens: qwen2-vl's 8 KV heads and
    musicgen's 24 do not divide 16, so each rank computes every KV head and
    the cache lies over its slots (2,048 a rank); the embedding's gather
    over the data axis holds the token table alone (a decode step embeds no
    image), musicgen's head is gathered over "model" and cut."""
    cfg = get_config(arch)
    rules = dr.mesh_rules("pod16x16")
    rec = dr.count_step(cfg, INPUT_SHAPES["decode_32k"], rules=rules)
    calls = {(r["kind"], tuple(r["axes"])): r["calls"]
             for r in rec["collective_calls"]}
    n = cfg.n_layers
    head = int(bool(cfg.n_codebooks))
    assert calls[("all-gather", ("data",))] == n + 2
    assert calls[("all-gather", ("model",))] == 2 * n + 1 + head
    assert calls[("all-reduce", ("model",))] == 5 * n + 1
    cache = rec["memory"]["cache_size_in_bytes"]
    kv_bytes = 2 * n * (128 // 16) * (32768 // 16) * cfg.n_kv_heads * \
        cfg.head_dim * 2
    assert cache == kv_bytes
