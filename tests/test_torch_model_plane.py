"""The model plane (``repro_torch.sharding.ModelPlane``, the dense family of
``repro_torch.models.transformer`` under ``rules=``) against the unsharded
port and the reference.

* Shard shapes, arithmetic only: for all 10 configs x 4 ``INPUT_SHAPES`` on
  both production meshes, the dry run's per-rank parameters, AdamW moments,
  batch and KV cache (``launch.dryrun.build_step`` on a ``CountingMesh``)
  have the shapes of JAX's ``NamedSharding(AbstractMesh, rules.spec(...))
  .shard_shape`` from the reference's rules and logical trees.
* Gloo ranks (``meshlab.spawn``, one spawn per world size): the smoke Llama
  in float32 at meshes (1, 1), (1, 2), (2, 1) in a world of 2 and (1, 1),
  (2, 2), (1, 4) in a world of 4; a prefill, 4 sampled tokens (3 decode
  steps) and 2 donated AdamW steps. Logits, tokens, losses and the first
  step's gradients equal ``rules=None``'s within 1e-5, and bit for bit at
  (1, 1); the parameters after the AdamW steps within 1e-5 wherever the
  first gradient exceeds ``meshlab.GRAD_FLOOR`` (1e-6): AdamW moves an
  entry by about lr * sign(g), so an entry whose gradient is float32 noise
  moves by an amount the noise decides, in either run. (1, 4) takes the
  half-head and KV_SEQ paths, the sliding config the ring;
  ``act_seq_shard`` equals the plain config within 1e-5. Each step's
  collectives, counted in the ranks by kind, equal the table in
  ``repro_torch.sharding``'s docstring.
* The (2, 2) prefill logits and train loss from JAX's parameters (through
  ``convert.lm_params``) equal JAX's ``model.prefill`` and ``loss_fn``
  within 1e-5.
* The plane keeps the batch's ``positions`` (3 t + 5 here): the prefill
  logits and loss equal ``rules=None``'s with the same positions bit for
  bit on one rank (``launch.mesh.host_rules``) and within 1e-5 at (2, 2).
* The dry run's counted collective bytes for the smoke Llama at a
  shape-only (2, 2) mesh equal the bytes the gloo (2, 2) run moved.
* The client plane on a (pod 2, data 2) mesh, whose client axis is the
  product ("pod", "data"), meets ``tests/test_torch_mesh.py``'s contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharding as jsh
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import specs as jspecs
from repro.models import registry as jreg
from repro.optim import optimizers as jopt
from repro_torch import meshlab
from repro_torch import sharding as sh
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun as dr
from repro_torch.models import common as cm
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_mesh import (LAB, assert_collectives, assert_mesh_contract,
                             expected_collectives)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
WORLD2 = ((1, 1), (1, 2), (2, 1))
WORLD4 = ((1, 1), (2, 2), (1, 4))


# ---------------------------------------------------------------------------
# shard shapes against JAX
# ---------------------------------------------------------------------------

def _abstract_mesh(shape: dict):
    names, sizes = tuple(shape), tuple(shape.values())
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _is_logical(x):
    return isinstance(x, str) or (isinstance(x, tuple) and len(x) > 0 and
                                  all(isinstance(e, (str, type(None)))
                                      for e in x))


def _jax_shards(shapes, logical, rules, amesh) -> list:
    lg = jax.tree.leaves(logical, is_leaf=_is_logical)
    sds = jax.tree.leaves(shapes)
    assert len(lg) == len(sds)
    return [tuple(jax.sharding.NamedSharding(
        amesh, rules.spec(g, s.shape)).shard_shape(s.shape))
        for g, s in zip(lg, sds)]


def _port_shapes(tree) -> list:
    return [tuple(x.shape) for x in cm.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("mesh", ("pod16x16", "pod2x16x16"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_equal_jax(arch, mesh):
    amesh = _abstract_mesh(dr.MESHES[mesh])
    jrules = jsh.ShardingRules.default(amesh)
    for name, shape in INPUT_SHAPES.items():
        jcfg = jspecs.shape_config(jget_config(arch), shape)
        jm = jreg.build_model(jcfg)
        p_logical = jm.param_logical()
        fn, args = dr.build_step(
            dr.sp.shape_config(dr.get_config(arch), shape), shape,
            rules=dr.mesh_rules(mesh))
        want_p = _jax_shards(jm.param_shapes(), p_logical, jrules, amesh)
        assert _port_shapes(args[0]) == want_p, (name, "params")
        b_specs, b_logical = jspecs.input_specs(jcfg, shape)
        assert _port_shapes(args[-1]) == _jax_shards(
            b_specs, b_logical, jrules, amesh), (name, "batch")
        if shape.kind == "train":
            o_logical = jopt.opt_state_logical(p_logical, "adamw")
            state = args[1]
            assert tuple(state.step.shape) == ()
            assert _port_shapes((state.mu, state.nu)) == _jax_shards(
                (jm.param_shapes(), jm.param_shapes()),
                (o_logical.mu, o_logical.nu), jrules, amesh), name
        if shape.kind == "decode":
            c_shapes = jax.eval_shape(lambda: jm.init_cache(
                shape.global_batch, shape.seq_len))
            c_logical = jm.cache_logical(shape.seq_len,
                                         dr.MESHES[mesh]["model"])
            got = _port_shapes((args[1]["scan"], args[1]["tail"]))
            assert got == _jax_shards(
                (c_shapes["scan"], c_shapes["tail"]),
                (c_logical["scan"], c_logical["tail"]), jrules, amesh), name


def test_llama_decode_cache_is_half_a_gib_a_rank():
    """Llama-3.2-1B's decode_32k bf16 cache, 128 GiB whole, over batch / 16
    and KV_SEQ / 16 (its 8 KV heads do not divide 16)."""
    shape = INPUT_SHAPES["decode_32k"]
    _, args = dr.build_step(dr.get_config("llama3.2-1b"), shape,
                            rules=dr.mesh_rules("pod16x16"))
    assert dr.tree_bytes(args[1]) == 2 ** 29
    k = args[1]["scan"][0]["k"]
    assert tuple(k.shape) == (16, 128 // 16, 32768 // 16, 8, 64)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _jax_setup():
    """The smoke Llama's JAX parameters (numpy) and JAX's prefill logits
    and loss on the lab's prompt."""
    cfg = meshlab.plane_configs()["base"]
    import dataclasses
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"), dtype="float32")
    assert cfg.d_model == jcfg.d_model and cfg.n_layers == jcfg.n_layers
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
def world2():
    return meshlab.spawn(meshlab.plane_world, 2, WORLD2)["plane"]


@pytest.fixture(scope="module")
def world4():
    jparams, logits, loss = _jax_setup()
    out = meshlab.spawn(meshlab.plane_world, 4, WORLD4, {"base": jparams},
                        LAB)
    out["jax"] = (logits, loss)
    return out


def _reports(world2, world4):
    return {tuple(r["mesh"]): r for r in world2 + world4["plane"]}


@pytest.fixture(scope="module")
def reports(world2, world4):
    return _reports(world2, world4)


@pytest.mark.parametrize("world", (2, 4))
def test_one_rank_mesh_is_bit_identical(world, world2, world4):
    rep = (world2 if world == 2 else world4["plane"])[0]
    assert rep["mesh"] == (1, 1)
    for name in ("base", "sliding"):
        assert rep[f"{name}_logits_bitwise"] and \
            rep[f"{name}_tokens_equal"], name
    assert rep["base_train_bitwise"]
    assert rep["base_grad_diff"] == 0.0


@pytest.mark.parametrize("mesh", ((1, 2), (2, 1), (2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_matches_unsharded(mesh, reports):
    rep = reports[mesh]
    names = ("base", "sliding") + (("seq",) if mesh[1] > 1 else ())
    for name in names:
        assert rep[f"{name}_logits"] <= TOL, name
        assert rep[f"{name}_tokens_equal"], name
    for name in ("base",) + (("seq",) if mesh[1] > 1 else ()):
        assert rep[f"{name}_loss_diff"] <= TOL, name
        assert rep[f"{name}_grad_diff"] <= TOL, name
        assert rep[f"{name}_param_diff_above_floor"] <= TOL, name


def test_each_path_is_taken(reports):
    """(1, 4): 2 KV heads of 64 columns over 4 ranks, half a head each,
    gathered whole; the cache over its slots; the sliding config's 8-slot
    ring, which the 16-token prompt wraps, over 4 ranks too."""
    paths = reports[(1, 4)]["paths"]
    assert paths == {"half_head": True, "kv_seq": True, "ring": True}
    assert reports[(2, 2)]["paths"]["kv_seq"] is False


def expected_counts(step: str, layers: int, kvg: int, seq: bool,
                    mesh=(2, 2), moe=None) -> dict:
    """``repro_torch.sharding``'s table: {kind: calls} of one step on a
    (data, model) ``mesh``, whose one-rank axes run nothing; with ``moe``
    (rg, cg) an MoE config's, the MoE table's terms added."""
    L = layers
    if step == "prefill":
        by_axes = ({"D": {"all-gather": L + 2},
                    "M": {"all-gather": L * kvg + 2 * L + 2,
                          "reduce-scatter": 2 * L + 1}} if seq else
                   {"D": {"all-gather": L + 2},
                    "M": {"all-gather": L * kvg + 1,
                          "all-reduce": 2 * L + 1}})
    elif step == "decode":
        by_axes = {"D": {"all-gather": L + 2},
                   "M": {"all-gather": 2 * L * kvg + 1,
                         "all-reduce": 2 * L + 1 + 3 * L * kvg}}
    elif seq:
        by_axes = {"D": {"all-gather": 2 * L + 2, "reduce-scatter": L + 2,
                         "all-reduce": 1},
                   "M": {"all-gather": 2 * L * kvg + 6 * L + 2,
                         "reduce-scatter": L * kvg + 5 * L + 2,
                         "all-reduce": 3},
                   "DM": {"all-reduce": 1}}
    else:
        by_axes = {"D": {"all-gather": 2 * L + 2, "reduce-scatter": L + 2,
                         "all-reduce": 1},
                   "M": {"all-gather": 2 * L * kvg,
                         "reduce-scatter": L * kvg,
                         "all-reduce": 5 * L + 4},
                   "DM": {"all-reduce": 1}}
    if moe is not None:
        rg, cg = moe
        train = step == "train"
        add = {"D": {"all-gather": (2 if train else 1) * cg * L,
                     "all-reduce": 2 * L if train else 0},
               "M": {"all-gather": (2 if train else 1) * rg * L,
                     "all-reduce": (2 * L if seq else L) if train else 0,
                     "reduce-scatter": -L if train and seq else 0}}
        for axes, kinds in add.items():
            for kind, n in kinds.items():
                by_axes[axes][kind] = by_axes[axes].get(kind, 0) + n
    size = {"D": mesh[0], "M": mesh[1], "DM": mesh[0] * mesh[1]}
    out = {}
    for axes, kinds in by_axes.items():
        for kind, n in kinds.items():
            if size[axes] > 1 and n:
                out[kind] = out.get(kind, 0) + n
    return out


@pytest.mark.parametrize("mesh", ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_equal_the_docstring_table(mesh, reports):
    rep = reports[mesh]
    cfg = meshlab.plane_configs()["base"]
    kvg = int(cfg.n_kv_heads % mesh[1] != 0)
    for name in ("base", "seq"):
        seq = name == "seq"
        if seq and mesh[1] == 1:
            continue
        serve = rep[f"{name}_serve_counts"]
        assert serve["prefill"][0] == expected_counts(
            "prefill", cfg.n_layers, kvg, seq, mesh), (name, "prefill")
        assert serve["decode"][0] == expected_counts(
            "decode", cfg.n_layers, kvg, False, mesh), (name, "decode")
        assert rep[f"{name}_train_counts"]["train"][0] == expected_counts(
            "train", cfg.n_layers, kvg, seq, mesh), (name, "train")


def test_one_rank_plane_keeps_the_batch_positions():
    """Under one rank's rules (``launch.mesh.host_rules``) the smoke Llama's
    prefill logits and loss with the batch's positions 3 t + 5 equal
    ``rules=None``'s with the same positions bit for bit, and those
    positions move the logits away from the token indices'."""
    from repro_torch.launch.mesh import host_rules
    with host_rules(device="cpu") as rules:
        rep = meshlab.positions_report(rules)
    assert rep["bitwise"] and rep["logits"] == 0.0 and rep["loss"] == 0.0
    assert rep["from_indices"] > 1e-3


def test_plane_keeps_the_batch_positions_at_2x2(world4):
    rep = world4["plane"][1]
    assert rep["mesh"] == (2, 2)
    pos = rep["positions"]
    assert pos["logits"] <= TOL and pos["loss"] <= TOL
    assert pos["from_indices"] > 1e-3


def test_jax_prefill_and_loss_at_2x2(world4):
    rep = world4["plane"][1]
    assert rep["mesh"] == (2, 2)
    logits, loss = world4["jax"]
    np.testing.assert_allclose(rep["base_jax_prefill_logits"], logits,
                               rtol=0, atol=TOL)
    assert abs(rep["base_jax_loss"] - loss) <= TOL


def test_counted_bytes_equal_the_gloo_run(world4):
    """The dry run's count of each step at a ``CountingMesh`` (data 2,
    model 2) equals the bytes each kind of collective moved on the gloo
    (2, 2) ranks."""
    rep = world4["plane"][1]
    cfg = meshlab.plane_configs()["base"]
    b, s, cap = meshlab.PLANE_B, meshlab.PLANE_S, \
        meshlab.PLANE_S + meshlab.PLANE_GEN
    runs = {"prefill": (InputShape("plane", s, b, "prefill"), cap),
            "decode": (InputShape("plane", cap, b, "decode"), None),
            "train": (InputShape("plane", s, b, "train"), None)}
    real = dict(rep["base_serve_counts"], **rep["base_train_counts"])
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


def test_client_plane_on_a_pod_data_product(world4):
    rep = world4["pod"]
    assert rep["world_size"] == 4 and rep["n_clients"] == 8
    assert_mesh_contract(rep, "mesh2x2")
    assert_collectives(rep["collectives_mesh2x2"], expected_collectives(LAB))


# ---------------------------------------------------------------------------
# layout and roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", ((24, 16), (8, 16), (512, 4), (7, 3)))
def test_split_range_tiles_every_item_once(n, k):
    parts = [sh.split_range(n, k, i) for i in range(k)]
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    sizes = {hi - lo for lo, hi in parts}
    assert max(sizes) - min(sizes) <= 1


def test_collective_term_uses_the_links_a_group_spans():
    """A group inside one 8-GPU node runs at NVLink's rate, one that spans
    nodes at the network's; a ring moves (n-1)/n of an all-gather's result,
    (n-1) results for a reduce-scatter and 2 (n-1)/n for an all-reduce."""
    from repro_torch import roofline as rl
    pod = {"data": 16, "model": 16}
    assert rl.link_rate(pod, ("model",)) == rl.NET_BW      # 16 > 8 ranks
    assert rl.link_rate(pod, ("data",)) == rl.NET_BW       # stride 16
    node = {"data": 32, "model": 8}
    assert rl.link_rate(node, ("model",)) == rl.NVLINK_BW
    assert rl.link_rate({"data": 1, "model": 1}, ("model",)) == rl.NVLINK_BW
    assert rl.wire_bytes("all-gather", 4, 400) == 300
    assert rl.wire_bytes("reduce-scatter", 4, 100) == 300
    assert rl.wire_bytes("all-reduce", 4, 400) == 600
    assert rl.wire_bytes("all-reduce", 1, 400) == 0
    summary = [{"kind": "all-reduce", "axes": ["model"], "calls": 2,
                "bytes": 8 * 10 ** 9}]
    assert rl.collective_seconds(summary, node) == pytest.approx(
        2 * 7 / 8 * 8e9 / rl.NVLINK_BW)


def test_counting_mesh_records_without_a_process_group():
    rules = sh.ShardingRules.default(sh.CountingMesh({"pod": 2, "data": 16,
                                                      "model": 16}))
    plane = sh.ModelPlane(rules)
    assert plane.axes["dp"] == ("pod", "data") and plane.k_dp == 32
    x = torch.empty((4, 6), device="meta")
    assert tuple(plane.all_gather(x, "dp", 1).shape) == (4, 192)
    assert tuple(plane.reduce_scatter(torch.empty((32, 3), device="meta"),
                                      "model", 0).shape) == (2, 3)
    plane.all_reduce(x, "all")
    assert rules.mesh.by_kind() == {"all-gather": 4 * 192 * 4,
                                    "reduce-scatter": 2 * 3 * 4,
                                    "all-reduce": 4 * 6 * 4,
                                    "all-to-all": 0}
    assert [r["axes"] for r in rules.mesh.summary()] == [
        ["pod", "data"], ["pod", "data", "model"], ["model"]]
