"""The port's sharding rules and client-axis helpers (``repro_torch.sharding``,
``repro_torch.launch.mesh``) against the reference's ``repro.sharding``.

* ``ShardingRules.spec`` equals JAX's ``PartitionSpec`` entries over a grid:
  the reference's abstract (16, 16) and (2, 16, 16) production meshes and
  the host (1, 1) mesh, every logical name (and ``None``) in every position
  of 1-3 dim tensors, with no dims, divisible dims and indivisible ones,
  plus ``SCALAR``; and every case of ``tests/test_sharding.py`` on the port.
* The logical trees of the model side (``param_logical``, ``cache_logical``
  at model axes 1 and 16, ``opt_state_logical`` for the three optimizers,
  ``input_specs_logical`` for every input shape) equal JAX's for every
  config in ``ARCH_IDS`` at its smoke size.
* At ``rules=None`` the helpers are the identity or a plain reduction.
* On a one-rank gloo group (a ``HashStore``, made here and destroyed after):
  placement, local rows and the collectives of ``ClientSlice``, and the
  kernels' wrappers raising ``TypeError`` on a DTensor.
* A manifest's ``mesh`` equals JAX's ``_mesh_desc`` for the same shape.
"""
import itertools

import jax
import pytest
import torch

from repro import sharding as jsh
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_smoke_config as j_smoke
from repro.launch import specs as jspecs
from repro.models import registry as jreg
from repro.obs.manifest import _mesh_desc as j_mesh_desc
from repro.optim import optimizers as jopt
from repro_torch import sharding as sh
from repro_torch.configs import INPUT_SHAPES, get_smoke_config
from repro_torch.core import batching
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import registry as treg
from repro_torch.obs import manifest as tman
from repro_torch.obs.manifest import read_manifest
from repro_torch.optim import optimizers as topt

from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = (sh.BATCH, sh.SEQ, sh.D_MODEL, sh.D_FF, sh.HEADS, sh.KV_HEADS,
         sh.KV_SEQ, sh.HEAD_DIM, sh.VOCAB, sh.EXPERTS, sh.CLIENTS, sh.STACK,
         None)
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")))


def _abstract_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _rules(sizes, names):
    return (jsh.ShardingRules.default(_abstract_mesh(sizes, names)),
            sh.ShardingRules.default(dict(zip(names, sizes))))


def test_logical_names_are_the_references():
    for name in ("BATCH", "SEQ", "D_MODEL", "D_FF", "HEADS", "KV_HEADS",
                 "KV_SEQ", "HEAD_DIM", "VOCAB", "EXPERTS", "CLIENTS", "STACK",
                 "SCALAR"):
        assert getattr(sh, name) == getattr(jsh, name)


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=lambda v: "x".join(map(str, v)))
def test_spec_matches_reference_over_grid(sizes, names):
    jr, tr = _rules(sizes, names)
    assert tuple(jr.rules.items()) == tuple(tr.rules.items())
    assert tr.data_axes() == jr.data_axes()
    assert tr.spec(sh.SCALAR) == tuple(jr.spec(jsh.SCALAR)) == ()
    dims_sets = {1: [None, (32,), (49,), (6,), (1,)],
                 2: [None, (32, 64), (49, 60), (64, 6), (2, 16)],
                 3: [None, (64, 32, 32), (60, 32, 32), (16, 49, 512),
                     (6, 8, 7)]}
    n_cases = 0
    for nd in (1, 2, 3):
        for logical in itertools.product(NAMES, repeat=nd):
            for dims in dims_sets[nd]:
                want = tuple(jr.spec(logical, dims))
                assert tr.spec(logical, dims) == want, (logical, dims)
                n_cases += 1
    assert n_cases == 5 * (13 + 13 ** 2 + 13 ** 3)


# the reference's tests/test_sharding.py, case by case, on the port
def test_reference_cases():
    host = sh.ShardingRules.default({"data": 1, "model": 1})
    assert host.spec((sh.D_MODEL, sh.D_FF)) == ("data", "model")
    assert host.spec(sh.SCALAR) == ()
    assert host.spec((sh.STACK, sh.D_MODEL, sh.D_FF))[0] is None
    assert host.spec((sh.BATCH, None)) == ("data", None)
    pod = sh.ShardingRules.default({"data": 16, "model": 16})
    assert pod.spec((sh.D_MODEL, sh.D_FF), dims=(32, 49))[1] is None
    assert pod.spec((sh.D_MODEL, sh.D_FF), dims=(32, 64))[1] == "model"
    assert pod.spec((sh.EXPERTS, sh.D_MODEL, sh.D_FF), dims=(64, 32, 32)) \
        == ("model", "data", None)
    assert pod.spec((sh.EXPERTS, sh.D_MODEL, sh.D_FF), dims=(60, 32, 32)) \
        == (None, "data", "model")
    four = sh.ShardingRules.default({"data": 4})
    assert four.spec((sh.CLIENTS, None), dims=(6, 7)) == (None, None)
    assert four.spec((sh.CLIENTS, None), dims=(8, 7)) == ("data", None)
    assert hash(four) == hash(sh.ShardingRules.default({"data": 4}))
    assert four == sh.ShardingRules.default({"data": 4})
    assert len({four, sh.ShardingRules.default({"data": 4})}) == 1
    assert sh.client_axes(3) == (sh.CLIENTS, None, None)
    assert sh.client_axes(0) == ()
    multi = sh.ShardingRules.default({"pod": 1, "data": 1, "model": 1})
    assert multi.spec((sh.BATCH, None)) == (("pod", "data"), None)
    assert multi.data_axes() == ("pod", "data")
    assert tmesh.make_production_mesh() == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_logical_trees_match_reference(arch):
    jm = jreg.build_model(j_smoke(arch))
    tm = treg.build_model(get_smoke_config(arch))
    p_logical = tm.param_logical()
    assert p_logical == jm.param_logical()
    for model_axis in (1, 16):
        assert tm.cache_logical(64, model_axis) == \
            jm.cache_logical(64, model_axis)
    for kind in ("sgd", "momentum", "adamw"):
        assert tuple(topt.opt_state_logical(p_logical, kind)) == \
            tuple(jopt.opt_state_logical(jm.param_logical(), kind))
    for name, shape in J_INPUT_SHAPES.items():
        j_specs, j_logical = jspecs.input_specs(j_smoke(arch), shape)
        t_specs, t_logical = tspecs.input_specs_logical(
            get_smoke_config(arch), INPUT_SHAPES[name])
        assert t_logical == j_logical, name
        assert {k: tuple(v.shape) for k, v in t_specs.items()} == \
            {k: tuple(v.shape) for k, v in j_specs.items()}, name


def test_helpers_are_the_identity_without_rules():
    x = torch.randn(6, 3, 2)
    assert sh.shard_clients(x, None) is x
    assert sh.constrain_clients(x, None) is x
    assert torch.equal(sh.client_sum(x, None), torch.sum(x, dim=0))
    assert torch.equal(sh.client_mean(x, None), torch.mean(x, dim=0))
    assert sh.gather_clients((x, {"a": x}), None)[0] is x
    part = sh.ClientSlice(None, 6)
    assert (part.lo, part.hi, part.sharded) == (0, 6, False)
    assert part.rows(x) is x and part.place(x) is x and part.gather(x) is x
    assert part.psum(x) is x
    v = torch.randn(6)
    assert torch.equal(part.mean(v), torch.mean(v))
    assert torch.equal(part.self_mask("cpu"),
                       torch.eye(6, dtype=torch.bool))
    lists = [torch.randn(3, 2), torch.randn(5, 2)]
    cd = batching.client_data_from_lists(lists)
    assert batching.shard_client_data(cd, None) is cd
    assert cd.whole() is cd
    data, sizes = batching.stack_clients(lists)
    assert torch.equal(data, cd.data) and torch.equal(sizes, cd.sizes)


def test_shape_only_mesh_places_nothing():
    rules = sh.ShardingRules.default({"data": 2})
    with pytest.raises(ValueError, match="shape-only"):
        sh.shard_clients(torch.zeros(4, 3), rules)
    # an indivisible client count replicates and needs no live mesh
    assert sh.ClientSlice(rules, 3).sharded is False


def test_client_mesh_on_the_card_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_client_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_client_mesh(1, device="cuda")


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group over a HashStore (no port) and its client
    mesh; destroyed after the module."""
    dist = torch.distributed
    made = not dist.is_initialized()
    mesh = tmesh.make_client_mesh(1, device="cpu")
    yield sh.ShardingRules.default(mesh)
    if made:
        dist.destroy_process_group()


def test_one_rank_slice_places_and_reduces(one_rank):
    from torch.distributed.tensor import DTensor, Shard
    rules = one_rank
    x = torch.randn(4, 3)
    placed = sh.shard_clients(x, rules)
    assert isinstance(placed, DTensor) and placed.placements == (Shard(0),)
    assert placed.shape == x.shape
    assert sh.shard_clients(placed, rules) is placed
    part = sh.ClientSlice(rules, 4)
    assert part.sharded and (part.lo, part.hi) == (0, 4)
    assert torch.equal(part.rows(placed), x)
    assert torch.equal(sh.client_sum(placed, rules), torch.sum(x, dim=0))
    assert torch.equal(sh.client_mean(placed, rules), torch.mean(x, dim=0))
    tree = {"a": x, "b": (x > 0, torch.arange(4))}
    got = part.gather(tree)
    assert torch.equal(got["a"], x) and torch.equal(got["b"][0], x > 0)
    assert torch.equal(got["b"][1], torch.arange(4))
    assert torch.equal(sh.gather_clients(placed, rules), x)
    assert torch.equal(sh.full_tensor(placed), x)
    s1, s2 = part.psum((torch.ones(3), torch.full((2, 2), 2.0)))
    assert torch.equal(s1, torch.ones(3)) and torch.equal(
        s2, torch.full((2, 2), 2.0))
    cd = batching.client_data_from_lists(
        [torch.randn(3, 2), torch.randn(5, 2)], rules=rules)
    assert isinstance(cd.data, DTensor) and not isinstance(cd.sizes, DTensor)
    assert [t.shape[0] for t in cd.data_list()] == [3, 5]
    # a stack whose local rows are not this rank's share is refused
    wrong = DTensor.from_local(torch.randn(2, 3), rules.mesh, [Shard(0)],
                               run_check=False, shape=torch.Size((4, 3)),
                               stride=(3, 1))
    with pytest.raises(ValueError, match="never redistributes"):
        part.rows(wrong)


def test_kernel_wrappers_refuse_dtensors(one_rank):
    x = sh.shard_clients(torch.randn(2, 8, 4), one_rank)
    c = torch.randn(2, 3, 4)
    with pytest.raises(TypeError, match="local shard"):
        ops.kmeans_assign(x, c)
    with pytest.raises(TypeError, match="local shard"):
        ops.recon_gate_score(x, x.to_local(), torch.ones(2, 8))
    q = sh.shard_clients(torch.randn(2, 4, 2, 8), one_rank)
    with pytest.raises(TypeError, match="local shard"):
        ops.flash_attention(q, q.to_local(), q.to_local())
    # the local shard goes through
    a, _ = ops.kmeans_assign(x.to_local(), c)
    assert a.shape == (2, 8)


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=lambda v: "x".join(map(str, v)))
def test_manifest_mesh_matches_reference(sizes, names, tmp_path):
    jr, tr = _rules(sizes, names)
    assert tman._mesh_desc(tr) == j_mesh_desc(jr) == dict(zip(names, sizes))
    path = tmp_path / "m.jsonl"
    w = tman.ManifestWriter(str(path), rules=tr)
    w.close()
    assert read_manifest(str(path))["run"]["mesh"] == j_mesh_desc(jr)
    w = tman.ManifestWriter(str(tmp_path / "n.jsonl"))
    w.close()
    assert read_manifest(str(tmp_path / "n.jsonl"))["run"]["mesh"] is None
    assert tman._mesh_desc(None) is None


def test_lab_timing_report_runs_sharded_and_not(one_rank):
    from repro_torch import meshlab
    cfg = meshlab.LabConfig(n_clients=4, rl_episodes=10, rl_buffer=5)
    for mesh_size in (None, 1):
        rep = meshlab.timing_report(cfg, mesh_size, iters=1, device="cpu")
        assert rep["mesh_size"] == (mesh_size or 0)
        for key in ("gate_us", "fl_segment_us", "disc_us", "cluster_us"):
            assert rep[key] > 0.0, key
