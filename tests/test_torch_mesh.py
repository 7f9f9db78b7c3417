"""The sharded client plane on host ranks: ``repro_torch.meshlab``'s parity
report on spawned gloo groups of 1, 2 and 4 ranks (one spawn each).

The reference's own multi-device test (``tests/test_mesh_parity.py``) cannot
run on this host's jax, so the port is held to that test's contract, with
the unsharded port (held against JAX by the other port tests) as the oracle:

* mesh 1 is bit-identical to ``rules=None`` for every path;
* at mesh K the gate and AE pretraining are bit-identical (no cross-client
  reduction), the FL segment's FedAvg all-reduce stays within 1e-5, the
  clustering program's centroids within 5e-6 with every assignment equal,
  and the three discovery bursts' Q-tables within 1e-3 with every final
  link equal;
* N = 6 clients on 4 ranks do not divide the axis: the stacks are
  replicated, no collective runs and every digest equals ``rules=None``;
* each stage runs exactly the collectives ``repro_torch.sharding``'s
  docstring lists, counted inside each rank by wrapping every
  ``torch.distributed`` collective (and DTensor's functional ones);
* a placed stack holds only its rank's rows: the storage under each local
  shard is that rank's share of the N clients, not a view of the whole.
"""
import numpy as np
import pytest
import torch

from repro_torch import meshlab
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PATHS = ("gate", "pretrain", "fl", "cluster", "disc", "disc_ucb",
         "disc_warm")
LAB = meshlab.LabConfig()
LAB6 = meshlab.LabConfig(n_clients=6)


@pytest.fixture(scope="module")
def world1():
    return meshlab.spawn_parity_report(LAB, 1, "cpu", count=True)


@pytest.fixture(scope="module")
def world2():
    return meshlab.spawn_parity_report(LAB6, 2, "cpu", count=True)


@pytest.fixture(scope="module")
def world4():
    return meshlab.spawn_parity_report((LAB, LAB6), 4, "cpu", count=True)


def expected_collectives(cfg: meshlab.LabConfig) -> dict:
    """Each stage's collectives on a placed client axis: (all-reduces,
    all-gathers)."""
    e, m, half = cfg.rl_episodes, cfg.rl_buffer, cfg.rl_episodes // 2
    return {"pretrain": (0, 0), "gate_operands": (0, 0),
            "gate": (0, 2),                  # reserve rows; sizes/moved
            "fl": (cfg.n_rounds, 0),         # one FedAvg a round
            "cluster": (1, 0),               # the PCA moments
            "disc": (e + e // m, 1),         # means per episode and flush
            "disc_ucb": (e, 1),              # UCB never flushes
            "disc_warm": (half + half // m + (e - half) + (e - half) // m,
                          2)}


def assert_collectives(counts: dict, want: dict):
    for stage, (reduces, gathers) in want.items():
        got = dict(counts[stage])
        n_gather = sum(v for k, v in got.items() if k.startswith(
            "all_gather"))
        assert got.pop("all_reduce", 0) == reduces, (stage, counts[stage])
        assert n_gather == gathers, (stage, counts[stage])
        others = {k: v for k, v in got.items()
                  if not k.startswith("all_gather")}
        assert not others, (stage, others)


def assert_bit_identical(rep, tag):
    for path in PATHS:
        assert rep[f"{path}_digest_{tag}"] == rep[f"{path}_digest_base"], \
            (tag, path)


def assert_mesh_contract(rep, tag):
    n = rep["n_clients"]
    for path in ("gate", "pretrain"):
        assert rep[f"{path}_digest_{tag}"] == rep[f"{path}_digest_base"]
        assert rep[f"{path}_maxdiff_{tag}"] == 0.0
    assert rep[f"fl_maxdiff_{tag}"] < 1e-5
    assert rep[f"cluster_cents_maxdiff_{tag}"] <= 5e-6
    assert rep[f"cluster_assign_agree_{tag}"] == \
        rep[f"cluster_assign_total_{tag}"]
    for name in ("disc", "disc_ucb", "disc_warm"):
        assert rep[f"{name}_q_maxdiff_{tag}"] < 1e-3, name
        assert rep[f"{name}_edge_agree_{tag}"] == n, name


def test_world1_mesh1_bit_identical(world1):
    """A one-rank client axis places its stacks ``Shard(0)`` and runs no
    collective: over one rank each is the identity."""
    assert world1["world_size"] == 1
    assert_bit_identical(world1, "mesh1")
    assert_collectives(world1["collectives_mesh1"],
                       {k: (0, 0) for k in expected_collectives(LAB)})
    assert_collectives(world1["collectives_base"],
                       {k: (0, 0) for k in expected_collectives(LAB)})


def test_world4_mesh_contract(world4):
    rep = world4[0]
    assert rep["world_size"] == 4 and rep["n_clients"] == 8
    assert_mesh_contract(rep, "mesh4")
    assert_collectives(rep["collectives_mesh4"], expected_collectives(LAB))


def test_world4_mesh1_bit_identical(world4):
    """A one-rank data axis on each of 4 ranks (under a replica axis)."""
    for rep in world4:
        assert_bit_identical(rep, "mesh1")


def test_world4_indivisible_clients_replicate(world4):
    rep = world4[1]
    assert rep["n_clients"] == 6
    assert_bit_identical(rep, "mesh4")
    assert_collectives(rep["collectives_mesh4"],
                       {k: (0, 0) for k in expected_collectives(LAB6)})


def test_world2_mesh_contract(world2):
    assert world2["world_size"] == 2 and world2["n_clients"] == 6
    assert_mesh_contract(world2, "mesh2")
    assert_bit_identical(world2, "mesh1")
    assert_collectives(world2["collectives_mesh2"],
                       expected_collectives(LAB6))


def local_storage_report(n_clients: int) -> dict:
    """On each rank of a spawned group: for every way a stack gets placed
    (``client_data_from_lists``, ``as_client_data`` of a whole
    ``ClientData``, ``shard_clients`` of a whole tensor), the bytes of
    storage under its local shard and this rank's share of the whole
    stack's bytes; and whether the stack gathered back equals the whole."""
    from repro_torch import sharding as sh
    from repro_torch.core.batching import (as_client_data,
                                           client_data_from_lists)
    world = torch.distributed.get_world_size()
    rules = meshlab.make_rules(world, "cpu")
    rng = np.random.default_rng(0)
    sizes = [5 + 2 * i for i in range(n_clients)]
    xs = [rng.random((s, 4, 4, 1), dtype=np.float32) for s in sizes]
    ys = [rng.integers(0, 10, s) for s in sizes]
    whole = client_data_from_lists(xs, ys)
    placed = {"lists": client_data_from_lists(xs, ys, rules=rules),
              "client_data": as_client_data(whole, rules=rules)}
    out = {}
    for name, cd in placed.items():
        back = cd.whole(rules)
        out[name] = {
            "bytes": [x.to_local().untyped_storage().nbytes()
                      for x in (cd.data, cd.labels)],
            "share": [x.numel() // world * x.element_size()
                      for x in (whole.data, whole.labels)],
            "gathered_equal": torch.equal(back.data, whole.data)
            and torch.equal(back.labels, whole.labels)}
    stack = sh.shard_clients(whole.data, rules)
    out["shard_clients"] = {
        "bytes": [stack.to_local().untyped_storage().nbytes()],
        "share": [whole.data.numel() // world * whole.data.element_size()],
        "gathered_equal": torch.equal(sh.full_tensor(stack), whole.data)}
    for name, rep in out.items():
        assert rep["bytes"] == rep["share"], (name, rep)
        assert rep["gathered_equal"], name
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_placed_stack_holds_only_its_rows(world):
    rep = meshlab.spawn(local_storage_report, world, 8)
    for name in ("lists", "client_data", "shard_clients"):
        assert rep[name]["bytes"] == rep[name]["share"], (name, rep[name])
        assert rep[name]["gathered_equal"], name
