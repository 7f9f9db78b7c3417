"""The port's checkpoint store and run state.

* ``save_pytree`` writes atomically; a corrupt or truncated archive and
  drift in the key set, a shape or the run geometry raise ``ValueError``.
* A port run killed by ``preempt-resume`` at segment 2 and resumed from its
  checkpoint ends bit-identical to the uninterrupted run on the CPU:
  trace, final global parameters and final ``ClientData``.
* A ``preempt-resume`` checkpoint written by the JAX package has the port's
  key set, loads through ``convert.run_state`` and, resumed by the port on
  :class:`JaxReplayDraws`, ends where JAX's own resumed run ends: graphs,
  moved counts and client data exact, eval losses and parameters within
  2e-4 relative + 2e-5 absolute (``test_torch_fl``'s tolerance).
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.dynamics import run_orchestrator as j_run
from repro.faults import Preempted as JPreempted
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.dynamics import SeededDraws, get_scenario, load_run_state
from repro_torch.dynamics import run_orchestrator as t_run
from repro_torch.dynamics.runstate import DEV_KEYS
from repro_torch.faults import Preempted
from repro_torch.models.common import tree_leaves

from test_torch_draws import JaxReplayDraws, one_torch_thread  # noqa: F401
from test_torch_orchestrator import (JC, TC, compare_runs, configs, jax_run,
                                     world)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32),
                  "d": (torch.ones(2, dtype=torch.bool), 3)},
            "e": None, "h": torch.ones(2, dtype=torch.bfloat16)}


def test_roundtrip_keys_and_dtypes(tmp_path):
    path = str(tmp_path / "t.npz")
    store.save_pytree(path, _tree())
    flat = store.load_flat(path)
    assert sorted(flat) == ["a", "b/c", "b/d/0", "b/d/1", "h"]
    assert flat["h"].dtype == np.float32          # bf16 widened for npz
    back = store.load_pytree(path, _tree())
    for a, b in zip(tree_leaves(back), tree_leaves(_tree())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert back["h"].dtype == torch.bfloat16 and back["e"] is None
    sub = store.restore_subtree(flat, "b", {"c": torch.zeros(2), "d": (
        torch.zeros(2, dtype=torch.bool), torch.zeros(()))})
    assert torch.equal(sub["c"], torch.tensor([1.0, 2.0]))


def test_save_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "t.npz")
    store.save_pytree(path, _tree())
    before = open(path, "rb").read()

    def crash(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError, match="disk gone"):
        store.save_pytree(path, {"a": torch.zeros(3)})
    assert open(path, "rb").read() == before      # the old archive stands
    assert os.listdir(tmp_path) == ["t.npz"]       # no temp file left


@pytest.mark.parametrize("drift", ["missing", "extra", "shape"])
def test_load_pytree_refuses_drift(tmp_path, drift):
    path = str(tmp_path / "t.npz")
    store.save_pytree(path, _tree())
    like = _tree()
    if drift == "missing":
        like["z"] = torch.zeros(1)
    elif drift == "extra":
        del like["a"]
    else:
        like["a"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="shape mismatch" if drift == "shape"
                       else "does not match"):
        store.load_pytree(path, like)
    with pytest.raises(ValueError):
        store.restore_subtree(store.load_flat(path), "b",
                              {"c": torch.zeros(3)} if drift == "shape"
                              else {"q": torch.zeros(2)})


def test_truncated_archive_raises_value_error(tmp_path):
    path = str(tmp_path / "t.npz")
    store.save_pytree(path, {"a": torch.arange(10000.0)})
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    for load in (store.load_flat, lambda p: store.load_pytree(
            p, {"a": torch.zeros(10000)})):
        with pytest.raises(ValueError, match="corrupt or truncated"):
            load(path)


# ---------------------------------------------------------------------------
# kill and resume in the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    return world()


def _cfgs(ckpt_dir):
    # preempt-resume preempts at segment 2: the resumed run does segment 2
    return configs(retry=False, channel_failure=False, n_segments=3,
                   checkpoint_dir=ckpt_dir)


def test_kill_and_resume_is_bit_identical(small, tmp_path):
    xs, ys, ev = small
    _, cfg = _cfgs(str(tmp_path / "ckpt"))
    draws = SeededDraws(5, "cpu")
    scn = get_scenario("preempt-resume")
    full = t_run(xs, ys, TC, dataclasses.replace(cfg, checkpoint_dir=None),
                 dataclasses.replace(scn, faults=dataclasses.replace(
                     scn.faults, preempt_at=None)),
                 ev, draws=draws, device="cpu")
    with pytest.raises(Preempted) as ei:
        t_run(xs, ys, TC, cfg, "preempt-resume", ev, draws=draws,
              device="cpu")
    assert ei.value.segment == 2 and ei.value.checkpoint == cfg.checkpoint_path
    res = t_run(xs, ys, TC, cfg, "preempt-resume", ev, draws=draws,
                resume_from=cfg.checkpoint_path, device="cpu")

    assert res.trace.summary() == full.trace.summary()
    for a, b in zip(res.trace.segments, full.trace.segments):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
            else:
                assert x == y or (x != x and y != y), f.name
    for a, b in zip(tree_leaves(res.global_params),
                    tree_leaves(full.global_params)):
        assert torch.equal(a, b)
    for a, b in zip(res.client_data, full.client_data):
        assert torch.equal(a, b)
    assert len(res.segment_seconds) == 1          # segment 2

    # another draw source, or another geometry, refuses the checkpoint
    with pytest.raises(ValueError, match="resume key mismatch"):
        t_run(xs, ys, TC, cfg, "preempt-resume", ev,
              draws=SeededDraws(6, "cpu"), resume_from=cfg.checkpoint_path,
              device="cpu")
    with pytest.raises(ValueError, match="n_segments"):
        load_run_state(cfg.checkpoint_path, TC, 5, 10)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_run_state(cfg.checkpoint_path,
                       dataclasses.replace(TC, latent_dim=4), cfg.n_segments,
                       cfg.iters_per_segment)


# ---------------------------------------------------------------------------
# a JAX-written checkpoint resumed by the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_resume(small, tmp_path_factory):
    xs, ys, ev = small
    key = jax.random.PRNGKey(9)
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    tdir = str(tmp_path_factory.mktemp("port_ckpt"))
    jcfg, _ = _cfgs(jdir)
    _, tcfg = _cfgs(tdir)
    with pytest.raises(JPreempted):
        j_run(key, xs, ys, JC, jcfg, "preempt-resume", ev)
    # keep the checkpoint of the preemption: the resumed run overwrites
    # the latest one
    jpath = os.path.join(jdir, "at_preemption.npz")
    shutil.copy(jcfg.checkpoint_path, jpath)
    with pytest.MonkeyPatch.context() as mp:
        want, margins = jax_run(mp, key, xs, ys, ev, jcfg, "preempt-resume",
                                resume_from=jpath)
    # the port's own checkpoint at the same boundary, for the key set
    with pytest.raises(Preempted):
        t_run(xs, ys, TC, tcfg, "preempt-resume", ev,
              draws=JaxReplayDraws(key), device="cpu")
    return dict(key=key, want=want, margins=margins, jpath=jpath,
                tpath=tcfg.checkpoint_path, tcfg=tcfg)


def test_jax_checkpoint_has_the_port_layout(jax_resume):
    jflat = store.load_flat(jax_resume["jpath"])
    tflat = store.load_flat(jax_resume["tpath"])
    assert sorted(jflat) == sorted(tflat)
    assert {k.rsplit("/", 1)[1] for k in jflat
            if k.startswith("pending/0/dev/")} == set(DEV_KEYS)
    for k in jflat:
        assert jflat[k].shape == tflat[k].shape, k


def test_port_resumes_a_jax_checkpoint_to_jax_result(small, jax_resume):
    xs, ys, ev = small
    tcfg = jax_resume["tcfg"]
    rs = convert.run_state(jax_resume["jpath"], TC, tcfg.n_segments,
                           tcfg.iters_per_segment)
    assert rs.segment == 1 and rs.cd.sizes.dtype == torch.int64
    got = t_run(xs, ys, TC, tcfg, "preempt-resume", ev,
                draws=JaxReplayDraws(jax_resume["key"]), resume_from=rs,
                device="cpu")
    # segments 0-1 come from the checkpoint: the margins are those of the
    # resumed segment's re-exchange, which the port replays
    assert len(jax_resume["margins"]) == 1
    compare_runs(got, jax_resume["want"], jax_resume["margins"])
    env = convert.env_state(jax.device_get(jax_resume["want"].env))
    for a, b in zip(got.env, env):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=4e-6,
                                   atol=1e-6)
