"""The sharded one-shot pipeline and online orchestrator on two host ranks
(``repro_torch.meshlab.online_reports`` in one spawned gloo group).

* ``run_pipeline`` + ``fl_train`` at mesh 2 against ``rules=None``: the
  graph, moved counts, gate decisions, channel failures, both lambda
  matrices and the exchanged client data exactly (the gate's smallest
  relative decision margin is printed and must exceed 1e-5: the scores
  themselves are bit-identical across meshes, so the decisions are too),
  the FL global parameters within 1e-5.
* ``run_orchestrator`` on ``burst-outage`` with retries, both engines
  (eager; scan with the device selector and a fixed cap), at mesh 2
  against ``rules=None``: per segment the graph, moved, live, failed,
  retried, delivered and available counts exactly, the eval losses and the
  final global parameters within 1e-5, the final client data exactly.
* A mesh-2 run killed at segment 2 and resumed from its checkpoint (written
  by rank 0 from the gathered state, placed again on resume) equals the
  uninterrupted mesh-2 run bit for bit, per engine.
"""
import numpy as np
import pytest

from repro_torch import meshlab
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXACT = ("segment", "in_edge", "moved", "n_live", "n_failed", "retried",
         "retry_delivered", "n_available", "rediscovered")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_online")
    return meshlab.spawn(meshlab.online_reports, 2, 2, str(d), "cpu")


def test_pipeline_mesh2_matches_unsharded(reports):
    base, mesh = reports["pipeline"]["base"], reports["pipeline"]["mesh2"]
    assert base["gate_margin"] > 1e-5, base["gate_margin"]
    for key in ("in_edge", "moved", "fail", "accept", "lam_before",
                "lam_after"):
        np.testing.assert_array_equal(mesh[key], base[key], err_msg=key)
    assert mesh["data_digest"] == base["data_digest"]
    assert int(np.sum(base["moved"])) > 0
    assert np.max(np.abs(mesh["fl_global"] - base["fl_global"])) < 1e-5
    np.testing.assert_allclose(mesh["eval_loss"], base["eval_loss"],
                               rtol=0, atol=1e-5)


def _segments_agree(a, b, float_tol):
    assert len(a["segments"]) == len(b["segments"])
    for x, y in zip(a["segments"], b["segments"]):
        for key in EXACT:
            np.testing.assert_array_equal(np.asarray(x[key]),
                                          np.asarray(y[key]),
                                          err_msg=(x["segment"], key))
        if float_tol == 0.0:
            for key in x:
                np.testing.assert_array_equal(np.asarray(x[key]),
                                              np.asarray(y[key]),
                                              err_msg=(x["segment"], key))
        else:
            assert abs(x["eval_loss"] - y["eval_loss"]) < float_tol


@pytest.mark.parametrize("impl", ["eager", "scan"])
def test_orchestrator_mesh2_matches_unsharded(reports, impl):
    rep = reports["orchestrator"]
    base, mesh = rep[f"{impl}_base"], rep[f"{impl}_mesh2"]
    _segments_agree(base, mesh, 1e-5)
    assert np.max(np.abs(mesh["global"] - base["global"])) < 1e-5
    assert mesh["data_digest"] == base["data_digest"]
    np.testing.assert_array_equal(mesh["in_edge"], base["in_edge"])
    # the run exercised the plane: data moved, links failed and retried
    segs = base["segments"]
    assert sum(s["moved"] for s in segs) > 0
    assert sum(s["n_failed"] for s in segs) > 0
    assert sum(s["retried"] for s in segs) > 0


@pytest.mark.parametrize("impl", ["eager", "scan"])
def test_orchestrator_mesh2_kill_and_resume_bit_identical(reports, impl):
    rep = reports["orchestrator"]
    full, resumed = rep[f"{impl}_mesh2"], rep[f"{impl}_resumed"]
    _segments_agree(full, resumed, 0.0)
    np.testing.assert_array_equal(resumed["global"], full["global"])
    assert resumed["data_digest"] == full["data_digest"]
    np.testing.assert_array_equal(resumed["in_edge"], full["in_edge"])
