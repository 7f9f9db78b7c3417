"""The port stands alone: ``src/repro_torch/``, ``chip_smoke.py`` and the
port's tools (``tools/flash_sm90_ablation.py``,
``tools/kmeans_assign_bench.py``, ``tools/flash_f32_bench.py``,
``tools/mma_tf32_probe.py``, ``tools/peak_live.py``) import no JAX and nothing of the JAX package,
and the port's entry points run on the card unless asked for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import meshlab
from repro_torch.core import exchange as tex
from repro_torch.core import pipeline as tpl
from repro_torch.configs import get_smoke_config
from repro_torch.core.trust import full_trust
from repro_torch.dynamics import OrchestratorConfig, run_orchestrator
from repro_torch.examples import quickstart
from repro_torch.fl import trainer as ttr
from repro_torch.launch import serve as tsrv
from repro_torch.models.autoencoder import AEConfig
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tools" / "flash_sm90_ablation.py",
     ROOT / "tools" / "kmeans_assign_bench.py",
     ROOT / "tools" / "flash_f32_bench.py",
     ROOT / "tools" / "mma_tf32_probe.py", ROOT / "tools" / "peak_live.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "repro", (path, mod)


def test_port_has_the_slice_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    for mod in ("kernels/ref.py", "kernels/ops.py", "kernels/_build.py",
                "kernels/kmeans_assign.py", "kernels/recon_gate.py",
                "core/batching.py", "core/pca.py", "core/kmeans.py",
                "core/trust.py", "core/channel.py", "core/dissimilarity.py",
                "core/rewards.py", "core/qlearning.py", "core/exchange.py",
                "core/pipeline.py", "data/partition.py", "data/synthetic.py",
                "models/common.py", "models/autoencoder.py", "fl/trainer.py",
                "fl/linear_eval.py", "convert.py",
                "kernels/flash_attention.py", "configs/base.py",
                "configs/__init__.py", "configs/llama32_1b.py",
                "configs/llama32_3b.py", "configs/llama3_8b.py",
                "models/rope.py", "models/attention.py",
                "models/transformer.py", "models/registry.py",
                "models/xlstm.py", "models/rglru.py",
                "configs/xlstm_125m.py", "configs/recurrentgemma_2b.py",
                "models/moe.py", "configs/qwen2_moe_a27b.py",
                "configs/phi35_moe_42b.py", "configs/moonshot_v1_16b.py",
                "configs/qwen2_vl_72b.py", "configs/musicgen_medium.py",
                "launch/serve.py", "dynamics/__init__.py",
                "dynamics/scenarios.py", "dynamics/environment.py",
                "dynamics/metrics.py", "dynamics/runstate.py",
                "dynamics/orchestrator.py", "dynamics/draws.py",
                "faults/__init__.py", "faults/plan.py", "faults/inject.py",
                "faults/retry.py", "checkpoint/__init__.py",
                "checkpoint/store.py", "obs/__init__.py", "obs/tracer.py",
                "obs/counters.py", "obs/manifest.py", "obs/profile.py",
                "obs/report.py", "examples/quickstart.py", "roofline.py",
                "launch/specs.py", "launch/dryrun.py", "launch/perf.py",
                "sharding.py", "launch/mesh.py", "meshlab.py"):
        assert mod in names
    for src in ("kmeans_assign.cu", "recon_gate.cu", "flash_attention.cu",
                "flash_attention_sm90.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).exists()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_resolve_device_defaults_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_a_card():
    _no_card()
    xs = [np.zeros((4, 8, 8, 1), np.float32)] * 3
    cfg = AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.run_pipeline(xs, None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.fl_train(xs, cfg, ttr.FLConfig(), xs[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        tex.run_exchange(xs, None, torch.zeros(3, 4, dtype=torch.long),
                         torch.ones(3, 3, 3), torch.tensor([1, 2, 0]),
                         torch.zeros(3, 3), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_orchestrator(xs, None, cfg, OrchestratorConfig(), "static",
                         xs[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        full_trust(3, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlab.parity_report(meshlab.LabConfig(), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlab.timing_report(meshlab.LabConfig(), None)
    model = build_model(get_smoke_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsrv.serve(model, params, torch.zeros((1, 4), dtype=torch.long), 2)
