"""The port's dense training path against the JAX package on the CPU, at the
smoke Llama's size (2 layers, d_model 256, vocab 512), from JAX's own
initial parameters (``convert.lm_params``) and optimizer state
(``convert.opt_state``).

Tolerances (each beside the largest difference measured):
  * ``forward_train`` in float32: loss 1e-5 relative (measured 0); every
    leaf's gradient within 1e-5 of that leaf's largest |g| (measured
    9.3e-7).
  * In bfloat16 (the config's activations): loss 1e-3 relative (measured
    5.5e-5); every leaf's gradient within 3e-2 of its largest |g| and
    3e-2 in relative L2 norm (measured 1.1e-2 and 8.7e-3): bf16 products
    are rounded at other places in the two frameworks, and each weight's
    gradient is formed in bf16 before it is widened into the f32 leaf.
  * Remat on and off: bitwise-equal gradients within the port.
  * The chunked route (KV length 2,100 > 2,048) under autograd: 1e-5 of
    the largest |grad| (measured 9.5e-7).
  * ``make_train_step``, 3 float32 AdamW steps at the launcher's lr 3e-4:
    losses and grad norms 1e-5 relative (measured 1.5e-7), lr equal;
    parameters and moments 2e-5 absolute (measured 3.6e-6). AdamW's first
    steps move each entry by about lr * g / |g|, so an entry whose gradient
    sits at rounding level can move up to 2 lr apart: at lr 3e-3 one entry
    of 1.44M did (2.7e-3). The gradients themselves are held above.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models.registry import build_model as jbuild
from repro.models.registry import make_train_step as jmake_train_step
from repro_torch import convert, optim
from repro_torch.configs import (INPUT_SHAPES, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model, make_train_step
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, S = 2, 32


def _models(dtype):
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype=dtype)
    return jbuild(jcfg), build_model(cfg)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    jm, m = _models(request.param)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    return dict(dtype=request.param, jm=jm, m=m, jp=jp,
                tp=convert.lm_params(jax.tree.map(np.asarray, jp)),
                jbatch={"tokens": jnp.asarray(toks), "labels":
                        jnp.asarray(toks)},
                batch={"tokens": torch.as_tensor(toks).long(),
                       "labels": torch.as_tensor(toks).long()})


def _grads(m, params, batch, remat):
    return cm.value_and_grad(
        lambda p: m.loss_fn(p, batch, remat=remat)[0], params)


def assert_grads_match(grads, jgrads, dtype):
    """Every leaf of the port's gradient tree against JAX's, in flatten
    order: finite, float32, JAX's shape; in float32 within 1e-5 of the
    leaf's largest |g|, in bfloat16 within 3e-2 of it and 3e-2 in
    relative L2 norm."""
    leaves, jleaves = cm.tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(leaves) == len(jleaves)
    f32 = dtype == "float32"
    for g, w in zip(leaves, jleaves):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert bool(torch.isfinite(g).all())
        err = np.abs(g.numpy() - w)
        scale = float(np.abs(w).max())
        assert float(err.max()) <= (1e-5 if f32 else 3e-2) * scale
        if not f32:
            assert np.linalg.norm(g.numpy() - w) <= 3e-2 * np.linalg.norm(w)


def assert_remat_bitwise(m, params, batch):
    """Remat off and on give the same loss and gradients, bit for bit."""
    l0, g0 = _grads(m, params, batch, remat=False)
    l1, g1 = _grads(m, params, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(cm.tree_leaves(g0),
                                                 cm.tree_leaves(g1)))


def assert_steps_match_jax(jm, m, jp, batches):
    """``make_train_step`` (float32 AdamW at the launcher's lr 3e-4, 2
    warmup steps of 10) from JAX's parameters and optimizer state, one step
    per (JAX batch, port batch) of ``batches``: loss, grad norm, ce and aux
    1e-5 relative and lr equal at every step, then every parameter and
    moment leaf within 2e-5. Returns the port's metrics per step."""
    tc = dict(optimizer="adamw", learning_rate=3e-4, total_steps=10,
              warmup_steps=2)
    jstep = jax.jit(jmake_train_step(jm, JTrainConfig(**tc)))
    step = make_train_step(m, TrainConfig(**tc))
    js = joptim.init_opt_state(jp, "adamw")
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    ts = convert.opt_state(jax.tree.map(np.asarray, js))
    out = []
    for jbatch, batch in batches:
        jp, js, jmet = jstep(jp, js, jbatch)
        tp, ts, met = step(tp, ts, batch)
        for name in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=1e-5)
        assert float(met["lr"]) == float(jmet["lr"])
        out.append(met)
    assert int(ts.step) == int(js.step) == len(batches)
    for a, b in zip(cm.tree_leaves((tp, ts.mu, ts.nu)),
                    jax.tree.leaves((jp, js.mu, js.nu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_loss_and_grads_match_jax(lm, remat):
    jl, jg = jax.jit(jax.value_and_grad(lambda p: lm["jm"].loss_fn(
        p, lm["jbatch"], remat=remat)[0]))(lm["jp"])
    loss, grads = _grads(lm["m"], lm["tp"], lm["batch"], remat)
    np.testing.assert_allclose(float(loss), float(jl),
                               rtol=1e-5 if lm["dtype"] == "float32"
                               else 1e-3)
    assert_grads_match(grads, jg, lm["dtype"])


def test_remat_grads_bitwise_equal(lm):
    """Checkpointed units recompute exactly what the plain run kept; the
    gradients reach the stacked leaves the same way."""
    assert_remat_bitwise(lm["m"], lm["tp"], lm["batch"])


def test_forward_train_metrics_and_ignored_labels(lm):
    labels = lm["batch"]["labels"].clone()
    labels[:, S // 2:] = -1
    loss, metrics = lm["m"].loss_fn(lm["tp"], dict(lm["batch"],
                                                   labels=labels))
    jloss, jmetrics = lm["jm"].loss_fn(lm["jp"], dict(
        lm["jbatch"], labels=jnp.asarray(labels.numpy())))
    assert float(metrics["aux"]) == 0.0 == float(jmetrics["aux"])
    assert float(loss) == float(metrics["ce"])
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if lm["dtype"] == "float32"
                               else 1e-3)


def test_chunked_route_gradient_matches_jax():
    """KV length 2,100 > 2,048 takes the chunked route (3 chunks, the last
    short); its gradient through q, k and v against ``jax.grad`` of the
    reference's ``chunked_attention``."""
    rng = np.random.default_rng(1)
    s, h, kv, hd = 2100, 2, 1, 8
    q, k, v, w = (rng.normal(size=shape).astype(np.float32) for shape in (
        (1, s, h, hd), (1, s, kv, hd), (1, s, kv, hd), (1, s, h, hd)))

    def jf(q_, k_, v_):
        return jnp.sum(jattn.attention(q_, k_, v_) * w)
    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attn.attention(tq, tk, tv)
    got = torch.autograd.grad(torch.sum(out * torch.as_tensor(w)),
                              (tq, tk, tv))
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        assert float(np.abs(g.numpy() - wnt).max()) <= \
            1e-5 * float(np.abs(wnt).max())


def test_make_train_step_matches_jax_over_three_steps():
    jm, m = _models("float32")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, 512, (B, S)).astype(np.int32)
        tt = torch.as_tensor(toks).long()
        batches.append(({"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(toks)},
                        {"tokens": tt, "labels": tt}))
    mets = assert_steps_match_jax(jm, m, jp, batches)
    assert all(float(met["aux"]) == 0.0 for met in mets)


def test_train_step_leaves_its_inputs_alone():
    """Two clients holding one tree: a step of one writes nothing into the
    tree or the shared optimizer state."""
    _, m = _models("float32")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    state = optim.init_opt_state(params, "adamw")
    before = [t.clone() for t in cm.tree_leaves((params, state))]
    step = make_train_step(m, TrainConfig(total_steps=4, warmup_steps=1))
    toks = torch.randint(0, 512, (B, S), generator=torch.Generator()
                         .manual_seed(1))
    p1, s1, _ = step(params, state, {"tokens": toks, "labels": toks})
    assert all(torch.equal(a, b) for a, b in
               zip(before, cm.tree_leaves((params, state))))
    p2, s2, _ = step(params, state, {"tokens": toks, "labels": toks})
    assert all(torch.equal(a, b) for a, b in
               zip(cm.tree_leaves((p1, s1)), cm.tree_leaves((p2, s2))))


@pytest.mark.parametrize("kind", ["adamw", "momentum", "sgd"])
def test_donated_step_writes_in_place_bit_for_bit(kind):
    """``donate=True`` (the reference's ``donate_argnums=(0, 1)``) returns
    the trees it was given, written in place, and over 3 steps the same
    bits as the plain step."""
    _, m = _models("float32")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tc = TrainConfig(optimizer=kind, total_steps=4, warmup_steps=1)
    plain, donated = make_train_step(m, tc), make_train_step(m, tc,
                                                              donate=True)
    p0, s0 = params, optim.init_opt_state(params, kind)
    p1 = cm.tree_map(torch.clone, p0)
    s1 = optim.init_opt_state(p1, kind)
    ptrs = [t.data_ptr() for t in cm.tree_leaves((p1, s1.mu, s1.nu))]
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        toks = torch.randint(0, 512, (B, S), generator=gen)
        batch = {"tokens": toks, "labels": toks}
        p0, s0, m0 = plain(p0, s0, batch)
        p1, s1, m1 = donated(p1, s1, batch)
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert [t.data_ptr() for t in cm.tree_leaves((p1, s1.mu, s1.nu))] == ptrs
    assert int(s1.step) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        cm.tree_leaves((p0, s0)), cm.tree_leaves((p1, s1))))


_FREE_PROBE = """
import gc, weakref
import torch
from repro_torch import optim
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch.train import synth_batch
from repro_torch.models import common as cm, registry, transformer
m = registry.build_model(get_smoke_config("qwen2-moe-a2.7b"))
g = torch.Generator().manual_seed(0)
params = m.init(g, device="cpu")
state = optim.init_opt_state(params, "adamw")
step = registry.make_train_step(m, TrainConfig(total_steps=4))
batch = synth_batch(m.cfg, g, 2, 16)
refs = {}
clip, update = registry.optim.clip_by_global_norm, registry.optim.opt_update
logits_fn = transformer.logits_from_hidden
def taped_clip(grads, max_norm, **kw):
    refs["unclipped"] = [weakref.ref(t) for t in cm.tree_leaves(grads)]
    out = clip(grads, max_norm, **kw)
    refs["clipped"] = [weakref.ref(t) for t in cm.tree_leaves(out[0])]
    return out
def taped_logits(*args):
    out = logits_fn(*args)
    refs["logits"] = [weakref.ref(out)]
    return out
def alive():
    return {k: sum(r() is not None for r in v) for k, v in refs.items()}
def taped_update(*args, **kw):
    print("update", alive())
    return update(*args, **kw)
registry.optim.clip_by_global_norm = taped_clip
registry.optim.opt_update = taped_update
transformer.logits_from_hidden = taped_logits
gc.disable()
for _ in range(2):
    params, state, _ = step(params, state, batch)
    print("after", alive())
"""


def test_train_step_frees_logits_and_gradients_without_the_collector():
    """In a fresh process (where the first checkpointed unit would import
    ``torch._dynamo``, and that import would keep the frames then on the
    stack in a reference cycle, had the model not imported it) with the
    cyclic collector off: at the optimizer update
    of the first and second steps only the clipped gradients are alive, not
    the logits or the unclipped gradients, and after each step none of
    them."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _FREE_PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    n = 16   # the smoke qwen2-moe's parameter leaves
    want_update = f"update {{'logits': 0, 'unclipped': 0, 'clipped': {n}}}"
    want_after = "after {'logits': 0, 'unclipped': 0, 'clipped': 0}"
    assert out == [want_update, want_after] * 2


def test_train_main_smoke_on_cpu(capsys):
    res = tlaunch.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "32", "--log-every", "1",
                        "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3.2-1b params=1,443,072 "
                             "active=1,443,072")
    assert [line.split()[:2] for line in out[1:4]] == \
        [["step", "0"], ["step", "1"], ["step", "2"]] and out[-1] == "done"
    assert len(res.loss) == len(res.seconds) == 3
    assert all(np.isfinite(res.loss)) and all(np.isfinite(res.grad_norm))
    # TrainConfig as the reference's launcher builds it: warmup max(2, 0)
    want_lr = [float(optim.cosine_warmup(i, base_lr=3e-4, warmup_steps=2,
                                         total_steps=3)) for i in range(3)]
    assert res.lr == want_lr


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-vl-72b",
                                  "musicgen-medium", "xlstm-125m",
                                  "recurrentgemma-2b"])
def test_train_main_runs_each_family_on_cpu(arch, capsys):
    """The launcher on each family's smoke config: 3 steps at batch 2 x 32
    positions (the audio family's frames of 2 codebooks, the vision
    family's 16 patches and 16 text tokens), finite losses and grad norms,
    the header's counts equal to JAX's."""
    res = tlaunch.main(["--arch", arch, "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "32", "--device", "cpu"])
    jm = jbuild(jget_smoke(arch))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"arch={arch} params={jm.n_params():,} "
                      f"active={jm.n_active_params():,} device=cpu")
    assert len(res.loss) == 3 and out[-1] == "done"
    assert all(np.isfinite(res.loss)) and all(np.isfinite(res.grad_norm))


def test_configs_and_entry_points_match_jax():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}
    m = build_model(get_config("llama3.2-1b"))
    assert m.n_active_params() == m.n_params() == 1_498_482_688
    moe = dataclasses.replace(get_smoke_config("llama3.2-1b"), n_experts=4,
                              experts_per_token=2, moe_d_ff=256)
    jmoe = dataclasses.replace(jget_smoke("llama3.2-1b"), n_experts=4,
                               experts_per_token=2, moe_d_ff=256)
    mm = build_model(moe)
    assert mm.n_active_params() == jbuild(jmoe).n_active_params() < \
        mm.n_params()
    vis = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              frontend="vision_stub", frontend_dim=8)
    batch = tlaunch.synth_batch(vis, torch.Generator(), 1, 4)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {"embeds": (1, 2, 8), "tokens": (1, 2), "labels": (1, 4)}
    assert batch["embeds"].dtype == torch.bfloat16
    assert get_config("qwen2-vl-72b").frontend == "vision_stub"
