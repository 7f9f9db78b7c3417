"""The recurrent families trained by the port against the JAX package on the
CPU, on the configs of ``test_torch_recurrent_serve.py``: xlstm-125m's
smoke config (mlstm, slstm) on 300 tokens, so the mLSTM's chunkwise form
crosses its 256-step chunk and pads the second, and the sLSTM's loop runs
300 steps of BPTT; recurrentgemma-2b reduced to 4 layers (one (rglru,
rglru, local_attn) unit and an rglru tail) on 72 tokens, past its 64-token
window, through the RG-LRU's log-depth scan. JAX's own initial parameters
are carried across by ``convert.lm_params``.

Checked: every gradient leaf of ``forward_train`` with remat on (float32),
remat off against remat on bit for bit, that remat recomputes the scanned
units and not the unrolled tail (as ``jax.checkpoint`` wraps only the
reference's scan body), the loss and the global gradient norm in
bfloat16, and three float32 AdamW steps of xlstm (64 positions a step)
against JAX's ``make_train_step``.

Tolerances: float32 gradients within 1e-5 of each leaf's largest |g|
(measured 2.8e-6 for xlstm and 2.1e-6 for recurrentgemma: the RG-LRU's
Hillis-Steele tree and the sLSTM's one GEMM over S sum in other orders
than JAX, as ``test_torch_recurrent_serve.py`` states), every gradient
finite (the mLSTM's sentinels, -1e9 and -1e30, never reach a gradient as
inf x 0). bfloat16: loss 1e-3 relative and global gradient norm 1e-2
relative (measured on xlstm and recurrentgemma: 7.6e-7 and 5.2e-5 on the
loss, 9.0e-6 and 1.1e-4 on the norm). Three steps: losses
and grad norms 1e-5 relative, parameters and moments 2e-5 absolute, as
for the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jbuild
from repro_torch import convert, optim
from repro_torch.models import common as cm
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_recurrent_serve import CASES, _cfgs
from test_torch_train import (_grads, assert_grads_match,
                              assert_remat_bitwise, assert_steps_match_jax)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 2


def _batch(cfg, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, s)).astype(np.int32)
    tt = torch.as_tensor(toks).long()
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": tt, "labels": tt})


@pytest.fixture(scope="module", params=list(CASES))
def lm(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch, "float32")
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jbatch, batch = _batch(cfg, CASES[arch][1])
    return dict(arch=arch, jm=jm, m=build_model(cfg), jp=jp, jbatch=jbatch,
                batch=batch,
                tp=convert.lm_params(jax.tree.map(np.asarray, jp)))


def test_forward_train_grads_match_jax(lm):
    jl, jg = jax.jit(jax.value_and_grad(lambda p: lm["jm"].loss_fn(
        p, lm["jbatch"], remat=True)[0]))(lm["jp"])
    loss, grads = _grads(lm["m"], lm["tp"], lm["batch"], remat=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert_grads_match(grads, jg, "float32")


def test_remat_grads_bitwise_equal(lm):
    assert_remat_bitwise(lm["m"], lm["tp"], lm["batch"])


@pytest.mark.parametrize("lm", ["recurrentgemma-2b"], indirect=True)
def test_remat_recomputes_the_units_not_the_tail(lm, monkeypatch):
    """recurrentgemma's 4 layers: the unit's two rglru blocks run again in
    the backward pass under remat, the tail's rglru block does not."""
    calls = []
    block = rglru_lib.rglru_block

    def counting(*args, **kw):
        calls.append(1)
        return block(*args, **kw)
    monkeypatch.setattr(rglru_lib, "rglru_block", counting)
    for remat, want in ((False, 3), (True, 5)):
        calls.clear()
        _grads(lm["m"], lm["tp"], lm["batch"], remat=remat)
        assert len(calls) == want


def test_bf16_loss_and_grad_norm_match_jax(lm):
    """The same parameters (float32 whatever the activations) with the
    config's bfloat16 activations."""
    jcfg, cfg = _cfgs(lm["arch"], "bfloat16")
    jm = jbuild(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(
        p, lm["jbatch"], remat=True)[0]))(lm["jp"])
    loss, grads = _grads(build_model(cfg), lm["tp"], lm["batch"], remat=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    np.testing.assert_allclose(float(optim.global_norm(grads)),
                               float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                                                  jax.tree.leaves(jg)))),
                               rtol=1e-2)
    assert all(bool(torch.isfinite(g).all()) for g in cm.tree_leaves(grads))


def test_xlstm_train_step_matches_jax_over_three_steps():
    jcfg, cfg = _cfgs("xlstm-125m", "float32")
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batches = [_batch(cfg, 64, seed) for seed in (2, 3, 4)]
    assert_steps_match_jax(jm, build_model(cfg), jp, batches)
