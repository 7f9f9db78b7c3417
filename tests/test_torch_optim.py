"""The port's optimizers, schedule and cross-entropy against the JAX package
on the CPU, on the same numpy inputs.

Tolerances (each beside the largest difference measured):
  * ``cosine_warmup``: 1e-6 relative (measured 3.0e-7 in the cosine
    phase: XLA's float32 cos and torch's differ by a few ulps); the warmup
    ramp is equal.
  * ``global_norm`` / ``clip_by_global_norm``: 1e-6 relative (measured 0).
  * ``sgd``, ``sgd_momentum``, ``adamw`` fed the same gradients, 3 updates:
    1e-6 relative plus 1e-9 absolute on parameters and moments (measured:
    sgd 0; momentum 7.5e-7 and adamw 1.2e-6 relative, the latter on
    second moments of ~1e-5, one float32 ulp or two).
  * ``cross_entropy``: 1e-6 relative (measured 1.0e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import convert, optim
from repro_torch.models import common as cm
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _np_tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
            "b": ({"c": (rng.normal(size=(5,)) * scale).astype(np.float32)},
                  (rng.normal(size=(2, 2, 3)) * scale).astype(np.float32))}


def _t(tree):
    return cm.tree_map(torch.as_tensor, tree)


def _close(got_tree, want_tree, rtol=1e-6, atol=1e-9):
    got, want = cm.tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("warmup,total", [(5, 30), (2, 10), (100, 1000),
                                          (0, 3)])
def test_cosine_warmup_matches_jax(warmup, total):
    steps = np.arange(total + 3, dtype=np.int32)
    kw = dict(base_lr=3e-4, warmup_steps=warmup, total_steps=total)
    want = np.asarray(jax.jit(lambda s: jsched.cosine_warmup(s, **kw))(
        jnp.asarray(steps)))
    got = optim.cosine_warmup(torch.as_tensor(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.numpy()[:warmup], want[:warmup])
    # a scalar step, as make_train_step passes OptState.step
    one = optim.cosine_warmup(torch.tensor(warmup, dtype=torch.int32), **kw)
    assert one.shape == () and float(one) == float(want[warmup])


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _np_tree(np.random.default_rng(1), scale=2.0)
    want, want_norm = jax.jit(lambda g: jopt.clip_by_global_norm(
        g, max_norm))(grads)
    got, norm = optim.clip_by_global_norm(_t(grads), max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(_t(grads))),
                               float(jopt.global_norm(grads)), rtol=1e-6)
    _close(got, want)
    if max_norm > float(norm):   # under the limit: unchanged
        _close(got, grads, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_optimizer_matches_jax_over_three_updates(kind):
    """Three updates fed the same gradients; the port starts from the JAX
    state carried across by ``convert.opt_state``."""
    rng = np.random.default_rng(2)
    params = _np_tree(rng)
    grads = [_np_tree(rng, scale=0.1) for _ in range(3)]
    lrs = [1e-3, 2e-3, 5e-4]
    kw = dict(weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8) \
        if kind == "adamw" else {}
    jstate = jopt.init_opt_state(params, kind)
    state = convert.opt_state(jax.tree.map(np.asarray, jstate))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    jp, p = params, _t(params)
    jupd = jax.jit(lambda p_, g, s, lr: jopt.opt_update(kind, p_, g, s, lr,
                                                        **kw))
    for g, lr in zip(grads, lrs):
        jp, jstate = jupd(jp, g, jstate, jnp.float32(lr))
        p, state = optim.opt_update(kind, p, _t(g), state,
                                    torch.tensor(lr, dtype=torch.float32),
                                    **kw)
    assert int(state.step) == int(jstate.step) == 3
    _close(p, jp)
    _close(state.mu, jstate.mu)
    _close(state.nu, jstate.nu)


def test_updates_leave_their_inputs_alone():
    """A tree held in several places (the federated-LLM example's clients) is
    not written through: every update returns new tensors."""
    rng = np.random.default_rng(3)
    params, grads = _t(_np_tree(rng)), _t(_np_tree(rng))
    for kind in ("sgd", "momentum", "adamw"):
        state = optim.init_opt_state(params, kind)
        before = [t.clone() for t in cm.tree_leaves((params, grads, state))]
        optim.opt_update(kind, params, grads, state, torch.tensor(1e-2))
        optim.clip_by_global_norm(grads, 1e-3)
        after = cm.tree_leaves((params, grads, state))
        assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("all_ignored", [False, True])
def test_cross_entropy_matches_jax(all_ignored):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 6, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    if all_ignored:
        labels[:] = -1
    want = float(jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cm.cross_entropy(torch.as_tensor(logits),
                                 torch.as_tensor(labels)))
    if all_ignored:
        assert got == want == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # bf16 logits are widened before the reductions
    lb = torch.as_tensor(logits).bfloat16()
    wb = float(jcm.cross_entropy(jnp.asarray(lb.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(labels)))
    np.testing.assert_allclose(float(cm.cross_entropy(lb, torch.as_tensor(
        labels))), wb, rtol=1e-6)
