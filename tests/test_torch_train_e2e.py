"""``repro_torch.examples.train_e2e`` against ``examples/train_e2e.py`` on
the CPU: a step's tokens from JAX's draws equal JAX's
``topic_token_batch`` at the example's vocabulary and topic i % 8; a
two-step run on xlstm-125m's smoke config (monkeypatched into the example:
the example itself trains the full config) prints the reference's lines,
returns finite losses and writes a checkpoint that loads back equal to the
trained parameters. Exact comparisons: tokens are integers.
"""
import functools
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import tokens as jtok
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.data import tokens as ttok
from repro_torch.examples import train_e2e
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _topic_draws(key, batch, seq, vocab, topic, n_topics=8):
    """The draws of ``topic_token_batch(key, ...)``."""
    kt, kg, ku = jax.random.split(key, 3)
    size = vocab // n_topics
    lo = topic * size
    return (jax.random.randint(kt, (batch, seq), lo, lo + size),
            jax.random.randint(kg, (batch, seq), 0, vocab),
            jax.random.uniform(ku, (batch, seq)))


@pytest.mark.parametrize("i", [0, 11])
def test_step_tokens_from_jax_draws_equal_the_reference(i):
    """The example's step i (``jax.random.fold_in(key, i)``, topic i % 8)
    at xlstm-125m's vocabulary and the --quick batch."""
    vocab = jget_config("xlstm-125m").vocab_size
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    want = jtok.topic_token_batch(key, batch=2, seq_len=64, vocab=vocab,
                                  topic=i % 8)
    draws = ttok.TopicDraws(*(t(a) for a in _topic_draws(key, 2, 64, vocab,
                                                         i % 8)))
    np.testing.assert_array_equal(ttok.topic_token_batch(draws).numpy(),
                                  np.asarray(want))
    # the example's own draws land in topic i % 8's slice as often
    got = train_e2e.step_tokens(torch.Generator().manual_seed(0), i,
                                batch=2, seq_len=64, vocab=vocab)
    size = vocab // 8
    lo = (i % 8) * size
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 64)
    assert float(((got >= lo) & (got < lo + size)).float().mean()) > 0.7


def test_main_quick_on_the_host(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(train_e2e, "get_config", get_smoke_config)
    ckpt = str(tmp_path / "xlstm.npz")
    saved = {}
    save = train_e2e.save_pytree

    def keep(path, tree):
        saved["params"] = tree
        save(path, tree)
    monkeypatch.setattr(train_e2e, "save_pytree", keep)
    losses = train_e2e.main(["--quick", "--steps", "2", "--device", "cpu",
                             "--ckpt", ckpt])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out.splitlines()
    cfg = get_smoke_config("xlstm-125m")
    n = build_model(cfg).n_params()
    assert out[0] == (f"model=xlstm-125m params={n:,} steps=2 batch=2 "
                      f"seq=64")
    assert re.fullmatch(r"step    0 loss=\d+\.\d{4} \(\d+ tok/s\)", out[1])
    assert re.fullmatch(r"step    1 loss=\d+\.\d{4} \(\d+ tok/s\)", out[2])
    assert out[3] == (f"mean loss first 5 steps {sum(losses) / 5:.4f} -> "
                      f"last 5 steps {sum(losses) / 5:.4f}")
    assert out[4] == f"checkpoint -> {ckpt}"
    like = build_model(cfg).param_shapes()
    back = load_pytree(ckpt, like)
    for a, b in zip(tree_leaves(back), tree_leaves(saved["params"])):
        assert torch.equal(a, b)
