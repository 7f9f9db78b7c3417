"""The port's federated-LLM path against the JAX package's example on the
CPU: token data (``data.tokens``), features (``core.features``) and the
example (``repro_torch.examples.federated_llm``) against
``examples/federated_llm.py``, imported from its path, on draws replayed
from the example's keys.

Checked exactly: the client token datasets, the clustering (assignments),
lambda, the links, the moved sequences and the exchanged datasets. Within
tolerance: the features (1e-6 absolute on values ~0.1; measured 1.5e-8) and
one FedAvg round (5 AdamW steps on 6 clients, the example's bf16 smoke
Llama) from the same initial parameters and minibatches: held-out loss
1e-3 relative (measured 2.1e-5), parameters 99.9% within 5e-4 (measured
8.5e-5) and all within 3e-3 (measured 8.6e-4). The bf16 gradients differ
at ~1e-2 relative between the frameworks, and AdamW moves an entry whose
gradient sits at that level by up to lr per step apart.
"""
import contextlib
import functools
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import channel as jch
from repro.core import features as jfeat
from repro.core import kmeans as jkm
from repro.core import pca as jpca
from repro.data import tokens as jtok
from repro.models.registry import build_model as jbuild
from repro_torch import convert, optim
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.core import features as feat
from repro_torch.core import kmeans as tkm
from repro_torch.data import tokens as ttok
from repro_torch.examples import federated_llm as tfl
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model, make_train_step
from test_torch_draws import (one_torch_thread, rl_draws,  # noqa: F401
                              t, trust_uniforms)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
VOCAB = 512
KEY = jax.random.PRNGKey(0)


def _example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "federated_llm.py")
    spec = importlib.util.spec_from_file_location("jax_federated_llm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _topic_draws(key, batch, seq, topic, n_topics=8):
    """The draws of ``topic_token_batch(key, ...)``."""
    kt, kg, ku = jax.random.split(key, 3)
    size = VOCAB // n_topics
    lo = topic * size
    return (jax.random.randint(kt, (batch, seq), lo, lo + size),
            jax.random.randint(kg, (batch, seq), 0, VOCAB),
            jax.random.uniform(ku, (batch, seq)))


def _client_draws(key, n_clients, per, seq, tpc=2):
    """The draws of ``make_client_token_data(key, ...)``, stacked."""
    parts = [[_topic_draws(jax.random.fold_in(jax.random.fold_in(key, i), j),
                           per, seq, (i + j) % 8) for j in range(tpc)]
             for i in range(n_clients)]
    return ttok.TopicDraws(*(torch.stack([torch.stack([t(p[j][f])
                                                       for j in range(tpc)])
                                          for p in parts])
                             for f in range(3)))


@jax.jit
def _kmeans_picks(keys):
    """``km.kmeans(key_i, x, 2)``'s k-means++ picks on 64 rows, per key."""
    def one(kk):
        k0, kk = jax.random.split(kk)
        first = jax.random.randint(k0, (), 0, 64)
        _, kc = jax.random.split(kk)
        return first, jax.random.uniform(kc, (1,))
    return jax.vmap(one)(keys)


def _discovery_draws(key):
    """Every draw of the example's ``discover_and_exchange(key, ...)``."""
    first, u = _kmeans_picks(jnp.stack([jax.random.fold_in(key, i)
                                        for i in range(6)]))
    kp, kf = jax.random.split(jax.random.fold_in(key, 8))
    return tfl.DiscoveryDraws(
        t(jax.random.normal(jax.random.PRNGKey(1234), (VOCAB, 64))),
        tkm.KMeansDraws(t(first, torch.int64), t(u)),
        trust_uniforms(jax.random.fold_in(key, 7), 6, 2),
        t(jch.make_positions(kp, 6)), t(jch.init_fading(kf, 6)),
        rl_draws(jax.random.fold_in(key, 9), 6, tfl.RL.n_episodes))


@jax.jit
def _jax_clustering(datasets):
    """The example's clustering: its features, federated PCA and one
    ``km.kmeans`` per client under ``fold_in(key, i)``."""
    table = jfeat.random_embed_table(jax.random.PRNGKey(1234), VOCAB, 64)
    flats = [jfeat.token_sequence_features(d, table) for d in datasets]
    pca = jpca.fit_pca_federated(flats, 16)
    return jnp.stack([jkm.kmeans(jax.random.fold_in(KEY, i),
                                 pca.transform(f), 2).assignments
                      for i, f in enumerate(flats)])


@pytest.fixture(scope="module")
def world():
    ex = _example()
    jds, jdom = ex.make_client_token_data(
        KEY, n_clients=6, n_seqs=64, seq_len=64, vocab=VOCAB,
        topics_per_client=2)
    ds, dom = ttok.make_client_token_data(_client_draws(KEY, 6, 32, 64))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jnew, jgraph = ex.discover_and_exchange(KEY, jds, VOCAB)
    printed = out.getvalue()
    lam_rows = printed.split("lambda matrix:\n")[1].split("links")[0]
    jlam = np.array([[int(v) for v in row.strip(" []").split()]
                     for row in lam_rows.strip().splitlines()])
    disc = tfl.discover_and_exchange(ds, VOCAB,
                                     draws=_discovery_draws(KEY))
    return dict(ex=ex, jds=jds, jdom=jdom, ds=ds, dom=dom, jnew=jnew,
                jgraph=jgraph, jlam=jlam, disc=disc)


def test_client_token_data_equals_reference(world):
    assert world["dom"] == world["jdom"]
    for a, b in zip(world["ds"], world["jds"]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topic_token_batch_equals_reference():
    key = jax.random.PRNGKey(5)
    want = jtok.topic_token_batch(key, batch=3, seq_len=10, vocab=VOCAB,
                                  topic=6, p_topic=0.5)
    draws = ttok.TopicDraws(*(t(a) for a in _topic_draws(key, 3, 10, 6)))
    np.testing.assert_array_equal(
        ttok.topic_token_batch(draws, p_topic=0.5).numpy(), np.asarray(want))
    # the generator convenience draws inside each topic's slice
    d = ttok.draw_topic_tokens(torch.Generator().manual_seed(0), [2, 7],
                               batch=4, seq_len=5, vocab=VOCAB)
    lo = torch.tensor([2, 7])[:, None, None] * 64
    assert tuple(d.u.shape) == (2, 4, 5)
    assert bool(((d.topical >= lo) & (d.topical < lo + 64)).all())


def test_features_match_reference(world):
    normals = jax.random.normal(jax.random.PRNGKey(1234), (VOCAB, 64))
    jtable = jfeat.random_embed_table(jax.random.PRNGKey(1234), VOCAB, 64)
    table = feat.random_embed_table(t(normals))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    got = feat.token_sequence_features(world["ds"][0], table)
    want = jfeat.token_sequence_features(world["jds"][0], jtable)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    imgs = np.random.default_rng(0).random((3, 4, 4, 2), dtype=np.float32)
    np.testing.assert_array_equal(feat.image_features(t(imgs)).numpy(),
                                  np.asarray(jfeat.image_features(imgs)))


def test_discovery_and_exchange_equal_the_example(world):
    disc = world["disc"]
    np.testing.assert_array_equal(
        disc.assignments.numpy(), np.asarray(_jax_clustering(world["jds"])))
    np.testing.assert_array_equal(disc.lam.numpy(), world["jlam"])
    np.testing.assert_array_equal(disc.graph.in_edge.numpy(),
                                  np.asarray(world["jgraph"].in_edge))
    np.testing.assert_array_equal(
        disc.moved.numpy(), [len(d) - 64 for d in world["jnew"]])
    for a, b in zip(disc.datasets, world["jnew"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fedavg_round_matches_the_example(world):
    jm = jbuild(jget_smoke("llama3.2-1b"))
    m = build_model(get_smoke_config("llama3.2-1b"))
    k3 = jax.random.PRNGKey(3)
    jnew = world["jnew"]
    want = world["ex"].fed_train_llm(k3, jm, jnew, steps=5)
    idx = np.stack([[np.asarray(jax.random.randint(
        jax.random.fold_in(k3, s * 100 + i), (4,), 0, jnew[i].shape[0]))
        for i in range(6)] for s in range(5)])
    init = convert.lm_params(jax.tree.map(np.asarray, jax.jit(jm.init)(k3)))
    got = tfl.fed_train_llm(m, world["disc"].datasets, steps=5,
                            init_params=init,
                            batch_idx=torch.as_tensor(idx).long())
    err = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel() for a, b
                          in zip(cm.tree_leaves(got), jax.tree.leaves(want))])
    assert float(err.max()) <= 3e-3
    assert float(np.quantile(err, 0.999)) <= 5e-4
    ev = np.concatenate([np.asarray(d) for d in jnew])[::6]
    jloss = float(jm.loss_fn(want, {"tokens": ev, "labels": ev})[0])
    tev = torch.as_tensor(ev).long()
    loss = float(m.loss_fn(got, {"tokens": tev, "labels": tev})[0])
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)


def test_fedavg_clients_do_not_write_through():
    """Every client starts from one shared tree and one shared optimizer
    state. Two clients with the same data and minibatches, averaged after
    one step, must equal one client's step: a write into the shared tree
    or state would start the second client elsewhere."""
    m = build_model(get_smoke_config("llama3.2-1b"))
    init = m.init(torch.Generator().manual_seed(0), device="cpu")
    before = [a.clone() for a in cm.tree_leaves(init)]
    data = torch.randint(0, VOCAB, (8, 16),
                         generator=torch.Generator().manual_seed(1))
    idx = torch.tensor([[[0, 3, 5, 6], [0, 3, 5, 6]]])
    got = tfl.fed_train_llm(m, [data, data], steps=1, tau_a=1,
                            init_params=init, batch_idx=idx)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 cm.tree_leaves(init)))
    step = make_train_step(m, TrainConfig(optimizer="adamw",
                                          learning_rate=1e-3, total_steps=1,
                                          warmup_steps=5))
    toks = data[idx[0, 0]]
    one, _, _ = step(init, optim.init_opt_state(init, "adamw"),
                     {"tokens": toks, "labels": toks})
    assert all(torch.equal(a, b) for a, b in zip(cm.tree_leaves(got),
                                                 cm.tree_leaves(one)))


def test_example_main_on_cpu(capsys):
    res = tfl.main(["--device", "cpu", "--steps", "1"])
    out = capsys.readouterr().out
    for line in ("== 6 clients with topic-skewed token data", "lambda matrix",
                 "links (rx <- tx)", "moved sequences",
                 "== federated training (1 steps, tau_a=5)",
                 "== held-out (all-topic) perplexity: non-iid="):
        assert line in out
    assert np.isfinite(res.ppl_base) and np.isfinite(res.ppl_smart)
    # fewer steps than tau_a: no aggregation, both runs keep the initial
    # parameters (the same draws), as in the reference
    assert res.ppl_base == res.ppl_smart
    assert (res.discovery.graph.in_edge != torch.arange(6)).all()
