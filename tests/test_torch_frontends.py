"""The port's vision-stub and audio-codec families against the JAX package
on the CPU: ``rope.apply_mrope``, ``transformer.embed_inputs`` for both
frontends, and the smoke qwen2-vl (2 layers, d_model 256, GQA 4/2, hd 64,
M-RoPE sections (8, 12, 12), 128-wide patch embeddings) and smoke musicgen
(2 layers, d_model 256, 2 codebooks of 512) from JAX's own parameters
carried across by ``convert.lm_params``: prefill logits and caches, 4
teacher-forced decode steps from JAX's cache, ``forward_train``'s loss and
ce and every leaf of its gradient (remat on; remat off bit for bit), and
``serve`` on JAX's replayed Gumbel draws.

M-RoPE equals RoPE when its three streams agree, so every M-RoPE check
that could hide a fault feeds distinct streams: the vision prompts carry
Qwen2-VL's position grid (patch i at (0, i // W, i % W), text after the
grid's largest index in all three streams), and ``apply_mrope`` is also
checked on random distinct (t, h, w) and on two streams (the band map
taken modulo the stream count).

Tolerances: ``apply_mrope`` 1e-6 absolute in float32 (the same f32 angles
and rotation; measured ~5e-7 on values of size ~4). The models in float32
1e-5 (measured ~1e-6) and in bfloat16 2e-2, as ``test_torch_moe.py`` and
``test_torch_transformer.py`` state theirs; ``embed_inputs`` in float32
1e-6 and in bfloat16 2e-2 (the projector's bf16 product rounded at other
places). Served tokens are held equal where JAX's top-two margin of
logits / T + noise exceeds ``MARGIN`` (1e-4), as in
``test_torch_serve.py``; an audio step compares all its codebooks, and a
row's comparison stops at the first step where any codebook's margin is
smaller. Gradients as ``test_torch_train.py`` holds the dense family's:
float32 within 1e-5 of each leaf's largest |g| (measured 9.9e-7),
bfloat16 within 3e-2 of it and 3e-2 in relative norm (measured 1.3e-2
and 8.8e-3: bf16 products rounded at other places, and the embedding
rows' gradients summed in another order than XLA's scatter-add).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import train as jtrain
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import serve as srv
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as cm
from repro_torch.models import rope
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401
from test_torch_serve import MARGIN, _jax_serve
from test_torch_train import _grads, assert_grads_match, assert_remat_bitwise

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VL, AUDIO = "qwen2-vl-72b", "musicgen-medium"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, N_IMG, N_TXT, N_DEC, GEN = 2, 8, 16, 4, 6
GRID_W = 4     # the smoke prompts' patch grid: 2 rows of 4


def vl_positions(b, n_img, n_txt, grid_w):
    """Qwen2-VL's (t, h, w) positions for one image of n_img patches in
    rows of ``grid_w`` followed by n_txt text tokens: patch i at (0,
    i // grid_w, i % grid_w), text token j at m + j in all three streams,
    m one past the grid's largest index."""
    i = np.arange(n_img)
    img = np.stack([np.zeros_like(i), i // grid_w, i % grid_w], -1)
    start = int(img.max()) + 1
    txt = np.repeat((start + np.arange(n_txt))[:, None], 3, -1)
    return np.broadcast_to(np.concatenate([img, txt])[None],
                           (b, n_img + n_txt, 3)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tb(batch):
    """A numpy batch as torch: ids int64, embeds bf16, positions int64."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = (torch.as_tensor(v.astype(np.float32)).bfloat16()
                  if k == "embeds" else torch.as_tensor(v).long())
    return out


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------

def _mrope_positions(kind, b, s, rng):
    if kind == "text":
        return np.broadcast_to(np.arange(s)[None, :, None],
                               (b, s, 3)).astype(np.int32)
    if kind == "grid":
        return vl_positions(b, s // 2, s - s // 2, 4)
    if kind == "random":
        return rng.integers(0, 300, (b, s, 3)).astype(np.int32)
    return rng.integers(0, 300, (b, s, 2)).astype(np.int32)   # two streams


@pytest.mark.parametrize("kind", ["text", "grid", "random", "two-streams"])
@pytest.mark.parametrize("sections,hd", [((8, 12, 12), 64),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd, kind):
    rng = np.random.default_rng(hd)
    b, s, h, theta = 2, 40, 3, 1_000_000.0
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    pos = _mrope_positions(kind, b, s, rng)
    want = np.asarray(jax.jit(jrope.apply_mrope, static_argnums=(2, 3))(
        x, pos, theta, sections))
    got = rope.apply_mrope(_t(x), _t(pos).long(), theta, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    flat = rope.apply_rope(_t(x), _t(pos[..., 0]).long(), theta)
    if kind == "text":
        # one stream: M-RoPE is RoPE, and so is JAX's
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(
            want, np.asarray(jax.jit(jrope.apply_rope, static_argnums=2)(
                x, pos[..., 0], theta)), rtol=0, atol=1e-6)
    else:
        # distinct streams move the rotation far from RoPE on stream t
        assert float((got - flat).abs().max()) > 0.1
    # bf16 inputs: rotated in f32, cast back
    got16 = rope.apply_mrope(_t(x).bfloat16(), _t(pos).long(), theta,
                             sections)
    assert got16.dtype == torch.bfloat16
    _close(got16, want, 2e-2)


# ---------------------------------------------------------------------------
# configs, counts, synthetic batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n", [(VL, 72_715_870_208),
                                    (AUDIO, 1_837_254_144)])
def test_configs_and_counts_match_jax(arch, n):
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch)),
                      (get_config(arch).reduced(n_layers=4),
                       jget_config(arch).reduced(n_layers=4))):
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert got == {key: want[key] for key in got}
    m, jm = build_model(get_config(arch)), jbuild(jget_config(arch))
    assert m.n_params() == jm.n_params() == n
    assert m.n_active_params() == jm.n_active_params() == n


@pytest.mark.parametrize("arch", [VL, AUDIO])
def test_synth_batch_shapes_and_dtypes(arch):
    """The reference's shapes and float dtypes; ids are int64 (torch's
    index dtype) where JAX's are int32, in [0, vocab)."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    got = tlaunch.synth_batch(cfg, torch.Generator().manual_seed(0), 3, 200)
    want = jax.eval_shape(lambda k: jtrain.synth_batch(jcfg, k, 3, 200),
                          jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        if k == "embeds":
            assert v.dtype == torch.bfloat16
            assert str(want[k].dtype) == "bfloat16"
            assert abs(float(v.float().std()) - 1.0) < 0.05
        else:
            assert v.dtype == torch.int64
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
    if arch == AUDIO:
        assert got["labels"] is got["codes"]


# ---------------------------------------------------------------------------
# embed_inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[VL, AUDIO])
def jparams(request):
    """One JAX init per family (the parameters are float32 whatever the
    activation dtype), its numpy leaves and a prompt in the family's
    batch form."""
    arch = request.param
    jm = jbuild(jget_smoke(arch))
    jp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    if arch == AUDIO:
        codes = rng.integers(0, cfg.vocab_size,
                             (B, N_IMG + N_TXT + N_DEC, cfg.n_codebooks))
        prompt = {"codes": codes[:, :N_IMG + N_TXT]}
        steps = [{"codes": codes[:, t:t + 1]}
                 for t in range(N_IMG + N_TXT, N_IMG + N_TXT + N_DEC)]
        train = {"codes": codes, "labels": codes}
    else:
        embeds = rng.standard_normal((B, N_IMG, cfg.frontend_dim))
        embeds = np.asarray(jax.numpy.asarray(embeds, jax.numpy.bfloat16))
        toks = rng.integers(0, cfg.vocab_size, (B, N_TXT + N_DEC))
        prompt = {"embeds": embeds, "tokens": toks[:, :N_TXT],
                  "positions": vl_positions(B, N_IMG, N_TXT, GRID_W)}
        steps = [{"token": toks[:, t:t + 1]}
                 for t in range(N_TXT, N_TXT + N_DEC)]
        labels = rng.integers(0, cfg.vocab_size, (B, N_IMG + N_TXT))
        train = dict(prompt, labels=labels)
    def i32(batch):
        return {k: v if k == "embeds" else np.asarray(v, np.int32)
                for k, v in batch.items()}
    return dict(arch=arch, jp=jp, tp=convert.lm_params(jp),
                prompt=i32(prompt), steps=[i32(st) for st in steps],
                train=i32(train))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [VL, AUDIO])
def test_embed_inputs_matches_jax(arch, dtype):
    """The frontends' embeddings on their own tables (4 codebooks for
    audio, so that the order of the bf16 sum shows: the reference adds
    e0 + e1 + e2 + e3 in bf16, and a float32 sum rounded once differs by
    an ulp) and the default positions, (B, S, 3) under M-RoPE. Audio is
    held exactly in both dtypes, vision within 1e-6 (float32) and 2e-2
    (bfloat16: the projector's bf16 product)."""
    over = {"dtype": dtype}
    if arch == AUDIO:
        over["n_codebooks"] = 4
    jcfg = dataclasses.replace(jget_smoke(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    rng = np.random.default_rng(2)
    s = N_IMG + N_TXT
    if arch == AUDIO:
        emb = {"tok": rng.standard_normal((4, cfg.vocab_size, cfg.d_model))}
        batch = {"codes": rng.integers(0, cfg.vocab_size, (B, s, 4))}
    else:
        emb = {"tok": rng.standard_normal((cfg.vocab_size, cfg.d_model)),
               "proj": rng.standard_normal((cfg.frontend_dim, cfg.d_model))
               * 0.1}
        batch = {"embeds": rng.standard_normal((B, N_IMG, cfg.frontend_dim)),
                 "tokens": rng.integers(0, cfg.vocab_size, (B, N_TXT))}
    emb = {k: v.astype(np.float32) for k, v in emb.items()}
    batch = {k: v.astype(np.float32 if k == "embeds" else np.int32)
             for k, v in batch.items()}
    jx, jpos, _ = jax.jit(lambda p, bt: jtf.embed_inputs(p, bt, jcfg))(
        {"embed": emb}, batch)
    tb = {k: _t(v) if k == "embeds" else _t(v).long()
          for k, v in batch.items()}
    x, pos, labels = tf.embed_inputs({"embed": convert.lm_params(emb)}, tb,
                                     cfg)
    assert x.dtype == cfg.act_dtype and labels is None
    assert tuple(x.shape) == (B, s, cfg.d_model)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    if arch == AUDIO:
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(jx, np.float32))
    else:
        assert tuple(pos.shape) == (B, s, 3)
        _close(x, jx, 1e-6 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# the smoke models against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(jparams, request):
    dtype = request.param
    arch = jparams["arch"]
    jm = jbuild(dataclasses.replace(jget_smoke(arch), dtype=dtype))
    m = build_model(dataclasses.replace(get_smoke_config(arch), dtype=dtype))
    return dict(jparams, jm=jm, m=m, tol=TOL[dtype])


def test_params_carry_the_frontend_leaves(lm):
    cfg, emb = lm["m"].cfg, lm["tp"]["embed"]
    if cfg.frontend == "audio_codec":
        assert tuple(emb["tok"].shape) == (cfg.n_codebooks, cfg.vocab_size,
                                           cfg.d_model)
        assert "proj" not in emb
    else:
        assert tuple(emb["proj"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert tuple(lm["tp"]["head"].shape) == \
        (cfg.d_model, cfg.vocab_size * max(cfg.n_codebooks, 1))
    leaves, jl = cm.tree_leaves(lm["tp"]), jax.tree.leaves(lm["jp"])
    assert len(leaves) == len(jl)
    assert [tuple(s.shape) for s in cm.tree_leaves(lm["m"].specs)] == \
        [a.shape for a in jl]
    for got, want in zip(leaves, jl):
        np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_and_decode_match_jax(lm):
    jm, m, tol = lm["jm"], lm["m"], lm["tol"]
    cap = N_IMG + N_TXT + N_DEC
    jl, jc = jax.jit(lambda p, bt: jm.prefill(p, bt, max_len=cap))(
        lm["jp"], lm["prompt"])
    logits, cache = m.prefill(lm["tp"], _tb(lm["prompt"]), max_len=cap,
                              use_flash=True)
    want_shape = (B, 1) + ((m.cfg.n_codebooks,) if m.cfg.n_codebooks
                           else ()) + (m.cfg.vocab_size,)
    assert tuple(logits.shape) == want_shape == jl.shape
    _close(logits, jl, tol)
    for got, want in zip(cm.tree_leaves((cache["scan"], cache["tail"])),
                         jax.tree.leaves((jc["scan"], jc["tail"]))):
        _close(got, want, tol)
    assert cache["pos"] == N_IMG + N_TXT
    cache = convert.lm_cache(jax.tree.map(np.asarray, jc))
    jdecode = jax.jit(jm.decode)
    for step in lm["steps"]:
        jl, jc = jdecode(lm["jp"], jc, step)
        logits, cache = m.decode(lm["tp"], cache, _tb(step))
        assert tuple(logits.shape) == want_shape
        _close(logits, jl, tol)
    assert cache["pos"] == cap


def test_forward_train_matches_jax(lm):
    jloss, jmet = jax.jit(lm["jm"].loss_fn)(lm["jp"], lm["train"])
    loss, met = lm["m"].loss_fn(lm["tp"], _tb(lm["train"]))
    tol = lm["tol"]
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=tol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0


def test_forward_train_grads_match_jax(lm):
    """Every gradient leaf of ``forward_train`` with remat on against
    ``jax.value_and_grad`` of the reference's (as ``test_torch_train.py``
    holds the dense family): the projector ``embed.proj`` from the bf16
    patch embeddings and the text embeddings under M-RoPE's distinct
    streams; every codebook's table and the codebook-major head. Then
    remat off against remat on, bit for bit, in the port."""
    jl, jg = jax.jit(jax.value_and_grad(lambda p: lm["jm"].loss_fn(
        p, lm["train"], remat=True)[0]))(lm["jp"])
    batch = _tb(lm["train"])
    loss, grads = _grads(lm["m"], lm["tp"], batch, remat=True)
    dtype = lm["m"].cfg.dtype
    np.testing.assert_allclose(float(loss), float(jl),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    assert_grads_match(grads, jg, dtype)
    emb = grads["embed"]
    if lm["arch"] == AUDIO:     # every codebook's table is reached
        assert all(float(t.abs().max()) > 0 for t in emb["tok"])
    else:
        assert float(emb["proj"].abs().max()) > 0
    assert_remat_bitwise(lm["m"], lm["tp"], batch)


def test_serve_with_replayed_noise_samples_jax_tokens(jparams):
    """Float32, JAX's Gumbel draws replayed: tokens equal wherever every
    codebook's top-two margin exceeds 1e-4 (see the module docstring)."""
    arch = jparams["arch"]
    jm = jbuild(dataclasses.replace(jget_smoke(arch), dtype="float32"))
    m = build_model(dataclasses.replace(get_smoke_config(arch),
                                        dtype="float32"))
    key = jax.random.PRNGKey(0)
    want, noise, top2, first = _jax_serve(jm, jparams["jp"],
                                          jparams["prompt"], GEN, 1.0, key)
    res = srv.serve(m, jparams["tp"], _tb(jparams["prompt"]), GEN,
                    gumbel=torch.as_tensor(noise), device="cpu")
    _close(res.logits, first, 1e-5)
    got = res.tokens.numpy()
    assert got.shape == want.shape == \
        (B, GEN) + ((m.cfg.n_codebooks,) if m.cfg.n_codebooks else ())
    if top2.ndim == 3:      # audio: a step's smallest margin over its books
        top2 = top2.min(-1)
    compared = 0
    for row in range(B):
        for i in range(GEN):
            if top2[row, i] <= MARGIN:
                break
            np.testing.assert_array_equal(got[row, i], want[row, i])
            compared += 1
    assert compared >= 0.75 * B * GEN, compared


@pytest.mark.parametrize("arch", [VL, AUDIO])
def test_serve_main_runs_the_frontends_on_the_host(arch):
    cfg = get_smoke_config(arch)
    res = srv.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "12", "--gen", "3", "--device", "cpu"])
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(res.tokens.shape) == (2, 3) + nq
    assert tuple(res.logits.shape) == (2, 1) + nq + (cfg.vocab_size,)
    assert bool(torch.isfinite(res.logits).all())
