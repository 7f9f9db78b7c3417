"""``repro_torch.launch.specs``, ``roofline``, ``launch.dryrun``,
``launch.perf`` and ``Model.init_cache`` against the JAX package on the CPU.

Exact comparisons (pure arithmetic and shapes): the input specs and
``shape_config`` for every ``ARCH_IDS`` x ``INPUT_SHAPES`` pair,
``model_flops`` and the active-parameter counts it takes, the dry run's
argument bytes against the bytes of JAX's ``jax.eval_shape`` of the same
step's arguments (the six arches of ``tests/test_dryrun_host.py`` at its
tiny shapes), ``init_cache``'s tree against JAX's and every perf variant
field for field.

One tolerance: the counted FLOPs of the smoke Llama's train step (B 2, S
64) against XLA's ``cost_analysis`` of the same step, lowered with
``scan_unroll=True`` on a one-device host mesh. The dry run counts the
products only (``torch.utils.flop_counter``'s formulas); XLA also counts
elementwise work (norms, softmax, SiLU, AdamW's update), and the port's
remat stops recomputing a unit at its last needed output, which skips
each unit's final MLP product. So the count sits below XLA's: it must
land in [0.80, 1.0] of it (measured 0.944).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import optim as joptim
from repro import roofline as jrl
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import perf as jperf
from repro.launch import specs as jsp
from repro.models.registry import build_model as jbuild
from repro_torch import roofline as rl
from repro_torch import sharding as sh
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.launch import specs as sp
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
PAIRS = [(a, s) for a in J_ARCH_IDS for s in J_INPUT_SHAPES]
HOST_ARCHS = ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "xlstm-125m",
              "recurrentgemma-2b", "qwen2-vl-72b", "musicgen-medium"]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return jnp.dtype(x.dtype).name


def _same_fields(cfg, jcfg):
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def _tiny(name):
    return dataclasses.replace(INPUT_SHAPES[name], seq_len=64,
                               global_batch=2)


def _jtiny(name):
    return dataclasses.replace(J_INPUT_SHAPES[name], seq_len=64,
                               global_batch=2)


def _jbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def test_the_port_has_every_arch_and_shape():
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    assert tuple(INPUT_SHAPES) == tuple(J_INPUT_SHAPES)


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_input_specs_and_shape_config_equal_the_reference(arch, shape_name):
    shape, jshape = INPUT_SHAPES[shape_name], J_INPUT_SHAPES[shape_name]
    cfg = sp.shape_config(get_config(arch), shape)
    jcfg = jsp.shape_config(jget_config(arch), jshape)
    _same_fields(cfg, jcfg)
    specs = sp.input_specs(cfg, shape)
    jspecs, _ = jsp.input_specs(jcfg, jshape)
    assert sorted(specs) == sorted(jspecs)
    for name, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jspecs[name].shape), name
        assert _dtype(t) == _dtype(jspecs[name]), name
    # model_flops: the same arithmetic on the same arguments
    n_act = build_model(cfg).n_active_params()
    assert n_act == jbuild(jcfg).n_active_params()
    for backward in (False, True):
        assert rl.model_flops(cfg, n_act, shape, backward=backward) == \
            jrl.model_flops(jcfg, n_act, jshape, backward=backward)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", HOST_ARCHS)
def test_dry_run_argument_bytes_equal_jax_eval_shape(arch, shape_name):
    """The dry run runs the step on meta tensors (so the port's step runs
    at this shape); its argument bytes equal the bytes of JAX's abstract
    arguments of ``build_lowerable``'s step. JAX's decode cache also holds
    ``pos`` as an int32 scalar, a Python int in the port."""
    shape, jshape = _tiny(shape_name), _jtiny(shape_name)
    cfg = sp.shape_config(get_smoke_config(arch), shape)
    jcfg = jsp.shape_config(jget_smoke(arch), jshape)
    rec = dr.count_step(cfg, shape)
    jm = jbuild(jcfg)
    p = jm.param_shapes()
    batch, _ = jsp.input_specs(jcfg, jshape)
    want = _jbytes(p) + _jbytes(batch)
    if shape.kind == "train":
        want += _jbytes(jax.eval_shape(
            lambda q: joptim.init_opt_state(q, "adamw"), p))
    elif shape.kind == "decode":
        want += _jbytes(jax.eval_shape(
            lambda: jm.init_cache(jshape.global_batch, jshape.seq_len))) - 4
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    if shape.kind == "train":   # donated: the parameters and moments
        assert rec["memory"]["alias_size_in_bytes"] == \
            want - _jbytes(batch) - 4
    has_attn = any(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    launches = rec["kernels"].get("flash_attention_sm90", {}).get("launches")
    if shape.kind == "prefill" and has_attn:
        n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
        assert launches == n_attn
    else:
        assert launches is None


@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_init_cache_tree_equals_jax(arch):
    jm = jbuild(jget_smoke(arch))
    want = jax.eval_shape(lambda: jm.init_cache(2, 48))
    got = build_model(get_smoke_config(arch)).init_cache(2, 48,
                                                         device="meta")
    assert got["pos"] == 0 and want["pos"].dtype == jnp.int32
    leaves = cm.tree_leaves((got["scan"], got["tail"]))
    jleaves = jax.tree.leaves((want["scan"], want["tail"]))
    assert len(leaves) == len(jleaves) > 0
    for t, w in zip(leaves, jleaves):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape)
        assert _dtype(t) == _dtype(w)


def test_counted_flops_against_xla_cost_analysis():
    from repro.launch.dryrun import lower_and_compile
    shape, jshape = _tiny("train_4k"), _jtiny("train_4k")
    cfg = get_smoke_config("llama3.2-1b")
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"), scan_unroll=True)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrec, _ = lower_and_compile(jcfg, jshape, mesh)
    rec = dr.count_step(cfg, shape)
    ratio = rec["cost"]["flops"] / jrec["cost"]["flops"]
    assert 0.80 <= ratio <= 1.0, ratio
    # torch's own FlopCounterMode agrees with the split by dtype
    fn, args = dr.build_step(cfg, shape)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as m:
        fn(*args)
    assert m.get_total_flops() == rec["cost"]["flops"]


def test_plane_prefill_counts_the_rank_cache_alone():
    """A prefill on a rank of 16 x 16 counts its own cache shards, not the
    whole batch's cache whose shapes the plane reads on the meta device:
    Llama-3.2-1B's peak at 16 layers exceeds 4 layers' by about 12 layers'
    shards (1 MiB each at 64 x 2,048), and the whole cache (256 MiB a
    layer) is not among the step's temporaries."""
    cfg = dr.get_config("llama3.2-1b")
    shape = InputShape("plane", 2048, 64, "prefill")
    peaks = [dr.count_step(dataclasses.replace(cfg, n_layers=n), shape,
                           rules=dr.mesh_rules("pod16x16"))["memory"]
             ["temp_size_in_bytes"] for n in (4, 16)]
    assert 0 <= peaks[1] - peaks[0] <= 16 * 2 ** 20


def test_musicgen_served_on_16x16_counts_a_whole_cache():
    """musicgen-medium served as phase 12 serves it (4 x 1,500 frames + 32)
    on one rank of 16 x 16: its 24 KV heads and its 1,532 slots do not
    divide the model axis, so the cache lies whole on every rank (4 rows,
    replicated over the data ranks) and the prefill and decode step count
    without raising. The decode step runs no softmax combine: over "model"
    it all-reduces each block's two row-parallel sums and the embedding's
    (2L + 1), and all-gathers each block's KV columns, the codec head and
    the logits (L + 2)."""
    cfg = get_config("musicgen-medium")
    layers = cfg.n_layers
    shapes = {"prefill": (InputShape("serve", 1500, 4, "prefill"), 1532),
              "decode": (InputShape("serve", 1532, 4, "decode"), None)}
    recs = {kind: dr.count_step(cfg, shape, max_len=max_len,
                                rules=dr.mesh_rules("pod16x16"))
            for kind, (shape, max_len) in shapes.items()}
    calls = {(r["kind"], tuple(r["axes"])): r["calls"]
             for r in recs["decode"]["collective_calls"]}
    assert calls[("all-reduce", ("model",))] == 2 * layers + 1
    assert calls[("all-gather", ("model",))] == layers + 2
    whole = 2 * layers * 4 * 1532 * cfg.n_kv_heads * cfg.head_dim * 2
    assert recs["decode"]["memory"]["cache_size_in_bytes"] == whole
    assert recs["prefill"]["memory"]["temp_size_in_bytes"] >= whole


@pytest.mark.parametrize("mesh", ((1, 3), (2, 3)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_configs_count_where_three_divides_no_width(arch, mesh):
    """Every smoke config's prefill (61 tokens into 65 slots) and decode
    step (on 61 slots) count on a rank of a (data, 3) mesh, which divides
    none of their KV heads, cache slots, recurrent channels or inner
    widths."""
    cfg = get_smoke_config(arch)
    data, model = mesh
    for shape, max_len in ((InputShape("p", 61, 2 * data, "prefill"), 65),
                           (InputShape("p", 61, 2 * data, "decode"), None)):
        rules = sh.ShardingRules.default(sh.CountingMesh(
            {"data": data, "model": model}))
        rec = dr.count_step(cfg, shape, max_len=max_len, rules=rules)
        assert rec["collective_calls"], shape.kind


def test_plane_decode_needs_the_cache_capacity():
    """A cache that lies over its slots or whole on every rank has the same
    local shape for some capacities (5 slots whole, or 15 over 3 ranks):
    a decode step reads the layout from the cache's "cap", and raises
    without it."""
    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg)
    rules = sh.ShardingRules.default(sh.CountingMesh({"data": 1, "model": 3}))
    params = model.param_shapes(rules)
    batch = {"token": torch.zeros((2, 1), dtype=torch.int64, device="meta")}
    for cap in (5, 15):
        cache = model.init_cache(2, cap, device="meta", rules=rules)
        assert cache["cap"] == cap and cache["scan"][0]["k"].shape[2] == 5
        model.decode(params, cache, batch, rules=rules)
        cache.pop("cap")
        with pytest.raises(ValueError, match="capacity"):
            model.decode(params, cache, batch, rules=rules)


def test_flash_work_counts_the_keys_each_query_sees():
    """A prefill's attention is counted as its kernel's work: the causal
    triangle (and the window), not the plain version's S x L product."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), n_layers=1)
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=96,
                                global_batch=2)
    rec = dr.count_step(cfg, shape)
    k = rec["kernels"]["flash_attention_sm90"]
    flops, nbytes = rl.flash_attention_work(2, 96, 96, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.head_dim)
    assert k == {"launches": 1, "flops": flops, "bytes": nbytes}
    assert flops == 4 * cfg.head_dim * 2 * cfg.n_heads * (96 * 97 // 2)
    assert rl.flash_attention_work(1, 8, 8, 1, 1, 4, window=3)[0] == \
        4 * 4 * (1 + 2 + 3 * 6)


def test_roofline_terms_on_one_card():
    t = rl.RooflineTerms(flops=2 * 989e12, bytes_hbm=3.35e12,
                         flops_by_dtype={"bfloat16": 989e12,
                                         "float32": 67e12})
    assert t.t_compute == pytest.approx(2.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == 0.0 and t.chips == 1
    assert t.bottleneck == "compute"
    keys = set(jrl.RooflineTerms(1.0, 1.0, 0.0, 1).as_dict())
    assert keys <= set(t.as_dict())
    assert rl.bound_ms(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert rl.bound_ms(0, 495e9 / 3, "3xtf32") == (pytest.approx(1.0),
                                                  "operations")


def test_perf_variants_equal_the_reference():
    assert set(perf.VARIANTS) == set(jperf.VARIANTS)
    for arch in ("llama3.2-1b", "qwen2-moe-a2.7b"):
        for name, fn in perf.VARIANTS.items():
            _same_fields(fn(get_config(arch)),
                         jperf.VARIANTS[name](jget_config(arch)))


def test_perf_reports_the_variant_beside_the_baseline(tmp_path, capsys):
    recs = perf.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                      "--variant", "bf16_params", "--out", str(tmp_path)])
    assert set(recs) == {"baseline", "bf16_params"}
    # bf16 parameters halve the weights a decode step reads
    assert recs["bf16_params"]["t_memory_s"] < recs["baseline"]["t_memory_s"]
    out = capsys.readouterr().out
    assert "t_memory_s:" in out and "against the baseline's" in out
    assert len(list(tmp_path.iterdir())) == 2


def test_dryrun_main_writes_one_record(tmp_path):
    with pytest.raises(SystemExit) as e:
        dr.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--roofline", "--out", str(tmp_path)])
    assert e.value.code == 0
    (path,) = tmp_path.iterdir()
    assert path.name == "llama3.2-1b--long_500k--h100.json"


ONE_RANK, COUNTED = {"data": 1, "model": 1}, {"data": 2, "model": 2}


@pytest.mark.parametrize("kind,seq,meshes", [
    ("prefill", 40, (ONE_RANK, COUNTED)), ("train", 40, (ONE_RANK, COUNTED)),
    ("train", 200, (ONE_RANK,))])
def test_slstm_step_count_multiplied_equals_the_whole_loop(kind, seq,
                                                           meshes):
    """The smoke xlstm (one mLSTM, one sLSTM block) at batch 2 and ``seq``
    tokens, on one rank and on a counted (data 2, model 2) mesh: the count
    from the loop cut to 6 and 7 steps, one step multiplied out to S and
    the peak from the inner step's storages repeated, equals the count of
    all S steps in FLOPs, bytes, ops, peak and collectives. At 2 x 200 on
    one rank the train step's peak lies in the loop's backward, where a
    peak taken affine from 2- and 3-step counts falls short."""
    cfg = get_smoke_config("xlstm-125m")
    shape = InputShape("slstm", seq, 2, kind)
    for mesh in meshes:
        def rules():
            return sh.ShardingRules.default(sh.CountingMesh(mesh))
        whole = dr._count_once(cfg, shape, None, rules())
        cut = dr.count_step(cfg, shape, rules=rules())
        assert cut["slstm_steps"] == [6, 7]
        for key in ("cost", "memory", "ops", "kernels", "collectives",
                    "collective_calls"):
            assert cut[key] == whole[key], (mesh, key)


def test_dryrun_sweep_counts_every_recurrent_step(tmp_path, capsys,
                                                  monkeypatch):
    """``--all --both-meshes`` skips no recurrent config: here on the smoke
    xlstm and recurrentgemma (the sweep's loop, with the configs swapped
    for their smoke sizes and each shape cut to 4 x 64 tokens), every
    shape on both production meshes, the sLSTM's train and prefill counted
    at 6 and 7 steps."""
    monkeypatch.setattr(dr, "ARCH_IDS", ("xlstm-125m", "recurrentgemma-2b"))
    monkeypatch.setattr(dr, "get_config", get_smoke_config)
    monkeypatch.setattr(dr, "INPUT_SHAPES", {
        name: dataclasses.replace(shape, seq_len=64, global_batch=4)
        for name, shape in INPUT_SHAPES.items()})
    with pytest.raises(SystemExit) as e:
        dr.main(["--all", "--both-meshes", "--out", str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "[SKIP]" not in out and "failures: 0" in out
    assert out.count("[OK ]") == 2 * len(INPUT_SHAPES) * 2
