"""Dry run of every (architecture x input shape) step for one H100, and of
one rank's step on the reference's production meshes (mirrors
``repro.launch.dryrun``, which lowers and compiles each step for the
16 x 16 and 2 x 16 x 16 TPU meshes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--roofline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --both-meshes --roofline           # or --multi-pod: 2 x 16 x 16 only

Each step is the one the reference lowers (``build_step``): a train step
(``make_train_step`` with ``TrainConfig()``, AdamW state from
``init_opt_state``, parameters and moments written in place: the
reference's ``donate_argnums``), a prefill (``model.prefill`` on the flash
route that ``launch.serve`` takes) or a decode step (``model.decode`` on
``Model.init_cache``). It runs once at the full production shape
(``INPUT_SHAPES``) on ``meta`` tensors, which hold no memory, under
:class:`StepCounter`, which records per combination into
``runs/dryrun_torch/<arch>--<shape>--h100.json``:

  * ``cost``: FLOPs by operand dtype (``torch.utils.flop_counter``'s
    formulas, the ones ``FlopCounterMode`` applies) and the bytes each op
    reads and writes (the counterpart of XLA's ``cost_analysis``);
  * ``memory``: argument, output and aliased-output bytes, and the peak of
    live bytes above the arguments (each output's storage tracked until its
    last tensor dies: the counterpart of ``temp_size_in_bytes``);
  * ``kernels``: the hand kernels' launches and work. The kernels launch
    outside the dispatcher, so on meta tensors the flash wrapper reports
    its kernel's own work (the keys each query sees: ``kernels.ops``) in
    place of the plain version's S x L product;
  * with ``--roofline`` the three roofline terms (``repro_torch.roofline``).

One card's step is the launchers' (``launch.train``, ``launch.serve``):
under the rules of a one-rank (data, model) mesh, whose collectives are
the identity (no copy, nothing recorded), so the counted bytes and peak
are the card's.

On a production mesh (``--multi-pod``: pod 2 x data 16 x model 16;
``--both-meshes``: that and data 16 x model 16) the step is one rank's,
under ``ShardingRules.default`` of a ``sharding.CountingMesh``: the
parameters, AdamW moments, batch and cache are meta tensors of that rank's
shard shapes (the reference's ``build_lowerable`` placements), and each
collective of the model plane records its kind, mesh axes and result bytes
instead of running; the record, ``<arch>--<shape>--pod16x16.json`` or
``--pod2x16x16.json``, adds ``collectives`` (bytes by the reference's
kinds), ``collective_calls`` (per kind and axes) and, with ``--roofline``,
the collective term (``roofline.collective_seconds``). Every family runs
on the model plane: the dense, MoE, recurrent, vision-stub and
audio-codec configs.

The count runs the port's Python as a real step does, op by op: the layers
and the chunked attention's loop, so every layer is counted. It takes
seconds a step. The sLSTM's loop over time is the one exception: run op by
op it took 969 s to count at train_4k (4,096 steps forward and backward)
and 1,513 s at prefill_32k, so :func:`count_step` counts it cut to 6 and
to 7 steps (:func:`slstm_steps`) and multiplies one step's work (their
difference) out to S; the peak comes from the 7-step count, in which the
storages that one inner step keeps stand for those of the S - 7 steps cut
(``tests/test_torch_dryrun.py`` holds both equal to the whole loop's count
at small shapes, one of them with the peak inside the loop).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import optim
from repro_torch import roofline as rl
from repro_torch import sharding as sh
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, TrainConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.registry import build_model, make_train_step

# the meshes a record can be for: one card is the launchers' one-rank
# (data, model) mesh (``launch.mesh.host_rules``)
MESHES = {"h100": {"data": 1, "model": 1},
          "pod16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True)}

# ops that allocate without writing
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_like,
            torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
            torch.ops.aten.new_empty_strided}
# in-place ops that overwrite their target without reading it
_OVERWRITE = {torch.ops.aten.copy_, torch.ops.aten.fill_,
              torch.ops.aten.zero_}


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` addresses (a broadcast dimension,
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts one step's work op by op as it runs (on meta tensors at full
    size): FLOPs by operand dtype, bytes read and written, and the live
    bytes above the arguments ``args``, whose storages it never counts.

    An op reads its tensor inputs and writes its outputs; an in-place op
    reads and writes its target (``copy_``, ``fill_`` and ``zero_`` only
    write it), an ``out=`` op writes ``out``; a view moves nothing. Each
    output's storage is live from its first tensor until its last tensor
    dies. ``kernel`` takes the work of a hand kernel from its wrapper."""

    def __init__(self, args):
        super().__init__()
        self.arg_keys = {_storage_key(t) for t in _tensors(args)}
        self.flops_by_dtype = collections.Counter()
        self.bytes_read = 0
        self.bytes_written = 0
        self.kernels = {}
        self.live = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_ops = 0
        self._paused = False

    def __enter__(self):
        ops.DRY_RUN_COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.DRY_RUN_COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            first = _tensors(args)[0]
            self.flops_by_dtype[str(first.dtype).split(".")[-1]] += \
                formula(*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_DATA:
            skip = set()
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                val = (kwargs.get(a.name) if a.kwarg_only or i >= len(args)
                       else args[i])
                if a.name != "self" or packet in _OVERWRITE:
                    skip.update(id(t) for t in _tensors(val))
            self.bytes_read += sum(_distinct_bytes(t) for t in
                                   _tensors((args, kwargs))
                                   if id(t) not in skip)
            self.bytes_written += sum(_distinct_bytes(t)
                                      for t in _tensors(out))
        for t in _tensors(out):
            self.track(t)
        return out

    def track(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage live until its last tensor dies."""
        key = _storage_key(t)
        if key in self.arg_keys:
            return
        if key in self.live:
            self.live[key][1] += 1
        else:
            nbytes = t.untyped_storage().nbytes()
            self.live[key] = [nbytes, 1]
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def repeat(self, entries: dict, k: int) -> None:
        """Counts each storage of ``entries`` (``live``'s items when they
        were made) that is still live as ``k`` more copies of itself, until
        it dies."""
        for key, entry in entries.items():
            if self.live.get(key) is entry:
                self.live_bytes += k * entry[0]
                entry[0] *= k + 1
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def kernel(self, name: str, dtype: str, flops: int, nbytes: int, plain):
        """A hand kernel's launch on meta tensors: its ``flops`` (on
        ``dtype`` operands) and ``nbytes`` counted, ``plain()`` run for the
        output's shape and not counted, the output tracked as the kernel's
        allocation."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops_by_dtype[dtype] += flops
        self.bytes_read += nbytes
        self._paused = True
        try:
            out = plain()
        finally:
            self._paused = False
        self.track(out)
        return out


def build_step(cfg, shape, *, max_len=None, rules=None):
    """Returns (fn, args): the step the shape exercises and its arguments
    as meta tensors, one rank's shards under ``rules``. ``max_len`` sets a
    prefill's cache capacity (the prompt's length by default, as in the
    reference)."""
    model = build_model(cfg)
    params = model.param_shapes(rules)
    batch = sp.input_specs(cfg, shape, rules)
    rows = shape.global_batch
    if shape.kind == "train":
        tc = TrainConfig()
        state = optim.init_opt_state(params, tc.optimizer)
        step = make_train_step(model, tc, donate=True, rules=rules)
        return (lambda p, o, b: step(p, o, b, global_batch=rows)), \
            (params, state, batch)
    if shape.kind == "prefill":
        return (lambda p, b: model.prefill(p, b, max_len=max_len,
                                           use_flash=True, rules=rules,
                                           global_batch=rows)), \
            (params, batch)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta", rules=rules)
    return (lambda p, c, b: model.decode(p, c, b, rules=rules,
                                         global_batch=rows)), \
        (params, cache, batch)


def mesh_rules(mesh_name: str):
    """``ShardingRules.default`` over a fresh :class:`sh.CountingMesh` of
    the named mesh (``MESHES``)."""
    return sh.ShardingRules.default(sh.CountingMesh(MESHES[mesh_name]))


def count_step(cfg, shape, *, max_len=None, rules=None) -> dict:
    """Runs the step once on meta tensors under :class:`StepCounter`;
    returns its record (``memory``, ``cost``, ``kernels``, ``count_s``;
    on a counting mesh also ``collectives`` and ``collective_calls``).

    An sLSTM config's train or prefill step (whose loop over time would
    run S steps op by op) is counted twice, with the loop cut to 6 and to
    7 steps (:func:`slstm_steps`). The work (FLOPs, bytes, ops, kernels,
    collectives) is affine in the steps run, so the second count less the
    first is one step's, and the record takes the first plus S - 6 steps.
    A peak is a max, not affine: ``memory`` is the 7-step count's, in
    which the storages of one inner step that the loop keeps count as the
    S - 7 steps' the cut leaves out (``slstm_steps``: [6, 7])."""
    s = shape.seq_len
    if "slstm" not in cfg.layer_kinds or shape.kind == "decode" or s <= 7:
        return _count_once(cfg, shape, max_len, rules)
    fresh = rules if rules is None or not isinstance(
        rules.mesh, sh.CountingMesh) else \
        sh.ShardingRules(sh.CountingMesh(dict(rules.mesh)), rules.rules)
    with slstm_steps(6):
        six = _count_once(cfg, shape, max_len, fresh)
    with slstm_steps(7):
        seven = _count_once(cfg, shape, max_len, rules)
    rec = _affine(six, seven, s - 6)
    rec["memory"] = seven["memory"]
    rec["count_s"] = six["count_s"] + seven["count_s"]
    rec["slstm_steps"] = [6, 7]
    return rec


@contextlib.contextmanager
def slstm_steps(n: int):
    """Within it, ``xlstm.slstm_sequence`` runs ``n`` (at least 5) steps of
    its loop over S, the rest of its output standing in without a
    gradient, and the active :class:`StepCounter` counts the storages of
    the third step that are still live at the end of the step before the
    last as S - n more copies: those of the steps the cut leaves out.
    The steps away from the loop's ends are alike (the first step's state
    needs no gradient, and a storage made in a step that the loop does not
    keep dies within two steps), so from then on the live bytes are the
    whole loop's at its end, forward and backward. The steps' ops are
    alike, so the work counted is affine in ``n``."""
    plain = xlstm_lib.slstm_sequence

    def cut(x, state, p, n_heads, wx=None):
        if wx is None:
            wx = xlstm_lib._input_gates(x, p)
        s = x.shape[1]
        counter = ops.DRY_RUN_COUNTERS[-1]
        hs = []
        for t in range(min(n, s)):
            if t == 2:
                before = dict(counter.live)
            state, h = xlstm_lib.slstm_step(None, state, p, n_heads,
                                            wx[:, t])
            hs.append(h)
            if t == 2:
                third = {k: e for k, e in counter.live.items()
                         if before.get(k) is not e}
            elif t == n - 2:
                counter.repeat(third, s - n)
        counter._paused = True          # an op the whole loop does not run
        rest = [hs[-1].detach()] * (s - len(hs))
        counter._paused = False
        return torch.stack(hs + rest, dim=1), state
    xlstm_lib.slstm_sequence = cut
    try:
        yield
    finally:
        xlstm_lib.slstm_sequence = plain


def _affine(a, b, k):
    """a + k (b - a) leaf by leaf over two records of the same layout."""
    if isinstance(a, dict):
        return {key: _affine(a[key], b[key], k) for key in a}
    if isinstance(a, list):
        return [_affine(x, y, k) for x, y in zip(a, b)]
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return a + k * (b - a)
    return a


def _count_once(cfg, shape, max_len, rules) -> dict:
    fn, args = build_step(cfg, shape, max_len=max_len, rules=rules)
    arg_bytes = tree_bytes(args)
    counter = StepCounter(args)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    secs = time.perf_counter() - t0
    outs = _tensors(out)
    arg_keys = counter.arg_keys
    del out
    flops = sum(counter.flops_by_dtype.values())
    rec = {
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": tree_bytes(outs),
            "alias_size_in_bytes": tree_bytes(
                [t for t in outs if _storage_key(t) in arg_keys]),
            "temp_size_in_bytes": counter.peak_bytes,
        },
        "cost": {"flops": float(flops),
                 "bytes": float(counter.bytes_read + counter.bytes_written),
                 "flops_by_dtype": {k: float(v) for k, v in
                                    counter.flops_by_dtype.items()}},
        "kernels": counter.kernels,
        "ops": counter.n_ops,
        "count_s": secs,
    }
    if shape.kind == "decode":
        rec["memory"]["cache_size_in_bytes"] = tree_bytes(args[1])
    if rules is not None:
        rec["mesh_shape"] = dict(rules.shape)
        rec["collectives"] = rules.mesh.by_kind()
        rec["collective_calls"] = rules.mesh.summary()
    return rec


def roofline_record(cfg, shape, rec: dict) -> dict:
    """The roofline terms of a :func:`count_step` record: the counted FLOPs
    and bytes on one card (on a mesh, one device's, with the collective
    term of the record's mesh), beside ``model_flops`` (and, for a train
    step, ``train_step_flops``: the step as it runs, analytically), both
    for the whole step."""
    model = build_model(cfg)
    train = shape.kind == "train"
    analytic = (rl.train_step_flops(model, shape.global_batch,
                                    shape.seq_len)[1] if train else 0.0)
    coll = rec.get("collective_calls", [])
    terms = rl.RooflineTerms(
        flops=rec["cost"]["flops"], bytes_hbm=rec["cost"]["bytes"],
        flops_by_dtype=rec["cost"]["flops_by_dtype"], chips=1,
        bytes_collective=float(sum(r["bytes"] for r in coll)),
        collective_s=rl.collective_seconds(coll, rec["mesh_shape"])
        if coll else 0.0,
        model_flops=rl.model_flops(cfg, model.n_active_params(), shape,
                                   backward=train),
        flops_analytic=float(analytic))
    return terms.as_dict()


def run_one(arch: str, shape_name: str, out_dir: str, do_roofline: bool,
            mesh_name: str = "h100") -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = sp.shape_config(get_config(arch), shape)
    mesh = MESHES[mesh_name]
    chips = math.prod(mesh.values())
    rec = {"arch": arch, "shape": shape_name, "device": "h100",
           "mesh": mesh_name, "chips": chips, "status": "ok"}
    try:
        rules = mesh_rules(mesh_name)
        rec.update(count_step(cfg, shape, rules=rules))
        if do_roofline:
            rec["roofline"] = roofline_record(cfg, shape, rec)
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}--{shape_name}--{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    flag = "OK " if rec["status"] == "ok" else "FAIL"
    extra = ""
    if rec["status"] == "ok":
        per = "/dev" if chips > 1 else ""
        extra = (f" flops{per}={rec['cost']['flops']:.4g}"
                 f" bytes{per}={rec['cost']['bytes']:.4g}"
                 f" args{per}={rec['memory']['argument_size_in_bytes']:.4g}B"
                 f" temp={rec['memory']['temp_size_in_bytes']:.4g}B")
        if chips > 1:
            extra += f" coll={sum(rec['collectives'].values()):.4g}B"
        extra += f" count={rec['count_s']:.1f}s"
        if do_roofline:
            r = rec["roofline"]
            extra += (f" t_comp={r['t_compute_s']:.4g}s"
                      f" t_mem={r['t_memory_s']:.4g}s")
            if chips > 1:
                extra += f" t_coll={r['t_collective_s']:.4g}s"
            extra += f" -> {r['bottleneck']}"
    print(f"[{flag}] {arch:22s} {shape_name:12s} {mesh_name}{extra}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="one rank of the 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="one rank of the 16 x 16 and the 2 x 16 x 16 mesh")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["pod16x16", "pod2x16x16"] if args.both_meshes else
              ["pod2x16x16"] if args.multi_pod else ["h100"])

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = run_one(arch, shape, args.out, args.roofline, mesh)
                n_fail += rec["status"] != "ok"
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
