"""Perf-iteration harness (mirrors ``repro.launch.perf``): apply a named
variant to an (arch, shape) pair, count the step on one H100 with
``launch.dryrun`` and report the three roofline terms next to the
baseline's.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-8b \\
        --shape train_4k --variant bf16_params

Variants are the hypothesis->change->measure loop's "change" step; each one
is a pure config transformation so baselines stay reproducible. The four
variants that set ``act_seq_shard`` (``seq_shard``, ``seq_bf16_logits``,
``moe_gather_seq``, ``moe_gather_grouped_seq``) are counted, with their
baseline, on one rank of the 16 x 16 production mesh (``MESH_VARIANTS``),
where the flag acts; the two MoE ones on the model plane's MoE layout
(experts or their d_ff over "model", the router whole on every rank).
"""
import argparse
import dataclasses
import json
import os

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.dryrun import count_step, mesh_rules, roofline_record


def v_baseline(cfg):
    return cfg


def v_bf16_params(cfg):
    """Store parameters in bf16 (the AdamW moments follow them: both
    packages' ``init_opt_state`` zeros them like the parameters): halves
    parameter memory and traffic."""
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def v_moe_fine_groups(cfg):
    """Shrink MoE dispatch groups from one-per-batch-row to 512-token
    groups: the GShard one-hot dispatch tensor is O(T^2 k cf / (G E)) —
    finer groups cut it quadratically."""
    return dataclasses.replace(cfg, moe_group_size=512)


def v_moe_gather(cfg):
    """Sort/gather-based MoE dispatch (no (T,E,C) one-hot at all)."""
    return dataclasses.replace(cfg, moe_dispatch="gather")


def v_seq_shard(cfg):
    """Sequence-parallel activations between units (reduce-scatter and
    all-gather along S in place of the model axis's all-reduces)."""
    return dataclasses.replace(cfg, act_seq_shard=True)


def v_bf16_logits(cfg):
    """bf16 LM-head logits (CE still reduces in f32): halves the single
    largest activation tensor of large-vocab training steps."""
    return dataclasses.replace(cfg, logits_dtype="bfloat16")


def v_bf16_all(cfg):
    """Stack bf16 params + bf16 logits."""
    return v_bf16_logits(v_bf16_params(cfg))


VARIANTS = {
    "baseline": v_baseline,
    "bf16_params": v_bf16_params,
    "bf16_logits": v_bf16_logits,
    "bf16_all": v_bf16_all,
    "moe_fine_groups": v_moe_fine_groups,
    "moe_gather": v_moe_gather,
    # group-local argsort: each 4,096-token group sorts its own choices
    "moe_gather_grouped": lambda cfg: v_moe_gather(
        dataclasses.replace(cfg, moe_group_size=4096)),
    "moe_gather_seq": lambda cfg: v_seq_shard(v_moe_gather(cfg)),
    "moe_gather_grouped_seq": lambda cfg: v_seq_shard(v_moe_gather(
        dataclasses.replace(cfg, moe_group_size=4096))),
    "seq_shard": v_seq_shard,
    "seq_bf16_logits": lambda cfg: v_bf16_logits(v_seq_shard(cfg)),
}
# variants counted on a production mesh, with their baseline
MESH_VARIANTS = {"seq_shard": "pod16x16", "seq_bf16_logits": "pod16x16",
                 "moe_gather_seq": "pod16x16",
                 "moe_gather_grouped_seq": "pod16x16"}


def run(arch, shape_name, variant, out_dir="runs/perf_torch",
        mesh: str = "h100"):
    shape = INPUT_SHAPES[shape_name]
    cfg = sp.shape_config(get_config(arch), shape)
    cfg = VARIANTS[variant](cfg)
    full_rec = count_step(cfg, shape, rules=mesh_rules(mesh))
    rec = roofline_record(cfg, shape, full_rec)
    rec.update(arch=arch, shape=shape_name, variant=variant, mesh=mesh,
               memory=full_rec["memory"], count_s=full_rec["count_s"])
    if "collectives" in full_rec:
        rec["collectives"] = full_rec["collectives"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(
            out_dir, f"{arch}--{shape_name}--{variant}--{mesh}.json"),
            "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"{arch} {shape_name} {variant} ({mesh}): "
          f"t_comp={rec['t_compute_s']:.4g}s t_mem={rec['t_memory_s']:.4g}s "
          f"t_coll={rec['t_collective_s']:.4g}s -> {rec['bottleneck']}; "
          f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--out", default="runs/perf_torch")
    args = ap.parse_args(argv)
    mesh = MESH_VARIANTS.get(args.variant, "h100")
    recs = {v: run(args.arch, args.shape, v, args.out, mesh)
            for v in dict.fromkeys(("baseline", args.variant))}
    base, var = recs["baseline"], recs[args.variant]
    for term in ("t_compute_s", "t_memory_s") + (
            ("t_collective_s",) if mesh != "h100" else ()):
        print(f"{term}: {var[term]:.4g} s against the baseline's "
              f"{base[term]:.4g} s ({var[term] / base[term]:.3f}x)")
    return recs


if __name__ == "__main__":
    main()
