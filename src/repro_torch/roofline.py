"""Three-term roofline of one step on one H100 (mirrors ``repro.roofline``,
retargeted from a TPU v5e pod to one card).

Terms (seconds, per training/serving step):

    compute    = sum over operand dtypes of FLOPs(dtype) / PEAK_FLOPS[dtype]
    memory     = bytes / HBM_BW
    collective = sum over one device's collectives of the bytes a ring
                 sends per device / the link rate of its mesh axes
                 (:func:`collective_seconds`); 0 on one card

The constants are the H100 SXM datasheet's dense peaks, not measurements.
The link rates are those of H100 SXM servers: NVLink 4 between the 8 GPUs
of one HGX H100 node (900 GB/s both ways, 450 GB/s each way, per GPU:
NVIDIA H100 datasheet) and one 400 Gb/s NDR network port per GPU across
nodes (50 GB/s each way: the DGX H100 user guide's ConnectX-7 ports). A
production mesh (16 x 16, 2 x 16 x 16) lays its ranks out row-major, the
model axis innermost, 8 to a node; a collective whose ranks span nodes
runs at the network rate.
A float32 product runs on the CUDA cores (the port turns TF32 off), a bf16
one on the tensor cores; ``"3xtf32"`` is float32 work done as three tf32
tensor-core products (the float32 flash kernel), a third of the tf32 rate.

The reference lowers each step at two shallow depths and extrapolates,
because XLA's cost analysis counts a scanned layer once, and it reads the
collective bytes out of the HLO text. The port runs its layers eagerly, so
``launch.dryrun`` counts every layer as it runs, and on a production mesh
each collective records its own bytes (``sharding.CountingMesh``):
``extrapolate``, ``parse_collective_bytes`` and ``_shape_bytes`` have no
counterpart here. No TPU rate is kept: the reference's collective term
uses the TPU's ICI links.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

# --- H100 SXM datasheet constants ---
HBM_BW = 3.35e12                      # bytes/s, device memory
NVLINK_BW = 450e9                     # bytes/s each way per GPU, in a node
NET_BW = 50e9                         # bytes/s each way per GPU, across nodes
GPUS_PER_NODE = 8
PEAK_FLOPS = {                        # dense FLOP/s by operand dtype
    "float32": 67e12,                 # CUDA cores
    "float64": 67e12,                 # tensor cores
    "tf32": 495e12,
    "3xtf32": 495e12 / 3,
    "bfloat16": 989e12,
    "float16": 989e12,
}


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # whole step
    bytes_hbm: float           # whole step
    bytes_collective: float = 0.0
    chips: int = 1
    model_flops: float = 0.0   # 6*N*D (or 6*N_active*D) analytic
    flops_analytic: float = 0.0
    # FLOPs by operand dtype (keys of PEAK_FLOPS); None: all of them bf16
    flops_by_dtype: Optional[Dict[str, float]] = None
    collective_s: float = 0.0  # collective_seconds of the same step

    @property
    def t_compute(self) -> float:
        by = self.flops_by_dtype or {"bfloat16": self.flops}
        return sum(f / PEAK_FLOPS[d] for d, f in by.items()) / self.chips

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "flops_analytic": self.flops_analytic,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "flops_by_dtype": dict(self.flops_by_dtype or {}),
        }


def _group_ranks(mesh: Dict[str, int], axes) -> list:
    """The global ranks of the group over ``axes`` that holds rank 0 of a
    row-major mesh."""
    names = list(mesh)
    strides, acc = {}, 1
    for n in reversed(names):
        strides[n] = acc
        acc *= mesh[n]
    ranks = [0]
    for a in axes:
        ranks = [r + i * strides[a] for r in ranks for i in range(mesh[a])]
    return ranks


def link_rate(mesh: Dict[str, int], axes) -> float:
    """Bytes/s each way per GPU for a collective over ``axes``: NVLink when
    its ranks lie in one node, else the network."""
    nodes = {r // GPUS_PER_NODE for r in _group_ranks(mesh, axes)}
    return NVLINK_BW if len(nodes) == 1 else NET_BW


def wire_bytes(kind: str, n: int, nbytes: float) -> float:
    """Bytes one device sends in a ring collective over ``n`` ranks whose
    result is ``nbytes``: an all-gather (n-1)/n of it, a reduce-scatter
    (n-1) times it (its input is n results), an all-reduce 2 (n-1)/n of
    it; an all-to-all (n-1)/n."""
    if n <= 1:
        return 0.0
    if kind == "reduce-scatter":
        return (n - 1) * nbytes
    if kind == "all-reduce":
        return 2 * (n - 1) / n * nbytes
    return (n - 1) / n * nbytes


def collective_seconds(summary, mesh: Dict[str, int]) -> float:
    """The collective term of one device's step: ``summary`` is
    ``sharding.CountingMesh.summary()`` ([{kind, axes, calls, bytes}]).
    The MoE plane's router gather (``ModelPlane.replicate``) and choice
    counts (``gather_counts``) record as all-gathers, whose ring moves
    (n-1)/n of the result whatever the backward does."""
    t = 0.0
    for row in summary:
        n = math.prod(mesh[a] for a in row["axes"])
        t += wire_bytes(row["kind"], n, row["bytes"]) / \
            link_rate(mesh, row["axes"])
    return t


def bound_ms(bytes_moved: float, flops: float, dtype: str = "float32"):
    """The least time the card takes for work that moves ``bytes_moved``
    and does ``flops`` on ``dtype`` operands: (ms, "bytes" or
    "operations"), whichever term is larger."""
    t = RooflineTerms(flops=flops, bytes_hbm=bytes_moved,
                      flops_by_dtype={dtype: flops})
    t_bytes, t_ops = t.t_memory * 1e3, t.t_compute * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_attention_work(b: int, s: int, lk: int, h: int, kv: int, hd: int,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, itemsize: int = 2):
    """The flash kernels' work for q (b, s, h, hd), k/v (b, lk, kv, hd):
    (flops, bytes). The flops count the keys each query sees (query i at
    position i + q_offset sees key j when j <= i + q_offset under
    ``causal`` and i + q_offset - j < ``window``), 4 hd a key (two
    products); the bytes are q, k and v read once and the output written
    once."""
    visible = 0
    for i in range(s):
        p = i + q_offset
        lo = max(0, p - window + 1) if window is not None else 0
        hi = min(lk - 1, p) if causal else lk - 1
        visible += max(0, hi - lo + 1)
    return (4 * hd * b * h * visible,
            itemsize * (2 * b * s * h * hd + 2 * b * lk * kv * hd))


# ---------------------------------------------------------------------------
# analytic FLOPs models
# ---------------------------------------------------------------------------

def model_flops(cfg, n_params_active: int, shape, *, backward: bool) -> float:
    """The classic 6*N*D estimate (3x matmul passes in backward) plus the
    quadratic attention term where applicable.

    N excludes the input embedding table (a lookup, not a matmul); the
    caller passes active (not total) params for MoE."""
    n_params_active = n_params_active - cfg.vocab_size * cfg.d_model * \
        max(cfg.n_codebooks, 1)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if backward else 2.0
    base = mult * n_params_active * tokens
    # attention score/value flops: 2 * 2 * B * S * L_ctx * H * hd per layer
    attn_flops = 0.0
    kinds = cfg.layer_kinds
    for kind in kinds:
        if kind not in ("attn", "local_attn"):
            continue
        if shape.kind == "decode":
            ctx = min(shape.seq_len, cfg.local_window if kind == "local_attn"
                      else (cfg.window if cfg.attention == "sliding"
                            else shape.seq_len))
            s_q = 1
        else:
            win = (cfg.local_window if kind == "local_attn"
                   else (cfg.window if cfg.attention == "sliding" else None))
            ctx = min(shape.seq_len, win) if win else shape.seq_len / 2
            s_q = shape.seq_len
        attn_flops += (2 * 2 * shape.global_batch * s_q * ctx
                       * cfg.n_heads * cfg.head_dim) * (3 if backward else 1)
    return base + attn_flops


def train_step_flops(model, b: int, s: int):
    """(active parameters, the FLOPs of one port training step at b x s
    positions as it runs): 6 N_active per token (forward and backward),
    one more forward of the blocks (block remat, so N_active less the
    embedding, final norm and head), and each attention layer's two
    products over the full S x L scores (the plain and chunked routes
    compute every entry), forward, backward and the remat forward. The
    analytic cross-check of ``launch.dryrun``'s count of a train step."""
    from repro_torch.models.common import tree_leaves
    cfg = model.cfg
    n = model.n_active_params()
    outer = sum(math.prod(sp.shape) for sp in tree_leaves(
        (model.specs["embed"], model.specs["head"],
         model.specs["final_norm"])))
    tokens = b * s
    n_attn = sum(kind in ("attn", "local_attn") for kind in cfg.layer_kinds)
    attn = 4 * b * s * s * cfg.n_heads * cfg.head_dim * n_attn
    return n, 6 * n * tokens + 2 * (n - outer) * tokens + 4 * attn
