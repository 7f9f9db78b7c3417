"""Quickstart: the paper's full loop (mirrors ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--seed 0]

Builds an 8-client non-i.i.d. world (synthetic FMNIST stand-in, 100
training and 20 eval images a class, 3 circular classes a client), runs
PCA -> K-means++ -> RL graph discovery -> AE-gated D2D exchange, then trains
unsupervised FL (FedAvg, tau_a = 10, 200 iterations) on the raw and on the
exchanged data and prints the reconstruction-loss comparison and both
linear-evaluation accuracies (paper Figs. 3-5 in miniature). On the card
the clustering runs through ``kmeans_assign`` and the exchange gate through
``recon_gate``.

Every draw comes from one ``torch.Generator`` on the host, seeded
``--seed``, in this order: the world, the pipeline's draws in
``run_pipeline``'s own order (so the pipeline's result is the one
``run_pipeline`` gives with that generator), the FL model's initial
parameters, then one set of minibatch uniforms. The reference starts both
FL runs from one key; here both start from the same parameters and map the
same uniforms onto each dataset's sizes. A card run and a host run of one
seed take the same draws. ``main`` returns what it prints; its keyword
arguments shrink the run (the CPU test's sizes).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import channel as ch
from repro_torch.core import exchange as ex
from repro_torch.core import kmeans as km
from repro_torch.core import qlearning as ql
from repro_torch.core import trust as tr
from repro_torch.core.pipeline import (PipelineConfig, PipelineDraws,
                                       run_pipeline)
from repro_torch.data import fmnist_like_split, partition_by_classes
from repro_torch.fl import FLConfig, fl_train, linear_evaluation
from repro_torch.fl.trainer import batch_indices_from
from repro_torch.models.autoencoder import AEConfig, init_ae


def pipeline_draws(generator: torch.Generator, sizes, cfg: PipelineConfig,
                   ae_cfg) -> PipelineDraws:
    """Every draw of ``run_pipeline`` on clients of the given ``sizes``
    under the quickstart's config (the mixed RL policy, the host reserve
    selector), from ``generator`` in the order ``run_pipeline`` makes them
    (the post-exchange k-means++ picks when the run reaches them)."""
    n, k = len(sizes), cfg.n_clusters
    return PipelineDraws(
        cluster=km.draw_kmeans(generator, sizes, k),
        trust_u=tr.draw_trust_uniforms(generator, n, k),
        positions=ch.make_positions(generator, n, cfg.channel),
        fading=ch.init_fading(generator, n),
        rl=ql.draw_rl(generator, n, cfg.rl.n_episodes),
        exchange=ex.draw_exchange(generator, n, ae_cfg),
        cluster_after=lambda after: km.draw_kmeans(generator, after, k))


def main(argv=None, *, n_train_per_class=100, n_eval_per_class=20,
         n_episodes=400, total_iters=200, eval_every=50,
         linear_iters=1000) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    ae_cfg = AEConfig(28, 28, 1, widths=(8, 16), latent_dim=32)
    t0 = time.perf_counter()

    print("== building non-i.i.d. federated world (8 clients, 3 classes each)")
    ds, ev = fmnist_like_split(gen, n_train_per_class=n_train_per_class,
                               n_eval_per_class=n_eval_per_class)
    xs, ys, domains = partition_by_classes(args.seed, ds.images.numpy(),
                                           ds.labels.numpy(), n_clients=8,
                                           classes_per_client=3,
                                           circular=True)
    print("   client label domains:", domains)

    print("== smart information exchange (PCA + K-means++ + RL, Alg. 1-2)")
    cfg = PipelineConfig(rl=ql.RLConfig(n_episodes=n_episodes,
                                        buffer_size=50))
    sizes = [x.shape[0] for x in xs]
    res = run_pipeline(xs, ys, ae_cfg, cfg,
                       draws=pipeline_draws(gen, sizes, cfg, ae_cfg),
                       device=dev)
    n = len(xs)
    in_edge = res.in_edge.cpu().numpy()
    pf = res.p_fail.cpu().numpy()
    lam_before = float(res.lam_before.float().mean())
    lam_after = float(res.lam_after.float().mean())
    pd_chosen = float(pf[np.arange(n), in_edge].mean())
    pd_all = float(pf[pf < 1].mean())
    moved = res.moved_counts
    print(f"   discovered links (receiver <- transmitter): "
          f"{list(enumerate(in_edge.tolist()))}")
    print(f"   mean lambda before={lam_before:.3f} after={lam_after:.3f}  "
          f"(paper Fig. 3: drops)")
    print(f"   chosen-link P_D={pd_chosen:.4f} vs all-links mean="
          f"{pd_all:.4f}  (paper Fig. 4)")
    print(f"   datapoints received per client: {moved}")

    print("== unsupervised FL (FedAvg, tau_a=10), raw vs exchanged data")
    fl_cfg = FLConfig(total_iters=total_iters, tau_a=10,
                      eval_every=eval_every, batch_size=32)
    init = init_ae(gen, ae_cfg)
    u = torch.rand((total_iters // fl_cfg.tau_a, fl_cfg.tau_a, n,
                    fl_cfg.batch_size), generator=gen)
    raw_sizes = torch.as_tensor(sizes, device=dev)
    base = fl_train(xs, ae_cfg, fl_cfg, ev.images, init_params=init,
                    batch_idx=batch_indices_from(u, raw_sizes), device=dev)
    smart = fl_train(res.client_data, ae_cfg, fl_cfg, ev.images,
                     init_params=init,
                     batch_idx=batch_indices_from(u, res.client_data.sizes),
                     device=dev)
    rows = []
    for it, lb, ls in zip(base.eval_iters, base.eval_loss, smart.eval_loss):
        rows.append((int(it), float(lb), float(ls)))
        print(f"   iter {it:4d}  non-iid={lb:.5f}  smart-D2D={ls:.5f}")

    half = ev.images.shape[0] // 2
    split = (ev.images[:half], ev.labels[:half], ev.images[half:],
             ev.labels[half:])
    acc_b, _ = linear_evaluation(base.global_params, ae_cfg, *split,
                                 iters=linear_iters, device=dev)
    acc_s, _ = linear_evaluation(smart.global_params, ae_cfg, *split,
                                 iters=linear_iters, device=dev)
    print(f"== linear evaluation: non-iid={acc_b:.3f}  smart-D2D={acc_s:.3f}")
    print("done.")
    return {"domains": domains, "in_edge": in_edge.tolist(),
            "lam_before": lam_before, "lam_after": lam_after,
            "pd_chosen": pd_chosen, "pd_all": pd_all,
            "moved": moved.tolist(), "eval": rows, "acc_non_iid": acc_b,
            "acc_smart": acc_s, "seconds": time.perf_counter() - t0,
            "pipeline": res}


if __name__ == "__main__":
    main()
