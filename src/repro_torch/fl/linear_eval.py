"""Linear evaluation (paper Sec. V; mirrors ``repro.fl.linear_eval``): freeze
the global encoder, train a linear classifier on its standardised
embeddings by full-batch gradient descent, report accuracy. The reference's
``lax.scan`` over steps is a Python loop."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import autoencoder as ae
from repro_torch.models.common import tree_map, value_and_grad


def linear_evaluation(global_params, ae_cfg, train_x, train_y, test_x,
                      test_y, *, n_classes=10, iters=1000, lr=0.5,
                      weight_decay=1e-4, device="cuda"):
    """Returns (test_accuracy, train_accuracy) as floats."""
    dev = resolve_device(device)
    global_params = tree_map(lambda p: torch.as_tensor(p, device=dev),
                             global_params)
    train_x, test_x = (torch.as_tensor(a, device=dev)
                       for a in (train_x, test_x))
    train_y, test_y = (torch.as_tensor(a, device=dev).long()
                       for a in (train_y, test_y))
    with torch.no_grad():
        z_tr = ae.encode(global_params, train_x, ae_cfg)
        z_te = ae.encode(global_params, test_x, ae_cfg)
    mu = torch.mean(z_tr, 0)
    sd = torch.std(z_tr, 0, correction=0) + 1e-6
    z_tr = (z_tr - mu) / sd
    z_te = (z_te - mu) / sd

    def loss(wb):
        logp = torch.log_softmax(z_tr @ wb["w"] + wb["b"], dim=-1)
        nll = -torch.mean(torch.gather(logp, 1, train_y[:, None]))
        return nll + weight_decay * torch.sum(torch.square(wb["w"]))

    wb = {"w": z_tr.new_zeros((z_tr.shape[1], n_classes)),
          "b": z_tr.new_zeros((n_classes,))}
    for _ in range(iters):
        _, g = value_and_grad(loss, wb)
        wb = {k: wb[k] - lr * g[k] for k in wb}
    with torch.no_grad():
        acc_te = torch.mean((torch.argmax(z_te @ wb["w"] + wb["b"], 1)
                             == test_y).float())
        acc_tr = torch.mean((torch.argmax(z_tr @ wb["w"] + wb["b"], 1)
                             == train_y).float())
    return float(acc_te), float(acc_tr)
