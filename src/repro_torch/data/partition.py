"""Non-i.i.d. federated partitioners (paper Sec. V setups).

A verbatim copy of ``repro.data.partition`` (pure numpy), kept in the port so
that the port imports nothing of the JAX package and partitions exactly as
the reference does from the same seed."""
from __future__ import annotations

import numpy as np


def partition_by_classes(rng_or_seed, images, labels, *, n_clients: int,
                         classes_per_client: int = 3, circular: bool = False,
                         samples_per_client: int | None = None):
    """Each client receives data from ``classes_per_client`` classes.

    circular=True reproduces the paper's Fig. 3 setup: client i's label
    domain is {i-1, i, i+1} mod n_classes.
    Returns (list of image arrays, list of label arrays, domains)."""
    rng = (np.random.default_rng(rng_or_seed)
           if isinstance(rng_or_seed, (int, np.integer)) else rng_or_seed)
    images = np.asarray(images)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    by_class = {c: np.flatnonzero(labels == c) for c in range(n_classes)}
    for c in by_class:
        rng.shuffle(by_class[c])
    cursors = {c: 0 for c in by_class}

    domains = []
    for i in range(n_clients):
        if circular:
            half = classes_per_client // 2
            dom = [(i - half + t) % n_classes for t in range(classes_per_client)]
        else:
            dom = rng.choice(n_classes, classes_per_client, replace=False).tolist()
        domains.append(dom)

    per_class_take = ((samples_per_client or
                       (len(labels) // n_clients)) // classes_per_client)
    out_x, out_y = [], []
    for dom in domains:
        idx = []
        for c in dom:
            pool = by_class[c]
            start = cursors[c]
            take = pool[start:start + per_class_take]
            if len(take) < per_class_take:  # wrap around (sufficient data asm.)
                take = np.concatenate([take, pool[:per_class_take - len(take)]])
                cursors[c] = per_class_take - len(take)
            else:
                cursors[c] = start + per_class_take
            idx.append(take)
        idx = np.concatenate(idx)
        rng.shuffle(idx)
        out_x.append(images[idx])
        out_y.append(labels[idx])
    return out_x, out_y, domains
