"""The port's data layer: the partitioner is the reference's numpy code
(bitwise equal from the same seed); the synthetic generator draws from a
torch.Generator and matches the reference in kind (shapes, range, balance,
class structure), not in values."""
import jax
import numpy as np
import pytest
import torch

from repro.data.partition import partition_by_classes as j_partition
from repro.data.synthetic import make_split_dataset as j_split
from repro_torch.data import (fmnist_like_split, make_image_dataset,
                              make_split_dataset, partition_by_classes)


@pytest.mark.parametrize("circular", [True, False])
def test_partition_equals_reference(circular):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(300, 4, 4, 1)).astype(np.float32)
    labels = np.repeat(np.arange(10), 30).astype(np.int32)
    want = j_partition(3, images, labels, n_clients=7, classes_per_client=3,
                       circular=circular)
    got = partition_by_classes(3, images, labels, n_clients=7,
                               classes_per_client=3, circular=circular)
    assert want[2] == got[2]
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_array_equal(a, b)


def test_synthetic_matches_reference_in_kind():
    g = torch.Generator().manual_seed(0)
    tr, ev = make_split_dataset(g, n_train_per_class=20, n_eval_per_class=5,
                                height=12, width=12, channels=1)
    jtr, _ = j_split(jax.random.PRNGKey(0), n_train_per_class=20,
                     n_eval_per_class=5, height=12, width=12, channels=1)
    assert tuple(tr.images.shape) == tuple(jtr.images.shape) == (200, 12, 12,
                                                                 1)
    assert tuple(ev.images.shape) == (50, 12, 12, 1)
    assert float(tr.images.min()) > 0.0 and float(tr.images.max()) < 1.0
    # a prefix of the shuffled set: every class present, none dominant
    counts = torch.bincount(tr.labels, minlength=10)
    assert int(counts.sum()) == 200 and int(counts.min()) > 5
    # same pixel statistics in kind: sigmoid of a ~N(0, 2.5^2) field
    for imgs in (tr.images.numpy(), np.asarray(jtr.images)):
        assert 0.3 < imgs.mean() < 0.7 and 0.15 < imgs.std() < 0.45


def test_synthetic_classes_are_separable():
    g = torch.Generator().manual_seed(1)
    ds = make_image_dataset(g, n_per_class=30, height=8, width=8)
    x = ds.images.reshape(300, -1)
    means = torch.stack([x[ds.labels == c].mean(0) for c in range(10)])
    nearest = torch.cdist(x, means).argmin(1)
    assert float((nearest == ds.labels).float().mean()) > 0.9


def test_synthetic_is_seeded():
    a, _ = fmnist_like_split(torch.Generator().manual_seed(4), 3, 1)
    b, _ = fmnist_like_split(torch.Generator().manual_seed(4), 3, 1)
    assert torch.equal(a.images, b.images) and torch.equal(a.labels, b.labels)
    assert tuple(a.images.shape) == (30, 28, 28, 1)
