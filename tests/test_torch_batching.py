"""The port's ClientData stack against ``repro.core.batching``: the same
ragged lists give an exactly equal stack (tolerance: none, bitwise)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import batching as jb
from repro_torch.core import batching as tb


def _ragged(seed=0, sizes=(5, 9, 3, 7)):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(s, 4, 4, 1)).astype(np.float32) for s in sizes]
    ys = [rng.integers(0, 10, size=s).astype(np.int32) for s in sizes]
    return xs, ys


@pytest.mark.parametrize("cap", [None, 12])
def test_stack_equals_reference_bitwise(cap):
    xs, ys = _ragged()
    want = jb.client_data_from_lists(xs, ys, cap=cap)
    got = tb.client_data_from_lists(xs, ys, cap=cap)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    np.testing.assert_array_equal(got.mask().numpy(), np.asarray(want.mask()))
    assert got.cap == want.cap and got.n_clients == 4


def test_round_trip_and_mask():
    xs, ys = _ragged(1)
    cd = tb.as_client_data(xs, ys)
    for a, b in zip(cd.data_list(), xs):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(cd.label_list(), ys):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        tb.valid_mask(cd.sizes, cd.cap).numpy(),
        np.asarray(jb.valid_mask(np.asarray(cd.sizes), cd.cap)))


def test_as_client_data_passes_stacks_through():
    xs, ys = _ragged(2)
    cd = tb.as_client_data(xs, ys)
    assert tb.as_client_data(cd) is not None
    assert torch.equal(tb.as_client_data(cd).data, cd.data)
    with pytest.raises(ValueError):
        tb.as_client_data(cd, labels=ys)
    with pytest.raises(ValueError):
        tb.client_data_from_lists(xs, cap=3)


def test_stack_unstack_pytrees():
    rng = np.random.default_rng(3)
    trees = [{"a": rng.normal(size=(2, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=4).astype(np.float32)}}
             for _ in range(3)]
    want = jb.stack_pytrees([jax.tree.map(np.asarray, t) for t in trees])
    got = tb.stack_pytrees([{"a": torch.as_tensor(t["a"]),
                             "b": {"c": torch.as_tensor(t["b"]["c"])}}
                            for t in trees])
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    back = tb.unstack_pytree(got, 3)
    np.testing.assert_array_equal(back[1]["a"].numpy(), trees[1]["a"])
