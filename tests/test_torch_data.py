"""ray_tpu_torch.data's in-memory datasets against ray_tpu.data's
``batches_from_refs`` on the same blocks.

The JAX package's re-batching runs on plain blocks: ``refs_iter`` yields
each block itself and the ``api`` whose ``get`` is the identity stands in
for the object store, so no runtime starts. Batches must be equal bit for
bit (values, dtypes, order), with and without the local shuffle.
"""

import numpy as np
import pytest

from ray_tpu_torch.data import batches_from_blocks, from_blocks, from_numpy


class _Identity:
    @staticmethod
    def get(ref):
        return ref


def _blocks(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 3, n).astype(np.int32),
             "row": np.arange(n, dtype=np.int64) + 1000 * i}
            for i, n in enumerate(sizes)]


def _jax_batches(blocks, **kw):
    from ray_tpu.data.iterator import batches_from_refs

    return list(batches_from_refs(iter([(b, {}) for b in blocks]),
                                  _Identity(), batch_format="numpy", **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("sizes", [[5, 0, 17, 3, 11], [64], [1, 1, 1, 1]],
                         ids=["ragged", "one", "single_rows"])
@pytest.mark.parametrize("batch_size", [4, 7, 100, None])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [None, 16])
def test_iter_batches_matches_batches_from_refs(sizes, batch_size,
                                                drop_last, shuffle):
    blocks = _blocks(sizes)
    want = _jax_batches(blocks, batch_size=batch_size, drop_last=drop_last,
                        shuffle_buffer_size=shuffle, shuffle_seed=3)
    got = list(from_blocks(blocks).iter_batches(
        batch_size=batch_size, drop_last=drop_last,
        local_shuffle_buffer_size=shuffle, local_shuffle_seed=3))
    _assert_same(got, want)
    got = list(batches_from_blocks(blocks, batch_size=batch_size,
                                   drop_last=drop_last,
                                   shuffle_buffer_size=shuffle,
                                   shuffle_seed=3))
    _assert_same(got, want)


def test_rows_carry_across_blocks_and_the_seed_decides_the_order():
    blocks = _blocks([5, 0, 17, 3, 11])
    ds = from_blocks(blocks)
    assert ds.count() == 36 and ds.num_blocks() == 5
    plain = list(ds.iter_batches(batch_size=8))
    assert [len(b["row"]) for b in plain] == [8, 8, 8, 8, 4]
    assert np.array_equal(np.concatenate([b["row"] for b in plain]),
                          np.concatenate([b["row"] for b in blocks]))
    shuf = lambda s: list(ds.iter_batches(  # noqa: E731
        batch_size=8, local_shuffle_buffer_size=32, local_shuffle_seed=s))
    a, b, c = shuf(1), shuf(1), shuf(2)
    assert all(np.array_equal(x["row"], y["row"]) for x, y in zip(a, b))
    assert not all(np.array_equal(x["row"], y["row"]) for x, y in zip(a, c))
    # A shuffle permutes within each emitted batch only.
    for x, p in zip(a, plain):
        assert sorted(x["row"]) == sorted(p["row"])


def test_from_numpy_matches_ray_tpu_data():
    from ray_tpu.data.block import block_from_numpy

    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    for data in (arr, {"x": arr, "y": arr[:, 0].astype(np.int32)}):
        want = _jax_batches([block_from_numpy(data)], batch_size=4)
        _assert_same(list(from_numpy(data).iter_batches(batch_size=4)),
                     want)
