"""The port's numpy host codecs (weaviate_tpu_torch/native.py) against the
JAX package's native-library bindings, which take their numpy fallback
when ``WEAVIATE_TPU_NO_NATIVE`` is set and their C++ library otherwise:
the same sets and the same varint bytes either way."""

import numpy as np
import pytest

from weaviate_tpu import native as jnative
from weaviate_tpu_torch import native as tnative


@pytest.mark.parametrize("seed", range(4))
def test_sorted_set_algebra_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a = np.unique(rng.integers(0, 500, rng.integers(0, 80))).astype(np.uint64)
        b = np.unique(rng.integers(0, 500, rng.integers(0, 80))).astype(np.uint64)
        for name in ("union_sorted", "difference_sorted", "intersect_sorted"):
            got = getattr(tnative, name)(a, b)
            want = getattr(jnative, name)(a, b)
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, want)


def test_varint_codec_matches():
    rng = np.random.default_rng(9)
    for n in (0, 1, 16, 17, 500):
        vals = np.unique(rng.integers(0, 1 << 40, n)).astype(np.uint64)
        enc = tnative.varint_encode(vals)
        assert enc == jnative.varint_encode(vals)
        np.testing.assert_array_equal(tnative.varint_decode(enc, len(vals)), vals)
    with pytest.raises(ValueError):
        tnative.varint_decode(tnative.varint_encode(np.arange(3, dtype=np.uint64)), 2)


def test_merge_topk_host_matches():
    rng = np.random.default_rng(2)
    d = np.sort(rng.standard_normal((3, 6)).astype(np.float32), axis=1)
    ids = rng.integers(0, 50, (3, 6))
    ids[1, 4:] = -1
    for k in (1, 5, 20):
        td, ti = tnative.merge_topk_host(d, ids, k)
        jd, ji = jnative.merge_topk_host(d, ids, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    assert not tnative.available()
