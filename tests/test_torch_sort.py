"""Port parity: ``ops/sort.py``'s LSD radix sort against the JAX package's.

The same seeded int32 keys go through both; sorted keys and permutations
are integers, held equal exactly (the permutation is the stable argsort's,
duplicates included).  Key bits at and beside digit boundaries, one-bit
and eight-bit digits, and every ``ValueError`` of the JAX module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_semantic_segmentation_tpu.ops import sort as j_sort
from vision_semantic_segmentation_tpu_torch.ops.sort import radix_sort, radix_sort_with_perm

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _keys(seed: int, n: int, key_bits: int, dup_pool: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dup_pool:  # few distinct values: long runs of duplicates
        pool = rng.integers(0, 1 << key_bits, dup_pool)
        return pool[rng.integers(0, dup_pool, n)].astype(np.int32)
    return rng.integers(0, 1 << key_bits, n).astype(np.int32)


@pytest.mark.parametrize("key_bits,digit_bits", [
    (4, 4), (8, 4), (9, 4), (12, 4), (16, 4), (26, 4), (7, 1), (16, 8), (17, 8), (25, 3),
])
def test_equal_to_jax(key_bits, digit_bits):
    keys = _keys(key_bits, 3000, key_bits)
    got = radix_sort(torch.from_numpy(keys), key_bits, digit_bits).numpy()
    want = np.asarray(j_sort.radix_sort(jnp.asarray(keys), key_bits, digit_bits))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(keys))
    ks, perm = radix_sort_with_perm(torch.from_numpy(keys), key_bits, digit_bits)
    jks, jperm = j_sort.radix_sort_with_perm(jnp.asarray(keys), key_bits, digit_bits)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("dup_pool", [1, 5, 64])
def test_duplicates_keep_the_stable_order(dup_pool):
    keys = _keys(dup_pool, 4096, 20, dup_pool=dup_pool)
    ks, perm = radix_sort_with_perm(torch.from_numpy(keys), 20)
    jks, jperm = j_sort.radix_sort_with_perm(jnp.asarray(keys), 20)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(ks.numpy(), keys[np.argsort(keys, kind="stable")])
    assert torch.equal(perm.long(), torch.sort(torch.from_numpy(keys), stable=True)[1])


def test_int64_keys_sort_as_int32_keys():
    """The engine hands over int64 keys; the values sort alike."""
    keys = _keys(3, 2000, 25)
    ks, perm = radix_sort_with_perm(torch.from_numpy(keys.astype(np.int64)), 25)
    np.testing.assert_array_equal(ks.numpy(), np.sort(keys))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("fn", [radix_sort, radix_sort_with_perm], ids=["sort", "with_perm"])
@pytest.mark.parametrize("keys,digit_bits,match", [
    (np.zeros((4, 4), np.int32), 4, "1-D"),
    (np.zeros(8, np.int32), 0, "digit_bits"),
    (np.zeros(8, np.int32), 9, "digit_bits"),
])
def test_value_errors(fn, keys, digit_bits, match):
    for f in (fn, getattr(j_sort, fn.__name__)):
        arg = torch.from_numpy(keys) if f is fn else jnp.asarray(keys)
        with pytest.raises(ValueError, match=match):
            f(arg, 8, digit_bits)


def test_too_many_keys():
    """n >= 2^24 overflows exact f32 ranks in both packages (checked before
    any work, so a meta tensor stands in for 16M keys)."""
    with pytest.raises(ValueError, match="2\\^24"):
        radix_sort(torch.empty(1 << 24, dtype=torch.int32, device="meta"), 8)
    with pytest.raises(ValueError, match="2\\^24"):
        j_sort.radix_sort(jnp.zeros(1 << 24, jnp.int32), 8)
