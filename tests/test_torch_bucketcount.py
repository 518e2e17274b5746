"""The port's bucket-count wrapper (``repro_torch.kernels.ops.bucket_count``)
against the JAX package's.

On the CPU the wrapper runs its plain version (``ref.bucket_count_ref``),
held exactly against ``repro.kernels.ops.bucket_count``'s reference path
on seeded keys with negative keys, UNBOUND (-1), A_NULL (-3) and pads,
and against the Pallas kernel (interpret mode) on non-negative keys
only: the Pallas kernel takes a signed floor-mod of the key
(``repro/kernels/bucketcount.py:39``) and so disagrees with its own
reference on negative keys (ROADMAP queue 3); the port follows the
reference's uint32 modulo, which is how the shuffle routes rows.  Pads
sit in invalid rows, where the executor puts them: a *valid* row whose
key is the pad counts in the reference path but not in the Pallas
kernel, and counts nowhere in the port (a valid row never carries the
pad).  A batch of rows, ``(B, n)`` keys into ``(B, n_buckets)``, is
held row by row against both.  The CUDA kernel's tests, and its launch
plan's, are in
``tests/test_torch_bucketcount_kernel.py``, which imports no JAX and so
also runs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops

from repro_torch.kernels import ops, ref

PAD = 2**31 - 1


def keys_and_valid(seed, n, signed=True):
    """Seeded keys over the whole int32 range (or its non-negative half),
    with UNBOUND, A_NULL and small keys salted in, a random valid mask,
    and pads in invalid rows."""
    rng = np.random.default_rng(seed)
    lo = -2**31 if signed else 0
    keys = rng.integers(lo, PAD, size=n, dtype=np.int64).astype(np.int32)
    if signed:
        keys[::5] = -1
        keys[1::7] = -3
    keys[2::3] = rng.integers(0, 50, size=len(keys[2::3]))
    valid = rng.random(n) < 0.7
    pads = ~valid & (rng.random(n) < 0.5)
    keys[pads] = PAD
    return keys, valid


def port(keys, valid, nb):
    return ops.bucket_count(torch.from_numpy(keys),
                            torch.from_numpy(valid), nb).numpy()


def reference(keys, valid, nb, pallas=False):
    return np.asarray(rops.bucket_count(jnp.asarray(keys), jnp.asarray(valid),
                                        nb, force_pallas=pallas))


@pytest.mark.parametrize("nb", [1, 3, 6, 8])
@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_plain_matches_reference(nb, n):
    keys, valid = keys_and_valid(nb * 100 + n, n)
    got = port(keys, valid, nb)
    assert got.dtype == np.int32 and got.shape == (nb,)
    np.testing.assert_array_equal(got, reference(keys, valid, nb))
    assert got.sum() == valid.sum()


@pytest.mark.parametrize("nb", [1, 3, 6, 8])
def test_all_invalid_counts_nothing(nb):
    keys, _ = keys_and_valid(nb, 2000)
    valid = np.zeros(2000, dtype=bool)
    np.testing.assert_array_equal(port(keys, valid, nb), np.zeros(nb))
    np.testing.assert_array_equal(reference(keys, valid, nb), np.zeros(nb))


@pytest.mark.parametrize("nb", [3, 8])
def test_plain_matches_pallas_on_nonnegative_keys(nb):
    keys, valid = keys_and_valid(nb, 3000, signed=False)
    np.testing.assert_array_equal(port(keys, valid, nb),
                                  reference(keys, valid, nb, pallas=True))


def test_negative_keys_take_the_uint32_modulo():
    """[-1, -1, -3, 5] into 3 buckets: uint32(-1) % 3 = 0, uint32(-3) %
    3 = 1, 5 % 3 = 2.  The reference path agrees; the Pallas kernel's
    floor-mod gives [1, 0, 3] (the divergence ROADMAP queue 3 records)."""
    keys = np.array([-1, -1, -3, 5], dtype=np.int32)
    valid = np.ones(4, dtype=bool)
    np.testing.assert_array_equal(port(keys, valid, 3), [2, 1, 1])
    np.testing.assert_array_equal(reference(keys, valid, 3), [2, 1, 1])
    np.testing.assert_array_equal(reference(keys, valid, 3, pallas=True),
                                  [1, 0, 3])


def test_a_valid_pad_counts_nowhere():
    keys = np.array([PAD, 4, PAD, 7], dtype=np.int32)
    valid = np.ones(4, dtype=bool)
    np.testing.assert_array_equal(port(keys, valid, 2), [1, 1])
    np.testing.assert_array_equal(reference(keys, valid, 2, pallas=True),
                                  [1, 1])


def test_wrapper_contract():
    keys = torch.arange(10, dtype=torch.int32)
    valid = torch.ones(10, dtype=torch.bool)
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="n_buckets"):
        ops.bucket_count(keys, valid, 0)
    with pytest.raises(ValueError, match="shape"):
        ops.bucket_count(keys, valid[:5], 2)
    np.testing.assert_array_equal(ops.bucket_count(keys, valid, 4).numpy(),
                                  [3, 3, 2, 2])
    assert ops.launches == before        # the plain version is no launch


# ---------------------------------------------------------------------------
# A batch of rows: (B, n) keys and validity give (B, n_buckets)
# ---------------------------------------------------------------------------

def batch_of_rows(seed, batch, n, signed=True):
    """``batch`` rows of :func:`keys_and_valid`, each with its own seed,
    its own share of valid rows and a run of invalid rows at its end (the
    executor's PAD tail), stacked to ``(batch, n)``."""
    keys, valid = zip(*(keys_and_valid(seed + b, n, signed)
                        for b in range(batch)))
    keys, valid = np.stack(keys), np.stack(valid)
    for b in range(batch):
        valid[b, n - (b * 97) % (n + 1):] = False
    return keys, valid


@pytest.mark.parametrize("nb", [1, 2, 3, 9])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_plain_matches_reference_row_by_row(batch, nb):
    from repro.kernels import ref as rref
    keys, valid = batch_of_rows(batch * 100 + nb, batch, 1000)
    got = port(keys, valid, nb)
    assert got.dtype == np.int32 and got.shape == (batch, nb)
    for b in range(batch):
        want = np.asarray(rref.bucket_count_ref(
            jnp.asarray(keys[b]), jnp.asarray(valid[b]), nb))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(got[b], port(keys[b], valid[b], nb))


@pytest.mark.parametrize("nb", [1, 2, 3, 9])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_plain_matches_pallas_on_nonnegative_keys(batch, nb):
    keys, valid = batch_of_rows(batch * 10 + nb, batch, 600, signed=False)
    got = port(keys, valid, nb)
    for b in range(batch):
        np.testing.assert_array_equal(
            got[b], reference(keys[b], valid[b], nb, pallas=True))


def test_batched_wrapper_contract():
    keys = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    valid = torch.ones(3, 4, dtype=torch.bool)
    valid[1, 2:] = False
    before = dict(ops.launches)
    np.testing.assert_array_equal(ops.bucket_count(keys, valid, 2).numpy(),
                                  [[2, 2], [1, 1], [2, 2]])
    assert ops.bucket_count(keys[:0], valid[:0], 3).shape == (0, 3)
    with pytest.raises(ValueError, match="shape"):
        ops.bucket_count(keys, valid[:2], 2)
    with pytest.raises(ValueError, match="batch"):
        ops.bucket_count(keys[None], valid[None], 2)
    assert ops.launches == before        # the plain version is no launch
