"""The port's bucket-count kernel (``repro_torch.kernels.ops.bucket_count``
on CUDA, ``csrc/bucketcount.cu``) and its launch plan
(``ops._bucket_plan``).

The file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX.  On the CPU it checks the plan: the path
on each side of each cut, the grid, the 16-byte body's ends, and a model
of the kernel's walk (head, body and tail, thread by thread) that must
take every key exactly once and count what the plain version counts,
for one row and for a batch of rows (``blockIdx.y`` the row).
The ``cuda`` tests hold the kernel exactly against the plain version
(``ref.bucket_count_ref``) on the card and skip without one.  The
wrapper's plain path is held against the JAX package's in
``tests/test_torch_bucketcount.py``.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

PAD = 2**31 - 1
SMS = 132


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


def walked_keys(n, plan, threads):
    """The key indices each thread of the kernel's grid takes, in the
    order ``walk_keys`` (bucketcount.cu) takes them: the body's steps of
    16 keys, then the head and tail one key a thread."""
    stride = plan.blocks * threads
    steps = (plan.hi - plan.lo) // ops.BUCKET_STEP_KEYS
    n_scalar = plan.lo + n - plan.hi
    out = []
    for t in range(stride):
        idx = [plan.lo + ops.BUCKET_STEP_KEYS * c + j
               for c in range(t, steps, stride)
               for j in range(ops.BUCKET_STEP_KEYS)]
        idx += [s if s < plan.lo else plan.hi + s - plan.lo
                for s in range(t, n_scalar, stride)]
        out.append(idx)
    return out


#: (n, n_buckets) around multiples of 16 and 4,096, on both sides of
#: each cut
SIZES = [0, 1, 15, 16, 17, 31, 33, 4095, 4096, 4097, 3 * 4096 + 21]
CUT_BUCKETS = [1, 2, 3, 4, ops.BUCKET_REG_MAX, ops.BUCKET_REG_MAX + 1, 256,
               ops.BUCKET_SMEM_MAX, ops.BUCKET_SMEM_MAX + 1, 20000]


@pytest.mark.parametrize("nb, path", [
    (1, "registers"), (2, "registers"), (ops.BUCKET_REG_MAX, "registers"),
    (ops.BUCKET_REG_MAX + 1, "shared"), (ops.BUCKET_SMEM_MAX, "shared"),
    (ops.BUCKET_SMEM_MAX + 1, "global"), (20000, "global")])
def test_plan_path_on_each_side_of_each_cut(nb, path):
    assert ops._bucket_plan(4096, nb, SMS, 512, 1024).path == path


def test_register_cut_at_zero_sends_every_call_to_the_shared_histogram(
        monkeypatch):
    monkeypatch.setattr(ops, "BUCKET_REG_MAX", 0)
    for nb in (1, 2, 8):
        assert ops._bucket_plan(4096, nb, SMS, 0, 0).path == "shared"
    assert ops._bucket_plan(4096, ops.BUCKET_SMEM_MAX + 1, SMS, 0,
                            0).path == "global"


def test_plan_constants_match_the_kernel_source():
    """The wrapper's cuts, step and path numbers are the ones
    bucketcount.cu compiles: the source instantiates the register path
    for 1..REG_BUCKETS buckets and refuses more, so the register cut may
    not exceed it."""
    src = (build.CSRC / build.SOURCES["bucket_count"]).read_text()
    defines = dict(re.findall(r"^#define (\w+) (\w+)$", src, re.M))
    assert 0 <= ops.BUCKET_REG_MAX <= int(defines["REG_BUCKETS"])
    assert ops.BUCKET_SMEM_MAX == int(defines["SMEM_BUCKETS"])
    assert ops.BUCKET_STEP_KEYS == int(defines["STEP_KEYS"])
    assert ops.BUCKET_PATH_IDS == {
        "registers": int(defines["PATH_REGISTERS"]),
        "shared": int(defines["PATH_SHARED"]),
        "global": int(defines["PATH_GLOBAL"])}


@pytest.mark.parametrize("n", [1, 4096, 2**20, 2**23, 2**28, 2**31 - 1])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("valid_ptr", [1024, 1025])
def test_plan_grid_is_persistent(n, sms, valid_ptr):
    """Aligned views read a body of steps; a validity view one byte off
    takes every key one at a time, and the grid covers those keys."""
    plan = ops._bucket_plan(n, 1, sms, 512, valid_ptr)
    assert (plan.hi > plan.lo) == (valid_ptr == 1024 and n >= 16)
    assert 1 <= plan.blocks <= sms * ops.BUCKET_BLOCKS_PER_SM
    threads = plan.blocks * ops.BUCKET_THREADS
    # every step and every head or tail key has a thread, or the grid
    # is full and threads stride
    steps = (plan.hi - plan.lo) // ops.BUCKET_STEP_KEYS
    assert threads >= max(steps, n - (plan.hi - plan.lo)) or \
        plan.blocks == sms * ops.BUCKET_BLOCKS_PER_SM
    if n >= 2**23:
        assert plan.blocks == sms * ops.BUCKET_BLOCKS_PER_SM


@pytest.mark.parametrize("n", [16, 17, 31, 32, 100, 4096, 4097, 70001])
def test_plan_body_is_aligned_and_whole_steps(n):
    """For every offset of the two pointers: the body is whole steps at
    16-byte-aligned addresses of both, and it exists exactly where one
    index aligns both and a step fits after it."""
    for key_off, valid_off in np.ndindex(4, 16):
        key_ptr, valid_ptr = 4096 + 4 * key_off, 8192 + valid_off
        plan = ops._bucket_plan(n, 2, SMS, key_ptr, valid_ptr)
        assert 0 <= plan.lo <= plan.hi <= n
        assert (plan.hi - plan.lo) % ops.BUCKET_STEP_KEYS == 0
        if plan.hi > plan.lo:
            assert (key_ptr + 4 * plan.lo) % 16 == 0
            assert (valid_ptr + plan.lo) % 16 == 0
            assert plan.lo < 16 and n - plan.hi < ops.BUCKET_STEP_KEYS
        else:
            assert plan.lo == plan.hi == 0
        aligned = [i for i in range(16) if (key_ptr + 4 * i) % 16 == 0
                   and (valid_ptr + i) % 16 == 0]
        assert (plan.hi > plan.lo) == bool(aligned and n - aligned[0] >= 16)


def test_fresh_tensors_read_every_whole_step_as_vectors():
    """The allocator's tensors are 512-byte aligned: the body starts at
    key 0 and only the last n mod 16 keys go one at a time."""
    for n in (16, 4096, 2**23 + 5):
        plan = ops._bucket_plan(n, 1, SMS, 1 << 20, 1 << 21)
        assert (plan.lo, plan.hi) == (0, n // 16 * 16)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 33, 4095, 4097, 9000])
def test_walk_takes_every_key_exactly_once(n):
    """The head, the body and the tail cover every key once, for every
    offset of the two pointers (a small grid, so threads stride)."""
    for key_off, valid_off in np.ndindex(4, 16):
        plan = ops._bucket_plan(n, 3, 1, 4 * key_off, valid_off)
        plan = plan._replace(blocks=min(plan.blocks, 2))
        visits = np.zeros(n, dtype=np.int64)
        for idx in walked_keys(n, plan, 64):
            np.add.at(visits, np.asarray(idx, dtype=np.int64), 1)
        assert (visits == 1).all(), (key_off, valid_off, plan)


@pytest.mark.parametrize("nb", [1, 2, 3, 8, 9, 256])
@pytest.mark.parametrize("key_off, valid_off", [(0, 0), (1, 1), (3, 3),
                                                (1, 2), (0, 3)])
def test_model_of_the_walk_counts_as_the_plain_version(nb, key_off,
                                                       valid_off):
    """Each thread's keys of the walk, counted per thread and summed,
    give the plain version's histogram on views at offsets."""
    n = 4096 + 37
    keys, valid = keys_and_valid(nb + 10 * key_off + valid_off, n + 3)
    k, v = keys[key_off:key_off + n], valid[valid_off:valid_off + n]
    plan = ops._bucket_plan(n, nb, 1, 4 * key_off, valid_off)
    plan = plan._replace(blocks=1)
    hist = np.zeros(nb, dtype=np.int64)
    for idx in walked_keys(n, plan, ops.BUCKET_THREADS):
        idx = np.asarray(idx, dtype=np.int64)
        live = v[idx] & (k[idx] != PAD)
        dest = (k[idx].astype(np.int64) & 0xFFFFFFFF) % nb
        hist += np.bincount(dest[live], minlength=nb)
    want = ref.bucket_count_ref(torch.from_numpy(k), torch.from_numpy(v), nb)
    np.testing.assert_array_equal(hist, want.numpy())


def test_cpu_views_take_the_plain_version_and_launch_nothing():
    keys, valid = keys_and_valid(5, 1000)
    k, v = torch.from_numpy(keys), torch.from_numpy(valid)
    before = dict(ops.launches)
    got = ops.bucket_count(k[1:998], v[3:], 4)
    assert ops.launches == before
    np.testing.assert_array_equal(
        got.numpy(), ref.bucket_count_ref(k[1:998], v[3:], 4).numpy())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel against the plain version on the card, exactly: every
    case above, the global-atomics path past the shared-memory cut, and
    2^24 keys (``-m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [(keys_and_valid(s, n), nb) for s, n in enumerate([0, 1, 33,
                                                               4099])
             for nb in (1, 2, 3, 6, 8, 256, 20000)]
    cases.append(((np.array([-1, -1, -3, 5], np.int32),
                   np.ones(4, bool)), 3))
    big = np.random.default_rng(7).integers(-2**31, PAD, 1 << 24)
    cases.append(((big.astype(np.int32), big % 3 > 0), 2))
    for (keys, valid), nb in cases:
        k, v = torch.from_numpy(keys), torch.from_numpy(valid)
        launches = ops.launches["bucket_count"]
        got = ops.bucket_count(k.cuda(), v.cuda(), nb)
        torch.cuda.synchronize()
        assert ops.launches["bucket_count"] == launches + (len(keys) > 0)
        assert torch.equal(got.cpu(), ref.bucket_count_ref(k, v, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("reg_max", [ops.BUCKET_REG_MAX, 0])
def test_cuda_paths_offsets_and_cuts_match_plain(monkeypatch, reg_max):
    """Every path and both sides of each cut, sizes around 16 and 4,096,
    key and validity views at offsets of 0-3 keys, with the register cut
    as committed and at 0 (``-m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(ops, "BUCKET_REG_MAX", reg_max)
    keys, valid = keys_and_valid(11, max(SIZES) + 3)
    kc, vc = torch.from_numpy(keys).cuda(), torch.from_numpy(valid).cuda()
    paths = set()
    for nb in CUT_BUCKETS:
        for n in SIZES:
            for ko in range(4):
                for vo in range(4):
                    k, v = kc[ko:ko + n], vc[vo:vo + n]
                    plan = ops._bucket_plan(n, nb, SMS, k.data_ptr(),
                                            v.data_ptr())
                    paths.add(plan.path)
                    launches = ops.launches["bucket_count"]
                    got = ops.bucket_count(k, v, nb)
                    torch.cuda.synchronize()
                    assert ops.launches["bucket_count"] == \
                        launches + (n > 0)
                    want = ref.bucket_count_ref(k, v, nb)
                    assert torch.equal(got, want), (nb, n, ko, vo, plan)
    assert paths == ({"registers", "shared", "global"} if reg_max else
                     {"shared", "global"})


# ---------------------------------------------------------------------------
# The batched launch: B rows of n keys, blockIdx.y the row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [2, 7, 32, 65535])
@pytest.mark.parametrize("n", [16, 17, 31, 32, 4096, 4100, 2**20])
def test_batched_plan_rows_share_an_aligned_body(batch, n):
    """Every row starts where the first row's body alignment repeats
    (n a multiple of 16 keys), or the plan takes every key one at a
    time; all rows' blocks together stay within the persistent grid,
    with at least one a row."""
    for key_off, valid_off in np.ndindex(4, 4):
        key_ptr, valid_ptr = 4096 + 4 * key_off, 8192 + valid_off
        plan = ops._bucket_plan(n, 2, SMS, key_ptr, valid_ptr, batch)
        if n % ops.BUCKET_STEP_KEYS:
            assert plan.lo == plan.hi == 0
        for b in (0, 1, batch - 1):
            row_k, row_v = key_ptr + 4 * b * n, valid_ptr + b * n
            if plan.hi > plan.lo:
                assert (row_k + 4 * plan.lo) % 16 == 0
                assert (row_v + plan.lo) % 16 == 0
        assert plan.blocks >= 1
        assert plan.blocks * batch <= max(SMS * ops.BUCKET_BLOCKS_PER_SM,
                                          batch)
    one = ops._bucket_plan(n, 2, SMS, 4096, 8192)
    assert ops._bucket_plan(n, 2, SMS, 4096, 8192, 1) == one


@pytest.mark.parametrize("nb", [1, 3, 9, 256])
@pytest.mark.parametrize("n", [4096, 4096 + 37])
def test_model_of_the_batched_walk_counts_as_the_plain_version(nb, n):
    """Each row's walk at its row offset, counted per thread and summed,
    gives the plain version's row: a (3, n) batch whose row stride is
    and is not a whole number of 16-key steps."""
    batch = 3
    keys, valid = keys_and_valid(nb + n, batch * n)
    k, v = keys.reshape(batch, n), valid.reshape(batch, n)
    plan = ops._bucket_plan(n, nb, 1, 0, 0, batch)._replace(blocks=1)
    hist = np.zeros((batch, nb), dtype=np.int64)
    for b in range(batch):
        for idx in walked_keys(n, plan, ops.BUCKET_THREADS):
            idx = np.asarray(idx, dtype=np.int64)
            live = v[b, idx] & (k[b, idx] != PAD)
            dest = (k[b, idx].astype(np.int64) & 0xFFFFFFFF) % nb
            hist[b] += np.bincount(dest[live], minlength=nb)
    want = ref.bucket_count_ref(torch.from_numpy(k), torch.from_numpy(v), nb)
    np.testing.assert_array_equal(hist, want.numpy())


#: phase 2's batched cases: rows, and bucket counts on each side of each
#: cut of the kernel's paths
BATCHES = [1, 2, 7, 32]
BATCH_BUCKETS = [1, 2, 3, ops.BUCKET_REG_MAX, ops.BUCKET_REG_MAX + 1, 256,
                 ops.BUCKET_SMEM_MAX, ops.BUCKET_SMEM_MAX + 1, 20000]


@pytest.mark.cuda
@pytest.mark.parametrize("reg_max", [ops.BUCKET_REG_MAX, 0])
def test_cuda_batched_launch_matches_plain(monkeypatch, reg_max):
    """A (B, n) batch is one launch, exactly the plain version: every
    path, row lengths that are and are not a multiple of 16 keys, rows
    starting 16-byte aligned and at a 1-key offset (``-m cuda`` on the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(ops, "BUCKET_REG_MAX", reg_max)
    paths = set()
    for batch in BATCHES:
        for n in (16, 33, 4096, 4097):
            keys, valid = keys_and_valid(batch * n, batch * n + 1)
            for nb in BATCH_BUCKETS:
                for off in (0, 1):
                    k = torch.from_numpy(keys).cuda()[off:off + batch * n] \
                        .view(batch, n)
                    v = torch.from_numpy(valid).cuda()[off:off + batch * n] \
                        .view(batch, n)
                    plan = ops._bucket_plan(n, nb, SMS, k.data_ptr(),
                                            v.data_ptr(), batch)
                    paths.add(plan.path)
                    launches = ops.launches["bucket_count"]
                    got = ops.bucket_count(k, v, nb)
                    torch.cuda.synchronize()
                    assert ops.launches["bucket_count"] == launches + 1
                    want = ref.bucket_count_ref(k.cpu(), v.cpu(), nb)
                    assert got.shape == (batch, nb)
                    assert torch.equal(got.cpu(), want), \
                        (batch, n, nb, off, plan)
    assert paths == ({"registers", "shared", "global"} if reg_max else
                     {"shared", "global"})
