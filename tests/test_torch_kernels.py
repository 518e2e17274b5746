"""The port's join probe against the JAX package's: ``repro_torch``'s
``ops.join_probe`` on CPU tensors (its plain version) must equal
``repro.kernels.ref.join_probe_ref`` and the Pallas kernel run through
``repro.kernels.ops.join_probe(..., force_pallas=True)`` (interpret mode
on the CPU) exactly, as int32.  The CUDA kernel itself runs only on the
card: the tests marked ``cuda`` skip without one.  The machine with the
card has no JAX, so the JAX package is imported only by the tests that
hold the port against it: ``python -m pytest -m cuda
tests/test_torch_kernels.py`` runs there."""

import numpy as np
import pytest
import torch

from repro_torch.core.jexec import A_NULL, A_SENT, B_NULL, B_SENT
from repro_torch.kernels import build, ops, ref

try:
    from repro.kernels.mergejoin import TILE_A, TILE_B
except ImportError:          # no JAX: the Pallas kernel's tiles as of now
    TILE_A, TILE_B = 1024, 512

BIG = 2**31 - 1


def _sorted_build(rng, n, lo, hi):
    return np.sort(rng.integers(lo, hi, n).astype(np.int32))


def _cases():
    rng = np.random.default_rng(1)
    out = []
    # tile-sized, many duplicates (TestJoinProbeKernel's shapes)
    for n_a, n_b in [(TILE_A, TILE_B), (2 * TILE_A, 2 * TILE_B)]:
        out.append((f"tiles-{n_a}x{n_b}",
                    rng.integers(0, 800, n_a).astype(np.int32),
                    _sorted_build(rng, n_b, 0, 800)))
    # a duplicate run that spans a build-tile boundary
    b = np.full(2 * TILE_B, 7, dtype=np.int32)
    b[:4] = 3
    out.append(("dup-run-across-tiles", np.full(TILE_A, 7, dtype=np.int32),
                np.sort(b)))
    # ragged sizes
    for seed, n_a, n_b in [(2, 1, 1), (3, 7, 3), (4, 1000, 513),
                           (5, 2500, 1200), (6, 1023, 511), (7, 3001, 1)]:
        r = np.random.default_rng(seed)
        out.append((f"ragged-{n_a}x{n_b}",
                    r.integers(0, 500, n_a).astype(np.int32),
                    _sorted_build(r, n_b, 0, 500)))
    # empty sides
    out.append(("empty-probe", np.empty(0, np.int32),
                _sorted_build(rng, 64, 0, 50)))
    out.append(("empty-build", np.arange(50, dtype=np.int32),
                np.empty(0, np.int32)))
    # the executor's four sentinels: probe pads / UNBOUND keys against
    # build pads / UNBOUND keys never match; a probe pad's lo is n_b
    out.append(("sentinels",
                np.array([5, A_NULL, A_SENT, 9, 0, A_SENT, 12], np.int32),
                np.array([B_NULL, B_NULL, 0, 5, 5, 9, B_SENT, B_SENT],
                         np.int32)))
    return out


CASES = _cases()


def _adversarial():
    """Inputs aimed at the CUDA kernel's search: runs of equal keys longer
    than a segment, runs that start on a splitter or fill the column,
    keys equal to splitters, all-pad probes and builds of pads.  On the
    card they run at several ``SMEM_KEYS`` (``test_cuda_kernel_matches_
    plain``), so that strides 1 to above 32 all occur at these sizes."""
    rng = np.random.default_rng(11)
    out = []
    keys = np.arange(-2, 130, dtype=np.int32)
    for n_b, run in [(64, 37), (200, 16), (1000, 37), (1000, 300),
                     (2049, 64)]:
        b = np.repeat(np.arange(n_b // run + 1), run)[:n_b].astype(np.int32)
        out.append((f"runs-of-{run}-in-{n_b}", keys, b))
    # every splitter's key, for strides 1 to 256 over a column of distinct keys
    b = np.arange(0, 3 * 1024, 3, dtype=np.int32)
    out.append(("keys-on-splitters", b[::8].copy(), b))
    out.append(("whole-column-run", np.array([6, 7, 8, A_SENT, A_NULL],
                                             np.int32),
                np.full(777, 7, np.int32)))
    out.append(("all-pad-probe", np.full(300, A_SENT, np.int32),
                np.sort(rng.integers(0, 1000, 500)).astype(np.int32)))
    out.append(("all-B_SENT-build", np.array([0, A_SENT, B_SENT, A_NULL, 5],
                                             np.int32),
                np.full(300, B_SENT, np.int32)))
    b = np.full(1500, B_SENT, np.int32)
    b[:3] = B_NULL
    b[3:90] = np.sort(rng.integers(0, 40, 87))
    out.append(("mostly-B_SENT-build",
                np.concatenate([np.arange(-6, 42), [A_SENT, A_NULL, B_SENT]])
                .astype(np.int32), b))
    out.append(("int32-extremes",
                np.array([-2**31, BIG, 0, -1, BIG - 1], np.int32),
                np.array([-2**31, -2**31, -1, 0, BIG - 1, BIG - 1], np.int32)))
    # a build that ends in a long run of the largest int32, probed with it
    b = np.concatenate([np.arange(10), np.full(100, BIG)]).astype(np.int32)
    out.append(("long-run-of-int32-max", np.array([BIG, 9, BIG - 1], np.int32),
                b))
    # runs of about 20 over builds just past 64: at SMEM_KEYS 64 the
    # stride is 2, narrower than the 4-key window the kernel reads
    for n_b in [100, 127, 128]:
        b = np.sort(rng.integers(0, 6, n_b)).astype(np.int32)
        out.append((f"runs-past-64-{n_b}", np.arange(-1, 8, dtype=np.int32), b))
    for n_b in [1, 2, 31, 33, 1023, 1025, 4096, 4097]:
        b = np.sort(rng.integers(0, 2 * n_b, n_b)).astype(np.int32)
        a = rng.integers(-1, 2 * n_b + 2, 700).astype(np.int32)
        a[::3] = b[rng.integers(0, n_b, len(a[::3]))]
        out.append((f"ragged-build-{n_b}", a, b))
    return out


ADVERSARIAL = _adversarial()


def _batch_cases():
    """Batches of probe rows against one build for every row (``shared``)
    or one build a row, of unlike contents: rows of random keys, of
    sentinels, of long runs, and empty rows (all pads); builds with pad
    tails of unlike lengths."""
    rng = np.random.default_rng(21)
    out = []
    for batch, n_a, n_b in [(1, 33, 16), (2, 100, 64), (3, 700, 1025),
                            (7, 64, 200)]:
        a = rng.integers(-1, 2 * n_b, (batch, n_a)).astype(np.int32)
        a[:, ::5] = A_SENT
        a[:, 1::7] = A_NULL
        builds = []
        for r in range(batch):
            live = int(rng.integers(0, n_b + 1))
            b = np.full(n_b, B_SENT, np.int32)
            b[:live] = np.sort(rng.integers(0, max(live // 3, 1) + 1, live))
            if live > 2:
                b[:2] = B_NULL
            builds.append(b)
            if live:                            # keys the build holds
                pick = a[r, 2::3]
                pick[:] = b[rng.integers(0, live, len(pick))]
        if batch > 2:
            a[-1] = A_SENT                      # a padding binding's row
        out.append((f"b{batch}-{n_a}x{n_b}-per-row", a, np.stack(builds)))
        out.append((f"b{batch}-{n_a}x{n_b}-shared", a, builds[0]))
    return out


BATCH_CASES = _batch_cases()


@pytest.fixture
def jax_ref():
    """The JAX package's ``(jnp, ops, ref)`` kernel modules."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref
    return jnp, ref_ops, ref_ref


@pytest.mark.parametrize("name,a,b", CASES, ids=[c[0] for c in CASES])
def test_join_probe_matches_reference(name, a, b, jax_ref):
    jnp, ref_ops, ref_ref = jax_ref
    lo, cnt = ops.join_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert lo.dtype == torch.int32 and cnt.dtype == torch.int32
    assert lo.shape == cnt.shape == (len(a),)
    wlo, wcnt = ref_ref.join_probe_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    plo, pcnt = ref_ops.join_probe(jnp.asarray(a), jnp.asarray(b),
                                   force_pallas=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(plo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pcnt))


@pytest.mark.parametrize("name,a,b", ADVERSARIAL,
                         ids=[c[0] for c in ADVERSARIAL])
def test_join_probe_adversarial_matches_reference(name, a, b, jax_ref):
    jnp, _, ref_ref = jax_ref
    lo, cnt = ops.join_probe(torch.from_numpy(a), torch.from_numpy(b))
    wlo, wcnt = ref_ref.join_probe_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("name,a,b", BATCH_CASES,
                         ids=[c[0] for c in BATCH_CASES])
def test_batched_join_probe_matches_reference(name, a, b, jax_ref):
    """A batch on the CPU (the plain version) against the reference's
    Pallas kernel (interpret mode) and its ref, row by row, each row in
    its own build or in the shared one."""
    jnp, ref_ops, ref_ref = jax_ref
    lo, cnt = ops.join_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert lo.shape == cnt.shape == a.shape
    assert lo.dtype == cnt.dtype == torch.int32
    for r in range(a.shape[0]):
        br = jnp.asarray(b[r] if b.ndim == 2 else b)
        plo, pcnt = ref_ops.join_probe(jnp.asarray(a[r]), br,
                                       force_pallas=True)
        np.testing.assert_array_equal(lo[r].numpy(), np.asarray(plo))
        np.testing.assert_array_equal(cnt[r].numpy(), np.asarray(pcnt))
        wlo, wcnt = ref_ref.join_probe_ref(jnp.asarray(a[r]), br)
        np.testing.assert_array_equal(lo[r].numpy(), np.asarray(wlo))
        np.testing.assert_array_equal(cnt[r].numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("probe,build", [((3, 5), (2, 8)), ((5,), (1, 8)),
                                         ((2, 2, 2), (8,)), ((4,), (2, 2, 2))])
def test_join_probe_rejects_unpaired_shapes(probe, build):
    with pytest.raises(ValueError, match="probe"):
        ops.join_probe(torch.zeros(probe, dtype=torch.int32),
                       torch.zeros(build, dtype=torch.int32))


SMS = 132


@pytest.mark.parametrize("n_a", [0, 1, 2**28])
@pytest.mark.parametrize("n_b", [0, 1, ops.SMEM_KEYS, ops.SMEM_KEYS + 1,
                                 2**19, 2**23])
def test_probe_plan(n_a, n_b):
    """The join-probe launch plan: the smallest power-of-two stride whose
    splitters fit ``SMEM_KEYS``, a tree of the next power of two of
    4-byte slots, and a persistent grid no larger than the probe's tiles
    or what the SMs hold at once."""
    stride, n_spl, blocks, smem = ops._probe_plan(n_a, n_b, SMS)
    assert stride & (stride - 1) == 0
    assert n_spl == -(-n_b // stride) <= ops.SMEM_KEYS
    assert stride == 1 or -(-n_b // (stride // 2)) > ops.SMEM_KEYS
    if n_b == 0:
        assert smem == 0
    else:
        slots = smem // 4
        assert smem % 4 == 0 and slots & (slots - 1) == 0
        assert n_spl <= slots < 2 * n_spl
    assert smem <= 4 * ops.SMEM_KEYS <= 232448     # a block's dynamic limit
    tile = ops.PROBE_THREADS
    per_sm = min(ops.SM_THREADS // ops.PROBE_THREADS,
                 ops.SM_SMEM_BYTES // (smem + ops.BLOCK_SMEM_RESERVED))
    assert per_sm >= 1
    assert blocks == min(-(-n_a // tile), SMS * per_sm)
    if n_b <= ops.SMEM_KEYS:
        assert stride == 1 and n_spl == n_b     # the whole column
    else:     # the main path's largest build (2^19), phase 2's (2^23)
        assert stride == max(1, 2**(n_b - 1).bit_length() // ops.SMEM_KEYS)
    if n_a == 1:
        assert blocks == 1


@pytest.mark.parametrize("batch", [1, 2, 7, 32, 300])
@pytest.mark.parametrize("n_a,n_b", [(1, 16), (4096, 2**15), (2**20, 2**19)])
def test_probe_plan_batched(batch, n_a, n_b):
    """A batch of rows with a build each: the same stride and tree as
    one row, and a row's persistent grid cut so that all rows' blocks
    together fit what the SMs hold at once (at least one block a row)."""
    one = ops._probe_plan(n_a, n_b, SMS)
    stride, n_spl, blocks, smem = ops._probe_plan(n_a, n_b, SMS, batch)
    assert (stride, n_spl, smem) == (one[0], one[1], one[3])
    per_sm = min(ops.SM_THREADS // ops.PROBE_THREADS,
                 ops.SM_SMEM_BYTES // (smem + ops.BLOCK_SMEM_RESERVED))
    assert blocks == min(-(-n_a // ops.PROBE_THREADS),
                         max(SMS * per_sm // batch, 1))
    assert blocks >= 1 and (blocks * batch <= SMS * per_sm or blocks == 1)


def test_duplicate_run_counts():
    """The TestJoinProbeKernel spot check: lo = 4, cnt = 2 * TILE_B - 4."""
    name, a, b = CASES[2]
    lo, cnt = ops.join_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert int(lo[0]) == 4 and int(cnt[0]) == 2 * TILE_B - 4


def test_sentinels_never_match():
    _, a, b = CASES[-1]
    lo, cnt = ref.join_probe_ref(torch.from_numpy(a), torch.from_numpy(b))
    pads = a == A_SENT
    assert (cnt.numpy()[pads] == 0).all()
    assert (lo.numpy()[pads] == len(b)).all()
    assert int(cnt[list(a).index(A_NULL)]) == 0


def test_cpu_path_launches_no_kernel():
    before = dict(ops.launches)
    ops.join_probe(torch.arange(10, dtype=torch.int32),
                   torch.arange(5, dtype=torch.int32))
    assert ops.launches == before


def test_wrapper_rejects_mixed_devices():
    with pytest.raises(ValueError):
        ops.join_probe(torch.empty(3, dtype=torch.int32, device="meta"),
                       torch.empty(3, dtype=torch.int32))


def test_build_names_libraries_by_source_hash():
    path = build.library_path("join_probe")
    assert path.parent == build.build_dir()
    assert path.name.startswith("libjoin_probe-") and path.suffix == ".so"
    assert (build.CSRC / build.SOURCES["join_probe"]).exists()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(monkeypatch):
    """The CUDA kernel against its plain version on the card, on every
    case above, at the default ``SMEM_KEYS`` and at small ones that give
    these sizes strides from 2 to above 32 (run on a machine with a GPU:
    ``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for smem_keys in [ops.SMEM_KEYS, 1, 4, 16, 64]:
        monkeypatch.setattr(ops, "SMEM_KEYS", smem_keys)
        for name, a, b in CASES + ADVERSARIAL:
            ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
            before = ops.launches["join_probe"]
            lo, cnt = ops.join_probe(ta, tb)
            torch.cuda.synchronize()
            assert ops.launches["join_probe"] == before + (1 if len(a) else 0)
            wlo, wcnt = ref.join_probe_ref(ta, tb)
            assert torch.equal(lo, wlo) and torch.equal(cnt, wcnt), \
                (name, smem_keys)


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_misaligned_build():
    """The kernel reads the build column in 16-byte vectors: a view at a
    4-byte offset raises, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = torch.arange(100, dtype=torch.int32, device="cuda")
    a = torch.arange(10, dtype=torch.int32, device="cuda")
    before = ops.launches["join_probe"]
    with pytest.raises(ValueError, match="aligned"):
        ops.join_probe(a, b[1:])
    assert ops.launches["join_probe"] == before


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain(monkeypatch):
    """The batched launches against the plain version on the card: each
    batch case with one build for every row (the rows end to end, one
    launch) and, where its rows are 16-byte aligned, with a build a row
    (``join_probe_batched_launch``), at
    the default ``SMEM_KEYS`` and at small ones that give every window
    width; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    cases = list(BATCH_CASES)
    for batch, n_b in [(2, 2**19), (32, 4096), (7, 40000)]:
        b = np.sort(rng.integers(0, n_b, (batch, n_b)), axis=1)
        b[:, -n_b // 8:] = B_SENT
        a = rng.integers(-1, n_b + 1, (batch, 3000)).astype(np.int32)
        cases.append((f"b{batch}-3000x{n_b}", a, b.astype(np.int32)))
    for smem_keys in [ops.SMEM_KEYS, 1, 4, 16, 64]:
        monkeypatch.setattr(ops, "SMEM_KEYS", smem_keys)
        for name, a, b in cases:
            ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
            builds = [tb[0].contiguous()] if tb.dim() == 2 else [tb]
            # a build a row needs rows of a multiple of 4 keys
            if tb.dim() == 2 and (len(a) == 1 or b.shape[1] % 4 == 0):
                builds.append(tb)
            for build in builds:
                before = ops.launches["join_probe"]
                lo, cnt = ops.join_probe(ta, build)
                torch.cuda.synchronize()
                assert ops.launches["join_probe"] == before + 1
                wlo, wcnt = ref.join_probe_ref(ta, build)
                assert torch.equal(lo, wlo) and torch.equal(cnt, wcnt), \
                    (name, tuple(build.shape), smem_keys)


@pytest.mark.cuda
def test_cuda_batched_kernel_refuses_unaligned_rows():
    """Rows of a build a row must each be 16-byte aligned: a width that
    is not a multiple of 4 keys raises, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.zeros((3, 10), dtype=torch.int32, device="cuda")
    b = torch.zeros((3, 6), dtype=torch.int32, device="cuda")
    before = ops.launches["join_probe"]
    with pytest.raises(ValueError, match="aligned"):
        ops.join_probe(a, b)
    assert ops.launches["join_probe"] == before
