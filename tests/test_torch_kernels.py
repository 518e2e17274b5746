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
