"""The port's join probe against the JAX package's: ``repro_torch``'s
``ops.join_probe`` on CPU tensors (its plain version) must equal
``repro.kernels.ref.join_probe_ref`` and the Pallas kernel run through
``repro.kernels.ops.join_probe(..., force_pallas=True)`` (interpret mode
on the CPU) exactly, as int32.  The CUDA kernel itself runs only on the
card: ``test_cuda_kernel_matches_plain`` is marked ``cuda`` and skips
without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.mergejoin import TILE_A, TILE_B

from repro_torch.core.jexec import A_NULL, A_SENT, B_NULL, B_SENT
from repro_torch.kernels import build, ops, ref

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


@pytest.mark.parametrize("name,a,b", CASES, ids=[c[0] for c in CASES])
def test_join_probe_matches_reference(name, a, b):
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
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card, on every
    case above (run on a machine with a GPU: ``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, a, b in CASES:
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        before = ops.launches["join_probe"]
        lo, cnt = ops.join_probe(ta, tb)
        torch.cuda.synchronize()
        assert ops.launches["join_probe"] == before + (1 if len(a) else 0)
        wlo, wcnt = ref.join_probe_ref(ta, tb)
        assert torch.equal(lo, wlo) and torch.equal(cnt, wcnt), name
