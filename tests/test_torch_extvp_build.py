"""The port's ExtVP load path against the JAX package's.

* ``repro_torch.kernels.ops.semijoin_mask`` (its plain version, on CPU
  tensors) equals ``repro.kernels.ops.semijoin_mask`` on its jnp path and
  on the Pallas kernel in interpret mode, pair by pair;
* the port's ``"torch"`` build (on ``device="cpu"``) and its ``"numpy"``
  build equal the reference's ``numpy`` and ``jax`` builds exactly — the
  SF map, the sizes, the materialized set and the rows byte for byte —
  for τ ∈ {0.25, 1.0}, on WatDiv and on a crafted VP catalog;
* ``Dataset.append_triples`` gives the reference's report and is
  equivalent to a from-scratch build (a new predicate, the out-of-range
  skip, the empty append, a VP-only catalog).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vp import build_extvp as ref_build_extvp
from repro.core.vp import build_vp as ref_build_vp
from repro.engine import Dataset as RefDataset
from repro.kernels import ops as ref_ops
from repro.kernels import semijoin as ref_semijoin

from repro_torch import Dataset
from repro_torch.core import extvp_build as eb
from repro_torch.core.vp import OS, SO, SS, build_extvp, build_vp
from repro_torch.kernels import ops, ref
from repro_torch.rdf.generator import WatDivConfig, generate_watdiv

from test_torch_semijoin import CASES, PLAN_CASES, _pack

TAUS = (0.25, 1.0)


def assert_builds_equal(a, b, check_semijoins: bool = True) -> None:
    """Exact equality of two ExtVP builds (one of each package, or two
    of the port's)."""
    assert a.sf == b.sf
    assert a.sizes == b.sizes
    assert set(a.tables) == set(b.tables)
    for k in a.tables:
        ra, rb = np.asarray(a.tables[k].rows), np.asarray(b.tables[k].rows)
        assert ra.dtype == rb.dtype == np.int32, k
        assert ra.tobytes() == rb.tobytes(), k
    assert a.threshold == b.threshold
    if check_semijoins:
        assert a.n_semijoins == b.n_semijoins


# ---------------------------------------------------------------------------
# The semi-join, pair by pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batch", CASES, ids=[c[0] for c in CASES])
def test_semijoin_mask_matches_reference(name, batch):
    probe, build_, pairs = _pack(batch)
    mask, counts = ops.semijoin_mask(torch.from_numpy(probe),
                                     torch.from_numpy(build_), pairs)
    start = 0
    for j, (a, b) in enumerate(batch):
        got = mask.numpy()[start:start + len(a)]
        start += len(a)
        want = np.asarray(ref_ops.semijoin_mask(jnp.asarray(a),
                                                jnp.asarray(b)))
        pallas = np.asarray(ref_ops.semijoin_mask(
            jnp.asarray(a), jnp.asarray(b), force_pallas=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
        assert int(counts[j]) == int(want.sum())


def _pad(x, mult, fill):
    return np.concatenate([x, np.full(-len(x) % mult or
                                      (mult if not len(x) else 0), fill,
                                      np.int32)]).astype(np.int32)


@pytest.mark.parametrize("name", ["mixed-paths", "ragged-batch"])
def test_bitmap_path_matches_pallas_interpret(name):
    """The port's plain bitmap path (its plan, the plain bitmap build and
    the plain probe through it) against the reference's Pallas kernel in
    interpret mode, pair by pair on the same numpy inputs: equal.  The
    reference pads a build to its tile with BUILD_PAD, so its inputs hold
    no BUILD_PAD probe key (as ids never are): such keys become
    PROBE_PAD here, for both."""
    batch = [(np.where(pa == ref_ops.BUILD_PAD, ref_ops.PROBE_PAD,
                       pa).astype(np.int32), pb)
             for pa, pb in dict(PLAN_CASES)[name]]
    probe, build_, pairs = _pack(batch)
    a, b = torch.from_numpy(probe), torch.from_numpy(build_)
    plan = ops.semijoin_plan(b, pairs)
    assert plan.bitmap.any()
    words = ref.semijoin_bitmaps_ref(b, plan)
    mask, counts = ref.semijoin_pairs_bitmap_ref(a, b, pairs, plan, words)
    start = 0
    for j, (pa, pb) in enumerate(batch):
        got = mask.numpy()[start:start + len(pa)]
        start += len(pa)
        want = np.asarray(ref_semijoin.semijoin_membership_pallas(
            jnp.asarray(_pad(pa, ref_semijoin.TILE_A, ref_ops.PROBE_PAD)),
            jnp.asarray(_pad(pb, ref_semijoin.TILE_B, ref_ops.BUILD_PAD)),
            interpret=True))[:len(pa)]
        np.testing.assert_array_equal(got, want)
        assert int(counts[j]) == int(want.sum())


# ---------------------------------------------------------------------------
# Whole builds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def watdiv_vp():
    tt, _, _ = generate_watdiv(WatDivConfig(scale_factor=0.5, seed=2))
    return tt


def crafted_triples():
    """Hand-built VP exercising every SF regime.

    Predicates (ids 1000+): p0 subjects {0,1,2}; p1 subjects {0,1,2}
    (SS identity for p0); p2 subjects {100} (range-disjoint from p0's);
    p3 subjects {1,9} (range-overlapping but empty SS vs p4);
    p4 subjects {0,2} (strict reduction of p0)."""
    return np.array([
        [0, 1000, 10], [1, 1000, 11], [2, 1000, 12],
        [0, 1001, 5], [1, 1001, 6], [2, 1001, 7],
        [100, 1002, 200],
        [1, 1003, 1], [9, 1003, 4],
        [0, 1004, 8], [2, 1004, 9],
    ], dtype=np.int32)


def random_tt(seed, n_preds=4, n_terms=30, n_triples=160):
    rng = np.random.default_rng(seed)
    tt = np.stack([rng.integers(0, n_terms, n_triples),
                   n_terms + rng.integers(0, n_preds, n_triples),
                   rng.integers(0, n_terms, n_triples)],
                  axis=1).astype(np.int32)
    return np.unique(tt, axis=0)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("source", ["watdiv", "crafted", "random"])
def test_builds_match_reference(watdiv_vp, source, tau):
    tt = {"watdiv": watdiv_vp, "crafted": crafted_triples(),
          "random": random_tt(4)}[source]
    ref_vp = ref_build_vp(tt)
    want = ref_build_extvp(ref_vp, threshold=tau, backend="numpy")
    assert_builds_equal(want, ref_build_extvp(ref_vp, threshold=tau,
                                              backend="jax"))
    vp = build_vp(tt)
    torch_build = build_extvp(vp, threshold=tau, backend="torch",
                              device="cpu", pair_batch=16)
    assert torch_build.backend == "torch"
    assert_builds_equal(want, torch_build)
    assert_builds_equal(want, build_extvp(vp, threshold=tau))
    assert len(torch_build.tables) == torch_build.n_tables(0, tau)


def test_build_matches_reference_under_pallas_interpret():
    """The reference's vmapped Pallas kernel (interpret mode) against the
    port's batched build, on a small graph."""
    tt = random_tt(11, n_preds=3, n_terms=12, n_triples=80)
    prev = ref_ops.pallas_enabled()
    ref_ops.use_pallas(True)
    try:
        want = ref_build_extvp(ref_build_vp(tt), backend="jax", pair_batch=8)
    finally:
        ref_ops.use_pallas(prev)
    got = build_extvp(build_vp(tt), backend="torch", device="cpu",
                      pair_batch=8)
    assert_builds_equal(want, got)


def test_sf_regimes_and_short_circuit():
    vp = build_vp(crafted_triples())
    dev = build_extvp(vp, threshold=1.0, backend="torch", device="cpu",
                      pair_batch=4)
    # identity: every p0 subject appears in p1 -> SF=1, not materialized
    assert dev.sf[(SS, 1000, 1001)] == 1.0
    assert (SS, 1000, 1001) not in dev.tables
    # disjoint ranges: pruned (SF=0) without evaluating a semi-join
    pruned, evals = eb.plan_pairs(vp, eb.all_pair_keys(sorted(vp)))
    assert (SS, 1000, 1002) in pruned and dev.sf[(SS, 1000, 1002)] == 0.0
    assert dev.n_semijoins == len(evals) < len(pruned) + len(evals)
    # overlapping ranges but empty result: evaluated, SF=0
    assert (SS, 1004, 1003) in evals and dev.sf[(SS, 1004, 1003)] == 0.0
    # strict reduction: materialized with exact rows, in s-order
    assert dev.sf[(SS, 1000, 1004)] == 2 / 3
    np.testing.assert_array_equal(dev.tables[(SS, 1000, 1004)].rows,
                                  [[0, 10], [2, 12]])


def test_pair_descriptors_address_the_packed_columns():
    """Each pair's (probe, build) segments are its predicates' columns."""
    vp = build_vp(crafted_triples())
    packed = eb.pack_vp(vp, "cpu")
    pairs = list(eb.all_pair_keys(sorted(vp)))
    desc = eb.pair_descriptors(packed, pairs)
    assert desc.dtype == np.int64
    keys, uniq = packed.keys.numpy(), packed.uniq.numpy()
    for (kind, p1, p2), (po, pl, bo, bl) in zip(pairs, desc):
        t1, t2 = vp[p1], vp[p2]
        np.testing.assert_array_equal(keys[po:po + pl],
                                      t1.o if kind == OS else t1.s)
        np.testing.assert_array_equal(
            uniq[bo:bo + bl], t2.unique_o if kind == SO else t2.unique_s)


def test_build_backend_validation():
    with pytest.raises(ValueError, match="build backend"):
        build_extvp({}, backend="jax")
    with pytest.raises(ValueError, match="build backend"):
        eb.evaluate_pairs({}, [], 1.0, backend="spark")


# ---------------------------------------------------------------------------
# Incremental append
# ---------------------------------------------------------------------------

def _triples(rng, n, n_ent, preds):
    return [(f"e{rng.integers(0, n_ent)}", str(rng.choice(preds)),
             f"e{rng.integers(0, n_ent)}") for _ in range(n)]


def assert_datasets_equivalent(ds, scratch) -> None:
    """Two datasets (either package) hold the same catalog."""
    assert np.array_equal(np.asarray(ds.catalog.tt),
                          np.asarray(scratch.catalog.tt))
    assert set(ds.catalog.vp) == set(scratch.catalog.vp)
    for p in ds.catalog.vp:
        assert np.array_equal(ds.catalog.vp[p].rows,
                              scratch.catalog.vp[p].rows), p
    assert_builds_equal(ds.catalog.extvp, scratch.catalog.extvp,
                        check_semijoins=False)
    assert ds.catalog.distinct_s == scratch.catalog.distinct_s
    assert ds.catalog.m2_o == scratch.catalog.m2_o


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_append_matches_reference_and_scratch(tau, backend):
    rng = np.random.default_rng(5)
    base = _triples(rng, 120, 24, ["p0", "p1", "p2", "p3"])
    extra = _triples(rng, 50, 24, ["p1", "p4"])   # p4 is a new predicate
    ds = Dataset.from_triples(base, threshold=tau, build_backend=backend,
                              device="cpu")
    report = ds.append_triples(extra)
    assert report is ds.last_append_report
    ref = RefDataset.from_triples(base, threshold=tau)
    assert report == ref.append_triples(extra)
    assert report["reused"] > 0 and report["evaluated"] > 0
    assert_datasets_equivalent(ref, ds)
    scratch = Dataset.from_triples(base + extra, threshold=tau,
                                   build_backend=backend, device="cpu")
    assert_datasets_equivalent(ds, scratch)
    q = "SELECT * WHERE { ?a p1 ?b . ?b p4 ?c }"
    got, want = ds.engine().query(q), ref.engine("jit").query(q)
    assert got.cols == want.cols
    np.testing.assert_array_equal(got.data, np.asarray(want.data))


def test_append_out_of_range_keys_skip_recompute():
    """New build-side keys outside every probe range: the pair results
    are carried over, not re-semi-joined — and still match scratch."""
    base = [(f"a{i}", "pA", f"a{i+1}") for i in range(6)] + \
           [(f"a{i}", "pB", f"a{i+2}") for i in range(5)]
    extra = [(f"z{i}", "pB", f"z{i+1}") for i in range(4)]  # fresh entities
    ds = Dataset.from_triples(base, threshold=1.0, device="cpu")
    report = ds.append_triples(extra)
    ref = RefDataset.from_triples(base, threshold=1.0)
    assert report == ref.append_triples(extra)
    assert report["range_skipped"] > 0
    assert_datasets_equivalent(
        ds, Dataset.from_triples(base + extra, threshold=1.0, device="cpu"))


def test_append_empty_and_engine_invalidation():
    ds = Dataset.from_triples([("a", "p", "b")], threshold=1.0, device="cpu")
    eng = ds.engine()
    assert ds.append_triples([])["recomputed"] == 0
    assert ds.engine() is eng              # no-op append keeps engines
    ds.append_triples([("b", "p", "c")])
    assert ds.engine() is not eng          # a real append drops them
    assert len(ds.engine().query("SELECT * WHERE { ?x p ?y . ?y p ?z }")) == 1


def test_append_without_extvp_stays_extvp_less():
    base = [("a", "p", "b"), ("c", "q", "d")]
    extra = [("x", "p", "y"), ("x", "r", "z")]
    ds = Dataset.from_triples(base, with_extvp=False, device="cpu")
    assert ds.append_triples(extra)["recomputed"] == 0
    assert not ds.catalog.extvp.sf and not ds.catalog.extvp.tables
    assert_datasets_equivalent(
        ds, Dataset.from_triples(base + extra, with_extvp=False,
                                 device="cpu"))


@pytest.mark.parametrize("seed", range(4))
def test_append_random_splits(seed):
    """Random base/extra splits: incremental == scratch == reference."""
    rng = np.random.default_rng(100 + seed)
    preds = [f"p{i}" for i in range(1 + seed % 4)]
    base = _triples(rng, int(rng.integers(1, 80)), 20, preds)
    extra = _triples(rng, int(rng.integers(1, 40)), 30, preds + ["pnew"])
    tau = TAUS[seed % 2]
    ds = Dataset.from_triples(base, threshold=tau, device="cpu")
    ds.append_triples(extra)
    assert_datasets_equivalent(
        ds, Dataset.from_triples(base + extra, threshold=tau, device="cpu"))
    assert_datasets_equivalent(
        RefDataset.from_triples(base + extra, threshold=tau), ds)
