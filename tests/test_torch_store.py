"""The port's persistent store (``repro_torch.store``) against the JAX
package's (``repro.store``): the same on-disk format, so a store written
by either package loads in the other; save → load (lazy and eager) is
byte-identical; the delta journal replays and compacts; broken stores
raise; and queries through a loaded catalog equal ``jit``."""

import json
import os

import numpy as np
import pytest

from repro.engine import Dataset as RefDataset

from repro_torch import Dataset
from repro_torch.core.table import LazyTableMap
from repro_torch.store import (
    StoreChecksumError, StoreFormatError, is_store, load_manifest,
    read_segments,
)

TAUS = (0.25, 1.0)
QUERIES = [
    "SELECT * WHERE { ?a p0 ?b . ?b p1 ?c }",
    "SELECT DISTINCT * WHERE { ?a p2 ?b } ORDER BY ?a LIMIT 5",
    "SELECT * WHERE { ?a p0 ?b OPTIONAL { ?b p3 ?c } }",
]


def _triples(n_ent=40, n_preds=6, n=260, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"e{rng.integers(0, n_ent)}", f"p{rng.integers(0, n_preds)}",
             f"e{rng.integers(0, n_ent)}") for _ in range(n)]


def assert_catalogs_identical(a, b, ctx=""):
    """Byte-level equality of two catalogs (tables, stats, dictionary),
    of either package."""
    assert np.asarray(a.tt).tobytes() == np.asarray(b.tt).tobytes(), ctx
    assert set(a.vp) == set(b.vp), ctx
    for p in a.vp:
        assert np.asarray(a.vp[p].rows).tobytes() == \
            np.asarray(b.vp[p].rows).tobytes(), (ctx, p)
    assert set(a.extvp.tables) == set(b.extvp.tables), ctx
    for k in a.extvp.tables:
        assert np.asarray(a.extvp.tables[k].rows).tobytes() == \
            np.asarray(b.extvp.tables[k].rows).tobytes(), (ctx, k)
    assert a.extvp.sf == b.extvp.sf, ctx
    assert a.extvp.sizes == b.extvp.sizes, ctx
    assert a.extvp.threshold == b.extvp.threshold, ctx
    assert tuple(a.extvp.kinds) == tuple(b.extvp.kinds), ctx
    assert a.with_extvp == b.with_extvp, ctx
    for name in ("distinct_s", "distinct_o", "m2_s", "m2_o"):
        assert getattr(a, name) == getattr(b, name), (ctx, name)
    da, db = a.dictionary, b.dictionary
    assert da.id_to_term == db.id_to_term, ctx
    assert da.values.tobytes() == db.values.tobytes(), ctx  # NaN-exact


def _flip_byte(path, offset=3):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _built(tmp_path, **kw):
    ds = Dataset.from_triples(_triples(), threshold=0.25, device="cpu", **kw)
    ds.save(tmp_path / "s")
    return ds


# ---------------------------------------------------------------------------
# Round trips, within the port and across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("build_backend", ["torch", "numpy"])
def test_roundtrip_byte_identity(tmp_path, tau, build_backend):
    ds = Dataset.from_triples(_triples(), threshold=tau,
                              build_backend=build_backend, device="cpu")
    ds.save(tmp_path / "store")
    assert load_manifest(str(tmp_path / "store"))["build_backend"] == \
        build_backend
    for eager in (False, True):
        loaded = Dataset.load(tmp_path / "store", eager=eager, verify=True,
                              device="cpu")
        assert_catalogs_identical(ds.catalog, loaded.catalog,
                                  (tau, build_backend, eager))


@pytest.mark.parametrize("tau", TAUS)
def test_port_store_loads_in_reference(tmp_path, tau):
    ds = Dataset.watdiv(scale=0.2, seed=1, threshold=tau, device="cpu")
    ds.save(tmp_path / "s")
    ref = RefDataset.load(tmp_path / "s", verify=True)
    assert_catalogs_identical(ds.catalog, ref.catalog)
    want = RefDataset.watdiv(scale=0.2, seed=1, threshold=tau)
    assert_catalogs_identical(want.catalog, ref.catalog)


@pytest.mark.parametrize("eager", [False, True])
def test_reference_store_loads_in_port(tmp_path, eager):
    ref = RefDataset.from_triples(_triples(seed=2), threshold=0.25,
                                  build_backend="jax")
    ref.save(tmp_path / "s")
    ref.append_triples([("e1", "p1", "e2"), ("eX", "pNew", "eY")])
    port = Dataset.load(tmp_path / "s", eager=eager, verify=True,
                        device="cpu")               # replays the segment
    assert_catalogs_identical(ref.catalog, port.catalog)
    assert port.storage_report()["delta_segments"] == 1


def test_roundtrip_vp_only_store(tmp_path):
    ds = Dataset.from_triples(_triples(), with_extvp=False, device="cpu")
    ds.save(tmp_path / "s")
    loaded = Dataset.load(tmp_path / "s", device="cpu")
    assert not loaded.catalog.with_extvp
    assert_catalogs_identical(ds.catalog, loaded.catalog)


def test_save_is_rerunnable_and_prunes_stale_tables(tmp_path):
    big = Dataset.from_triples(_triples(n_preds=8), threshold=1.0,
                               device="cpu")
    big.save(tmp_path / "s")
    small = Dataset.from_triples(_triples(n_preds=3, seed=1),
                                 threshold=0.25, device="cpu")
    small.save(tmp_path / "s")
    loaded = Dataset.load(tmp_path / "s", verify=True, device="cpu")
    assert_catalogs_identical(small.catalog, loaded.catalog)
    manifest = load_manifest(str(tmp_path / "s"))
    assert set(os.listdir(tmp_path / "s" / "vp")) == \
        {os.path.basename(e["file"]) for e in manifest["vp"].values()}


def test_from_ntriples(tmp_path):
    from repro_torch.rdf.ntriples import write_ntriples
    triples = [("http://x/a", "http://x/p", "http://x/b"),
               ("http://x/b", "http://x/p", '"4.5"'),
               ("_:b0", "http://x/q", "http://x/a")]
    write_ntriples(triples, str(tmp_path / "g.nt"))
    ds = Dataset.from_ntriples(str(tmp_path / "g.nt"), device="cpu")
    ref = RefDataset.from_ntriples(str(tmp_path / "g.nt"))
    assert_catalogs_identical(ref.catalog, ds.catalog)


# ---------------------------------------------------------------------------
# Laziness
# ---------------------------------------------------------------------------

def test_lazy_load_touches_nothing_until_queried(tmp_path):
    _built(tmp_path)
    loaded = Dataset.load(tmp_path / "s", device="cpu")
    vp, ext = loaded.catalog.vp, loaded.catalog.extvp.tables
    assert isinstance(vp, LazyTableMap) and isinstance(ext, LazyTableMap)
    assert vp.n_loaded == 0 and ext.n_loaded == 0
    some = next(iter(loaded.catalog.extvp.sf))
    loaded.catalog.sf(*some)
    loaded.storage_report()
    assert vp.n_loaded == 0 and ext.n_loaded == 0
    # a query faults in only what it scans, through the engine's upload
    loaded.engine().query("SELECT * WHERE { ?s p0 ?o }")
    assert 0 < vp.n_loaded + ext.n_loaded < len(vp) + len(ext)
    pid = loaded.dictionary.id_of("p0")
    base = vp[pid].rows
    while base is not None and not isinstance(base, np.memmap):
        base = getattr(base, "base", None)
    assert base is not None, "lazy-loaded table is not memory-mapped"


def test_replay_stays_lazy_and_eager_materializes(tmp_path):
    ds = Dataset.from_triples(_triples(n_preds=6), threshold=1.0,
                              device="cpu")
    ds.save(tmp_path / "s")
    ds.append_triples([("e1", "p1", "e2")])      # one journaled segment
    loaded = Dataset.load(tmp_path / "s", device="cpu")
    ext = loaded.catalog.extvp.tables
    assert isinstance(ext, LazyTableMap) and ext.n_loaded == 0
    rep = loaded.storage_report()
    assert ext.n_loaded == 0
    assert rep["extvp_tuples"] == ds.storage_report()["extvp_tuples"]
    eager = Dataset.load(tmp_path / "s", eager=True, device="cpu")
    vp = eager.catalog.vp
    assert not isinstance(vp[next(iter(vp))].rows, np.memmap)
    assert_catalogs_identical(ds.catalog, eager.catalog)


# ---------------------------------------------------------------------------
# Delta journal and compaction
# ---------------------------------------------------------------------------

def test_append_journals_replays_and_compacts(tmp_path):
    base = _triples(seed=5)
    extra1 = [("e1", "p1", "e2"), ("e2", "p0", "e3"), ("eX", "pNew", "eY")]
    extra2 = [("e5", "p2", "e1")]
    ds = Dataset.from_triples(base, threshold=0.25, device="cpu")
    ds.save(tmp_path / "s")
    ds.append_triples(extra1)
    ds.append_triples(extra2)
    assert [s.triples for s in read_segments(str(tmp_path / "s"))] == \
        [[tuple(t) for t in extra1], [tuple(t) for t in extra2]]
    replayed = Dataset.load(tmp_path / "s", device="cpu")
    assert_catalogs_identical(ds.catalog, replayed.catalog)
    scratch = Dataset.from_triples(base + extra1 + extra2, threshold=0.25,
                                   device="cpu")
    assert_catalogs_identical(scratch.catalog, replayed.catalog)
    assert replayed.storage_report()["delta_segments"] == 2
    # the reference replays the port's journal to the same catalog
    assert_catalogs_identical(scratch.catalog,
                              RefDataset.load(tmp_path / "s").catalog)
    replayed.compact()
    assert replayed.storage_report()["delta_segments"] == 0
    assert read_segments(str(tmp_path / "s")) == []
    assert_catalogs_identical(
        scratch.catalog,
        Dataset.load(tmp_path / "s", verify=True, device="cpu").catalog)


def test_append_without_store_does_not_journal_and_compact_needs_one():
    ds = Dataset.from_triples(_triples(), threshold=0.25, device="cpu")
    ds.append_triples([("x", "y", "z")])
    assert ds.store_path is None
    assert ds.storage_report()["delta_segments"] == 0.0
    with pytest.raises(ValueError, match="store"):
        ds.compact()
    with pytest.raises(ValueError, match="path"):
        ds.save()


# ---------------------------------------------------------------------------
# Broken stores raise
# ---------------------------------------------------------------------------

def test_load_missing_and_garbage_store(tmp_path):
    assert not is_store(tmp_path / "nope")
    with pytest.raises(StoreFormatError, match="missing manifest.json"):
        Dataset.load(tmp_path / "nope", device="cpu")
    d = tmp_path / "g"
    d.mkdir()
    (d / "manifest.json").write_text("{not json")
    with pytest.raises(StoreFormatError, match="unreadable"):
        Dataset.load(d, device="cpu")


def test_load_foreign_format_and_version(tmp_path):
    _built(tmp_path)
    mpath = tmp_path / "s" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["version"] = 99
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(StoreFormatError, match="version"):
        Dataset.load(tmp_path / "s", device="cpu")
    manifest["format"] = "something-else"
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(StoreFormatError, match="not a"):
        Dataset.load(tmp_path / "s", device="cpu")


def test_checksum_mismatch_surfaces_on_touch(tmp_path):
    _built(tmp_path)
    manifest = load_manifest(str(tmp_path / "s"))
    pid, entry = next(iter(manifest["vp"].items()))
    _flip_byte(tmp_path / "s" / entry["file"])
    loaded = Dataset.load(tmp_path / "s", verify=True, device="cpu")
    with pytest.raises(StoreChecksumError, match="CRC-32"):
        loaded.catalog.vp[int(pid)]
    with pytest.raises(StoreChecksumError):
        Dataset.load(tmp_path / "s", eager=True, verify=True, device="cpu")


def test_truncated_table_fails_even_without_verify(tmp_path):
    _built(tmp_path)
    manifest = load_manifest(str(tmp_path / "s"))
    pid, entry = next(iter(manifest["vp"].items()))
    fpath = tmp_path / "s" / entry["file"]
    fpath.write_bytes(fpath.read_bytes()[:-8])
    loaded = Dataset.load(tmp_path / "s", device="cpu")
    with pytest.raises(StoreFormatError, match="size"):
        loaded.catalog.vp[int(pid)]


def test_corrupted_delta_segment(tmp_path):
    ds = _built(tmp_path)
    ds.append_triples([("q", "r", "s")])
    seg = read_segments(str(tmp_path / "s"))[0]
    data = json.loads(open(seg.path).read())
    data["triples"][0][0] = "tampered"
    open(seg.path, "w").write(json.dumps(data))
    with pytest.raises(StoreChecksumError, match="delta"):
        Dataset.load(tmp_path / "s", device="cpu")


# ---------------------------------------------------------------------------
# Queries through a loaded catalog
# ---------------------------------------------------------------------------

def test_loaded_catalog_queries_equal_jit(tmp_path):
    triples = _triples(seed=3)
    built = Dataset.from_triples(triples, threshold=0.25, device="cpu")
    built.save(tmp_path / "s")
    built.append_triples([("e3", "p0", "e7"), ("e7", "p1", "e3")])
    lazy = Dataset.load(tmp_path / "s", device="cpu")
    ref = RefDataset.from_triples(
        triples + [("e3", "p0", "e7"), ("e7", "p1", "e3")], threshold=0.25)
    for q in QUERIES:
        want = ref.engine("jit").query(q)
        got = lazy.engine().query(q)
        assert got.cols == want.cols, q
        np.testing.assert_array_equal(got.data, np.asarray(want.data))
