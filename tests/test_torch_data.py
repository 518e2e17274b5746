"""The port's data layer against the JAX package's: the WatDiv generator
byte for byte, the numpy catalog build (VP, ExtVP, SF, sizes, the
materialized set and the statistics) exactly, and the catalog carried
across through ``repro_torch.convert.catalog_from_arrays``.

Also home of :func:`port_catalog`, the helper the other port tests use
to query the very same catalog from both packages."""

import numpy as np
import pytest

from repro.core.stats import build_catalog as ref_build_catalog
from repro.rdf.generator import WatDivConfig as RefConfig
from repro.rdf.generator import generate_watdiv as ref_generate
from repro.rdf.workloads import basic_queries as ref_basic_queries

from repro_torch.convert import catalog_from_arrays
from repro_torch.core.stats import build_catalog
from repro_torch.rdf.generator import WatDivConfig, generate_watdiv
from repro_torch.rdf.workloads import basic_queries


def catalog_arrays(cat) -> dict:
    """Every array and scalar of a ``repro`` catalog, as plain numpy /
    Python values — the keyword arguments of ``catalog_from_arrays``."""
    d = cat.dictionary
    ext = cat.extvp
    return dict(
        tt=np.asarray(cat.tt), terms=list(d.id_to_term),
        values=np.asarray(d.values, dtype=np.float64),
        vp={int(p): np.asarray(t.rows) for p, t in cat.vp.items()},
        extvp={k: np.asarray(t.rows) for k, t in ext.tables.items()},
        sf=dict(ext.sf), sizes=dict(ext.sizes), threshold=ext.threshold,
        kinds=tuple(ext.kinds), distinct_s=cat.distinct_s,
        distinct_o=cat.distinct_o, m2_s=cat.m2_s, m2_o=cat.m2_o,
        with_extvp=cat.with_extvp, n_semijoins=ext.n_semijoins)


def port_catalog(cat):
    """The port's Catalog over exactly the arrays of a ``repro`` one."""
    return catalog_from_arrays(**catalog_arrays(cat))


def assert_same_dictionary(a, b):
    assert a.id_to_term == b.id_to_term
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))


def assert_same_catalog(ref, port):
    """Exact equality of two catalogs (a repro one and a port one)."""
    assert np.asarray(port.tt).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(ref.tt), port.tt)
    assert sorted(ref.vp) == sorted(port.vp)
    for p in ref.vp:
        assert port.vp[p].rows.dtype == np.int32
        np.testing.assert_array_equal(ref.vp[p].rows, port.vp[p].rows)
    assert sorted(ref.extvp.tables) == sorted(port.extvp.tables)
    for k in ref.extvp.tables:
        np.testing.assert_array_equal(ref.extvp.tables[k].rows,
                                      port.extvp.tables[k].rows)
    assert ref.extvp.sf == port.extvp.sf
    assert ref.extvp.sizes == port.extvp.sizes
    assert ref.extvp.threshold == port.extvp.threshold
    assert tuple(ref.extvp.kinds) == tuple(port.extvp.kinds)
    assert ref.extvp.n_semijoins == port.extvp.n_semijoins
    for name in ("distinct_s", "distinct_o", "m2_s", "m2_o"):
        assert getattr(ref, name) == getattr(port, name), name
    for kind, p1, p2 in ref.extvp.sf:
        assert ref.materialized(kind, p1, p2) == \
            port.materialized(kind, p1, p2)


@pytest.mark.parametrize("scale", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 7])
def test_generator_byte_identical(scale, seed):
    tt_r, d_r, s_r = ref_generate(RefConfig(scale_factor=scale, seed=seed))
    tt_p, d_p, s_p = generate_watdiv(WatDivConfig(scale_factor=scale,
                                                  seed=seed))
    assert tt_p.dtype == tt_r.dtype
    assert tt_p.tobytes() == tt_r.tobytes()
    assert_same_dictionary(d_r, d_p)
    assert vars(s_r) == vars(s_p)
    assert ref_basic_queries(s_r, seed=seed) == basic_queries(s_p, seed=seed)


def test_generator_triples_per_scale():
    """The count the generator's docstring states for scale 1.0."""
    tt, _, _ = generate_watdiv(WatDivConfig(scale_factor=1.0, seed=0))
    assert len(tt) == 29_583


@pytest.fixture(scope="module")
def watdiv_03():
    return generate_watdiv(WatDivConfig(scale_factor=0.3, seed=3))


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_build_catalog_matches_reference(watdiv_03, tau):
    tt, d, _ = watdiv_03
    ref = ref_build_catalog(tt, d, threshold=tau, build_backend="numpy")
    port = build_catalog(tt, d, threshold=tau)
    assert_same_catalog(ref, port)
    assert len(port.extvp.tables) == port.extvp.n_tables(0, tau)
    assert port.storage_report()["extvp_tuples"] == \
        ref.storage_report()["extvp_tuples"]


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_catalog_from_arrays_round_trips(watdiv_03, tau):
    tt, d, _ = watdiv_03
    ref = ref_build_catalog(tt, d, threshold=tau, build_backend="numpy")
    port = port_catalog(ref)
    assert_same_catalog(ref, port)
    assert_same_dictionary(ref.dictionary, port.dictionary)
    # nothing is shared with the caller's arrays
    assert not np.shares_memory(port.tt, ref.tt)
    p = next(iter(ref.vp))
    assert not np.shares_memory(port.vp[p].rows, ref.vp[p].rows)
    # the table the compiler reads falls back to VP exactly as the
    # reference's does
    for key in list(ref.extvp.sf)[:50]:
        kind, p1, p2 = key
        np.testing.assert_array_equal(ref.table(kind, p1, p2).rows,
                                      port.table(kind, p1, p2).rows)


def test_vp_only_build_matches_reference(watdiv_03):
    """``with_extvp=False``: VP tables and statistics, no ExtVP pairs."""
    tt, d, _ = watdiv_03
    ref = ref_build_catalog(tt, d, with_extvp=False)
    port = build_catalog(tt, d, with_extvp=False)
    assert_same_catalog(ref, port)
    assert not port.extvp.sf and not port.extvp.tables
