"""Each operator of the port's executor against the JAX package's.

The same seeded numpy inputs go through ``repro.core.jexec`` and
``repro_torch.core.jexec``; the outputs ``(data, n, overflow)`` must be
equal exactly (everything is int32; float32 keys are compared bitwise).
Inputs carry the executor's hazards: PAD tails, UNBOUND values,
duplicate join keys, several shared variables (``needs_compact``), the
cross join, overflowing capacities, and values past 2**24."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algebra as ralg
from repro.core import jexec as RJ
from repro.core.modifiers import ModifierSpine as RSpine
from repro.rdf.dictionary import Dictionary as RDictionary

from repro_torch.core import algebra as talg
from repro_torch.core import jexec as TJ
from repro_torch.core.modifiers import ModifierSpine as TSpine
from repro_torch.rdf.dictionary import PAD, UNBOUND
from repro_torch.rdf.dictionary import Dictionary as TDictionary


def _rel(rng, cap, k, n, hi=12, unbound=0.1):
    data = rng.integers(0, hi, (cap, k)).astype(np.int32)
    data[rng.random((cap, k)) < unbound] = UNBOUND
    data[n:] = PAD
    return data


def pair(cols, data, n, ovf=False):
    r = RJ.JBindings(tuple(cols), jnp.asarray(data),
                     jnp.asarray(np.int32(n)), jnp.asarray(ovf))
    t = TJ.JBindings(tuple(cols), torch.from_numpy(data.copy()),
                     torch.tensor(n, dtype=torch.int32), torch.tensor(ovf))
    return r, t


def same_arrays(r, t):
    r = np.asarray(r)
    t = t.numpy()
    assert r.shape == t.shape
    if r.dtype == np.float32:
        np.testing.assert_array_equal(r.view(np.int32), t.view(np.int32))
    else:
        assert t.dtype == r.dtype, (t.dtype, r.dtype)
        np.testing.assert_array_equal(r, t)


def same_triple(r, t):
    """(data, n, overflow) tuples."""
    same_arrays(r[0], t[0])
    assert t[1].dtype == torch.int32
    assert int(r[1]) == int(t[1])
    assert bool(r[2]) == bool(t[2])


def same_rel(r, t):
    assert r.cols == t.cols
    same_triple((r.data, r.n, r.overflow), (t.data, t.n, t.overflow))


def table(rng, n, cap, hi=20):
    rows = rng.integers(0, hi, (n, 2)).astype(np.int32)
    rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    out = np.full((cap, 2), PAD, np.int32)
    out[:n] = rows
    return out


# ---------------------------------------------------------------------------
# compaction and scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_cap", [16, 64, 128])
def test_compact(out_cap):
    rng = np.random.default_rng(out_cap)
    data = _rel(rng, 64, 3, 64)
    keep = rng.random(64) < 0.4
    r = RJ._compact(jnp.asarray(data), jnp.asarray(keep), out_cap)
    t = TJ._compact(torch.from_numpy(data), torch.from_numpy(keep), out_cap)
    same_triple(r, t)


@pytest.mark.parametrize("s,o,same,take,out_cap", [
    (None, None, False, (0, 1), 64), (3, None, False, (1,), 64),
    (None, 5, False, (0,), 8), (3, 5, False, (), 64),
    (None, None, True, (0,), 64), (None, None, False, (0, 1), 16),
])
def test_device_scan(s, o, same, take, out_cap):
    rng = np.random.default_rng(11)
    rows = table(rng, 50, 64, hi=8)
    sb_r = None if s is None else jnp.asarray(np.int32(s))
    ob_r = None if o is None else jnp.asarray(np.int32(o))
    sb_t = None if s is None else torch.tensor(s, dtype=torch.int32)
    ob_t = None if o is None else torch.tensor(o, dtype=torch.int32)
    r = RJ.device_scan(jnp.asarray(rows), jnp.asarray(np.int32(50)), sb_r,
                       ob_r, same, take, out_cap)
    t = TJ.device_scan(torch.from_numpy(rows), torch.tensor(50, dtype=torch.int32),
                       sb_t, ob_t, same, take, out_cap)
    same_triple(r, t)


@pytest.mark.parametrize("s,out_cap", [(3, 16), (3, 2), (19, 8), (99, 8),
                                       (-1, 4)])
@pytest.mark.parametrize("with_col", [False, True])
def test_device_scan_windowed(s, out_cap, with_col):
    rng = np.random.default_rng(12)
    rows = table(rng, 60, 64)
    r = RJ.device_scan_windowed(jnp.asarray(rows), jnp.asarray(np.int32(60)),
                                jnp.asarray(np.int32(s)), (1,), out_cap)
    trows = torch.from_numpy(rows)
    t = TJ.device_scan_windowed(trows, torch.tensor(60, dtype=torch.int32),
                                torch.tensor(s, dtype=torch.int32), (1,),
                                out_cap,
                                trows[:, 0].contiguous() if with_col else None)
    same_triple(r, t)


@pytest.mark.parametrize("s,p,o,eqs,take,out_cap", [
    (None, None, None, (), (0, 1, 2), 128), (2, None, None, (), (1, 2), 32),
    (None, 1, None, (), (0, 2), 8), (None, None, None, ((0, 2),), (0, 1), 64),
    (None, 0, 3, (), (0,), 64),
])
def test_device_scan_tt(s, p, o, eqs, take, out_cap):
    rng = np.random.default_rng(13)
    tt = rng.integers(0, 5, (100, 3)).astype(np.int32)
    tt = np.concatenate([tt, np.full((28, 3), PAD, np.int32)])
    rs = None if s is None else jnp.asarray(np.int32(s))
    ro = None if o is None else jnp.asarray(np.int32(o))
    ts = None if s is None else torch.tensor(s, dtype=torch.int32)
    to = None if o is None else torch.tensor(o, dtype=torch.int32)
    r = RJ.device_scan_tt(jnp.asarray(tt), jnp.asarray(np.int32(100)), rs, p,
                          ro, eqs, take, out_cap)
    t = TJ.device_scan_tt(torch.from_numpy(tt), torch.tensor(100, dtype=torch.int32),
                          ts, p, to, eqs, take, out_cap)
    same_triple(r, t)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def test_build_key_and_presort():
    rng = np.random.default_rng(14)
    data = _rel(rng, 32, 2, 20, hi=6, unbound=0.2)
    r, t = pair(("?x", "?y"), data, 20)
    kr = RJ.build_key(r, 1)
    kt = TJ.build_key(t, 1)
    same_arrays(kr, kt)
    order_r = jnp.argsort(kr).astype(jnp.int32)
    order_t, sorted_t = TJ._presort(kt)
    same_arrays(order_r, order_t)
    same_arrays(kr[order_r], sorted_t)


JOIN_SHAPES = {
    "single-key": (("?x", "?y"), ("?y", "?z")),
    "multi-key": (("?x", "?y", "?w"), ("?y", "?w", "?z")),
    "cross": (("?x",), ("?z", "?u")),
    "same-cols": (("?x", "?y"), ("?x", "?y")),
}


@pytest.mark.parametrize("shape", sorted(JOIN_SHAPES))
@pytest.mark.parametrize("out_cap", [8, 64, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_join(shape, out_cap, seed):
    rng = np.random.default_rng(seed)
    ca, cb = JOIN_SHAPES[shape]
    a = _rel(rng, 32, len(ca), 25, hi=6)
    b = _rel(rng, 16, len(cb), 13, hi=6)
    ra, ta = pair(ca, a, 25)
    rb, tb = pair(cb, b, 13)
    same_rel(RJ.device_join(ra, rb, out_cap), TJ.device_join(ta, tb, out_cap))


@pytest.mark.parametrize("out_cap", [16, 256])
def test_device_join_presorted(out_cap):
    rng = np.random.default_rng(5)
    ra, ta = pair(("?x", "?y"), _rel(rng, 32, 2, 30, hi=5), 30)
    rb, tb = pair(("?y", "?z"), _rel(rng, 16, 2, 9, hi=5), 9)
    kr = RJ.build_key(rb, 0)
    order_r = jnp.argsort(kr).astype(jnp.int32)
    pre_t = TJ._presort(TJ.build_key(tb, 0))
    same_rel(RJ.device_join(ra, rb, out_cap, (order_r, kr[order_r])),
             TJ.device_join(ta, tb, out_cap, pre_t))


def _cond(alg, const):
    return alg.Cmp("!=", "?z", const)


@pytest.mark.parametrize("with_expr", [False, True])
@pytest.mark.parametrize("out_cap", [8, 64, 256])
@pytest.mark.parametrize("cols", ["single-key", "multi-key"])
def test_device_left_join(with_expr, out_cap, cols):
    rng = np.random.default_rng(out_cap)
    ca, cb = JOIN_SHAPES[cols]
    ra, ta = pair(ca, _rel(rng, 32, len(ca), 20, hi=7), 20)
    rb, tb = pair(cb, _rel(rng, 16, len(cb), 10, hi=7), 10)
    vals = np.empty((0, 4), np.float32)
    fc = np.array([3], np.int32)
    r = RJ.device_left_join(
        ra, rb, out_cap, _cond(ralg, 3) if with_expr else None,
        jnp.asarray(vals), jnp.asarray(fc), [0])
    t = TJ.device_left_join(
        ta, tb, out_cap, _cond(talg, 3) if with_expr else None,
        torch.from_numpy(vals), torch.from_numpy(fc), [0])
    same_rel(r, t)


@pytest.mark.parametrize("out_cap", [16, 64])
def test_device_union(out_cap):
    rng = np.random.default_rng(8)
    ra, ta = pair(("?x", "?y"), _rel(rng, 32, 2, 17), 17)
    rb, tb = pair(("?y", "?z"), _rel(rng, 16, 2, 11), 11)
    same_rel(RJ.device_union(ra, rb, out_cap), TJ.device_union(ta, tb, out_cap))


# ---------------------------------------------------------------------------
# the modifier spine
# ---------------------------------------------------------------------------

TERMS = ['"10"', '"16777217"', '"16777216"', '"2.5"', "ex:a", '"-3"',
         '"30"', "ex:b", '"20"', '"16777217.5"', '"1e3"', "ex:c"]


@pytest.fixture(scope="module")
def values():
    r = RJ.numeric_value_keys(RDictionary.from_terms(TERMS))
    t = TJ.numeric_value_keys(TDictionary.from_terms(TERMS))
    same_arrays(r, torch.from_numpy(t))
    return r


def _value_rel(rng, cap=32, n=24, k=3):
    data = rng.integers(0, len(TERMS), (cap, k)).astype(np.int32)
    data[rng.random((cap, k)) < 0.15] = UNBOUND
    data[n:] = PAD
    return data


FILTERS = {
    "lt-literal": lambda a: a.Cmp("<", "?x", 25.0),
    "gt-big": lambda a: a.Cmp(">", "?x", 16777216.0),
    "ge-var": lambda a: a.Cmp(">=", "?x", "?y"),
    "eq-const": lambda a: a.Cmp("=", "?y", 4),
    "ne-const": lambda a: a.Cmp("!=", "?x", 1),
    "num-eq": lambda a: a.Cmp("=", "?x", 10.0),
    "num-ne": lambda a: a.Cmp("!=", "?x", 10.0),
    "le-const": lambda a: a.Cmp("<=", "?x", 8),
    "and-or-not": lambda a: a.BoolOp("||", (
        a.BoolOp("&&", (a.Cmp(">", "?x", 5.0), a.Cmp("<", "?y", "?z"))),
        a.NotExpr(a.Bound("?z")))),
    "unknown-var": lambda a: a.Cmp("=", "?q", "?x"),
    "bound-missing": lambda a: a.Bound("?q"),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_device_filter(values, name):
    rng = np.random.default_rng(len(name))
    ra, ta = pair(("?x", "?y", "?z"), _value_rel(rng), 24)
    fc = np.array([4, 1, 8], np.int32)
    r = RJ.device_filter(ra, FILTERS[name](ralg), jnp.asarray(values),
                         jnp.asarray(fc), [0])
    t = TJ.device_filter(ta, FILTERS[name](talg), torch.from_numpy(values),
                         torch.from_numpy(fc), [0])
    same_rel(r, t)


@pytest.mark.parametrize("out_vars", [("?y",), ("?z", "?x"), ("?x", "?q"), ()])
def test_device_project(out_vars):
    rng = np.random.default_rng(3)
    ra, ta = pair(("?x", "?y", "?z"), _value_rel(rng), 20)
    same_rel(RJ.device_project(ra, out_vars), TJ.device_project(ta, out_vars))


@pytest.mark.parametrize("out_cap", [8, 32, 64])
def test_device_resize(out_cap):
    rng = np.random.default_rng(4)
    ra, ta = pair(("?x", "?y"), _rel(rng, 32, 2, 20), 20)
    r, rovf = RJ.device_resize(ra, out_cap)
    t, tovf = TJ.device_resize(ta, out_cap)
    same_rel(r, t)
    assert bool(rovf) == bool(tovf)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 40])
def test_device_distinct(k, n):
    rng = np.random.default_rng(k * 100 + n)
    data = _rel(rng, 64, k, n, hi=3, unbound=0.2)
    cols = ("?a", "?b", "?c")[:k]
    ra, ta = pair(cols, data, n)
    same_rel(RJ.device_distinct(ra), TJ.device_distinct(ta))


ORDERS = [
    (("?x", True),), (("?x", False),), (("?y", True), ("?x", False)),
    (("?z", False), ("?y", True), ("?x", True)), (("?q", True),),
    (("?q", False), ("?x", True)),
]


@pytest.mark.parametrize("keys", ORDERS, ids=[str(o) for o in ORDERS])
@pytest.mark.parametrize("with_values", [True, False])
def test_device_order(values, keys, with_values):
    rng = np.random.default_rng(len(keys))
    ra, ta = pair(("?x", "?y", "?z"), _value_rel(rng), 24)
    vals = values if with_values else np.empty((0, 4), np.float32)
    same_rel(RJ.device_order(ra, keys, jnp.asarray(vals)),
             TJ.device_order(ta, keys, torch.from_numpy(vals)))


def test_order_separates_two_pow_24_plus_one(values):
    """16777217 and 16777216 share a float32 ``hi``; only the residual
    ``lo`` orders them — both executors must order them the same way."""
    data = np.array([[1, 0], [2, 0], [1, 0], [9, 0], [0, 0],
                     [PAD, PAD]], np.int32)
    ra, ta = pair(("?x", "?y"), data, 5)
    for asc in (True, False):
        r = RJ.device_order(ra, (("?x", asc),), jnp.asarray(values))
        t = TJ.device_order(ta, (("?x", asc),), torch.from_numpy(values))
        same_rel(r, t)
        got = [TERMS[i] for i in t.data[:5, 0].tolist()]
        want = ['"10"', '"16777216"', '"16777217"', '"16777217"',
                '"16777217.5"']
        assert got == (want if asc else want[::-1])


@pytest.mark.parametrize("offset,limit", [(0, None), (0, 5), (3, 4), (2, None),
                                          (40, 3), (0, 0), (5, 100)])
def test_device_slice(offset, limit):
    rng = np.random.default_rng(6)
    ra, ta = pair(("?x",), _rel(rng, 32, 1, 20), 20)
    same_rel(RJ.device_slice(ra, offset, limit),
             TJ.device_slice(ta, offset, limit))


# ---------------------------------------------------------------------------
# host helpers of the executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caps,ovf,n_steps", [
    ((16, 64, 256), (True, False, True), 3),
    ((16, 64, 256, 64), (False, True, False, False), 3),
    ((16, 4096, 64), (False, True, False), 2),
    ((32,), (True,), 0),
])
def test_double_caps(caps, ovf, n_steps):
    assert TJ.double_caps(caps, ovf, n_steps) == \
        RJ.double_caps(caps, ovf, n_steps)


@pytest.mark.parametrize("spine", [dict(), dict(limit=5), dict(offset=100,
                                                                 limit=3000)])
@pytest.mark.parametrize("pipe_cap", [16, 4096, 1 << 20])
def test_mod_cap_seed(spine, pipe_cap):
    assert TJ._mod_cap_seed(TSpine(**spine), pipe_cap) == \
        RJ._mod_cap_seed(RSpine(**spine), pipe_cap)


def test_prepare_value_keys_rejects_indistinguishable_literal():
    """A float literal the double-single pairs cannot tell apart from a
    dictionary value raises in both packages."""
    lit = 16777217.0 - 2.0**-27
    d_r = RDictionary.from_terms(TERMS)
    d_t = TDictionary.from_terms(TERMS)

    class _Cat:
        def __init__(self, d):
            self.dictionary = d

    for mod, alg, d, spine in ((RJ, ralg, d_r, RSpine()),
                               (TJ, talg, d_t, TSpine())):
        with pytest.raises(NotImplementedError):
            mod.prepare_value_keys(_Cat(d), spine,
                                   [alg.Cmp("<", "?x", lit)])
    same_arrays(RJ.prepare_value_keys(_Cat(d_r), RSpine(order=(("?x", True),)), []),
                torch.from_numpy(TJ.prepare_value_keys(
                    _Cat(d_t), TSpine(order=(("?x", True),)), [])))
