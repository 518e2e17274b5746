"""The plain reference: hand-computed answers, every basic template
against a brute force, and what it (and the harness) may load."""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from s2bench import reference
from s2bench.inputs import queries, watdiv

ROOT = Path(__file__).resolve().parents[2]

TERMS = ["p:knows", "p:age", "p:likes", "p:name", "a", "b", "c", "d", "e",
         "x", "y", '"30"', '"45"', '"50"', '"str"']
T = {t: i for i, t in enumerate(TERMS)}
TRIPLES = [("a", "p:knows", "b"), ("a", "p:knows", "c"), ("b", "p:knows", "c"),
           ("c", "p:knows", "a"), ("d", "p:knows", "d"), ("e", "p:knows", "a"),
           ("a", "p:age", '"30"'), ("b", "p:age", '"45"'), ("c", "p:age", '"50"'),
           ("d", "p:age", '"str"'), ("a", "p:likes", "x"), ("a", "p:likes", "y"),
           ("b", "p:likes", "x"), ("c", "p:likes", "y"), ("e", "p:likes", "x"),
           ("b", "p:name", '"str"')]


def store():
    tt = np.array([[T[s], T[p], T[o]] for s, p, o in TRIPLES], dtype=np.int32)
    return reference.Store(tt, TERMS)


def ans(q):
    rel = store().answer(q)
    names = sorted(rel.vars)
    return Counter(tuple(TERMS[v] if v >= 0 else None
                         for v in (row[rel.vars.index(n)] for n in names))
                   for row in rel.data.tolist())


@pytest.mark.parametrize("q, want", [
    ("SELECT * WHERE { ?x p:knows ?y }",
     {("a", "b"): 1, ("a", "c"): 1, ("b", "c"): 1, ("c", "a"): 1,
      ("d", "d"): 1, ("e", "a"): 1}),
    ("SELECT * WHERE { a p:knows ?y . ?y p:likes ?z }",
     {("b", "x"): 1, ("c", "y"): 1}),
    ("SELECT * WHERE { ?x p:knows ?x }", {("d",): 1}),
    ("SELECT * WHERE { ?x p:likes x . ?x p:knows ?y . ?y p:likes ?z }",
     # x, y, z in name order: ?x ?y ?z
     {("a", "b", "x"): 1, ("a", "c", "y"): 1, ("b", "c", "y"): 1,
      ("e", "a", "x"): 1, ("e", "a", "y"): 1}),
    ("SELECT * WHERE { ?x p:knows ?y . ?y p:age ?a . FILTER(?a > 40) }",
     {('"45"', "a", "b"): 1, ('"50"', "a", "c"): 1, ('"50"', "b", "c"): 1}),
    ("SELECT * WHERE { ?x p:age ?a . FILTER(?a != 30) }",
     {('"45"', "b"): 1, ('"50"', "c"): 1}),
    ("SELECT * WHERE { ?x p:likes ?z . OPTIONAL { ?x p:name ?n } }",
     {(None, "a", "x"): 1, (None, "a", "y"): 1, ('"str"', "b", "x"): 1,
      (None, "c", "y"): 1, (None, "e", "x"): 1}),
    ("SELECT * WHERE { ?x p:likes nobody }", {}),
    ("SELECT * WHERE { ?x p:name ?n . ?y p:likes y }",
     {('"str"', "b", "a"): 1, ('"str"', "b", "c"): 1}),
])
def test_hand_computed(q, want):
    assert ans(q) == Counter(want)


def brute_force(qtext, tt, terms):
    """Solutions by extending mappings one triple pattern at a time over
    Python lists, then OPTIONAL and FILTER, with no sorting or index."""
    g = reference.parse(qtext)
    tid = {t: i for i, t in enumerate(terms)}
    by_p = {}
    for s, p, o in tt.tolist():
        by_p.setdefault(p, []).append((s, o))

    def extend(sols, pats):
        for s_t, p_t, o_t in pats:
            out = []
            for mu in sols:
                for s, o in by_p.get(tid.get(p_t, -9), []):
                    nu = dict(mu)
                    ok = True
                    for t, v in ((s_t, s), (o_t, o)):
                        if t.startswith("?"):
                            if nu.setdefault(t, v) != v:
                                ok = False
                        elif tid.get(t, -9) != v:
                            ok = False
                    if ok:
                        out.append(nu)
            sols = out
        return sols

    sols = extend([{}], g.patterns)
    for opt in g.optionals:
        out = []
        for mu in sols:
            ext = extend([mu], opt.patterns)
            out.extend(ext if ext else [mu])
        sols = out
    vals = reference.numeric_values(terms)
    for var, op, num in g.filters:
        cmp = {">": float.__gt__, "<": float.__lt__}[op]
        sols = [mu for mu in sols if var in mu and cmp(float(vals[mu[var]]), num)]
    names = sorted({v for p in g.patterns + [p for o in g.optionals
                                              for p in o.patterns]
                    for v in p if v.startswith("?")})
    return Counter(tuple(mu.get(n, -1) for n in names) for mu in sols), names


def test_every_basic_template_against_brute_force():
    g = watdiv.generate(0.5, 3)
    st = reference.Store(g.tt, g.terms)
    qset = queries.load_queryset("watdiv-basic")
    inst = queries.instances(qset, g.counts, 9, 2)
    nonempty = 0
    for name, texts in inst.items():
        if name in ("C1", "C2"):       # 10^4-10^5 rows: too slow here
            continue
        for q in texts:
            want, names = brute_force(q, g.tt, g.terms)
            rel = st.answer(q)
            assert sorted(rel.vars) == names, name
            got = Counter(tuple(int(row[rel.vars.index(n)]) for n in names)
                          for row in rel.data.tolist())
            assert got == want, name
            nonempty += bool(want)
    assert nonempty >= 20


def test_canonical_is_a_multiset_compare():
    data = np.array([[3, 1], [2, -1], [3, 1]], dtype=np.int32)
    a = reference.canonical(("?b", "?a"), data, 10)
    b = reference.canonical(("?a", "?b"), data[[2, 0, 1]][:, [1, 0]], 10)
    assert reference.same_answer(a, b)
    c = reference.canonical(("?b", "?a"), data[[0, 1, 1]], 10)
    assert not reference.same_answer(a, c)
    wide = np.arange(40, dtype=np.int32).reshape(4, 10) % 7
    names = tuple(f"?v{i}" for i in range(10))
    assert reference.same_answer(
        reference.canonical(names, wide, 2 ** 22),
        reference.canonical(names, wide[::-1], 2 ** 22))


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_loads_neither_jax_nor_the_program():
    top = _loaded("import s2bench.reference, s2bench.check, "
                  "s2bench.control, s2bench.inputs.watdiv, "
                  "s2bench.inputs.queries")
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_loads_no_jax():
    top = _loaded("import s2bench.run, s2bench.cell\n"
                  "from s2bench.cell import build_server\n"
                  "import repro_torch.serve, repro_torch.engine, "
                  "repro_torch.kernels.ops\n"
                  "from s2bench import spec\n"
                  "for w in spec.load_benchmark()['workloads']:\n"
                  "    for m in spec.resolve(w['name']).per_layer:\n"
                  "        spec.metric_reader(m['name'])")
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
