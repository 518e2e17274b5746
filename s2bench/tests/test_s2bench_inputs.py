"""The benchmark's frozen input makers give the port's inputs bit for bit."""

import numpy as np
import pytest

from repro_torch.rdf.generator import WatDivConfig, generate_watdiv
from repro_torch.rdf.workloads import basic_queries

from s2bench.inputs import queries, watdiv


@pytest.mark.parametrize("scale", [0.5, 2.0])
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
def test_graph_matches_the_port(scale, seed):
    g = watdiv.generate(scale, seed)
    tt, d, sch = generate_watdiv(WatDivConfig(scale_factor=scale, seed=seed))
    assert g.tt.dtype == tt.dtype and g.tt.shape == tt.shape
    assert np.array_equal(g.tt, tt)
    assert g.terms == d.id_to_term
    for name in ("users", "products", "reviews", "retailers", "websites",
                 "cities", "countries", "genres", "categories"):
        assert g.counts[name] == getattr(sch, f"n_{name}")
    assert g.first["users"] == sch.user0 and g.first["genres"] == sch.genre0


@pytest.mark.parametrize("scale", [0.5, 2.0])
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
def test_query_texts_match_the_port(scale, seed):
    g = watdiv.generate(scale, 1)
    _, _, sch = generate_watdiv(WatDivConfig(scale_factor=scale, seed=1))
    qset = queries.load_queryset("watdiv-basic")
    assert queries.instances(qset, g.counts, seed, 4) == \
        basic_queries(sch, seed=seed, n_instances=4)


def test_a_stream_draws_every_placeholder():
    """One instance advances the generator by every placeholder, used or
    not, so a template's stream does not depend on the others."""
    qset = queries.load_queryset("watdiv-basic")
    counts = watdiv.generate(0.5, 0).counts
    a = np.random.default_rng(5)
    queries.instantiate(qset["templates"]["L4"], qset, counts, a)
    b = np.random.default_rng(5)
    b.integers(0, 10, size=len(qset["placeholders"]))
    assert a.bit_generator.state == b.bit_generator.state


def test_relabelling_keeps_the_graph_up_to_names():
    from s2bench import reference
    base = watdiv.generate(1.0, 0)
    c3 = ("SELECT * WHERE { ?v0 wsdbm:likes ?v1 . ?v0 wsdbm:friendOf ?v2 . "
          "?v0 wsdbm:gender ?v3 . OPTIONAL { ?v0 foaf:age ?v4 } }")
    sizes = set()
    for seed in (1, 2 ** 33 + 9):
        g = watdiv.relabel(base, seed)
        assert not np.array_equal(g.tt, base.tt)
        assert np.array_equal(g.tt[:, 1], base.tt[:, 1])
        lit = base.tt[:, 2] >= base.first["categories"] + \
            base.counts["categories"]
        assert np.array_equal(g.tt[lit, 2], base.tt[lit, 2])
        for name, _ in watdiv.BLOCKS:     # ids stay inside their block
            lo, n = base.first[name], base.counts[name]
            inside = (base.tt[:, 0] >= lo) & (base.tt[:, 0] < lo + n)
            assert ((g.tt[inside, 0] >= lo) & (g.tt[inside, 0] < lo + n)).all()
        sizes.add(len(reference.Store(g.tt, g.terms).answer(c3)))
        assert np.array_equal(watdiv.relabel(base, seed).tt, g.tt)
    assert len(sizes) == 1


def test_every_seed_asks_the_same_queries_up_to_names():
    """The mix's query set, renamed as the seed renames the graph, has the
    same answer sizes for every seed: the seed changes names and order,
    not the work."""
    from s2bench import reference
    from s2bench.cell import TRAFFIC_STREAM, Pool
    base = watdiv.generate(0.5, 0)
    qset = queries.load_queryset("watdiv-basic")
    templates = ["L1", "S1", "S4", "F3", "C3"]
    sizes, texts = [], []
    for seed in (3, 2 ** 33 + 1):
        g = watdiv.relabel(base, seed)
        store = reference.Store(g.tt, g.terms)
        pool = Pool(seed, TRAFFIC_STREAM, templates, qset, g.counts, 3)
        texts.append(pool.pool)
        sizes.append({t: sorted(len(store.answer(q)) for q in qs)
                      for t, qs in pool.pool.items()})
        sent = [pool("S1") for _ in range(6)]
        assert sorted(sent) == sorted(pool.pool["S1"] * 2)
    assert sizes[0] == sizes[1]
    assert any(n for per in sizes[0].values() for n in per)
    assert texts[0]["S1"] != texts[1]["S1"]
