"""The benchmark's own WatDiv generator: a frozen copy of the port's
``repro_torch.rdf.generator.generate_watdiv``.

Given a scale and a seed it returns the same triples, in the same order,
and the same id-ordered term list as the port's generator (the tests
under ``s2bench/tests`` hold it to that bit for bit).  Two steps differ
in how, not in what:

* de-duplication sorts one packed ``int64`` key per row, ``(s * P + p) *
  T + o``, instead of ``np.unique(rows, axis=0)``: the key orders rows as
  the lexicographic row sort does, so the unique rows come out in the
  same order, about forty times sooner;
* the final shuffle gathers the rows through ``rng.permutation(n)``
  instead of ``rng.shuffle(rows, axis=0)``: both draw the same
  Fisher-Yates swaps from the generator, and the gather moves each row
  once.

The term list is built as the port's ``Dictionary`` would assign ids,
without the dictionary: the port receives it through its own public
constructor.  Nothing here imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

PREDICATES: List[str] = [
    "rdf:type", "wsdbm:follows", "wsdbm:friendOf", "wsdbm:likes",
    "wsdbm:purchased", "wsdbm:invitedBy", "sorg:email", "wsdbm:gender",
    "foaf:age", "wsdbm:subscribes", "rev:reviewer", "rev:rating",
    "rev:hasReview", "sorg:caption", "sorg:price", "sorg:hasGenre",
    "sorg:soldBy", "wsdbm:sells", "sorg:locatedIn", "gn:partOf",
    "sorg:homepage", "wsdbm:hits",
]

CLASSES: List[str] = [
    "wsdbm:User", "wsdbm:Product", "wsdbm:Review", "wsdbm:Retailer",
    "wsdbm:Website", "wsdbm:City", "wsdbm:Country", "wsdbm:Genre",
]

NUM_POOL = 1001          # integer literals 0..1000
STR_POOL = 997           # shared string-literal pool

#: entity blocks after the predicates and classes, in id order:
#: (name, term prefix)
BLOCKS: List[Tuple[str, str]] = [
    ("users", "wsdbm:User"), ("products", "wsdbm:Product"),
    ("reviews", "wsdbm:Review"), ("retailers", "wsdbm:Retailer"),
    ("websites", "wsdbm:Website"), ("cities", "gn:City"),
    ("countries", "gn:Country"), ("genres", "sorg:Genre"),
    ("categories", "wsdbm:ProductCategory"),
]


@dataclass
class Graph:
    """One generated graph: ``tt`` int32 ``(N, 3)`` rows ``(s, p, o)``,
    ``terms`` the id-ordered term list, ``counts`` the entity count of
    each block of :data:`BLOCKS` and ``first`` its first id."""

    tt: np.ndarray
    terms: List[str]
    counts: Dict[str, int]
    first: Dict[str, int]


def entity_counts(scale_factor: float) -> Dict[str, int]:
    """The generator's entity counts at ``scale_factor`` (its counts per
    unit scale, with their floors)."""
    s = scale_factor
    return {"users": max(20, int(1000 * s)),
            "products": max(10, int(250 * s)),
            "reviews": max(10, int(1100 * s)),
            "retailers": max(5, int(20 * s)),
            "websites": max(5, int(50 * s)),
            "cities": 100, "countries": 25, "genres": 21, "categories": 12}


def _zipf_targets(rng, n_src: int, n_edges: int, alpha: float = 1.5):
    if n_src == 0 or n_edges == 0:
        return np.zeros(n_src, dtype=np.int64)
    w = (1.0 / np.arange(1, n_src + 1) ** alpha)
    rng.shuffle(w)
    w /= w.sum()
    return rng.multinomial(n_edges, w).astype(np.int64)


def _edges(rng, src_ids, deg, dst_lo: int, dst_n: int):
    s = np.repeat(src_ids, deg)
    o = rng.integers(dst_lo, dst_lo + dst_n, size=s.shape[0], dtype=np.int64)
    return s, o


def generate(scale_factor: float, seed: int) -> Graph:
    """The port's WatDiv graph at ``scale_factor`` from ``seed``."""
    rng = np.random.default_rng(seed)
    counts = entity_counts(scale_factor)
    pred = {p: i for i, p in enumerate(PREDICATES)}
    cls = {c: len(PREDICATES) + i for i, c in enumerate(CLASSES)}
    first: Dict[str, int] = {}
    nxt = len(PREDICATES) + len(CLASSES)
    for name, _ in BLOCKS:
        first[name] = nxt
        nxt += counts[name]
    num0 = nxt
    str0 = num0 + NUM_POOL
    n_terms = str0 + STR_POOL

    U, P, R = counts["users"], counts["products"], counts["reviews"]
    n_ret, n_web = counts["retailers"], counts["websites"]
    n_cit, n_cou = counts["cities"], counts["countries"]

    def ids(name: str) -> np.ndarray:
        lo = first[name]
        return np.arange(lo, lo + counts[name], dtype=np.int64)

    users, products, reviews = ids("users"), ids("products"), ids("reviews")
    retailers, websites, cities = ids("retailers"), ids("websites"), \
        ids("cities")
    product0, retailer0 = first["products"], first["retailers"]
    website0, city0 = first["websites"], first["cities"]

    chunks: List[Tuple[int, np.ndarray, np.ndarray]] = []

    def emit(pname: str, s, o) -> None:
        chunks.append((pred[pname], np.asarray(s), np.asarray(o)))

    def subset(a: np.ndarray, frac: float) -> np.ndarray:
        return rng.choice(a, size=int(round(len(a) * frac)), replace=False)

    emit("rdf:type", users, np.full(U, cls["wsdbm:User"]))
    emit("rdf:type", products,
         first["categories"] + rng.integers(0, counts["categories"], P))
    emit("rdf:type", reviews, np.full(R, cls["wsdbm:Review"]))
    emit("rdf:type", retailers, np.full(n_ret, cls["wsdbm:Retailer"]))
    emit("rdf:type", websites, np.full(n_web, cls["wsdbm:Website"]))

    u_email = subset(users, 0.90)
    emit("sorg:email", u_email, str0 + rng.integers(0, STR_POOL, len(u_email)))
    u_gender = subset(users, 0.77)
    emit("wsdbm:gender", u_gender, str0 + rng.integers(0, 3, len(u_gender)))
    u_age = subset(users, 0.50)
    emit("foaf:age", u_age, num0 + rng.integers(18, 91, len(u_age)))

    u_like = subset(users, 0.50)
    deg = rng.poisson(2.2, len(u_like)) + 1
    emit("wsdbm:likes", *_edges(rng, u_like, deg, product0, P))
    u_buy = subset(users, 0.05)
    deg = rng.poisson(1.5, len(u_buy)) + 1
    emit("wsdbm:purchased", *_edges(rng, u_buy, deg, product0, P))
    u_inviters = subset(users, 0.04)
    n_inv = max(4, int(0.04 * U))
    emit("wsdbm:invitedBy", rng.choice(users, n_inv),
         rng.choice(u_inviters, n_inv) if len(u_inviters) else users[:0])
    u_sub = subset(users, 0.80)
    deg = rng.poisson(1.5, len(u_sub)) + 1
    emit("wsdbm:subscribes", *_edges(rng, u_sub, deg, website0, n_web))

    u_reviewers = subset(users, 0.30)
    emit("rev:reviewer", reviews, rng.choice(u_reviewers, R))
    emit("rev:rating", reviews, num0 + rng.integers(1, 11, R))
    emit("rev:hasReview", rng.integers(product0, product0 + P, R), reviews)

    p_cap = subset(products, 0.60)
    emit("sorg:caption", p_cap, str0 + rng.integers(0, STR_POOL, len(p_cap)))
    emit("sorg:price", products, num0 + rng.integers(1, NUM_POOL, P))
    deg = rng.poisson(1.5, P) + 1
    emit("sorg:hasGenre",
         *_edges(rng, products, deg, first["genres"], counts["genres"]))
    p_sold = rng.integers(retailer0, retailer0 + n_ret, P)
    emit("sorg:soldBy", products, p_sold)
    emit("wsdbm:sells", p_sold, products)

    emit("sorg:locatedIn", retailers, rng.integers(city0, city0 + n_cit, n_ret))
    emit("gn:partOf", cities,
         rng.integers(first["countries"], first["countries"] + n_cou, n_cit))
    emit("sorg:homepage", retailers,
         rng.integers(website0, website0 + n_web, n_ret))
    emit("wsdbm:hits", websites, num0 + rng.integers(0, NUM_POOL, n_web))

    n_other = sum(len(s) for _, s, _ in chunks)
    deg = _zipf_targets(rng, U, n_other)
    emit("wsdbm:follows", *_edges(rng, users, deg, first["users"], U))
    deg = _zipf_targets(rng, U, int(round(n_other * 4 / 3)))
    emit("wsdbm:friendOf", *_edges(rng, users, deg, first["users"], U))

    # one packed key a row orders rows as the lexicographic (s, p, o) sort
    n_pred = len(PREDICATES)
    if n_terms ** 2 * n_pred >= 2 ** 63:
        raise ValueError(f"{n_terms} terms overflow the packed row key")
    key = np.concatenate([
        (s.astype(np.int64) * n_pred + pid) * n_terms + o.astype(np.int64)
        for pid, s, o in chunks])
    key.sort()
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    tt = np.empty((len(key), 3), dtype=np.int32)
    so, tt[:, 2] = np.divmod(key, n_terms)
    tt[:, 0], tt[:, 1] = np.divmod(so, n_pred)
    tt = tt[rng.permutation(len(tt))]

    terms = list(PREDICATES) + list(CLASSES)
    for name, prefix in BLOCKS:
        terms.extend(f"{prefix}{i}" for i in range(counts[name]))
    terms.extend(f'"{v}"' for v in range(NUM_POOL))
    terms.extend(f'"str{i}"' for i in range(STR_POOL))
    assert len(terms) == n_terms
    return Graph(tt=tt, terms=terms, counts=counts, first=first)


#: stream of the seed's generator that draws the relabelling
RELABEL_STREAM = 4


def renaming(counts: Dict[str, int], seed: int) -> Dict[str, np.ndarray]:
    """The permutation of every block of :data:`BLOCKS` that
    :func:`relabel` applies for ``seed``: entity ``i`` of a block is
    renamed ``renaming[block][i]``."""
    rng = np.random.default_rng([seed, RELABEL_STREAM])
    return {name: rng.permutation(counts[name]).astype(np.int32)
            for name, _ in BLOCKS}


def relabel(graph: Graph, seed: int) -> Graph:
    """``graph`` with the entities of every block renamed by a permutation
    drawn from ``seed`` (:func:`renaming`): ``User5`` takes the edges some
    other user had.  The graph is the same up to those names, so every
    seed gives a graph with the same table sizes, degrees and join sizes,
    and a query whose constants are renamed alike has the same answer up
    to names.  Predicates, classes and literals keep their ids (a
    literal's value is its name)."""
    perm = np.arange(len(graph.terms), dtype=np.int32)
    for name, block in renaming(graph.counts, seed).items():
        lo = graph.first[name]
        perm[lo:lo + len(block)] = lo + block
    return Graph(tt=perm[graph.tt], terms=graph.terms, counts=graph.counts,
                 first=graph.first)
