"""WatDiv-like scalable RDF graph generator.

The paper evaluates on the Waterloo SPARQL Diversity Test Suite (WatDiv)
[Aluç et al., §7].  The original generator is a C++ tool; this module is a
vectorized numpy re-implementation of its *relevant structure*: an
e-commerce + social-network schema whose predicate cardinalities match the
figures the paper reports and whose correlation selectivities reproduce the
selectivity classes used in the paper's Selectivity Testing (ST) use case
(§7.1):

* ``friendOf``  ~ 0.4 |G|   (the largest predicate; ST-1, ST-5, IL paths)
* ``follows``   ~ 0.3 |G|   (second largest; together 0.7 |G|, §7.3)
* ``likes``     ~ 0.01 |G|  (small-input predicate, ST-4)
* ``reviewer``  ~ 0.01 |G|  (small-input predicate, ST-2)
* OS-correlation selectivities vs ``friendOf`` of ~0.9 / ~0.5 / ~0.05
  (via ``email`` / ``likes`` / ``purchased`` subject coverage)
* SS-correlation selectivities of ~0.9 / ~0.77 (via ``email`` / ``gender``)
* SO-correlation selectivities of ~0.9 / ~0.3 / ~0.04
  (via ``follows`` / ``reviewer`` / ``invitedBy`` object coverage)
* structurally-empty correlations (e.g. literal objects joined against
  entity subjects) so that ST-8's statistics-only ∅ answer is exercised.

Entity id layout is blocked so term strings can be materialized lazily and
the generator stays O(N) vectorized:

    [predicates | classes | users | products | reviews | retailers |
     websites | cities | countries | genres | categories |
     integer literals 0..NUM_POOL | string-literal pool]

Scale: ``scale_factor=1.0`` produces 29,583 triples (measured with
``seed=0``), and the count grows about linearly with the scale: 10 gives
295,757, and about 340 gives the 10M triples of the paper's smallest
WatDiv dataset.  Everything is deterministic given
``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.rdf.dictionary import Dictionary

# --------------------------------------------------------------------------
# Schema
# --------------------------------------------------------------------------

PREDICATES: List[str] = [
    "rdf:type",          # everything
    "wsdbm:follows",     # user -> user         ~0.3 |G|
    "wsdbm:friendOf",    # user -> user         ~0.4 |G|
    "wsdbm:likes",       # user -> product      ~1%  (50% of users)
    "wsdbm:purchased",   # user -> product      (5% of users)     OS low
    "wsdbm:invitedBy",   # user -> user         (4% object cover) SO low
    "sorg:email",        # user -> literal      (90% of users)    OS/SS high
    "wsdbm:gender",      # user -> literal      (77% of users)    SS mid
    "foaf:age",          # user -> int literal  (50% of users)    OS mid
    "wsdbm:subscribes",  # user -> website      (80% of users)
    "rev:reviewer",      # review -> user       ~1%
    "rev:rating",        # review -> int literal
    "rev:hasReview",     # product -> review
    "sorg:caption",      # product -> literal   (60% of products)
    "sorg:price",        # product -> int literal
    "sorg:hasGenre",     # product -> genre
    "sorg:soldBy",       # product -> retailer
    "wsdbm:sells",       # retailer -> product
    "sorg:locatedIn",    # retailer -> city
    "gn:partOf",         # city -> country
    "sorg:homepage",     # retailer -> website
    "wsdbm:hits",        # website -> int literal
]

CLASSES: List[str] = [
    "wsdbm:User",
    "wsdbm:Product",
    "wsdbm:Review",
    "wsdbm:Retailer",
    "wsdbm:Website",
    "wsdbm:City",
    "wsdbm:Country",
    "wsdbm:Genre",
]

NUM_POOL = 1001          # integer literals 0..1000
STR_POOL = 997           # shared string-literal pool (emails/captions/genders)


@dataclass
class WatDivConfig:
    scale_factor: float = 1.0
    seed: int = 0
    # entity counts per unit scale factor
    users_per_sf: int = 1000
    products_per_sf: int = 250
    reviews_per_sf: int = 1100
    retailers_per_sf: int = 20
    websites_per_sf: int = 50
    n_cities: int = 100
    n_countries: int = 25
    n_genres: int = 21
    n_categories: int = 12

    @property
    def n_users(self) -> int:
        return max(20, int(self.users_per_sf * self.scale_factor))

    @property
    def n_products(self) -> int:
        return max(10, int(self.products_per_sf * self.scale_factor))

    @property
    def n_reviews(self) -> int:
        return max(10, int(self.reviews_per_sf * self.scale_factor))

    @property
    def n_retailers(self) -> int:
        return max(5, int(self.retailers_per_sf * self.scale_factor))

    @property
    def n_websites(self) -> int:
        return max(5, int(self.websites_per_sf * self.scale_factor))


@dataclass
class WatDivSchema:
    """Id layout + handles the query workloads need."""

    pred: Dict[str, int] = field(default_factory=dict)
    cls: Dict[str, int] = field(default_factory=dict)
    user0: int = 0
    n_users: int = 0
    product0: int = 0
    n_products: int = 0
    review0: int = 0
    n_reviews: int = 0
    retailer0: int = 0
    n_retailers: int = 0
    website0: int = 0
    n_websites: int = 0
    city0: int = 0
    n_cities: int = 0
    country0: int = 0
    n_countries: int = 0
    genre0: int = 0
    n_genres: int = 0
    category0: int = 0
    n_categories: int = 0
    num0: int = 0        # id of integer literal "0"
    str0: int = 0
    n_terms: int = 0

    def num_literal(self, v: int) -> int:
        assert 0 <= v < NUM_POOL
        return self.num0 + v


def _zipf_targets(rng: np.random.Generator, n_src: int, n_edges: int,
                  alpha: float = 1.5) -> np.ndarray:
    """Zipf-ish out-degree allocation: returns int64[n_src] summing n_edges."""
    if n_src == 0 or n_edges == 0:
        return np.zeros(n_src, dtype=np.int64)
    w = (1.0 / np.arange(1, n_src + 1) ** alpha)
    rng.shuffle(w)
    w /= w.sum()
    deg = rng.multinomial(n_edges, w)
    return deg.astype(np.int64)


def _edges(rng: np.random.Generator, src_ids: np.ndarray, deg: np.ndarray,
           dst_lo: int, dst_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-source degrees into (s, o) edge arrays with random targets."""
    s = np.repeat(src_ids, deg)
    o = rng.integers(dst_lo, dst_lo + dst_n, size=s.shape[0], dtype=np.int64)
    return s, o


def generate_watdiv(cfg: WatDivConfig) -> Tuple[np.ndarray, Dictionary, WatDivSchema]:
    """Generate the graph.  Returns (tt int32[N,3], dictionary, schema)."""
    rng = np.random.default_rng(cfg.seed)
    sch = WatDivSchema()

    # ---- id layout ---------------------------------------------------------
    next_id = 0

    def block(n: int) -> int:
        nonlocal next_id
        lo = next_id
        next_id += n
        return lo

    for p in PREDICATES:
        sch.pred[p] = block(1)
    for c in CLASSES:
        sch.cls[c] = block(1)
    sch.user0, sch.n_users = block(cfg.n_users), cfg.n_users
    sch.product0, sch.n_products = block(cfg.n_products), cfg.n_products
    sch.review0, sch.n_reviews = block(cfg.n_reviews), cfg.n_reviews
    sch.retailer0, sch.n_retailers = block(cfg.n_retailers), cfg.n_retailers
    sch.website0, sch.n_websites = block(cfg.n_websites), cfg.n_websites
    sch.city0, sch.n_cities = block(cfg.n_cities), cfg.n_cities
    sch.country0, sch.n_countries = block(cfg.n_countries), cfg.n_countries
    sch.genre0, sch.n_genres = block(cfg.n_genres), cfg.n_genres
    sch.category0, sch.n_categories = block(cfg.n_categories), cfg.n_categories
    sch.num0 = block(NUM_POOL)
    sch.str0 = block(STR_POOL)
    sch.n_terms = next_id

    U, P, R = cfg.n_users, cfg.n_products, cfg.n_reviews
    users = np.arange(sch.user0, sch.user0 + U, dtype=np.int64)
    products = np.arange(sch.product0, sch.product0 + P, dtype=np.int64)
    reviews = np.arange(sch.review0, sch.review0 + R, dtype=np.int64)
    retailers = np.arange(sch.retailer0, sch.retailer0 + cfg.n_retailers, dtype=np.int64)
    websites = np.arange(sch.website0, sch.website0 + cfg.n_websites, dtype=np.int64)
    cities = np.arange(sch.city0, sch.city0 + cfg.n_cities, dtype=np.int64)

    chunks: List[Tuple[int, np.ndarray, np.ndarray]] = []  # (pred id, s, o)

    def emit(pname: str, s: np.ndarray, o: np.ndarray) -> None:
        chunks.append((sch.pred[pname], np.asarray(s), np.asarray(o)))

    def subset(ids: np.ndarray, frac: float) -> np.ndarray:
        k = int(round(len(ids) * frac))
        return rng.choice(ids, size=k, replace=False)

    # ---- "other" predicates first; friendOf/follows sized from their total -
    # rdf:type
    emit("rdf:type", users, np.full(U, sch.cls["wsdbm:User"]))
    emit("rdf:type", products,
         sch.category0 + rng.integers(0, cfg.n_categories, P))
    emit("rdf:type", reviews, np.full(R, sch.cls["wsdbm:Review"]))
    emit("rdf:type", retailers, np.full(cfg.n_retailers, sch.cls["wsdbm:Retailer"]))
    emit("rdf:type", websites, np.full(cfg.n_websites, sch.cls["wsdbm:Website"]))

    # user attributes (subject coverage tuned for ST selectivity classes)
    u_email = subset(users, 0.90)
    emit("sorg:email", u_email, sch.str0 + rng.integers(0, STR_POOL, len(u_email)))
    u_gender = subset(users, 0.77)
    emit("wsdbm:gender", u_gender,
         sch.str0 + rng.integers(0, 3, len(u_gender)))
    u_age = subset(users, 0.50)
    emit("foaf:age", u_age,
         sch.num0 + rng.integers(18, 91, len(u_age)))

    # user -> product (likes: 50% of users, avg 2.2 products)
    u_like = subset(users, 0.50)
    deg = rng.poisson(2.2, len(u_like)) + 1
    emit("wsdbm:likes", *_edges(rng, u_like, deg, sch.product0, P))

    # user -> product (purchased: 5% of users)  -> OS(friendOf|purchased)~0.05
    u_buy = subset(users, 0.05)
    deg = rng.poisson(1.5, len(u_buy)) + 1
    emit("wsdbm:purchased", *_edges(rng, u_buy, deg, sch.product0, P))

    # user -> user (invitedBy: objects cover ~4% of users) -> SO low
    u_inviters = subset(users, 0.04)
    n_inv = max(4, int(0.04 * U))
    emit("wsdbm:invitedBy",
         rng.choice(users, n_inv),
         rng.choice(u_inviters, n_inv) if len(u_inviters) else users[:0])

    # user -> website
    u_sub = subset(users, 0.80)
    deg = rng.poisson(1.5, len(u_sub)) + 1
    emit("wsdbm:subscribes", *_edges(rng, u_sub, deg, sch.website0, cfg.n_websites))

    # reviews: written by 30% of users -> SO(.|reviewer)~0.3
    u_reviewers = subset(users, 0.30)
    emit("rev:reviewer", reviews, rng.choice(u_reviewers, R))
    emit("rev:rating", reviews, sch.num0 + rng.integers(1, 11, R))
    emit("rev:hasReview", rng.integers(sch.product0, sch.product0 + P, R), reviews)

    # products
    p_cap = subset(products, 0.60)
    emit("sorg:caption", p_cap, sch.str0 + rng.integers(0, STR_POOL, len(p_cap)))
    emit("sorg:price", products, sch.num0 + rng.integers(1, NUM_POOL, P))
    deg = rng.poisson(1.5, P) + 1
    emit("sorg:hasGenre", *_edges(rng, products, deg, sch.genre0, cfg.n_genres))
    p_sold = rng.integers(sch.retailer0, sch.retailer0 + cfg.n_retailers, P)
    emit("sorg:soldBy", products, p_sold)
    emit("wsdbm:sells", p_sold, products)      # inverse edges

    # retailers / websites / geo
    emit("sorg:locatedIn", retailers,
         rng.integers(sch.city0, sch.city0 + cfg.n_cities, cfg.n_retailers))
    emit("gn:partOf", cities,
         rng.integers(sch.country0, sch.country0 + cfg.n_countries, cfg.n_cities))
    emit("sorg:homepage", retailers,
         rng.integers(sch.website0, sch.website0 + cfg.n_websites, cfg.n_retailers))
    emit("wsdbm:hits", websites, sch.num0 + rng.integers(0, NUM_POOL, cfg.n_websites))

    n_other = sum(len(s) for _, s, _ in chunks)

    # ---- the two giant social predicates (0.4 / 0.3 of |G|) ----------------
    # other : follows : friendOf  =  3 : 3 : 4  =>  |G| ~ n_other * 10/3
    n_follows = n_other
    n_friend = int(round(n_other * 4 / 3))
    deg = _zipf_targets(rng, U, n_follows)
    emit("wsdbm:follows", *_edges(rng, users, deg, sch.user0, U))
    deg = _zipf_targets(rng, U, n_friend)
    emit("wsdbm:friendOf", *_edges(rng, users, deg, sch.user0, U))

    # ---- assemble ----------------------------------------------------------
    n_total = sum(len(s) for _, s, _ in chunks)
    tt = np.empty((n_total, 3), dtype=np.int32)
    pos = 0
    for pid, s, o in chunks:
        k = len(s)
        tt[pos:pos + k, 0] = s
        tt[pos:pos + k, 1] = pid
        tt[pos:pos + k, 2] = o
        pos += k
    # deduplicate (multi-edges collapse, like real RDF sets)
    tt = np.unique(tt, axis=0)
    rng.shuffle(tt, axis=0)

    d = _build_dictionary(sch)
    return tt, d, sch


def _build_dictionary(sch: WatDivSchema) -> Dictionary:
    """Materialize term strings for the blocked id layout."""
    d = Dictionary()
    for p in PREDICATES:
        d.add(p)
    for c in CLASSES:
        d.add(c)

    def addrange(prefix: str, lo: int, n: int) -> None:
        assert len(d) == lo, (prefix, len(d), lo)
        for i in range(n):
            d.add(f"{prefix}{i}")

    addrange("wsdbm:User", sch.user0, sch.n_users)
    addrange("wsdbm:Product", sch.product0, sch.n_products)
    addrange("wsdbm:Review", sch.review0, sch.n_reviews)
    addrange("wsdbm:Retailer", sch.retailer0, sch.n_retailers)
    addrange("wsdbm:Website", sch.website0, sch.n_websites)
    addrange("gn:City", sch.city0, sch.n_cities)
    addrange("gn:Country", sch.country0, sch.n_countries)
    addrange("sorg:Genre", sch.genre0, sch.n_genres)
    addrange("wsdbm:ProductCategory", sch.category0, sch.n_categories)
    assert len(d) == sch.num0
    for v in range(NUM_POOL):
        d.add(f'"{v}"')
    for i in range(STR_POOL):
        d.add(f'"str{i}"')
    assert len(d) == sch.n_terms
    return d
