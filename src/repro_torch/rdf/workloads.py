"""WatDiv query workloads (paper §7).

Three use cases, matching the paper's experimental design:

* **ST — Selectivity Testing** (§7.1, Appendix B): pairs/triples of
  patterns whose ExtVP tables span the selectivity classes the paper
  sweeps (OS 0.9/0.5/0.05, SO 0.9/0.3/0.04, SS 0.9/0.77, plus the
  statistics-only-empty ST-8 pair).
* **Basic Testing** (§7.2, Appendix A): 20 templates over four shapes —
  star (S1–S7), linear (L1–L5), snowflake (F1–F5), complex (C1–C3).
* **IL — Incremental Linear Testing** (§7.3, Appendix C): linear chains
  of diameter 5..10, user-bound (IL-1), retailer-bound (IL-2) and
  unbound (IL-3).

The WatDiv appendices are not redistributed with the paper text, so the
templates here are reconstructed to the documented shape/selectivity
classes over this generator's schema; ``%x%`` placeholders instantiate to
random entities (deterministic per seed), as the WatDiv driver does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.rdf.generator import WatDivSchema

# ---------------------------------------------------------------------------
# Selectivity Testing (ST)
# ---------------------------------------------------------------------------

ST_QUERIES: Dict[str, str] = {
    # OS effectiveness, big first table (|VP_friendOf| ~ 0.4|G|)
    "ST-1-1": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v1 sorg:email ?v2 }",
    "ST-1-2": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v1 wsdbm:likes ?v2 }",
    "ST-1-3": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v1 wsdbm:purchased ?v2 }",
    # OS effectiveness, small first table (|VP_reviewer| ~ 0.01|G|)
    "ST-2-1": "SELECT * WHERE { ?v0 rev:reviewer ?v1 . ?v1 sorg:email ?v2 }",
    "ST-2-2": "SELECT * WHERE { ?v0 rev:reviewer ?v1 . ?v1 wsdbm:likes ?v2 }",
    "ST-2-3": "SELECT * WHERE { ?v0 rev:reviewer ?v1 . ?v1 wsdbm:purchased ?v2 }",
    # SO effectiveness, big second table
    "ST-3-1": "SELECT * WHERE { ?v0 wsdbm:follows ?v1 . ?v1 wsdbm:friendOf ?v2 }",
    "ST-3-2": "SELECT * WHERE { ?v0 rev:reviewer ?v1 . ?v1 wsdbm:friendOf ?v2 }",
    "ST-3-3": "SELECT * WHERE { ?v0 wsdbm:invitedBy ?v1 . ?v1 wsdbm:friendOf ?v2 }",
    # SO effectiveness, small second table
    "ST-4-1": "SELECT * WHERE { ?v0 wsdbm:follows ?v1 . ?v1 wsdbm:likes ?v2 }",
    "ST-4-2": "SELECT * WHERE { ?v0 rev:reviewer ?v1 . ?v1 wsdbm:likes ?v2 }",
    "ST-4-3": "SELECT * WHERE { ?v0 wsdbm:invitedBy ?v1 . ?v1 wsdbm:likes ?v2 }",
    # SS effectiveness
    "ST-5-1": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v0 sorg:email ?v2 }",
    "ST-5-2": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v0 wsdbm:gender ?v2 }",
    # high selectivity on small inputs (linear / star)
    "ST-6-1": "SELECT * WHERE { ?v0 wsdbm:invitedBy ?v1 . ?v1 wsdbm:purchased ?v2 }",
    "ST-6-2": "SELECT * WHERE { ?v0 wsdbm:purchased ?v1 . ?v0 wsdbm:invitedBy ?v2 }",
    # OS-vs-SO choice in a chain (middle pattern has both candidates)
    "ST-7-1": "SELECT * WHERE { ?v0 wsdbm:follows ?v1 . ?v1 wsdbm:friendOf ?v2 . "
              "?v2 wsdbm:purchased ?v3 }",
    "ST-7-2": "SELECT * WHERE { ?v0 wsdbm:invitedBy ?v1 . ?v1 wsdbm:friendOf ?v2 . "
              "?v2 sorg:email ?v3 }",
    # statistics-only empty answers
    "ST-8-1": "SELECT * WHERE { ?v0 sorg:price ?v1 . ?v1 wsdbm:follows ?v2 }",
    "ST-8-2": "SELECT * WHERE { ?v0 wsdbm:friendOf ?v1 . ?v1 wsdbm:follows ?v2 . "
              "?v2 sorg:hasGenre ?v3 }",
}

# ---------------------------------------------------------------------------
# Basic Testing (S/L/F/C)
# ---------------------------------------------------------------------------

BASIC_TEMPLATES: Dict[str, str] = {
    # --- star ---
    "S1": "SELECT * WHERE { ?v0 sorg:soldBy %retailer% . ?v0 sorg:price ?v2 . "
          "?v0 rdf:type ?v3 . ?v0 sorg:caption ?v4 . ?v0 sorg:hasGenre ?v5 }",
    "S2": "SELECT * WHERE { ?v0 wsdbm:gender %gender% . ?v0 sorg:email ?v2 . "
          "?v0 rdf:type wsdbm:User }",
    "S3": "SELECT * WHERE { ?v0 rdf:type %category% . ?v0 sorg:caption ?v1 . "
          "?v0 sorg:price ?v2 . ?v0 sorg:hasGenre ?v3 }",
    "S4": "SELECT * WHERE { ?v0 wsdbm:subscribes %website% . ?v0 sorg:email ?v1 . "
          "?v0 foaf:age ?v2 }",
    "S5": "SELECT * WHERE { ?v0 rev:rating %rating% . ?v0 rev:reviewer ?v1 }",
    "S6": "SELECT * WHERE { ?v0 sorg:locatedIn ?v1 . ?v0 sorg:homepage ?v2 . "
          "?v0 wsdbm:sells ?v3 }",
    "S7": "SELECT * WHERE { ?v0 wsdbm:likes %product% . ?v0 wsdbm:gender ?v1 . "
          "?v0 sorg:email ?v2 }",
    # --- linear ---
    "L1": "SELECT * WHERE { %user% wsdbm:follows ?v1 . ?v1 wsdbm:likes ?v2 . "
          "?v2 sorg:price ?v3 }",
    "L2": "SELECT * WHERE { ?v0 wsdbm:likes %product% . ?v0 wsdbm:friendOf ?v1 . "
          "?v1 sorg:email ?v2 }",
    "L3": "SELECT * WHERE { %retailer% wsdbm:sells ?v1 . ?v1 rev:hasReview ?v2 . "
          "?v2 rev:rating ?v3 }",
    "L4": "SELECT * WHERE { ?v0 sorg:locatedIn ?v1 . ?v1 gn:partOf %country% }",
    "L5": "SELECT * WHERE { %user% wsdbm:friendOf ?v1 . ?v1 wsdbm:subscribes ?v2 . "
          "?v2 wsdbm:hits ?v3 }",
    # --- snowflake ---
    "F1": "SELECT * WHERE { ?v0 rev:hasReview ?v1 . ?v1 rev:rating ?v2 . "
          "?v1 rev:reviewer ?v3 . ?v0 sorg:price ?v4 . ?v0 sorg:soldBy ?v5 . "
          "?v5 sorg:locatedIn ?v6 }",
    "F2": "SELECT * WHERE { ?v0 wsdbm:likes ?v1 . ?v0 wsdbm:friendOf ?v2 . "
          "?v2 sorg:email ?v3 . ?v1 sorg:price ?v4 . ?v1 sorg:hasGenre %genre% }",
    "F3": "SELECT * WHERE { %retailer% wsdbm:sells ?v1 . ?v1 sorg:hasGenre ?v2 . "
          "?v1 rev:hasReview ?v3 . ?v3 rev:reviewer ?v4 . ?v4 wsdbm:gender ?v5 }",
    "F4": "SELECT * WHERE { ?v0 wsdbm:subscribes ?v1 . ?v1 wsdbm:hits ?v2 . "
          "?v0 wsdbm:likes ?v3 . ?v3 sorg:caption ?v4 . ?v0 foaf:age ?v5 . "
          "FILTER(?v5 > 40) }",
    "F5": "SELECT * WHERE { ?v0 rev:hasReview ?v1 . ?v1 rev:rating ?v2 . "
          "?v1 rev:reviewer ?v3 . ?v3 wsdbm:follows ?v4 . ?v0 sorg:soldBy %retailer% . "
          "FILTER(?v2 > 5) }",
    # --- complex ---
    "C1": "SELECT * WHERE { ?v0 wsdbm:follows ?v1 . ?v1 wsdbm:friendOf ?v2 . "
          "?v2 wsdbm:likes ?v3 . ?v3 rev:hasReview ?v4 . ?v4 rev:reviewer ?v5 . "
          "?v5 sorg:email ?v6 }",
    "C2": "SELECT * WHERE { ?v0 wsdbm:likes ?v1 . ?v1 sorg:soldBy ?v2 . "
          "?v2 wsdbm:sells ?v3 . ?v3 rev:hasReview ?v4 . ?v4 rev:reviewer ?v5 . "
          "?v5 wsdbm:friendOf ?v6 . ?v5 foaf:age ?v7 . FILTER(?v7 < 30) }",
    "C3": "SELECT * WHERE { ?v0 wsdbm:likes ?v1 . ?v0 wsdbm:friendOf ?v2 . "
          "?v0 wsdbm:gender ?v3 . OPTIONAL { ?v0 foaf:age ?v4 } }",
}

# ---------------------------------------------------------------------------
# Incremental Linear Testing (IL)
# ---------------------------------------------------------------------------

_IL1_EDGES = ["wsdbm:follows", "wsdbm:friendOf", "wsdbm:likes", "rev:hasReview",
              "rev:reviewer", "wsdbm:follows", "wsdbm:friendOf", "wsdbm:likes",
              "rev:hasReview", "rev:reviewer"]
_IL2_EDGES = ["wsdbm:sells", "rev:hasReview", "rev:reviewer", "wsdbm:follows",
              "wsdbm:friendOf", "wsdbm:likes", "rev:hasReview", "rev:reviewer",
              "wsdbm:follows", "wsdbm:friendOf"]


def il_query(kind: int, diameter: int, start: str = "?v0") -> str:
    """IL-<kind>-<diameter>; kind 1 = user-bound, 2 = retailer-bound,
    3 = unbound (IL-1 edge sequence)."""
    assert 5 <= diameter <= 10
    edges = _IL2_EDGES if kind == 2 else _IL1_EDGES
    tps = []
    subj = start if kind != 3 else "?v0"
    for i, p in enumerate(edges[:diameter]):
        obj = f"?v{i + 1}"
        tps.append(f"{subj} {p} {obj}")
        subj = obj
    return "SELECT * WHERE { " + " . ".join(tps) + " }"


def instantiate(template: str, sch: WatDivSchema, rng: np.random.Generator) -> str:
    """Fill %placeholders% with random entities of the right class."""
    def pick(lo, n):
        return int(rng.integers(lo, lo + n))

    subs = {
        "%retailer%": f"wsdbm:Retailer{pick(0, sch.n_retailers)}",
        "%user%": f"wsdbm:User{pick(0, sch.n_users)}",
        "%product%": f"wsdbm:Product{pick(0, sch.n_products)}",
        "%website%": f"wsdbm:Website{pick(0, sch.n_websites)}",
        "%country%": f"gn:Country{pick(0, sch.n_countries)}",
        "%genre%": f"sorg:Genre{pick(0, sch.n_genres)}",
        "%category%": f"wsdbm:ProductCategory{pick(0, sch.n_categories)}",
        "%gender%": f'"str{pick(0, 3)}"',
        "%rating%": f'"{pick(1, 10)}"',
    }
    out = template
    for k, v in subs.items():
        out = out.replace(k, v)
    return out


def basic_queries(sch: WatDivSchema, seed: int = 0,
                  n_instances: int = 3) -> Dict[str, List[str]]:
    rng = np.random.default_rng(seed)
    return {name: [instantiate(t, sch, rng) for _ in range(n_instances)]
            for name, t in BASIC_TEMPLATES.items()}


def il_queries(sch: WatDivSchema, seed: int = 0, n_instances: int = 3,
               il3_max_diameter: int = 6) -> Dict[str, List[str]]:
    """IL-3 (fully unbound) result sets grow ~10× per hop — the paper's
    own Table 5 shows 'F' (failure) entries for several systems there; on
    a single host we cap IL-3 at ``il3_max_diameter`` and report the rest
    as F."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List[str]] = {}
    for diameter in range(5, 11):
        out[f"IL-1-{diameter}"] = [
            il_query(1, diameter, f"wsdbm:User{rng.integers(0, sch.n_users)}")
            for _ in range(n_instances)]
        out[f"IL-2-{diameter}"] = [
            il_query(2, diameter,
                     f"wsdbm:Retailer{rng.integers(0, sch.n_retailers)}")
            for _ in range(n_instances)]
        if diameter <= il3_max_diameter:
            out[f"IL-3-{diameter}"] = [il_query(3, diameter)]
    return out
