"""Quickstart on the PyTorch port: the paper's running example (Figs.
1–12) end to end, through the ``repro_torch`` ``Dataset``/``Engine`` API.

Builds graph G1, constructs VP + ExtVP with statistics, compiles query Q1
showing Algorithm-1 table selection + Algorithm-4 join ordering, and
executes it on the host engine, the static-capacity torch engine and the
VP storage baseline.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

from repro_torch import Dataset


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the dataset and the torch engine")
    args = ap.parse_args()

    # --- Fig. 1: RDF graph G1 -------------------------------------------------
    triples = [
        ("A", "follows", "B"), ("B", "follows", "C"), ("B", "follows", "D"),
        ("C", "follows", "D"), ("A", "likes", "I1"), ("A", "likes", "I2"),
        ("C", "likes", "I2"),
    ]
    ds = Dataset.from_triples(triples, device=args.device)
    print(f"G1: {ds.n_triples} triples, {len(ds.dictionary)} terms")

    # --- §5: VP + ExtVP construction -------------------------------------------
    rep = ds.storage_report()
    print(f"VP tables: {int(rep['vp_tables'])}  "
          f"ExtVP materialized: {int(rep['extvp_tables'])}  "
          f"(empty: {int(rep['extvp_empty'])}, identity: {int(rep['extvp_identity'])})")
    f, l = ds.dictionary.id_of("follows"), ds.dictionary.id_of("likes")
    print(f"SF(ExtVP^OS_follows|likes) = {ds.catalog.sf('OS', f, l)}   # Fig. 10: 0.25")

    # --- §6: query Q1 -----------------------------------------------------------
    q1 = ("SELECT * WHERE { ?x likes ?w . ?x follows ?y . "
          "?y follows ?z . ?z likes ?w }")
    eager = ds.engine("eager")
    print("\ncompiled plan (table selection + join order):")
    print(" ", eager.explain(q1))

    res = eager.query(q1)
    print("\nresult (paper: ?x→A ?y→B ?z→C ?w→I2):")
    for row in res.to_terms():
        print(" ", row)

    # --- device path -------------------------------------------------------------
    res_torch = ds.engine("torch").query(q1)
    print(f"\nstatic-capacity torch engine agrees: {res_torch.same_as(res)}")

    # --- baseline comparison (column order differs; bag comparison aligns) ------
    res_vp = ds.engine("eager", layout="vp").query(q1)
    print(f"VP baseline result identical: {res_vp.same_as(res)}")


if __name__ == "__main__":
    main()
