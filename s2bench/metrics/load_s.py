"""Seconds of the load path, as the program times them
(``Dataset.storage_report()``): the VP build and statistics
(``core/vp.py``, ``core/stats.py``) plus the ExtVP build on the card
(``core/extvp_build.py``; 0 for a store without ExtVP)."""


def read(run):
    s = run.storage
    return s["vp_build_seconds"] + s["extvp_build_seconds"]
