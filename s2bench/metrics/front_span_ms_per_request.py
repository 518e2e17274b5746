"""Host time of the engine's front end a request, from the program's own
``front`` spans (``Engine.query_batch``): one a signature group, on its
first traced request, over the signature grouping, the routing, the
plan-cache lookups (``parse`` / ``plan`` / ``verify`` inside it on a
miss) and the binding of each request's constants.  Σ their durations
over Σ their ``requests``; nothing when the program opens no such span."""


def read(run):
    ms = n = 0.0
    for r in run.requests:
        tr = r.trace
        if tr is None:
            continue
        for s in tr.spans:
            if s.name == "front" and s.t1 is not None:
                ms += (s.t1 - s.t0) * 1e3
                n += s.attrs.get("requests", 0)
    return ms / n if n else None
