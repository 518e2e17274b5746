"""Rate of the copy of the answers' rows to the host: Σ ``bytes`` of the
program's ``copyback`` spans (every binding's rows, ``PlanExecutor._launch``)
over Σ their seconds, in GB/s.  Nothing when the program opens no such
span."""


def read(run):
    nbytes = seconds = 0.0
    for r in run.requests:
        tr = r.trace
        if tr is None:
            continue
        for s in tr.spans:
            if s.name == "copyback" and s.t1 is not None:
                nbytes += s.attrs.get("bytes", 0)
                seconds += s.t1 - s.t0
    return nbytes / seconds / 1e9 if seconds > 0 else None
