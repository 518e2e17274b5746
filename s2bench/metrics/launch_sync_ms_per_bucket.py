"""Mean over buckets of the time the host waited on the stream: the
``head_sync`` spans (the copy of the head of row counts,
``PlanExecutor._launch``) under the ``device.launch`` spans of each
bucket's lead ``execute`` span.  ``launch_ms_per_bucket`` less this is
the host's dispatch of the launch sequence.  Nothing when the program
opens no ``head_sync`` span."""


def read(run):
    buckets, total, seen = 0, 0.0, False
    for r in run.requests:
        tr = r.trace
        if tr is None:
            continue
        spans = tr.spans
        for ex in spans:
            if ex.name != "execute" or ex.t1 is None or \
                    ex.attrs.get("shared_launch", True):
                continue
            launches = {s.sid for s in spans if s.name == "device.launch"
                        and s.parent == ex.sid}
            syncs = [s for s in spans if s.name == "head_sync"
                     and s.parent in launches and s.t1 is not None]
            seen = seen or bool(syncs)
            total += sum((s.t1 - s.t0) * 1e3 for s in syncs)
            buckets += 1
    return total / buckets if seen else None
