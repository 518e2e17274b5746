"""Share of the profiler's slice in which the card is idle and the host
is inside no profiler range or operator: the ``no host event`` entry of
the device trace's idle gaps (:func:`s2bench.devtrace.reduce_trace`)
over the slice.  Once the program's spans open ``repro.<span>`` ranges,
that is the host outside every program call: the client loop.

The breakdown keeps the :data:`~s2bench.devtrace.TOP` largest gaps.
When the entry is not among them and the list is full, the last listed
entry's seconds are read, an upper bound; when the list is not full,
there was no such gap and the share is 0."""

from s2bench.devtrace import TOP

NO_HOST = "no host event"


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    gaps = p["breakdown"]["idle_gaps"]
    by_name = dict((k, v) for k, v in gaps)
    if NO_HOST in by_name:
        seconds = by_name[NO_HOST]
    elif len(gaps) >= TOP:
        seconds = gaps[-1][1]
    else:
        seconds = 0.0
    return 100.0 * seconds / p["window_s"]
