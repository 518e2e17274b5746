"""Share of the profiler's slice of the window in which no kernel, copy
or memset ran on the card: 1 - busy / slice, from the device trace."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
