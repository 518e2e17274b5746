"""The join-probe kernel's share of its roofline over the window
(``kernels/ops.py::join_probe`` -> ``csrc/join_probe.cu``): the sum over
every call of its byte bound (probe keys read once, both int32 outputs
written once, build keys read once, at 3.35 TB/s) over the sum of its
CUDA-event times."""


def read(run):
    p = run.probe
    if not p or p["event_ms"] <= 0:
        return None
    return 100.0 * p["bound_ms"] / p["event_ms"]
