"""``correct`` must come out false when the served answers are wrong:
the control (the reference with answers cut short), and the program
broken underneath the timed path, each fault the cells can have.  These
runs skip the harness's look for a card and use a small graph on the
CPU; the rest of a run is the benchmark's own.

A cell on one chip has no exchange between chips to leave out."""

import time

import numpy as np
import pytest

from repro_torch.core import jexec

from s2bench.cell import run_cell
from s2bench.control import run_control

CELLS = ["extvp.basic.c576"]
SCALE, SECONDS = 1.0, 1.5


def run(cell, seed=2 ** 32 + 11):
    line, notes, _ = run_cell(cell, seed, SECONDS, False, time.perf_counter(),
                              device="cpu", scale=SCALE)
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    out = run_control(cell, 2 ** 32 + 5, SECONDS, scale=SCALE)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def stale(monkeypatch):
    """An answer kept between requests: every bucket of a template gets
    the rows its first bucket got (a step that returns its state
    unchanged)."""
    inner = jexec.PlanExecutor.run_batch
    memo = {}

    def run_batch(self, bounds_batch, *a, **k):
        out = inner(self, bounds_batch, *a, **k)
        first = memo.setdefault(id(self), out[0])
        return [first] * len(out)
    monkeypatch.setattr(jexec.PlanExecutor, "run_batch", run_batch)


def half_batch(monkeypatch):
    """Half of every bucket left out (the later half, rounded up): those
    bindings get no rows."""
    inner = jexec.PlanExecutor.run_batch

    def run_batch(self, bounds_batch, *a, **k):
        out = inner(self, bounds_batch, *a, **k)
        keep = len(out) // 2
        return out[:keep] + [(d[:0], c) for d, c in out[keep:]]
    monkeypatch.setattr(jexec.PlanExecutor, "run_batch", run_batch)


def altered(monkeypatch):
    """One id of the first row of every answer altered where it is
    produced."""
    inner = jexec.PlanExecutor.run_batch

    def run_batch(self, bounds_batch, *a, **k):
        out = []
        for d, c in inner(self, bounds_batch, *a, **k):
            d = np.array(d)
            if len(d):
                d[0, 0] += 1
            out.append((d, c))
        return out
    monkeypatch.setattr(jexec.PlanExecutor, "run_batch", run_batch)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run(cell)
    assert not line["correct"]
    assert line["checks"]["wrong_answers"]["value"] > 0
