"""The harness: cells found by name, the end-to-end arithmetic, the
closed loop, the trace reduction, and a run without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from s2bench import devtrace, spec
from s2bench.loop import ClosedLoop, Request, p95, window_numbers

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_resolves_its_files():
    bench = spec.load_benchmark()
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"qps", "setup_s"}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A later cell, configuration, traffic mix and metric need new files
    and new entries only."""
    shutil.copytree(ROOT / "s2bench", tmp_path / "s2bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "watdiv-sf10-extvp"
    cfg["dataset"]["scale_factor"] = 34
    (tmp_path / "s2bench/configs/watdiv-sf10-extvp.json").write_text(
        json.dumps(cfg))
    (tmp_path / "s2bench/traffic/lookups.json").write_text(json.dumps(
        {"name": "lookups", "queryset": "watdiv-basic", "templates": ["L4"],
         "loop": "closed", "draw": "per_client", "clients_per_template": 4,
         "instances_per_template": 4, "think_ms": 0}))
    (tmp_path / "s2bench/metrics/requests_read.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench["configs"].append({"name": "watdiv-sf10-extvp", "source": "x",
                             "file": "s2bench/configs/watdiv-sf10-extvp.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extvp.lookups.c4",
                               "config": "watdiv-sf10-extvp",
                               "traffic": "lookups", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_read", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "qps",
                               "workloads": ["extvp.lookups.c4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("extvp.lookups.c4", tmp_path)
    assert cell.config["dataset"]["scale_factor"] == 34
    assert cell.traffic["templates"] == ["L4"]
    assert [m["name"] for m in cell.per_layer] == ["requests_read"]
    got = spec.read_metrics(cell.per_layer,
                            type("R", (), {"requests": [1, 2, 3]})(),
                            tmp_path)
    assert got == {"requests_read": {"value": 3.0, "unit": "requests"}}
    # the old cells keep their metrics
    old = spec.resolve("extvp.basic.c576", tmp_path)
    assert "requests_read" not in [m["name"] for m in old.per_layer]


@pytest.mark.parametrize("change", [
    {"loop": "open"}, {"think_ms": 50}, {"draw": "zipf"}, {"rate_qps": 100},
    {"loop": None}, {"instances_per_template": 0}])
def test_a_traffic_file_the_harness_cannot_run_is_refused(tmp_path, change):
    """A traffic file is never run as something it does not say: an open
    loop, a think time, another draw or an unknown key is refused."""
    shutil.copytree(ROOT / "s2bench", tmp_path / "s2bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    spec.resolve("extvp.basic.c576", tmp_path)
    path = tmp_path / "s2bench/traffic/basic.json"
    mix = json.loads(path.read_text())
    for key, value in change.items():
        if value is None:
            del mix[key]
        else:
            mix[key] = value
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        spec.resolve("extvp.basic.c576", tmp_path)


def _req(t_submit, t_done, error=None):
    return Request(0, "T", "q", t_submit, t_done=t_done, error=error)


def test_p95_is_the_exact_order_statistic():
    assert p95([]) is None
    assert p95([7.0]) == 7.0
    lat = list(range(1, 101))          # 1..100 ms
    assert p95(lat) == 95
    assert p95(lat[::-1]) == 95
    assert p95(list(range(1, 21))) == 19   # ceil(0.95 * 20) = 19th


def test_window_numbers_take_all_work_and_all_time():
    # 10 s window from t0 = 100: a request a second, then a stall of 5 s
    # that delays one request; one request answered before the window,
    # one after it, one failed
    reqs = [_req(100 + i, 100 + i + 0.01) for i in range(4)]
    reqs.append(_req(104.0, 109.5))                     # the stalled one
    reqs += [_req(109.6, 109.61), _req(99.0, 99.5), _req(109.9, 111.0),
             _req(105.0, 105.1, error="boom")]
    n = window_numbers(reqs, 100.0, 10.0)
    assert n["completed"] == 6
    assert n["qps"] == pytest.approx(0.6)              # 6 over all 10 s
    lat = sorted([10.0] * 5 + [5500.0])
    assert n["p95_ms"] == pytest.approx(lat[5])          # the stall is the tail
    assert n["attempted"] == 8 and n["failed"] == 1


class FakeTicket:
    def __init__(self, server):
        self.server, self.answer = server, None

    def done(self):
        return self.answer is not None

    def result(self):
        if self.answer is None:
            self.server.flush()
        return self.answer


class FakeServer:
    """Queues requests; a bucket of ``size`` runs when it fills; a forced
    result runs everything queued.  Records how many requests are in
    flight at every call."""

    def __init__(self, n_clients, size=4):
        self.batcher, self.size, self.n = self, size, n_clients
        self.queue, self.in_flight, self.answered = [], [], 0

    def pending(self):
        return len(self.queue)

    def submit(self, q):
        t = FakeTicket(self)
        self.queue.append(t)
        if len(self.queue) >= self.size:
            self.flush()
        return t

    def flush(self):
        for t in self.queue:
            t.answer = type("A", (), {"cols": (), "data": [],
                                      "__len__": lambda s: 0})()
        self.answered += len(self.queue)
        self.queue = []


def test_the_closed_loop_keeps_every_client_waiting_on_one_request():
    n = 10
    server = FakeServer(n, size=4)
    clock = iter(i * 1e-3 for i in range(10 ** 6))
    loop = ClosedLoop(server, [f"T{c % 3}" for c in range(n)],
                      lambda t: t, lambda t, a: [], clock=lambda: next(clock))
    seen = []
    loop.run(0.5, tick=lambda now, t0: seen.append(
        len(loop._outstanding) + len(loop._ready)))
    assert server.answered > 50
    assert set(seen) == {n}                     # never more, never fewer
    per_client = {}
    for r in loop.requests:
        per_client.setdefault(r.client, []).append(r)
    for reqs in per_client.values():            # one outstanding a client
        for a, b in zip(reqs, reqs[1:]):
            assert a.t_done is not None and a.t_done <= b.t_submit


def test_the_window_opens_when_the_loop_has_settled():
    """Set-up runs whole rounds of the loop until ``settled`` says so; the
    window's requests come after that."""
    n = 6
    server = FakeServer(n, size=3)
    clock = iter(i * 1e-3 for i in range(10 ** 6))
    loop = ClosedLoop(server, [f"T{c % 2}" for c in range(n)],
                      lambda t: t, lambda t, a: [], clock=lambda: next(clock))
    asked = []

    def settled(rounds, now):
        done = {}
        for r in loop.requests:
            if r.t_done is not None:
                done[r.client] = done.get(r.client, 0) + 1
        asked.append((rounds, min(done.values()), len(done)))
        return rounds == 3
    t0 = loop.run(0.2, settled=settled)
    assert [a[0] for a in asked] == [1, 2, 3]
    assert all(least >= rounds and clients == n
               for rounds, least, clients in asked)
    assert any(r.t_done is not None and r.t_done >= t0 for r in loop.requests)
    assert sum(1 for r in loop.requests
               if r.t_done is not None and r.t_done < t0) >= 3 * n


def test_trace_reduction():
    ev = [{"name": devtrace.MARK, "cat": "user_annotation", "ts": 0, "dur": 100},
          {"name": devtrace.MARK, "cat": "gpu_user_annotation", "ts": 5, "dur": 10},
          {"name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
          {"name": "k2", "cat": "kernel", "ts": 25, "dur": 10},   # overlaps
          {"name": "cp", "cat": "gpu_memcpy", "ts": 90, "dur": 30},  # cut at 100
          {"name": "aten::copy_", "cat": "cpu_op", "ts": 40, "dur": 45},
          {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 50, "dur": 10}]
    r = devtrace.reduce_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)    # [10, 35) and [90, 100)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(20e-6) and ops["cp"] == pytest.approx(10e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # gaps [0, 10) and [35, 90): the first has no host event, the second's
    # middle (62.5) lies in aten::copy_ only
    assert gaps == pytest.approx({"no host event": 10e-6,
                                  "aten::copy_": 55e-6})
    assert devtrace.reduce_trace([e for e in ev if e["cat"] != "kernel"
                                  and e["cat"] != "gpu_memcpy"]) is None


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "s2bench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
                          timeout=300)


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _run(["--workload", "extvp.basic.c576", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_bare_checkout_of_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "s2bench", tmp_path / "s2bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "extvp.basic.c576", "--seed", "1",
                "--seconds", "1", "--trace", "1"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time
    from s2bench.cell import run_cell
    for trace in (False, True):
        line, notes, info = run_cell("extvp.basic.c576", 2 ** 32 + 3, 4.0,
                                     trace, time.perf_counter(), scale=34)
        assert line["correct"], notes
        assert line["device"]["platform"] == "gpu"
        if trace:
            assert line["device"]["busy_s"] > 0
            assert "device_idle_share" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}
