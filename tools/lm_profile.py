"""Where an LM's serving time goes on one NVIDIA GPU: a profiler trace of
the warm decode steps and the warm prefill that ``chip_smoke.py`` phase
10a times, for one checkout of the port.

    python3 tools/lm_profile.py [--arch qwen1.5-0.5b]

Initializes ``--arch`` at full width on the card (random weights from
seed 0, the config's own dtypes) and makes its inputs as phase 10a's
timed half does (``chip_smoke.lm_inputs``), warms it with one prefill and
four decode steps, then traces, with ``torch.profiler`` (CPU and CUDA),
``LM_DECODE_TOKENS`` steps of ``chip_smoke.lm_greedy`` from empty caches
made before the trace starts, and one prefill of ``LM_BATCH`` ×
``LM_PREFILL_SEQ`` tokens.  For each it prints the wall time (host clock,
synchronized), the device's busy time (the sum of its kernels' and
copies' spans: one stream) and idle share, the kernel launches, and the
kernels and host operators that take the most time.  Prints the card's
name and power limit and one JSON line.  Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trace(fn) -> dict:
    """Run ``fn`` once under the profiler: wall ms, device busy ms (CUDA
    kernels and memory copies), idle share, launches, the top device
    kernels and the host operators by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev_ms, kernels, launches, host = 0.0, Counter(), 0, Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            dev_ms += us / 1e3
            kernels[e.name[:80]] += us / 1e3
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"):
            launches += 1
        elif e.name.startswith("aten::") and e.cpu_parent is None:
            host[e.name] += e.self_cpu_time_total / 1e3
    out = {"wall_ms": round(wall_ms, 4), "launches": launches,
           "top_host_ops_ms": {k: round(v, 4)
                               for k, v in host.most_common(8)}}
    if dev_ms == 0.0:
        out["device_busy_ms"] = "not measured (no device events traced)"
        return out
    out.update({"device_busy_ms": round(dev_ms, 4),
                "device_idle_share": round(1 - dev_ms / wall_ms, 4),
                "top_kernels_ms": {k: round(v, 4)
                                   for k, v in kernels.most_common(8)}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get
    from repro_torch.models.api import Model

    ident = smoke.gpu_identity()
    cfg = get(args.arch)
    m = Model(cfg)
    steps = smoke.LM_DECODE_TOKENS
    with torch.inference_mode():
        params = m.init(0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        inp = smoke.lm_inputs(cfg, smoke.LM_BATCH, smoke.LM_PREFILL_SEQ,
                              gen, torch.device("cuda"))
        m.prefill(params, inp)
        smoke.lm_greedy(m, params, smoke.lm_caches(m, params), 4)
        caches = smoke.lm_caches(m, params)
        res = {"arch": cfg.name, "card": ident, "batch": smoke.LM_BATCH,
               "decode_steps": steps,
               "decode": trace(lambda: smoke.lm_greedy(m, params, caches,
                                                       steps)),
               "prefill_seq": smoke.LM_PREFILL_SEQ,
               "prefill": trace(lambda: m.prefill(params, inp))}
    res["decode"]["launches_per_step"] = round(
        res["decode"]["launches"] / steps, 1)
    print(ident)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
