"""Where the join-probe kernel's time goes, on one NVIDIA GPU.

    python3 tools/probe_ablate.py [--log2-probe 28] [--log2-build 19] [--seed 0]

Builds ``src/repro_torch/kernels/csrc/join_probe.cu`` four times with
``nvcc``: as it is, without its window reads (every key skips them),
without its tree walk (a key's splitter count is a hash of the key), and
without both, then times each on one seeded input shaped like the main
path's largest (by default 2^28 probe keys, 40 % probe pads and 60 %
keys that match one build key; 2^19 build keys, 28.7 % build pads), in
turns (full, no window, no walk, neither, then back).  Only the full
build's output is checked against ``torch.searchsorted``; the others
compute wrong answers on purpose.  Prints one JSON line with the card,
the times (ms, CUDA events) and the bytes bound.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
WINDOWS = "            if (q.act) {"
WALK = "        const int g1 = tree_count<false>(tree, h, key);"
HASHED = ("        const int g1 = 1 + (int)(((uint32_t)key * 2654435761u)"
          " % (uint32_t)G);")


def variants(src: str) -> dict:
    for pattern in (WINDOWS, WALK):
        if src.count(pattern) != 1:
            raise SystemExit(f"probe_ablate: the kernel source changed; "
                             f"{pattern.strip()!r} not found once")
    no_window = src.replace(WINDOWS, "            if (q.act && key == 12345) {")
    return {"full": src, "no_window": no_window,
            "no_walk": src.replace(WALK, HASHED),
            "neither": no_window.replace(WALK, HASHED)}


def inputs(log2_a: int, log2_b: int, seed: int):
    n_a, n_b = 1 << log2_a, 1 << log2_b
    g = torch.Generator(device="cuda").manual_seed(seed)
    live = int(n_b * (1 - 0.287))
    b = torch.unique(torch.randint(0, 1 << 24, (2 * live,), generator=g,
                                   device="cuda", dtype=torch.int32))[:live]
    b = torch.cat([b, torch.full((n_b - b.numel(),), 2**31 - 2,
                                 dtype=torch.int32, device="cuda")])
    a = torch.randint(0, 1 << 24, (n_a,), generator=g, device="cuda",
                      dtype=torch.int32)
    u = torch.rand(n_a, generator=g, device="cuda")
    hit = b[torch.randint(0, live, (n_a,), generator=g, device="cuda")]
    a = torch.where(u < 0.6, hit, a)
    a = torch.where(u >= 0.6, torch.full_like(a, 2**31 - 1), a)
    return a.contiguous(), b.contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-probe", type=int, default=28)
    ap.add_argument("--log2-build", type=int, default=19)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops, ref

    out_dir = os.path.join(ROOT, "build", "probe_ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = (build.CSRC / build.SOURCES["join_probe"]).read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")) \
            .join_probe_launch
        fn.argtypes = ops._join_probe_fn().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    a, b = inputs(args.log2_probe, args.log2_build, args.seed)
    n_a, n_b = a.numel(), b.numel()
    lo, cnt = torch.empty_like(a), torch.empty_like(a)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stride, n_spl, blocks, smem = ops._probe_plan(n_a, n_b, sms)
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        status = fns[name](a.data_ptr(), n_a, b.data_ptr(), n_b,
                           lo.data_ptr(), cnt.data_ptr(),
                           stride.bit_length() - 1, n_spl, smem, blocks,
                           ops.PROBE_THREADS, sms, stream)
        if status:
            raise RuntimeError(f"{name}: launch failed, CUDA error {status}")

    call("full")
    torch.cuda.synchronize()
    wlo, wcnt = ref.join_probe_ref(a, b)
    if not (torch.equal(lo, wlo) and torch.equal(cnt, wcnt)):
        raise AssertionError("the full kernel != torch.searchsorted")
    ms = {}
    for name in ("full", "no_window", "no_walk", "neither",
                 "neither", "no_walk", "no_window", "full"):
        for _ in range(3):
            call(name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call(name)
        end.record()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append(start.elapsed_time(end) / 10)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "n_a": n_a, "n_b": n_b,
                      "stride": stride, "ms": ms,
                      "bytes_bound_ms": (12 * n_a + 4 * n_b)
                      / HBM_BYTES_PER_S * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
