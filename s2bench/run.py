"""Run one cell of the benchmark once.

    python3 -m s2bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: every number the check compared, with its limit.  The
same numbers are the last lines of standard error.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell needs, when the program (``src/repro_torch``) cannot
be imported, or when, once the window has closed, the process holds a
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro``.  Kernel builds go to ``build/kernels`` in the checkout (and
any extension, Triton or Inductor cache to fixed directories beside
it), so that only a checkout's first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from s2bench import spec  # noqa: E402


def _env() -> None:
    build = spec.ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    src = str(spec.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    _env()
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"s2bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"s2bench: the program is not importable: {exc}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from s2bench.cell import forbidden_modules, run_cell
    line, notes, info = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), T_START, device="cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"s2bench: the run loaded {loaded}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), file=sys.stderr)
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
