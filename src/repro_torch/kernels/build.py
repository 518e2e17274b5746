"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for Hopper only (``sm_90a``).  Libraries land in
``build/kernels/`` at the root of the checkout (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["CSRC", "SOURCES", "build_dir", "library_path", "build_all",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> its source file under ``csrc/``
SOURCES: Dict[str, str] = {"join_probe": "join_probe.cu"}
NVCC_FLAGS: List[str] = ["-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", "-shared", "-Xcompiler",
                         "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> <checkout>/build/kernels
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC to build the "
                       "CUDA kernels")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every requested kernel that is not built yet, one ``nvcc``
    process per source, all started together.  Raises with the
    compiler's output when any build fails."""
    names = list(SOURCES) if names is None else names
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LOADED[name] = lib
    return lib
