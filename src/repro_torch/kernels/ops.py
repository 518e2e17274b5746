"""Wrappers of the port's hand-written kernels.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only for tensors that lie on the CPU.  A CUDA tensor launches the kernel,
or the wrapper raises: there is no fallback.  Each launch adds one to
``launches[<kernel>]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, ref

__all__ = ["join_probe", "launches", "reset_launches"]

#: kernel name -> launches since the last reset
launches: Dict[str, int] = {"join_probe": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _join_probe_fn():
    lib = build.load("join_probe")
    fn = lib.join_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def join_probe(probe: torch.Tensor, build_sorted: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt) per probe key against the ascending build column:
    ``lo[i] = #{b < a_i}``, ``cnt[i] = #{b == a_i}``, both int32.

    The probe may be in any order.  Sentinel keys (probe pads 2^31-1,
    build pads 2^31-2, the negative UNBOUND keys) need no padding step:
    they never match, and a probe pad's ``lo`` is ``len(build_sorted)``.
    On CUDA this is the hand-written kernel ``csrc/join_probe.cu``, which
    replaces the TPU kernel ``repro/kernels/mergejoin.py::join_probe_kernel``.
    """
    if probe.device.type == "cpu" and build_sorted.device.type == "cpu":
        return ref.join_probe_ref(probe, build_sorted)
    if probe.device.type != "cuda" or probe.device != build_sorted.device:
        raise ValueError(f"join_probe: probe on {probe.device} and build on "
                         f"{build_sorted.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    for name, t in (("probe", probe), ("build_sorted", build_sorted)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"join_probe: {name} must be a contiguous 1-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
    lo = torch.empty_like(probe)
    cnt = torch.empty_like(probe)
    n_a, n_b = probe.numel(), build_sorted.numel()
    if n_a == 0:
        return lo, cnt
    stream = torch.cuda.current_stream(probe.device).cuda_stream
    with torch.cuda.device(probe.device):
        status = _join_probe_fn()(probe.data_ptr(), n_a,
                                  build_sorted.data_ptr(), n_b,
                                  lo.data_ptr(), cnt.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"join_probe kernel launch failed: CUDA error "
                           f"{status}")
    launches["join_probe"] += 1
    return lo, cnt
