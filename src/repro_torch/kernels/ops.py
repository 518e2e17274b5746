"""Wrappers of the port's hand-written kernels.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only for tensors that lie on the CPU.  A CUDA tensor launches the kernel,
or the wrapper raises: there is no fallback.  Each launch adds one to
``launches[<kernel>]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

__all__ = ["join_probe", "semijoin_mask", "bucket_count", "launches",
           "reset_launches"]

#: threads of one block of the semi-join kernel (one probe key each)
SEMIJOIN_THREADS = 256

#: splitters of the build column one join-probe block stages in shared
#: memory (a power of two; 4 bytes each): a build column of at most this
#: many keys sits there whole
SMEM_KEYS = 32768
#: threads of one block of the join-probe kernel
PROBE_THREADS = 1024
#: what one H100 SM holds: threads, and shared memory with the 1 KB the
#: system keeps per block (CUDA C++ Programming Guide, compute capability 9.0)
SM_THREADS = 2048
SM_SMEM_BYTES = 233472
BLOCK_SMEM_RESERVED = 1024

#: threads of one block of the bucket-count kernel
BUCKET_THREADS = 256
#: blocks of the bucket-count kernel per SM (each flushes one histogram)
BUCKET_BLOCKS_PER_SM = 8

#: kernel name -> launches since the last reset
launches: Dict[str, int] = {"join_probe": 0, "semijoin_membership": 0,
                            "bucket_count": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _join_probe_fn():
    lib = build.load("join_probe")
    fn = lib.join_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _probe_plan(n_a: int, n_b: int, sms: int) -> Tuple[int, int, int, int]:
    """The join-probe kernel's launch plan: ``(stride, n_splitters,
    blocks, smem_bytes)``.  ``stride`` is the smallest power of two that
    keeps the ``ceil(n_b / stride)`` splitters within ``SMEM_KEYS``; they
    fill a search tree of the next power of two of slots, 4 bytes each.
    ``blocks`` is the persistent grid: a block per ``PROBE_THREADS``
    probe keys, at most as many as ``sms`` SMs hold at once with that
    much shared memory (the launch cuts it further if registers hold
    fewer)."""
    stride = 1
    while -(-n_b // stride) > SMEM_KEYS:
        stride *= 2
    n_splitters = -(-n_b // stride)
    smem_bytes = 4 << max(n_splitters - 1, 0).bit_length() if n_b else 0
    per_sm = min(SM_THREADS // PROBE_THREADS,
                 SM_SMEM_BYTES // (smem_bytes + BLOCK_SMEM_RESERVED))
    return stride, n_splitters, min(-(-n_a // PROBE_THREADS), sms * per_sm), \
        smem_bytes


def _semijoin_fn():
    lib = build.load("semijoin_membership")
    fn = lib.semijoin_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bucket_count_fn():
    lib = build.load("bucket_count")
    fn = lib.bucket_count_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_int32_column(fn: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous 1-D int32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def semijoin_mask(probe: torch.Tensor, build_sorted: torch.Tensor,
                  pairs: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-join membership for a batch of (probe, build) pairs in one
    launch.

    ``probe`` and ``build_sorted`` are ragged int32 key arrays; row j of
    the int64 (P, 4) host array ``pairs`` is (probe_off, probe_len,
    build_off, build_len), and ``build_sorted[build_off:+build_len]``
    must be ascending.  ``pairs=None`` is a batch of one over the whole
    of both.  Returns ``(mask, counts)``: ``mask`` uint8, the pairs'
    masks end to end in pair order (pair j's starts at the sum of the
    probe lengths before it), ``mask = probe key ∈ build segment``;
    ``counts`` int64 (P,), the ones in each pair's mask.

    On CUDA this is the hand-written kernel ``csrc/semijoin.cu``, which
    replaces the TPU kernel
    ``repro/kernels/semijoin.py::semijoin_membership_kernel``.
    """
    if pairs is None:
        pairs = np.array([[0, probe.numel(), 0, build_sorted.numel()]],
                         dtype=np.int64)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 4)
    if (pairs < 0).any() or \
            (pairs[:, 0] + pairs[:, 1] > probe.numel()).any() or \
            (pairs[:, 2] + pairs[:, 3] > build_sorted.numel()).any():
        raise ValueError("semijoin_mask: a pair's segment lies outside "
                         "the probe or build array")
    if probe.device.type == "cpu" and build_sorted.device.type == "cpu":
        return ref.semijoin_pairs_ref(probe, build_sorted, pairs)
    if probe.device.type != "cuda" or probe.device != build_sorted.device:
        raise ValueError(f"semijoin_mask: probe on {probe.device} and build "
                         f"on {build_sorted.device}; both must be on one "
                         "CUDA device (or both on the CPU)")
    _check_int32_column("semijoin_mask", "probe", probe)
    _check_int32_column("semijoin_mask", "build_sorted", build_sorted)
    dev = probe.device
    n_pairs = len(pairs)
    out_off = np.concatenate([[0], np.cumsum(pairs[:, 1])]).astype(np.int64)
    mask = torch.empty(int(out_off[-1]), dtype=torch.uint8, device=dev)
    counts = torch.zeros(n_pairs, dtype=torch.int64, device=dev)
    blocks = -(-pairs[:, 1] // SEMIJOIN_THREADS)
    n_blocks = int(blocks.sum())
    if n_blocks == 0:
        return mask, counts
    block_start = np.concatenate([[0], np.cumsum(blocks)[:-1]])
    desc = torch.from_numpy(np.concatenate(
        [pairs, out_off[:-1, None]], axis=1).astype(np.int64)).to(dev)
    starts = torch.from_numpy(block_start.astype(np.int64)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = _semijoin_fn()(probe.data_ptr(), build_sorted.data_ptr(),
                                desc.data_ptr(), starts.data_ptr(), n_pairs,
                                n_blocks, SEMIJOIN_THREADS, mask.data_ptr(),
                                counts.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"semijoin kernel launch failed: CUDA error "
                           f"{status}")
    launches["semijoin_membership"] += 1
    return mask, counts


def join_probe(probe: torch.Tensor, build_sorted: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt) per probe key against the ascending build column:
    ``lo[i] = #{b < a_i}``, ``cnt[i] = #{b == a_i}``, both int32.

    The probe may be in any order.  Sentinel keys (probe pads 2^31-1,
    build pads 2^31-2, the negative UNBOUND keys) need no padding step:
    they never match, and a probe pad's ``lo`` is ``len(build_sorted)``.
    On CUDA this is the hand-written kernel ``csrc/join_probe.cu``, which
    replaces the TPU kernel ``repro/kernels/mergejoin.py::join_probe_kernel``
    and reads the build column in 16-byte vectors: a build column that is
    not 16-byte aligned (a view at an offset) raises.
    """
    if probe.device.type == "cpu" and build_sorted.device.type == "cpu":
        return ref.join_probe_ref(probe, build_sorted)
    if probe.device.type != "cuda" or probe.device != build_sorted.device:
        raise ValueError(f"join_probe: probe on {probe.device} and build on "
                         f"{build_sorted.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    _check_int32_column("join_probe", "probe", probe)
    _check_int32_column("join_probe", "build_sorted", build_sorted)
    if build_sorted.numel() and build_sorted.data_ptr() % 16:
        raise ValueError("join_probe: the build column must be 16-byte "
                         "aligned (a fresh tensor, not a view at an offset)")
    n_a, n_b = probe.numel(), build_sorted.numel()
    if n_b >= 2**31:
        raise ValueError(f"join_probe: {n_b} build keys would overflow an "
                         "int32 rank")
    lo = torch.empty_like(probe)
    cnt = torch.empty_like(probe)
    if n_a == 0:
        return lo, cnt
    sms = _sm_count(probe.device.index)
    stride, n_splitters, blocks, smem = _probe_plan(n_a, n_b, sms)
    stream = torch.cuda.current_stream(probe.device).cuda_stream
    with torch.cuda.device(probe.device):
        status = _join_probe_fn()(
            probe.data_ptr(), n_a, build_sorted.data_ptr(), n_b,
            lo.data_ptr(), cnt.data_ptr(), stride.bit_length() - 1,
            n_splitters, smem, blocks, PROBE_THREADS, sms, stream)
    if status != 0:
        raise RuntimeError(f"join_probe kernel launch failed: CUDA error "
                           f"{status}")
    launches["join_probe"] += 1
    return lo, cnt


def bucket_count(keys: torch.Tensor, valid: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """int32 histogram of ``uint32(key) mod n_buckets`` over the rows that
    are valid and whose key is not the probe pad 2^31-1 (see
    :func:`repro_torch.kernels.ref.bucket_count_ref`).  ``keys`` int32
    and ``valid`` bool, both 1-D of one length.

    On CUDA this is the hand-written kernel ``csrc/bucketcount.cu``,
    which replaces the TPU kernel
    ``repro/kernels/bucketcount.py::bucket_count_kernel``.
    """
    n_buckets = int(n_buckets)
    if n_buckets < 1:
        raise ValueError(f"bucket_count: n_buckets must be >= 1, got "
                         f"{n_buckets}")
    if keys.shape != valid.shape:
        raise ValueError(f"bucket_count: keys {tuple(keys.shape)} and valid "
                         f"{tuple(valid.shape)} differ in shape")
    if keys.device.type == "cpu" and valid.device.type == "cpu":
        return ref.bucket_count_ref(keys, valid, n_buckets)
    if keys.device.type != "cuda" or keys.device != valid.device:
        raise ValueError(f"bucket_count: keys on {keys.device} and valid on "
                         f"{valid.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    _check_int32_column("bucket_count", "keys", keys)
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError(f"bucket_count: valid must be a contiguous bool "
                         f"tensor, got {valid.dtype}")
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"bucket_count: {n} keys would overflow an int32 "
                         "count")
    out = torch.zeros(n_buckets, dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    n_blocks = min(-(-n // BUCKET_THREADS), sms * BUCKET_BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    with torch.cuda.device(keys.device):
        status = _bucket_count_fn()(keys.data_ptr(), valid.data_ptr(), n,
                                    n_buckets, n_blocks, BUCKET_THREADS,
                                    out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"bucket_count kernel launch failed: CUDA error "
                           f"{status}")
    launches["bucket_count"] += 1
    return out
