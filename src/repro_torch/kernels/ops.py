"""Wrappers of the port's hand-written kernels.

A wrapper takes its kernel's plain version (:mod:`repro_torch.kernels.ref`)
only for tensors that lie on the CPU.  A CUDA tensor launches the kernel,
or the wrapper raises: there is no fallback.  Each launch adds one to
``launches[<kernel>]``, and nothing else does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

__all__ = ["join_probe", "semijoin_mask", "semijoin_plan",
           "semijoin_bitmaps", "SemijoinPlan", "bucket_count", "launches",
           "reset_launches", "semijoin_paths", "KernelLaunchError"]



class KernelLaunchError(RuntimeError):
    """A kernel's entry point returned a CUDA error.  Like
    :class:`~repro_torch.kernels.build.KernelBuildError` it always
    propagates: the engine never turns it into a host fallback or a
    routing exclusion."""


#: threads of one block of the semi-join membership kernel and the probe
#: keys each takes (four 16-byte vectors: ``4 * VECS`` in semijoin.cu),
#: and threads of one block of its bitmap build (one build key each)
SEMIJOIN_THREADS = 256
SEMIJOIN_KEYS_PER_THREAD = 16
SEMIJOIN_BITMAP_THREADS = 256
#: a build segment gets a presence bitmap when its id range, in 32-bit
#: words, is at most max(DENSITY * its keys, MIN_WORDS) (65,536 words =
#: 256 KB); every other segment keeps the binary search
SEMIJOIN_BITMAP_DENSITY = 1
SEMIJOIN_BITMAP_MIN_WORDS = 65536

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

#: threads of one block of the bucket-count kernel, and its blocks per SM
#: (the persistent grid asks for 2,048 threads an SM; at 35-47 registers a
#: thread, 5-6 blocks an SM are resident at once and the rest follow)
BUCKET_THREADS = 256
BUCKET_BLOCKS_PER_SM = 8
#: keys a bucket-count thread takes a step: four 16-byte key vectors and
#: one 16-byte vector of validity bytes (STEP_KEYS in bucketcount.cu)
BUCKET_STEP_KEYS = 16
#: bucket counts up to which every thread counts in registers; at most 8,
#: the counts bucketcount.cu instantiates (REG_BUCKETS).  0 sends every
#: call to the shared histogram.
BUCKET_REG_MAX = 8
#: bucket counts the shared histogram holds (SMEM_BUCKETS: 48 KB); above
#: it the kernel counts with global atomics
BUCKET_SMEM_MAX = 12288
#: the bucket-count kernel's paths, numbered as bucketcount.cu's PATH_*
BUCKET_PATH_IDS = {"registers": 0, "shared": 1, "global": 2}

#: kernel name -> launches since the last reset
launches: Dict[str, int] = {"join_probe": 0, "semijoin_membership": 0,
                            "bucket_count": 0}


#: pairs of the last semi-join call on CUDA that took each path
semijoin_paths: Dict[str, int] = {"bitmap": 0, "search": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_PROBE_ARGTYPES = {
    "join_probe_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "join_probe_batched_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]}


def _join_probe_fn(name: str = "join_probe_launch"):
    """An entry point of ``join_probe.cu``: ``join_probe_launch`` (one
    build) or ``join_probe_batched_launch`` (a build per row)."""
    fn = getattr(build.load("join_probe"), name)
    if fn.argtypes is None:
        fn.argtypes = _PROBE_ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _probe_plan(n_a: int, n_b: int, sms: int, batch: int = 1
                ) -> Tuple[int, int, int, int]:
    """The join-probe kernel's launch plan: ``(stride, n_splitters,
    blocks, smem_bytes)``.  ``stride`` is the smallest power of two that
    keeps the ``ceil(n_b / stride)`` splitters within ``SMEM_KEYS``; they
    fill a search tree of the next power of two of slots, 4 bytes each.
    ``blocks`` is the persistent grid of one of ``batch`` rows of ``n_a``
    probe keys (each row its own build): a block per ``PROBE_THREADS``
    keys, all rows' blocks together at most as many as ``sms`` SMs hold
    at once with that much shared memory, and at least one a row (the
    launch cuts it further if registers hold fewer)."""
    stride = 1
    while -(-n_b // stride) > SMEM_KEYS:
        stride *= 2
    n_splitters = -(-n_b // stride)
    smem_bytes = 4 << max(n_splitters - 1, 0).bit_length() if n_b else 0
    per_sm = min(SM_THREADS // PROBE_THREADS,
                 SM_SMEM_BYTES // (smem_bytes + BLOCK_SMEM_RESERVED))
    room = max(sms * per_sm // batch, 1)
    return stride, n_splitters, min(-(-n_a // PROBE_THREADS), room), \
        smem_bytes


def _semijoin_fns():
    lib = build.load("semijoin_membership")
    fb, fm = lib.semijoin_bitmap_launch, lib.semijoin_launch
    if fb.argtypes is None:
        fb.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fb.restype = ctypes.c_int
    if fm.argtypes is None:
        fm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fm.restype = ctypes.c_int
    return fb, fm


@functools.lru_cache(maxsize=None)
def _bucket_count_fn(name: str = "bucket_count_launch"):
    """An entry point of ``bucketcount.cu``: ``bucket_count_launch`` (one
    row) or ``bucket_count_batched_launch`` (B rows; one more argument,
    the rows, after the row length)."""
    fn = getattr(build.load("bucket_count"), name)
    rows = [ctypes.c_int64] if name == "bucket_count_batched_launch" else []
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   *rows, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class BucketPlan(NamedTuple):
    """The bucket-count kernel's launch: its path, its blocks, and the
    body ``[lo, hi)`` it reads in 16-byte vectors (the head ``[0, lo)``
    and the tail ``[hi, n)`` go one key a thread)."""

    path: str    # "registers", "shared" or "global"
    blocks: int
    lo: int
    hi: int


def _bucket_plan(n: int, n_buckets: int, sms: int, key_ptr: int,
                 valid_ptr: int, batch: int = 1) -> BucketPlan:
    """The bucket-count kernel's launch for ``batch`` rows of ``n`` keys
    at address ``key_ptr`` (int32) and their validity bytes at
    ``valid_ptr``, both contiguous ``(batch, n)``.

    The path: registers up to ``BUCKET_REG_MAX`` buckets, the shared
    histogram up to ``BUCKET_SMEM_MAX``, global atomics above.  The body
    starts at the first key where both addresses are 16-byte aligned
    and holds every whole step of ``BUCKET_STEP_KEYS`` keys from there;
    where no key aligns both (their offsets differ mod 4 keys) or fewer
    than a step remain, it is empty (``lo = hi = 0``).  Every row of a
    batch shares the body only when each row starts at the first row's
    alignment (``n`` a multiple of ``BUCKET_STEP_KEYS``); otherwise it
    is empty.  ``blocks`` is the x-grid of one row: one thread a step or
    a head or tail key, all rows' blocks together at most ``sms *
    BUCKET_BLOCKS_PER_SM`` (the persistent grid), at least one a row."""
    path = ("registers" if n_buckets <= BUCKET_REG_MAX else
            "shared" if n_buckets <= BUCKET_SMEM_MAX else "global")
    lo = -valid_ptr % 16
    if (key_ptr + 4 * lo) % 16 or n - lo < BUCKET_STEP_KEYS or \
            (batch > 1 and n % BUCKET_STEP_KEYS):
        lo = hi = 0
    else:
        hi = lo + (n - lo) // BUCKET_STEP_KEYS * BUCKET_STEP_KEYS
    items = max((hi - lo) // BUCKET_STEP_KEYS, n - (hi - lo))
    blocks = min(-(-items // BUCKET_THREADS),
                 sms * BUCKET_BLOCKS_PER_SM // batch)
    return BucketPlan(path, max(blocks, 1), lo, hi)


def _check_int32_column(fn: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous 1-D int32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


class SemijoinPlan(NamedTuple):
    """Which path each build segment of a semi-join batch takes, and
    where its presence bitmap lies.  Arrays are indexed by distinct
    segment (``segs``, ascending) unless named otherwise."""

    segs: np.ndarray         # int64 (S, 2): distinct (build_off, build_len)
    seg_of_pair: np.ndarray  # int64 (P,): each pair's segment
    bitmap: np.ndarray       # bool (S,): the segment takes a bitmap
    word_off: np.ndarray     # int64 (S,): its first word; -1 on the search path
    lo: np.ndarray           # int64 (S,): the id of its bit 0 (first key)
    words: np.ndarray        # int64 (S,): its 32-bit words (0: search)
    n_words: int             # words of all the batch's bitmaps


def _build_segments(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct build segments (build_off, build_len) of a batch,
    ascending, and the index of each pair's segment among them."""
    seg = pairs[:, 2:4].reshape(-1, 2)
    order = np.lexsort((seg[:, 1], seg[:, 0]))
    ordered = seg[order]
    new = np.ones(len(ordered), dtype=bool)
    new[1:] = (ordered[1:] != ordered[:-1]).any(axis=1)
    inv = np.empty(len(ordered), dtype=np.int64)
    inv[order] = np.cumsum(new) - 1
    return ordered[new].astype(np.int64), inv


def _semijoin_plan(pairs: np.ndarray, first: np.ndarray, last: np.ndarray,
                   segments: Optional[Tuple[np.ndarray, np.ndarray]] = None
                   ) -> SemijoinPlan:
    """The semi-join kernel's plan for a batch, from the first and last
    key of each distinct build segment (in the order of
    :func:`_build_segments`; ignored for an empty segment).

    A segment takes a bitmap of ``ceil((last - first + 1) / 32)`` words
    when that is at most ``max(SEMIJOIN_BITMAP_DENSITY * build_len,
    SEMIJOIN_BITMAP_MIN_WORDS)``; an empty segment and every other one
    keep the binary search.  One bitmap per distinct segment, however
    many pairs read it; the bitmaps lie end to end.  Ranges are int64: a
    segment from -1 to 2^31-2 spans 2^31 ids.  ``segments`` is
    :func:`_build_segments` of ``pairs`` where the caller has it."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 4)
    segs, seg_of_pair = segments or _build_segments(pairs)
    n = segs[:, 1]
    first = np.asarray(first, dtype=np.int64).reshape(-1)
    last = np.asarray(last, dtype=np.int64).reshape(-1)
    span = np.where(n > 0, last - first + 1, 0)
    words = -(-span // 32)
    limit = np.maximum(SEMIJOIN_BITMAP_DENSITY * n,
                       SEMIJOIN_BITMAP_MIN_WORDS)
    bitmap = (n > 0) & (words <= limit)
    words = np.where(bitmap, words, 0).astype(np.int64)
    ends = np.cumsum(words)
    return SemijoinPlan(
        segs=segs, seg_of_pair=seg_of_pair, bitmap=bitmap,
        word_off=np.where(bitmap, ends - words, -1).astype(np.int64),
        lo=np.where(bitmap, first, 0).astype(np.int64), words=words,
        n_words=int(ends[-1]) if len(ends) else 0)


def semijoin_plan(build_sorted: torch.Tensor,
                  pairs: np.ndarray) -> SemijoinPlan:
    """:func:`_semijoin_plan` over the keys of ``build_sorted``: the first
    and last key of each distinct non-empty segment come from one gather
    and one small copy to the host (on the card, the semi-join's only
    host sync)."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 4)
    segments = _build_segments(pairs)
    segs = segments[0]
    live = segs[:, 1] > 0
    first = np.zeros(len(segs), dtype=np.int64)
    last = np.zeros(len(segs), dtype=np.int64)
    if live.any():
        off, n = segs[live, 0], segs[live, 1]
        idx = torch.from_numpy(np.concatenate([off, off + n - 1]))
        ends = torch.index_select(build_sorted, 0,
                                  idx.to(build_sorted.device)).cpu().numpy()
        first[live] = ends[:len(off)]
        last[live] = ends[len(off):]
    return _semijoin_plan(pairs, first, last, segments)


def _bitmap_desc(plan: SemijoinPlan) -> Tuple[np.ndarray, int, int]:
    """The bitmap-build kernel's arguments: int64 rows (build_off,
    build_len, word_off, lo) of each bitmap segment followed by each
    one's first block, flat; the segments; the blocks."""
    sel = np.nonzero(plan.bitmap)[0]
    segs = plan.segs[sel]
    blocks = -(-segs[:, 1] // SEMIJOIN_BITMAP_THREADS)
    start = np.cumsum(blocks) - blocks
    flat = np.concatenate([segs, plan.word_off[sel, None],
                           plan.lo[sel, None]], axis=1).reshape(-1)
    return np.concatenate([flat, start]), len(sel), int(blocks.sum())


def _launch_bitmaps(build_sorted: torch.Tensor, words: torch.Tensor,
                    desc: torch.Tensor, n_segs: int, n_blocks: int,
                    stream: int) -> None:
    if n_segs == 0:
        return
    status = _semijoin_fns()[0](
        build_sorted.data_ptr(), desc.data_ptr(),
        desc.data_ptr() + 8 * 4 * n_segs, n_segs, n_blocks,
        SEMIJOIN_BITMAP_THREADS, words.data_ptr(), stream)
    if status != 0:
        raise KernelLaunchError(f"semijoin bitmap kernel launch failed: "
                                f"CUDA error {status}")


def semijoin_bitmaps(build_sorted: torch.Tensor,
                     plan: SemijoinPlan) -> torch.Tensor:
    """The presence bitmaps of ``plan``: int32 (``plan.n_words``,), bit
    ``key - lo`` of each bitmap segment's words set for each of its keys.
    On CUDA this is the bitmap-build kernel of ``csrc/semijoin.cu``, as
    :func:`semijoin_mask` launches it (a call here is not counted in
    ``launches``); on the CPU its plain version."""
    if build_sorted.device.type == "cpu":
        return ref.semijoin_bitmaps_ref(build_sorted, plan)
    if build_sorted.device.type != "cuda":
        raise ValueError(f"semijoin_bitmaps: build on {build_sorted.device}; "
                         "it must be on a CUDA device (or the CPU)")
    _check_int32_column("semijoin_bitmaps", "build_sorted", build_sorted)
    dev = build_sorted.device
    words = torch.zeros(plan.n_words, dtype=torch.int32, device=dev)
    flat, n_segs, n_blocks = _bitmap_desc(plan)
    desc = torch.from_numpy(flat).to(dev)
    with torch.cuda.device(dev):
        _launch_bitmaps(build_sorted, words, desc, n_segs, n_blocks,
                        torch.cuda.current_stream(dev).cuda_stream)
    return words


def semijoin_mask(probe: torch.Tensor, build_sorted: torch.Tensor,
                  pairs: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-join membership for a batch of (probe, build) pairs in one
    call.

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
    ``repro/kernels/semijoin.py::semijoin_membership_kernel``: the plan
    (:func:`semijoin_plan`) gives each dense build segment a presence
    bitmap, built by one launch, and one launch then probes every pair,
    through its segment's bitmap or by binary search.  Each call that
    launches adds one to ``launches["semijoin_membership"]`` and sets
    ``semijoin_paths`` to the pairs on each path.
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
    if not pairs[:, 1].any():
        semijoin_paths.update(bitmap=0, search=0)
        return (torch.empty(0, dtype=torch.uint8, device=probe.device),
                torch.zeros(len(pairs), dtype=torch.int64,
                            device=probe.device))
    return _semijoin_launch(probe, build_sorted, pairs,
                            semijoin_plan(build_sorted, pairs))


def _semijoin_launch(probe: torch.Tensor, build_sorted: torch.Tensor,
                     pairs: np.ndarray, plan: SemijoinPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`semijoin_mask` on CUDA after its plan: one copy of the
    descriptors to the card, the bitmap build, the membership kernel.
    No host sync."""
    dev = probe.device
    n_pairs = len(pairs)
    out_off = np.cumsum(pairs[:, 1])
    mask = torch.empty(int(out_off[-1]), dtype=torch.uint8, device=dev)
    counts = torch.zeros(n_pairs, dtype=torch.int64, device=dev)
    tile = SEMIJOIN_THREADS * SEMIJOIN_KEYS_PER_THREAD
    blocks = -(-pairs[:, 1] // tile)
    seg = plan.seg_of_pair
    # one copy to the card: the pairs' descriptors and first blocks, then
    # the bitmap segments'
    pair_desc = np.concatenate(
        [pairs, (out_off - pairs[:, 1])[:, None], plan.word_off[seg, None],
         plan.lo[seg, None], plan.words[seg, None]], axis=1).reshape(-1)
    bitmap_desc, n_segs, n_seg_blocks = _bitmap_desc(plan)
    arr = torch.from_numpy(np.concatenate(
        [pair_desc, np.cumsum(blocks) - blocks, bitmap_desc])).to(dev)
    words = torch.zeros(plan.n_words, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _launch_bitmaps(build_sorted, words, arr[pair_desc.size + n_pairs:],
                        n_segs, n_seg_blocks, stream)
        status = _semijoin_fns()[1](
            probe.data_ptr(), build_sorted.data_ptr(), words.data_ptr(),
            arr.data_ptr(), arr.data_ptr() + 8 * pair_desc.size, n_pairs,
            int(blocks.sum()), SEMIJOIN_THREADS, mask.data_ptr(),
            counts.data_ptr(), stream)
    if status != 0:
        raise KernelLaunchError(f"semijoin kernel launch failed: "
                                f"CUDA error {status}")
    launches["semijoin_membership"] += 1
    n_bitmap = int(plan.bitmap[seg].sum())
    semijoin_paths.update(bitmap=n_bitmap, search=n_pairs - n_bitmap)
    return mask, counts


def _check_probe_shapes(probe: torch.Tensor, build_sorted: torch.Tensor
                        ) -> None:
    """The forms :func:`join_probe` takes: a probe ``(n_a,)`` or ``(B,
    n_a)`` against a build ``(n_b,)`` (one for every row), or a probe
    ``(B, n_a)`` against a build ``(B, n_b)`` (one a row)."""
    ok = probe.dim() in (1, 2) and (
        build_sorted.dim() == 1 or (probe.dim() == build_sorted.dim() == 2
                                    and probe.shape[0] ==
                                    build_sorted.shape[0]))
    if not ok:
        raise ValueError(f"join_probe: probe {tuple(probe.shape)} and build "
                         f"{tuple(build_sorted.shape)}: a probe (n_a,) or "
                         "(B, n_a) takes a build (n_b,), a probe (B, n_a) "
                         "a build (n_b,) or (B, n_b)")


def join_probe(probe: torch.Tensor, build_sorted: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt) per probe key against the ascending build column:
    ``lo[i] = #{b < a_i}``, ``cnt[i] = #{b == a_i}``, both int32 and of
    the probe's shape.

    A batch of B rows: a probe ``(B, n_a)`` against one build ``(n_b,)``
    for every row, or against a build ``(B, n_b)``, row r of the probe in
    row r of the build.  Either form is one launch.  The probe may be in
    any order.  Sentinel keys (probe pads 2^31-1, build pads 2^31-2, the
    negative UNBOUND keys) need no padding step: they never match, and a
    probe pad's ``lo`` is ``n_b``.  On CUDA this is the hand-written
    kernel ``csrc/join_probe.cu``, which replaces the TPU kernel
    ``repro/kernels/mergejoin.py::join_probe_kernel`` and reads the build
    in 16-byte vectors: a build that is not 16-byte aligned (a view at an
    offset, or rows of a width that is not a multiple of 4 keys) raises.
    """
    _check_probe_shapes(probe, build_sorted)
    if probe.device.type == "cpu" and build_sorted.device.type == "cpu":
        return ref.join_probe_ref(probe, build_sorted)
    if probe.device.type != "cuda" or probe.device != build_sorted.device:
        raise ValueError(f"join_probe: probe on {probe.device} and build on "
                         f"{build_sorted.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    for name, t in (("probe", probe), ("build_sorted", build_sorted)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"join_probe: {name} must be a contiguous int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    per_row = build_sorted.dim() == 2
    batch = probe.shape[0] if per_row else 1
    n_a, n_b = probe.shape[-1], build_sorted.shape[-1]
    if build_sorted.numel() and (build_sorted.data_ptr() % 16 or
                                 (batch > 1 and n_b % 4)):
        raise ValueError("join_probe: the build column must be 16-byte "
                         "aligned (a fresh tensor, not a view at an offset; "
                         "rows of a multiple of 4 keys)")
    if n_b >= 2**31:
        raise ValueError(f"join_probe: {n_b} build keys would overflow an "
                         "int32 rank")
    if batch > 65535:
        raise ValueError(f"join_probe: {batch} rows exceed the grid's "
                         "65,535")
    lo = torch.empty_like(probe)
    cnt = torch.empty_like(probe)
    if probe.numel() == 0:
        return lo, cnt
    sms = _sm_count(probe.device.index)
    # one build for every row: the rows end to end are one probe
    n_keys = n_a if per_row else probe.numel()
    stride, n_splitters, blocks, smem = _probe_plan(n_keys, n_b, sms, batch)
    stream = torch.cuda.current_stream(probe.device).cuda_stream
    with torch.cuda.device(probe.device):
        if per_row:
            status = _join_probe_fn("join_probe_batched_launch")(
                probe.data_ptr(), n_a, build_sorted.data_ptr(), n_b, batch,
                lo.data_ptr(), cnt.data_ptr(), stride.bit_length() - 1,
                n_splitters, smem, blocks, PROBE_THREADS, sms, stream)
        else:
            status = _join_probe_fn()(
                probe.data_ptr(), n_keys, build_sorted.data_ptr(), n_b,
                lo.data_ptr(), cnt.data_ptr(), stride.bit_length() - 1,
                n_splitters, smem, blocks, PROBE_THREADS, sms, stream)
    if status != 0:
        raise KernelLaunchError(f"join_probe kernel launch failed: "
                                f"CUDA error {status}")
    launches["join_probe"] += 1
    return lo, cnt


def _bucket_on_card(keys: torch.Tensor, valid: torch.Tensor,
                    n_buckets: int) -> bool:
    """:func:`bucket_count`'s checks: True for tensors on one CUDA device
    that the kernel takes, False for tensors on the CPU; raises on
    anything else."""
    if n_buckets < 1:
        raise ValueError(f"bucket_count: n_buckets must be >= 1, got "
                         f"{n_buckets}")
    if keys.shape != valid.shape:
        raise ValueError(f"bucket_count: keys {tuple(keys.shape)} and valid "
                         f"{tuple(valid.shape)} differ in shape")
    if keys.dim() not in (1, 2):
        raise ValueError(f"bucket_count: keys {tuple(keys.shape)}: a row "
                         "(n,) or a batch (B, n)")
    if keys.is_cuda and valid.is_cuda and \
            keys.get_device() == valid.get_device():
        if keys.dtype != torch.int32 or not keys.is_contiguous():
            raise ValueError(f"bucket_count: keys must be a contiguous "
                             f"int32 tensor, got {keys.dtype} "
                             f"{tuple(keys.shape)}")
        if valid.dtype != torch.bool or not valid.is_contiguous():
            raise ValueError(f"bucket_count: valid must be a contiguous "
                             f"bool tensor, got {valid.dtype}")
        if keys.shape[-1] >= 2**31:
            raise ValueError(f"bucket_count: {keys.shape[-1]} keys would "
                             "overflow an int32 count")
        if keys.dim() == 2 and keys.shape[0] > 65535:
            raise ValueError(f"bucket_count: {keys.shape[0]} rows exceed "
                             "the grid's 65,535")
        return True
    if keys.device.type == "cpu" and valid.device.type == "cpu":
        return False
    raise ValueError(f"bucket_count: keys on {keys.device} and valid on "
                     f"{valid.device}; both must be on one CUDA device "
                     "(or both on the CPU)")


def bucket_count(keys: torch.Tensor, valid: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """int32 histogram of ``uint32(key) mod n_buckets`` over the rows that
    are valid and whose key is not the probe pad 2^31-1 (see
    :func:`repro_torch.kernels.ref.bucket_count_ref`).  ``keys`` int32
    and ``valid`` bool of one shape: ``(n,)`` gives ``(n_buckets,)``, a
    batch ``(B, n)`` gives ``(B, n_buckets)``, row b the histogram of
    row b.

    On CUDA this is the hand-written kernel ``csrc/bucketcount.cu``,
    which replaces the TPU kernel
    ``repro/kernels/bucketcount.py::bucket_count_kernel``, on the path
    and grid of :func:`_bucket_plan`; a batch is one launch
    (``bucket_count_batched_launch``).  The call allocates its output and
    nothing else, and makes no host sync: the kernel's entry point zeroes
    the output in stream order.
    """
    n_buckets = int(n_buckets)
    if not _bucket_on_card(keys, valid, n_buckets):
        return ref.bucket_count_ref(keys, valid, n_buckets)
    out = keys.new_empty(keys.shape[:-1] + (n_buckets,))
    n = keys.shape[-1]
    if keys.numel() == 0:
        return out.zero_()
    dev = keys.get_device()
    key_ptr, valid_ptr = keys.data_ptr(), valid.data_ptr()
    rows = () if keys.dim() == 1 else (keys.shape[0],)
    path, blocks, lo, hi = _bucket_plan(n, n_buckets, _sm_count(dev),
                                        key_ptr, valid_ptr, *rows)
    # the raw handle of the current stream and the current device, each
    # in one call into torch's C module, without the Python Stream object
    # that torch.cuda.current_stream builds
    args = (key_ptr, valid_ptr, n, *rows, n_buckets, BUCKET_PATH_IDS[path],
            lo, hi, blocks, BUCKET_THREADS, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev))
    fn = _bucket_count_fn("bucket_count_batched_launch" if rows
                          else "bucket_count_launch")
    if dev == torch._C._cuda_getDevice():
        status = fn(*args)
    else:
        with torch.cuda.device(dev):
            status = fn(*args)
    if status != 0:
        raise KernelLaunchError(f"bucket_count kernel launch failed: "
                                f"CUDA error {status}")
    launches["bucket_count"] += 1
    return out
