"""Checkpointing: save and restore with an async writer — the
fault-tolerance substrate.

The format is the JAX package's, so a checkpoint written by either
package restores in the other: one ``arrays.npz`` holding the flattened
leaves keyed by tree path (``params/groups/pos_0/mixer/wq``,
``opt/.mu/embed/table``, ``opt/.step``: a NamedTuple field reads
``.name``), plus a ``manifest.json`` with ``step``, ``keys``, ``shapes``,
``dtypes``, ``extra`` and ``n_devices`` (here the number of cards the
leaves lie on, or 1 on the CPU).  Leaves are saved whole, so a restore
does not depend on where they were saved from.

``save`` copies every leaf to host memory before it returns (a copy
even of a CPU leaf, so a caller may update its tensors in place at
once), then one worker thread writes the files; ``restore`` reads the
leaves on several threads.  Atomicity: write to
``<dir>.tmp`` then ``os.replace``, so a crash never leaves a half
checkpoint; ``latest_step`` only believes manifests.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.train.tree import flatten_with_paths, map_tree

__all__ = ["latest_step", "restore", "save"]

Params = Any

_EXEC = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
#: ``restore`` reads the leaves on this many threads, each with its own
#: handle on the npz (the reads and the zip's checksums release the
#: interpreter lock: a 1.2 GB file read 4× as fast on four as on one)
_READERS = 8


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().to("cpu", copy=True).numpy()


def _n_devices(tree: Params) -> int:
    cards = {leaf.device for _, leaf in flatten_with_paths(tree)
             if leaf.device.type == "cuda"}
    return len(cards) or 1


def save(ckpt_dir: str, step: int, tree: Params,
         extra: Optional[Dict[str, Any]] = None,
         async_write: bool = True) -> Future:
    """Snapshot ``tree`` at ``step``.  Returns a Future (already done if
    async_write=False)."""
    flat = {k: _host_copy(v) for k, v in flatten_with_paths(tree)}
    manifest = {
        "step": int(step),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
        "n_devices": _n_devices(tree),
    }

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    if async_write:
        return _EXEC.submit(write)
    f: Future = Future()
    f.set_result(write())
    return f


def _read(path: str, key: str) -> np.ndarray:
    with np.load(path) as npz:
        return npz[key]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            manifest = os.path.join(ckpt_dir, name, "manifest.json")
            if os.path.exists(manifest):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Params, device=None) -> Params:
    """Restore into the structure of ``like`` (a tree of tensors, which
    may lie on the ``"meta"`` device): each leaf takes the dtype of
    ``like``'s and lies on ``device``, or on the device of ``like``'s
    leaf when none is given."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    keys = [k for k, _ in flatten_with_paths(like)]
    with ThreadPoolExecutor(max_workers=_READERS) as ex:
        flat = dict(zip(keys, ex.map(lambda k: _read(path, k), keys)))

    def walk(key, leaf):
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: saved shape {arr.shape} differs from "
                             f"{tuple(leaf.shape)}")
        dev = leaf.device if device is None else torch.device(device)
        if dev.type == "meta":
            raise ValueError(f"{key}: pass device= to restore into a tree "
                             "on the 'meta' device")
        out = torch.from_numpy(np.require(arr, requirements="C"))
        return out.to(leaf.dtype).to(dev)

    return map_tree(walk, like, with_path=True)
