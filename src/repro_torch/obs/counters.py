"""What a run moves: its collectives and the bytes of its aten operators.

Two counters, both off unless a block opens them, that the dry run
(:mod:`repro_torch.launch.dryrun`) and its collective accounting
(:mod:`repro_torch.launch.collectives`) read and the executors report
to:

* :func:`record` / :func:`note`: one entry per collective issued inside
  a :func:`record` block.  Every collective call site of the port calls
  :func:`note` (``core/distributed.py``: the gathers of
  ``_all_gather_cat``, the ``all_to_all_single`` of ``repartition``, the
  ``all_reduce`` of a launch's sync, the result gather of ``_collect``;
  ``engine/engine.py``: the latency all-reduce of an ``"auto"`` engine
  over a group).  Outside a block a call costs one ``if``.  An entry
  carries the operand bytes, what the call puts on the wire from this
  rank: an all-gather's own shard, an all-to-all's whole send buffer
  (the rank's own bucket included), an all-reduce's input.
* :class:`OpCounter`: a ``TorchDispatchMode`` that counts the bytes
  every aten operator run inside it reads and writes, and the peak of
  the bytes those operators allocated that were live at once.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["record", "note", "OpCounter"]

_sink: Optional[List[Dict[str, object]]] = None


@contextmanager
def record() -> Iterator[List[Dict[str, object]]]:
    """Collect one entry per collective issued inside the block: ``kind``
    (one of :data:`repro_torch.launch.collectives.COLLECTIVE_OPS`),
    ``dtype``, ``shape`` and ``bytes`` (the operand's).  Blocks nest; an
    inner block's entries are its own."""
    global _sink
    outer, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = outer


def note(kind: str, operand: torch.Tensor) -> None:
    """Report one collective of ``kind`` on ``operand`` (what leaves this
    rank) to the innermost :func:`record` block, if one is open."""
    if _sink is not None:
        _sink.append({"kind": kind,
                      "dtype": str(operand.dtype).replace("torch.", ""),
                      "shape": tuple(operand.shape),
                      "bytes": _nbytes(operand)})


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: operators that allocate their output and move no bytes
_ALLOC_ONLY = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


class OpCounter(TorchDispatchMode):
    """The bytes every aten operator run inside the block reads and
    writes, and the peak of the bytes those operators allocated that
    were live at once.

    An operator moves each distinct tensor argument once (read, or, for
    a mutated operand of an in-place or ``out=`` form, written once) and
    each output that is not an alias of an argument once (written).  A
    view (``view``, ``as_strided``, ``expand``, ``t``, ``unbind``'s
    outputs, ...) and an output on an argument's storage (``_unsafe_view``)
    move nothing; ``empty`` and its kin allocate and move nothing.
    Operators of other namespaces (the collectives, ``c10d``) are left
    out: :func:`note` accounts for them.  A storage counts as live from
    the operator that created it until it is freed (its Python object is
    kept while the storage lives, so its finalizer runs exactly then).

    This is the traffic of the operators as the eager port runs them,
    unfused: each per-use cast and each elementwise pass is counted.  It
    is not the least traffic the work needs."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        self.ops += 1
        if func.is_view:
            return out
        ins = {id(t): t for t in _tensors(args)
               + _tensors(list(kwargs.values()))}
        outs = out if isinstance(out, (list, tuple)) else (out,)
        returns = func._schema.returns
        fresh = []
        for ret, value in zip(returns, outs):
            if ret.alias_info is not None:
                continue                    # the mutated operand, or a view
            fresh += [t for t in _tensors(value) if id(t) not in ins]
        if fresh:
            held = {id(t.untyped_storage()) for t in ins.values()}
            fresh = [t for t in fresh if id(t.untyped_storage()) not in held]
        for t in fresh:
            self._track(t)
        if func in _ALLOC_ONLY:
            return out
        self.bytes += sum(_nbytes(t) for t in ins.values()) + \
            sum(_nbytes(t) for t in fresh)
        return out
