"""replint for the port — an AST lint for device code written with torch.

The torch twin of :mod:`repro.analysis.lint`.  It flags the pitfalls
that only show on the card: Python control flow on a tensor (a hidden
device-to-host sync), explicit host reads inside device code, int
literals past the int32 lattice, shapes that come from tensor values
(every one reads a count back and blocks CUDA-graph capture), and sorts
that do not promise stability.

The lint is *scoped*: most rules only apply inside functions the
analyzer believes run on the device.  torch has no tracer, so a
function is *device code* when any of these hold, closed under the
intra-module call graph:

* its name marks it as device code (``device_*`` / ``_device*``);
* it is an executor's program (a name ending in ``_program``: the
  single-device ``_program`` and the distributed ``_shard_program``);
* it is a kernel's launch wrapper: it counts a launch
  (``launches[...] += 1``), or reaches a function of its module that
  does;
* it is called (by simple name or ``self.name``) from device code.

Taint model (which expressions hold *tensors*): results of ``torch.*``
calls (but not of ``torch.cuda`` / ``torch.distributed`` calls or the
host helpers in ``_TORCH_HOST_FNS``), of ``ops.*`` calls (the kernels'
wrappers) and of calls to ``device_*``-named functions are tainted; a
tensor method's result is tainted; taint propagates through arithmetic,
comparisons, subscripts and assignments.  Calls to other local helpers
are *untainted*, as in the original: they return host metadata (column
tuples, capacities), and branching on their results is the supported
idiom.  ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` reads and
``.size()`` / ``.numel()`` / ``.dim()`` / ``.data_ptr()`` calls are
always untainted (host metadata, no sync).  ``.n`` / ``.data`` /
``.overflow`` reads are always tainted: those are the ``JBindings``
device attributes (:mod:`repro_torch.core.jexec`).  Function parameters
are untainted.  A Python list/tuple/set holding tensors is tracked as a
*container*: iterating or truth-testing it is host-side and fine, but
indexing it yields a tensor and handing it to ``np.*`` is still a host
sync.

Suppressions: ``# replint: disable=<rule> -- <justification>`` on the
offending line, or standing alone on the line directly above it.  A
directive without the ``-- <justification>`` tail is itself a finding
(``bare-suppression``) and cannot be suppressed.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["LintFinding", "RULES", "lint_source", "lint_file", "lint_paths"]

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

#: rule id -> one-line description (the lint catalog).  Each rule of the
#: original stands here under the name that fits torch; the original's
#: ``shard-map-check-rep`` has no counterpart, since the port has no
#: ``shard_map`` (its distributed engine calls ``torch.distributed``
#: collectives directly), so no rule is kept that could never fire.
RULES: Dict[str, str] = {
    "tensor-branch":
        "Python if/while/ternary on a tensor inside device code (the "
        "original's traced-branch) — reads the value back to the host: "
        "on CUDA a hidden sync.",
    "host-sync":
        "Host synchronisation inside device code: .item(), .cpu(), "
        ".numpy(), .tolist(), or np.* / float() / int() / bool() "
        "applied to a tensor — blocks on the device.",
    "int32-overflow":
        "Integer literal outside int32 range inside device code — "
        "silently promotes the lattice past the engine's int32 id space.",
    "nonstatic-shape":
        "A shape that comes from a tensor's value: a constructor, view "
        "or expand sized by a tensor (e.g. a JBindings .n), or an op "
        "whose output shape depends on the data (nonzero, boolean-mask "
        "indexing, masked_select, unique, one-argument where, "
        "repeat_interleave without output_size) — each reads a count "
        "back and blocks CUDA-graph capture.",
    "unstable-sort":
        "sort / argsort of a tensor without stable=True — JAX's sort is "
        "stable by contract, and the port's ORDER BY, DISTINCT and join "
        "build rely on ties keeping their order.",
    "bare-suppression":
        "replint suppression without a '-- <justification>' tail — "
        "unexplained suppressions are not allowed.",
}

#: module aliases whose call results are tensors.
_DEVICE_MODULES = {"torch", "ops", "F"}

#: attribute-chain members under ``torch`` whose calls are host-side
#: (streams, events, collectives, backend switches, the C module's raw
#: stream handles and device indices), never tensors.
_HOST_SUBMODULES = {"cuda", "distributed", "backends", "dist", "_C"}

#: ``torch.*`` functions that return host values, not tensors.
_TORCH_HOST_FNS = {
    "device", "Size", "iinfo", "finfo", "is_tensor", "Generator",
    "get_default_dtype", "is_floating_point", "promote_types",
    "result_type", "can_cast", "no_grad", "inference_mode",
    "set_grad_enabled", "get_num_threads", "set_num_threads",
}

#: host modules whose calls on tensors force a device->host sync.
_HOST_MODULES = {"np", "numpy"}

#: attribute reads that are host metadata (never tainted).
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}

#: tensor methods that return host metadata without a sync.
_STATIC_METHODS = {
    "size", "numel", "dim", "nelement", "data_ptr", "element_size",
    "stride", "storage_offset", "is_contiguous", "get_device",
}

#: tensor methods that copy a value back to the host (a sync).
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}

#: attribute reads that are always device values (JBindings convention).
_TAINTED_ATTRS = {"n", "data", "overflow"}

#: constructors whose positional shape arguments (or ``size=`` /
#: ``shape=``) must be host values; ``full`` / ``new_full`` take only
#: their first positional argument as the shape.
_SHAPE_FNS = {"zeros", "ones", "empty", "arange", "new_zeros", "new_ones",
              "new_empty", "full", "new_full"}
_FIRST_ARG_SHAPE = {"full", "new_full"}

#: ops whose shape argument follows the tensor when called as
#: ``torch.f(x, shape)`` and leads when called as ``x.f(shape)``.
_VIEW_FNS = {"reshape", "view", "expand", "broadcast_to"}

#: ops whose output shape depends on the data.
_DATA_SHAPE_FNS = {"nonzero", "argwhere", "masked_select", "unique",
                   "unique_consecutive"}

#: calls whose results are boolean masks (for mask indexing).
_MASK_FNS = {"isnan", "isinf", "isfinite", "isin", "eq", "ne", "lt", "le",
             "gt", "ge", "logical_and", "logical_or", "logical_not",
             "logical_xor"}

_SORT_FNS = {"sort", "argsort"}


@dataclass(frozen=True)
class LintFinding:
    """One lint violation at a source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


def _terminal(node: ast.expr) -> Optional[str]:
    """The last dotted component of a Name/Attribute chain, else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _chain(node: ast.expr) -> List[str]:
    """The dotted components of a Name/Attribute chain, base first
    (``["torch", "cuda", "synchronize"]``); empty for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return []
    parts.append(node.id)
    return parts[::-1]


def _root(node: ast.expr) -> Optional[str]:
    """The base Name of a Name/Attribute chain (``np`` in ``np.a.b``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _device_call(func: ast.expr) -> bool:
    """Whether calling ``func`` (a module function) returns a tensor."""
    parts = _chain(func)
    if not parts or parts[0] not in _DEVICE_MODULES:
        return False
    if len(parts) == 1:                     # a bare call of the alias
        return False
    if any(p in _HOST_SUBMODULES for p in parts[1:-1]):
        return False
    return parts[-1] not in _TORCH_HOST_FNS


def _counts_launch(node: ast.AST) -> bool:
    """``launches[...] += 1``: the statement a launch wrapper makes
    where it launches its kernel."""
    return (isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Subscript)
            and _terminal(node.target.value) == "launches")


class _ModuleScan(ast.NodeVisitor):
    """First pass: function registry, device-code seeds, call graph."""

    def __init__(self) -> None:
        self.funcs: Dict[str, ast.AST] = {}
        self.seeds: Set[str] = set()
        self.launchers: Set[str] = set()
        self.callees: Dict[str, Set[str]] = {}
        self._stack: List[str] = []

    # -- functions -----------------------------------------------------------
    def _handle_def(self, node) -> None:
        self.funcs[node.name] = node
        name = node.name
        if name.startswith("device_") or name.startswith("_device") \
                or name.endswith("_program"):
            self.seeds.add(name)
        self.callees.setdefault(name, set())
        self._stack.append(name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _handle_def
    visit_AsyncFunctionDef = _handle_def

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self._stack and _counts_launch(node):
            self.launchers.add(self._stack[-1])
        self.generic_visit(node)

    # -- call sites ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        term = _terminal(node.func)
        if self._stack and term:
            self.callees[self._stack[-1]].add(term)
        self.generic_visit(node)

    def _closure(self, start: Set[str]) -> Set[str]:
        """``start`` closed under the intra-module call graph."""
        out = set(start)
        changed = True
        while changed:
            changed = False
            for fn in list(out):
                for callee in self.callees.get(fn, ()):
                    if callee in self.funcs and callee not in out:
                        out.add(callee)
                        changed = True
        return out

    def traced(self) -> Set[str]:
        """Device code: the seeds and every launch wrapper (a function
        from which a launch count is reachable), closed under the
        intra-module call graph."""
        wrappers = {fn for fn in self.funcs
                    if self._closure({fn}) & self.launchers}
        return self._closure(self.seeds | wrappers)


#: taint lattice: 0 = clean (host), 1 = tensor, 2 = host container
#: holding tensors.
_CLEAN, _TRACED, _CONTAINER = 0, 1, 2


class _TracedChecker:
    """Second pass: taint-tracking walk over one device function body."""

    def __init__(self, path: str, findings: List[LintFinding]) -> None:
        self.path = path
        self.findings = findings
        self.tainted: Dict[str, int] = {}
        self.masks: Set[str] = set()

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(LintFinding(
            self.path, node.lineno, node.col_offset, rule, message))

    # -- statements ----------------------------------------------------------
    def run(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            t = self.expr(s.value)
            mask = self._is_mask(s.value)
            for target in s.targets:
                self._bind(target, t, mask)
        elif isinstance(s, ast.AnnAssign):
            t = self.expr(s.value) if s.value is not None else _CLEAN
            self._bind(s.target, t,
                       s.value is not None and self._is_mask(s.value))
        elif isinstance(s, ast.AugAssign):
            t = self.expr(s.value)
            if isinstance(s.target, ast.Name):
                prev = self.tainted.get(s.target.id, _CLEAN)
                if max(t, prev):
                    self.tainted[s.target.id] = max(t, prev)
            else:
                self.expr(s.target)
        elif isinstance(s, ast.If):
            if self.expr(s.test) == _TRACED:
                self._emit(s, "tensor-branch",
                           "Python `if` on a tensor (a hidden host sync)")
            self.run(s.body)
            self.run(s.orelse)
        elif isinstance(s, ast.While):
            if self.expr(s.test) == _TRACED:
                self._emit(s, "tensor-branch",
                           "Python `while` on a tensor (a hidden host "
                           "sync)")
            self.run(s.body)
            self.run(s.orelse)
        elif isinstance(s, ast.For):
            it = self.expr(s.iter)
            # iterating a tensor or a container of tensors binds tensors
            # (views: no sync, unlike a branch on one)
            self._bind(s.target, _TRACED if it else _CLEAN)
            self.run(s.body)
            self.run(s.orelse)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs inherit the closure's taint
            self.run(s.body)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.expr(s.value)
        elif isinstance(s, ast.Expr):
            self.expr(s.value)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.expr(item.context_expr)
            self.run(s.body)
        elif isinstance(s, ast.Try):
            self.run(s.body)
            for h in s.handlers:
                self.run(h.body)
            self.run(s.orelse)
            self.run(s.finalbody)
        elif isinstance(s, (ast.Assert, ast.Raise, ast.Delete)):
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child)
        # pass/import/global/... carry no expressions we track

    def _bind(self, target: ast.expr, taint: int, mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            if taint:
                self.tainted[target.id] = taint
            else:
                self.tainted.pop(target.id, None)
            if mask:
                self.masks.add(target.id)
            else:
                self.masks.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # unpacking a container of tensors binds tensors
            elt = _TRACED if taint else _CLEAN
            for e in target.elts:
                self._bind(e, elt)
        elif isinstance(target, ast.Subscript):
            # a store through an index (``x[mask] = v``) is a masked
            # write, not a data-dependent shape: walk its parts only
            self.expr(target.value)
            self.expr(target.slice)
        elif isinstance(target, (ast.Attribute, ast.Starred)):
            self.expr(target)

    # -- masks ---------------------------------------------------------------
    def _is_mask(self, e: ast.expr) -> bool:
        """Whether ``e`` is a boolean tensor (for mask indexing)."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(self._taint_of(x) == _TRACED
                       for x in [e.left, *e.comparators])
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self._is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(e.left) or self._is_mask(e.right)
        if isinstance(e, ast.Call):
            term = _terminal(e.func)
            return term in _MASK_FNS and _root(e.func) not in _HOST_MODULES
        return False

    def _taint_of(self, e: ast.expr) -> int:
        """Taint of ``e`` without emitting findings (a read-only probe)."""
        saved = len(self.findings)
        t = self.expr(e)
        del self.findings[saved:]
        return t

    # -- expressions ---------------------------------------------------------
    def expr(self, e: Optional[ast.expr]) -> int:
        """Walk an expression, emitting findings; returns its taint level."""
        if e is None:
            return _CLEAN
        if isinstance(e, ast.Name):
            return self.tainted.get(e.id, _CLEAN)
        if isinstance(e, ast.Constant):
            if isinstance(e.value, int) and not isinstance(e.value, bool):
                if e.value > INT32_MAX or e.value < INT32_MIN:
                    self._emit(e, "int32-overflow",
                               f"int literal {e.value} exceeds int32 range "
                               "in device code")
            return _CLEAN
        if isinstance(e, ast.Attribute):
            base = self.expr(e.value)
            if e.attr in _STATIC_ATTRS:
                return _CLEAN
            if e.attr in _TAINTED_ATTRS:
                return _TRACED
            return base
        if isinstance(e, ast.Call):
            return self._call(e)
        if isinstance(e, ast.IfExp):
            if self.expr(e.test) == _TRACED:
                self._emit(e, "tensor-branch",
                           "conditional expression on a tensor (a hidden "
                           "host sync)")
            return max(self.expr(e.body), self.expr(e.orelse))
        if isinstance(e, ast.BinOp):
            return max(self.expr(e.left), self.expr(e.right))
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand)
        if isinstance(e, ast.Compare):
            t = self.expr(e.left)
            for cmp in e.comparators:
                t = max(self.expr(cmp), t)
            # `x is None` / `in` on a tensor operand is a host identity /
            # membership test over Python structure, not device compute
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return _CLEAN
            return min(t, _TRACED)
        if isinstance(e, ast.BoolOp):
            t = _CLEAN
            for v in e.values:
                t = max(self.expr(v), t)
            return min(t, _TRACED)
        if isinstance(e, ast.Subscript):
            val = self.expr(e.value)
            sub = self.expr(e.slice)
            idx = e.slice.elts if isinstance(e.slice, ast.Tuple) \
                else [e.slice]
            if isinstance(e.ctx, ast.Load) and val != _CONTAINER and \
                    any(self._is_mask(i) for i in idx):
                self._emit(e, "nonstatic-shape",
                           "boolean-mask indexing: the result's length is "
                           "the mask's count, read back from the device")
            if val == _CONTAINER:
                # slicing a container keeps the container level; indexing
                # it yields one of its tensors
                val = _CONTAINER if isinstance(e.slice, ast.Slice) \
                    else _TRACED
            return max(val, min(sub, _TRACED))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            t = _CLEAN
            for elt in e.elts:
                t = max(self.expr(elt), t)
            return _CONTAINER if t else _CLEAN
        if isinstance(e, ast.Dict):
            t = _CLEAN
            for k in e.keys:
                if k is not None:
                    t = max(self.expr(k), t)
            for v in e.values:
                t = max(self.expr(v), t)
            return _CONTAINER if t else _CLEAN
        if isinstance(e, ast.Slice):
            t = self.expr(e.lower)
            t = max(self.expr(e.upper), t)
            return max(self.expr(e.step), t)
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, ast.Lambda):
            self.expr(e.body)
            return _CLEAN
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            t = _CLEAN
            for gen in e.generators:
                gt = self.expr(gen.iter)
                self._bind(gen.target, _TRACED if gt else _CLEAN)
                for cond in gen.ifs:
                    self.expr(cond)
                t = max(gt, t)
            if isinstance(e, ast.DictComp):
                t = max(self.expr(e.key), t)
                t = max(self.expr(e.value), t)
            else:
                t = max(self.expr(e.elt), t)
            return _CONTAINER if t else _CLEAN
        # fallback: max over child expressions
        t = _CLEAN
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                t = max(self.expr(child), t)
        return t

    def _call(self, e: ast.Call) -> int:
        func_taint = _CLEAN
        if isinstance(e.func, (ast.Name, ast.Attribute)):
            # walking the func expr also handles taint of `x.sum` etc.
            func_taint = self.expr(e.func)
        else:
            self.expr(e.func)
        arg_taints = [self.expr(a) for a in e.args]
        kw_taints = {kw.arg: self.expr(kw.value) for kw in e.keywords}
        any_arg = any(arg_taints) or any(kw_taints.values())

        term = _terminal(e.func)
        root = _root(e.func)
        method = isinstance(e.func, ast.Attribute) and \
            root not in _DEVICE_MODULES | _HOST_MODULES
        on_host_module = root in _HOST_MODULES

        # host syncs -----------------------------------------------------
        if method and term in _SYNC_METHODS:
            self._emit(e, "host-sync",
                       f".{term}() copies a device value to the host in "
                       "device code")
            return _CLEAN
        if on_host_module and any_arg:
            self._emit(e, "host-sync",
                       f"{root}.{term}() on a tensor forces a host sync")
            return _CLEAN
        if isinstance(e.func, ast.Name) and e.func.id in (
                "float", "int", "bool") and any_arg:
            self._emit(e, "host-sync",
                       f"{e.func.id}() on a tensor forces a host sync")
            return _CLEAN

        # shapes ---------------------------------------------------------
        if not on_host_module:
            self._shapes(e, term, root, arg_taints, kw_taints)

        # sorts ----------------------------------------------------------
        if term in _SORT_FNS and not on_host_module and \
                (root == "torch" or (method and func_taint == _TRACED)):
            stable = any(kw.arg == "stable" and isinstance(
                kw.value, ast.Constant) and kw.value.value is True
                for kw in e.keywords)
            if not stable:
                self._emit(e, "unstable-sort",
                           f"{term}() without stable=True: ties may come "
                           "back in any order")

        # result taint: tensors from torch / the kernels' wrappers, from
        # device_* functions and from tensor methods.  Other local
        # helpers return host metadata in this codebase.
        if method and term in _STATIC_METHODS:
            return _CLEAN
        if _device_call(e.func):
            return _TRACED
        if term and (term.startswith("device_") or term.startswith("_device")):
            return _TRACED
        return min(func_taint, _TRACED)

    def _shapes(self, e: ast.Call, term: Optional[str], root: Optional[str],
                arg_taints: List[int], kw_taints: Dict[str, int]) -> None:
        """The ``nonstatic-shape`` rule at one call."""
        if term in _SHAPE_FNS:
            shape_args = arg_taints[:1] if term in _FIRST_ARG_SHAPE \
                else list(arg_taints)
            shape_args += [kw_taints[k] for k in ("size", "shape")
                           if k in kw_taints]
            if any(shape_args):
                self._emit(e, "nonstatic-shape",
                           f"{term}() shape derives from a tensor — the "
                           "size is read back from the device")
        elif term in _VIEW_FNS:
            shape_args = arg_taints[1:] if root == "torch" else arg_taints
            if any(shape_args):
                self._emit(e, "nonstatic-shape",
                           f".{term}() target derives from a tensor — the "
                           "size is read back from the device")
        elif term in _DATA_SHAPE_FNS:
            self._emit(e, "nonstatic-shape",
                       f"{term}() has a data-dependent output shape (reads "
                       "a count back, blocks CUDA-graph capture)")
        elif term == "repeat_interleave" and \
                "output_size" not in kw_taints:
            self._emit(e, "nonstatic-shape",
                       "repeat_interleave() without output_size reads its "
                       "total back from the device")
        elif term == "where" and root == "torch" and \
                len(e.args) == 1 and not e.keywords:
            self._emit(e, "nonstatic-shape",
                       "one-argument torch.where() is nonzero(): a "
                       "data-dependent output shape")


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*replint:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?\s*$")


def _scan_suppressions(
    source: str, path: str,
) -> Tuple[Dict[int, Set[str]], List[LintFinding]]:
    """Map of line -> suppressed rules, plus bare-suppression findings.

    An inline directive covers its own line; a directive on a line of its
    own covers the line below it.
    """
    suppressed: Dict[int, Set[str]] = {}
    findings: List[LintFinding] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        justified = m.group(2) is not None
        if not justified:
            findings.append(LintFinding(
                path, lineno, m.start(), "bare-suppression",
                "suppression lacks a '-- <justification>' tail"))
        target = lineno + 1 if text.lstrip().startswith("#") else lineno
        suppressed.setdefault(target, set()).update(rules)
    return suppressed, findings


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[LintFinding]:
    """Lint one module's source text; returns findings sorted by location."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [LintFinding(path, exc.lineno or 1, exc.offset or 0,
                            "syntax-error", f"cannot parse: {exc.msg}")]

    scan = _ModuleScan()
    scan.visit(tree)
    traced = scan.traced()

    findings: List[LintFinding] = []
    for name in sorted(traced):
        node = scan.funcs.get(name)
        if node is None:
            continue  # seed referenced a name defined elsewhere
        checker = _TracedChecker(path, findings)
        checker.run(node.body)

    suppressed, bare = _scan_suppressions(source, path)
    kept = [
        f for f in findings
        if not (f.rule in suppressed.get(f.line, ())
                and f.rule != "bare-suppression")
    ]
    kept.extend(bare)
    # nested device defs are visited both standalone and through their
    # enclosing function — deduplicate by location+rule
    unique = {(f.line, f.col, f.rule): f for f in kept}
    return sorted(unique.values(), key=lambda f: (f.line, f.col, f.rule))


def lint_file(path) -> List[LintFinding]:
    p = Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p))


def lint_paths(paths: Iterable) -> List[LintFinding]:
    """Lint files and/or directory trees (``*.py``, sorted, recursive)."""
    findings: List[LintFinding] = []
    for entry in paths:
        p = Path(entry)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings
