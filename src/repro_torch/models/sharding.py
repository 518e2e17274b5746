"""Sharding rules: parameter / optimizer-state / activation partition
specs, the JAX package's structural rules over a mesh's axis sizes.

A mesh is ``(shape, axis_names)``, as ``launch/mesh.py`` gives it:
``((16, 16), ("data", "model"))`` single-pod, ``((2, 16, 16), ("pod",
"data", "model"))`` multi-pod.  A spec is a tuple with one entry per
leading dim it names — an axis name, a tuple of axis names, or ``None``
(replicated) — equal entry for entry to the JAX package's
``PartitionSpec``; ``()`` replicates the whole leaf.

Conventions:
  * batch axes of activations shard over the data axes
    (("pod","data") multi-pod, ("data",) single-pod);
  * tensor-parallel dims shard over "model": attention heads, FFN hidden,
    MoE experts (EP), SSM d_inner, vocab (embedding + logits);
  * dims not divisible by the model-axis size stay replicated (e.g. KV
    heads = 8 on a 16-way model axis — replication is the deliberate,
    Llama-TP-style choice);
  * optimizer moments inherit the param spec; with ``cfg.zero1`` the
    largest replicated dim additionally shards over "data" (ZeRO-1).

Specs are derived *structurally* from parameter names + shapes, so any
tree the model inits produce (tensors, or stand-ins on the ``"meta"``
device) gets consistent rules without per-arch tables.

Placing the shards across cards waits for a multi-card deployment: on
one card every leaf stays whole on the card, whatever its spec says.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

from repro_torch.train.tree import map_tree

__all__ = ["batch_specs", "cache_specs", "data_axes", "is_spec",
           "opt_state_specs", "param_specs"]

Params = Any
Mesh = Tuple[Sequence[int], Sequence[str]]
Spec = Tuple[Any, ...]


def _sizes(mesh: Mesh) -> Dict[str, int]:
    shape, axes = mesh
    return dict(zip(axes, shape))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    sizes = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _model_size(mesh: Mesh) -> int:
    return _sizes(mesh).get("model", 1)


def _dsize(mesh: Mesh) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


# Rules keyed by parameter leaf name: map dim index -> axis, guarded by
# divisibility.  `None` entries mean replicated.
_NAME_RULES = {
    # embeddings / unembeddings: vocab on model
    "table": (0, "model"),
    # attention
    "wq": (1, "model"), "wk": (1, "model"), "wv": (1, "model"),
    "wo": (0, "model"),
    "bq": (0, "model"), "bk": (0, "model"), "bv": (0, "model"),
    # dense MLPs (SwiGLU + GELU)
    "w_gate": (-1, "model"), "w_up": (-1, "model"), "w_down": (-2, "model"),
    "w_in": (-1, "model"), "b_in": (-1, "model"), "w_out": (-2, "model"),
    # MoE: expert dim on model (EP).  (w_gate/w_up/w_down of experts are
    # 3D — handled by ndim check below.)
    "router": None,
    # SSM streams: d_inner on model; B/C/dt tiny -> replicated
    "in_z": (-1, "model"), "in_x": (-1, "model"),
    "in_b": None, "in_c": None, "in_dt": None,
    "conv_x": (-1, "model"), "conv_bias_x": (-1, "model"),
    "conv_b": None, "conv_c": None, "conv_bias_b": None, "conv_bias_c": None,
    "a_log": (-1, "model"), "dt_bias": (-1, "model"), "d_skip": (-1, "model"),
    "norm_scale": (-1, "model"),
    "out_proj": (0, "model"),
    # norms / misc
    "scale": None, "bias": None, "b_out": None,
}


def _one(ndim: int, dim: int, axis) -> Spec:
    spec = [None] * ndim
    spec[dim] = axis
    return tuple(spec)


def _spec_for(path: str, leaf, msize: int) -> Spec:
    name = path.split("/")[-1]
    shape = tuple(leaf.shape)
    ndim = len(shape)
    rule = _NAME_RULES.get(name, None)

    # MoE expert tensors: (..., E, D, F) with a leading stacked-group axis
    # possibly present: shard the expert dim (ndim - 3) when it divides
    if name in ("w_gate", "w_up", "w_down") and ndim >= 3:
        edim = ndim - 3
        if shape[edim] % msize == 0 and shape[edim] >= msize:
            return _one(ndim, edim, "model")
        # fall through to hidden-dim rule

    if rule is None:
        return ()
    dim, axis = rule
    dim = dim % ndim if ndim else 0
    # the rules were written for unstacked params: a positive dim may sit
    # one further right behind the stacked group axis, so that reading
    # is tried when the first does not divide
    candidates = [dim]
    if rule[0] >= 0:
        candidates.append(rule[0] + 1 if rule[0] + 1 < ndim else dim)
    for dcand in candidates:
        if shape[dcand] % msize == 0 and shape[dcand] >= msize:
            return _one(ndim, dcand, axis)
    return ()


def param_specs(params: Params, mesh: Mesh) -> Params:
    msize = _model_size(mesh)
    return map_tree(lambda path, leaf: _spec_for(path, leaf, msize), params,
                    with_path=True)


def opt_state_specs(pspecs: Params, params: Params, mesh: Mesh,
                    zero1: bool) -> Params:
    """Moments inherit the param spec; ZeRO-1 additionally shards the
    largest replicated dim over the data axes when divisible."""
    daxes = data_axes(mesh)
    dsize = _dsize(mesh)

    def widen(spec: Spec, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not zero1 or not shape:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        # find largest dim currently replicated & divisible by data size
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if entries[i] is None and shape[i] % dsize == 0 \
                    and shape[i] >= dsize:
                entries[i] = daxes if len(daxes) > 1 else daxes[0]
                break
        return tuple(entries)

    return map_tree(widen, pspecs, params, is_leaf=is_spec)


def batch_specs(batch_tree: Params, mesh: Mesh) -> Params:
    """Shard the leading (batch) dim of every input over the data axes
    (replicate when the batch doesn't divide — e.g. global_batch=1)."""
    daxes = data_axes(mesh)
    ax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    dsz = _dsize(mesh)

    def spec(leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not shape or shape[0] % dsz or shape[0] < dsz:
            return (None,) * len(shape)
        return (ax,) + (None,) * (len(shape) - 1)

    return map_tree(spec, batch_tree)


def cache_specs(cache_tree: Params, mesh: Mesh) -> Params:
    """KV caches / SSM states: batch dim over data; KV-head or d_inner dim
    over model when divisible.  Layout (groups?, B, S, KV, hd) or SSM
    {h: (groups?, B, H, N, P), conv_*: (groups?, B, K-1, C)}."""
    daxes = data_axes(mesh)
    dax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    msize = _model_size(mesh)
    dsz = _dsize(mesh)

    def walk(path: str, leaf) -> Spec:
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        # batch dim: KV caches are 5D (G,B,S,KV,hd) or 4D (B,S,KV,hd);
        # ssm h is 5D (G,B,H,N,P) or 4D; conv bufs 4D (G,B,K,C) or 3D
        bdim = 1 if nd >= 4 and name in ("k", "v", "h") else \
            (1 if nd == 4 and name.startswith("conv") else 0)
        if name in ("k", "v") and nd == 4:
            bdim = 0
        if name == "h" and nd == 4:
            bdim = 0
        if name.startswith("conv") and nd == 3:
            bdim = 0
        if name in ("cross_k", "cross_v"):
            bdim = 1
        batch_ok = shape[bdim] % dsz == 0 and shape[bdim] >= dsz
        if batch_ok:
            spec[bdim] = dax
        # model axis: KV heads (dim -2 of k/v) or SSM heads (dim bdim+1 of h)
        if name in ("k", "v", "cross_k", "cross_v") and \
                shape[-2] % msize == 0 and shape[-2] >= msize:
            spec[nd - 2] = "model"
        if name == "h" and shape[bdim + 1] % msize == 0 \
                and shape[bdim + 1] >= msize:
            spec[bdim + 1] = "model"
        if name == "conv_x" and shape[-1] % msize == 0 \
                and shape[-1] >= msize:
            spec[nd - 1] = "model"
        # long-context, batch-1 decode: sequence-parallel KV — shard the
        # cache length over the data axes instead of the batch
        if not batch_ok and name in ("k", "v") and nd >= 3:
            sdim = bdim + 1
            if shape[sdim] % dsz == 0 and shape[sdim] >= dsz:
                spec[sdim] = dax
        return tuple(spec)

    return map_tree(walk, cache_tree, with_path=True)


def is_spec(x) -> bool:
    """True for a spec (a plain tuple), the leaf of a spec tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")
