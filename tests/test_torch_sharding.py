"""The sharding rules held against the JAX package: for every config at
its published size, the specs of its params, optimizer state (with and
without ZeRO-1), batches and caches equal the reference's
``PartitionSpec`` entries, on the (16, 16) and (2, 16, 16) production
meshes (shapes only: the port's trees on the ``"meta"`` device, the
reference's from ``jax.eval_shape``)."""

import dataclasses
import types

import jax
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get as ref_get
from repro.models import api as ref_api
from repro.models import sharding as r_shard
from repro.models.config import SHAPES as REF_SHAPES

from repro_torch.configs import get
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding
from repro_torch.models.api import Model
from repro_torch.models.config import SHAPES
from repro_torch.train.tree import flatten_with_paths

NAMES = sorted(REF_ARCHS)
MESHES = {"single_pod": False, "multi_pod": True}


def ref_mesh(mesh):
    """The reference's rules read only ``mesh.shape``: axis -> size."""
    shape, axes = mesh
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def ref_flat(tree):
    """Path -> spec entries of a tree of ``PartitionSpec``s."""
    out = {}

    def walk(path, spec):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = tuple(spec)
        return spec

    jax.tree_util.tree_map_with_path(
        walk, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def port_flat(tree):
    return dict(flatten_with_paths(tree, is_leaf=sharding.is_spec))


def same_specs(got, want):
    g, w = port_flat(got), ref_flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k] == w[k], (k, g[k], w[k])
    return len(w)


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    mesh = mesh_mod.make_production_mesh(multi_pod=MESHES[request.param])
    return mesh, ref_mesh(mesh)


@pytest.mark.parametrize("name", NAMES)
def test_param_and_opt_state_specs(name, meshes):
    mesh, rmesh = meshes
    cfg, ref_cfg = get(name), ref_get(name)
    rparams = jax.eval_shape(ref_api.Model(ref_cfg).init,
                             jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    params = Model(cfg).init(None, device="meta")
    rspecs = r_shard.param_specs(rparams, rmesh)
    specs = sharding.param_specs(params, mesh)
    assert same_specs(specs, rspecs) > 0
    sharded = [s for s in port_flat(specs).values() if s]
    assert sharded, "no leaf shards over the model axis"
    for zero1 in (False, True):
        same_specs(sharding.opt_state_specs(specs, params, mesh, zero1),
                   r_shard.opt_state_specs(rspecs, rparams, rmesh, zero1))


@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_specs(name, meshes):
    mesh, rmesh = meshes
    cfg, ref_cfg = get(name), ref_get(name)
    m, rm = Model(cfg), ref_api.Model(ref_cfg)
    for cell, rcell in zip(SHAPES, REF_SHAPES):
        assert dataclasses.astuple(cell) == dataclasses.astuple(rcell)
        specs, rspecs = m.input_specs(cell), rm.input_specs(rcell)
        if cell.kind == "decode":
            same_specs(sharding.cache_specs(specs["caches"], mesh),
                       r_shard.cache_specs(rspecs["caches"], rmesh))
            specs = {"tokens": specs["tokens"]}
            rspecs = {"tokens": rspecs["tokens"]}
        same_specs(sharding.batch_specs(specs, mesh),
                   r_shard.batch_specs(rspecs, rmesh))


def test_meshes_equal_the_reference():
    assert mesh_mod.make_production_mesh() == ((16, 16), ("data", "model"))
    assert mesh_mod.make_production_mesh(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    assert mesh_mod.make_query_mesh() == ((256,), ("data",))
    assert mesh_mod.make_query_mesh(multi_pod=True) == ((512,), ("data",))
    assert mesh_mod.make_query_mesh(8) == ((8,), ("data",))
    mesh_mod.require_ranks(mesh_mod.make_query_mesh(1), 1)
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_mod.require_ranks(mesh_mod.make_production_mesh(), 1)
    assert mesh_mod.HW.PEAK_FLOPS_BF16 == 989e12
