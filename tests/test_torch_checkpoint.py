"""Checkpoints: the port's round trip, atomicity and bit-exact resume on
the CPU, and the format shared with the JAX package — a checkpoint
written by either package restores in the other, with the same key set
and the same manifest fields (values exact)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt

from repro_torch.configs import get_reduced
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, as_tensors, make_batch
from repro_torch.train.optimizer import (AdamWState, OptConfig,
                                         init_opt_state)
from repro_torch.train.train_state import make_train_step
from repro_torch.train.tree import flatten_with_paths, leaves, map_tree

CELL = ShapeCell("t", 32, 4, "train")
NAME = "qwen1.5-0.5b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU tensors: at these sizes
    more threads cost more than they give (a bf16 step of the reduced
    qwen takes 10× as long on eight), and the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced(NAME)
    return cfg, Model(cfg)


def trained_state(model, cfg, steps=2):
    """Params and optimizer state after ``steps`` steps (non-zero
    moments and step)."""
    params = model.init(0, device="cpu")
    state = init_opt_state(params)
    step = make_train_step(model, OptConfig(lr=1e-3))
    dc = DataConfig(seed=3, vocab=cfg.vocab)
    for i in range(steps):
        params, state, _ = step(params, state,
                                as_tensors(make_batch(dc, cfg, CELL, i), "cpu"))
    return params, state


def assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def test_round_trip(tmp_path, setup):
    cfg, model = setup
    params, state = trained_state(model, cfg)
    tree = {"params": params, "opt": state}
    fut = checkpoint.save(str(tmp_path), 7, tree, extra={"note": "x"},
                          async_write=True)
    assert fut.result().endswith("step_00000007")
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored = checkpoint.restore(str(tmp_path), 7, tree)
    assert isinstance(restored["opt"], AdamWState)
    assert restored["opt"].step.dtype == torch.int32
    assert_trees_equal(restored, tree)
    # a tree on the "meta" device is a template: the leaves land on the
    # device asked for
    like = map_tree(lambda x: torch.empty_like(x, device="meta"), tree)
    assert_trees_equal(checkpoint.restore(str(tmp_path), 7, like,
                                          device="cpu"), tree)
    with pytest.raises(ValueError, match="meta"):
        checkpoint.restore(str(tmp_path), 7, like)


def test_save_snapshots_before_it_returns(tmp_path, setup):
    """The caller may update its tensors in place as soon as ``save``
    returns (the train step does): the files hold the values at save."""
    cfg, model = setup
    params = model.init(0, device="cpu")
    want = map_tree(torch.clone, params)
    fut = checkpoint.save(str(tmp_path), 1, params)
    for p in leaves(params):
        p.add_(1.0)
    fut.result()
    assert_trees_equal(checkpoint.restore(str(tmp_path), 1, params), want)


def test_atomicity(tmp_path, setup):
    """A .tmp directory (simulated crash) is never reported as a step."""
    cfg, model = setup
    checkpoint.save(str(tmp_path), 3, {"p": model.init(0, device="cpu")},
                    async_write=False)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "step_00000011"))  # no manifest
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None


def test_resume_is_bit_exact(tmp_path, setup):
    """Save at step k, keep training vs restore + train: identical."""
    cfg, model = setup
    step_fn = make_train_step(model, OptConfig(lr=1e-3))
    dc = DataConfig(seed=3, vocab=cfg.vocab)
    p = model.init(0, device="cpu")
    o = init_opt_state(p)
    losses = []
    for i in range(4):
        p, o, m = step_fn(p, o, as_tensors(make_batch(dc, cfg, CELL, i),
                                           "cpu"))
        losses.append(m["loss"])
        if i == 1:
            checkpoint.save(str(tmp_path), 1, {"params": p, "opt": o},
                            async_write=True).result()
    fresh = model.init(1, device="cpu")
    restored = checkpoint.restore(str(tmp_path), 1,
                                  {"params": fresh,
                                   "opt": init_opt_state(fresh)})
    p2, o2 = restored["params"], restored["opt"]
    for i in (2, 3):
        p2, o2, m = step_fn(p2, o2, as_tensors(make_batch(dc, cfg, CELL, i),
                                               "cpu"))
        assert torch.equal(m["loss"], losses[i])
    assert_trees_equal({"params": p2, "opt": o2}, {"params": p, "opt": o})


def manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(tmp_path, setup):
    cfg, model = setup
    params, state = trained_state(model, cfg)
    np_tree = {"params": map_tree(lambda x: x.numpy(), params),
               "opt": r_opt.AdamWState(
                   step=jnp.int32(int(state.step)),
                   mu=map_tree(lambda x: jnp.asarray(x.numpy()), state.mu),
                   nu=map_tree(lambda x: jnp.asarray(x.numpy()), state.nu))}
    r_ckpt.save(str(tmp_path), 5, np_tree, extra={"by": "reference"},
                async_write=False)
    fresh = model.init(1, device="cpu")
    like = {"params": fresh, "opt": init_opt_state(fresh)}
    restored = checkpoint.restore(str(tmp_path), checkpoint.latest_step(
        str(tmp_path)), like)
    assert_trees_equal(restored, {"params": params, "opt": state})
    m = manifest(str(tmp_path), 5)
    assert m["keys"] == sorted(k for k, _ in flatten_with_paths(like))
    assert "opt/.mu/embed/table" in m["keys"] and "opt/.step" in m["keys"]
    assert "params/groups/pos_0/mixer/wq" in m["keys"]


def test_port_checkpoint_restores_in_the_reference(tmp_path, setup):
    cfg, model = setup
    params, state = trained_state(model, cfg)
    checkpoint.save(str(tmp_path / "port"), 5,
                    {"params": params, "opt": state},
                    extra={"by": "port"}, async_write=False)
    like = {"params": jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
        map_tree(lambda x: x.numpy(), params))}
    like["opt"] = r_opt.AdamWState(
        step=jax.ShapeDtypeStruct((), jnp.int32), mu=like["params"],
        nu=like["params"])
    assert r_ckpt.latest_step(str(tmp_path / "port")) == 5
    restored = r_ckpt.restore(str(tmp_path / "port"), 5, like)
    assert int(restored["opt"].step) == int(state.step) == 2
    for got, want in ((restored["params"], params),
                      (restored["opt"].mu, state.mu),
                      (restored["opt"].nu, state.nu)):
        flat = dict(flatten_with_paths(want))
        for k, v in flatten_with_paths(got):
            np.testing.assert_array_equal(np.asarray(v), flat[k].numpy(), k)
    # the same manifest fields as a checkpoint of the reference's own
    r_ckpt.save(str(tmp_path / "ref"), 5, jax.tree.map(
        jnp.asarray, {"params": map_tree(lambda x: x.numpy(), params),
                      "opt": r_opt.AdamWState(
                          step=np.int32(2),
                          mu=map_tree(lambda x: x.numpy(), state.mu),
                          nu=map_tree(lambda x: x.numpy(), state.nu))}),
        extra={"by": "port"}, async_write=False)
    ours, theirs = manifest(str(tmp_path / "port"), 5), \
        manifest(str(tmp_path / "ref"), 5)
    assert sorted(ours) == sorted(theirs) == sorted(
        ["step", "keys", "shapes", "dtypes", "extra", "n_devices"])
    for field in ("step", "keys", "shapes", "dtypes", "extra"):
        assert ours[field] == theirs[field], field
    assert ours["n_devices"] == 1 and theirs["n_devices"] == \
        jax.device_count()
