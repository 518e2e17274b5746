"""The training path held against the JAX package at reduced size on the
CPU: the value and gradients of ``Model.loss`` for every architecture,
and the train step (plain, with gradient accumulation, with gradient
compression) over 3 steps.  The parameters are drawn from a seed as
numpy arrays (the port's init, written out) and cross into the port
with ``params_from_arrays``; the batches are the data pipeline's
(bit-identical in both packages).  Tolerances:

- gradients, float32: each leaf within ``GRAD_TOL`` of the larger of
  that leaf's largest |g| in the reference and ``ZERO_SHARE`` of the
  whole tree's (a leaf whose exact gradient is 0, as a cross-attention
  key bias's is — softmax does not see a shift of every logit — holds
  only rounding noise).  ``GRAD_TOL`` is 2e-4: jamba's SSD ``a_log``
  through 14 mamba layers differs by 1.02e-4 of its largest |g|;
- losses within ``LOSS_TOL`` relative;
- params and moments after 3 steps within ``OPT_TOL`` absolute, at the
  default learning rate 3e-4: AdamW moves an element whose gradient
  lies at the float32 noise of its sum by up to about ``lr`` a step in
  either package (at lr 1e-2 qwen's embedding differed by 2e-4 there);
  ``grad_norm`` and ``lr`` within ``LOSS_TOL`` relative;
- the error-feedback state within ``OPT_TOL`` but at elements whose
  bf16 rounding tipped (at most ``TIPPED_SHARE`` of them), each within
  one bf16 step: twice the leaf's largest residual.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_reduced as ref_get_reduced
from repro.models import api as ref_api
from repro.train import optimizer as r_opt
from repro.train import train_state as r_ts

from repro_torch.configs import get_reduced
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.models.convert import params_from_arrays
from repro_torch.train.data import DataConfig, as_tensors, make_batch
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                        init_opt_state)
from repro_torch.train.train_state import loss_and_grads, make_train_step
from repro_torch.train.tree import flatten_with_paths, leaves, unflatten_like

NAMES = sorted(REF_ARCHS)
GRAD_TOL = 2e-4
ZERO_SHARE = 1e-3
#: error-feedback state after 3 compressed steps: elements whose bf16
#: rounding tipped between the packages, at most this share
TIPPED_SHARE = 1e-3
LOSS_TOL = 1e-5
OPT_TOL = 1e-5
CELL = ShapeCell("t", 32, 4, "train")


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


def ref_params(cfg, seed=0):
    """A parameter tree of numpy arrays drawn from ``seed``."""
    params = Model(cfg).init(seed, device="cpu")
    return jax.tree.map(lambda x: x.numpy(), params)


def batch_for(cfg, step=0, seed=2):
    seq = CELL.seq_len + (cfg.n_patches if cfg.vlm else 0)
    return make_batch(DataConfig(seed=seed, vocab=cfg.vocab), cfg,
                      ShapeCell("t", seq, CELL.global_batch, "train"), step)


def paths(tree):
    """Path -> float32 numpy array, for a tree of either package."""
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for k, v in flatten_with_paths(tree)}


def grads_close(got, want, what=""):
    g, w = paths(got), paths(want)
    assert sorted(g) == sorted(w)
    floor = ZERO_SHARE * max(float(np.abs(v).max()) for v in w.values())
    for k in w:
        assert np.isfinite(g[k]).all(), (what, k)
        bound = GRAD_TOL * max(float(np.abs(w[k]).max()), floor)
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= bound, (what, k, err, bound)


def rel_close(got, want, tol=LOSS_TOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


def tree_close(got, want, tol=OPT_TOL, what=""):
    g, w = paths(got), paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# value and gradients of Model.loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_value_and_grad_matches_reference(name):
    ref_cfg = ref_get_reduced(name, dtype="float32")
    cfg = get_reduced(name, dtype="float32")
    tree = ref_params(cfg)
    batch = batch_for(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(ref_api.Model(ref_cfg).loss))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = loss_and_grads(Model(cfg),
                               params_from_arrays(cfg, tree, "cpu"),
                               as_tensors(batch, "cpu"))
    rel_close(loss, want_loss)
    grads_close(got, want, name)


def test_grads_leave_the_params_untouched():
    cfg = get_reduced("qwen1.5-0.5b", dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    before = [p.clone() for p in leaves(params)]
    loss, grads = loss_and_grads(Model(cfg), params,
                                 as_tensors(batch_for(cfg), "cpu"))
    assert not loss.requires_grad
    for p, q in zip(leaves(params), before):
        assert not p.requires_grad and p.grad is None and torch.equal(p, q)


# ---------------------------------------------------------------------------
# the train step over 3 steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True)],
                         ids=["plain", "accum2", "compress"])
def test_train_step_matches_reference(accum, compress):
    name = "qwen1.5-0.5b"
    ref_cfg = ref_get_reduced(name, dtype="float32")
    cfg = get_reduced(name, dtype="float32")
    kw = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    tree = ref_params(cfg)
    rstep = jax.jit(r_ts.make_train_step(ref_api.Model(ref_cfg),
                                         r_opt.OptConfig(**kw), accum,
                                         compress))
    step = make_train_step(Model(cfg), OptConfig(**kw), accum, compress)
    rparams, rstate, rerr = tree, r_opt.init_opt_state(tree), None
    params = params_from_arrays(cfg, tree, "cpu")
    state, err = init_opt_state(params), None
    for i in range(3):
        batch = batch_for(cfg, step=i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = as_tensors(batch, "cpu")
        if compress:
            rparams, rstate, rerr, rm = rstep(rparams, rstate, jb, rerr)
            params, state, err, m = step(params, state, tb, err)
        else:
            rparams, rstate, rm = rstep(rparams, rstate, jb)
            params, state, m = step(params, state, tb)
        assert sorted(m) == sorted(rm) == ["grad_norm", "loss", "lr"]
        for k in rm:
            assert m[k].shape == ()
            rel_close(m[k], rm[k])
    assert int(state.step) == int(rstate.step) == 3
    tree_close(params, rparams, what="params")
    tree_close(state.mu, rstate.mu, what="mu")
    tree_close(state.nu, rstate.nu, what="nu")
    if compress:
        # a gradient a float32 rounding apart may round to the next bf16
        # value in one package: the residual then differs by one bf16
        # step of that gradient; elsewhere it is held to OPT_TOL
        g, w = paths(err), paths(rerr)
        tipped = sum(int((np.abs(g[k] - w[k]) > OPT_TOL).sum()) for k in w)
        assert tipped <= TIPPED_SHARE * sum(v.size for v in w.values())
        for k in w:       # a residual is at most half a bf16 step
            bound = max(2 * float(np.abs(w[k]).max()), OPT_TOL)
            assert np.abs(g[k] - w[k]).max() <= bound, k


def test_accumulation_splits_rows_as_the_reference():
    """Microbatch i holds rows i·b/accum … (i+1)·b/accum − 1: a step with
    ``accum_steps=2`` equals AdamW fed the mean of the two halves'
    gradients, and its loss is the halves' mean, exactly."""
    cfg = get_reduced("qwen1.5-0.5b", dtype="float32")
    m = Model(cfg)
    params = m.init(0, device="cpu")
    batch = as_tensors(batch_for(cfg), "cpu")
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    (l0, g0), (l1, g1) = [loss_and_grads(m, params, h) for h in halves]
    opt = OptConfig(clip_norm=1e9)
    mean_g = unflatten_like(g0, [(a + b) / 2 for a, b in zip(leaves(g0),
                                                             leaves(g1))])
    want = copy.deepcopy(params)
    adamw_update(opt, mean_g, init_opt_state(want), want)
    got = copy.deepcopy(params)
    _, _, metrics = make_train_step(m, opt, accum_steps=2)(
        got, init_opt_state(got), batch)
    assert torch.equal(metrics["loss"], (l0 + l1) / 2)
    for (k, a), b in zip(flatten_with_paths(got), leaves(want)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# activation checkpointing, flash chunks, blocked dispatch
# ---------------------------------------------------------------------------

class _Products(TorchDispatchMode):
    """Counts the products dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket.__name__)
        if name in ("mm", "addmm", "bmm"):
            key = name if name != "bmm" or args[0].shape[0] != 1 else "bmm1"
            self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_remat_changes_no_gradient(name):
    cfg = get_reduced(name, dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    batch = as_tensors(batch_for(cfg), "cpu")
    l0, g0 = loss_and_grads(Model(cfg), params, batch)
    l1, g1 = loss_and_grads(Model(dataclasses.replace(cfg, remat=True)),
                            params, batch)
    assert torch.equal(l0, l1)
    for (k, a), b in zip(flatten_with_paths(g0), leaves(g1)):
        assert torch.equal(a, b), k


def test_remat_keeps_products_without_batch_dims():
    """Under the selective policy the backward recomputes the batched
    products of each group and none of the others."""
    cfg = get_reduced("qwen1.5-0.5b", dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    batch = as_tensors(batch_for(cfg), "cpu")
    counts = {}
    for remat in (False, True):
        with _Products() as mode:
            loss_and_grads(Model(dataclasses.replace(cfg, remat=remat)),
                           params, batch)
        counts[remat] = mode.n
    plain, kept = counts[False], counts[True]
    assert kept.get("mm", 0) == plain.get("mm", 0)
    assert kept.get("bmm1", 0) == plain.get("bmm1", 0)
    assert kept["bmm"] > plain["bmm"]


def test_remat_is_off_under_inference():
    cfg = get_reduced("qwen1.5-0.5b", dtype="float32", remat=True)
    m = Model(cfg)
    params = m.init(0, device="cpu")
    tokens = torch.from_numpy(batch_for(cfg)["tokens"])
    with torch.inference_mode():
        a = m.prefill(params, {"tokens": tokens})
    b = Model(dataclasses.replace(cfg, remat=False)).prefill(
        params, {"tokens": tokens})
    assert torch.equal(a, b)


def test_flash_chunk_gradients_equal_dense():
    """The counterpart of the reference's flash ``test_gradients_flow``:
    finite, non-zero, and equal to the dense path's within
    ``GRAD_TOL``."""
    cfg = get_reduced("mistral-nemo-12b", dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    batch = as_tensors(batch_for(cfg), "cpu")
    dense_loss, dense = loss_and_grads(Model(cfg), params, batch)
    loss, flash = loss_and_grads(
        Model(dataclasses.replace(cfg, flash_chunk=8)), params, batch)
    rel_close(loss, dense_loss)
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in leaves(flash)))
    assert torch.isfinite(gnorm) and float(gnorm) > 0
    grads_close(flash, dense, "flash")


def test_blocked_dispatch_trains():
    """The counterpart of the reference's ``test_blocked_trains``, held
    to the reference's value and gradients (float32: the same routing)."""
    name = "deepseek-moe-16b"
    moe = lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch_blocks=2))
    ref_cfg = moe(ref_get_reduced(name, dtype="float32"))
    cfg = moe(get_reduced(name, dtype="float32"))
    tree = ref_params(cfg)
    batch = batch_for(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(ref_api.Model(ref_cfg).loss))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = loss_and_grads(Model(cfg),
                               params_from_arrays(cfg, tree, "cpu"),
                               as_tensors(batch, "cpu"))
    assert torch.isfinite(loss)
    rel_close(loss, want_loss)
    grads_close(got, want, "blocked dispatch")


def test_loss_decreases():
    """The counterpart of the reference's ``test_loss_decreases``: 40
    steps of the reduced qwen at its published bf16 activations."""
    cfg = get_reduced("qwen1.5-0.5b")
    m = Model(cfg)
    params = m.init(0, device="cpu")
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    step = make_train_step(m, opt)
    state = init_opt_state(params)
    dc = DataConfig(seed=1, vocab=64)
    losses = []
    for i in range(40):
        batch = as_tensors(make_batch(dc, cfg, CELL, i), "cpu")
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.75, (losses[0], losses[-1])
