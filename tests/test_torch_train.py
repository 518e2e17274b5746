"""The training substrate's host-side pieces held against the JAX package
on the CPU: the synthetic data pipeline (bit-identical batches), AdamW
and its schedule (params and moments within ``OPT_TOL`` after 3 steps;
``lr``, ``grad_norm`` and the schedule within ``SCHED_TOL`` relative),
gradient compression (exact), and the elastic policies (the same
decisions on the same inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models.config import ShapeCell as RefShapeCell
from repro.train import compression as r_comp
from repro.train import data as r_data
from repro.train import elastic as r_elastic
from repro.train import optimizer as r_opt

from repro_torch.configs import get_reduced
from repro_torch.models.config import ShapeCell
from repro_torch.train import compression, data, elastic, optimizer
from repro_torch.train.tree import flatten_with_paths, leaves

#: params and moments after 3 AdamW steps, absolute
OPT_TOL = 1e-5
#: lr, grad_norm and the schedule, relative (float32 rounding of a few
#: operations in each package's order)
SCHED_TOL = 1e-6
CELL = (32, 4)


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


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "whisper-small",
                                  "llava-next-34b"])
@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (5, 11, 2, 4), (3, 7, 1, 2)])
def test_batches_are_bit_identical(name, seed, step, shard, n_shards):
    ref_cfg, cfg = ref_get_reduced(name), get_reduced(name)
    seq = CELL[0] + (cfg.n_patches if cfg.vlm else 0)
    want = r_data.make_batch(r_data.DataConfig(seed=seed, vocab=300), ref_cfg,
                             RefShapeCell("t", seq, CELL[1], "train"), step,
                             shard, n_shards)
    got = data.make_batch(data.DataConfig(seed=seed, vocab=300), cfg,
                          ShapeCell("t", seq, CELL[1], "train"), step,
                          shard, n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    moved = data.as_tensors(got, "cpu")
    for k in want:
        np.testing.assert_array_equal(moved[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def tree_np(seed, scale):
    """A tree of 1-D, 2-D and 3-D float32 leaves."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": leaf(8, 16), "b": leaf(16), "blk": {"k": leaf(2, 4, 4),
                                                     "norm": leaf(4)}}


def to_t(tree):
    if isinstance(tree, dict):
        return {k: to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_j(tree):
    if isinstance(tree, dict):
        return {k: to_j(v) for k, v in tree.items()}
    return jnp.asarray(np.asarray(tree))


def same_tree(got, want, tol):
    g = dict(flatten_with_paths(got))
    w = dict(flatten_with_paths(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float32),
                                   np.asarray(w[k], np.float32),
                                   rtol=0, atol=tol, err_msg=k)


def rel_close(got, want, tol=SCHED_TOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
def test_schedule(step):
    cfg = optimizer.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    rcfg = r_opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    got = optimizer._schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = r_opt._schedule(rcfg, jnp.int32(step))
    assert got.dtype == torch.float32 and got.shape == ()
    rel_close(got, want)


@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clip_active",
                                                  "clip_idle"])
@pytest.mark.parametrize("start", [0, 9, 99, 120],
                         ids=["step0", "warmup", "total", "beyond"])
def test_adamw_three_steps(clip, start):
    kw = dict(lr=1e-2, warmup_steps=10, total_steps=100, clip_norm=clip)
    cfg, rcfg = optimizer.OptConfig(**kw), r_opt.OptConfig(**kw)
    p_np = tree_np(0, 1.0)
    params, rparams = to_t(p_np), to_j(p_np)
    state = optimizer.init_opt_state(params)
    rstate = r_opt.init_opt_state(rparams)
    state = state._replace(step=torch.tensor(start, dtype=torch.int32))
    rstate = rstate._replace(step=jnp.int32(start))
    for i in range(3):
        g_np = tree_np(10 + i, 2.0)
        rparams, rstate, rm = jax.jit(
            lambda g, s, p: r_opt.adamw_update(rcfg, g, s, p))(
                to_j(g_np), rstate, rparams)
        params, state, m = optimizer.adamw_update(cfg, to_t(g_np), state,
                                                  params)
        assert m["lr"].shape == () and m["grad_norm"].shape == ()
        rel_close(m["grad_norm"], rm["grad_norm"])
        rel_close(m["lr"], rm["lr"])
    if clip < 1.0:
        assert float(rm["grad_norm"]) > clip       # the clip did act
    assert int(state.step) == int(rstate.step) == start + 3
    assert state.step.dtype == torch.int32
    same_tree(params, rparams, OPT_TOL)
    same_tree(state.mu, rstate.mu, OPT_TOL)
    same_tree(state.nu, rstate.nu, OPT_TOL)


def test_decay_only_on_matrices():
    """A zero gradient moves only leaves with ndim >= 2 (decoupled weight
    decay), as in the reference."""
    cfg = optimizer.OptConfig(lr=1e-2, warmup_steps=1)
    p_np = tree_np(0, 1.0)
    params = to_t(p_np)
    zero = to_t(tree_np(1, 0.0))
    params, _, _ = optimizer.adamw_update(
        cfg, zero, optimizer.init_opt_state(params), params)
    for (path, got), want in zip(flatten_with_paths(params),
                                 leaves(to_t(p_np))):
        moved = not torch.equal(got, want)
        assert moved == (want.ndim >= 2), path


def test_global_norm():
    t = tree_np(3, 1.5)
    rel_close(optimizer.global_norm(to_t(t)), r_opt.global_norm(to_j(t)))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compression_is_exact_over_three_steps():
    err, rerr = None, None
    for i in range(3):
        g = tree_np(20 + i, 1.0)
        g["b"][:4] = 1.0 + 2.0 ** -12          # below bf16's step at 1.0
        got, err = compression.compress_decompress(to_t(g), err)
        want, rerr = r_comp.compress_decompress(to_j(g), rerr)
        for a, b in ((got, want), (err, rerr)):
            ga = dict(flatten_with_paths(a))
            wa = dict(flatten_with_paths(jax.tree.map(np.asarray, b)))
            assert sorted(ga) == sorted(wa)
            for k in wa:
                assert ga[k].dtype == torch.float32
                np.testing.assert_array_equal(ga[k].numpy(), wa[k], k)


def test_compression_error_feedback_recovers_the_bias():
    g = {"w": torch.full((128,), 1.0 + 2 ** -12)}
    err = compression.init_error_state(g)
    total = torch.zeros(128)
    for _ in range(64):
        cg, err = compression.compress_decompress(g, err)
        total += cg["w"]
    np.testing.assert_allclose((total / 64).numpy(), g["w"].numpy(),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# elastic: the reference's cases, run through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(params=["port", "reference"])
def el(request):
    return elastic if request.param == "port" else r_elastic


def test_failure_detection(el):
    cv = el.ClusterView(timeout_s=10)
    cv.heartbeat("h0", now=0.0)
    cv.heartbeat("h1", now=0.0)
    cv.heartbeat("h0", now=8.0)
    assert cv.alive(now=12.0) == ["h0"]
    assert cv.dead(now=12.0) == ["h1"]


def test_remesh_plan_shrinks(el):
    pol = el.ElasticPolicy(devices_per_host=4, model_axis=16,
                           global_batch=256)
    full = pol.plan(n_hosts=128)
    assert full.shape == (32, 16)
    degraded = pol.plan(n_hosts=100)
    assert degraded.shape[1] == 16
    assert degraded.n_devices <= 400
    assert 256 % degraded.shape[0] == 0


def test_remesh_tiny_cluster(el):
    pol = el.ElasticPolicy(devices_per_host=4, model_axis=16,
                           global_batch=256)
    assert pol.plan(n_hosts=1).n_devices <= 4


def test_straggler_ejection(el):
    det = el.StragglerDetector(straggler_factor=1.5, patience=2)
    timings = {f"h{i}": 1.0 for i in range(8)}
    assert det.observe(timings) == []
    slow = dict(timings, h3=5.0)
    assert det.observe(slow) == []
    assert det.observe(slow) == ["h3"]


def test_straggler_recovers(el):
    det = el.StragglerDetector(straggler_factor=1.5, patience=2, ewma=1.0)
    slow = {f"h{i}": 1.0 for i in range(8)}
    slow["h3"] = 5.0
    det.observe(slow)
    assert det.observe({f"h{i}": 1.0 for i in range(8)}) == []


@pytest.mark.parametrize("n_hosts", [0, 1, 3, 4, 5, 37, 64, 100, 128])
def test_plans_equal_the_reference(n_hosts):
    kw = dict(devices_per_host=4, model_axis=16, global_batch=256)
    if n_hosts == 0:
        for mod in (elastic, r_elastic):
            with pytest.raises(RuntimeError):
                mod.ElasticPolicy(**kw).plan(0)
        return
    got = elastic.ElasticPolicy(**kw).plan(n_hosts)
    want = r_elastic.ElasticPolicy(**kw).plan(n_hosts)
    assert (got.shape, got.axis_names, got.n_hosts, got.per_host_batch,
            got.n_devices) == (want.shape, want.axis_names, want.n_hosts,
                               want.per_host_batch, want.n_devices)


def test_straggler_decisions_equal_the_reference():
    rng = np.random.default_rng(4)
    got, want = elastic.StragglerDetector(), r_elastic.StragglerDetector()
    for step in range(30):
        t = {f"h{i}": float(rng.uniform(0.9, 1.1)) for i in range(6)}
        if 10 <= step < 20:
            t["h2"] = 3.0
        assert got.observe(t) == want.observe(t)
        if step == 25:
            got.forget("h2")
            want.forget("h2")
