"""The LM substrate's modules, one by one, held against the JAX package at
reduced size on the CPU: the same numpy inputs (from a seed) and the
same parameters (the reference's init, carried across as numpy arrays)
go through each JAX function and its counterpart in the port, in float32,
within rtol/atol ``TOL`` unless a case states another bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm

from repro_torch.configs import get_reduced
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.transformer import local_cache_len

TOL = 1e-4


def to_t(tree):
    if isinstance(tree, dict):
        return {k: to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_j(tree):
    if isinstance(tree, dict):
        return {k: to_j(v) for k, v in tree.items()}
    return jnp.asarray(np.asarray(tree))


def same(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def cfgs(name, **kw):
    return (ref_get_reduced(name, dtype="float32", **kw),
            get_reduced(name, dtype="float32", **kw))


def normal(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def ref_tree(init, *args):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), *args))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms():
    x = normal((2, 5, 64), 1, 2.0)
    p = {"scale": normal((64,), 2) + 1.0, "bias": normal((64,), 3)}
    same(layers.rmsnorm(to_t(p), torch.from_numpy(x), 1e-6),
         r_layers.rmsnorm(to_j(p), jnp.asarray(x), 1e-6))
    same(layers.layernorm(to_t(p), torch.from_numpy(x), 1e-5),
         r_layers.layernorm(to_j(p), jnp.asarray(x), 1e-5))


def test_rope_is_split_half():
    pos = np.array([0, 1, 7, 40, 255], np.int32)
    sin, cos = layers.rope_angles(torch.from_numpy(pos), 16, 1e6)
    rsin, rcos = r_layers.rope_angles(jnp.asarray(pos), 16, 1e6)
    same(sin, rsin, 1e-5)
    same(cos, rcos, 1e-5)
    x = normal((2, 5, 3, 16), 4)
    got = layers.apply_rope(torch.from_numpy(x), sin, cos)
    same(got, r_layers.apply_rope(jnp.asarray(x), rsin, rcos), 1e-5)
    # split-half: dimension i pairs with i + hd/2
    want = x[..., 0] * cos.numpy()[None, :, None, 0] - \
        x[..., 8] * sin.numpy()[None, :, None, 0]
    same(got[..., 0], want, 1e-6)


def test_swiglu_and_gelu_mlps():
    x = normal((2, 5, 64), 5)
    p = ref_tree(r_layers.init_mlp, 64, 128, jnp.float32)
    same(layers.mlp(to_t(p), torch.from_numpy(x)),
         r_layers.mlp(to_j(p), jnp.asarray(x)))
    g = ref_tree(r_layers.init_gelu_mlp, 64, 128, jnp.float32)
    g["b_in"] = normal((128,), 6)
    got = layers.gelu_mlp(to_t(g), torch.from_numpy(x))
    same(got, r_layers.gelu_mlp(to_j(g), jnp.asarray(x)))
    # the tanh approximation, not the exact erf form
    h = torch.from_numpy(x) @ to_t(g)["w_in"] + to_t(g)["b_in"]
    exact = torch.nn.functional.gelu(h) @ to_t(g)["w_out"]
    assert (got - exact).abs().max() > 1e-5


def test_embed_and_unembed():
    table = {"table": normal((32, 16), 7)}
    tok = np.array([[0, 5, 31], [2, 2, 9]], np.int32)
    same(layers.embed(to_t(table), torch.from_numpy(tok), torch.float32),
         r_layers.embed(to_j(table), jnp.asarray(tok), jnp.float32))
    x = normal((2, 3, 16), 8)
    same(layers.unembed(to_t(table), torch.from_numpy(x)),
         r_layers.unembed(to_j(table), jnp.asarray(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_ARCHS = ["qwen1.5-0.5b", "gemma3-12b"]     # MHA with bias; GQA


@pytest.mark.parametrize("name", ATTN_ARCHS)
@pytest.mark.parametrize("kind", ["global", "local", "bidir"])
def test_self_attention(name, kind):
    rcfg, cfg = cfgs(name)
    p = ref_tree(r_attn.init_attention, rcfg, jnp.float32)
    if "bq" in p:
        for k in ("bq", "bk", "bv"):
            p[k] = normal(p[k].shape, 9)
    x = normal((2, 12, cfg.d_model), 10)
    if kind == "bidir":
        got = attn.attention_bidir(to_t(p), torch.from_numpy(x), cfg)
        want = r_attn.attention_bidir(to_j(p), jnp.asarray(x), rcfg)
    else:
        local = kind == "local"
        got = attn.attention(to_t(p), torch.from_numpy(x), cfg, local=local)
        want = jax.jit(r_attn.attention, static_argnums=(2, 3))(
            to_j(p), jnp.asarray(x), rcfg, local)
    same(got, want)


def test_masks_equal_the_reference():
    for sq, skv, off, win in [(8, 8, 0, None), (8, 8, 0, 4), (1, 16, 7, None),
                              (4, 12, 8, 3)]:
        assert np.array_equal(attn._mask(sq, skv, off, win).numpy(),
                              np.asarray(r_attn._mask(sq, skv, off, win)))


def test_cross_attention_and_encoder_kv():
    rcfg, cfg = cfgs("whisper-small")
    p = ref_tree(r_attn.init_cross_attention, rcfg, jnp.float32)
    for k in ("bq", "bk", "bv"):
        p[k] = normal(p[k].shape, 11)
    enc = normal((2, cfg.n_frames, cfg.d_model), 12)
    x = normal((2, 5, cfg.d_model), 13)
    kv = attn.encoder_kv(to_t(p), torch.from_numpy(enc))
    rkv = r_attn.encoder_kv(to_j(p), jnp.asarray(enc))
    same(kv[0], rkv[0])
    same(kv[1], rkv[1])
    same(attn.cross_attention(to_t(p), torch.from_numpy(x), kv, cfg),
         r_attn.cross_attention(to_j(p), jnp.asarray(x), rkv, rcfg))


@pytest.mark.parametrize("kind,s_cache,steps", [
    ("local", None, 21),     # the ring of a sliding-window layer wraps twice
    ("global", 16, 12),
    ("global", 4, 7),        # past the cache's end: the write is clamped
])
def test_attention_decode(kind, s_cache, steps):
    rcfg, cfg = cfgs("gemma3-12b")
    p = ref_tree(r_attn.init_attention, rcfg, jnp.float32)
    if s_cache is None:
        s_cache = local_cache_len(cfg, 64)
        assert s_cache == 8
    shape = (2, s_cache, cfg.n_kv, cfg.hd)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    rkc, rvc = jnp.zeros(shape), jnp.zeros(shape)
    xs = normal((steps, 2, 1, cfg.d_model), 14)
    ref_step = jax.jit(r_attn.attention_decode, static_argnums=5)
    for pos in range(steps):
        wp = pos % s_cache if kind == "local" else pos
        o, kc, vc = attn.attention_decode(to_t(p), torch.from_numpy(xs[pos]),
                                          kc, vc, pos, cfg, write_pos=wp)
        ro, rkc, rvc = ref_step(to_j(p), jnp.asarray(xs[pos]), rkc, rvc,
                                jnp.int32(pos), rcfg, jnp.int32(wp))
        same(o, ro)
        same(kc, rkc)
        same(vc, rvc)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("chunk,seq", [(8, 32), (16, 64), (8, 64)])
def test_sdpa_chunked(local, chunk, seq):
    """Flash-chunked attention against the reference's and against the
    port's dense path (the reference's own bound against dense)."""
    rcfg, cfg = cfgs("gemma3-12b", sliding_window=8)
    p = ref_tree(r_attn.init_attention, rcfg, jnp.float32)
    x = normal((2, seq, cfg.d_model), 15, 0.3)
    fcfg = dataclasses.replace(cfg, flash_chunk=chunk)
    rfcfg = dataclasses.replace(rcfg, flash_chunk=chunk)
    flash = attn.attention(to_t(p), torch.from_numpy(x), fcfg, local=local)
    same(flash, jax.jit(r_attn.attention, static_argnums=(2, 3))(
        to_j(p), jnp.asarray(x), rfcfg, local))
    dense = attn.attention(to_t(p), torch.from_numpy(x), cfg, local=local)
    np.testing.assert_allclose(dense.numpy(), flash.numpy(), rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_case(name, **moe_kw):
    rcfg, cfg = cfgs(name)
    if moe_kw:
        rcfg = dataclasses.replace(
            rcfg, moe=dataclasses.replace(rcfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return rcfg, cfg, ref_tree(r_moe.init_moe, rcfg, jnp.float32)


@pytest.mark.parametrize("name,moe_kw", [
    ("granite-moe-1b-a400m", {}),
    ("deepseek-moe-16b", {}),                        # a shared expert
    ("granite-moe-1b-a400m", {"dispatch_blocks": 4}),
    ("granite-moe-1b-a400m", {"capacity_factor": 0.25}),   # tokens drop
    ("granite-moe-1b-a400m", {"capacity_factor": 0.25, "dispatch_blocks": 2}),
])
def test_moe_layer(name, moe_kw):
    rcfg, cfg, p = moe_case(name, **moe_kw)
    x = normal((8, 16, cfg.d_model), 16, 0.3)
    got = moe.moe_layer(to_t(p), torch.from_numpy(x), cfg)
    same(got, jax.jit(r_moe.moe_layer, static_argnums=2)(to_j(p), jnp.asarray(x), rcfg))
    if moe_kw.get("capacity_factor", 1) < 1:
        # the capacity is below an expert's mean load: tokens drop
        t = x.shape[0] * x.shape[1] // max(1, moe_kw.get("dispatch_blocks", 1))
        m = cfg.moe
        assert moe.moe_capacity(cfg, t) < t * m.top_k / m.n_experts


def test_moe_blocked_equals_global_when_capacity_ample():
    _, cfg, p = moe_case("granite-moe-1b-a400m", capacity_factor=8.0)
    x = torch.from_numpy(normal((8, 16, cfg.d_model), 17, 0.3))
    blocked = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch_blocks=4))
    same(moe.moe_layer(to_t(p), x, blocked), moe.moe_layer(to_t(p), x, cfg),
         1e-5)


def test_moe_capacity_and_aux_loss():
    rcfg, cfg, p = moe_case("granite-moe-1b-a400m")
    for t in (1, 7, 64, 1000):
        assert moe.moe_capacity(cfg, t) == r_moe.moe_capacity(rcfg, t)
        assert moe.moe_capacity(cfg, t) % 8 == 0
    x = normal((4, 16, cfg.d_model), 18)
    same(moe.aux_load_balance_loss(to_t(p), torch.from_numpy(x), cfg),
         r_moe.aux_load_balance_loss(to_j(p), jnp.asarray(x), rcfg))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def ssm_case(chunk=8):
    rcfg, cfg = cfgs("mamba2-370m", ssm_chunk=chunk)
    p = ref_tree(r_ssm.init_ssm, rcfg, jnp.float32)
    p["dt_bias"] = normal(p["dt_bias"].shape, 19)
    p["conv_bias_x"] = normal(p["conv_bias_x"].shape, 20)
    return rcfg, cfg, p


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_forward(chunk):
    rcfg, cfg, p = ssm_case(chunk)
    x = normal((2, 16, cfg.d_model), 21, 0.3)
    got = ssm.ssd_forward(to_t(p), torch.from_numpy(x), cfg)
    same(got, jax.jit(r_ssm.ssd_forward, static_argnums=2)(
        to_j(p), jnp.asarray(x), rcfg))
    if chunk != 4:      # chunking is a pure performance knob
        base = dataclasses.replace(cfg, ssm_chunk=4)
        same(got, ssm.ssd_forward(to_t(p), torch.from_numpy(x), base))


def test_ssd_forward_needs_whole_chunks():
    _, cfg, p = ssm_case(8)
    with pytest.raises(AssertionError):
        ssm.ssd_forward(to_t(p), torch.zeros((1, 12, cfg.d_model)), cfg)


def test_ssd_decode_steps():
    rcfg, cfg, p = ssm_case()
    st = ssm.ssm_decode_state(cfg, 2, "cpu")
    rst = r_ssm.ssm_decode_state(rcfg, 2)
    xs = normal((10, 2, 1, cfg.d_model), 22, 0.3)
    ref_step = jax.jit(r_ssm.ssd_decode, static_argnums=3)
    for t in range(10):
        y, st = ssm.ssd_decode(to_t(p), torch.from_numpy(xs[t]), st, cfg)
        ry, rst = ref_step(to_j(p), jnp.asarray(xs[t]), rst, rcfg)
        same(y, ry)
        for k in st:
            same(st[k], rst[k])
    # the steps replay the forward over the same 8 tokens
    full = ssm.ssd_forward(to_t(p), torch.from_numpy(
        xs[:8, :, 0].transpose(1, 0, 2).copy()), cfg)
    st = ssm.ssm_decode_state(cfg, 2, "cpu")
    for t in range(8):
        y, st = ssm.ssd_decode(to_t(p), torch.from_numpy(xs[t]), st, cfg)
        same(y[:, 0], full[:, t], 1e-4)
