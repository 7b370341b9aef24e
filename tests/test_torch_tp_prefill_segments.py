"""The port's plain TP prefill segments (ops/tp_megakernel.py:
prefill_attn_segment_ref, prefill_mlp_segment_ref, prefill_lm_segment_ref,
which the wrappers run for CPU tensors) against the JAX package's prefill
segment kernels (`build_prefill_attn_segment`, `build_prefill_mlp_segment`,
`build_prefill_lm_segment`) in interpret mode, per rank of a model axis of
2, on the tiny TP shape (tests/test_torch_tp_split.py `tp_fixture`: 2
layers, head_dim 128, bucket 128): the JAX segment on that rank's slice of
its TP prefill pack and its pool shard, the port's on its own pack of the
same numpy weights (each rank's TP decode pack) and the same pool bytes,
at a served prompt length (n = 45) and a full bucket (n = 128).

Tolerances (tests/test_torch_tp_segments.py's): the o / down partials of
the prompt rows and the local logits within 1e-2 of their largest (both
sides round x_norm, q, p, attn_out and the SwiGLU activation to bf16 at the
same points and apply the weight qparams rounded to bf16; they differ in
the order of the f32 sums); the written pool rows (< n of the owned pages)
within one level for integer payload, 2e-2 of their largest for float
payload, a head's scale within 2e-2 of itself and its zero within 2e-2 of
its range; every other pool element equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create_cache
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_torch_megakernel import LOGITS_RTOL, _port_rt
from tests.test_torch_tp_segments import assert_pool, pool_shard, port_cache
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

N = 2
BUCKET = 128


def prefill_case(quant, mode, KH, n=N, alibi=False):
    """The JAX and the port's local prefill plan and per-rank packs of one
    tiny TP model (`alibi`: its ALiBi twin) at bucket 128, and a random
    full pool (JAX layout)."""
    cfg, rt, params = tp_fixture(quant, KH=KH, alibi=alibi)
    ps = rt.cache.page_size
    rt = dataclasses.replace(
        rt, max_length=BUCKET + ps,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    assert jtpk.supports_prefill_tp(cfg, rt, params, BUCKET, n)
    jplan, jpacked = jtpk.make_tp_prefill_plan(cfg, rt, params, BUCKET, n,
                                               target_chunk_bytes=48 * 1024)
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    assert ttpk.supports_prefill_tp(tcfg, trt, tparams, BUCKET, n)
    parts = ttpk.split_params_tp(tparams, tcfg, n)
    tp_plan, packs = ttpk.make_tp_plan(tcfg, trt, parts)
    plan = ttpk.make_tp_prefill_plans(tcfg, trt, parts, [BUCKET],
                                      tp_plan)[BUCKET]
    assert plan.qkv is tp_plan.qkv and plan.lm is tp_plan.lm
    L = cfg.num_layers
    jcache = j_create_cache(cfg, rt.cache, rt.cache.num_pages * L,
                            model_dtype=jnp.float32)
    rng = np.random.RandomState(11)
    pools = []
    for i, p in enumerate((jcache.k, jcache.v, jcache.k_qparams,
                           jcache.v_qparams)):
        if p is None:
            continue
        a = np.asarray(p)
        if i >= 2:
            a = rng.uniform(0.01, 0.02, a.shape).astype(a.dtype)
        elif a.dtype == np.float32:
            a = rng.standard_normal(a.shape).astype(np.float32)
        else:
            a = rng.randint(0, 256, a.shape).astype(np.uint8).view(a.dtype)
        pools.append(a)
    return dict(cfg=cfg, rt=rt, jplan=jplan, jpacked=jpacked, tcfg=tcfg,
                plan=plan, packs=packs, pools=pools, mode=mode, ps=ps)


def prompt_inputs(c, n_tokens, seed=5):
    """The residual x [S, hid], the RoPE tiles of positions 0..S-1, a
    request's shuffled logical pages as physical base rows, for both
    sides."""
    cfg, plan = c["cfg"], c["plan"]
    L = cfg.num_layers
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((BUCKET, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    pages = 1 + rng.permutation(c["rt"].cache.num_pages - 1)[:plan.maxPb]
    page_row = (pages * L).astype(np.int32)
    cos, sin = j_rope_tiles(cfg, False, jnp.arange(BUCKET, dtype=jnp.int32))
    tcos, tsin = tsteps._rope_tiles(c["tcfg"], torch.arange(BUCKET))
    return dict(x=x, page_row=page_row, cos=cos, sin=sin, tcos=tcos,
                tsin=tsin, n=torch.tensor([n_tokens], dtype=torch.int32))


def written_prompt_rows(page_row, n_tokens, layers, ps, shape):
    """[pages, ps] rows a prefill writes: tokens < n at `layers`."""
    w = np.zeros(shape, bool)
    for t in range(n_tokens):
        for l in layers:
            w[page_row[t // ps] + l, t % ps] = True
    return w


def assert_close(got, ref, what):
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max()
    assert err <= LOGITS_RTOL * np.abs(ref).max(), (what, err)


@pytest.mark.parametrize("quant,mode,KH", [
    ("a16w4", "int8", 2), ("a16w8", "uint4", 4), ("none", "default", 2)])
@pytest.mark.parametrize("n_tokens", [45, BUCKET])
def test_prefill_segments_match_jax_per_rank(quant, mode, KH, n_tokens):
    check_prefill_segments_against_jax(prefill_case(quant, mode, KH),
                                       n_tokens)


def check_prefill_segments_against_jax(c, n_tokens):
    """Each rank's prefill attn, mlp and lm segments (plain) against the JAX
    segments in interpret mode at layer 1, at the module's tolerances."""
    cfg, jplan, plan, ps = c["cfg"], c["jplan"], c["plan"], c["ps"]
    mode, KH = c["mode"], cfg.num_kv_heads
    assert (plan.S, plan.H, plan.KH, plan.V) == \
        (jplan.S, jplan.H, jplan.KH, cfg.vocab_size // N)
    inp = prompt_inputs(c, n_tokens)
    x, page_row = inp["x"], inp["page_row"]
    seg_a = jtpk.build_prefill_attn_segment(jplan, interpret=True)
    seg_m = jtpk.build_prefill_mlp_segment(jplan, interpret=True)
    seg_lm = jtpk.build_prefill_lm_segment(jplan, interpret=True)
    n_j = jnp.int32(n_tokens)
    layer = 1                       # the pool rows and weights of layer 1
    for r in range(N):
        pk = jax.tree.map(lambda a: a[r], c["jpacked"])
        before = pool_shard(c["pools"], r, N, KH, mode)
        o_j, pools_j = seg_a(layer, jnp.asarray(x), inp["cos"], inp["sin"],
                             jnp.asarray(page_row), n_j, pk,
                             *[jnp.asarray(p) for p in before])
        cache = port_cache(before, ps)
        o_t = ttpk.prefill_attn_segment_ref(
            plan, c["packs"][r], layer, torch.from_numpy(x.copy()),
            inp["tcos"], inp["tsin"], torch.from_numpy(page_row), inp["n"],
            cache)
        assert o_t.shape == (BUCKET, cfg.hidden_size)
        assert_close(o_t.numpy()[:n_tokens], np.asarray(o_j)[:n_tokens],
                     f"attn rank {r}")
        after = [t.numpy() for t in (cache.k, cache.v, cache.k_qparams,
                                     cache.v_qparams) if t is not None]
        assert_pool(after, [np.asarray(p) for p in pools_j], before,
                    written_prompt_rows(page_row, n_tokens, (layer,), ps,
                                        before[0].shape[:2]),
                    mode, ps, f"attn rank {r}")

        d_j = np.asarray(seg_m(layer, jnp.asarray(x), pk))
        d_t = ttpk.prefill_mlp_segment_ref(plan, c["packs"][r], layer,
                                           torch.from_numpy(x.copy()),
                                           inp["n"]).numpy()
        assert_close(d_t, d_j, f"mlp rank {r}")
        lg_j = np.asarray(seg_lm(jnp.asarray(x), n_j, pk))[0, :plan.V]
        lg_t = ttpk.prefill_lm_segment_ref(plan, c["packs"][r],
                                           torch.from_numpy(x.copy()),
                                           inp["n"]).numpy()
        assert lg_t.shape == (cfg.vocab_size // N,)
        assert_close(lg_t, lg_j, f"lm rank {r}")
        assert int(np.argmax(lg_t)) == int(np.argmax(lg_j)), r


def test_prefill_add_is_the_residual_update():
    """A segment given `add` computes on x + add and leaves that in x (the
    lm segment in the one row it reads, n - 1): the JAX package's
    `x + psum(partial)` between its segments."""
    c = prefill_case("a16w4", "int8", 2)
    plan, pk = c["plan"], c["packs"][1]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(BUCKET, plan.hid, generator=g)
    add = torch.randn(BUCKET, plan.hid, generator=g)
    n = torch.tensor([45], dtype=torch.int32)
    want = ttpk.prefill_mlp_segment_ref(plan, pk, 0, x + add, n)
    x1 = x.clone()
    got = ttpk.tp_prefill_mlp_segment(plan, pk, 0, x1, n, add=add)
    torch.testing.assert_close(x1, x + add, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    x2 = x.clone()
    lg = ttpk.tp_prefill_lm_segment(plan, pk, x2, n, add=add)
    torch.testing.assert_close(lg, ttpk.prefill_lm_segment_ref(
        plan, pk, x + add, n), rtol=0, atol=0)
    torch.testing.assert_close(x2[44], x[44] + add[44], rtol=0, atol=0)
    torch.testing.assert_close(x2[:44], x[:44], rtol=0, atol=0)
