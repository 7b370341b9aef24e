"""The port's plain TP segments (ops/tp_megakernel.py: attn_segment_ref,
mlp_segment_ref, lm_segment_ref, which the wrappers run for CPU tensors)
against the JAX package's segment kernels (`build_attn_segment`,
`build_mlp_segment`, `build_lm_segment`) in interpret mode, per rank of a
model axis of 2: the JAX segment on that rank's slice of its packed tree
and its pool shard, the port's on its own pack of the same numpy weights
and the same pool bytes.

Tolerances: the o / down partials and the local logits within 1e-2 of
their largest over the active rows (both sides round x_norm, q, attn_out
and the SwiGLU activation to bf16 at the same points and apply the weight
qparams rounded to bf16; they differ in the order of the f32 sums); the
written pool rows: integer payload at most one level apart, float payload
within 2e-2 of its largest, a head's scale within 2e-2 of itself and its
zero within 2e-2 of the head's range (scale x levels: zero = min + 128
scale cancels under INT8, so it is held on the range it offsets); every
other pool element equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from tests.test_megakernel import _prep_cache
from tests.test_torch_megakernel import (LOGITS_RTOL, QPARAM_RTOL, _port_rt,
                                         _unpack_kv)
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

N = 2
LENS = np.asarray([17, 16, 5, 0], np.int32)
ACTIVE = np.asarray([1, 1, 1, 0], np.int32)


def tp_case(quant, mode, KH, n=N, alibi=False):
    """The JAX and the port's plan and packs of one tiny TP model (`alibi`:
    its ALiBi twin), and a pool prefilled through the JAX per-op
    prefill."""
    cfg, rt, params = tp_fixture(quant, KH=KH, alibi=alibi)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    assert jtpk.supports_tp(cfg, rt, params, n)
    jplan, jpacked = jtpk.make_tp_plan(cfg, rt, params, n,
                                       target_chunk_bytes=48 * 1024)
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    assert ttpk.supports_tp(tcfg, trt, tparams, n)
    plan, packs = ttpk.make_tp_plan(
        tcfg, trt, ttpk.split_params_tp(tparams, tcfg, n))
    B, maxP = rt.max_batch, rt.max_pages_per_seq
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    jcache = _prep_cache(cfg, rt, params, JMode(mode), LENS, pt)
    pools = [np.asarray(p) for p in (jcache.k, jcache.v, jcache.k_qparams,
                                     jcache.v_qparams) if p is not None]
    return dict(cfg=cfg, rt=rt, params=params, jplan=jplan, jpacked=jpacked,
                tcfg=tcfg, plan=plan, packs=packs, pt=pt, pools=pools,
                mode=mode)


def pool_shard(pools, r, n, KH, mode):
    """Rank r's share of the full pool (the JAX package's cache sharding:
    payload lanes head-major, qparam rows 2h, 2h + 1)."""
    KHl = KH // n
    Ds = 64 if mode == "uint4" else 128
    out = [p[..., r * KHl * Ds:(r + 1) * KHl * Ds] for p in pools[:2]]
    out += [p[:, r * 2 * KHl:(r + 1) * 2 * KHl, :] for p in pools[2:]]
    return [np.ascontiguousarray(p) for p in out]


def port_cache(pools, ps):
    """numpy pool (the JAX layout) -> the port's KVCache (qparam lanes cut
    to the page size)."""
    t = [torch.from_numpy(p.copy()) for p in pools]
    if len(t) == 4:
        t[2], t[3] = (x[..., :ps].contiguous() for x in t[2:])
        return TKVCache(*t)
    return TKVCache(t[0], t[1], None, None)


def assert_close_rows(got, ref, active, what):
    for b in np.nonzero(active)[0]:
        assert np.abs(got[b] - ref[b]).max() <= \
            LOGITS_RTOL * np.abs(ref[active > 0]).max(), (what, b)


def assert_pool(after, ref, before, written, mode, ps, what):
    """`after`: the port's pool (numpy, the port's layout); `ref`: the JAX
    pool after; `before`: the pool before (JAX layout); `written`
    [pages, ps] the rows that must have changed."""
    for i in (0, 1):
        got, want = after[i], ref[i]
        for row, off in zip(*np.nonzero(written)):
            g = _unpack_kv(got[row, off], mode)
            w = _unpack_kv(want[row, off], mode)
            tol = QPARAM_RTOL * np.abs(w).max() if mode == "default" else 1
            assert np.abs(g - w).max() <= tol, (what, i, row, off)
        np.testing.assert_array_equal(got[~written], before[i][~written])
    levels = 255.0 if mode == "int8" else 15.0
    for i in range(2, len(after)):
        got, want = after[i], ref[i][..., :ps]
        for row, off in zip(*np.nonzero(written)):
            d = np.abs(got[row, :, off] - want[row, :, off])
            sc = np.abs(want[row, 0::2, off])          # each head's scale
            assert (d[0::2] <= QPARAM_RTOL * sc).all() and \
                (d[1::2] <= QPARAM_RTOL * levels * sc).all(), (what, i)
        keep = ~np.broadcast_to(written[:, None, :], got.shape)
        np.testing.assert_array_equal(got[keep],
                                      before[i][..., :ps][keep])


def written_rows(pt, layers, L, ps, shape):
    w = np.zeros(shape, bool)
    for b in np.nonzero(ACTIVE)[0]:
        g, off = pt[b, LENS[b] // ps], int(LENS[b] % ps)
        for l in layers:
            w[g * L + l, off] = True
    return w


@pytest.mark.parametrize("quant,mode,KH", [
    ("none", "default", 2), ("a16w4", "int8", 2), ("a16w8", "uint4", 4)])
def test_segments_match_jax_per_rank(quant, mode, KH):
    check_segments_against_jax(tp_case(quant, mode, KH))


def check_segments_against_jax(c):
    """Each rank's attn segment, and rank 1's mlp and lm segments (plain)
    against the JAX segments in interpret mode at layer 1, at the module's
    tolerances."""
    cfg, jplan, plan, pt = c["cfg"], c["jplan"], c["plan"], c["pt"]
    mode, KH = c["mode"], cfg.num_kv_heads
    B, L, ps = plan.B, plan.L, plan.ps
    assert (plan.H, plan.KH) == (jplan.H, jplan.KH) and \
        plan.V == cfg.vocab_size // N
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((B, cfg.hidden_size)) * 0.5).astype(np.float32)
    lens_j = jnp.asarray(LENS)
    cos, sin = j_rope_tiles(cfg, False, lens_j)
    sb, sp, ns, tgt = jmk.build_schedule(jnp.asarray(pt), lens_j,
                                         jnp.asarray(ACTIVE > 0), ps)
    tcos, tsin = tsteps._rope_tiles(c["tcfg"], torch.from_numpy(LENS))
    step_t = (tcos, tsin, torch.from_numpy(pt), torch.from_numpy(LENS),
              torch.from_numpy(ACTIVE > 0))
    seg_a = jtpk.build_attn_segment(jplan, interpret=True)
    seg_b = jtpk.build_mlp_segment(jplan, interpret=True)
    seg_lm = jtpk.build_lm_segment(jplan, interpret=True)
    layer = 1                       # the pool rows and weights of layer 1
    for r in range(N):
        pk = jax.tree.map(lambda a: a[r], c["jpacked"])
        before = pool_shard(c["pools"], r, N, KH, mode)
        o_j, pools_j = seg_a(layer, jnp.asarray(x),
                             jnp.tile(cos, (1, jplan.H)),
                             jnp.tile(sin, (1, jplan.H)),
                             jnp.tile(cos, (1, jplan.KH)),
                             jnp.tile(sin, (1, jplan.KH)), jnp.asarray(pt),
                             lens_j, jnp.asarray(ACTIVE), tgt, sb, sp, ns,
                             pk, *[jnp.asarray(p) for p in before])
        cache = port_cache(before, ps)
        o_t = ttpk.attn_segment_ref(plan, c["packs"][r], layer,
                                    torch.from_numpy(x.copy()), *step_t,
                                    cache)
        assert_close_rows(o_t.numpy(), np.asarray(o_j), ACTIVE,
                          f"attn rank {r}")
        after = [t.numpy() for t in (cache.k, cache.v, cache.k_qparams,
                                     cache.v_qparams) if t is not None]
        assert_pool(after, [np.asarray(p) for p in pools_j], before,
                    written_rows(pt, (layer,), L, ps, before[0].shape[:2]),
                    mode, ps, f"attn rank {r}")

        if r == 0:
            continue    # the MLP and lm shares of rank 1 (not at offset 0)
        d_j = seg_b(layer, jnp.asarray(x), pk)
        d_t = ttpk.mlp_segment_ref(plan, c["packs"][r], layer,
                                   torch.from_numpy(x.copy()))
        assert_close_rows(d_t.numpy(), np.asarray(d_j), ACTIVE,
                          f"mlp rank {r}")
        lg_j = np.asarray(seg_lm(jnp.asarray(x), pk))[:, :plan.V]
        lg_t = ttpk.lm_segment_ref(plan, c["packs"][r],
                                   torch.from_numpy(x.copy()))
        assert lg_t.shape == (B, cfg.vocab_size // N)
        assert_close_rows(lg_t.numpy(), lg_j, ACTIVE, f"lm rank {r}")


def test_add_is_the_residual_update():
    """A segment given `add` computes on x + add and leaves that in x: the
    JAX package's `x + psum(partial)` between its segments."""
    c = tp_case("a16w4", "int8", 2)
    plan, pk = c["plan"], c["packs"][0]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(plan.B, plan.hid, generator=g)
    add = torch.randn(plan.B, plan.hid, generator=g)
    want = ttpk.mlp_segment_ref(plan, pk, 0, x + add)
    x1 = x.clone()
    got = ttpk.tp_mlp_segment(plan, pk, 0, x1, add=add)
    torch.testing.assert_close(x1, x + add, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    lg = ttpk.tp_lm_segment(plan, pk, x.clone(), add=add)
    torch.testing.assert_close(lg, ttpk.lm_segment_ref(plan, pk, x + add),
                               rtol=0, atol=0)
