"""MoE on a model axis: the port's plain MoE segment, its whole TP decode
and its per-op TP forwards against the JAX package, on the CPU, on
tests/test_megakernel.py's tiny Qwen2-MoE (2 layers, hid 256, 4 experts
top-2 of width 256, a shared expert of 256 with its gate; B = 4, two KV
heads, four query heads) over a model axis of 2: each rank holds 2 experts
and 128 columns of the shared expert, and routes over all 4.

Tolerances: a segment's moe partial within 1e-2 of its largest over the
active rows (LOGITS_RTOL, as the mlp segment in
tests/test_torch_tp_segments.py: both sides round x_norm and the SwiGLU
activation to bf16 at the same points and differ in the order of the f32
sums); the whole TP decode against the JAX `build_tp_decode_fn` as
tests/test_torch_tp_decode.py (0.05 of each row's largest logit for f32
weights, 0.08 quantized, the same argmax, the pool shards by the segment
rules); the per-op TP forwards against the JAX single-device forwards
within 2e-3 of the largest logit with f32 weights (the ranks' partials are
summed in another order) and 1e-2 with a16w4 experts on the grouped route
(its bf16 operands: tests/test_torch_moe.py's quantized forward bound),
with the same argmax, and within 1e-4 of the port's single-device per-op
forward on the ragged route (1e-2 on the grouped route, which sums a
token's experts in bf16: a rank sums only its own)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.models import transformer as jtf
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttf
from dashinfer_tpu_torch.ops import moe as tmoe
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.parallel import make_mesh, shard_params
from tests.test_megakernel import _prep_cache, _tiny_moe
from tests.test_torch_megakernel import LOGITS_RTOL, _port_rt
from tests.test_torch_tp_segments import (ACTIVE, LENS, N, assert_pool,
                                          pool_shard, port_cache,
                                          written_rows)
from tests.test_torch_transformer import port_config

_cache = {}
CPU2 = [torch.device("cpu")] * N


def moe_fixture(quant: str, shared: bool = True, E: int = 4):
    """(cfg, rt, numpy params) of the tiny MoE model, quantized with group
    128 ("a16w4", "a16w8") or f32 ("none")."""
    key = (quant, shared, E)
    if key not in _cache:
        cfg, rt, params = _tiny_moe(B=4, KH=2, H=4, E=E, shared=shared,
                                    shared_gate=shared)
        if quant != "none":
            params = quantize_params(params, QuantConfig(mode=quant,
                                                         group_size=128))
        _cache[key] = (cfg, rt, jax.tree.map(np.asarray, params))
    return _cache[key]


def moe_case(quant: str, shared: bool = True):
    """The JAX and the port's TP plan and packs of the tiny MoE model at
    n = 2, INT8 KV, and a pool prefilled through the JAX per-op prefill."""
    cfg, rt, params = moe_fixture(quant, shared)
    assert jtpk.supports_tp(cfg, rt, params, N)
    jplan, jpacked = jtpk.make_tp_plan(cfg, rt, params, N,
                                       target_chunk_bytes=48 * 1024)
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    tparams = params_from_numpy(params, "cpu", torch.float32)
    parts = ttpk.split_params_tp(tparams, tcfg, N)
    assert ttpk.supports_tp(tcfg, trt, tparams, N, local=parts[0])
    plan, packs = ttpk.make_tp_plan(tcfg, trt, parts)
    B, maxP = rt.max_batch, rt.max_pages_per_seq
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    jcache = _prep_cache(cfg, rt, params, JMode.INT8, LENS, pt)
    pools = [np.asarray(p) for p in (jcache.k, jcache.v, jcache.k_qparams,
                                     jcache.v_qparams)]
    return dict(cfg=cfg, rt=rt, params=params, tparams=tparams, jplan=jplan,
                jpacked=jpacked, tcfg=tcfg, trt=trt, plan=plan, packs=packs,
                parts=parts, pt=pt, pools=pools, jcache=jcache)


def _close_rows(got, ref, what):
    for b in np.nonzero(ACTIVE)[0]:
        assert np.abs(got[b] - ref[b]).max() <= \
            LOGITS_RTOL * np.abs(ref[ACTIVE > 0]).max(), (what, b)


@pytest.mark.parametrize("quant,shared", [
    ("none", True), ("a16w8", True),
    ("a16w4", False)])          # the Qwen3-MoE shape (no shared expert)
def test_moe_segment_ref_matches_jax_per_rank(quant, shared):
    """Each rank's plain MoE segment against the JAX segment kernel (in
    interpret mode) on the rank's slice of the JAX packed tree, at both
    layers; every rank routes alike."""
    c = moe_case(quant, shared)
    plan, jplan = c["plan"], c["jplan"]
    assert (plan.E, plan.E_global, plan.EP) == (2, 4, 128)
    assert plan.has_shared == shared and plan.shared_inter == (
        128 if shared else 0)
    E_g, EP_g = plan.E_global, plan.EP
    seg = jtpk.build_moe_mlp_segment(jplan, E_g, EP_g, interpret=True)
    rng = np.random.RandomState(9)
    x = (rng.standard_normal((plan.B, plan.hid)) * 0.5).astype(np.float32)
    for layer in range(plan.L):
        routed = []
        for r in range(N):
            pk = jax.tree.map(lambda a: a[r], c["jpacked"])
            want = np.asarray(seg(layer, r, jnp.asarray(x), pk))
            routing = []
            got = ttpk.moe_segment_ref(plan, c["packs"][r], layer,
                                       torch.from_numpy(x.copy()), r,
                                       routing=routing)
            _close_rows(got.numpy(), want, f"moe layer {layer} rank {r}")
            routed.append(routing[0])
        torch.testing.assert_close(routed[0], routed[1], rtol=0, atol=0)
    # the ranks' partials sum to the single-device MoE block
    x_t = torch.from_numpy(x)
    parts = [ttpk.moe_segment_ref(plan, c["packs"][r], 1, x_t.clone(), r)
             for r in range(N)]
    from dashinfer_tpu_torch.ops import megakernel as tmk
    plan1 = tmk.make_plan(c["tcfg"], c["trt"], c["tparams"])
    pack1 = tmk.pack_params(c["tcfg"], plan1, c["tparams"])
    xn = tmk._rms(x_t, pack1["norms"][1, 1], plan1.rms_eps).to(
        torch.bfloat16)
    whole = tmk.moe_ref(plan1, xn, 1, lambda x_, sp, l_, e: tmk._stream_dot(
        x_, pack1, sp, l_, e))
    _close_rows((parts[0] + parts[1]).numpy(), whole.numpy(), "sum")


def test_moe_segment_wrapper_and_add():
    """The wrapper takes the plain version for CPU tensors; `add` is the
    residual update, left in x."""
    c = moe_case("a16w8")
    plan, pk = c["plan"], c["packs"][1]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(plan.B, plan.hid, generator=g)
    add = torch.randn(plan.B, plan.hid, generator=g)
    want = ttpk.moe_segment_ref(plan, pk, 0, x + add, 1)
    x1 = x.clone()
    got = ttpk.tp_moe_segment(plan, pk, 0, x1, 1,
                              torch.from_numpy(ACTIVE > 0), add=add)
    torch.testing.assert_close(x1, x + add, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # routed as forced: every row to experts 0 and 3 (one of each rank)
    forced = torch.tensor([[0, 3]] * plan.B)
    p0 = ttpk.moe_segment_ref(plan, c["packs"][0], 0, x.clone(), 0,
                              forced_routing=forced)
    p1 = ttpk.moe_segment_ref(plan, pk, 0, x.clone(), 1,
                              forced_routing=forced)
    routing = []
    ttpk.moe_segment_ref(plan, pk, 0, x.clone(), 1, routing=routing)
    assert routing[0].shape == (plan.B, plan.EP)
    assert not torch.equal(p0, p1)


@pytest.mark.parametrize("quant", ["none", "a16w8"])
def test_tp_decode_ref_matches_jax_tp_decode_fn_moe(quant):
    """The port's plain TP decode of the MoE model, the ranks on the CPU,
    against the JAX `build_tp_decode_fn` on a (1, 2) CPU mesh (interpret
    mode): tests/test_tp_megakernel.py's MoE case, held as
    tests/test_torch_tp_decode.py holds the dense one."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dashinfer_tpu.parallel import make_mesh as j_make_mesh
    from dashinfer_tpu.parallel import shard_cache as j_shard_cache
    from dashinfer_tpu.runtime.kv_cache import KVCache as JKVCache
    c = moe_case(quant)
    cfg, params, jplan, plan, pt = (c["cfg"], c["params"], c["jplan"],
                                    c["plan"], c["pt"])
    B, L, ps = plan.B, plan.L, plan.ps
    tokens = np.asarray([7, 11, 13, 0], np.int32)
    mesh = j_make_mesh((1, N))
    packed = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("model"))),
        c["jpacked"])
    full = [jnp.asarray(p) for p in c["pools"]]
    cache_s = j_shard_cache(JKVCache(*full), cfg, mesh)
    x0 = jnp.asarray(params["embed_tokens"]["w"])[tokens].astype(
        jnp.bfloat16)
    lens = jnp.asarray(LENS)
    cos, sin = j_rope_tiles(cfg, False, lens)
    sb, sp, ns, tgt = jmk.build_schedule(jnp.asarray(pt), lens,
                                         jnp.asarray(ACTIVE > 0), ps)
    fn = jtpk.build_tp_decode_fn(jplan, mesh, cfg.vocab_size, interpret=True)
    outs = jax.jit(fn)(packed, x0, cos, sin, jnp.asarray(pt), lens,
                       jnp.asarray(ACTIVE), tgt, sb, sp, ns, cache_s.k,
                       cache_s.v, cache_s.k_qparams, cache_s.v_qparams)
    ref = np.asarray(outs[0])[:, :cfg.vocab_size]
    ref_pools = [np.asarray(o) for o in outs[1:]]

    caches = [port_cache(pool_shard(c["pools"], r, N, 2, "int8"), ps)
              for r in range(N)]
    tcos, tsin = tsteps._rope_tiles(c["tcfg"], torch.from_numpy(LENS))
    x0_t = torch.from_numpy(np.asarray(params["embed_tokens"]["w"])
                            )[torch.from_numpy(tokens).long()].to(
                                torch.bfloat16)
    routing = []
    logits = ttpk.tp_decode_ref(
        plan, c["packs"], x0_t, tcos, tsin, torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0), caches, CPU2,
        routing=routing).numpy()
    assert logits.shape == (B, cfg.vocab_size) and len(routing) == L
    tol = 0.05 if quant == "none" else 0.08
    for b in np.nonzero(ACTIVE)[0]:
        rel = np.abs(logits[b] - ref[b]).max() / (np.abs(ref[b]).max() + 1e-6)
        assert rel < tol, (b, rel)
        assert int(np.argmax(logits[b])) == int(np.argmax(ref[b])), b
    written = written_rows(pt, range(L), L, ps, c["pools"][0].shape[:2])
    for r in range(N):
        after = [t.numpy() for t in (caches[r].k, caches[r].v,
                                     caches[r].k_qparams,
                                     caches[r].v_qparams)]
        assert_pool(after, pool_shard(ref_pools, r, N, 2, "int8"),
                    pool_shard(c["pools"], r, N, 2, "int8"), written, "int8",
                    ps, f"rank {r}")
    # forced to its own routing, the plain forward repeats itself
    from dashinfer_tpu_torch.ops import megakernel as tmk
    forced = torch.stack([
        torch.nonzero(tmk.route(plan, lg)[0] > 0
                      )[:, 1].reshape(B, -1)
        for lg in routing]).to(torch.int32)
    again = ttpk.tp_decode_ref(
        plan, c["packs"], x0_t, tcos, tsin, torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0),
        [port_cache(pool_shard(c["pools"], r, N, 2, "int8"), ps)
         for r in range(N)], CPU2, forced_routing=forced).numpy()
    np.testing.assert_array_equal(again[ACTIVE > 0], logits[ACTIVE > 0])


@pytest.mark.parametrize("grouped", [False, True])
def test_per_op_tp_moe_forwards_match_jax(grouped, monkeypatch):
    """The per-op TP decode and prefill forwards of the MoE model (every
    rank's share of `moe_block`: ragged experts, or with DI_MOE_GROUPED=1
    the grouped route's plain version, whose layout gives the other ranks'
    pairs no expert) against the JAX single-device forwards, f32 weights."""
    if grouped:
        monkeypatch.setenv("DI_MOE_GROUPED", "1")
    quant = "a16w4" if grouped else "none"
    cfg, rt, params = moe_fixture(quant)
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    ranks = shard_params(tparams, tcfg, make_mesh((1, N), ["cpu"] * N))
    ex = ranks[0]["layers"]["experts"]["gate_proj"]
    assert (ex["w_q"] if grouped else ex).shape[1] == 2
    assert ranks[1]["layers"]["router"]["w"].shape[-1] == 4
    B, maxP, ps = rt.max_batch, rt.max_pages_per_seq, rt.cache.page_size
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    jcache = _prep_cache(cfg, rt, params, JMode.INT8, LENS, pt)
    pools = [np.asarray(p) for p in (jcache.k, jcache.v, jcache.k_qparams,
                                     jcache.v_qparams)]
    tokens = np.asarray([7, 11, 13, 0], np.int32)
    ref, _ = jtf.decode_forward(
        cfg, params, jnp.asarray(tokens), jax.tree.map(jnp.copy, jcache),
        jnp.asarray(pt), jnp.asarray(LENS), jnp.asarray(ACTIVE > 0),
        mode=JMode.INT8, use_kernel=False)
    ref = np.asarray(ref)
    caches = [port_cache(pool_shard(pools, r, N, 2, "int8"), ps)
              for r in range(N)]
    got, _ = ttf.tp_decode_forward(
        tcfg, ranks, torch.from_numpy(tokens), caches, torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0),
        mode=TMode.INT8, devices=CPU2, use_kernel=False)
    got = got.numpy()
    rtol = 1e-2 if grouped else 2e-3
    single, _ = ttf.decode_forward(
        tcfg, tparams, torch.from_numpy(tokens),
        port_cache([p.copy() for p in pools], ps), torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0),
        mode=TMode.INT8, use_kernel=False)
    for b in np.nonzero(ACTIVE)[0]:
        assert np.abs(got[b] - ref[b]).max() <= rtol * np.abs(ref[b]).max()
        assert np.argmax(got[b]) == np.argmax(ref[b])
        assert np.abs(got[b] - single[b].numpy()).max() <= \
            (1e-2 if grouped else 1e-4) * np.abs(ref[b]).max()
    # prefill: 21 tokens of a fresh prompt into slot 3's pages
    S, n_tok = 32, 21
    toks = np.zeros((S,), np.int32)
    toks[:n_tok] = np.random.RandomState(4).randint(1, cfg.vocab_size,
                                                    size=n_tok)
    want, _ = jtf.prefill_forward(
        cfg, params, jnp.asarray(toks), jax.tree.map(jnp.copy, jcache),
        jnp.asarray(pt[3, :2]), jnp.int32(0), jnp.int32(n_tok),
        mode=JMode.INT8, use_kernel=False)
    want = np.asarray(want)
    caches = [port_cache(pool_shard(pools, r, N, 2, "int8"), ps)
              for r in range(N)]
    got, _ = ttf.tp_prefill_forward(
        tcfg, ranks, torch.from_numpy(toks), caches,
        torch.from_numpy(pt[3, :2].copy()), 0, n_tok, mode=TMode.INT8,
        devices=CPU2, use_kernel=False)
    got = got.numpy()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    assert np.argmax(got) == np.argmax(want)
    single, _ = ttf.prefill_forward(
        tcfg, tparams, torch.from_numpy(toks),
        port_cache([p.copy() for p in pools], ps),
        torch.from_numpy(pt[3, :2].copy()), 0, n_tok, mode=TMode.INT8,
        use_kernel=False)
    assert np.abs(got - single.numpy()).max() <= \
        (1e-2 if grouped else 1e-4) * np.abs(want).max()


def test_moe_block_rank_shares_sum_to_the_block(monkeypatch):
    """Each rank's share of `moe_block` (f32) sums to the single-device
    block on the same route: the ragged one within 1e-5, the grouped one
    (its plain version, where the other ranks' pairs are computed by no
    expert) within 1e-2 of the block's largest (it sums a token's experts
    in bf16, a rank only its own)."""
    cfg, _, params = moe_fixture("a16w4")
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    parts = ttpk.split_params_tp(tparams, tcfg, N)
    cfg_r = ttf.rank_config(tcfg, N)
    assert cfg_r.moe.num_experts == 2 and \
        cfg_r.moe.shared_expert_intermediate_size == 128
    x = torch.randn(5, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(1))
    lp = ttf._layer(tparams, 0)
    for grouped in ("0", "1"):
        monkeypatch.setenv("DI_MOE_GROUPED", grouped)
        whole = tmoe.moe_block(tcfg, x, lp)
        shares = [tmoe.moe_block(cfg_r, x, ttf._layer(p, 0), rank=r, n=N)
                  for r, p in enumerate(parts)]
        assert all(s.dtype == torch.float32 for s in shares)
        tol = 1e-2 * whole.abs().max().item() if grouped == "1" else 1e-5
        torch.testing.assert_close(shares[0] + shares[1], whole, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("n", [2, 4])
def test_supports_prefill_tp_refuses_moe(n):
    """No bucket of a MoE model takes the TP prefill segments (the JAX
    package's compute a dense MLP over the expert pack): with and without
    the caller's split tree, at every bucket and model axis, though the
    decode segments take the model at n = 2."""
    cfg, rt, params = moe_fixture("a16w4")
    tcfg = port_config(cfg)
    trt = dataclasses.replace(_port_rt(rt, "int8"), max_length=1024)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    local = ttpk.split_params_tp(tparams, tcfg, n)[0]
    assert ttpk.supports_tp(tcfg, trt, tparams, n) == (n == 2)
    for b in (128, 256, 512, 1024):
        assert jtpk.supports_prefill_tp(cfg, dataclasses.replace(
            rt, max_length=1024), params, b, n) == (n == 2)
        assert not ttpk.supports_prefill_tp(tcfg, trt, tparams, b, n)
        assert not ttpk.supports_prefill_tp(tcfg, trt, tparams, b, n,
                                            local=local)
