"""Qwen3 (per-head QK RMSNorm) through the port against the JAX package, on
the CPU: the per-op forwards of a tiny Qwen3 and Qwen3-MoE built by the JAX
loader from random HF models, the decode and prefill megakernels' plain
versions with `qk_norms` in the pack against the Pallas kernels in
interpret mode (INT8 and UINT4 KV, dense and MoE), the TP attn and prefill
attn segments' plain versions per rank at n = 2 against the JAX segments,
the split keeping `q_norm` / `k_norm` whole on every rank, the `supports`
rules, the kernels' argument order, and greedy tokens of the port's Engine
against the JAX Engine.

Tolerances are those of the files whose checks these reuse
(tests/test_torch_megakernel.py, test_torch_prefill_megakernel.py,
test_torch_tp_segments.py, test_torch_tp_prefill_segments.py,
test_torch_transformer.py, test_torch_moe.py), stated where they are
applied below. The per-op path rounds q and k to the model dtype after the
norm (the JAX per-op path's `rms_norm`), the megakernels keep them in f32
up to RoPE (the Pallas kernels'); each plain version follows its own JAX
counterpart."""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.hf_util as hf_util
from dashinfer_tpu.config import CacheConfig as JCacheCfg
from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
from dashinfer_tpu.loader import build_from_torch_model
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.models import transformer as jtr
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import prefill_megakernel as jpmk
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as t_create
from tests import test_torch_megakernel as tm
from tests import test_torch_prefill_megakernel as tpm
from tests.test_megakernel import _prep_cache, _quantized_fixture, _tiny, \
    _tiny_moe
from tests.test_torch_megakernel import _np_tree, _port_rt
from tests.test_torch_tp_prefill_segments import (assert_close,
                                                  written_prompt_rows)
from tests.test_torch_tp_segments import (ACTIVE, LENS, assert_close_rows,
                                          assert_pool, pool_shard,
                                          port_cache, written_rows)
from tests.test_torch_tp_split import assert_bit_equal
from tests.test_torch_transformer import _assert_pools_close, port_config

PS = 16
N = 2
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "dashinfer_tpu_torch", "csrc")


@functools.lru_cache(maxsize=None)
def _hf_model(moe: bool):
    """A tiny Qwen3 (head_dim 16) or Qwen3-MoE (4 experts top-2,
    norm_topk_prob) from a random HF model, through the JAX loader."""
    hf = hf_util.tiny_qwen3_moe_config() if moe else \
        hf_util.tiny_qwen3_config()
    cfg, params = build_from_torch_model(hf_util.make_torch_model(hf),
                                         hf.to_dict(), "float32")
    assert cfg.qk_norm and "q_norm" in params["layers"]
    return cfg, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the per-op path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe,mode,quant", [
    (False, "default", None), (False, "int8", "a16w4"),
    (True, "int8", None), (True, "int8", "a16w4")])
def test_per_op_prefill_and_decode_match_jax(moe, mode, quant):
    """Prefill one 10-token prompt, then 3 decode steps with 2 slots (slot 1
    inactive), through `prefill_forward` / `decode_forward` of both
    packages in f32. Unquantized: logits max|d| <= 1e-4 * max|ref|
    (test_torch_transformer.py's); a16w4 (group 32): both round the
    activation to bf16 for the weight product, so a last-bit f32 difference
    can move an operand by one bf16 step: 5e-3 dense, 1e-2 MoE
    (test_torch_moe.py's: the experts' gates weigh those products), the
    same argmax. Pools: payload within one level, float K/V and qparams
    within the logits' bound (2e-2 for the quantized MoE model, whose
    deeper layer quantizes those activations)."""
    cfg, params = _hf_model(moe)
    if quant:
        params = jax.tree.map(np.asarray, quantize_params(
            params, QuantConfig(mode=quant, group_size=32)))
    tcfg = port_config(cfg)
    ttr.check_supported(tcfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    L = cfg.num_layers
    n_pages = L * 6
    jc = j_create(cfg, JCacheCfg(page_size=PS, mode=JMode(mode)), n_pages,
                  model_dtype=jnp.float32)
    tc = t_create(tcfg, TCacheCfg(page_size=PS, mode=TMode(mode)), n_pages,
                  torch.float32, "cpu")
    ids = np.random.RandomState(3).randint(1, cfg.vocab_size, 10)
    toks = np.zeros(16, np.int32)
    toks[:len(ids)] = ids
    row = np.asarray([2, 4], np.int32)
    jl, jc = jax.jit(functools.partial(jtr.prefill_forward, cfg,
                                       mode=JMode(mode), use_kernel=False))(
        jparams, jnp.asarray(toks), jc, jnp.asarray(row), jnp.int32(0),
        jnp.int32(len(ids)))
    tl, tc = ttr.prefill_forward(tcfg, tparams, torch.from_numpy(toks), tc,
                                 torch.from_numpy(row), 0, len(ids),
                                 mode=TMode(mode))
    rtol = (1e-2 if moe else 5e-3) if quant else 1e-4
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= rtol * np.abs(jl).max()
    jdec = jax.jit(functools.partial(jtr.decode_forward, cfg,
                                     mode=JMode(mode), use_kernel=False))
    pt = np.stack([row, np.asarray([1, 0], np.int32)])
    tok = int(np.argmax(jl))
    for i in range(3):
        tokens = np.asarray([tok, 7], np.int32)
        lens = np.asarray([len(ids) + i, 3], np.int32)
        active = np.asarray([True, False])
        jl, jc = jdec(jparams, jnp.asarray(tokens), jc, jnp.asarray(pt),
                      jnp.asarray(lens), jnp.asarray(active))
        tl, tc = ttr.decode_forward(tcfg, tparams, torch.from_numpy(tokens),
                                    tc, torch.from_numpy(pt),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(active),
                                    mode=TMode(mode))
        jl0 = np.asarray(jl)[0]
        assert np.abs(tl.numpy()[0] - jl0).max() <= rtol * np.abs(jl0).max()
        assert int(tl[0].argmax()) == int(np.argmax(jl0))
        tok = int(np.argmax(jl0))
    _assert_pools_close(jc, tc, mode, 2e-2 if quant and moe else rtol)


def test_per_op_qk_norm_is_the_heads_rms_norm():
    """The per-op q|k|v of a QK-norm layer: each q and k head RMS-normalized
    with its [D] weight and rounded to the model dtype (the JAX per-op
    `_qkv`), v untouched; without QK-norm the same projections unnormed."""
    cfg, params = _hf_model(False)
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    lp = ttr._layer(tparams, 0)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (5, cfg.hidden_size)).astype(np.float32))
    q, k, v = ttr._qkv(tcfg, lp, x, use_kernel=False)
    q0, k0, v0 = ttr._qkv(dataclasses.replace(tcfg, qk_norm=False), lp, x,
                          use_kernel=False)
    assert torch.equal(v, v0)
    for got, raw, w in ((q, q0, lp["q_norm"]), (k, k0, lp["k_norm"])):
        want = raw * torch.rsqrt(raw.pow(2).mean(-1, keepdim=True) +
                                 cfg.rms_norm_eps) * w
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jq, jk, _ = jtr._qkv(cfg, jax.tree.map(lambda a: jnp.asarray(a[0]),
                                           params["layers"]),
                         jnp.asarray(x.numpy()))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the megakernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,mode", [("a16w4", "int8"),
                                        ("a16w8", "uint4"),
                                        ("none", "default")])
def test_decode_megakernel_ref_qk_norm_matches_pallas(quant, mode):
    """tests/test_torch_megakernel.py's check (logits within 1e-2 of their
    largest and the same argmax; written pool rows within one level, their
    qparams within 2e-2; every other pool element equal) on a QK-norm
    model, the pack holding `qk_norms` [L, 2, D]."""
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, True, False, PS, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    tm._check_against_pallas(cfg, rt, params, mode,
                             np.asarray([17, 16, 5, 0]),
                             np.asarray([1, 1, 1, 0]),
                             np.asarray([7, 11, 13, 0]))


def test_decode_megakernel_ref_qwen3_moe_matches_pallas():
    """The MoE branch with QK-norm (Qwen3-MoE's layout: no shared expert,
    norm_topk_prob), a16w4, INT8 KV, at the tolerances above."""
    cfg, rt, params = _tiny_moe(KH=2, H=2, shared=False, shared_gate=False,
                                norm_topk=True, qk_norm=True)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    tm._check_against_pallas(cfg, rt, params, "int8", np.asarray([17, 9, 0]),
                             np.asarray([1, 1, 0]), np.asarray([7, 11, 0]))


@pytest.mark.parametrize("quant,mode,n_tokens", [("a16w4", "int8", 45),
                                                 ("a16w8", "uint4", 128),
                                                 ("none", "default", 33)])
def test_prefill_megakernel_ref_qk_norm_matches_pallas(quant, mode,
                                                       n_tokens):
    """tests/test_torch_prefill_megakernel.py's check (logits within 2e-2
    of their largest and the same argmax; the written pool rows within one
    level, their qparams within 1e-3 in layer 0 and 1e-2 deeper; nothing
    else written) on a QK-norm model."""
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, True, False, PS, kh)
    rt = dataclasses.replace(
        rt, max_length=tpm.BUCKET + PS,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    tpm._check_against_pallas(cfg, rt, params, mode, n_tokens)


def test_prefill_megakernel_ref_qwen3_moe_matches_pallas():
    """The prefill MoE branch with QK-norm against the interpret-mode TPU
    kernel; as the MoE case there, at most 2 token rows of the pool may
    leave the tolerance (a flipped near-tie top-k choice)."""
    cfg, rt, params = _tiny_moe(ps=PS, KH=2, H=2, shared=False,
                                shared_gate=False, norm_topk=True,
                                qk_norm=True)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    rt = dataclasses.replace(rt, max_length=tpm.BUCKET + PS)
    tpm._check_against_pallas(cfg, rt, params, "int8", 45, flip_budget=2)


def test_forced_routing_reproduces_the_plain_routing_without_shared():
    """The prefill plain version routed as given (`forced_routing`: the
    MoE checks' rule, -1 for the rows past the prompt) reproduces its own
    unforced routing exactly for a Qwen3-MoE layout (no shared expert,
    renormalized gates): a row routed to no expert keeps zero gates, where
    0 / 0 once emptied the expert list of every row."""
    cfg, rt, params = _tiny_moe(ps=PS, KH=2, H=2, shared=False,
                                shared_gate=False, norm_topk=True,
                                qk_norm=True)
    rt = dataclasses.replace(rt, max_length=tpm.BUCKET + PS)
    tcfg, trt, tparams, plan, packed = tpm._port_side(cfg, rt, params,
                                                      "int8")
    S, L, n = plan.S, plan.L, 45
    toks = np.zeros(S, np.int64)
    toks[:n] = np.random.RandomState(2).randint(1, cfg.vocab_size, n)
    x0 = tparams["embed_tokens"]["w"][torch.from_numpy(toks)].to(
        torch.bfloat16)
    cos, sin = tsteps._rope_tiles(tcfg, torch.arange(S))
    page_row = torch.arange(1, plan.maxPb + 1, dtype=torch.int32) * L
    n_t = torch.tensor([n], dtype=torch.int32)

    def run(forced=None):
        routing = []
        cache = t_create(tcfg, trt.cache, rt.cache.num_pages * L,
                         torch.float32, "cpu")
        out = tpmk.prefill_megakernel_ref(
            plan, packed, x0, cos, sin, page_row, n_t, cache,
            routing=routing, forced_routing=forced)
        return out, routing

    want, routing = run()
    chosen = torch.full((L, S, plan.k_top), -1, dtype=torch.int64)
    for l, lg in enumerate(routing):
        chosen[l, :n] = tpmk.chosen_experts(plan, lg[:n])
    got, routing_f = run(chosen)
    assert torch.equal(got, want)
    for a, b in zip(routing, routing_f):
        assert torch.equal(a[:n], b[:n])
    gates, _ = tmk.route(plan, routing[0], chosen[0])
    assert not gates[n:].any() and torch.isfinite(gates).all()


def test_qk_norm_pack_and_plan():
    """The plan carries `qk_norm` into the prefill plans; the pack's
    `qk_norms` are [L, 2, D] f32 of the bf16-rounded q_norm, k_norm; the
    plain decode step without them (qk_norm off on the same pack) differs:
    the branch is live."""
    cfg, rt, params = _quantized_fixture("a16w4", True, False, PS, 1)
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(tcfg, trt, tparams)
    assert plan.qk_norm and not plan.has_qkv_bias
    assert tmk.cuda_kernel_gaps(plan) == []
    packed = tmk.pack_params(tcfg, plan, tparams)
    qk = packed["qk_norms"]
    assert qk.dtype == torch.float32 and qk.shape == (cfg.num_layers, 2, 128)
    for j, name in enumerate(("q_norm", "k_norm")):
        want = tparams["layers"][name].to(torch.bfloat16).float()
        assert torch.equal(qk[:, j], want)
    pplan = tpmk.make_prefill_plan(tcfg, trt, tparams, 128, decode_plan=plan)
    assert pplan.qk_norm
    assert tmk.pack_cache_key_fields(plan) != tmk.pack_cache_key_fields(
        dataclasses.replace(plan, qk_norm=False))
    B = trt.max_batch
    pt = (1 + torch.arange(B * trt.max_pages_per_seq, dtype=torch.int32)
          ).reshape(B, -1)
    lens = torch.tensor([17, 3, 0, 9], dtype=torch.int32)
    x0 = tparams["embed_tokens"]["w"][torch.tensor([7, 11, 13, 5])].to(
        torch.bfloat16)
    cos, sin = tsteps._rope_tiles(tcfg, lens)
    act = torch.ones(B, dtype=torch.bool)
    out = [tmk.decode_megakernel(
        p, packed, x0, cos, sin, pt, lens, act,
        t_create(tcfg, trt.cache, 64 * cfg.num_layers, torch.float32, "cpu"))
        for p in (plan, dataclasses.replace(plan, qk_norm=False))]
    assert not torch.allclose(out[0], out[1])


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

_tp_cache = {}


def _tp_fixture(quant: str, KH: int):
    """tests/test_torch_tp_split.py's tiny TP shape with QK-norm."""
    key = (quant, KH)
    if key not in _tp_cache:
        cfg, rt, params = _tiny(B=4, L=2, KH=KH, H=4, hid=256, inter=256,
                                vocab=512, qk_norm=True)
        if quant != "none":
            params = quantize_params(params, QuantConfig(
                mode=quant, group_size=-1 if quant == "a16w8" else 128))
        _tp_cache[key] = (cfg, rt, jax.tree.map(np.asarray, params))
    return _tp_cache[key]


@pytest.mark.parametrize("n", [2, 4])
def test_split_keeps_qk_norm_whole_on_every_rank(n):
    """`q_norm` / `k_norm` ([L, D], one weight for every head) stay whole on
    every rank, and the split equals the JAX `split_params_tp`."""
    cfg, _, params = _tp_fixture("a16w4", 4)
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    parts = ttpk.split_params_tp(tparams, tcfg, n)
    for r, part in enumerate(parts):
        for name in ("q_norm", "k_norm"):
            got = part["layers"][name]
            assert got.shape == (cfg.num_layers, 128), (r, name)
            assert torch.equal(got, tparams["layers"][name]), (r, name)
        want = jtpk._split_rank(params, cfg, n, r)
        for name in ("q_norm", "k_norm", "q_proj", "k_proj"):
            assert_bit_equal(want["layers"][name], part["layers"][name],
                             f"rank {r} {name}")


def _tp_case(quant, mode, KH):
    """The JAX and the port's TP plan and packs of the QK-norm model, and a
    pool prefilled through the JAX per-op prefill (the TP segment test's
    `tp_case`)."""
    cfg, rt, params = _tp_fixture(quant, KH)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    assert jtpk.supports_tp(cfg, rt, params, N)
    jplan, jpacked = jtpk.make_tp_plan(cfg, rt, params, N,
                                       target_chunk_bytes=48 * 1024)
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    assert ttpk.supports_tp(tcfg, trt, tparams, N)
    parts = ttpk.split_params_tp(tparams, tcfg, N)
    plan, packs = ttpk.make_tp_plan(tcfg, trt, parts)
    assert plan.qk_norm and packs[1]["qk_norms"].shape == (plan.L, 2, 128)
    return cfg, rt, params, jplan, jpacked, tcfg, trt, parts, plan, packs


@pytest.mark.parametrize("quant,mode,KH", [("a16w4", "int8", 2),
                                           ("a16w8", "uint4", 4)])
def test_tp_attn_segment_qk_norm_matches_jax_per_rank(quant, mode, KH):
    """Each rank's attn segment (plain) against the JAX `build_attn_segment`
    in interpret mode at n = 2, test_torch_tp_segments.py's tolerances: the
    o partial within 1e-2 of its largest over the active rows; the written
    pool rows within one level, a head's scale within 2e-2 of itself and
    its zero within 2e-2 of its range; every other element equal."""
    cfg, rt, params, jplan, jpacked, tcfg, _, _, plan, packs = _tp_case(
        quant, mode, KH)
    B, L, ps = plan.B, plan.L, plan.ps
    maxP = rt.max_pages_per_seq
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    jcache = _prep_cache(cfg, rt, params, JMode(mode), LENS, pt)
    pools = [np.asarray(p) for p in (jcache.k, jcache.v, jcache.k_qparams,
                                     jcache.v_qparams) if p is not None]
    x = (np.random.RandomState(5).standard_normal((B, cfg.hidden_size)) *
         0.5).astype(np.float32)
    lens_j = jnp.asarray(LENS)
    cos, sin = j_rope_tiles(cfg, False, lens_j)
    sb, sp, ns, tgt = jmk.build_schedule(jnp.asarray(pt), lens_j,
                                         jnp.asarray(ACTIVE > 0), ps)
    tcos, tsin = tsteps._rope_tiles(tcfg, torch.from_numpy(LENS))
    step_t = (tcos, tsin, torch.from_numpy(pt), torch.from_numpy(LENS),
              torch.from_numpy(ACTIVE > 0))
    seg_a = jtpk.build_attn_segment(jplan, interpret=True)
    layer = 1
    for r in range(N):
        pk = jax.tree.map(lambda a: a[r], jpacked)
        before = pool_shard(pools, r, N, KH, mode)
        o_j, pools_j = seg_a(layer, jnp.asarray(x),
                             jnp.tile(cos, (1, jplan.H)),
                             jnp.tile(sin, (1, jplan.H)),
                             jnp.tile(cos, (1, jplan.KH)),
                             jnp.tile(sin, (1, jplan.KH)), jnp.asarray(pt),
                             lens_j, jnp.asarray(ACTIVE), tgt, sb, sp, ns,
                             pk, *[jnp.asarray(p) for p in before])
        cache = port_cache(before, ps)
        o_t = ttpk.tp_attn_segment(plan, packs[r], layer,
                                   torch.from_numpy(x.copy()), *step_t,
                                   cache)
        assert_close_rows(o_t.numpy(), np.asarray(o_j), ACTIVE,
                          f"attn rank {r}")
        after = [t.numpy() for t in (cache.k, cache.v, cache.k_qparams,
                                     cache.v_qparams) if t is not None]
        assert_pool(after, [np.asarray(p) for p in pools_j], before,
                    written_rows(pt, (layer,), L, ps, before[0].shape[:2]),
                    mode, ps, f"attn rank {r}")


@pytest.mark.parametrize("quant,mode,KH,n_tokens", [
    ("a16w4", "int8", 2, 45), ("a16w8", "uint4", 4, 128)])
def test_tp_prefill_attn_segment_qk_norm_matches_jax_per_rank(quant, mode,
                                                              KH, n_tokens):
    """Each rank's prefill attn segment (plain) against the JAX
    `build_prefill_attn_segment` in interpret mode at n = 2, bucket 128,
    test_torch_tp_prefill_segments.py's tolerances: the prompt rows' o
    partial within 1e-2 of its largest; the pool as above."""
    bucket = 128
    cfg, rt, params = _tp_fixture(quant, KH)
    ps = rt.cache.page_size
    rt = dataclasses.replace(
        rt, max_length=bucket + ps,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    assert jtpk.supports_prefill_tp(cfg, rt, params, bucket, N)
    jplan, jpacked = jtpk.make_tp_prefill_plan(cfg, rt, params, bucket, N,
                                               target_chunk_bytes=48 * 1024)
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    assert ttpk.supports_prefill_tp(tcfg, trt, tparams, bucket, N)
    parts = ttpk.split_params_tp(tparams, tcfg, N)
    tp_plan, packs = ttpk.make_tp_plan(tcfg, trt, parts)
    plan = ttpk.make_tp_prefill_plans(tcfg, trt, parts, [bucket],
                                      tp_plan)[bucket]
    assert plan.qk_norm and ttpk.prefill_cuda_kernel_gaps(plan) == []
    L = cfg.num_layers
    jcache = j_create(cfg, rt.cache, rt.cache.num_pages * L,
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
        else:
            a = rng.randint(0, 256, a.shape).astype(np.uint8).view(a.dtype)
        pools.append(a)
    x = (rng.standard_normal((bucket, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    pages = 1 + rng.permutation(rt.cache.num_pages - 1)[:plan.maxPb]
    page_row = (pages * L).astype(np.int32)
    cos, sin = j_rope_tiles(cfg, False, jnp.arange(bucket, dtype=jnp.int32))
    tcos, tsin = tsteps._rope_tiles(tcfg, torch.arange(bucket))
    n_t = torch.tensor([n_tokens], dtype=torch.int32)
    seg_a = jtpk.build_prefill_attn_segment(jplan, interpret=True)
    layer = 1
    for r in range(N):
        pk = jax.tree.map(lambda a: a[r], jpacked)
        before = pool_shard(pools, r, N, KH, mode)
        o_j, pools_j = seg_a(layer, jnp.asarray(x), cos, sin,
                             jnp.asarray(page_row), jnp.int32(n_tokens), pk,
                             *[jnp.asarray(p) for p in before])
        cache = port_cache(before, ps)
        o_t = ttpk.tp_prefill_attn_segment(
            plan, packs[r], layer, torch.from_numpy(x.copy()), tcos, tsin,
            torch.from_numpy(page_row), n_t, cache)
        assert_close(o_t.numpy()[:n_tokens], np.asarray(o_j)[:n_tokens],
                     f"attn rank {r}")
        after = [t.numpy() for t in (cache.k, cache.v, cache.k_qparams,
                                     cache.v_qparams) if t is not None]
        assert_pool(after, [np.asarray(p) for p in pools_j], before,
                    written_prompt_rows(page_row, n_tokens, (layer,), ps,
                                        before[0].shape[:2]),
                    mode, ps, f"prefill attn rank {r}")


def test_tp_prefill_lm_segment_takes_a_64_mod_128_vocab_shard():
    """Qwen3's vocab 151936 over 2 ranks is 75968 columns, 64 mod 128: the
    TP prefill lm segment's one-row product writes the true columns, so
    its gaps (and the runtime's TP prefill install) let it through; the
    prefill megakernel keeps the 128 rule."""
    cfg, rt, params = _tp_fixture("a16w4", 2)
    rt = dataclasses.replace(rt, max_length=128 + PS)
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    parts = ttpk.split_params_tp(
        params_from_numpy(params, "cpu", torch.float32), tcfg, N)
    tp_plan, _ = ttpk.make_tp_plan(tcfg, trt, parts)
    pplan = ttpk.make_tp_prefill_plans(tcfg, trt, parts, [128],
                                       tp_plan)[128]
    assert ttpk.prefill_cuda_kernel_gaps(pplan) == []
    pplan = dataclasses.replace(pplan, lm=tmk.StreamPlan(
        "lm", ("lm_head",), 4, 4096, (151936 // N,), 128))
    assert ttpk.prefill_cuda_kernel_gaps(pplan) == []
    assert tpmk.cuda_kernel_gaps(pplan)
    assert ttpk.prefill_cuda_kernel_gaps(
        dataclasses.replace(pplan, E=4)) == ["MoE"]


# ---------------------------------------------------------------------------
# the rules and the kernels' arguments
# ---------------------------------------------------------------------------

def test_supports_agree_with_jax_on_qwen3():
    """`supports`, `supports_prefill`, `supports_tp` and
    `supports_prefill_tp` admit a QK-norm model exactly where the JAX
    package's rules do: with plain [D] norm leaves, not without them (a
    missing k_norm); and on an ALiBi model the port's `supports` says what
    the JAX package's does."""
    cfg, rt, params = _tp_fixture("a16w4", 2)
    rt = dataclasses.replace(rt, max_length=128 + PS)
    tcfg, trt = port_config(cfg), _port_rt(rt, "default")
    lp = params["layers"]
    no_k = dict(params, layers={k: v for k, v in lp.items()
                                if k != "k_norm"})
    for p, want in ((params, True), (no_k, False)):
        assert jmk.supports(cfg, rt, p) == want
        assert tmk.supports(tcfg, trt, p) == want
        assert jpmk.supports_prefill(cfg, rt, p, 128) == want
        assert tpmk.supports_prefill(tcfg, trt, p, 128) == want
    assert jtpk.supports_tp(cfg, rt, params, N)
    assert ttpk.supports_tp(tcfg, trt, params, N)
    assert jtpk.supports_prefill_tp(cfg, rt, params, 128, N)
    assert ttpk.supports_prefill_tp(tcfg, trt, params, 128, N)
    from dashinfer_tpu_torch.config import PositionEmbedding
    acfg, art, aparams = _tiny(alibi=True)
    assert jmk.supports(acfg, art, aparams)
    tacfg = dataclasses.replace(port_config(acfg),
                                position_embedding=PositionEmbedding.ALIBI)
    assert tmk.supports(tacfg, _port_rt(art, "default"),
                        _np_tree(aparams))


def _enum(path: str) -> list:
    """The names of a source's `enum IArg`, lower case, without I_ (the
    wrappers' names, case aside)."""
    src = open(path).read()
    body = re.search(r"enum IArg \{(.*?)\};", src, re.S).group(1)
    names = [t.strip() for t in body.replace("\n", " ").split(",")]
    return [t[2:].lower() for t in names if t and t != "I_STREAMS"]


def test_kernel_arguments_in_the_sources_order():
    """The wrappers' integer arguments (`_IARGS`, the QK-norm weights'
    address among them) in the order of the kernels' `enum IArg`."""
    assert _enum(os.path.join(CSRC, "di_layer.cuh")) == \
        [k.lower() for k in tmk._IARGS]
    assert _enum(os.path.join(CSRC, "di_prefill_layer.cuh")) == \
        [k.lower() for k in tpmk._IARGS]
    assert "qk_norm" in tmk._IARGS and "qk_norm" in tpmk._IARGS


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

PROMPT = [5, 9, 2, 41, 77, 3]


def _greedy(mod):
    return mod.GenerationConfig(max_length=20, do_sample=False, top_k=1,
                                eos_token_id=-1)


def _engine_tokens(mod, cfg, params, builder, device=None):
    kw = {} if device is None else dict(device=device)
    eng = mod.Engine().install_model("q3", builder.build(), params=params,
                                     model_config=cfg, **kw)
    run = eng._models["q3"]
    eng.start_model("q3")
    try:
        _, h, q = eng.start_request("q3", PROMPT, _greedy(mod))
        eng.sync_request("q3", h, timeout_s=900)
        return run, q.GetAllGeneratedTokens()
    finally:
        eng.release_model("q3")


def test_engine_tiny_qwen3_same_tokens_as_jax_engine():
    """The verify drive on a tiny HF Qwen3 (head_dim 16: the per-op path):
    14 greedy tokens, equal through both Engines and to the HF model's own
    greedy continuation."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    cfg, params = _hf_model(False)

    def b(mod):
        return (mod.RuntimeConfigBuilder("q3").max_length(96).max_batch(2)
                .kv_cache_page_size(16).kv_cache_num_pages(24)
                .dtype("float32").update({"min_prefill_bucket": 16}))

    _, want = _engine_tokens(jp, cfg, params, b(jp))
    run, got = _engine_tokens(tp, port_config(cfg), params, b(tp), "cpu")
    assert run.mega_plan is None
    assert len(got) == 14 and got == want
    hf = hf_util.make_torch_model(hf_util.tiny_qwen3_config())
    assert got == hf_util.hf_greedy_tokens(hf, PROMPT, 14)


def test_engine_qwen3_megakernel_and_mesh_paths_same_tokens_as_jax():
    """A head_dim-128 Qwen3 (a16w4, INT8 KV): the port's default install
    plans QK-norm into the decode megakernel (its plain version on the
    CPU) and, on a (1, 2) mesh of the CPU, into the TP segments; the JAX
    Engine decodes through its megakernel in interpret mode. The two sum in
    another order, so a late near-tie of a random tiny model may flip: the
    first 10 of 14 tokens agree (tests/test_torch_engine.py's rule), and
    the mesh's tokens those of the port's single-device serving."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    cfg, rt, params = _tiny(B=2, KH=2, H=4, qk_norm=True)
    rt = dataclasses.replace(
        rt, max_length=48,
        cache=dataclasses.replace(rt.cache, mode=JMode.INT8))
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    jrt = JRuntime("q3", cfg, params, rt, use_kernel=True)
    assert jrt.mega_plan is not None
    jeng = jp.Engine()
    jeng._models["q3"] = jrt
    jeng.start_model("q3")
    try:
        _, h, jq = jeng.start_request("q3", PROMPT, _greedy(jp))
        jeng.sync_request("q3", h, timeout_s=900)
    finally:
        jeng.release_model("q3")
    want = jq.GetAllGeneratedTokens()

    def b(mesh=1):
        out = (tp.RuntimeConfigBuilder("q3").max_length(rt.max_length)
               .max_batch(rt.max_batch).kv_cache_page_size(PS)
               .kv_cache_num_pages(rt.cache.num_pages)
               .kv_cache_mode(tp.CacheMode.INT8).dtype(rt.dtype)
               .update({"min_prefill_bucket": rt.min_prefill_bucket}))
        return out.mesh(1, mesh) if mesh > 1 else out

    np_params = _np_tree(params)
    run, got = _engine_tokens(tp, port_config(cfg), np_params, b(), "cpu")
    assert run.mega_plan is not None and run.mega_plan.qk_norm
    assert len(got) == len(want) == 14 and got[:10] == want[:10], (got, want)
    run, mesh_got = _engine_tokens(tp, port_config(cfg), np_params, b(2),
                                   ["cpu", "cpu"])
    assert run.tp_mega_plan is not None and run.tp_mega_plan.qk_norm
    assert mesh_got[:10] == got[:10], (mesh_got, got)
