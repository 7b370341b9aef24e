"""The port's prefill megakernel module against the JAX package's, on the
CPU: `prefill_megakernel_ref` (which the port's wrapper runs for CPU
tensors) against the Pallas kernel in interpret mode on the same numpy
params and inputs, `supports_prefill` over a table of buckets and
quantizations, and the plain version against the port's per-op
`prefill_forward`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import prefill_megakernel as jpmk
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create_cache
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from tests.test_megakernel import _quantized_fixture, _tiny, _tiny_moe
from tests.test_torch_megakernel import _np_tree, _port_rt, _unpack_kv
from tests.test_torch_transformer import port_config

BUCKET, PS = 128, 16

# Tolerances. Both sides round x_norm, the dequantized weights, p, v,
# attn_out and the SwiGLU activation to bf16 at the same points and keep f32
# sums; they differ in the order of those sums (the TPU kernel also adds the
# MLP's inter chunks one by one). Logits: max|d| <= 2e-2 * max|ref| and the
# same argmax (readings 1e-6 .. 4e-3). Written pool rows: integer payload at
# most one level apart; scale, and zero relative to the token's range,
# within 1e-3 in layer 0, where both sides quantize the same input, and
# within 1e-2 in the deeper layer, whose activations already differ by the
# bf16 roundings that an f32 order change moved (reading 1.3e-3 under
# UINT4); float payload within 1e-3 * max|ref|. Every pool element outside
# rows < n of the owned pages keeps its value.
LOGITS_RTOL = 2e-2
QPARAM_RTOL = 1e-3
DEEP_QPARAM_RTOL = 1e-2


def _fixture(quant, mode):
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, False, PS, kh)
    rt = dataclasses.replace(
        rt, max_length=BUCKET + PS,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    return cfg, rt, params


def _port_side(cfg, rt, params, mode):
    """(cfg, rt, tensor params of the weight-only view, plan, pack)."""
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    view = tmk.weight_only_decode_view(_np_tree(params))
    tparams = params_from_numpy(view, "cpu", torch.float32)
    assert tpmk.supports_prefill(tcfg, trt, tparams, BUCKET)
    dplan = tmk.make_plan(tcfg, trt, tparams)
    plan = tpmk.make_prefill_plan(tcfg, trt, tparams, BUCKET,
                                  decode_plan=dplan)
    assert plan.qkv is dplan.qkv and plan.dn is dplan.dn
    return tcfg, trt, tparams, plan, tmk.pack_params(tcfg, dplan, tparams)


@pytest.mark.parametrize("quant,mode,n_tokens", [
    ("none", "default", 45), ("none", "int8", 45), ("a16w4", "int8", 33),
    ("a16w8", "uint4", 48), ("a8w8", "int8", 45), ("none", "int8", 17)])
def test_prefill_megakernel_ref_matches_pallas_interpret(quant, mode,
                                                         n_tokens):
    cfg, rt, params = _fixture(quant, mode)
    _check_against_pallas(cfg, rt, params, mode, n_tokens)


@pytest.mark.parametrize("quant,shared,kh", [("a16w4", True, 2),
                                             ("none", False, 1)])
def test_prefill_megakernel_ref_moe_matches_pallas_interpret(quant, shared,
                                                             kh):
    """The MoE branch against the interpret-mode TPU kernel. Both route
    every row with the same bf16 router product, but an order change in its
    sums could flip a near-tie top-k choice: as in the JAX package's own
    test, at most 2 token rows of the pool may leave the tolerance."""
    cfg, rt, params = _tiny_moe(ps=PS, KH=kh, H=2, shared=shared,
                                shared_gate=shared, norm_topk=not shared)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    rt = dataclasses.replace(rt, max_length=BUCKET + PS)
    _check_against_pallas(cfg, rt, params, "int8", 45, flip_budget=2)


def _check_against_pallas(cfg, rt, params, mode, n_tokens, flip_budget=0):
    assert jpmk.supports_prefill(cfg, rt, params, BUCKET)
    jplan = jpmk.make_prefill_plan(cfg, rt, params, BUCKET,
                                   target_chunk_bytes=48 * 1024)
    jpacked = jpmk.pack_prefill_params(cfg, jplan, params)
    fn = jpmk.build_prefill_megakernel(jplan, interpret=True)

    L, KH = cfg.num_layers, cfg.num_kv_heads
    rng = np.random.RandomState(7)
    toks = np.zeros((BUCKET,), np.int32)
    toks[:n_tokens] = rng.randint(1, cfg.vocab_size, size=n_tokens)
    maxPb = jplan.maxPb
    page_row = np.arange(1, maxPb + 1, dtype=np.int32)   # logical pages

    # the JAX side, as engine/steps.py `_prefill_mega_forward` calls it
    from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
    view = jmk.weight_only_decode_view(params)
    jcache = j_create_cache(cfg, rt.cache, rt.cache.num_pages * L,
                            model_dtype=jnp.float32)
    x0 = view["embed_tokens"]["w"][jnp.asarray(toks)].astype(jnp.bfloat16)
    cos, sin = j_rope_tiles(cfg, False, jnp.arange(BUCKET, dtype=jnp.int32))
    pools = [jcache.k, jcache.v]
    if jcache.k_qparams is not None:
        pools += [jcache.k_qparams, jcache.v_qparams]
    outs = fn(jpacked, x0, cos, sin, jnp.asarray(page_row * L),
              jnp.int32(n_tokens), *pools)
    ref = np.asarray(outs[0])[0, :cfg.vocab_size]
    ref_pools = [np.asarray(o) for o in outs[1:]]

    # the port, from the same numpy arrays
    tcfg, trt, tparams, plan, packed = _port_side(cfg, rt, params, mode)
    assert plan.qkv.bits == jplan.qkv.bits and plan.lm.bits == jplan.lm.bits
    cache = create_kv_cache(tcfg, trt.cache, rt.cache.num_pages * L,
                            torch.float32, "cpu")
    tx0 = tparams["embed_tokens"]["w"][torch.from_numpy(toks).long()] \
        .to(torch.bfloat16)
    tcos, tsin = tsteps._rope_tiles(tcfg, torch.arange(BUCKET))
    np.testing.assert_array_equal(np.asarray(cos.astype(jnp.float32)),
                                  tcos.float().numpy())
    logits = tpmk.prefill_megakernel(
        plan, packed, tx0, tcos, tsin, torch.from_numpy(page_row * L),
        torch.tensor([n_tokens], dtype=torch.int32), cache).numpy()

    assert logits.shape == (cfg.vocab_size,)
    assert np.abs(logits - ref).max() <= LOGITS_RTOL * np.abs(ref).max()
    assert int(np.argmax(logits)) == int(np.argmax(ref))

    got_pools = [cache.k.numpy(), cache.v.numpy()]
    if cache.k_qparams is not None:
        got_pools += [cache.k_qparams.numpy(), cache.v_qparams.numpy()]
    written = np.zeros(got_pools[0].shape[:2], bool)
    for t in range(n_tokens):
        for l in range(L):
            written[page_row[t // PS] * L + l, t % PS] = True
    levels = 255.0 if mode == "int8" else 15.0
    token = np.nonzero(written)[1] + PS * (
        (np.nonzero(written)[0] // L) - 1)      # the row's token index
    bad = np.zeros(written.sum(), bool)
    for i in (0, 1):
        got = _unpack_kv(got_pools[i], mode)[written]
        want = _unpack_kv(ref_pools[i], mode)[written]
        if mode == "default":
            bad |= np.abs(got - want).max(-1) > \
                QPARAM_RTOL * np.abs(want).max()
            continue
        bad |= np.abs(got - want).max(-1) > 1
        # qparams [pages, 2*KH, ps] -> [pages, ps, 2*KH] at the written rows
        gq = got_pools[2 + i].transpose(0, 2, 1)[written]
        wq = ref_pools[2 + i][..., :PS].transpose(0, 2, 1)[written]
        assert gq.shape == (n_tokens * L, 2 * KH)
        scale = wq[:, 0::2]
        rel = np.maximum(np.abs(gq[:, 0::2] - scale) / scale,
                         np.abs(gq[:, 1::2] - wq[:, 1::2]) /
                         (scale * levels)).max(axis=-1)
        layer0 = np.nonzero(written)[0] % L == 0
        bad |= layer0 & (rel > QPARAM_RTOL)
        bad |= rel > DEEP_QPARAM_RTOL
    # rows beyond the tolerance: none, or for MoE the rows of at most
    # `flip_budget` tokens (a flipped top-k choice)
    assert len(set(token[bad].tolist())) <= flip_budget, token[bad]
    # nothing else was written: the pool started as zeros
    for i, a in enumerate(got_pools):
        keep = ~written if i < 2 else \
            ~np.broadcast_to(written[:, None, :], a.shape)
        assert not a[keep].any(), i


@pytest.mark.parametrize("quant,mode", [
    ("none", "default"), ("a16w4", "int8"), ("a16w8", "uint4"),
    ("a8w8", "int8")])
def test_supports_prefill_agrees_with_jax(quant, mode):
    cfg, rt, params = _fixture(quant, mode)
    tcfg, trt, p = port_config(cfg), _port_rt(rt, mode), _np_tree(params)
    for bucket in (64, 128, 192, 1024, 2048):
        want = jpmk.supports_prefill(cfg, rt, params, bucket)
        assert want == (bucket in (128, 1024))
        assert tpmk.supports_prefill(tcfg, trt, p, bucket) == want, bucket
    # gate / up / down must share their bits on both sides
    if quant == "a16w4":
        mixed = dict(p, layers=dict(p["layers"], down_proj={
            "w": np.zeros((cfg.num_layers, cfg.intermediate_size,
                           cfg.hidden_size), np.float32)}))
        assert not tpmk.supports_prefill(tcfg, trt, mixed, 128)
        assert not jpmk.supports_prefill(cfg, rt, mixed, 128)


def test_supports_prefill_turns_down_what_the_port_has_not():
    """QK-norm (Qwen3) and ALiBi (Baichuan-13B) are ported: on both the
    port's `supports_prefill` agrees with the JAX package's, which admits
    them."""
    from dashinfer_tpu_torch.config import ModelConfig, PositionEmbedding
    for kw in (dict(qk_norm=True), dict(alibi=True)):
        cfg, rt, params = _tiny(ps=PS, **kw)
        rt = dataclasses.replace(rt, max_length=BUCKET + PS)
        assert jpmk.supports_prefill(cfg, rt, params, BUCKET)
        kws = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if f.name not in ("activation", "rope_scaling", "moe",
                                 "position_embedding")}
        tcfg = ModelConfig(**kws, position_embedding=PositionEmbedding(
            cfg.position_embedding.value))
        assert tpmk.supports_prefill(tcfg, _port_rt(rt, "default"),
                                     _np_tree(params), BUCKET)


def test_prefill_plan_and_gaps():
    cfg, rt, params = _fixture("a16w4", "int8")
    tcfg, trt, tparams, plan, _ = _port_side(cfg, rt, params, "int8")
    assert (plan.S, plan.maxPb, plan.kv_bits, plan.kv_dtype_name) == \
        (BUCKET, BUCKET // PS, 8, "int8")
    # without a decode plan the same streams come from the params
    assert tpmk.make_prefill_plan(tcfg, trt, tparams, BUCKET) == plan
    # the tiny model's 128-column k and v leaves are padded to the pack's
    # 256-column tiles, and the kernel's q|k|v phase reads each of q, k and
    # v at its padded offset, so they take the kernel, as q, k and v of
    # whole tiles do; not a width that is no multiple of 128, nor a
    # 1100-token bucket
    assert plan.qkv.N == (256, 128, 128) and plan.qkv.Np == (256, 256, 256)
    assert tpmk.cuda_kernel_gaps(plan) == []
    whole = dataclasses.replace(plan, qkv=dataclasses.replace(
        plan.qkv, N=(256, 256, 256)))
    assert tpmk.cuda_kernel_gaps(whole) == []
    narrow = dataclasses.replace(plan, qkv=dataclasses.replace(
        plan.qkv, N=(256, 64, 64)))
    gaps = tpmk.cuda_kernel_gaps(narrow)
    assert len(gaps) == 1 and gaps[0].startswith("qkv: columns")
    assert len(tpmk.cuda_kernel_gaps(dataclasses.replace(whole, S=1100))) == 1
    assert tpmk.trace_len(plan) == 2 * (9 * plan.L + 2) + 1
    # one chunk (K = 256: 4) cannot split further than its chunks
    ks, cps = tpmk.choose_split(14, 56, 1, 132)
    assert ks * cps >= 56 and (ks - 1) * cps < 56 and ks > 1
    assert tpmk.choose_split(148, 56, 8, 132) == (1, 56)


def test_moe_supports_prefill_and_plan():
    """The JAX MoE rules (uniform bits over the experts and over the shared
    expert), the decode plan's MoE fields adopted, the routed operations of
    a launch (n rows x k experts + the router + the shared expert), and the
    trace's phases of a MoE layer (router, gates, route, the experts over
    their routed slots, the sum, the shared expert)."""
    cfg, rt, params = _tiny_moe(ps=PS, KH=2, H=2)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    rt = dataclasses.replace(rt, max_length=BUCKET + PS)
    tcfg, trt, p = port_config(cfg), _port_rt(rt, "int8"), _np_tree(params)
    for bucket in (64, 128, 256):
        want = jpmk.supports_prefill(cfg, rt, params, bucket)
        assert want == (bucket % 128 == 0)
        assert tpmk.supports_prefill(tcfg, trt, p, bucket) == want
    lp = p["layers"]
    mixed = dict(p, layers=dict(lp, experts=dict(
        lp["experts"], down_proj=np.zeros((2, 4, 256, 256), np.float32))))
    assert not jpmk.supports_prefill(cfg, rt, mixed, 128)
    assert not tpmk.supports_prefill(tcfg, trt, mixed, 128)
    tparams = params_from_numpy(p, "cpu", torch.float32)
    dplan = tmk.make_plan(tcfg, trt, tparams)
    plan = tpmk.make_prefill_plan(tcfg, trt, tparams, BUCKET,
                                  decode_plan=dplan)
    assert (plan.E, plan.k_top, plan.rt, plan.sgu) == \
        (4, 2, dplan.rt, dplan.sgu)
    hid, Im, n = 256, 256, 45
    routed = plan.operations(n)
    shared = sum(sp.K * sp.Ntot for sp in (plan.sgu, plan.sdn))
    attn = sum(sp.K * sp.Ntot for sp in (plan.qkv, plan.o))
    assert routed - plan.operations(0) == n * 2.0 * 2 * (
        attn + 2 * (3 * hid * Im) + shared + hid * (4 + 1)) + \
        2.0 * 2 * plan.H * plan.D * (n * (n + 1))
    assert tpmk.cuda_kernel_gaps(plan) == []
    names = tpmk._phase_names(plan)
    assert len(names) == 2 * (9 + 4 + 2) + 2
    assert names[6:15] == ("router", "gates", "route", "expert_gate_up",
                           "expert_swiglu", "expert_down", "moe_sum",
                           "shared_swiglu", "shared_down")
    assert tpmk.trace_len(plan) == 2 * len(names) + 1


def test_scratch_is_one_set_that_grows_to_the_largest_plan():
    """Every bucket's launches share one set of flat buffers per device:
    a smaller need reuses what is there, a larger one replaces the buffer,
    and new buffers are zero (rows 1.. of x_last rely on it)."""
    sc = tpmk._Scratch(torch.device("cpu"))
    sc.fit(dict(partial=64, x_last=32, status=1))
    first = sc.bufs["partial"]
    assert first.dtype == torch.float32 and not first.any()
    assert sc.bufs["x_last"].dtype == torch.bfloat16
    sc.fit(dict(partial=16, x_last=48))
    assert sc.bufs["partial"] is first
    assert sc.bufs["x_last"].numel() == 48 and not sc.bufs["x_last"].any()
    assert sc.nbytes() == 64 * 4 + 48 * 2 + 4
    assert tpmk.scratch_bytes("cpu") == 0
    tpmk.release_scratch("cpu")         # nothing held: no error
    tpmk.check_status("cpu")


def test_plain_version_against_per_op_prefill_forward():
    """With an unquantized pool both paths attend exact K/V, so the plain
    version must give the per-op `prefill_forward`'s logits up to its bf16
    rounding points (the JAX test's reasoning: a quantized pool would put
    the per-op path's dequantized pages into deeper layers), and write the
    same K/V rows."""
    cfg, rt, params = _fixture("none", "default")
    tcfg, trt, tparams, plan, packed = _port_side(cfg, rt, params, "default")
    n, L = 45, cfg.num_layers
    rng = np.random.RandomState(11)
    toks = np.zeros((BUCKET,), np.int64)
    toks[:n] = rng.randint(1, cfg.vocab_size, size=n)
    toks = torch.from_numpy(toks)
    page_row = torch.arange(1, plan.maxPb + 1, dtype=torch.int32)
    caches = [create_kv_cache(tcfg, trt.cache, rt.cache.num_pages * L,
                              torch.float32, "cpu") for _ in range(2)]
    want, _ = ttr.prefill_forward(tcfg, tparams, toks, caches[0], page_row,
                                  0, n, mode=TMode.DEFAULT)
    cos, sin = tsteps._rope_tiles(tcfg, torch.arange(BUCKET))
    got = tpmk.prefill_megakernel_ref(
        plan, packed, tparams["embed_tokens"]["w"][toks].to(torch.bfloat16),
        cos, sin, page_row * L, torch.tensor([n], dtype=torch.int32),
        caches[1])
    # bf16 rounding of activations and weights against the f32 path
    assert (got - want).abs().max() <= 8e-2 * want.abs().max()
    assert int(got.argmax()) == int(want.argmax())
    for a, b in ((caches[1].k, caches[0].k), (caches[1].v, caches[0].v)):
        assert (a - b).abs().max() <= 3e-2 * b.abs().max()
        assert torch.equal(a == 0, b == 0)       # the same rows were written
