"""The port's decode megakernel module against the JAX package's, on the
CPU: the install-time helpers leaf for leaf, `supports` on the tiny configs
of tests/test_megakernel.py, and `decode_megakernel_ref` (which the port's
wrapper runs for CPU tensors) against the Pallas kernel in interpret mode,
on the same numpy params, cache and inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.config import RuntimeConfig as TRuntimeCfg
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
from tests.test_megakernel import (_prep_cache, _quantized_fixture, _tiny,
                                   _tiny_moe)
from tests.test_torch_transformer import port_config


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_rt(rt, mode_name):
    return TRuntimeCfg(
        model_name=rt.model_name, max_length=rt.max_length,
        max_batch=rt.max_batch, dtype=rt.dtype,
        min_prefill_bucket=rt.min_prefill_bucket,
        cache=TCacheCfg(page_size=rt.cache.page_size,
                        num_pages=rt.cache.num_pages, mode=TMode(mode_name)))


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or not isinstance(a, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_expand_u4_to_i8_equals_jax_leaf_for_leaf():
    _, _, params = _quantized_fixture("a16w4", False, False, 16, 1)
    p = _np_tree(params)
    for meta in (False, True):
        want = jmk.expand_u4_to_i8(p, meta_only=meta)
        got = tmk.expand_u4_to_i8(p, meta_only=meta)
        _assert_tree_equal(want, got)
    assert got["layers"]["q_proj"]["w_q"].dtype == np.int8
    assert got["layers"]["down_proj"]["scale"].shape[1] == 1
    # no u4 leaf -> None, as the JAX function
    _, _, plain = _tiny()
    assert tmk.expand_u4_to_i8(_np_tree(plain)) is None
    assert jmk.expand_u4_to_i8(_np_tree(plain)) is None


def test_expand_u4_to_i8_tensors_equals_the_numpy_function():
    """The runtime re-expands tensor leaves on their device; same
    arithmetic, same leaves (exactly)."""
    _, _, params = _quantized_fixture("a16w4", False, False, 16, 1)
    p = _np_tree(params)
    want = tmk.expand_u4_to_i8(p)
    got = tmk.expand_u4_to_i8_tensors(
        params_from_numpy(p, "cpu", torch.float32), col_block=96)
    for name in ("q_proj", "down_proj"):
        for key in ("w_q", "scale", "zero"):
            np.testing.assert_array_equal(want["layers"][name][key],
                                          got["layers"][name][key].numpy())
    assert got["layers"]["q_proj"]["w_q"].dtype == torch.int8
    _, _, plain = _tiny()
    assert tmk.expand_u4_to_i8_tensors(
        params_from_numpy(_np_tree(plain), "cpu", torch.float32)) is None


def test_weight_only_decode_view_equals_jax_leaf_for_leaf():
    _, _, params = _quantized_fixture("a8w8", False, False, 16, 1)
    p = _np_tree(params)
    want, got = jmk.weight_only_decode_view(p), tmk.weight_only_decode_view(p)
    assert got is not p and "w_q" in got["layers"]["q_proj"]
    _assert_tree_equal(want, got)
    # nothing to convert -> the same object; fp8 payload -> None
    _, _, plain = _tiny()
    p2 = _np_tree(plain)
    assert tmk.weight_only_decode_view(p2) is p2
    bad = dict(p2, layers=dict(p2["layers"], q_proj={"w_f8": 0}))
    assert tmk.weight_only_decode_view(bad) is None
    assert jmk.weight_only_decode_view(bad) is None


@pytest.mark.parametrize("quant,mode", [("none", "default"), ("none", "int8"),
                                        ("a16w4", "int8"),
                                        ("a16w8", "uint4")])
def test_supports_agrees_with_jax_on_tiny_configs(quant, mode):
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, False, 16, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    p = _np_tree(params)
    trt = _port_rt(rt, mode)
    assert jmk.supports(cfg, rt, params)
    assert tmk.supports(port_config(cfg), trt, p)
    # the rules both keep: batch cap, head_dim, o bias, mixed q/k/v bits
    big = dataclasses.replace(trt, max_batch=65)
    assert not tmk.supports(port_config(cfg), big, p)
    assert not jmk.supports(cfg, dataclasses.replace(rt, max_batch=65),
                            params)
    cfg64 = dataclasses.replace(cfg, head_dim=64)
    assert not tmk.supports(port_config(cfg64), trt, p)
    assert not jmk.supports(cfg64, rt, params)
    with_b = dict(p, layers=dict(p["layers"], o_proj=dict(
        p["layers"]["o_proj"], b=np.zeros((cfg.num_layers, cfg.hidden_size),
                                          np.float32))))
    assert not tmk.supports(port_config(cfg), trt, with_b)
    assert not jmk.supports(cfg, rt, with_b)


def test_supports_turns_down_what_the_port_has_not():
    """QK-norm (Qwen3) and ALiBi (Baichuan-13B) are ported: on both the
    port's `supports` agrees with the JAX package's, which admits them; an
    ALiBi model with LayerNorm leaves (Bloom's w / b) says no in both."""
    for kw in (dict(qk_norm=True), dict(alibi=True)):
        cfg, rt, params = _tiny(**kw)
        assert jmk.supports(cfg, rt, params)
        kws = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if f.name not in ("activation", "rope_scaling", "moe",
                                 "position_embedding")}
        from dashinfer_tpu_torch.config import ModelConfig, PositionEmbedding
        tcfg = ModelConfig(**kws, position_embedding=PositionEmbedding(
            cfg.position_embedding.value))
        trt = _port_rt(rt, "default")
        assert tmk.supports(tcfg, trt, _np_tree(params))
        if "alibi" in kw:
            lp = params["layers"]
            ln = dict(params, layers=dict(lp, input_layernorm={
                "w": lp["input_layernorm"],
                "b": np.zeros_like(lp["input_layernorm"])}))
            assert not jmk.supports(cfg, rt, ln)
            assert not tmk.supports(tcfg, trt, _np_tree(ln))


@pytest.mark.parametrize("quant", ["none", "a16w4", "a16w8"])
def test_moe_supports_agrees_with_jax(quant):
    cfg, rt, params = _tiny_moe(KH=2, H=2)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    tcfg, trt, p = port_config(cfg), _port_rt(rt, "int8"), _np_tree(params)
    assert jmk.supports(cfg, rt, params) and tmk.supports(tcfg, trt, p)
    plan = tmk.make_plan(tcfg, trt, p)
    assert (plan.E, plan.k_top, plan.EP, plan.has_shared_gate) == \
        (4, 2, 128, True)
    assert plan.gu.E == plan.dn.E == 4 and plan.inter == 256
    # the rules both keep: dense layers among MoE ones, more than 8
    # experts a token, a biased shared expert
    for change in (dict(mlp_only_layers=(1,)),
                   dict(num_experts_per_tok=9)):
        jc = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              **change))
        assert not jmk.supports(jc, rt, params)
        assert not tmk.supports(port_config(jc), trt, p)
    lp = p["layers"]
    biased = dict(p, layers=dict(lp, shared_expert=dict(
        lp["shared_expert"], down_proj=dict(
            lp["shared_expert"]["down_proj"],
            b=np.zeros((cfg.num_layers, cfg.hidden_size), np.float32)))))
    assert not jmk.supports(cfg, rt, biased)
    assert not tmk.supports(tcfg, trt, biased)


def test_width_of_128_mod_256_takes_the_kernels():
    """A vocab (or an expert width) that is a multiple of 128 but not of
    256 is padded in the pack: `supports` and `cuda_kernel_gaps` accept the
    model, the padded payload and qparams are zero, and the plain version's
    logits equal those of the unpadded loader leaf exactly (the padded
    columns compute 0 and are dropped)."""
    from tests.test_megakernel import _tiny as tiny
    from dashinfer_tpu_torch.loader.quantize import quantize_weight
    cfg, rt, params = tiny(vocab=384)
    params = _np_tree(quantize_params(params, QuantConfig(mode="a16w4",
                                                          group_size=128)))
    # a u4 lm_head of 384 columns: the loader's plain-halves layout
    params["lm_head"] = quantize_weight(params["lm_head"]["w"], 4, 128)
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    tparams = params_from_numpy(params, "cpu", torch.float32)
    assert tmk.supports(tcfg, trt, tparams)
    plan = tmk.make_plan(tcfg, trt, tparams)
    assert plan.lm.N == (384,) and plan.lm.Np == (512,)
    assert tmk.cuda_kernel_gaps(plan) == []
    assert tmk.cuda_kernel_gaps(dataclasses.replace(
        plan, lm=dataclasses.replace(plan.lm, N=(320,))))
    packed = tmk.pack_params(tcfg, plan, tparams)
    lm = packed["lm_head"]
    assert lm["w_f"].shape == (2, 4, 64 * 128) and lm["scale"].shape[-1] == 512
    raw = tmk.loader_view(lm)
    from dashinfer_tpu_torch.ops.u4pack import weight_levels
    levels = weight_levels(raw["w_q"])
    assert not levels[:, 384:].any() and not lm["scale"][:, 384:].any() and \
        not lm["zero"][:, 384:].any()
    np.testing.assert_array_equal(
        levels[:, :384].numpy(),
        weight_levels(tparams["lm_head"]["w_q"]).numpy())
    unpadded = dict(packed, lm_head=tparams["lm_head"])
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    B, L = trt.max_batch, tcfg.num_layers
    pt = (1 + torch.arange(B * trt.max_pages_per_seq, dtype=torch.int32)
          ).reshape(B, -1)
    lens = torch.zeros(B, dtype=torch.int32)
    x0 = tparams["embed_tokens"]["w"][torch.tensor([7, 11, 13, 5])] \
        .to(torch.bfloat16)
    cos, sin = tsteps._rope_tiles(tcfg, lens)
    out = [tmk.decode_megakernel(
        plan, pk, x0, cos, sin, pt, lens, torch.ones(B, dtype=torch.bool),
        create_kv_cache(tcfg, trt.cache, 64 * L, torch.float32, "cpu"))
        for pk in (packed, unpadded)]
    assert out[0].shape == (B, 384)
    assert torch.equal(out[0], out[1])


def test_padded_expert_leaves_keep_the_true_width():
    """An expert width of 128 mod 256 (Qwen1.5-MoE's 1408; 384 here): the
    install re-lays the stacks out padded to 512 columns in place of the
    loader's (`prepare_grouped_experts`). The plan still takes the model's
    widths from them, and the pack made from the padded leaves equals the
    pack made from the loader's: the payload byte for byte, the qparams in
    the true columns (the install pads scale with ones as the JAX package
    does, the pack with zeros; a padded column's levels are 0 either way)."""
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as tgqm
    cfg, rt, params = _tiny_moe(KH=2, H=2, Im=384)
    params = _np_tree(quantize_params(params, QuantConfig(mode="a16w4",
                                                          group_size=128)))
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    raw = params_from_numpy(params, "cpu", torch.float32)
    padded = tgqm.prepare_grouped_experts(
        params_from_numpy(params, "cpu", torch.float32), tcfg)
    ex = padded["layers"]["experts"]
    assert ex["gate_proj"]["w_q"].shape[-1] == 256 and \
        ex["gate_proj"]["scale"].shape[-1] == 512
    plans = [tmk.make_plan(tcfg, trt, p) for p in (raw, padded)]
    assert plans[0] == plans[1]
    plan = plans[1]
    assert plan.gu.N == (384, 384) and plan.gu.Np == (512, 512) and \
        plan.dn.N == (256,) and plan.inter == 384
    assert tmk.cuda_kernel_gaps(plan) == []
    packs = [tmk.pack_params(tcfg, plan, p)["layers"] for p in (raw, padded)]
    for n in ("experts.gate_proj", "experts.up_proj", "experts.down_proj"):
        assert torch.equal(packs[0][n]["w_f"], packs[1][n]["w_f"]), n
        N = 384 if n != "experts.down_proj" else 256
        for key in ("scale", "zero"):
            assert torch.equal(packs[0][n][key][..., :N],
                               packs[1][n][key][..., :N]), (n, key)


def test_target_pages_is_build_schedules_tgt_page():
    pt = np.arange(12, dtype=np.int32).reshape(3, 4)
    lens = np.asarray([17, 0, 33], np.int32)
    *_, tgt = jmk.build_schedule(jnp.asarray(pt), jnp.asarray(lens),
                                 jnp.asarray([True, False, True]), 16)
    got = tmk.target_pages(torch.from_numpy(pt), torch.from_numpy(lens), 16)
    np.testing.assert_array_equal(np.asarray(tgt), got.numpy())


def _unpack_kv(a, mode):
    a = np.asarray(a)
    if mode == "uint4":
        return np.concatenate([a & 0xF, a >> 4], axis=-1).astype(np.int32)
    return a.astype(np.int32 if mode == "int8" else np.float32)


# Tolerances. Logits: both sides round x_norm, q, attn_out and the SwiGLU
# activation to bf16 at the same points, apply the weight qparams rounded
# to bf16 (the JAX pack stores them so) and keep f32 sums; they differ in
# the order of those sums: max|d| <= 1e-2 * max|ref| over the active rows,
# and the same argmax. Written pool rows: integer payload at most one level
# apart, float payload and qparams within 2e-2 * max|ref|; every other pool
# element exactly equal.
LOGITS_RTOL = 1e-2
QPARAM_RTOL = 2e-2


@pytest.mark.parametrize("quant,mode", [
    ("none", "default"), ("none", "int8"), ("a16w4", "int8"),
    ("a16w8", "uint4"), ("a16w4i8", "int8")])
def test_decode_megakernel_ref_matches_pallas_interpret(quant, mode):
    kh = 2 if mode == "uint4" else 1
    expand = quant == "a16w4i8"
    cfg, rt, params = _quantized_fixture("a16w4" if expand else quant, False,
                                         False, 16, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    if expand:
        params = jmk.expand_u4_to_i8(params)
    _check_against_pallas(cfg, rt, params, mode, np.asarray([17, 16, 5, 0]),
                          np.asarray([1, 1, 1, 0]), np.asarray([7, 11, 13, 0]))


@pytest.mark.parametrize("quant,shared,shared_gate,kh", [
    ("a16w4", True, True, 2),       # Qwen1.5-MoE's layout, one q head a KV head
    ("none", False, False, 1),
    ("a16w8", True, False, 2)])
def test_decode_megakernel_ref_moe_matches_pallas_interpret(quant, shared,
                                                            shared_gate, kh):
    """The MoE branch (router, routed experts, shared expert) of the plain
    version against the interpret-mode TPU kernel, at the tolerances below;
    the two route with the same bf16 router product and agree on every
    row's experts here."""
    cfg, rt, params = _tiny_moe(KH=kh, H=2, shared=shared,
                                shared_gate=shared_gate, norm_topk=not shared)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    _check_against_pallas(cfg, rt, params, "int8", np.asarray([17, 9, 0]),
                          np.asarray([1, 1, 0]), np.asarray([7, 11, 0]))


def _check_against_pallas(cfg, rt, params, mode, lens, active, tokens,
                          lora=None):
    """`lora`: (the JAX LoraManager, each row's slot, the port's pool
    dtype) for the kernels' LoRA branches; returns then how far the
    adapters move the port's logits (max over the rows on a slot, in
    shares of max|ref|)."""
    lens, active, tokens = (a.astype(np.int32) for a in (lens, active,
                                                         tokens))
    assert jmk.supports(cfg, rt, params)
    jplan = jmk.make_plan(cfg, rt, params, target_chunk_bytes=64 * 1024,
                          interleave_mlp=True)
    jpacked = jmk.pack_params(cfg, jplan, params)
    nr = rt.lora_max_num * rt.lora_max_rank if lora is not None else 0
    fn = jmk.build_decode_megakernel(jplan, interpret=True, lora_nr=nr)
    lora_args = None
    if lora is not None:
        # the JAX runtime's masks (engine/steps.py build_decode_step)
        jm, lidx = lora[0], lora[1]
        assert jmk.supports_lora_epilogue(jplan)
        onehot = (lidx[:, None] == np.arange(rt.lora_max_num)[None]
                  ).astype(np.float32)
        nrp = -(-nr // 128) * 128
        mask1 = np.zeros((rt.max_batch, nrp), np.float32)
        mask1[:, :nr] = np.repeat(onehot, rt.lora_max_rank, axis=1)
        lora_args = dict(jm.build_mega_view(jplan), lmask1=jnp.asarray(mask1),
                         lmask3=jnp.asarray(np.tile(mask1, (1, 3))))

    B, L, ps = rt.max_batch, cfg.num_layers, rt.cache.page_size
    maxP = rt.max_pages_per_seq
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    jcache = _prep_cache(cfg, rt, params, JMode(mode), lens, pt)
    pools = [jcache.k, jcache.v]
    if jcache.k_qparams is not None:
        pools += [jcache.k_qparams, jcache.v_qparams]
    before = [np.asarray(p).copy() for p in pools]

    # the JAX side, as engine/steps.py `_megakernel_forward` calls it
    from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
    H, KH = cfg.num_heads, cfg.num_kv_heads
    x0 = params["embed_tokens"]["w"][jnp.asarray(tokens)].astype(jnp.bfloat16)
    cos, sin = j_rope_tiles(cfg, False, jnp.asarray(lens))
    sb, sp_, ns, tgt = jmk.build_schedule(
        jnp.asarray(pt), jnp.asarray(lens), jnp.asarray(active > 0), ps)
    outs = fn(jpacked, x0, jnp.tile(cos, (1, H)), jnp.tile(sin, (1, H)),
              jnp.tile(cos, (1, KH)), jnp.tile(sin, (1, KH)),
              jnp.asarray(pt), jnp.asarray(lens), jnp.asarray(active), tgt,
              sb, sp_, ns, *[jnp.asarray(b) for b in before], lora=lora_args)
    ref_logits = np.asarray(outs[0])[:, :cfg.vocab_size]
    ref_pools = [np.asarray(o) for o in outs[1:]]

    # the port, from the same numpy arrays
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    assert tmk.supports(tcfg, trt, tparams)
    plan = tmk.make_plan(tcfg, trt, tparams)
    packed = tmk.pack_params(tcfg, plan, tparams)
    assert plan.qkv.bits == jplan.qkv.bits and plan.lm.bits == jplan.lm.bits
    assert (plan.E, plan.k_top) == (jplan.E, jplan.k_top)
    assert not plan.E or plan.EP == jplan.EP
    tp = [torch.from_numpy(b.copy()) for b in before]
    if len(tp) == 4:            # the JAX pool pads qparam lanes to 128
        tp[2], tp[3] = (t[..., :ps].contiguous() for t in tp[2:])
    cache = TKVCache(tp[0], tp[1], *(tp[2:] if len(tp) == 4
                                     else (None, None)))
    tbefore = [t.clone() for t in tp]
    lens_t = torch.from_numpy(lens)
    x0_t = tparams["embed_tokens"]["w"][torch.from_numpy(tokens).long()] \
        .to(torch.bfloat16)
    tcos, tsin = tsteps._rope_tiles(tcfg, lens_t)
    np.testing.assert_array_equal(
        np.asarray(cos.astype(jnp.float32)), tcos.float().numpy())
    lkw = {}
    if lora is not None:
        from dashinfer_tpu_torch.lora.manager import from_jax_pool
        lkw = dict(lora=from_jax_pool(lora[0].pool, getattr(torch, lora[2])),
                   lora_idx=torch.from_numpy(lora[1]))
        dense = tmk.decode_megakernel(
            plan, packed, x0_t, tcos, tsin, torch.from_numpy(pt), lens_t,
            torch.from_numpy(active > 0), cache.clone()).numpy()
    logits = tmk.decode_megakernel(
        plan, packed, x0_t, tcos, tsin, torch.from_numpy(pt), lens_t,
        torch.from_numpy(active > 0), cache, **lkw).numpy()

    for b in range(B):
        if not active[b]:
            continue
        ref = ref_logits[b]
        assert np.abs(logits[b] - ref).max() <= \
            LOGITS_RTOL * np.abs(ref).max(), (b, mode)
        assert int(np.argmax(logits[b])) == int(np.argmax(ref)), b

    after = [t.numpy() for t in tp]
    written = np.zeros(after[0].shape[:2], bool)
    for b in range(B):
        if not active[b]:
            continue
        g, off = pt[b, lens[b] // ps], int(lens[b] % ps)
        for l in range(L):
            row = g * L + l
            written[row, off] = True
            for i in (0, 1):                       # K and V payload
                got = _unpack_kv(after[i][row, off], mode)
                want = _unpack_kv(ref_pools[i][row, off], mode)
                if mode == "default":
                    assert np.abs(got - want).max() <= \
                        QPARAM_RTOL * np.abs(want).max()
                else:
                    assert np.abs(got - want).max() <= 1, (b, l, i)
            for i in range(2, len(after)):         # qparams column `off`
                got, want = after[i][row, :, off], ref_pools[i][row, :, off]
                assert np.abs(got - want).max() <= \
                    QPARAM_RTOL * np.abs(want).max(), (b, l, i)
    # everything else is untouched (inactive slots' pages included)
    for i, (a, b0) in enumerate(zip(after, tbefore)):
        b0 = b0.numpy()
        if i < 2:
            keep = ~written
            np.testing.assert_array_equal(a[keep], b0[keep])
        else:
            keep = ~np.broadcast_to(written[:, None, :], a.shape)
            np.testing.assert_array_equal(a[keep], b0[keep])
            np.testing.assert_array_equal(a[keep],
                                          ref_pools[i][..., :ps][keep])
    if lora is not None:
        rows = (active > 0) & (lora[1] >= 0)
        return float(np.abs(logits[rows] - dense[rows]).max() /
                     np.abs(ref_logits[rows]).max())


def test_new_token_is_attended_unquantized():
    """The megakernel attends the new token from its f32 K/V; the per-op
    path appends the quantized token first. With a coarse UINT4 pool the
    two must differ, and the plain version must side with the megakernel
    semantics: zeroing the pool row it wrote does not change its logits."""
    cfg, rt, params = _quantized_fixture("none", False, False, 16, 2)
    tcfg, trt = port_config(cfg), _port_rt(rt, "uint4")
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(tcfg, trt, tparams)
    packed = tmk.pack_params(tcfg, plan, tparams)
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    B, L = trt.max_batch, tcfg.num_layers
    cache = create_kv_cache(tcfg, trt.cache, 64 * L, torch.float32, "cpu")
    pt = (1 + torch.arange(B * trt.max_pages_per_seq, dtype=torch.int32)
          ).reshape(B, -1)
    lens = torch.zeros(B, dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)
    x0 = tparams["embed_tokens"]["w"][torch.tensor([7, 11, 13, 5])] \
        .to(torch.bfloat16)
    cos, sin = tsteps._rope_tiles(tcfg, lens)
    got = tmk.decode_megakernel(plan, packed, x0, cos, sin, pt, lens, active,
                                cache)
    assert cache.k[pt[0, 0].item() * L].any()        # the token was written
    from dashinfer_tpu_torch.models import transformer as ttr
    per_op, _ = ttr.decode_forward(
        tcfg, tparams, torch.tensor([7, 11, 13, 5]),
        create_kv_cache(tcfg, trt.cache, 64 * L + 1, torch.float32, "cpu"),
        pt, lens, active, mode=TMode.UINT4)
    assert (got - per_op).abs().max() > 1e-4


def _kernel_address(bits, w, lane, s, nt, i, half, p):
    """Where csrc/di_product.cuh reads, within a packed chunk, the payload
    element of k16 step s, n8 tile nt, row half i, column half, row p for
    lane (gid, tig) of warp w (element offset)."""
    if bits == 4:
        q, el, per = s >> 1, (((s & 1) * 2 + nt) * 2 + i) * 2 + p, 16
    elif bits == 8:
        q, el, per = s, ((nt * 2 + i) * 2 + half) * 2 + p, 16
    else:
        q, el, per = 2 * s + nt, (i * 2 + half) * 2 + p, 8
    quarters = {4: 2, 8: 4, 16: 8}[bits]
    return w * quarters * 32 * per + q * 32 * per + lane * per + el


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_pack_payload_is_the_kernels_fragment_order(bits):
    """pack_payload puts the element of row 16 s + 8 i + 2 tig + p, column
    256 T + 128 half + 16 w + 8 nt + gid (a u4 byte holds both halves) where
    the kernel's lane (gid, tig) of warp w reads it, and unpack_payload is
    its inverse."""
    units = 128 if bits == 4 else 256
    K, T = 128, 2
    idx = torch.arange(K * T * units, dtype=torch.int32).reshape(K, T * units)
    dt = {4: torch.uint8, 8: torch.int8, 16: torch.bfloat16}[bits]
    # pack the index map through the same permutation (as three byte planes
    # for the narrow dtypes)
    planes = [((idx >> (7 * j)) & 0x7F).to(dt) for j in range(3)]
    packed = [tmk.pack_payload(pl) for pl in planes]
    for pl, pk in zip(planes, packed):
        assert pk.shape == (T, K // 64, 64 * units) and pk.is_contiguous()
        assert torch.equal(tmk.unpack_payload(pk), pl)
    got = sum(pk.to(torch.int32) << (7 * j) for j, pk in enumerate(packed))
    rng = np.random.RandomState(bits)
    for _ in range(400):
        t, c, w, lane = (rng.randint(n) for n in (T, K // 64, 8, 32))
        s, nt, i, half, p = (rng.randint(n) for n in (4, 2, 2, 2, 2))
        gid, tig = lane >> 2, lane & 3
        row = 64 * c + 16 * s + 8 * i + 2 * tig + p
        col = units * t + 16 * w + 8 * nt + gid + (128 * half if bits != 4
                                                   else 0)
        addr = _kernel_address(bits, w, lane, s, nt, i, half, p)
        assert int(got[t, c, addr]) == int(idx[row, col])


def test_packed_leaf_keeps_narrow_leaves_and_ref_reads_both():
    gen = torch.Generator().manual_seed(5)
    wide = {"w_q": torch.randint(0, 256, (128, 128), dtype=torch.uint8,
                                 generator=gen),
            "scale": torch.rand((1, 256), generator=gen) * 0.01,
            "zero": torch.rand((1, 256), generator=gen) * -0.05}
    narrow = {"w": torch.randn((96, 64), generator=gen)}
    pw, pn = tmk.packed_leaf(wide), tmk.packed_leaf(narrow)
    assert set(pw) == {"w_f", "scale", "zero"} and pw["scale"] is wide["scale"]
    assert set(pn) == {"w"} and pn["w"].dtype == torch.bfloat16
    x = torch.randn((3, 128), generator=gen).to(torch.bfloat16)
    assert torch.equal(tmk.leaf_dot(x, pw), tmk.leaf_dot(x, wide))
    assert torch.equal(tmk.loader_view(pw)["w_q"], wide["w_q"])


def test_phase_times_reads_a_trace():
    cfg, rt, params = _tiny()
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(port_config(cfg), _port_rt(rt, "default"), tparams)
    n = tmk.trace_len(plan)
    assert n == 2 * (10 * plan.L + 3) + 1     # ten barriers a layer
    # phase p works 3 ns and waits 1 ns
    t = torch.tensor([0] + [v for p in range((n - 1) // 2)
                            for v in (4 * p + 3, 4 * p + 4)])
    times = tmk.phase_times(plan, t)
    assert set(times) == set(tmk.LAYER_PHASES + tmk.TAIL_PHASES) | {"total"}
    assert times["qkv"]["work"] == pytest.approx(plan.L * 3e-6)
    assert times["lm_head"]["wait"] == pytest.approx(1e-6)
    assert times["total"]["work"] == pytest.approx(4 * (n - 1) // 2 * 1e-6)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_moe_forced_routing_of_its_own_choice_changes_nothing(norm_topk):
    """`decode_megakernel_ref(..., forced_routing=)` (the routing a card
    check hands it from `kernel_routing`: each layer's experts per row, in
    ascending order) given the plain version's own routing gives its
    unforced logits and pool exactly; a routing that differs changes
    them. `resid_norms` receives each layer's residual RMS."""
    cfg, rt, params = _tiny_moe(KH=2, H=2, shared=True, shared_gate=True,
                                norm_topk=norm_topk)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(tcfg, trt, tparams)
    packed = tmk.pack_params(tcfg, plan, tparams)
    B, L, maxP = rt.max_batch, cfg.num_layers, rt.max_pages_per_seq
    lens = torch.tensor([17, 9, 3, 0][:B], dtype=torch.int32)
    active = lens > 0
    pt = (1 + torch.arange(B * maxP, dtype=torch.int32)).reshape(B, maxP)
    cache = create_kv_cache(tcfg, trt.cache, rt.cache.num_pages * L,
                            torch.float32, "cpu")
    g = torch.Generator().manual_seed(3)
    cache.k.view(torch.uint8).random_(0, 256, generator=g)
    cache.v.view(torch.uint8).random_(0, 256, generator=g)
    cache.k_qparams.uniform_(0.004, 0.008, generator=g)
    cache.v_qparams.uniform_(0.004, 0.008, generator=g)
    x0 = tparams["embed_tokens"]["w"][torch.arange(1, B + 1)].to(
        torch.bfloat16)
    cos, sin = tsteps._rope_tiles(tcfg, lens)
    args = (plan, packed, x0, cos, sin, pt, lens, active)
    routing, c0 = [], cache.clone()
    want = tmk.decode_megakernel_ref(*args, c0, routing=routing)
    own = torch.stack([torch.nonzero(tmk.route(plan, lg)[0] > 0)[:, 1]
                       .reshape(B, plan.k_top) for lg in routing])
    assert own.shape == (L, B, plan.k_top)
    c1, norms = cache.clone(), []
    got = tmk.decode_megakernel_ref(*args, c1, forced_routing=own,
                                    resid_norms=norms)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # each layer's residual RMS entering it, the first the embedding's
    assert len(norms) == L and norms[0].shape == (B,)
    torch.testing.assert_close(norms[0], x0.float().pow(2).mean(-1).sqrt())
    for a, b in ((c1.k, c0.k), (c1.v, c0.v), (c1.k_qparams, c0.k_qparams)):
        assert torch.equal(a, b)
    other = own.clone()
    other[0, 0] = torch.tensor([e for e in range(plan.E)
                                if e not in own[0, 0].tolist()][:plan.k_top])
    moved = tmk.decode_megakernel_ref(*args, cache.clone(),
                                      forced_routing=other)
    assert not torch.equal(moved[0], want[0])
    torch.testing.assert_close(moved[1:], want[1:], rtol=0, atol=0)
