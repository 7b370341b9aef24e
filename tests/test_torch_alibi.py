"""ALiBi through the port against the JAX package, on the CPU: the slopes,
the per-op attention with slopes, the per-op forwards of a tiny MHA ALiBi
model whose head count is not a power of two, the decode and prefill
megakernels' plain versions with `slopes` in the pack against the Pallas
kernels in interpret mode, the TP segments' plain versions per rank, the
whole TP decode and prefill and the per-op TP forwards at n = 2 (each rank
with its slice of the global slope table), and the kernels' argument
order.

Tolerances are those of the files whose checks these reuse
(tests/test_torch_megakernel.py, test_torch_prefill_megakernel.py,
test_torch_tp_segments.py, test_torch_tp_prefill_segments.py,
test_torch_tp_decode.py, test_torch_tp_prefill.py,
test_torch_tp_forward.py, test_torch_transformer.py), stated where they
are applied below."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheConfig as JCacheCfg
from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.models import transformer as jtr
from dashinfer_tpu.ops import attention as jattn
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import attention as tattn
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as t_create
from tests import test_torch_megakernel as tm
from tests import test_torch_prefill_megakernel as tpm
from tests.test_megakernel import _quantized_fixture, _tiny
from tests.test_torch_megakernel import _np_tree, _port_rt
from tests.test_torch_qwen3 import _enum
from tests.test_torch_tp_decode import check_tp_decode_against_jax
from tests.test_torch_tp_forward import check_tp_forward_against_jax
from tests.test_torch_tp_prefill import check_tp_prefill_against_jax
from tests.test_torch_tp_prefill_segments import (
    check_prefill_segments_against_jax, prefill_case)
from tests.test_torch_tp_segments import (ACTIVE, LENS, N,
                                          check_segments_against_jax,
                                          pool_shard, port_cache, tp_case)
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import _assert_pools_close, port_config

PS = 16
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "dashinfer_tpu_torch", "csrc")


# ---------------------------------------------------------------------------
# the slopes and the per-op attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", range(1, 65))
def test_alibi_slopes_equal_jax(H):
    """Every head count 1..64 (powers of two and the interleaved extras of
    the others, Baichuan-13B's 40 among them): bit-equal f32."""
    want = np.asarray(jtr.alibi_slopes(H))
    got = ttr.alibi_slopes(H)
    assert got.dtype == torch.float32 and got.shape == (H,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_slopes_on_is_the_cached_slice():
    """`slopes_on`: the heads asked for on the device, one tensor a key (a
    captured forward reads the same one)."""
    full = ttr.alibi_slopes(40)
    a = tattn.slopes_on(40, torch.device("cpu"), 20, 20)
    assert torch.equal(a, full[20:])
    assert a is tattn.slopes_on(40, torch.device("cpu"), 20, 20)
    assert torch.equal(tattn.slopes_on(40, torch.device("cpu")), full)


@pytest.mark.parametrize("mode", ["default", "int8", "uint4"])
def test_paged_attention_ref_with_slopes_matches_jax(mode):
    """Decode attention with ALiBi slopes over a paged pool (H = 6 on KH =
    3, lens up to 40 tokens): the port's `paged_attention_ref` (and its
    dispatch, which takes it for slopes) against the JAX reference, within
    1e-5 of the largest output; without slopes it differs (the bias is
    live)."""
    rng = np.random.RandomState(1)
    B, H, KH, D, ps, P = 3, 6, 3, 128, 16, 12
    Ds = D // 2 if mode == "uint4" else D
    pool_dt = np.float32 if mode == "default" else (
        np.int8 if mode == "int8" else np.uint8)
    if mode == "default":
        k = rng.standard_normal((P, ps, KH * D)).astype(np.float32)
        v = rng.standard_normal((P, ps, KH * D)).astype(np.float32)
    else:
        k = rng.randint(0, 256, (P, ps, KH * Ds)).astype(np.uint8).view(
            pool_dt)
        v = rng.randint(0, 256, (P, ps, KH * Ds)).astype(np.uint8).view(
            pool_dt)
    qp = [rng.uniform(0.01, 0.03, (P, 2 * KH, 128)).astype(np.float32)
          for _ in range(2)] if mode != "default" else [None, None]
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pt = rng.permutation(P)[:9].reshape(B, 3).astype(np.int32)
    lens = np.asarray([40, 17, 1], np.int32)
    slopes = ttr.alibi_slopes(H)
    from dashinfer_tpu.runtime.kv_cache import KVCache as JKVCache
    jc = JKVCache(jnp.asarray(k), jnp.asarray(v),
                  *(None if x is None else jnp.asarray(x) for x in qp))
    want = np.asarray(jattn.paged_attention_ref(
        jnp.asarray(q), jc, JMode(mode), jnp.asarray(pt), jnp.asarray(lens),
        0.088, alibi=jnp.asarray(slopes.numpy())))
    tc = TKVCache(torch.from_numpy(k), torch.from_numpy(v),
                  *(torch.from_numpy(x[..., :ps].copy()) if x is not None
                    else None for x in qp))
    args = (torch.from_numpy(q), tc, TMode(mode), torch.from_numpy(pt),
            torch.from_numpy(lens), 0.088)
    got = tattn.paged_attention_ref(*args, alibi=slopes).numpy()
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    disp = tattn.paged_attention(*args, alibi=slopes).numpy()
    np.testing.assert_array_equal(disp, got)
    plain = tattn.paged_attention_ref(*args).numpy()
    assert np.abs(plain - want).max() > 100 * tol


def test_prefill_attention_with_slopes_matches_jax():
    """Causal prefill attention with slopes (a 9-token prefix, 20 new
    tokens, H = 6 on KH = 2) against the JAX function, within 1e-5 of the
    largest output."""
    rng = np.random.RandomState(2)
    T, S, H, KH, D = 20, 32, 6, 2, 16
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k = rng.standard_normal((S, KH, D)).astype(np.float32)
    v = rng.standard_normal((S, KH, D)).astype(np.float32)
    slopes = ttr.alibi_slopes(H)
    want = np.asarray(jattn.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(9),
        jnp.int32(29), 0.25, alibi=jnp.asarray(slopes.numpy())))
    got = tattn.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 9, 29, 0.25,
                                  alibi=slopes).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the per-op forwards
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mha6(quant):
    """A tiny MHA ALiBi model, H = KH = 6 (slopes of a non-power-of-two
    head count), head_dim 128, f32 or a16w4 group 128."""
    cfg, rt, params = _tiny(B=2, L=2, KH=6, H=6, alibi=True)
    if quant:
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    return cfg, rt, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("mode,quant", [("default", None), ("int8", None),
                                        ("default", "a16w4")])
def test_per_op_prefill_and_decode_match_jax(mode, quant):
    """Prefill one 37-token prompt, then 3 decode steps with 2 slots (slot 1
    inactive), through `prefill_forward` / `decode_forward` of both
    packages in f32 (no RoPE; the slopes of H = 6). Unquantized: logits
    max|d| <= 1e-4 * max|ref| (test_torch_transformer.py's); a16w4: 2e-2,
    the same argmax. Both packages round the activation of each weight
    product to bf16, so a last-bit f32 difference moves an operand by one
    bf16 step; test_torch_transformer.py holds that to 5e-3, but on this
    model its RoPE twin's prefill logits read 5.3e-3 and the ALiBi model's
    1.0e-2 (the slope 0.5 of head 4 puts a row's attention on its last few
    tokens, which averages less of the rounding away); the same rounding
    moves a layer-1 INT8 pool row of this model by 2 levels, so the a16w4
    case keeps a float pool. Pools: payload within one level, float K/V and
    qparams within the logits' bound."""
    cfg, _, params = _mha6(quant)
    tcfg = port_config(cfg)
    ttr.check_supported(tcfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    L = cfg.num_layers
    n_pages = L * 8
    jc = j_create(cfg, JCacheCfg(page_size=PS, mode=JMode(mode)), n_pages,
                  model_dtype=jnp.float32)
    tc = t_create(tcfg, TCacheCfg(page_size=PS, mode=TMode(mode)), n_pages,
                  torch.float32, "cpu")
    n = 37
    ids = np.random.RandomState(3).randint(1, cfg.vocab_size, n)
    toks = np.zeros(48, np.int32)
    toks[:n] = ids
    row = np.asarray([2, 4, 5], np.int32)
    jl, jc = jax.jit(functools.partial(jtr.prefill_forward, cfg,
                                       mode=JMode(mode), use_kernel=False))(
        jparams, jnp.asarray(toks), jc, jnp.asarray(row), jnp.int32(0),
        jnp.int32(n))
    tl, tc = ttr.prefill_forward(tcfg, tparams, torch.from_numpy(toks), tc,
                                 torch.from_numpy(row), 0, n,
                                 mode=TMode(mode))
    rtol = 2e-2 if quant else 1e-4
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= rtol * np.abs(jl).max()
    jdec = jax.jit(functools.partial(jtr.decode_forward, cfg,
                                     mode=JMode(mode), use_kernel=False))
    pt = np.stack([np.asarray([2, 4, 5, 6], np.int32),
                   np.asarray([1, 0, 0, 0], np.int32)])
    tok = int(np.argmax(jl))
    for i in range(3):
        tokens = np.asarray([tok, 7], np.int32)
        lens = np.asarray([n + i, 3], np.int32)
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
    _assert_pools_close(jc, tc, mode, rtol)


def test_per_op_alibi_is_not_the_rope_model():
    """The same weights read as a RoPE model give other logits (the ALiBi
    forward takes the slopes, not the rotation)."""
    cfg, _, params = _mha6(None)
    tcfg = port_config(cfg)
    rope = dataclasses.replace(tcfg, position_embedding=type(
        tcfg.position_embedding).ROPE)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        1, cfg.vocab_size, 32).astype(np.int32))

    def last_logits(c):
        tc = t_create(c, TCacheCfg(page_size=PS), 32, torch.float32, "cpu")
        lg, _ = ttr.prefill_forward(c, tparams, toks, tc,
                                    torch.tensor([1, 2], dtype=torch.int32),
                                    0, 20, mode=TMode.DEFAULT)
        return lg
    a, b = last_logits(tcfg), last_logits(rope)
    assert (a - b).abs().max() > 1e-2 * a.abs().max()


# ---------------------------------------------------------------------------
# the megakernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,mode", [("a16w4", "int8"),
                                        ("a16w8", "uint4"),
                                        ("none", "default")])
def test_decode_megakernel_ref_alibi_matches_pallas(quant, mode):
    """tests/test_torch_megakernel.py's check (logits within 1e-2 of their
    largest and the same argmax; written pool rows within one level, their
    qparams within 2e-2; every other pool element equal) on an ALiBi model
    (H = 2 KH), the pack holding `slopes` [H]."""
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, True, PS, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    tm._check_against_pallas(cfg, rt, params, mode,
                             np.asarray([17, 16, 5, 0]),
                             np.asarray([1, 1, 1, 0]),
                             np.asarray([7, 11, 13, 0]))


@pytest.mark.parametrize("quant,mode,n_tokens", [("a16w4", "int8", 45),
                                                 ("a16w8", "uint4", 128),
                                                 ("none", "default", 33)])
def test_prefill_megakernel_ref_alibi_matches_pallas(quant, mode, n_tokens):
    """tests/test_torch_prefill_megakernel.py's check (logits within 2e-2
    of their largest and the same argmax; the written pool rows within one
    level, their qparams within 1e-3 in layer 0 and 1e-2 deeper; nothing
    else written) on an ALiBi model."""
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, True, PS, kh)
    rt = dataclasses.replace(
        rt, max_length=tpm.BUCKET + PS,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    tpm._check_against_pallas(cfg, rt, params, mode, n_tokens)


@pytest.mark.parametrize("quant,mode,chunk", [("a16w4", "int8", 16),
                                              ("none", "default", 32)])
def test_attention_order_with_slopes_matches_pallas(monkeypatch, quant,
                                                    mode, chunk):
    """The plain decode step with its attention in the kernel's order
    (tests/test_torch_megakernel_geometry.py `attention_chunked`: chunks of
    16 / 32 tokens, one bias origin, the slot's new token, for every chunk)
    on an ALiBi model holds to the interpret-mode TPU kernel at the plain
    version's tolerances (lens 17, 16, 5 cross chunk borders)."""
    from tests.test_torch_megakernel_geometry import attention_chunked
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, True, PS, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    calls = []

    def chunked(*args):
        assert args[-1] is not None          # the slopes
        calls.append(1)
        return attention_chunked(*args, chunk_tokens=chunk,
                                 warp_tokens=min(16, chunk))

    monkeypatch.setattr(tmk, "_attend_ref", chunked)
    tm._check_against_pallas(cfg, rt, params, mode,
                             np.asarray([17, 16, 5, 0]),
                             np.asarray([1, 1, 1, 0]),
                             np.asarray([7, 11, 13, 0]))
    assert len(calls) == cfg.num_layers


def test_alibi_pack_and_plan():
    """The plan carries `alibi` into the prefill plans and the pack key
    (and takes no LoRA branch); the pack's `slopes` are `alibi_slopes(H)`
    f32; the plain decode step
    read as a RoPE plan on the same pack differs (the branch is live); the
    kernels' `slopes` argument is 0 for a RoPE plan and checked for an
    ALiBi one."""
    cfg, rt, params = _quantized_fixture("a16w4", False, True, PS, 1)
    tcfg, trt = port_config(cfg), _port_rt(rt, "int8")
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(tcfg, trt, tparams)
    assert plan.alibi and not plan.has_qkv_bias and not plan.qk_norm
    assert tmk.cuda_kernel_gaps(plan) == []
    packed = tmk.pack_params(tcfg, plan, tparams)
    assert torch.equal(packed["slopes"], ttr.alibi_slopes(plan.H))
    pplan = tpmk.make_prefill_plan(tcfg, trt, tparams, 128, decode_plan=plan)
    assert pplan.alibi
    rope = dataclasses.replace(plan, alibi=False)
    assert tmk.pack_cache_key_fields(plan) != \
        tmk.pack_cache_key_fields(rope)
    # the ALiBi kernel has no LoRA branch: its LoRA batches decode per-op
    assert tmk.supports_lora_epilogue(rope, 2, 8)
    assert not tmk.supports_lora_epilogue(plan, 2, 8)
    assert tmk.slopes_arg(rope, packed, torch.device("cpu"), "t") == 0
    assert tmk.slopes_arg(plan, packed, torch.device("cpu"), "t") == \
        packed["slopes"].data_ptr()
    with pytest.raises(ValueError, match="slopes"):
        tmk.slopes_arg(plan, dict(packed, slopes=packed["slopes"][:1]),
                       torch.device("cpu"), "t")
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
        for p in (plan, rope)]
    assert not torch.allclose(out[0], out[1])


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,mode,KH", [("a16w4", "int8", 2),
                                           ("a16w8", "uint4", 4)])
def test_tp_segments_alibi_match_jax_per_rank(quant, mode, KH):
    """Each rank's attn segment and rank 1's mlp and lm segments (plain)
    against the JAX segments in interpret mode at n = 2 on the ALiBi twin
    of the tiny TP model, test_torch_tp_segments.py's tolerances (partials
    within 1e-2 of their largest over the active rows; written pool rows
    within one level, qparams within 2e-2; every other element equal)."""
    c = tp_case(quant, mode, KH, alibi=True)
    assert c["plan"].alibi and c["jplan"].alibi
    check_segments_against_jax(c)


@pytest.mark.parametrize("quant,mode,KH,n_tokens", [
    ("a16w4", "int8", 2, 45), ("a16w8", "uint4", 4, 128)])
def test_tp_prefill_segments_alibi_match_jax_per_rank(quant, mode, KH,
                                                      n_tokens):
    """Each rank's prefill attn, mlp and lm segments (plain) against the
    JAX segments in interpret mode at n = 2, bucket 128, on the ALiBi twin,
    test_torch_tp_prefill_segments.py's tolerances (the prompt rows'
    partials within 1e-2 of their largest; the pool as above)."""
    c = prefill_case(quant, mode, KH, alibi=True)
    assert c["plan"].alibi and c["jplan"].alibi
    check_prefill_segments_against_jax(c, n_tokens)


@pytest.mark.parametrize("quant,mode,KH", [("a16w4", "int8", 2),
                                           ("none", "uint4", 4)])
def test_tp_decode_ref_alibi_matches_jax_tp_decode_fn(quant, mode, KH):
    """`tp_decode_ref` (the ranks on the CPU) against `build_tp_decode_fn`
    on a (1, 2) CPU mesh on the ALiBi twin, test_torch_tp_decode.py's
    tolerances (logits within 0.05 / 0.08 of each row's largest, the same
    argmax; every rank's pool shard)."""
    check_tp_decode_against_jax(tp_case(quant, mode, KH, alibi=True), quant)


@pytest.mark.parametrize("quant,mode,KH,n_tokens", [
    ("a16w4", "int8", 2, 45), ("a16w8", "uint4", 4, 128)])
def test_tp_prefill_ref_alibi_matches_jax_tp_prefill_fn(quant, mode, KH,
                                                        n_tokens):
    """`tp_prefill_ref` against `build_tp_prefill_fn` on a (1, 2) CPU mesh
    on the ALiBi twin, test_torch_tp_prefill.py's tolerances (last-token
    logits within 2e-2 of their largest, the same argmax; the pool)."""
    check_tp_prefill_against_jax(
        prefill_case(quant, mode, KH, alibi=True),
        tp_fixture(quant, KH=KH, alibi=True)[2], n_tokens)


@pytest.mark.parametrize("quant,mode,KH", [("none", "int8", 2),
                                           ("a16w4", "uint4", 4)])
def test_per_op_tp_forward_alibi_matches_jax_spmd(quant, mode, KH):
    """The per-op TP forwards (each rank with its slice of the global slope
    table) against the JAX SPMD model on a (1, 2) CPU mesh,
    test_torch_tp_forward.py's tolerances (logits within 0.05 / 0.08 of the
    row's largest, the same argmax; every rank's pool shard)."""
    check_tp_forward_against_jax(quant, mode, KH, alibi=True)


def test_rank_slopes_are_the_global_slice():
    """Each rank's pack holds heads r * H/n .. of the GLOBAL table (the JAX
    `make_tp_plan`'s), not `alibi_slopes(H/n)`; rank 1 packed with the local
    table (the planted fault) moves the TP step's logits beyond
    test_torch_tp_decode.py's tolerance against the right packs."""
    c = tp_case("a16w4", "int8", 2, alibi=True)
    plan, packs, cfg = c["plan"], c["packs"], c["cfg"]
    glob = ttr.alibi_slopes(cfg.num_heads)
    Hl = cfg.num_heads // N
    for r in range(N):
        assert torch.equal(packs[r]["slopes"], glob[r * Hl:(r + 1) * Hl])
        want = np.asarray(jax.tree.map(lambda a: a[r], c["jpacked"])
                          ["slopes"])[:, :plan.G].reshape(-1)
        np.testing.assert_array_equal(packs[r]["slopes"].numpy(), want)
    assert not torch.equal(packs[1]["slopes"], ttr.alibi_slopes(Hl))
    bad = [packs[0], dict(packs[1], slopes=ttr.alibi_slopes(Hl))]
    pt, ps, KH, mode = c["pt"], plan.ps, cfg.num_kv_heads, c["mode"]
    tokens = torch.tensor([7, 11, 13, 0])
    x0 = torch.from_numpy(np.asarray(c["params"]["embed_tokens"]["w"]))[
        tokens].to(torch.bfloat16)
    tcos, tsin = tsteps._rope_tiles(c["tcfg"], torch.from_numpy(LENS))
    out = []
    for pk in (packs, bad):
        caches = [port_cache(pool_shard(c["pools"], r, N, KH, mode), ps)
                  for r in range(N)]
        out.append(ttpk.tp_decode_ref(
            plan, pk, x0, tcos, tsin, torch.from_numpy(pt),
            torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0), caches,
            [torch.device("cpu")] * N).numpy())
    rows = np.nonzero(ACTIVE)[0]
    rel = max(np.abs(out[1][b] - out[0][b]).max() / np.abs(out[0][b]).max()
              for b in rows)
    assert rel > 0.08, rel


def test_kernel_arguments_end_with_the_slopes():
    """The wrappers' integer arguments (`_IARGS`) in the order of the
    kernels' `enum IArg`, the slopes' address last."""
    assert _enum(os.path.join(CSRC, "di_layer.cuh")) == \
        [k.lower() for k in tmk._IARGS]
    assert _enum(os.path.join(CSRC, "di_prefill_layer.cuh")) == \
        [k.lower() for k in tpmk._IARGS]
    assert tmk._IARGS[-1] == tpmk._IARGS[-1] == "slopes"
