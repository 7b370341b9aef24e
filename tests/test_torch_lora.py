"""The port's LoRA serving against the JAX package's, on the CPU: the
adapter pool and its errors, the PEFT reader (the port's own .safetensors
reader and the .bin one), the plain delta functions, the per-op forwards
with adapters, the decode megakernel's plain version with its LoRA branch
against the Pallas kernel in interpret mode, and the Engine (tests of the
Engine: tests/test_torch_lora_engine.py). Inputs are numpy arrays made
from a seed, handed to both packages."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.hf_util as hf_util
from dashinfer_tpu.config import CacheConfig as JCacheCfg
from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.lora import manager as jlm
from dashinfer_tpu.models import transformer as jtr
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.config import RuntimeConfigBuilder
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.lora import manager as tlm
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as t_create
from tests.test_torch_transformer import (PS, _assert_pools_close,
                                          port_config, tiny_qwen2)

RANK, ALPHA = 4, 8.0


def adapter(cfg, seed, rank=RANK, std=0.3, targets=tlm.TARGETS):
    """PEFT-layout tensors {(layer, target, "A" | "B"): f32 array}, strong
    enough to move a tiny model's greedy tokens."""
    rng = np.random.RandomState(seed)
    out = {}
    for l in range(cfg.num_layers):
        for t in targets:
            i, o = tlm._dims(cfg, t)
            out[(l, t, "A")] = rng.randn(rank, i).astype(np.float32) * std
            out[(l, t, "B")] = rng.randn(o, rank).astype(np.float32) * std
    return out


def _rt(jax_side: bool, max_num=2, max_rank=8):
    if jax_side:
        from dashinfer_tpu import RuntimeConfigBuilder as JBuilder
        return JBuilder("m").lora(True, max_num=max_num,
                                  max_rank=max_rank).build()
    return RuntimeConfigBuilder("m").lora(True, max_num=max_num,
                                          max_rank=max_rank).build()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_after_load_equals_jax(dtype):
    """Two adapters (one on q / v only, one on every target, of a smaller
    rank than the pool's) and an unload: the port's pool equals the JAX
    LoraManager's exactly, and `from_jax_pool` carries the JAX pool
    across unchanged."""
    cfg, _ = tiny_qwen2()
    jm = jlm.LoraManager(cfg, _rt(True), dtype=getattr(jnp, dtype))
    tm = tlm.LoraManager(port_config(cfg), _rt(False),
                         dtype=getattr(torch, dtype))
    a = adapter(cfg, 1, targets=("q_proj", "v_proj"))
    b = adapter(cfg, 2, rank=3)
    for m in (jm, tm):
        assert m.load("a", a, alpha=ALPHA, rank=RANK) == 0
        assert m.load("b", b, alpha=6.0, rank=3) == 1
    for which in ("A", "B"):
        for t in tlm.TARGETS:
            np.testing.assert_array_equal(
                _np(jm.pool[which][t]), tm.pool[which][t].float().numpy())
    np.testing.assert_array_equal(_np(jm.pool["scale"]),
                                  tm.pool["scale"].numpy())
    jm.unload("a")
    tm.unload("a")
    carried = tlm.from_jax_pool(jm.pool, getattr(torch, dtype))
    for which in ("A", "B"):
        for t in tlm.TARGETS:
            np.testing.assert_array_equal(
                _np(jm.pool[which][t]), tm.pool[which][t].float().numpy())
            assert torch.equal(carried[which][t], tm.pool[which][t])
    assert torch.equal(carried["scale"], tm.pool["scale"])


def test_manager_errors_as_jax():
    """Name already loaded, pool full, rank above lora_max_rank, unknown
    name: the JAX manager's errors (tests/test_lora.py), and the same from
    both."""
    cfg, _ = tiny_qwen2()
    big = {(0, "q_proj", "A"): np.zeros((32, cfg.hidden_size), np.float32),
           (0, "q_proj", "B"): np.zeros((cfg.num_heads * cfg.head_dim, 32),
                                        np.float32)}
    a = adapter(cfg, 1)
    for m in (jlm.LoraManager(cfg, _rt(True), dtype=jnp.float32),
              tlm.LoraManager(port_config(cfg), _rt(False),
                              dtype=torch.float32)):
        m.load("a", a, alpha=ALPHA, rank=RANK)
        with pytest.raises(ValueError):
            m.load("a", a, alpha=ALPHA, rank=RANK)
        m.load("b", a, alpha=ALPHA, rank=RANK)
        with pytest.raises(RuntimeError):
            m.load("c", a, alpha=ALPHA, rank=RANK)
        assert m.unload("b") and not m.unload("b")
        with pytest.raises(ValueError):
            m.load("d", big, alpha=8.0, rank=32)
        with pytest.raises(KeyError):
            m.index_of("nope")
        assert m.index_of(None) == -1 and m.index_of("a") == 0


def test_slot_reuse_writes_in_place():
    """Unload an adapter and load another into its slot: every pool tensor
    keeps its address (a captured decode graph stays valid) and holds the
    new adapter."""
    cfg, _ = tiny_qwen2()
    m = tlm.LoraManager(port_config(cfg), _rt(False), dtype=torch.bfloat16)
    m.load("x", adapter(cfg, 1), alpha=ALPHA, rank=RANK)
    m.load("keep", adapter(cfg, 2), alpha=ALPHA, rank=RANK)
    ptrs = {(w, t): m.pool[w][t].data_ptr() for w in ("A", "B")
            for t in tlm.TARGETS}
    scale_ptr = m.pool["scale"].data_ptr()
    m.unload("x")
    assert float(m.pool["A"]["q_proj"][:, 0].abs().max()) == 0.0
    y = adapter(cfg, 3)
    assert m.load("y", y, alpha=4.0, rank=RANK) == 0
    assert all(m.pool[w][t].data_ptr() == p for (w, t), p in ptrs.items())
    assert m.pool["scale"].data_ptr() == scale_ptr
    want = torch.tensor(y[(1, "down_proj", "B")].T).to(torch.bfloat16)
    assert torch.equal(m.pool["B"]["down_proj"][1, 0, :RANK], want)
    assert float(m.pool["scale"][0]) == 1.0


# ---------------------------------------------------------------------------
# PEFT checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("safe", [True, False])
def test_peft_reader_equals_jax(tmp_path, safe):
    """A tiny HF Qwen2 wrapped by `peft` (rank 4, alpha 8, all seven
    targets), lora_B set from a seed (peft starts it at zero), saved as
    .safetensors and as .bin: the port's reader gives the JAX reader's
    tensors, alpha and rank exactly, and the pools they load are equal."""
    from peft import LoraConfig, get_peft_model
    hf = hf_util.tiny_qwen2_config()
    model = hf_util.make_torch_model(hf)
    pm = get_peft_model(model, LoraConfig(
        r=RANK, lora_alpha=ALPHA, target_modules=list(tlm.TARGETS),
        lora_dropout=0.0))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in pm.named_parameters():
            if "lora_B" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    pm.save_pretrained(str(tmp_path), safe_serialization=safe)
    names = {p.name for p in tmp_path.iterdir()}
    assert ("adapter_model.safetensors" in names) == safe
    jt, ja, jr = jlm.LoraManager._read_peft(None, str(tmp_path))
    tt, ta, tr = tlm.read_peft(str(tmp_path))
    assert (ta, tr) == (ja, jr) == (ALPHA, RANK)
    assert sorted(tt) == sorted(jt) and len(tt) == 2 * 7 * hf.num_hidden_layers
    for k in jt:
        np.testing.assert_array_equal(np.asarray(jt[k], np.float32), tt[k])
    cfg, _ = tiny_qwen2()
    jm = jlm.LoraManager(cfg, _rt(True), dtype=jnp.float32)
    tm = tlm.LoraManager(port_config(cfg), _rt(False), dtype=torch.float32)
    jm.load("p", str(tmp_path))
    tm.load("p", str(tmp_path))
    for t in tlm.TARGETS:
        np.testing.assert_array_equal(_np(jm.pool["B"][t]),
                                      tm.pool["B"][t].numpy())
    assert float(tm.pool["scale"][0]) == ALPHA / RANK


# ---------------------------------------------------------------------------
# the plain functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(4, 3), (2, 3)])
def test_apply_lora_batch_matches_jax(B, N):
    """N <= B (the one-hot contraction) and N > B (the gather), rows on
    slots and a row without one: f32, within 1e-5 of max|ref|."""
    rng = np.random.RandomState(B)
    x = rng.randn(B, 24).astype(np.float32)
    A = rng.randn(N, 24, 8).astype(np.float32)
    Bm = rng.randn(N, 8, 40).astype(np.float32)
    scale = rng.rand(N).astype(np.float32) + 0.5
    idx = np.asarray([2, -1, 0, 1][:B])
    onehot = (idx[:, None] == np.arange(N)[None]).astype(np.float32)
    want = np.asarray(jlm.apply_lora_batch(*(jnp.asarray(a) for a in (
        x, A, Bm, scale, onehot))))
    got = tlm.apply_lora_batch(*(torch.from_numpy(a) for a in (
        x, A, Bm, scale, onehot))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert not got[1].any()                 # no adapter: a zero delta


@pytest.mark.parametrize("idx", [1, -1])
def test_apply_lora_single_matches_jax(idx):
    rng = np.random.RandomState(7)
    x = rng.randn(6, 24).astype(np.float32)
    A = rng.randn(3, 24, 8).astype(np.float32)
    Bm = rng.randn(3, 8, 40).astype(np.float32)
    scale = rng.rand(3).astype(np.float32) + 0.5
    want = np.asarray(jlm.apply_lora_single(
        *(jnp.asarray(a) for a in (x, A, Bm, scale)), jnp.int32(idx)))
    got = tlm.apply_lora_single(*(torch.from_numpy(a) for a in (
        x, A, Bm, scale)), idx).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30)
    assert (idx >= 0) == bool(np.abs(want).max() > 0)


# ---------------------------------------------------------------------------
# the per-op forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,quant", [("default", None),
                                        ("int8", "a16w4")])
def test_forwards_with_adapters_match_jax(mode, quant):
    """The LoRA hooks of the per-op forwards (tests/test_torch_transformer.py
    's drive): a 10-token prompt prefilled with adapter 1, then 3 decode
    steps of three slots on adapters 1, none and 0. Unquantized, f32:
    logits max|d| <= 1e-4 * max|ref|; a16w4 within 5e-3, same argmax; the
    pools as `_assert_pools_close` holds them. The adapters move the
    logits (against the same forward without them)."""
    cfg, params = tiny_qwen2()
    if quant:
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=32))
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    jm = jlm.LoraManager(cfg, _rt(True), dtype=jnp.float32)
    for i in range(2):
        jm.load(f"a{i}", adapter(cfg, 10 + i), alpha=ALPHA, rank=RANK)
    tpool = tlm.from_jax_pool(jm.pool, torch.float32)
    L = cfg.num_layers
    jc = j_create(cfg, JCacheCfg(page_size=PS, mode=JMode(mode)), L * 8,
                  model_dtype=jnp.float32)
    tc = t_create(tcfg, TCacheCfg(page_size=PS, mode=TMode(mode)), L * 8,
                  torch.float32, "cpu")
    ids = np.random.RandomState(3).randint(1, cfg.vocab_size, 10)
    toks = np.zeros(16, np.int32)
    toks[:len(ids)] = ids
    row = np.asarray([2, 4], np.int32)
    jl, jc = jax.jit(functools.partial(jtr.prefill_forward, cfg,
                                       mode=JMode(mode), use_kernel=False))(
        jparams, jnp.asarray(toks), jc, jnp.asarray(row), jnp.int32(0),
        jnp.int32(len(ids)), lora=jm.pool, lora_idx=jnp.int32(1))
    tl, tc = ttr.prefill_forward(tcfg, tparams, torch.from_numpy(toks), tc,
                                 torch.from_numpy(row), 0, len(ids),
                                 mode=TMode(mode), lora=tpool, lora_idx=1)
    base, _ = ttr.prefill_forward(tcfg, tparams, torch.from_numpy(toks),
                                  t_create(tcfg, TCacheCfg(
                                      page_size=PS, mode=TMode(mode)), L * 8,
                                      torch.float32, "cpu"),
                                  torch.from_numpy(row), 0, len(ids),
                                  mode=TMode(mode))
    rtol = 5e-3 if quant else 1e-4
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= rtol * np.abs(jl).max()
    assert np.abs(base.numpy() - jl).max() > 0.1 * np.abs(jl).max()
    _assert_pools_close(jc, tc, mode, rtol)

    jdec = jax.jit(functools.partial(jtr.decode_forward, cfg,
                                     mode=JMode(mode), use_kernel=False))
    pt = np.stack([row, np.asarray([1, 0], np.int32),
                   np.asarray([5, 0], np.int32)])
    lidx = np.asarray([1, -1, 0], np.int32)
    onehot = (lidx[:, None] == np.arange(2)[None]).astype(np.float32)
    tok = int(np.argmax(jl))
    for i in range(3):
        tokens = np.asarray([tok, 7, 9], np.int32)
        lens = np.asarray([len(ids) + i, 3 + i, 5 + i], np.int32)
        active = np.asarray([True, True, True])
        jl, jc = jdec(jparams, jnp.asarray(tokens), jc, jnp.asarray(pt),
                      jnp.asarray(lens), jnp.asarray(active), lora=jm.pool,
                      lora_onehot=jnp.asarray(onehot))
        tl, tc = ttr.decode_forward(
            tcfg, tparams, torch.from_numpy(tokens), tc,
            torch.from_numpy(pt), torch.from_numpy(lens),
            torch.from_numpy(active), mode=TMode(mode), lora=tpool,
            lora_onehot=torch.from_numpy(onehot))
        jl = np.asarray(jl)
        for b in range(3):
            assert np.abs(tl.numpy()[b] - jl[b]).max() <= \
                rtol * np.abs(jl[b]).max()
            assert int(tl[b].argmax()) == int(np.argmax(jl[b]))
        tok = int(np.argmax(jl[0]))
    _assert_pools_close(jc, tc, mode, rtol)


# ---------------------------------------------------------------------------
# the decode megakernel's LoRA branch (plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_dtype", ["bfloat16", "float32"])
def test_decode_megakernel_ref_lora_matches_pallas_interpret(pool_dtype):
    """The plain version with the LoRA branch against the JAX
    `build_decode_megakernel(plan, interpret=True, lora_nr=...)`, built as
    tests/test_megakernel.py builds it (interleaved plan, INT8 KV), on a
    mixed batch of two adapters on all seven targets [0, -1, 1, -1] (the
    last row inactive), for a bf16 pool (the scale folded into B in bf16,
    as on the card) and an f32 one: logits and pool writes at
    tests/test_torch_megakernel.py's tolerances. The adapters move the
    logits far beyond those."""
    from tests.test_torch_megakernel import _check_against_pallas
    from tests.test_megakernel import _quantized_fixture
    cfg, rt, params = _quantized_fixture("a16w4", False, False, 16, 1)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode.INT8),
        enable_lora=True, lora_max_num=2, lora_max_rank=8)
    jm = jlm.LoraManager(cfg, rt, dtype=getattr(jnp, pool_dtype))
    for i in range(2):
        jm.load(f"a{i}", adapter(cfg, 20 + i, std=0.05 if i else 0.08),
                alpha=16.0, rank=RANK)
    moved = _check_against_pallas(
        cfg, rt, params, "int8", np.asarray([17, 16, 5, 0]),
        np.asarray([1, 1, 1, 0]), np.asarray([7, 11, 13, 0]),
        lora=(jm, np.asarray([0, -1, 1, -1], np.int32), pool_dtype))
    assert moved > 0.1


def test_decode_megakernel_ref_all_none_is_the_dense_step():
    """A batch whose rows carry no adapter (and an inactive row on a
    slot): the plain version with the pool gives the dense plain version's
    logits and pool bit for bit."""
    from tests.test_megakernel import _quantized_fixture
    from tests.test_torch_megakernel import _np_tree, _port_rt
    cfg, rt, params = _quantized_fixture("a16w4", False, False, 16, 1)
    tcfg = port_config(cfg)
    trt = _port_rt(dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode.INT8)), "int8")
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    plan = tmk.make_plan(tcfg, trt, tparams)
    packed = tmk.pack_params(tcfg, plan, tparams)
    assert tmk.supports_lora_epilogue(plan, 2, 8)
    m = tlm.LoraManager(tcfg, _rt(False), dtype=torch.bfloat16)
    m.load("a", adapter(cfg, 3), alpha=ALPHA, rank=RANK)
    B = plan.B
    gen = torch.Generator().manual_seed(0)
    cache = t_create(tcfg, trt.cache, (B * plan.maxP + 1) * plan.L + 1,
                     torch.float32, "cpu")
    cache.k.view(torch.uint8).random_(0, 256, generator=gen)
    cache.v.view(torch.uint8).random_(0, 256, generator=gen)
    cache.k_qparams.uniform_(0.004, 0.008, generator=gen)
    cache.v_qparams.uniform_(0.004, 0.008, generator=gen)
    pt = (1 + torch.arange(B * plan.maxP, dtype=torch.int32)).reshape(
        B, plan.maxP)
    lens = torch.tensor([17, 16, 5, 3][:B], dtype=torch.int32)
    active = torch.tensor([True, True, True, False][:B])
    x0 = torch.randn((B, plan.hid), generator=gen).to(torch.bfloat16)
    cos = torch.randn((B, plan.D), generator=gen).to(torch.bfloat16)
    sin = torch.randn((B, plan.D), generator=gen).to(torch.bfloat16)
    c0, c1 = cache.clone(), cache.clone()
    dense = tmk.decode_megakernel(plan, packed, x0, cos, sin, pt, lens,
                                  active, c0)
    idx = torch.tensor([-1, -1, -1, 0][:B], dtype=torch.int32)
    none = tmk.decode_megakernel(plan, packed, x0, cos, sin, pt, lens,
                                 active, c1, lora=m.pool, lora_idx=idx)
    assert torch.equal(dense, none)
    for k in ("k", "v", "k_qparams", "v_qparams"):
        assert torch.equal(getattr(c0, k), getattr(c1, k))


def test_lora_epilogue_rules():
    """A dense plan takes the LoRA branch for a pool it can read (slots
    and rank in the kernel's limits, the rank a multiple of 8); a MoE plan
    does not (its LoRA batches decode per-op, as in the JAX package); a
    MoE launch with a pool raises."""
    from tests.test_megakernel import _tiny, _tiny_moe
    from tests.test_torch_megakernel import _np_tree, _port_rt
    cfg, rt, params = _tiny()
    plan = tmk.make_plan(port_config(cfg), _port_rt(rt, "default"),
                         params_from_numpy(_np_tree(params), "cpu",
                                           torch.float32))
    assert tmk.supports_lora_epilogue(plan, 4, 16)
    assert not tmk.supports_lora_epilogue(plan, 4, 12)
    assert not tmk.supports_lora_epilogue(plan, 4, 128)
    assert not tmk.supports_lora_epilogue(plan, 65, 16)
    mcfg, mrt, mparams = _tiny_moe(KH=2, H=2)
    mplan = tmk.make_plan(port_config(mcfg), _port_rt(mrt, "default"),
                          params_from_numpy(_np_tree(mparams), "cpu",
                                            torch.float32))
    assert mplan.E and not tmk.supports_lora_epilogue(mplan, 4, 16)
    assert jmk.supports_lora_epilogue(
        jmk.make_plan(cfg, rt, params, interleave_mlp=True))
    with pytest.raises(ValueError):
        tmk.decode_megakernel(mplan, None, torch.zeros(1), None, None, None,
                              None, None, None, lora={}, lora_idx=None)
