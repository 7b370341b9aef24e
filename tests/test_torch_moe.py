"""The port's MoE block and a tiny Qwen2-MoE model against the JAX package,
on the CPU: `moe_block` on its ragged route and on its grouped route (the
JAX package's `DI_MOE_GROUPED=1`, its Pallas kernel in interpret mode; the
port's plain version), the dispatch rules, the f32 router, and
decode_forward / prefill_forward of tests/test_megakernel.py's `_tiny_moe`
(one query head a KV head), from the same numpy arrays."""

import dataclasses
import functools
import types

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
from dashinfer_tpu.ops import moe as jmoe
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import moe as tmoe
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as t_create
from tests.test_megakernel import _tiny_moe
from tests.test_torch_transformer import _assert_pools_close, port_config

PS = 16


@functools.lru_cache(maxsize=None)
def _model(quant: str, shared: bool = True, KH: int = 2):
    cfg, rt, params = _tiny_moe(KH=KH, H=2, shared=shared,
                                shared_gate=shared, norm_topk=not shared)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    return cfg, rt, jax.tree.map(np.asarray, params)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# moe_block: the ragged routes compute the same f32 products of the same
# dequantized f32 stacks (order of sums aside): |d| <= 1e-5 * max|ref|; with
# a quantized shared expert its large-M product rounds x to bf16, where a
# last-bit f32 difference moves an operand by one bf16 step: 1e-3. The
# grouped routes round x and h to bf16 for the dot and their outputs to
# bf16 (the JAX kernel's out_dtype), and combine in bf16: one or two bf16
# steps, |d| <= 2e-2 * max|ref|.
@pytest.mark.parametrize("quant,route", [("a16w4", "ragged"),
                                         ("a16w8", "ragged"),
                                         ("none", "ragged"),
                                         ("a16w4", "grouped"),
                                         ("a16w8", "grouped")])
def test_moe_block_matches_jax(quant, route, monkeypatch):
    cfg, _, params = _model(quant)
    lp = _layer0(params["layers"])
    if route == "grouped":
        monkeypatch.setenv("DI_MOE_GROUPED", "1")
    x = np.random.RandomState(4).randn(9, cfg.hidden_size).astype(
        np.float32) * 0.5
    want = np.asarray(jmoe.moe_block(
        cfg, jnp.asarray(x), jax.tree.map(jnp.asarray, lp)))
    tlp = params_from_numpy(lp, "cpu", torch.float32)
    assert tmoe._use_grouped(tlp, torch.zeros(1)) == (route == "grouped")
    got = tmoe.moe_block(port_config(cfg), torch.from_numpy(x), tlp).numpy()
    rtol = 2e-2 if route == "grouped" else (1e-5 if quant == "none"
                                            else 1e-3)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        np.abs(got - want).max()


def test_dispatch_rules(monkeypatch):
    """Off the card the JAX package's off-TPU route: ragged, or grouped
    with DI_MOE_GROUPED=1; DI_MOE_GROUPED=0 turns the kernel off anywhere;
    a stack the grouped kernel cannot tile (u4 of 128 mod 256 columns not
    padded by the install) stays ragged off the card and raises on it. The
    router and the shared gate keep the tree's f32 in a bf16 model."""
    cfg, _, params = _model("a16w4")
    lp = params_from_numpy(_layer0(params["layers"]), "cpu", torch.bfloat16)
    assert lp["router"]["w"].dtype == torch.float32
    assert lp["shared_expert_gate"]["w"].dtype == torch.float32
    assert lp["q_proj"]["b"].dtype == torch.bfloat16
    x = torch.zeros(1)
    assert not tmoe._use_grouped(lp, x)
    monkeypatch.setenv("DI_MOE_GROUPED", "1")
    assert tmoe._use_grouped(lp, x)
    monkeypatch.setenv("DI_MOE_GROUPED", "0")
    assert not tmoe._use_grouped(lp, x)
    monkeypatch.setenv("DI_MOE_GROUPED", "1")
    narrow = dict(lp, experts=dict(lp["experts"], gate_proj={
        "w_q": torch.zeros((4, 256, 96), dtype=torch.uint8),
        "scale": torch.ones((4, 2, 192)), "zero": torch.zeros((4, 2, 192))}))
    assert not tmoe._use_grouped(narrow, x)
    # on the card such a stack raises instead (no quiet plain route), unless
    # DI_MOE_GROUPED=0 asks for the ragged route; bf16 stacks take it too
    on_card = types.SimpleNamespace(is_cuda=True)
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("DI_MOE_GROUPED")
        else:
            monkeypatch.setenv("DI_MOE_GROUPED", env)
        assert tmoe._use_grouped(lp, on_card)
        with pytest.raises(ValueError, match="gate_proj"):
            tmoe._use_grouped(narrow, on_card)
    monkeypatch.setenv("DI_MOE_GROUPED", "0")
    assert not tmoe._use_grouped(narrow, on_card)
    monkeypatch.delenv("DI_MOE_GROUPED")
    raw = params_from_numpy(_layer0(_model("none")[2]["layers"]), "cpu",
                            torch.bfloat16)
    assert not tmoe._use_grouped(raw, on_card)


@pytest.mark.parametrize("quant,route", [("a16w4", "ragged"),
                                         ("a16w4", "grouped"),
                                         ("a16w8", "grouped")])
def test_padded_experts_compute_the_same(quant, route, monkeypatch):
    """Expert stacks of 128 mod 256 columns (384) re-laid out padded to 512
    by the install, in place of the loader's: the ragged route drops the
    padded columns and gives what the loader's leaves give (|d| <= 1e-6 *
    max|ref|: the same f32 values, other sums); the grouped route (its
    plain version, DI_MOE_GROUPED=1) takes them where it could not take the
    loader's u4 leaves, and matches the JAX package's grouped route on its
    padded copy (interpret mode) within the grouped tolerance above."""
    import copy
    from dashinfer_tpu.ops.pallas import grouped_quant_matmul as jgqm
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as tgqm
    cfg, _, params = _tiny_moe(KH=2, H=2, Im=384)
    params = jax.tree.map(np.asarray, quantize_params(
        params, QuantConfig(mode=quant, group_size=128)))
    tcfg = port_config(cfg)
    lp = _layer0(params["layers"])
    padded = _layer0(tgqm.prepare_grouped_experts(
        copy.deepcopy(params), tcfg)["layers"])
    assert padded["experts"]["up_proj"]["scale"].shape[-1] == 512
    x = np.random.RandomState(5).randn(7, cfg.hidden_size).astype(
        np.float32) * 0.5
    tx = torch.from_numpy(x)
    tpad = params_from_numpy(padded, "cpu", torch.float32)
    if route == "ragged":
        want = tmoe.moe_block(tcfg, tx, params_from_numpy(
            lp, "cpu", torch.float32)).numpy()
        rtol = 1e-6
    else:
        monkeypatch.setenv("DI_MOE_GROUPED", "1")
        assert tmoe._use_grouped(tpad, tx)
        jlp = _layer0(jgqm.prepare_grouped_experts(copy.deepcopy(params),
                                                   cfg)["layers"])
        want = np.asarray(jmoe.moe_block(cfg, jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, jlp)))
        rtol = 2e-2
    got = tmoe.moe_block(tcfg, tx, tpad).numpy()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        np.abs(got - want).max()


def test_check_supported_lets_moe_through():
    cfg, _, _ = _model("none")
    tcfg = port_config(cfg)
    ttr.check_supported(tcfg)
    with pytest.raises(NotImplementedError):
        ttr.check_supported(dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, mlp_only_layers=(0,))))
    # Qwen3-MoE's QK-norm is ported (the JAX per-op path runs it): admitted
    ttr.check_supported(dataclasses.replace(tcfg, qk_norm=True))


@pytest.mark.parametrize("quant,shared,KH", [("a16w4", True, 2),
                                             ("none", False, 1)])
def test_tiny_qwen2_moe_forward_matches_jax(quant, shared, KH):
    """Prefill a 10-token prompt, then 3 decode steps with 2 slots (slot 1
    inactive), INT8 KV, both on the ragged route in f32: logits max|d| <=
    1e-4 * max|ref|; with a16w4 1e-2 (the large-M products of q/k/v/o and of
    the shared expert round their operand to bf16, so a last-bit f32
    difference moves an operand by one bf16 step, and a MoE layer has seven
    such products where tests/test_torch_transformer.py's dense model, held
    to 5e-3, has them too but not the experts' gates that weigh them: 6.5e-3
    was read), the same argmax; the pools' payload within one level, their
    qparams within the same bound, 2e-2 of the pool's largest with a16w4
    (the deeper layer quantizes those activations: 1.1e-2 was read)."""
    cfg, _, params = _model(quant, shared, KH)
    mode = "int8"
    tcfg = port_config(cfg)
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
    rtol = 1e-2 if quant != "none" else 1e-4
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
    _assert_pools_close(jc, tc, mode, 2e-2 if quant != "none" else rtol)
