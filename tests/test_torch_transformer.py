"""decode_forward / prefill_forward: logits and KV pools of the port against
the JAX package on the tiny Qwen2 in f32, with the JAX loader's weights
carried over by params_from_numpy (CPU)."""

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
from dashinfer_tpu.loader import build_from_torch_model
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.models import transformer as jtr
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheConfig as TCacheCfg
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.config import ModelConfig as TModelCfg
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as t_create

PS = 16


@functools.lru_cache(maxsize=None)
def tiny_qwen2():
    hf = hf_util.tiny_qwen2_config()
    cfg, params = build_from_torch_model(hf_util.make_torch_model(hf),
                                         hf.to_dict(), "float32")
    return cfg, params


def port_config(cfg):
    """The JAX ModelConfig's fields, as the port's ModelConfig (a MoE
    config's and the position embedding too)."""
    import dataclasses
    from dashinfer_tpu_torch.config import MoEConfig as TMoECfg
    from dashinfer_tpu_torch.config import PositionEmbedding as TPosEmb
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("activation", "position_embedding",
                            "rope_scaling", "moe")}
    if cfg.moe is not None:
        kw["moe"] = TMoECfg(**dataclasses.asdict(cfg.moe))
    return TModelCfg(**kw, position_embedding=TPosEmb(
        cfg.position_embedding.value))


def _assert_pools_close(jc, tc, mode, rtol):
    """Int payload at most 1 apart (a rounding tie); float K/V and qparams
    within rtol * max|ref| (they follow from activations that differ in the
    last bits; zero = min + 128*scale can cancel, so the bound is on the
    pool's scale, not per element). The port's last page is the sink of
    inactive decode slots, which the JAX package drops instead."""
    if mode == "default":
        for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
            a = np.asarray(a)[:-1]
            assert np.abs(b.numpy()[:-1] - a).max() <= rtol * np.abs(a).max()
        return
    for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
        d = np.asarray(a)[:-1].astype(np.int32) - \
            b.numpy()[:-1].astype(np.int32)
        assert np.abs(d).max() <= 1
    for a, b in ((jc.k_qparams, tc.k_qparams), (jc.v_qparams, tc.v_qparams)):
        a = np.asarray(a)[:-1, :, :PS]
        assert np.abs(b.numpy()[:-1] - a).max() <= rtol * np.abs(a).max()


@pytest.mark.parametrize("mode,quant", [("default", None),
                                        ("int8", "a16w4")])
def test_prefill_and_decode_match_jax(mode, quant):
    """Prefill one 10-token prompt, then 3 decode steps with 2 slots (slot 1
    inactive). Unquantized, all in f32: logits max|d| <= 1e-4 * max|ref|.
    a16w4: both packages round the activation to bf16 for the weight
    product, so a last-bit f32 difference can move an operand by one bf16
    step (2^-8): logits max|d| <= 5e-3 * max|ref|, same argmax."""
    cfg, params = tiny_qwen2()
    if quant:
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=32))
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
    S = 16
    toks = np.zeros(S, np.int32)
    toks[:len(ids)] = ids
    row = np.asarray([2, 4], np.int32)
    jl, jc = jax.jit(functools.partial(jtr.prefill_forward, cfg,
                                       mode=JMode(mode), use_kernel=False))(
        jparams, jnp.asarray(toks), jc, jnp.asarray(row), jnp.int32(0),
        jnp.int32(len(ids)))
    tl, tc = ttr.prefill_forward(tcfg, tparams, torch.from_numpy(toks), tc,
                                 torch.from_numpy(row), 0, len(ids),
                                 mode=TMode(mode))
    rtol = 5e-3 if quant else 1e-4
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= rtol * np.abs(jl).max()
    _assert_pools_close(jc, tc, mode, rtol)

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
    _assert_pools_close(jc, tc, mode, rtol)


def test_unported_architecture_raises():
    """Tied embeddings and a parallel residual are not in the port's model
    code: NotImplementedError. QK-norm is, as the JAX per-op path runs it
    (`dashinfer_tpu.models.transformer._qkv`): admitted, as there."""
    cfg, _ = tiny_qwen2()
    tcfg = port_config(cfg)
    import dataclasses
    for change in ({"tie_word_embeddings": True},
                   {"parallel_residual": True}):
        with pytest.raises(NotImplementedError):
            ttr.check_supported(dataclasses.replace(tcfg, **change))
    ttr.check_supported(dataclasses.replace(tcfg, qk_norm=True))
    ttr.check_supported(tcfg)
