"""The port's whole TP prefill (ops/tp_megakernel.py `tp_prefill_ref`, the
ranks on ["cpu", "cpu"]) against the JAX package's `build_tp_prefill_fn`
on a (1, 2) CPU mesh in interpret mode, and against the port's own
single-device prefill megakernel plain version and per-op TP prefill on the
same weights; `supports_prefill_tp` against the JAX function.

Tolerances. Against the JAX TP prefill and the single-device plain
version (the same roundings, other orders of the f32 sums): the last
token's logits within 2e-2 of their largest with the same argmax (the
prefill megakernel test's); the written pool rows within one level of
integer payload, their scale and zero (relative to the head's range)
within 1e-3 in layer 0, where both sides quantize the same input, and 1e-2
in the deeper layer; float payload within 1e-3 of its largest; every other
pool element equal. Against the per-op TP prefill on an unquantized pool:
logits within 8e-2 of their largest with the same argmax, and K / V within
3e-2 (the per-op path keeps f32 activations and weights where the segments
round to bf16), as tests/test_torch_prefill_megakernel.py holds the
single-device plain version to the per-op prefill."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu.parallel import make_mesh as j_make_mesh
from dashinfer_tpu.parallel import shard_cache as j_shard_cache
from dashinfer_tpu.runtime.kv_cache import KVCache as JKVCache
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from tests.test_megakernel import _tiny_moe
from tests.test_torch_megakernel import _np_tree, _port_rt, _unpack_kv
from tests.test_torch_tp_prefill_segments import (BUCKET, N, prefill_case,
                                                  prompt_inputs)
from tests.test_torch_tp_segments import pool_shard, port_cache
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

LOGITS_RTOL = 2e-2
QPARAM_RTOL = 1e-3
DEEP_QPARAM_RTOL = 1e-2
CPU2 = [torch.device("cpu")] * N


def _tokens(cfg, n_tokens, seed=7):
    rng = np.random.RandomState(seed)
    toks = np.zeros((BUCKET,), np.int32)
    toks[:n_tokens] = rng.randint(1, cfg.vocab_size, size=n_tokens)
    return toks


def _port_prefill(c, params_np, toks, n_tokens, page_row, caches):
    """tp_prefill_ref on the port's packs from the same numpy embedding."""
    inp = prompt_inputs(c, n_tokens)
    embed = torch.from_numpy(np.asarray(params_np["embed_tokens"]["w"],
                                        np.float32))
    x0 = embed[torch.from_numpy(toks).long()].to(torch.bfloat16)
    return ttpk.tp_prefill_ref(c["plan"], c["packs"], x0, inp["tcos"],
                               inp["tsin"], torch.from_numpy(page_row),
                               inp["n"], caches, CPU2)


def _full_pool(caches):
    """The ranks' pools side by side: the single-device pool's layout."""
    def cat(name):
        ts = [getattr(c, name) for c in caches]
        if ts[0] is None:
            return None
        return torch.cat(ts, dim=1 if name.endswith("qparams") else 2)
    return TKVCache(*(cat(nm) for nm in ("k", "v", "k_qparams",
                                         "v_qparams")))


def assert_prefill_pool(got, ref, before, written, L, mode, ps, what):
    """numpy pools (payload, qparams cut to the page size): `written`
    [pages, ps]."""
    layer0 = (np.nonzero(written)[0] % L) == 0
    levels = 255.0 if mode == "int8" else 15.0
    for i in (0, 1):
        g = _unpack_kv(got[i], mode)[written]
        w = _unpack_kv(ref[i], mode)[written]
        if mode == "default":
            assert np.abs(g - w).max() <= QPARAM_RTOL * np.abs(w).max(), what
        else:
            assert np.abs(g - w).max() <= 1, (what, i)
            gq = got[2 + i].transpose(0, 2, 1)[written]
            wq = ref[2 + i][..., :ps].transpose(0, 2, 1)[written]
            scale = wq[:, 0::2]
            rel = np.maximum(np.abs(gq[:, 0::2] - scale) / scale,
                             np.abs(gq[:, 1::2] - wq[:, 1::2]) /
                             (scale * levels)).max(-1)
            assert rel[layer0].max() <= QPARAM_RTOL, (what, i)
            assert rel.max() <= DEEP_QPARAM_RTOL, (what, i)
    for i, a in enumerate(got):
        keep = ~written if i < 2 else \
            ~np.broadcast_to(written[:, None, :], a.shape)
        np.testing.assert_array_equal(a[keep], before[i][..., :a.shape[-1]]
                                      [keep], err_msg=f"{what} pool {i}")


def _written(page_row, n_tokens, L, ps, shape):
    w = np.zeros(shape, bool)
    for t in range(n_tokens):
        w[page_row[t // ps]:page_row[t // ps] + L, t % ps] = True
    return w


@pytest.mark.parametrize("quant,mode,KH,n_tokens", [
    ("a16w4", "int8", 2, 45), ("a16w8", "uint4", 4, 128)])
def test_tp_prefill_ref_matches_jax_tp_prefill_fn(quant, mode, KH,
                                                  n_tokens):
    check_tp_prefill_against_jax(prefill_case(quant, mode, KH),
                                 tp_fixture(quant, KH=KH)[2], n_tokens)


def check_tp_prefill_against_jax(c, params, n_tokens):
    """`tp_prefill_ref` against `build_tp_prefill_fn` on a (1, 2) CPU mesh
    (`params`: the case's numpy weights), at the module's tolerances."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg, jplan, ps, L = c["cfg"], c["jplan"], c["ps"], c["cfg"].num_layers
    mode, KH = c["mode"], cfg.num_kv_heads
    toks = _tokens(cfg, n_tokens)
    page_row = prompt_inputs(c, n_tokens)["page_row"]

    mesh = j_make_mesh((1, N))
    packed = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("model"))),
        c["jpacked"])
    full = [jnp.asarray(p) for p in c["pools"]]
    cache_s = j_shard_cache(JKVCache(full[0], full[1],
                                     *(full[2:] or (None, None))), cfg, mesh)
    x0 = jnp.asarray(np.asarray(params["embed_tokens"]["w"]))[
        jnp.asarray(toks)].astype(jnp.bfloat16)
    inp = prompt_inputs(c, n_tokens)
    fn = jtpk.build_tp_prefill_fn(jplan, mesh, cfg.vocab_size,
                                  interpret=True)
    pools = [cache_s.k, cache_s.v]
    if cache_s.k_qparams is not None:
        pools += [cache_s.k_qparams, cache_s.v_qparams]
    outs = jax.jit(fn)(packed, x0, inp["cos"], inp["sin"],
                       jnp.asarray(page_row), jnp.int32(n_tokens), *pools)
    ref = np.asarray(outs[0])[0, :cfg.vocab_size]
    ref_pools = [np.asarray(o) for o in outs[1:]]

    caches = [port_cache(pool_shard(c["pools"], r, N, KH, mode), ps)
              for r in range(N)]
    logits = _port_prefill(c, params, toks, n_tokens, page_row,
                           caches).numpy()
    assert logits.shape == (cfg.vocab_size,)
    assert np.abs(logits - ref).max() <= LOGITS_RTOL * np.abs(ref).max()
    assert int(np.argmax(logits)) == int(np.argmax(ref))
    written = _written(page_row, n_tokens, L, ps, c["pools"][0].shape[:2])
    for r in range(N):
        after = [t.numpy() for t in (caches[r].k, caches[r].v,
                                     caches[r].k_qparams,
                                     caches[r].v_qparams) if t is not None]
        assert_prefill_pool(after, pool_shard(ref_pools, r, N, KH, mode),
                            pool_shard(c["pools"], r, N, KH, mode), written,
                            L, mode, ps, f"rank {r}")


@pytest.mark.parametrize("quant,mode", [("a16w4", "int8"),
                                        ("none", "default")])
def test_tp_prefill_ref_matches_the_single_device_plain_version(quant, mode):
    """The same weights through the port's single-device prefill
    megakernel plain version (its pool the ranks' pools side by side)."""
    c = prefill_case(quant, mode, 2)
    cfg, tcfg, ps, L = c["cfg"], c["tcfg"], c["ps"], c["cfg"].num_layers
    _, _, params = tp_fixture(quant)
    n_tokens = 45
    toks = _tokens(cfg, n_tokens)
    inp = prompt_inputs(c, n_tokens)
    page_row = inp["page_row"]
    caches = [port_cache(pool_shard(c["pools"], r, N, 2, mode), ps)
              for r in range(N)]
    before = _full_pool(caches).clone()
    got = _port_prefill(c, params, toks, n_tokens, page_row, caches)
    # the single-device plan and pack of the same weights
    from dashinfer_tpu_torch.loader import params_from_numpy
    trt = _port_rt(c["rt"], mode)
    tparams = params_from_numpy(tmk.weight_only_decode_view(
        _np_tree(params)), "cpu", torch.float32)
    dplan = tmk.make_plan(tcfg, trt, tparams)
    plan1 = tpmk.make_prefill_plan(tcfg, trt, tparams, BUCKET,
                                   decode_plan=dplan)
    pack1 = tmk.pack_params(tcfg, dplan, tparams)
    c1 = before.clone()
    x0 = tparams["embed_tokens"]["w"][torch.from_numpy(toks).long()].to(
        torch.bfloat16)
    want = tpmk.prefill_megakernel_ref(plan1, pack1, x0, inp["tcos"],
                                       inp["tsin"],
                                       torch.from_numpy(page_row), inp["n"],
                                       c1)
    assert (got - want).abs().max() <= LOGITS_RTOL * want.abs().max()
    assert int(got.argmax()) == int(want.argmax())
    as_np = [t.numpy() for t in (_full_pool(caches).k, _full_pool(caches).v,
                                 _full_pool(caches).k_qparams,
                                 _full_pool(caches).v_qparams)
             if t is not None]
    ref_np = [t.numpy() for t in (c1.k, c1.v, c1.k_qparams, c1.v_qparams)
              if t is not None]
    before_np = [t.numpy() for t in (before.k, before.v, before.k_qparams,
                                     before.v_qparams) if t is not None]
    assert_prefill_pool(as_np, ref_np, before_np,
                        _written(page_row, n_tokens, L, ps,
                                 before.k.shape[:2]), L, mode, ps,
                        "vs single device")


def test_tp_prefill_ref_against_the_per_op_tp_prefill():
    c = prefill_case("none", "default", 2)
    cfg, tcfg, ps, L = c["cfg"], c["tcfg"], c["ps"], c["cfg"].num_layers
    _, _, params = tp_fixture("none")
    n_tokens = 45
    toks = _tokens(cfg, n_tokens)
    inp = prompt_inputs(c, n_tokens)
    page_row = inp["page_row"]
    shards = [pool_shard([np.zeros_like(p) for p in c["pools"]], r, N, 2,
                         "default") for r in range(N)]
    c_seg = [port_cache(s, ps) for s in shards]
    c_op = [port_cache(s, ps) for s in shards]
    got = _port_prefill(c, params, toks, n_tokens, page_row, c_seg)
    from dashinfer_tpu_torch.loader import params_from_numpy
    tparams = params_from_numpy(_np_tree(params), "cpu", torch.float32)
    parts = ttpk.split_params_tp(tparams, tcfg, N)
    want, _ = ttr.tp_prefill_forward(
        tcfg, parts, torch.from_numpy(toks).long(), c_op,
        torch.from_numpy(page_row // L), 0, n_tokens, mode=TMode.DEFAULT,
        devices=CPU2)
    assert (got - want).abs().max() <= 8e-2 * want.abs().max()
    assert int(got.argmax()) == int(want.argmax())
    for r in range(N):
        for a, b in ((c_seg[r].k, c_op[r].k), (c_seg[r].v, c_op[r].v)):
            assert (a - b).abs().max() <= 3e-2 * b.abs().max()
            assert torch.equal(a == 0, b == 0)   # the same rows written


@pytest.mark.parametrize("quant,mode,KH", [
    ("none", "default", 2), ("a16w4", "int8", 2), ("a16w8", "uint4", 4),
    ("a16w8g", "int8", 2), ("a16w4", "int8", 1)])
@pytest.mark.parametrize("n", [2, 4])
def test_supports_prefill_tp_decides_as_jax(quant, mode, KH, n):
    """Equal decisions over buckets and meshes (a KV head count the ranks
    do not divide is refused on both sides), but for the JAX UINT4 rule of
    128 K/V lanes a rank, a Mosaic tiling rule the port does not keep
    (tests/test_torch_tp_split.py)."""
    cfg, rt, params = tp_fixture(quant, KH=KH)
    rt = dataclasses.replace(
        rt, max_length=2048,
        cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    tcfg, trt = port_config(cfg), _port_rt(rt, mode)
    lane_rule = mode == "uint4" and KH // n * 64 < 128
    for bucket in (64, 128, 192, 1024, 2048):
        want = jtpk.supports_prefill_tp(cfg, rt, params, bucket, n)
        got = ttpk.supports_prefill_tp(tcfg, trt, params, bucket, n)
        assert got == (bucket in (128, 1024) and KH % n == 0 and
                       (256 // n) % 128 == 0), bucket
        if not lane_rule:
            assert got == want, (bucket, want)
        else:
            assert not want


def test_supports_prefill_tp_refuses_moe():
    """The JAX package prefills a MoE model on a mesh through its segments
    (experts split over the model axis); the port has no MoE on a mesh yet
    and says no."""
    cfg, rt, params = _tiny_moe(KH=2, H=2)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    rt = dataclasses.replace(rt, max_length=2048)
    assert jtpk.supports_prefill_tp(cfg, rt, params, 128, 2)
    assert not ttpk.supports_prefill_tp(port_config(cfg),
                                        _port_rt(rt, "default"),
                                        _np_tree(params), 128, 2)
