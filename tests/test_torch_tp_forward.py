"""The port's per-op TP forward (models/transformer.py `tp_prefill_forward`
/ `tp_decode_forward`, the ranks on ["cpu", "cpu"]) against the JAX
package's per-op model on a (1, 2) CPU mesh (its params and KV pool
sharded, XLA's SPMD partitioner inserting the collectives), on the same
numpy weights and pool: logits within 0.05 (f32 weights) / 0.08
(quantized) of the row's largest with the same argmax, and every rank's
pool shard as tests/test_torch_tp_segments.py holds it."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.models import transformer as jtr
from dashinfer_tpu.parallel import make_mesh as j_make_mesh
from dashinfer_tpu.parallel import shard_cache as j_shard_cache
from dashinfer_tpu.parallel import shard_params as j_shard_params
from dashinfer_tpu.runtime.kv_cache import create_kv_cache as j_create
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.parallel import make_mesh, shard_params
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from tests.test_megakernel import _prep_cache
from tests.test_torch_tp_segments import (ACTIVE, LENS, N, assert_pool,
                                          pool_shard)
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

CPU2 = [torch.device("cpu")] * N


def _rank_caches(pools, KH, mode, ps):
    """Each rank's pool shard as the port holds it, with the port's sink
    page (inactive decode slots write there) appended."""
    out = []
    for r in range(N):
        sh = pool_shard(pools, r, N, KH, mode)
        t = [torch.from_numpy(np.concatenate([p, np.zeros_like(p[:1])]))
             for p in sh]
        if len(t) == 4:
            t[2], t[3] = (x[..., :ps].contiguous() for x in t[2:])
        out.append(TKVCache(*t) if len(t) == 4 else
                   TKVCache(t[0], t[1], None, None))
    return out


def _after(cache):
    return [t.numpy()[:-1] for t in (cache.k, cache.v, cache.k_qparams,
                                     cache.v_qparams) if t is not None]


@pytest.mark.parametrize("quant,mode,KH", [("none", "int8", 2),
                                          ("a16w4", "uint4", 4)])
def test_tp_forward_matches_jax_spmd(quant, mode, KH):
    check_tp_forward_against_jax(quant, mode, KH)


def check_tp_forward_against_jax(quant, mode, KH, alibi=False):
    """One decode step over a prefilled pool and a 20-token prefill through
    the port's per-op TP forwards and the JAX SPMD model (`alibi`: the
    tiny model's ALiBi twin), at the module's tolerances."""
    cfg, rt, params = tp_fixture(quant, KH=KH, alibi=alibi)
    jm = JMode(mode)
    tcfg = port_config(cfg)
    B, L, ps = rt.max_batch, cfg.num_layers, rt.cache.page_size
    maxP = rt.max_pages_per_seq
    pt = (1 + np.arange(B * maxP, dtype=np.int32)).reshape(B, maxP)
    import dataclasses
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=jm))
    jcache = _prep_cache(cfg, rt, params, jm, LENS, pt)
    pools = [np.asarray(p) for p in (jcache.k, jcache.v, jcache.k_qparams,
                                     jcache.v_qparams) if p is not None]
    mesh = j_make_mesh((1, N))
    sp = j_shard_params(jax.tree.map(jnp.asarray, params), mesh)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    ranks = shard_params(tparams, tcfg, make_mesh((1, N), CPU2))
    tol = 0.05 if quant == "none" else 0.08

    def close(got, ref, rows):
        for b in rows:
            rel = np.abs(got[b] - ref[b]).max() / np.abs(ref[b]).max()
            assert rel < tol, (b, rel)
            assert int(np.argmax(got[b])) == int(np.argmax(ref[b])), b

    # one decode step over the prefilled pool
    tokens = np.asarray([7, 11, 13, 0], np.int32)
    dec = jax.jit(functools.partial(jtr.decode_forward, cfg, mode=jm,
                                    use_kernel=False))
    jl, jc = dec(sp, jnp.asarray(tokens), j_shard_cache(jcache, cfg, mesh),
                 jnp.asarray(pt), jnp.asarray(LENS),
                 jnp.asarray(ACTIVE > 0))
    caches = _rank_caches(pools, KH, mode, ps)
    tl, _ = ttr.tp_decode_forward(
        tcfg, ranks, torch.from_numpy(tokens), caches, torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0),
        mode=TMode(mode), devices=CPU2)
    close(tl.numpy(), np.asarray(jl), np.nonzero(ACTIVE)[0])
    ref_pools = [np.asarray(p) for p in (jc.k, jc.v, jc.k_qparams,
                                         jc.v_qparams) if p is not None]
    written = np.zeros(pools[0].shape[:2], bool)
    for b in np.nonzero(ACTIVE)[0]:
        g, off = pt[b, LENS[b] // ps], int(LENS[b] % ps)
        written[g * L:(g + 1) * L, off] = True
    for r in range(N):
        assert_pool(_after(caches[r]), pool_shard(ref_pools, r, N, KH, mode),
                    pool_shard(pools, r, N, KH, mode), written, mode, ps,
                    f"decode rank {r}")

    # a 20-token prompt's prefill (bucket 32) into fresh pages
    n, S = 20, 32
    rng = np.random.RandomState(9)
    prompt = np.zeros((S,), np.int32)
    prompt[:n] = rng.randint(1, cfg.vocab_size, size=n)
    row = np.arange(40, 40 + S // ps, dtype=np.int32)
    fresh = j_create(cfg, rt.cache, rt.cache.num_pages * L,
                     model_dtype=jnp.float32)
    pre = jax.jit(functools.partial(jtr.prefill_forward, cfg, mode=jm,
                                    use_kernel=False))
    jl, jc = pre(sp, jnp.asarray(prompt), j_shard_cache(fresh, cfg, mesh),
                 jnp.asarray(row), jnp.int32(0), jnp.int32(n))
    fresh_np = [np.asarray(p) for p in (fresh.k, fresh.v, fresh.k_qparams,
                                        fresh.v_qparams) if p is not None]
    caches = _rank_caches(fresh_np, KH, mode, ps)
    tl, _ = ttr.tp_prefill_forward(
        tcfg, ranks, torch.from_numpy(prompt), caches,
        torch.from_numpy(row), 0, n, mode=TMode(mode), devices=CPU2)
    close(tl.numpy()[None], np.asarray(jl)[None], [0])
    ref_pools = [np.asarray(p) for p in (jc.k, jc.v, jc.k_qparams,
                                         jc.v_qparams) if p is not None]
    written = np.zeros(pools[0].shape[:2], bool)
    for t in range(n):
        written[row[t // ps] * L:(row[t // ps] + 1) * L, t % ps] = True
    for r in range(N):
        assert_pool(_after(caches[r]), pool_shard(ref_pools, r, N, KH, mode),
                    pool_shard(fresh_np, r, N, KH, mode), written, mode, ps,
                    f"prefill rank {r}")


def test_tp_forward_replicates_kv_heads_that_do_not_divide():
    """KH = 2 on four ranks: every rank holds all KV heads (the K/V weights
    and the pool replicated, as the JAX package replicates the cache) and
    attends with its own query heads; the logits equal the single-device
    per-op forward's."""
    cfg, rt, params = tp_fixture("none", KH=2)
    tcfg = port_config(cfg)
    n = 4
    devs = [torch.device("cpu")] * n
    tparams = params_from_numpy(params, "cpu", torch.float32)
    ranks = shard_params(tparams, tcfg, make_mesh((1, n), devs))
    assert ranks[0]["layers"]["k_proj"]["w"].shape[-1] == 2 * 128
    from dashinfer_tpu_torch.config import CacheConfig
    from dashinfer_tpu_torch.parallel import shard_cache
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    cc = CacheConfig(page_size=16, num_pages=64, mode=TMode.INT8)
    pages = 64 * cfg.num_layers + 1
    caches = shard_cache(tcfg, cc, make_mesh((1, n), devs), pages,
                         torch.float32)
    assert caches[0].k.shape[-1] == 2 * 128
    single = create_kv_cache(tcfg, cc, pages, torch.float32, "cpu")
    prompt = torch.tensor([5, 9, 2, 41, 77, 3] + [0] * 10)
    row = torch.tensor([1], dtype=torch.int32)
    want, _ = ttr.prefill_forward(tcfg, tparams, prompt, single, row, 0, 6,
                                  mode=TMode.INT8)
    got, _ = ttr.tp_prefill_forward(tcfg, ranks, prompt, caches, row, 0, 6,
                                    mode=TMode.INT8, devices=devs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for c in caches:      # the same rows, at most one level apart (layer 1
        # quantizes activations whose sums ran in another order)
        d = c.k.numpy().astype(np.int32) - single.k.numpy()
        assert np.abs(d).max() <= 1
