"""The port's whole TP decode step (ops/tp_megakernel.py `tp_decode_ref`,
the ranks on ["cpu", "cpu"]) against the JAX package's
`build_tp_decode_fn` on a (1, 2) CPU mesh in interpret mode, as
tests/test_tp_megakernel.py holds the JAX function to its reference:
logits within 0.05 (bf16 weights) / 0.08 (quantized) of each row's largest
with the same argmax, and every rank's pool shard (written rows within one
level, or 2e-2 for float payload and qparams; every other element
equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.engine.steps import _rope_tiles as j_rope_tiles
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu.parallel import make_mesh as j_make_mesh
from dashinfer_tpu.parallel import shard_cache as j_shard_cache
from dashinfer_tpu.runtime.kv_cache import KVCache as JKVCache
from dashinfer_tpu_torch.engine import steps as tsteps
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_torch_tp_segments import (ACTIVE, LENS, N, assert_pool,
                                          pool_shard, port_cache, tp_case,
                                          written_rows)


@pytest.mark.parametrize("quant,mode,KH", [
    ("none", "int8", 2), ("a16w4", "uint4", 4)])
def test_tp_decode_ref_matches_jax_tp_decode_fn(quant, mode, KH):
    check_tp_decode_against_jax(tp_case(quant, mode, KH), quant)


def check_tp_decode_against_jax(c, quant):
    """`tp_decode_ref` against `build_tp_decode_fn` on a (1, 2) CPU mesh, at
    the module's tolerances (`quant`: the weights' quantization)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg, params, jplan, plan, pt = (c["cfg"], c["params"], c["jplan"],
                                    c["plan"], c["pt"])
    mode, KH = c["mode"], cfg.num_kv_heads
    B, L, ps = plan.B, plan.L, plan.ps
    tokens = np.asarray([7, 11, 13, 0], np.int32)

    # the JAX TP megakernel on a (1, 2) mesh
    mesh = j_make_mesh((1, N))
    packed = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("model"))),
        c["jpacked"])
    full = [jnp.asarray(p) for p in c["pools"]]
    cache_s = j_shard_cache(JKVCache(full[0], full[1],
                                     *(full[2:] or (None, None))), cfg, mesh)
    x0 = jnp.asarray(params["embed_tokens"]["w"])[tokens].astype(
        jnp.bfloat16)
    lens = jnp.asarray(LENS)
    cos, sin = j_rope_tiles(cfg, False, lens)
    sb, sp, ns, tgt = jmk.build_schedule(jnp.asarray(pt), lens,
                                         jnp.asarray(ACTIVE > 0), ps)
    fn = jtpk.build_tp_decode_fn(jplan, mesh, cfg.vocab_size, interpret=True)
    pools = [cache_s.k, cache_s.v]
    if cache_s.k_qparams is not None:
        pools += [cache_s.k_qparams, cache_s.v_qparams]
    outs = jax.jit(fn)(packed, x0, cos, sin, jnp.asarray(pt), lens,
                       jnp.asarray(ACTIVE), tgt, sb, sp, ns, *pools)
    ref = np.asarray(outs[0])[:, :cfg.vocab_size]
    ref_pools = [np.asarray(o) for o in outs[1:]]

    # the port's plain TP forward, the ranks on the CPU
    caches = [port_cache(pool_shard(c["pools"], r, N, KH, mode), ps)
              for r in range(N)]
    tcos, tsin = tsteps._rope_tiles(c["tcfg"], torch.from_numpy(LENS))
    x0_t = torch.from_numpy(np.asarray(params["embed_tokens"]["w"])
                            )[torch.from_numpy(tokens).long()].to(
                                torch.bfloat16)
    logits = ttpk.tp_decode_ref(
        plan, c["packs"], x0_t, tcos, tsin, torch.from_numpy(pt),
        torch.from_numpy(LENS), torch.from_numpy(ACTIVE > 0), caches,
        [torch.device("cpu")] * N).numpy()
    assert logits.shape == (B, cfg.vocab_size)
    tol = 0.05 if quant == "none" else 0.08
    for b in np.nonzero(ACTIVE)[0]:
        rel = np.abs(logits[b] - ref[b]).max() / (np.abs(ref[b]).max() + 1e-6)
        assert rel < tol, (b, rel)
        assert int(np.argmax(logits[b])) == int(np.argmax(ref[b])), b

    written = written_rows(pt, range(L), L, ps, c["pools"][0].shape[:2])
    for r in range(N):
        after = [t.numpy() for t in (caches[r].k, caches[r].v,
                                     caches[r].k_qparams,
                                     caches[r].v_qparams) if t is not None]
        assert_pool(after, pool_shard(ref_pools, r, N, KH, mode),
                    pool_shard(c["pools"], r, N, KH, mode), written, mode,
                    ps, f"rank {r}")
