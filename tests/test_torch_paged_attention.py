"""Decode attention and KV-pool movement: the port against the JAX package
on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.ops import attention as jattn
from dashinfer_tpu.ops import kv_ops as jkv
from dashinfer_tpu.ops.pallas import paged_attention as jpa
from dashinfer_tpu.runtime.kv_cache import KVCache as JCache
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.ops import attention as tattn
from dashinfer_tpu_torch.ops import kv_ops as tkv
from dashinfer_tpu_torch.ops import paged_attention as tpa
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TCache

KH, PS, D, P = 2, 8, 16, 32


def _random_pools(mode: str, seed: int):
    """Random pool contents in the JAX package's layout (qparams lane dim
    padded to 128), and the port's view of the same numbers (lanes [:ps])."""
    rng = np.random.RandomState(seed)
    if mode == "default":
        k = rng.randn(P, PS, KH * D).astype(np.float32)
        v = rng.randn(P, PS, KH * D).astype(np.float32)
        kq = vq = None
    else:
        lo, hi, dt, ds = ((-128, 128, np.int8, D) if mode == "int8"
                          else (0, 256, np.uint8, D // 2))
        k = rng.randint(lo, hi, (P, PS, KH * ds)).astype(dt)
        v = rng.randint(lo, hi, (P, PS, KH * ds)).astype(dt)
        kq = (rng.rand(P, 2 * KH, 128) * 0.05).astype(np.float32)
        vq = (rng.rand(P, 2 * KH, 128) * 0.05).astype(np.float32)
    jc = JCache(*(None if a is None else jnp.asarray(a)
                  for a in (k, v, kq, vq)))
    tc = TCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                *(None if a is None else torch.from_numpy(a[..., :PS].copy())
                  for a in (kq, vq)))
    return jc, tc


def _tables(seed: int):
    """Ragged lens incl. 0 and a non-multiple of the page size; page tables
    shuffled over the pool, garbage entries past lens."""
    rng = np.random.RandomState(seed)
    lens = np.asarray([5, 24, 0, 17], np.int32)
    maxP = 3
    perm = rng.permutation(P)
    pt = perm[:len(lens) * maxP].reshape(len(lens), maxP).astype(np.int32)
    return pt, lens


@pytest.mark.parametrize("mode", ["default", "int8", "uint4"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_paged_attention_plain_matches_jax(mode, G):
    """Plain twin vs the Pallas kernel (interpret mode) and vs the JAX
    gather reference (rows with lens > 0; the reference is not defined at
    lens 0). All f32; only summation order differs: max|d| <= 1e-5 *
    max|ref|. lens 0 gives exactly 0, as in the kernel."""
    jc, tc = _random_pools(mode, seed=G)
    pt, lens = _tables(seed=10 + G)
    q = np.random.RandomState(20 + G).randn(len(lens), KH * G, D) \
        .astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    args_j = (jnp.asarray(q), jc, JMode(mode), jnp.asarray(pt),
              jnp.asarray(lens), scale)
    args_t = (torch.from_numpy(q), tc, TMode(mode), torch.from_numpy(pt),
              torch.from_numpy(lens), scale)
    want = np.asarray(jpa.paged_attention(*args_j, interpret=True))
    got = tpa.paged_attention_plain(*args_t).numpy()
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert np.all(got[lens == 0] == 0.0)

    live = lens > 0
    ref_j = np.asarray(jattn.paged_attention_ref(*args_j))
    ref_t = tattn.paged_attention_ref(*args_t).numpy()
    assert np.abs(ref_t[live] - ref_j[live]).max() <= tol
    assert np.abs(got[live] - ref_t[live]).max() <= tol
    # the CPU wrapper takes the plain version and launches nothing
    before = tpa.paged_attention.counter.read()
    assert np.array_equal(tattn.paged_attention(*args_t).numpy(), got)
    assert tpa.paged_attention.counter.read() == before


def _empty_caches(mode: str):
    if mode == "default":
        shape, dt = (P, PS, KH * D), np.float32
    else:
        shape = (P, PS, KH * (D if mode == "int8" else D // 2))
        dt = np.int8 if mode == "int8" else np.uint8
    z = np.zeros(shape, dt)
    qz = None if mode == "default" else np.zeros((P, 2 * KH, 128), np.float32)
    jc = JCache(jnp.asarray(z), jnp.asarray(z),
                None if qz is None else jnp.asarray(qz),
                None if qz is None else jnp.asarray(qz))
    tc = TCache(torch.from_numpy(z.copy()), torch.from_numpy(z.copy()),
                None if qz is None else torch.zeros(P, 2 * KH, PS),
                None if qz is None else torch.zeros(P, 2 * KH, PS))
    return jc, tc


def _assert_pools_match(jc, tc, mode):
    """Payload equal (an int payload may be 1 apart where the scaled value
    sits on a rounding tie and the two frameworks' f32 division differs by
    one ulp); qparams rtol 1e-6 on lanes [:ps]. The port's last page is the
    sink of inactive decode slots, which the JAX package drops instead."""
    for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
        a, b = np.asarray(a)[:-1], b.numpy()[:-1]
        if mode == "default":
            assert np.array_equal(a, b)
        elif mode == "int8":
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            for sh in (0, 4):
                d = ((a >> sh) & 0xF).astype(np.int32) - \
                    ((b >> sh) & 0xF).astype(np.int32)
                assert np.abs(d).max() <= 1
    if mode != "default":
        for a, b in ((jc.k_qparams, tc.k_qparams),
                     (jc.v_qparams, tc.v_qparams)):
            np.testing.assert_allclose(b.numpy()[:-1],
                                       np.asarray(a)[:-1, :, :PS],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["default", "int8", "uint4"])
def test_append_kv_pools_match_jax(mode):
    jc, tc = _empty_caches(mode)
    rng = np.random.RandomState(3)
    T, n = 16, 13
    k = rng.randn(T, KH, D).astype(np.float32)
    v = rng.randn(T, KH, D).astype(np.float32)
    row = np.asarray([9, 4], np.int32)
    # an empty append writes nothing (the JAX scatter drops every token)
    jc = jkv.append_prefill_kv(jc, JMode(mode), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(row), jnp.int32(0), jnp.int32(0))
    tkv.append_prefill_kv(tc, TMode(mode), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(row), 0, 0)
    assert not tc.k.any() and not tc.v.any()
    _assert_pools_match(jc, tc, mode)
    jc = jkv.append_prefill_kv(jc, JMode(mode), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(row), jnp.int32(0), jnp.int32(n))
    tkv.append_prefill_kv(tc, TMode(mode), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(row), 0, n)
    _assert_pools_match(jc, tc, mode)

    # one decode append for 3 slots, the middle one inactive
    nk = rng.randn(3, KH, D).astype(np.float32)
    nv = rng.randn(3, KH, D).astype(np.float32)
    pages = np.asarray([4, 7, 11], np.int32)
    offs = np.asarray([n % PS, 2, 0], np.int32)
    active = np.asarray([True, False, True])
    jc = jkv.append_decode_kv(jc, JMode(mode), jnp.asarray(nk),
                              jnp.asarray(nv), jnp.asarray(pages),
                              jnp.asarray(offs), jnp.asarray(active))
    sink_before = tc.k[-1].clone()
    tkv.append_decode_kv(tc, TMode(mode), torch.from_numpy(nk),
                         torch.from_numpy(nv), torch.from_numpy(pages).long(),
                         torch.from_numpy(offs).long(),
                         torch.from_numpy(active))
    _assert_pools_match(jc, tc, mode)
    assert not torch.equal(tc.k[-1], sink_before)   # the inactive slot's
    #                                                 write went to the sink

    gk_j, gv_j = jkv.gather_kv_pages(jc, JMode(mode), jnp.asarray(row), KH)
    gk_t, gv_t = tkv.gather_kv_pages(tc, TMode(mode), torch.from_numpy(row),
                                     KH)
    np.testing.assert_allclose(gk_t.numpy(), np.asarray(gk_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gv_t.numpy(), np.asarray(gv_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "uint4"])
def test_quantize_kv_matches_jax(mode):
    x = np.random.RandomState(4).randn(6, KH, D).astype(np.float32)
    jp, js, jz = jkv.quantize_kv(jnp.asarray(x), JMode(mode))
    tp, ts, tz = tkv.quantize_kv(torch.from_numpy(x), TMode(mode))
    assert tp.dtype == {"int8": torch.int8, "uint4": torch.uint8}[mode]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-7)
    back = tkv.dequantize_page_tokens(tp, ts, tz, TMode(mode)).numpy()
    want = np.asarray(jkv.dequantize_page_tokens(jp, js, jz, JMode(mode)))
    step = np.asarray(js).max()
    assert np.abs(back - want).max() <= step + 1e-6
