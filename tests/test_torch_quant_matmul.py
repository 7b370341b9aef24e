"""quant_matmul and the linear layer: the port against the JAX package on the
same numpy inputs (CPU)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.loader import quantize as jq
from dashinfer_tpu.ops import linear as jlin
from dashinfer_tpu.ops.pallas import quant_matmul as jqmm
from dashinfer_tpu_torch.loader import quantize as tq
from dashinfer_tpu_torch.ops import linear as tlin
from dashinfer_tpu_torch.ops import quant_matmul as tqmm


def _leaf(K, N, gs, bits, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(K, N).astype(np.float32) * 0.1
    return jq.quantize_weight(w, bits, gs)


def _both(leaf):
    return ({k: jnp.asarray(v) for k, v in leaf.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in leaf.items()})


def _x(M, K, seed=1):
    return np.random.RandomState(seed).randn(M, K).astype(np.float32) * 0.5


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 5, 32])
def test_quant_matmul_plain_matches_pallas_kernel(bits, M):
    """Plain twin vs the Pallas kernel in interpret mode (N % 256 == 0, as
    the kernel needs). Both accumulate bf16 x f32-exact products in f32 and
    differ only in summation order: max|d| <= 1e-5 * max|ref|."""
    K, N, gs = 256, 256, 128
    jleaf, tleaf = _both(_leaf(K, N, gs, bits))
    x = _x(M, K)
    want = np.asarray(jqmm.quant_matmul(jnp.asarray(x), jleaf, jnp.float32))
    got = tqmm.quant_matmul_plain(torch.from_numpy(x), tleaf,
                                  torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_quant_matmul_wrapper_takes_plain_on_cpu():
    jleaf, tleaf = _both(_leaf(128, 256, 64, 4))
    x = torch.from_numpy(_x(3, 128))
    before = tqmm.quant_matmul.counter.read()
    got = tqmm.quant_matmul(x, tleaf, torch.float32)
    assert torch.equal(got, tqmm.quant_matmul_plain(x, tleaf, torch.float32))
    assert tqmm.quant_matmul.counter.read() == before   # no kernel launched


@pytest.mark.parametrize("layout,N,bits", [("u4_tile128", 256, 4),
                                           ("u4_halves", 96, 4),
                                           ("i8", 96, 8)])
def test_large_m_matches_jax(layout, N, bits):
    """bf16(q*scale) operand + f32 zero term, as the JAX package forms it:
    the same bf16 products, f32 sums in another order (rtol 1e-5)."""
    K, gs = 64, 32
    jleaf, tleaf = _both(_leaf(K, N, gs, bits))
    x = _x(40, K)
    want = np.asarray(jlin._quant_matmul_large_m(jnp.asarray(x), jleaf))
    got = tlin._quant_matmul_large_m(torch.from_numpy(x), tleaf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("M,K,N,gs", [
    (1, 512, 512, 128),     # kernel
    (32, 512, 512, 128),    # kernel at the M limit
    (33, 512, 512, 128),    # large M
    (8, 512, 96, 128),      # N % 256 != 0
    (8, 2048, 256, 1024),   # gs > 512 and gs % 512 == 0
    (8, 1536, 256, 768),    # gs > 512 and gs % 512 != 0
])
def test_linear_dispatch_matches_jax(M, K, N, gs, monkeypatch):
    """On the accelerator the port takes its kernel exactly where the JAX
    package takes its Pallas kernel; off it, neither does."""
    leaf = {"w_q": np.zeros((K, N // 2), np.uint8),
            "scale": np.zeros((K // gs, N), np.float32),
            "zero": np.zeros((K // gs, N), np.float32)}
    cpu = torch.zeros(1)
    assert not tlin.use_fused_gemv(M, leaf, cpu)
    assert not jqmm.use_fused_gemv(M, leaf)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    on_card = types.SimpleNamespace(is_cuda=True)
    assert tlin.use_fused_gemv(M, leaf, on_card) == \
        jqmm.use_fused_gemv(M, leaf)


@pytest.mark.parametrize("M", [1, 40])
def test_linear_cpu_matches_jax(M):
    """linear() with bias on the CPU: the large-M formulation at every M in
    both packages (rtol 1e-5)."""
    K, N, gs = 64, 256, 32
    leaf = dict(_leaf(K, N, gs, 4))
    leaf["b"] = np.random.RandomState(3).randn(N).astype(np.float32)
    jleaf, tleaf = _both(leaf)
    x = _x(M, K)
    want = np.asarray(jlin.linear(jnp.asarray(x), jleaf))
    got = tlin.linear(torch.from_numpy(x), tleaf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bits,N", [(4, 256), (4, 96), (8, 96)])
def test_dequantize_weight_matches_jax(bits, N):
    jleaf, tleaf = _both(_leaf(64, N, 16, bits))
    want = np.asarray(jlin.dequantize_weight(jleaf, jnp.float32))
    got = tlin.dequantize_weight(tleaf, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits,gs,N", [(4, 32, 256), (4, 16, 96), (4, -1, 64),
                                       (8, 32, 96), (8, -1, 256)])
def test_quantize_weight_bit_equal(bits, gs, N):
    w = np.random.RandomState(5).randn(64, N).astype(np.float32)
    want = jq.quantize_weight(w, bits, gs)
    got = tq.quantize_weight(w, bits, gs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def test_quantize_params_bit_equal():
    from dashinfer_tpu.config import QuantConfig as JQ
    from dashinfer_tpu_torch.config import QuantConfig as TQ
    rng = np.random.RandomState(6)
    tree = {"embed_tokens": {"w": rng.randn(32, 64).astype(np.float32)},
            "lm_head": {"w": rng.randn(64, 32).astype(np.float32)},
            "layers": {"q_proj": {"w": rng.randn(2, 64, 64).astype(
                np.float32), "b": rng.randn(2, 64).astype(np.float32)},
                "down_proj": {"w": rng.randn(2, 128, 64).astype(np.float32)},
                "input_layernorm": np.ones((2, 64), np.float32)}}
    want = jq.quantize_params(tree, JQ(mode="a16w4", group_size=32))
    got = tq.quantize_params(tree, TQ(mode="a16w4", group_size=32))

    def flat(t, p=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{p}/{k}").items()}
        return {p: np.asarray(t)}

    fw, fg = flat(want), flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), k
