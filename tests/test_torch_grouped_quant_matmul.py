"""The port's grouped MoE GEMM module against the JAX package's, on the CPU:
the 4-D expert quantization and the u4 TILE-128 repack (bit-equal), the
boundary-padded group layout (equal), and `grouped_quant_matmul_plain`
(which the port's wrapper runs for CPU tensors) against the Pallas
`_gkernel` in interpret mode on the same numpy inputs, for u4 and int8, at
widths that are and are not multiples of 256."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params as j_quantize
from dashinfer_tpu.ops.pallas import grouped_quant_matmul as jgqm
from dashinfer_tpu_torch.config import QuantConfig as TQuantConfig
from dashinfer_tpu_torch.loader.quantize import quantize_params as t_quantize
from dashinfer_tpu_torch.ops import grouped_quant_matmul as tgqm
from tests.test_grouped_quant_matmul import _quant_expert_stack

# Tolerance of the plain version against the interpret-mode kernel: both
# take bf16(x) against the exact integer levels and apply the f32 affine
# after each K tile's dot; they differ in the order of the f32 sums and the
# plain version rounds its f32 result to bf16 where the kernel's
# out_dtype=f32 call does not: |d| <= 1e-3 * max|ref| + 2^-8 |ref|.
RTOL, BF16_REL = 1e-3, 2.0 ** -8


@pytest.mark.parametrize("mode", ["a16w4", "a16w8"])
def test_quantize_expert_stacks_bit_equal_to_jax(mode):
    rng = np.random.RandomState(0)
    L, E, K, N = 2, 3, 128, 192          # N % 256 != 0: plain-halves u4
    tree = {"layers": {"experts": {
        "gate_proj": rng.randn(L, E, K, N).astype(np.float32) * 0.1,
        "down_proj": rng.randn(L, E, N, K).astype(np.float32) * 0.1},
        "router": {"w": rng.randn(L, K, E).astype(np.float32)}}}
    want = j_quantize(tree, QuantConfig(mode=mode, group_size=64))
    got = t_quantize(tree, TQuantConfig(mode=mode, group_size=64))
    for name in ("gate_proj", "down_proj"):
        for key in ("w_q", "scale", "zero"):
            a = np.asarray(want["layers"]["experts"][name][key])
            b = got["layers"]["experts"][name][key]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the router is no linear leaf: both leave it as it is
    assert got["layers"]["router"]["w"] is tree["layers"]["router"]["w"]


def test_repack_and_prepare_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    L, E, K, N = 2, 3, 64, 192
    leaf = _quant_expert_stack(rng, L, E, K, N, 4, 64)
    want = jgqm.repack_expert_u4_tile128(leaf, N)
    got = tgqm.repack_expert_u4_tile128(leaf, N)
    tensor = tgqm._repack_tensor_leaf(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         leaf.items()}, N)
    for key in ("w_qg", "scale_g", "zero_g"):
        np.testing.assert_array_equal(want[key], got[key])
        np.testing.assert_array_equal(want[key], tensor[key].numpy())
    assert got["w_qg"].shape == (L, E, K, 128)

    from dashinfer_tpu.config import MoEConfig, ModelConfig
    from tests.test_torch_transformer import port_config
    cfg = ModelConfig(arch="qwen2_moe", vocab_size=128, hidden_size=K,
                      intermediate_size=N, num_layers=L, num_heads=1,
                      num_kv_heads=1, head_dim=64,
                      moe=MoEConfig(num_experts=E, num_experts_per_tok=2,
                                    moe_intermediate_size=N))

    down = _quant_expert_stack(rng, L, E, N, K, 4, 64)

    def tree():
        return {"layers": {"experts": {"gate_proj": dict(leaf),
                                       "down_proj": dict(down)}}}

    j, t = jgqm.prepare_grouped_experts(tree(), cfg), \
        tgqm.prepare_grouped_experts(tree(), port_config(cfg))
    for name in ("gate_proj", "down_proj"):
        jl, tl = j["layers"]["experts"][name], t["layers"]["experts"][name]
        # the JAX package keeps the padded copy beside the loader's leaf
        # (w_qg / scale_g / zero_g); the port keeps it alone, in the
        # loader's keys
        want = {k: jl[k + "_g" if k != "w_q" else "w_qg"] for k in
                ("w_q", "scale", "zero")} if "w_qg" in jl else jl
        assert sorted(tl) == ["scale", "w_q", "zero"]
        for key in tl:
            np.testing.assert_array_equal(want[key], tl[key])
    assert t["layers"]["experts"]["gate_proj"]["w_q"].shape == (L, E, K, 128)
    # a leaf already padded is left as it is
    again = tgqm.prepare_grouped_experts(
        {"layers": {"experts": dict(t["layers"]["experts"])}},
        port_config(cfg))["layers"]["experts"]
    assert all(again[n] is t["layers"]["experts"][n] for n in again)
    # an int8 stack of 128 mod 256 columns is padded too (the CUDA kernel's
    # column tile is 256 wide)
    raw8 = _quant_expert_stack(rng, L, E, K, 384, 8, 64)
    cfg8 = port_config(cfg)
    import dataclasses
    cfg8 = dataclasses.replace(cfg8, moe=dataclasses.replace(
        cfg8.moe, moe_intermediate_size=384))
    g8 = tgqm.prepare_grouped_experts(
        {"layers": {"experts": {"gate_proj": dict(raw8)}}}, cfg8)[
        "layers"]["experts"]["gate_proj"]
    assert g8["w_q"].shape == (L, E, K, 512)
    np.testing.assert_array_equal(g8["w_q"][..., :384], raw8["w_q"])
    assert not g8["w_q"][..., 384:].any()
    np.testing.assert_array_equal(g8["scale"][..., :384], raw8["scale"])
    assert (g8["scale"][..., 384:] == 1).all()


@pytest.mark.parametrize("T,k,E,TM", [(37, 4, 6, 8), (8, 4, 60, 64),
                                      (32, 4, 60, 64), (5, 2, 3, 16)])
def test_build_group_layout_equals_jax(T, k, E, TM):
    rng = np.random.RandomState(T)
    topk = np.stack([rng.choice(E, size=k, replace=False) for _ in range(T)]
                    ).astype(np.int32)
    want = jgqm.build_group_layout(jnp.asarray(topk), E, TM)
    got = tgqm.build_group_layout(torch.from_numpy(topk), E, TM)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the real rows of each tile, the kernel's hint
    pos = np.asarray(want[2])
    rows = tgqm.tile_row_counts(got[2], got[3].shape[0], TM).numpy()
    np.testing.assert_array_equal(
        rows, np.bincount(pos // TM, minlength=got[3].shape[0]))


@pytest.mark.parametrize("bits,N,gs,repack", [
    (4, 512, 64, False),      # u4 TILE-128 as the loader holds it
    (4, 192, 64, True),       # u4, N % 256 != 0: padded by the install
    (8, 384, 64, False),      # int8, N % 128 only (the Pallas kernel's rule)
    (8, 384, 64, True),       # ... and padded by the port's install
    (8, 256, 0, False),       # per-channel groups
])
def test_grouped_plain_matches_pallas_interpret(bits, N, gs, repack):
    rng = np.random.default_rng(1)
    E, K, TM, T, ktop = 5, 128, 8, 23, 2
    raw = _quant_expert_stack(rng, 1, E, K, N, bits, gs or K)
    if repack:
        from dashinfer_tpu_torch.config import ModelConfig, MoEConfig
        cfg = ModelConfig(arch="qwen2_moe", vocab_size=128, hidden_size=K,
                          intermediate_size=N, num_layers=1, num_heads=1,
                          num_kv_heads=1, head_dim=64,
                          moe=MoEConfig(num_experts=E, num_experts_per_tok=2,
                                        moe_intermediate_size=N))
        tree = tgqm.prepare_grouped_experts(
            {"layers": {"experts": {"gate_proj": raw}}}, cfg)
        leaf_np = {k: v[0] for k, v in
                   tree["layers"]["experts"]["gate_proj"].items()}
    else:
        leaf_np = {k: v[0] for k, v in raw.items()}
    jleaf = {k: jnp.asarray(v) for k, v in leaf_np.items()}
    assert jgqm.supports_grouped(jleaf)
    tleaf = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in leaf_np.items()}
    assert tgqm.supports_grouped(tleaf)
    topk = rng.integers(0, E, size=(T, ktop)).astype(np.int32)
    x = rng.standard_normal((T, K), dtype=np.float32) * 0.5
    order, sorted_token, pos, te = jgqm.build_group_layout(
        jnp.asarray(topk), E, TM)
    Mcap = int(te.shape[0]) * TM
    xs = np.zeros((Mcap, K), np.float32)
    xs[np.asarray(pos)] = x[np.asarray(sorted_token)]
    want = np.asarray(jgqm.grouped_quant_matmul(
        jnp.asarray(xs), te, jleaf, out_dtype=jnp.float32, interpret=True))
    got = tgqm.grouped_quant_matmul(
        torch.from_numpy(xs), torch.from_numpy(np.asarray(te)), tleaf,
        tile_rows=tgqm.tile_row_counts(torch.from_numpy(np.asarray(pos)),
                                       int(te.shape[0]), TM))
    assert got.dtype == torch.bfloat16 and got.shape == (Mcap, want.shape[1])
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <=
                  RTOL * np.abs(want).max() + BF16_REL * np.abs(want))
    # padded rows compute zeros
    pad = np.ones(Mcap, bool)
    pad[np.asarray(pos)] = False
    assert not got[pad].any()


def test_wrapper_rules():
    """A CPU tensor takes the plain version; the kernel's layout rules (a
    256-column tile, 64-row K chunks, M tiles of 16 / 32 / 64) are the
    wrapper's to check, which it does before it touches the card."""
    leaf = {"w_q": torch.zeros((2, 128, 96), dtype=torch.uint8),
            "scale": torch.ones((2, 2, 192)), "zero": torch.zeros((2, 2, 192))}
    assert not tgqm.supports_grouped(leaf)
    leaf = {"w_q": torch.zeros((2, 128, 128), dtype=torch.uint8),
            "scale": torch.ones((2, 2, 256)), "zero": torch.zeros((2, 2, 256))}
    assert tgqm.supports_grouped(leaf)
    xs = torch.zeros((32, 128))
    te = torch.zeros(4, dtype=torch.int32)
    out = tgqm.grouped_quant_matmul(xs, te, leaf)
    assert out.shape == (32, 256) and not out.any()
    with pytest.raises(ValueError):
        tgqm.grouped_quant_matmul(xs.to("meta"), te, leaf)
