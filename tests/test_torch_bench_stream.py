"""The stream-rate probe tool on the CPU: its wrappers take the plain
versions for CPU tensors, and the launch geometry helpers that the CUDA
kernels rely on keep their invariants."""

import numpy as np
import pytest
import torch

from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops.linear import dequantize_weight
from dashinfer_tpu_torch.tools import bench_stream


def test_stream_copy_plain_sums_words_mod_2_32():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, 4096).astype(np.uint8)
    want = int(a.view(np.uint32).astype(np.uint64).sum() % (1 << 32))
    assert bench_stream.stream_copy(torch.from_numpy(a)) == want


# the product is affine-after-dot on bf16 x with qparams rounded to bf16;
# dequantize-then-matmul in f32 differs by that rounding of scale and zero
# (2^-9 relative each): |d| <= 1e-2 * max|ref|
@pytest.mark.parametrize("fmt", bench_stream.FORMATS[1:])
def test_stream_product_on_cpu_is_dequantize_then_matmul(fmt):
    gen = torch.Generator().manual_seed(3)
    K, N, B = 256, 512, 5
    leaf = bench_stream.random_leaf(fmt, K, N, gen, "cpu")
    x = torch.randn((B, K), generator=gen).to(torch.bfloat16)
    got = bench_stream.stream_product(x, leaf)
    w = leaf["w"].float() if "w" in leaf else \
        dequantize_weight(leaf, torch.float32)
    ref = x.float() @ w
    assert got.shape == (B, N) and got.dtype == torch.float32
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
    sp = mk._stream_plan("probe", ("w",), [leaf], 0)
    assert sp.bits == {"bf16": 16, "u4_g128": 4}.get(fmt, 8)
    assert sp.gs == {"bf16": 0, "i8_pc": K}.get(fmt, 128)
    assert mk.stream_gaps(sp) == []


def test_random_a16w4_params_streams():
    from dashinfer_tpu_torch.config import ModelConfig
    cfg = ModelConfig(arch="qwen2", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=2,
                      num_kv_heads=1, head_dim=128, qkv_bias=True)
    u4 = bench_stream.random_a16w4_params(cfg, 0, "cpu")
    i8 = bench_stream.random_a16w4_params(cfg, 0, "cpu", stream="i8")
    assert u4["layers"]["gate_proj"]["w_q"].shape == (2, 256, 256)
    assert i8["layers"]["gate_proj"]["w_q"].shape == (2, 256, 512)
    assert i8["layers"]["gate_proj"]["scale"].shape == (2, 1, 512)
    # the i8 leaves are the u4 leaves re-expanded: same weights within one
    # i8 step of each channel
    wu = dequantize_weight({k: v[0] for k, v in
                            u4["layers"]["gate_proj"].items()}, torch.float32)
    wi = dequantize_weight({k: v[0] for k, v in
                            i8["layers"]["gate_proj"].items()}, torch.float32)
    assert ((wu - wi).abs() <= i8["layers"]["gate_proj"]["scale"][0]).all()


@pytest.mark.parametrize("tiles,chunks,grid", [(18, 56, 264), (148, 56, 264),
                                               (14, 296, 132), (594, 56, 264),
                                               (1, 4, 8)])
def test_choose_split_covers_k_exactly(tiles, chunks, grid):
    ks, cps = mk.choose_split(tiles, chunks, 8192, 8, 1, grid)
    assert 1 <= ks <= chunks
    assert (ks - 1) * cps < chunks <= ks * cps     # no empty split
    assert mk.padded_rows(8) == 16 and mk.padded_rows(17) == 32 and \
        mk.padded_rows(33) == 64


def test_kernel_sources_are_registered():
    from dashinfer_tpu_torch.ops import kernel_build
    assert set(kernel_build.SOURCES) == {"quant_matmul", "paged_attention",
                                         "megakernel", "stream_probe",
                                         "prefill_megakernel", "probes",
                                         "grouped_quant_matmul",
                                         "tp_segments",
                                         "tp_prefill_segments"}
    for name in kernel_build.SOURCES:     # hash covers the shared headers
        assert kernel_build.lib_path(name).endswith(".so")
