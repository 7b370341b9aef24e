"""The port's per-rank split (ops/tp_megakernel.py, parallel/sharding.py)
against the JAX package's `split_params_tp`, `local_config` and
`supports_tp`, on the tiny TP shape of tests/test_tp_megakernel.py (L = 2,
H = 4, hid 256, inter 256, vocab 512), on the CPU: the same numpy tree
through both, the leaves bit-equal, the decisions equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from dashinfer_tpu_torch.parallel import make_mesh, shard_params
from tests.test_megakernel import _tiny
from tests.test_torch_megakernel import _port_rt
from tests.test_torch_transformer import port_config

_cache = {}


def tp_fixture(quant: str, KH: int = 2, dtype: str = "float32",
               alibi: bool = False):
    """(cfg, rt, numpy params) of the tiny TP shape, quantized: "a16w4"
    (group 128), "a16w8" (per-channel), "a16w8g" (group 128) or "none";
    `alibi`: the ALiBi model of that shape (no q|k|v bias)."""
    key = (quant, KH, dtype, alibi)
    if key not in _cache:
        cfg, rt, params = _tiny(B=4, L=2, KH=KH, H=4, hid=256, inter=256,
                                vocab=512, dtype=dtype, alibi=alibi)
        if quant != "none":
            q = QuantConfig(mode=quant[:5], group_size=(
                -1 if quant == "a16w8" else 128))
            params = quantize_params(params, q)
        _cache[key] = (cfg, rt, jax.tree.map(np.asarray, params))
    return _cache[key]


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_bit_equal(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            assert_bit_equal(want[k], got[k], f"{path}/{k}")
        return
    w, g = _np(want), _np(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (path, w.dtype,
                                                       g.dtype, w.shape,
                                                       g.shape)
    np.testing.assert_array_equal(w, g, err_msg=path)


@pytest.mark.parametrize("quant,dtype", [
    ("a16w4", "float32"),   # q: tile-aligned shares; k, v, lm_head (n = 4)
                            # are unpacked and repacked
    ("a16w8", "float32"),   # per-channel: one group replicates on rows
    ("a16w8g", "float32"),  # group-wise: the groups follow the rows
    ("none", "bfloat16")])
@pytest.mark.parametrize("n", [2, 4])
def test_split_params_tp_bit_equal_to_jax(quant, dtype, n):
    cfg, _, params = tp_fixture(quant, dtype=dtype)
    want = jtpk.split_params_tp(params, cfg, n)
    tparams = params_from_numpy(params, "cpu", getattr(torch, dtype))
    got = ttpk.split_params_tp(tparams, port_config(cfg), n)
    for r in range(n):
        assert_bit_equal(want[r], got[r], f"rank {r}")
    if quant == "a16w4":
        # both paths of the u4 column slice ran: q's share is whole tiles
        # at n = 2, k's is not
        assert (cfg.num_heads * 128 // n) % 256 == 0 or n == 4
        assert (cfg.num_kv_heads * 128 // n) % 256 != 0
    # the runtime's per-rank trees on a mesh of repeated CPU ranks are the
    # same leaves; KV heads that do not divide among the ranks replicate
    # the K/V weights
    mesh = make_mesh((1, n), ["cpu"] * n)
    ranks = shard_params(tparams, port_config(cfg), mesh)
    for r in range(n):
        lp, wl = ranks[r]["layers"], want[r]["layers"]
        for name in ("q_proj", "o_proj", "gate_proj", "down_proj"):
            assert_bit_equal(wl[name], lp[name], f"rank {r} {name}")
        for name in ("k_proj", "v_proj"):
            full = cfg.num_kv_heads % n != 0
            assert_bit_equal(params["layers"][name] if full else wl[name],
                             lp[name], f"rank {r} {name}")


@pytest.mark.parametrize("n", [2, 4])
def test_local_config_equals_jax(n):
    cfg, _, _ = tp_fixture("none", KH=4)
    assert ttpk.local_config(port_config(cfg), n) == \
        port_config(jtpk.local_config(cfg, n))


@pytest.mark.parametrize("quant,mode,KH", [
    ("none", "default", 2), ("none", "int8", 2), ("a16w4", "int8", 2),
    ("a16w8", "int8", 4), ("a16w8g", "int8", 2), ("a16w4", "uint4", 4),
    ("a16w4", "uint4", 2)])
@pytest.mark.parametrize("n", [2, 4])
def test_supports_tp_decides_as_jax(quant, mode, KH, n):
    """Equal decisions, but for the JAX UINT4 rule of 128 K/V lanes a rank
    (KH/n * D/2), a Mosaic tiling rule the port does not keep."""
    cfg, rt, params = tp_fixture(quant, KH=KH)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    want = jtpk.supports_tp(cfg, rt, params, n)
    got = ttpk.supports_tp(port_config(cfg), _port_rt(rt, mode), params, n)
    lane_rule = mode == "uint4" and KH // n * 64 < 128 and \
        KH % n == 0 and (cfg.intermediate_size // n) % 128 == 0
    if lane_rule:
        assert got and not want
    else:
        assert got == want
    # what the two say no to alike: a width that does not divide, MoE
    assert not ttpk.supports_tp(
        dataclasses.replace(port_config(cfg), num_heads=6),
        _port_rt(rt, mode), params, 4)


def test_mesh_rules():
    """make_mesh raises as the JAX function when the devices are too few;
    a data axis > 1 is not served; repeated devices only when listed."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh((1, 2), ["cpu"])
    with pytest.raises(NotImplementedError, match="data axis"):
        make_mesh((2, 1), ["cpu", "cpu"])
    m = make_mesh((1, 2), ["cpu", "cpu", "cpu"])
    assert m.n == 2 and m.devices == (torch.device("cpu"),) * 2
    assert m.distinct == (torch.device("cpu"),)
    from dashinfer_tpu_torch.parallel import collective_kind
    assert collective_kind(m.devices) == "same-device sum"
    assert collective_kind([torch.device("cuda", 0),
                            torch.device("cuda", 1)]) == "nccl"
    with pytest.raises(NotImplementedError):
        collective_kind([torch.device("cuda", 0)] * 2 +
                        [torch.device("cuda", 1)])


def test_all_reduce_and_gather():
    from dashinfer_tpu_torch.parallel import all_gather_vocab, all_reduce_
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 5, generator=g) for _ in range(3)]
    want = parts[0] + parts[1] + parts[2]
    out = all_reduce_([p.clone() for p in parts])
    for p in out:
        torch.testing.assert_close(p, want, rtol=0, atol=0)
    half = [p.to(torch.bfloat16) for p in parts[:2]]
    out = all_reduce_([h.clone() for h in half])
    assert out[1].dtype == torch.bfloat16
    torch.testing.assert_close(out[1], (half[0].float() + half[1].float())
                               .to(torch.bfloat16), rtol=0, atol=0)
    cat = all_gather_vocab([torch.ones(2, 3), torch.zeros(2, 4)])
    assert cat.shape == (2, 7) and cat[:, :3].eq(1).all()


def test_padded_qkv_widths_and_the_kernels():
    """A rank's q / k / v of 128 mod 256 columns (Qwen2-7B's at n = 4;
    here the tiny model's k and v at n = 2): the decode
    pack pads each leaf to its 256-column tiles, which the decode and
    segment kernels' attention phase reads at the leaves' padded offsets
    (csrc/di_layer.cuh), and so does the prefill kernels' q|k|v phase
    (csrc/di_prefill_layer.cuh): their gaps name none of them."""
    from dashinfer_tpu_torch.ops import megakernel as tmk
    from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
    cfg, rt, params = tp_fixture("a16w4")
    tcfg = port_config(cfg)
    trt = _port_rt(rt, "int8")
    tparams = params_from_numpy(params, "cpu", torch.float32)
    plan, packs = ttpk.make_tp_plan(tcfg, trt, ttpk.split_params_tp(
        tparams, tcfg, 2))
    assert plan.qkv.N == (256, 128, 128) and plan.qkv.Np == (256, 256, 256)
    assert packs[0]["layers"]["k_proj"]["w_f"].shape[-3] == 1   # one tile
    assert not tmk.cuda_kernel_gaps(plan)
    local = ttpk.local_config(tcfg, 2)
    pplan = tpmk.make_prefill_plan(local, trt, ttpk.split_params_tp(
        tparams, tcfg, 2)[0], 128, decode_plan=plan)
    assert pplan.qkv is plan.qkv and tpmk.cuda_kernel_gaps(pplan) == []


def _moe_fixture(quant: str, E: int = 4, Im: int = 256, KH: int = 2):
    """tests/test_megakernel.py's tiny Qwen2-MoE (hid 256, 4 query heads on
    KH, top-2, a gated shared expert of width Im), quantized with group 128
    or f32."""
    from tests.test_megakernel import _tiny_moe
    cfg, rt, params = _tiny_moe(B=4, KH=KH, H=4, E=E, Im=Im)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    return cfg, rt, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("quant", ["none", "a16w8", "a16w4"])
@pytest.mark.parametrize("n", [2, 4])
def test_moe_split_bit_equal_to_jax(quant, n):
    """Each rank's experts (its contiguous group), shared expert (column
    gate|up, row down) and shared gate (whole) are the JAX `_split_rank`'s,
    bit for bit; the router stays whole on every rank (the JAX function
    slices it and its `make_tp_plan` packs the whole one)."""
    cfg, _, params = _moe_fixture(quant)
    want = jtpk.split_params_tp(params, cfg, n)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    got = ttpk.split_params_tp(tparams, port_config(cfg), n)
    for r in range(n):
        wl, gl = dict(want[r]["layers"]), dict(got[r]["layers"])
        assert_bit_equal(params["layers"]["router"], gl.pop("router"),
                         f"rank {r} router")
        wl.pop("router")
        assert_bit_equal(wl, gl, f"rank {r}")
        assert gl["experts"]["down_proj"]["w_q" if quant != "none" else
                                          "scale"].shape[1] == 4 // n \
            if quant != "none" else gl["experts"]["down_proj"].shape[1] == \
            4 // n
        for k in ("embed_tokens", "norm", "lm_head"):
            assert_bit_equal(want[r][k], got[r][k], f"rank {r} {k}")


@pytest.mark.parametrize("quant", ["none", "a16w8"])
def test_moe_tp_plan_router_equals_jax(quant):
    """The TP plan routes over all experts: the port's packed router of
    every rank, unpacked, is the JAX `make_tp_plan`'s `router_w` (the
    global router and the shared gate at lane E, bf16, EP lanes)."""
    from dashinfer_tpu_torch.ops import megakernel as tmk
    from tests.test_torch_megakernel import _port_rt
    cfg, rt, params = _moe_fixture(quant)
    jplan, jpacked = jtpk.make_tp_plan(cfg, rt, params, 2)
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    plan, packs = ttpk.make_tp_plan(tcfg, _port_rt(rt, "int8"),
                                    ttpk.split_params_tp(tparams, tcfg, 2))
    assert (plan.E, plan.E_global, plan.EP, plan.rt.N) == (2, 4, 128, (128,))
    assert plan.E == jplan.E and plan.shared_inter == jplan.shared_inter
    for r in range(2):
        rw = tmk.loader_view(packs[r]["layers"]["router"])["w"]
        assert_bit_equal(np.asarray(jpacked["router_w"][r]),
                         rw[..., :plan.EP].contiguous(), f"rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_moe_local_config_equals_jax(n):
    cfg, _, _ = _moe_fixture("none")
    assert ttpk.local_config(port_config(cfg), n) == \
        port_config(jtpk.local_config(cfg, n))


@pytest.mark.parametrize("quant,E,Im", [
    ("none", 4, 256),      # n = 2 yes; n = 4: shared 64 a rank, no
    ("a16w4", 4, 256),
    ("a16w8", 6, 256),     # n = 4: 6 experts do not divide
    ("a16w4", 4, 512)])    # n = 4: shared 128 a rank, yes
@pytest.mark.parametrize("n", [2, 4])
def test_moe_supports_tp_decides_as_jax(quant, E, Im, n):
    """Equal decisions; yes where the experts divide among the ranks and
    the rank's shared width is a multiple of 128 (four KV heads)."""
    cfg, rt, params = _moe_fixture(quant, E, Im, KH=4)
    from tests.test_torch_megakernel import _port_rt
    want = jtpk.supports_tp(cfg, rt, params, n)
    got = ttpk.supports_tp(port_config(cfg), _port_rt(rt, "int8"), params, n)
    assert got == want
    assert want == (E % n == 0 and (Im // n) % 128 == 0)


@pytest.mark.parametrize("n,V", [(2, 384), (4, 640)])
def test_vocab_shard_of_64_or_32_mod_128_packs(n, V):
    """A vocab shard whose width is 64 (n = 2: 192) or 32 (n = 4: 160) mod 128,
    as Qwen1.5-MoE's 151936 splits into 75968 and 37984: the pack pads it to
    its 256-column tiles (the u4 payload re-laid from plain halves into
    TILE-128 halves), the TP lm segments (decode and prefill) have no CUDA gap
    for it (the megakernels keep theirs), and unpacked it is the split leaf in
    its true columns, zeros after them; the plain lm product is the loader
    leaf's."""
    from dashinfer_tpu.loader.quantize import _quantize_stacked
    from dashinfer_tpu_torch.ops import megakernel as tmk
    from dashinfer_tpu_torch.ops.u4pack import weight_levels
    from tests.test_torch_megakernel import _port_rt
    cfg, rt, params = _tiny(B=4, L=2, KH=4, H=4, hid=256, inter=512,
                            vocab=V, dtype="float32")
    params = jax.tree.map(np.asarray, quantize_params(
        params, QuantConfig(mode="a16w4", group_size=128)))
    lm = _quantize_stacked(np.asarray(params["lm_head"]["w"])[None], 4, 128)
    params["lm_head"] = {k: v[0] for k, v in lm.items()}
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    parts = ttpk.split_params_tp(tparams, tcfg, n)
    plan, packs = ttpk.make_tp_plan(tcfg, _port_rt(rt, "int8"), parts)
    Vn = V // n
    assert Vn % 128 == 128 // n and plan.lm.N == (Vn,)
    assert plan.lm.Np == (-(-Vn // 256) * 256,)
    # the TP lm segments (decode and prefill) take the shard; the
    # megakernels keep the 128 rule
    assert tmk.stream_gaps(plan.lm, any_lm_width=True) == []
    assert not [g for g in ttpk.cuda_kernel_gaps(plan) if g.startswith("lm")]
    pplan = ttpk.make_tp_prefill_plans(tcfg, _port_rt(rt, "int8"), parts,
                                       [128], plan)[128]
    assert not [g for g in ttpk.prefill_cuda_kernel_gaps(pplan)
                if g.startswith("lm")]
    assert tmk.stream_gaps(plan.lm)
    for r in range(n):
        lm, leaf = packs[r]["lm_head"], parts[r]["lm_head"]
        un = tmk.loader_view(lm)
        lv = weight_levels(un["w_q"])
        assert lv.shape == (256, plan.lm.Np[0])
        assert torch.equal(lv[:, :Vn], weight_levels(leaf["w_q"]))
        assert not lv[:, Vn:].any()
        for k in ("scale", "zero"):
            assert torch.equal(un[k][:, :Vn], leaf[k])
            assert not un[k][:, Vn:].any()
        x = torch.randn(4, 256, generator=torch.Generator().manual_seed(r)
                        ).to(torch.bfloat16)
        torch.testing.assert_close(tmk.leaf_dot(x, lm)[:, :Vn],
                                   tmk.leaf_dot(x, leaf), rtol=1e-5,
                                   atol=1e-5)
