"""Baichuan through the port against the JAX package, on the CPU: the
builder (`models/baichuan.py` `_model_config` on Baichuan2-13B's and
Baichuan2-7B's published configs, the converter's W_pack split and
NormHead, the registry), the `supports*` rules and `check_supported` on the
tiny ALiBi models and on Baichuan2-13B's shapes, and greedy tokens of the
port's Engine against the JAX Engine on a tiny ALiBi model (per-op,
megakernel and (1, 2) mesh paths)."""

import dataclasses

import numpy as np
import pytest
import torch


from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.models import baichuan as jbc
from dashinfer_tpu.models.registry import get_model_builder as j_builder
from dashinfer_tpu.ops.pallas import megakernel as jmk
from dashinfer_tpu.ops.pallas import prefill_megakernel as jpmk
from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu_torch.config import PositionEmbedding
from dashinfer_tpu_torch.models import baichuan as tbc
from dashinfer_tpu_torch.models import transformer as ttr
from dashinfer_tpu_torch.models.registry import get_model_builder
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_megakernel import _tiny
from tests.test_torch_megakernel import _np_tree, _port_rt
from tests.test_torch_qwen3 import PROMPT, _greedy
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

# the published config.json files, written out
BAICHUAN2_13B = dict(
    architectures=["BaichuanForCausalLM"], vocab_size=125696,
    hidden_size=5120, intermediate_size=13696, num_hidden_layers=40,
    num_attention_heads=40, rms_norm_eps=1e-6, model_max_length=4096,
    hidden_act="silu", tie_word_embeddings=False)
BAICHUAN2_7B = dict(
    architectures=["BaichuanForCausalLM"], vocab_size=125696,
    hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
    num_attention_heads=32, rms_norm_eps=1e-6, model_max_length=4096,
    hidden_act="silu", tie_word_embeddings=False)
PS = 16


def _fields(cfg) -> dict:
    """A ModelConfig's fields, enums by value (the two packages' enums are
    distinct types)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = getattr(v, "value", v)
    out["rope_scaling"] = dataclasses.asdict(cfg.rope_scaling)
    return out


@pytest.mark.parametrize("hf,alibi", [(BAICHUAN2_13B, True),
                                      (BAICHUAN2_7B, False),
                                      (dict(BAICHUAN2_7B,
                                            position_embedding="ALIBI"),
                                       True),
                                      (dict(BAICHUAN2_13B,
                                            model_max_length=2048), False)])
def test_model_config_equals_jax(hf, alibi):
    """Every field of the port's `_model_config` equals the JAX one's: the
    13B by the 40-layer / model_max_length >= 4096 rule and an explicit
    `position_embedding` take ALiBi; the 7B and a 40-layer model of 2048
    tokens RoPE."""
    want = jbc._model_config(hf)
    got = tbc._model_config(hf)
    assert _fields(got) == _fields(want)
    assert (got.position_embedding == PositionEmbedding.ALIBI) == alibi
    assert got.num_kv_heads == got.num_heads and got.head_dim == 128


def _hf_tensors(cfg, dtype, seed=0):
    """Random HF-named Baichuan tensors ([out, in], W_pack fused q|k|v)."""
    g = torch.Generator().manual_seed(seed)
    hid, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def rnd(*shape):
        return (torch.randn(shape, generator=g) * 0.05).to(dtype)
    t = {"model.embed_tokens.weight": rnd(V, hid),
         "model.norm.weight": 1 + rnd(hid),
         "lm_head.weight": rnd(V, hid)}
    for i in range(cfg.num_layers):
        b = f"model.layers.{i}"
        t.update({f"{b}.input_layernorm.weight": 1 + rnd(hid),
                  f"{b}.post_attention_layernorm.weight": 1 + rnd(hid),
                  f"{b}.self_attn.W_pack.weight": rnd(3 * hid, hid),
                  f"{b}.self_attn.o_proj.weight": rnd(hid, hid),
                  f"{b}.mlp.gate_proj.weight": rnd(inter, hid),
                  f"{b}.mlp.up_proj.weight": rnd(inter, hid),
                  f"{b}.mlp.down_proj.weight": rnd(hid, inter)})
    return t


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_trees_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _assert_trees_equal(want[k], got[k], f"{path}/{k}")
        return
    w = np.asarray(want)
    assert tuple(got.shape) == w.shape, path
    assert str(got.dtype).split(".")[-1] == w.dtype.name, (path, got.dtype)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(w), err_msg=path)


@pytest.mark.parametrize("src,dst", [(torch.float32, "float32"),
                                     (torch.bfloat16, "bfloat16"),
                                     (torch.float32, "bfloat16")])
def test_converter_equals_jax(src, dst):
    """The port's converter (through its registry) on random HF-named
    tensors equals the JAX converter's tree bit for bit: W_pack split into
    q, k, v and transposed to [in, out], every leaf stacked over the layers,
    the lm_head rows divided by their norm (NormHead) in f32 before the
    cast; bf16 in, and f32 rounded to bf16 out."""
    hf = dict(BAICHUAN2_7B, hidden_size=256, intermediate_size=384,
              num_hidden_layers=2, num_attention_heads=2, vocab_size=300)
    make_cfg, conv = get_model_builder("BaichuanForCausalLM")()
    j_make_cfg, j_conv = j_builder("BaichuanForCausalLM")()
    cfg, jcfg = make_cfg(hf), j_make_cfg(hf)
    tensors = _hf_tensors(cfg, src)
    import ml_dtypes
    jdt = np.float32 if dst == "float32" else ml_dtypes.bfloat16
    want = j_conv.convert(tensors, jcfg, jdt)
    got = conv.convert(tensors, cfg, dst)
    _assert_trees_equal(want, got)
    head = got["lm_head"]["w"].float()
    norms = head.norm(dim=0)
    tol = 1e-6 if dst == "float32" else 1e-2
    assert ((norms - 1).abs() <= tol).all()
    w_pack = tensors["model.layers.1.self_attn.W_pack.weight"]
    assert torch.equal(got["layers"]["k_proj"]["w"][1],
                       w_pack[256:512].T.to(got["layers"]["k_proj"]["w"]
                                            .dtype))
    with pytest.raises(KeyError, match="unsupported"):
        get_model_builder("BloomForCausalLM")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _rules(cfg, rt, params, n=2, bucket=128):
    """The five `supports*` rules of a JAX config and numpy params, JAX's
    and the port's."""
    tcfg, trt = port_config(cfg), _port_rt(rt, rt.cache.mode.value)
    return [
        (jmk.supports(cfg, rt, params), tmk.supports(tcfg, trt, params)),
        (jpmk.supports_prefill(cfg, rt, params, bucket),
         tpmk.supports_prefill(tcfg, trt, params, bucket)),
        (jtpk.supports_tp(cfg, rt, params, n),
         ttpk.supports_tp(tcfg, trt, params, n)),
        (jtpk.supports_prefill_tp(cfg, rt, params, bucket, n),
         ttpk.supports_prefill_tp(tcfg, trt, params, bucket, n)),
    ]


@pytest.mark.parametrize("quant,KH", [("none", 2), ("a16w4", 2),
                                      ("a16w8", 4)])
def test_supports_agree_with_jax_on_tiny_alibi(quant, KH):
    """`supports`, `supports_prefill`, `supports_tp` and
    `supports_prefill_tp` say yes to the tiny TP-shaped ALiBi models in both
    packages, and `check_supported` admits them; Bloom's LayerNorm leaves
    (w / b) say no in both."""
    cfg, rt, params = tp_fixture(quant, KH=KH, alibi=True)
    rt = dataclasses.replace(rt, max_length=128 + PS)
    ttr.check_supported(port_config(cfg))
    for j, t in _rules(cfg, rt, params):
        assert j and t
    lp = params["layers"]
    ln = dict(params, layers=dict(lp, input_layernorm={
        "w": lp["input_layernorm"],
        "b": np.zeros_like(lp["input_layernorm"])}))
    for j, t in _rules(cfg, rt, ln):
        assert j == t == False  # noqa: E712


def _shape_only_params(cfg, L=None):
    """a16w4 group-128 leaves of the model's shapes as zero-stride numpy
    views (the rules read shapes and dtypes only)."""
    L = cfg.num_layers if L is None else L
    hid, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_heads * cfg.head_dim

    def z(shape, dt):
        return np.broadcast_to(np.zeros((), dt), shape)

    def qlin(kin, kout, lead=(L,)):
        return {"w_q": z(lead + (kin, kout // 2), np.uint8),
                "scale": z(lead + (kin // 128, kout), np.float32),
                "zero": z(lead + (kin // 128, kout), np.float32)}
    return {"embed_tokens": {"w": z((V, hid), np.float32)},
            "norm": z((hid,), np.float32), "lm_head": qlin(hid, V, ()),
            "layers": {"input_layernorm": z((L, hid), np.float32),
                       "post_attention_layernorm": z((L, hid), np.float32),
                       "q_proj": qlin(hid, HD), "k_proj": qlin(hid, HD),
                       "v_proj": qlin(hid, HD), "o_proj": qlin(HD, hid),
                       "gate_proj": qlin(hid, inter),
                       "up_proj": qlin(hid, inter),
                       "down_proj": qlin(inter, hid)}}


def test_supports_agree_with_jax_on_baichuan2_13b():
    """Baichuan2-13B's shapes (a16w4 group 128, INT8 KV, page 64, batch 8):
    the decode and prefill megakernels take it in both packages; on a (1,
    2) mesh `supports_tp` and `supports_prefill_tp` say no in both (13696 /
    2 = 6848 is not a multiple of 128)."""
    from dashinfer_tpu.config import CacheConfig, RuntimeConfig
    jcfg = jbc._model_config(BAICHUAN2_13B)
    rt = RuntimeConfig(model_name="b", max_length=4096, max_batch=8,
                       cache=CacheConfig(page_size=64, num_pages=512,
                                         mode=JMode.INT8))
    ttr.check_supported(tbc._model_config(BAICHUAN2_13B))
    params = _shape_only_params(jcfg)
    rules = _rules(jcfg, rt, params, bucket=1024)
    assert rules == [(True, True), (True, True), (False, False),
                     (False, False)]
    tcfg = tbc._model_config(BAICHUAN2_13B)
    plan = tmk.make_plan(tcfg, _port_rt(rt, "int8"), params)
    assert plan.alibi and plan.G == 1 and plan.KH == 40
    assert tmk.cuda_kernel_gaps(plan) == []
    pplan = tpmk.make_prefill_plan(tcfg, _port_rt(rt, "int8"), params, 1024,
                                   decode_plan=plan)
    assert pplan.alibi and tpmk.cuda_kernel_gaps(pplan) == []


def test_check_supported_admits_alibi_and_not_bloom():
    """ALiBi passes `check_supported`; Bloom (ALiBi with GELU and tied
    embeddings) stays refused by its activation and head."""
    ttr.check_supported(tbc._model_config(BAICHUAN2_13B))
    from dashinfer_tpu_torch.config import Activation
    bloom = dataclasses.replace(tbc._model_config(BAICHUAN2_13B),
                                arch="bloom", activation=Activation.GELU,
                                tie_word_embeddings=True)
    with pytest.raises(NotImplementedError, match="activation"):
        ttr.check_supported(bloom)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

def _engine_tokens(mod, cfg, params, builder, device=None):
    kw = {} if device is None else dict(device=device)
    eng = mod.Engine().install_model("bc", builder.build(), params=params,
                                     model_config=cfg, **kw)
    run = eng._models["bc"]
    eng.start_model("bc")
    try:
        _, h, q = eng.start_request("bc", PROMPT, _greedy(mod))
        eng.sync_request("bc", h, timeout_s=900)
        return run, q.GetAllGeneratedTokens()
    finally:
        eng.release_model("bc")


def _jax_tokens(cfg, rt, params, mega):
    import dashinfer_tpu as jp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    jrt = JRuntime("bc", cfg, params,
                   dataclasses.replace(rt, enable_megakernel=mega),
                   use_kernel=mega)
    assert (jrt.mega_plan is not None) == mega
    eng = jp.Engine()
    eng._models["bc"] = jrt
    eng.start_model("bc")
    try:
        _, h, q = eng.start_request("bc", PROMPT, _greedy(jp))
        eng.sync_request("bc", h, timeout_s=900)
    finally:
        eng.release_model("bc")
    return q.GetAllGeneratedTokens()


def test_engine_tiny_alibi_same_tokens_as_jax_engine():
    """A head_dim-128 ALiBi model (H = 4 on KH = 4, f32 weights, INT8 KV:
    with a16w4 weights the two packages' per-op logits part by ~0.9% of
    their largest on this model, and its greedy step 3 is a near-tie, a
    top-2 gap of 1.5e-3, which the rule below cannot hold): the
    port's per-op install (`enable_megakernel` off) against the JAX
    Engine's XLA path, the port's default install (the decode megakernel
    with `alibi`, its plain version on the CPU) against the JAX Engine's
    megakernel in interpret mode, and the port's (1, 2) mesh of the CPU
    (the TP segments) against its own single-device serving. The two
    packages sum in other orders, so a late near-tie of a random tiny
    model may flip: the first 10 of 14 tokens agree
    (tests/test_torch_engine.py's rule)."""
    import dashinfer_tpu_torch as tp
    cfg, rt, params = _tiny(B=2, KH=4, H=4, alibi=True)
    rt = dataclasses.replace(
        rt, max_length=48,
        cache=dataclasses.replace(rt.cache, mode=JMode.INT8))
    np_params = _np_tree(params)
    tcfg = port_config(cfg)

    def b(mega=True, mesh=1):
        out = (tp.RuntimeConfigBuilder("bc").max_length(rt.max_length)
               .max_batch(rt.max_batch).kv_cache_page_size(PS)
               .kv_cache_num_pages(rt.cache.num_pages)
               .kv_cache_mode(tp.CacheMode.INT8).dtype(rt.dtype)
               .update({"min_prefill_bucket": rt.min_prefill_bucket,
                        "enable_megakernel": mega}))
        return out.mesh(1, mesh) if mesh > 1 else out

    for mega in (False, True):
        want = _jax_tokens(cfg, rt, params, mega)
        run, got = _engine_tokens(tp, tcfg, np_params, b(mega), "cpu")
        assert (run.mega_plan is not None) == mega
        if mega:
            assert run.mega_plan.alibi
            single = got
        assert len(got) == len(want) == 14 and got[:10] == want[:10], \
            (mega, got, want)
    run, mesh_got = _engine_tokens(tp, tcfg, np_params, b(mesh=2),
                                   ["cpu", "cpu"])
    assert run.tp_mega_plan is not None and run.tp_mega_plan.alibi
    assert mesh_got[:10] == single[:10], (mesh_got, single)
