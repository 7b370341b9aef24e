"""The port's Engine on the CPU: the verify drive against the JAX Engine,
the megakernel path against the JAX Engine's interpret-mode megakernel,
fail-fast for impossible requests, stop/release, unported request features,
seeded sampling."""

import numpy as np
import pytest

import tests.hf_util as hf_util
from tests.test_torch_transformer import port_config, tiny_qwen2

PROMPT = [5, 9, 2, 41, 77, 3]


def _greedy(mod, **kw):
    return mod.GenerationConfig(max_length=20, do_sample=False, top_k=1,
                                eos_token_id=-1, **kw)


def _rt(mod, num_pages=24, max_length=96):
    return (mod.RuntimeConfigBuilder("m").max_length(max_length).max_batch(2)
            .kv_cache_page_size(16).kv_cache_num_pages(num_pages)
            .dtype("float32").update({"min_prefill_bucket": 16}).build())


def _port_engine(**rt_kw):
    import dashinfer_tpu_torch as tp
    cfg, params = tiny_qwen2()
    eng = tp.Engine().install_model("m", _rt(tp, **rt_kw), params=params,
                                     model_config=port_config(cfg),
                                     device="cpu")
    return eng.start_model("m")


def _run(eng, mod, ids, gen):
    _, h, q = eng.start_request("m", ids, gen)
    eng.sync_request("m", h, timeout_s=300)
    return h, q


def test_verify_drive_same_tokens_as_jax_engine():
    """The repository's documented verify drive (tiny Qwen2, 6-token
    prompt): 14 greedy tokens, equal through both Engines and to the HF
    model's own greedy continuation."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    cfg, params = tiny_qwen2()
    jeng = jp.Engine().install_model("m", _rt(jp), params=params,
                                     model_config=cfg).start_model("m")
    try:
        _, jq = _run(jeng, jp, PROMPT, _greedy(jp))
    finally:
        jeng.release_model("m")
    teng = _port_engine()
    try:
        _, tq = _run(teng, tp, PROMPT, _greedy(tp))
    finally:
        teng.release_model("m")
    assert tq.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
    assert jq.GenerateStatus() == jp.runtime.request.GenerateRequestStatus \
        .GenerateFinished
    toks = tq.GetAllGeneratedTokens()
    assert len(toks) == 14
    assert toks == jq.GetAllGeneratedTokens()
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    assert toks == hf_util.hf_greedy_tokens(hf, PROMPT, 14)


def test_impossible_request_fails_fast():
    """A prompt wanting more pages than the whole pool: InternalError, not a
    request pending forever."""
    import dashinfer_tpu_torch as tp
    eng = _port_engine(num_pages=4)
    try:
        ids = list(np.random.RandomState(0).randint(1, 500, 80))
        _, q = _run(eng, tp, ids, tp.GenerationConfig(
            max_length=90, do_sample=False, top_k=1, eos_token_id=-1))
        assert q.GenerateStatus() == tp.GenerateRequestStatus.InternalError
        # the engine keeps serving
        _, q2 = _run(eng, tp, PROMPT, _greedy(tp))
        assert q2.GenerateStatus() == \
            tp.GenerateRequestStatus.GenerateFinished
    finally:
        eng.release_model("m")


def test_stop_request_interrupts_and_frees_pages():
    import dashinfer_tpu_torch as tp
    eng = _port_engine(max_length=320)     # long enough to stop mid-way
    try:
        _, h, q = eng.start_request("m", PROMPT, tp.GenerationConfig(
            max_length=320, do_sample=False, top_k=1, eos_token_id=-1))
        q.Get(timeout_s=60)                 # first token(s) arrived
        eng.stop_request("m", h)
        assert q.GenerateStatus() == \
            tp.GenerateRequestStatus.GenerateInterrupted
        assert len(q.GetAllGeneratedTokens()) < 320 - len(PROMPT)
        eng.release_request("m", h)
        assert eng.get_engine_stat("m")["used_span"] == 0
    finally:
        eng.release_model("m")


@pytest.mark.parametrize("field,value", [
    ("logprobs", True),
    ("response_format", {"type": "json_object"}),
    ("bad_words_ids", [[3]]),
    ("no_repeat_ngram_size", 2),
    ("lora_name", "adapter"),
    ("mm_info", [(5, np.zeros((1, 64), np.float32))]),
])
def test_unported_request_feature_raises(field, value):
    import dashinfer_tpu_torch as tp
    eng = _port_engine()
    try:
        gen = _greedy(tp).update({field: value})
        with pytest.raises(NotImplementedError):
            eng.start_request("m", PROMPT, gen)
    finally:
        eng.release_model("m")


def test_seeded_sampling_is_reproducible():
    import dashinfer_tpu_torch as tp
    eng = _port_engine()
    try:
        def sampled(seed):
            gen = tp.GenerationConfig(max_length=20, do_sample=True, top_k=50,
                                      temperature=1.0, seed=seed,
                                      eos_token_id=-1)
            _, q = _run(eng, tp, PROMPT, gen)
            assert q.GenerateStatus() == \
                tp.GenerateRequestStatus.GenerateFinished
            return q.GetAllGeneratedTokens()

        a, b, c = sampled(11), sampled(11), sampled(12)
        assert a == b and len(a) == 14
        assert a != c
    finally:
        eng.release_model("m")


def _megakernel_fixture():
    """tests/test_megakernel.py's tiny a16w4 model (head_dim 128, L 2, hid
    256), INT8 KV, as numpy leaves for both packages."""
    import dataclasses
    import jax
    from dashinfer_tpu.config import CacheMode, QuantConfig
    from dashinfer_tpu.loader.quantize import quantize_params
    from tests.test_megakernel import _tiny
    cfg, rt, params = _tiny(B=2)
    rt = dataclasses.replace(
        rt, max_length=48,
        cache=dataclasses.replace(rt.cache, mode=CacheMode.INT8))
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    return cfg, rt, params, jax.tree.map(np.asarray, params)


def _port_megakernel_engine(cfg, rt, np_params, **update):
    import dashinfer_tpu_torch as tp
    trt = (tp.RuntimeConfigBuilder("mk").max_length(rt.max_length)
           .max_batch(rt.max_batch).kv_cache_page_size(rt.cache.page_size)
           .kv_cache_num_pages(rt.cache.num_pages)
           .kv_cache_mode(tp.CacheMode.INT8).dtype(rt.dtype)
           .update({"min_prefill_bucket": rt.min_prefill_bucket, **update})
           .build())
    eng = tp.Engine().install_model("mk", trt, params=np_params,
                                    model_config=port_config(cfg),
                                    device="cpu")
    return eng, eng._models["mk"]


def test_default_megakernel_path_same_tokens_as_jax_megakernel():
    """`enable_megakernel` left at its default: the port's runtime plans,
    packs and decodes through `decode_megakernel` (its plain version on the
    CPU), and gives the greedy tokens of the JAX engine whose megakernel
    runs in interpret mode. Both round to bf16 at the same points but sum
    in another order, and a late near-tie of a random tiny model may flip:
    the first 10 of 14 tokens must agree (the JAX package's own tolerance
    between its megakernel and its fallback)."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    cfg, rt, params, np_params = _megakernel_fixture()
    # use_kernel normally needs a TPU; forcing it makes the runtime pack
    jrt = JRuntime("mk", cfg, params, rt, use_kernel=True)
    assert jrt.mega_plan is not None
    jeng = jp.Engine()
    jeng._models["mk"] = jrt
    jeng.start_model("mk")
    try:
        _, h, jq = jeng.start_request("mk", PROMPT, _greedy(jp))
        jeng.sync_request("mk", h, timeout_s=900)
    finally:
        jeng.release_model("mk")
    assert rt.enable_megakernel          # the default, untouched
    teng, trun = _port_megakernel_engine(cfg, rt, np_params)
    assert trun.mega_plan is not None and trun.rt.enable_megakernel
    assert trun.mega_params["embed"] is trun.params["embed_tokens"]["w"]
    teng.start_model("mk")
    try:
        _, h, tq = teng.start_request("mk", PROMPT, _greedy(tp))
        teng.sync_request("mk", h, timeout_s=300)
    finally:
        teng.release_model("mk")
    want, got = jq.GetAllGeneratedTokens(), tq.GetAllGeneratedTokens()
    assert len(want) == len(got) == 14
    assert got[:10] == want[:10], (got, want)


def test_megakernel_install_rules(monkeypatch):
    """The install order's branches: off by config or by DI_MEGAKERNEL=0,
    an unsupported model served per-op, the u4 -> i8 stream rule, and
    weight_residency."""
    import dashinfer_tpu_torch as tp
    cfg, rt, _, np_params = _megakernel_fixture()
    _, run = _port_megakernel_engine(cfg, rt, np_params,
                                     enable_megakernel=False)
    assert run.mega_plan is None
    monkeypatch.setenv("DI_MEGAKERNEL", "0")
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.mega_plan is None
    monkeypatch.delenv("DI_MEGAKERNEL")
    # head_dim 16: `supports` says no, the per-op path serves (and the
    # verify drive above still gives the HF model's tokens)
    eng = _port_engine()
    try:
        assert eng._models["m"].mega_plan is None
    finally:
        eng.release_model("m")
    # the stream rule: u4 below the batch threshold, per-channel i8 at it
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.mega_plan.qkv.bits == 4 and run.mega_plan.lm.bits == 16
    monkeypatch.setenv("DI_MK_I8_BATCH", "2")
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.mega_plan.qkv.bits == 8 and run.mega_plan.dn.gs == \
        cfg.intermediate_size
    import torch
    assert run.params["layers"]["q_proj"]["w_q"].dtype == torch.uint8
    monkeypatch.setenv("DI_MK_STREAM", "u4")
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.mega_plan.qkv.bits == 4
    monkeypatch.delenv("DI_MK_STREAM")
    monkeypatch.delenv("DI_MK_I8_BATCH")
    # pack_only needs the prefill megakernel too: the reference's error
    with pytest.raises(ValueError, match="pack_only"):
        _port_megakernel_engine(cfg, rt, np_params,
                                weight_residency="pack_only")
    _, run = _port_megakernel_engine(cfg, rt, np_params,
                                     weight_residency="both")
    assert run.mega_plan is not None
