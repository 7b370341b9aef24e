"""The port's Engine on the CPU: the verify drive against the JAX Engine,
the decode and prefill megakernel paths against the JAX Engine's
interpret-mode megakernels, weight residency, fail-fast for impossible
requests, stop/release, unported request features, seeded sampling."""

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


def test_seeded_sampling_same_tokens_as_jax_engine():
    """Seeded top-k / top-p requests: the port's Engine draws the JAX
    Engine's noise, so both give the same tokens (tiny Qwen2, CPU)."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp

    def gens(mod):
        return [mod.GenerationConfig(max_length=20, do_sample=True, top_k=k,
                                     top_p=p, temperature=1.3, seed=seed,
                                     eos_token_id=-1)
                for seed, k, p in ((11, 50, 1.0), (2 ** 32 - 1, 0, 0.9),
                                   (7, 20, 0.95))]

    cfg, params = tiny_qwen2()
    jeng = jp.Engine().install_model("m", _rt(jp), params=params,
                                     model_config=cfg).start_model("m")
    try:
        want = [_run(jeng, jp, PROMPT, g)[1].GetAllGeneratedTokens()
                for g in gens(jp)]
    finally:
        jeng.release_model("m")
    teng = _port_engine()
    try:
        got = [_run(teng, tp, PROMPT, g)[1].GetAllGeneratedTokens()
               for g in gens(tp)]
    finally:
        teng.release_model("m")
    assert [len(t) for t in got] == [14, 14, 14]
    assert got == want
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    assert got[0] != hf_util.hf_greedy_tokens(hf, PROMPT, 14)


def _megakernel_fixture(max_length=48):
    """tests/test_megakernel.py's tiny a16w4 model (head_dim 128, L 2, hid
    256), INT8 KV, as numpy leaves for both packages."""
    import dataclasses
    import jax
    from dashinfer_tpu.config import CacheMode, QuantConfig
    from dashinfer_tpu.loader.quantize import quantize_params
    from tests.test_megakernel import _tiny
    cfg, rt, params = _tiny(B=2)
    rt = dataclasses.replace(
        rt, max_length=max_length,
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
    # pack_only needs the prefill megakernel too: with max_length 48 no
    # bucket qualifies for it, and with the megakernel off nothing does:
    # the reference's error
    with pytest.raises(ValueError, match=r"pack_only needs .*"
                       r"megakernel=True, prefill_buckets=\[\]"):
        _port_megakernel_engine(cfg, rt, np_params,
                                weight_residency="pack_only")
    cfg2, rt2, _, np2 = _megakernel_fixture(max_length=192)
    with pytest.raises(ValueError, match=r"pack_only needs .*"
                       r"megakernel=False"):
        _port_megakernel_engine(cfg2, rt2, np2, enable_megakernel=False,
                                weight_residency="pack_only")
    _, run = _port_megakernel_engine(cfg, rt, np_params,
                                     weight_residency="both")
    assert run.mega_plan is not None


def test_default_prefill_megakernel_path_same_tokens_as_jax():
    """The default configuration routes a 70-token prompt (bucket 128)
    through the prefill megakernel (its plain version on the CPU) and then
    decodes from the pages it wrote; the JAX engine does the same with both
    Pallas kernels in interpret mode. The two sum in another order, and the
    JAX package's own test of this path holds its two numeric classes to
    the first 3 tokens on this random model; here all 8 of 8 agreed when
    the test was written, and the first 3 are required."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    cfg, rt, params, np_params = _megakernel_fixture(max_length=192)
    prompt = np.random.RandomState(3).randint(
        1, cfg.vocab_size, size=70).tolist()

    def gen(mod):
        return mod.GenerationConfig(max_length=len(prompt) + 8,
                                    do_sample=False, top_k=1, eos_token_id=-1)

    jrt = JRuntime("mk", cfg, params, rt, use_kernel=True)
    assert 128 in jrt._pmk_plans
    jeng = jp.Engine()
    jeng._models["mk"] = jrt
    jeng.start_model("mk")
    try:
        _, h, jq = jeng.start_request("mk", prompt, gen(jp))
        jeng.sync_request("mk", h, timeout_s=900)
    finally:
        jeng.release_model("mk")
    teng, trun = _port_megakernel_engine(cfg, rt, np_params)
    assert sorted(trun._pmk_plans) == [128] and trun.residency == "both"
    assert trun._pmk_plans[128].qkv is trun.mega_plan.qkv
    teng.start_model("mk")
    try:
        _, h, tq = teng.start_request("mk", prompt, gen(tp))
        teng.sync_request("mk", h, timeout_s=300)
        # a 20-token prompt (bucket 32) goes per-op
        _, h2, tq2 = teng.start_request("mk", prompt[:20], gen(tp))
        teng.sync_request("mk", h2, timeout_s=300)
    finally:
        teng.release_model("mk")
    assert set(trun._prefill_steps) == {(128, True), (32, False)}
    assert tq2.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
    want, got = jq.GetAllGeneratedTokens(), tq.GetAllGeneratedTokens()
    assert len(want) == len(got) == 8
    assert got[:3] == want[:3], (got, want)


def test_prefill_megakernel_switch(monkeypatch):
    cfg, rt, _, np_params = _megakernel_fixture(max_length=192)
    monkeypatch.setenv("DI_PREFILL_MEGAKERNEL", "0")
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.mega_plan is not None and run._pmk_plans == {}
    monkeypatch.delenv("DI_PREFILL_MEGAKERNEL")
    monkeypatch.setenv("DI_WEIGHT_RESIDENCY", "pack_only")
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert run.residency == "pack_only"


def test_pack_only_serves_from_the_pack_alone():
    """`weight_residency="pack_only"`: the raw params leave the device
    tree, what the pack points at stays, a 20-token prompt is served from
    bucket 128 through the prefill megakernel with the tokens of the
    both-resident engine, and a prompt beyond the coverage is refused at
    start_request with the reference's message."""
    import dashinfer_tpu_torch as tp
    cfg, rt, _, np_params = _megakernel_fixture(max_length=192)
    prompt = np.random.RandomState(5).randint(
        1, cfg.vocab_size, size=20).tolist()
    gen = tp.GenerationConfig(max_length=28, do_sample=False, top_k=1,
                              eos_token_id=-1)
    toks = {}
    for res in ("both", "pack_only"):
        eng, run = _port_megakernel_engine(cfg, rt, np_params,
                                           weight_residency=res)
        assert run.residency == res and run._weights_resident()
        if res == "pack_only":
            assert run.params is None and run._pack_only_buckets == [128]
            host = run._raw_params_host
            packed = run.mega_params["packed"]
            # the pack aliases the loader's scale / zero and the embedding
            assert host["layers"]["q_proj"]["scale"] is \
                packed["layers"]["q_proj"]["scale"]
            assert host["embed_tokens"]["w"] is run.mega_params["embed"]
            assert host["layers"]["q_proj"]["w_q"].device.type == "cpu"
        eng.start_model("mk")
        try:
            _, h, q = eng.start_request("mk", prompt, gen)
            eng.sync_request("mk", h, timeout_s=300)
            if res == "pack_only":
                with pytest.raises(ValueError, match="exceeds the prefill "
                                   "megakernel coverage \\(128 tokens\\) "
                                   "under weight_residency=pack_only"):
                    eng.start_request("mk", list(range(1, 151)), gen)
        finally:
            eng.release_model("mk")
        assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
        toks[res] = q.GetAllGeneratedTokens()
        assert set(run._prefill_steps) == \
            {(128, True) if res == "pack_only" else (32, False)}
    # bucket 128 through the megakernel against bucket 32 per-op: two
    # numeric classes; the prefill's own argmax must agree
    assert len(toks["both"]) == len(toks["pack_only"]) == 8
    assert toks["both"][0] == toks["pack_only"][0]


MIB = 1024 ** 2


@pytest.mark.parametrize("hbm,typical,max_prompt,num_pages,want", [
    (520 * MIB, 128, 100, 0, True),     # the pool could not hold 2 x 8 pages
    (8192 * MIB, 128, 100, 0, False),   # it could
    (520 * MIB, 0, 100, 0, False),      # no workload stated
    (520 * MIB, 128, 0, 0, False),      # prompts not bounded
    (520 * MIB, 128, 150, 0, False),    # prompts may exceed bucket 128
    (520 * MIB, 128, 100, 64, False),   # an explicit pool is never resized
])
def test_auto_residency_decides_as_the_jax_runtime(hbm, typical, max_prompt,
                                                   num_pages, want):
    """`auto` follows `_auto_pack_only` of the JAX runtime (called here on
    a stand-in that carries the same configuration and weight bytes)."""
    import dataclasses
    import types
    import jax.numpy as jnp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    cfg, rt, _, np_params = _megakernel_fixture(max_length=192)
    update = dict(hbm_bytes=hbm, typical_seq_len=typical,
                  max_prompt_len=max_prompt, weight_residency="auto")
    eng, run = _port_megakernel_engine(
        cfg, dataclasses.replace(rt, cache=dataclasses.replace(
            rt.cache, num_pages=num_pages)), np_params, **update)
    assert (run.residency == "pack_only") == want
    from dashinfer_tpu_torch.engine.model_runtime import _resident_bytes
    w_both = _resident_bytes(run._raw_params_host or run.params,
                             run.mega_params)
    jrt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, num_pages=num_pages),
        **{k: v for k, v in update.items()})
    stand_in = types.SimpleNamespace(
        rt=jrt, cfg=cfg, dtype=jnp.float32, params=None, mega_params=None,
        _pmk_plans={128: None}, _per_device_nbytes=lambda tree: w_both)
    assert JRuntime._auto_pack_only(stand_in, None) == want


def _moe_fixture(max_length=64):
    """tests/test_megakernel.py's tiny Qwen2-MoE (head_dim 128, 4 experts,
    top-2, a shared expert with its gate, one query head a KV head), a16w4,
    INT8 KV, as numpy leaves for both packages."""
    import dataclasses
    import jax
    from dashinfer_tpu.config import QuantConfig
    from dashinfer_tpu.loader.quantize import quantize_params
    from tests.test_megakernel import _tiny_moe
    cfg, rt, params = _tiny_moe(B=2, KH=2, H=2)
    rt = dataclasses.replace(rt, max_length=max_length)
    params = quantize_params(params, QuantConfig(mode="a16w4",
                                                 group_size=128))
    return cfg, rt, jax.tree.map(np.asarray, params)


def test_moe_engine_same_tokens_as_jax_engine():
    """A tiny Qwen2-MoE served by the JAX Engine (its XLA path on the CPU,
    ragged experts) and by the port's Engine: per-op (`enable_megakernel`
    off, ragged experts), the 14 greedy tokens are equal; with every flag
    at its default the port decodes through the decode megakernel's MoE
    branch (its plain version on the CPU), which rounds at the TPU kernel's
    points, and the first 8 tokens must agree (the JAX package's own bound
    between its megakernel and its XLA path)."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    cfg, rt, np_params = _moe_fixture()
    name = rt.model_name
    jeng = jp.Engine().install_model(name, rt, params=np_params,
                                     model_config=cfg).start_model(name)
    try:
        _, h, jq = jeng.start_request(name, PROMPT, _greedy(jp))
        jeng.sync_request(name, h, timeout_s=600)
    finally:
        jeng.release_model(name)
    want = jq.GetAllGeneratedTokens()
    for mega in (False, True):
        teng, trun = _port_megakernel_engine(
            cfg, rt, np_params, **({} if mega else
                                   {"enable_megakernel": False}))
        assert (trun.mega_plan is not None) == mega
        if mega:
            assert trun.mega_plan.E == 4 and trun.mega_plan.G == 1
        teng.start_model("mk")
        try:
            _, h, tq = teng.start_request("mk", PROMPT, _greedy(tp))
            teng.sync_request("mk", h, timeout_s=300)
        finally:
            teng.release_model("mk")
        got = tq.GetAllGeneratedTokens()
        assert tq.GenerateStatus() == \
            tp.GenerateRequestStatus.GenerateFinished
        assert len(got) == len(want) == 14
        if mega:
            assert got[:8] == want[:8], (got, want)
        else:
            assert got == want, (got, want)


def test_moe_prefill_buckets_stop_at_the_cap():
    """A MoE model's prefill megakernel buckets stop at
    moe_prefill_mega_max_bucket (0: none), as in the JAX runtime; a fresh
    prompt of bucket 128 then goes through the kernel's MoE branch (its
    plain version on the CPU) and the request finishes."""
    import dashinfer_tpu_torch as tp
    cfg, rt, np_params = _moe_fixture(max_length=320)
    _, run = _port_megakernel_engine(cfg, rt, np_params)
    assert sorted(run._pmk_plans) == [128, 256]
    _, run = _port_megakernel_engine(
        cfg, rt, np_params, moe_prefill_mega_max_bucket=128)
    assert sorted(run._pmk_plans) == [128]
    _, run = _port_megakernel_engine(
        cfg, rt, np_params, moe_prefill_mega_max_bucket=0)
    assert run.mega_plan is not None and run._pmk_plans == {}
    eng, run = _port_megakernel_engine(
        cfg, rt, np_params, moe_prefill_mega_max_bucket=128)
    eng.start_model("mk")
    prompt = np.random.RandomState(5).randint(1, cfg.vocab_size,
                                              size=70).tolist()
    try:
        _, h, q = eng.start_request("mk", prompt, tp.GenerationConfig(
            max_length=74, do_sample=False, top_k=1, eos_token_id=-1))
        eng.sync_request("mk", h, timeout_s=300)
    finally:
        eng.release_model("mk")
    assert (128, True) in run._prefill_steps
    assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
    assert len(q.GetAllGeneratedTokens()) == 4


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_drain_raises_on_a_quant_matmul_ring_fault(monkeypatch, phase):
    """A quant_matmul launch whose copy-ring wait gave up leaves a nonzero
    status word in its device's scratch. The drain after a per-op forward
    raises before it emits that forward's token, and clears the word and
    the tickets, so that later launches run. The scratch is planted on the
    CPU device here: there is no card to time a wait out on."""
    import types

    import torch

    import dashinfer_tpu_torch as tp
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.runtime.request import Request
    from dashinfer_tpu_torch.runtime.result_queue import ResultQueue
    monkeypatch.setenv("DI_MEGAKERNEL", "0")
    monkeypatch.setenv("DI_PREFILL_MEGAKERNEL", "0")
    cfg, params = tiny_qwen2()
    eng = tp.Engine().install_model("m", _rt(tp), params=params,
                                    model_config=port_config(cfg),
                                    device="cpu")
    run = eng._models["m"]
    assert run.mega_plan is None and not run._pmk_plans
    req = Request(uuid="r", input_ids=list(PROMPT), gen_cfg=_greedy(tp))
    run.register(req, ResultQueue("r"))
    run.enqueue(req)
    fault = types.SimpleNamespace(
        status=torch.full((1,), -1, dtype=torch.int32),
        tickets=torch.ones(4, dtype=torch.int32))
    if phase == "decode":
        assert run.try_prefill_one()
        run._drain_prefill_tokens()
        assert len(req.generated_ids) == 1
        assert run.decode_tick() == 1      # in flight, not drained
    monkeypatch.setitem(qm._scratch, torch.device("cpu"), fault)
    if phase == "prefill":
        assert run.try_prefill_one()
    with pytest.raises(RuntimeError, match="quant_matmul: a ring wait"):
        run._drain_inflight()
    assert len(req.generated_ids) == (1 if phase == "decode" else 0)
    assert int(fault.status) == 0 and not fault.tickets.any()
    run._drain_inflight()                  # cleared: nothing left to raise
