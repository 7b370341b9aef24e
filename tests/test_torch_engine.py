"""The port's Engine on the CPU: the verify drive against the JAX Engine,
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
