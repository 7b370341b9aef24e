"""Guided (JSON) decoding: the port's `engine/guided.py` against the JAX
package's on the same inputs (CPU), then JSON mode through both Engines.

`JsonState` / `advance_str` give the JAX acceptor's verdict and state on
every prefix of a list of JSON and non-JSON strings; the enforcer's
`allowed_mask` equals the JAX one (exactly: bool masks) over
tests/test_guided.py's FakeTokenizer along random walks of allowed tokens;
a seeded JSON-mode request through the port's Engine gives the JAX Engine's
tokens, a JSON prefix (the text of every id but the EOS id 0, which is
also the '{' string), on a runtime with decode_steps_per_launch = 3 (a
guided request takes synchronous single steps); and the enforcer has seen
every emitted token, the async prefill's first one included, before each
mask is computed."""

import json

import numpy as np
import pytest

import tests.hf_util as hf_util
from dashinfer_tpu.engine import guided as jg
from dashinfer_tpu_torch.engine import guided as tg
from tests.test_guided import FakeTokenizer, _vocab
from tests.test_torch_multistep import held_admission

TEXTS = ['{}', '{"a": 1}', '{"a": [1, 2, {"b": null}], "c": "x"}',
         '{"s": "he\\"llo", "n": -1.5e8}', '[1, 2]', '[]', '{"k": true}',
         '{,', '{"a" 1}', '{"a": 01}', '{"a": tru]', '}', '{"a": 1}}',
         '{"a": .5}', '{"a": 1,,', 'hello', '{"a": [1,', ' { "x" : "\\u',
         '{"a": -0.25E+3, "b": false}', '{"\n"}']


@pytest.mark.parametrize("text", TEXTS)
def test_json_state_matches_jax(text):
    """Every prefix: the same accept / reject verdict, the same state key
    and the same completeness."""
    js, ts = jg.JsonState(), tg.JsonState()
    for i in range(1, len(text) + 1):
        ok_j = jg.advance_str(js, text[i - 1])
        ok_t = tg.advance_str(ts, text[i - 1])
        assert ok_t == ok_j, (text, i)
        if not ok_j:
            break
        assert ts.key() == js.key(), (text, i)
        assert tg.is_complete(ts) == jg.is_complete(js)


@pytest.mark.parametrize("seed", range(4))
def test_enforcer_masks_match_jax(seed):
    """Random walks through the allowed tokens of 64- and 200-id FakeTokenizer
    vocabularies: the masks are equal at every step, the text stays a JSON
    prefix, and a completed text parses."""
    n = 64 if seed % 2 == 0 else 200
    strings = _vocab(n)
    tok = FakeTokenizer(strings)
    je = jg.JsonFormatEnforcer(tok, eos_token_id=0, vocab_size=n)
    te = tg.JsonFormatEnforcer(tok, eos_token_id=0, vocab_size=n)
    rng = np.random.RandomState(seed)
    text = ""
    for _ in range(60):
        mask = te.allowed_mask()
        assert mask.dtype == bool and mask.shape == (n,)
        assert np.array_equal(mask, je.allowed_mask()), text
        if te.complete:
            break
        tid = int(rng.choice(np.nonzero(mask)[0]))
        assert te.advance(tid) and je.advance(tid)
        text += strings[tid] if tid != 0 else ""
    st = tg.JsonState()
    assert tg.advance_str(st, text), text
    if te.complete:
        json.loads(text)


def _json_engine(mod, tok, params, cfg):
    rt = (mod.RuntimeConfigBuilder("json").max_length(64).max_batch(2)
          .kv_cache_page_size(16).kv_cache_num_pages(16).dtype("float32")
          .update({"min_prefill_bucket": 16, "decode_steps_per_launch": 3,
                   "enable_json_mode": True}).build())
    kw = {} if mod.__name__ == "dashinfer_tpu" else dict(device="cpu")
    return mod.Engine().install_model("json", rt, params=params,
                                      model_config=cfg, tokenizer=tok,
                                      **kw).start_model("json")


def test_json_mode_same_tokens_as_jax_engine():
    """A seeded json_object request (FakeTokenizer over a 64-id vocab, EOS
    0) beside a greedy plain one, admitted in one tick: the port's tokens equal the JAX
    Engine's; the JSON output is a JSON prefix (complete JSON where the
    acceptor says so); a batch that holds the guided request takes single
    steps only."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu.loader import build_from_torch_model
    from tests.test_torch_transformer import port_config

    hf_cfg = hf_util.tiny_qwen2_config(vocab=64)
    cfg, params = build_from_torch_model(hf_util.make_torch_model(hf_cfg),
                                         hf_cfg.to_dict(), "float32")
    strings = _vocab(64)
    tok = FakeTokenizer(strings)
    out = {}
    for mod in (jp, tp):
        eng = _json_engine(mod, tok, params,
                           cfg if mod is jp else port_config(cfg))
        try:
            gens = [mod.GenerationConfig(
                max_length=40, do_sample=True, top_k=0, temperature=1.0,
                seed=3, eos_token_id=0,
                response_format={"type": "json_object"}),
                mod.GenerationConfig(max_length=30, do_sample=False,
                                     top_k=1, eos_token_id=-1)]
            with held_admission(eng, "json"):
                hs = [eng.start_request("json", p, g)
                      for p, g in zip(([5, 9, 3], [7, 1, 2, 8]), gens)]
            for _, h, _q in hs:
                eng.sync_request("json", h, timeout_s=600)
            out[mod] = [q.GetAllGeneratedTokens() for _, _, q in hs]
            if mod is tp:
                launches = dict(eng._models["json"].decode_launches)
        finally:
            eng.release_model("json")
    assert out[tp] == out[jp]
    ids = out[tp][0]
    text = "".join(strings[i] for i in ids if i != 0)
    st = tg.JsonState()
    assert tg.advance_str(st, text), f"not a JSON prefix: {text!r}"
    if tg.is_complete(st):
        json.loads(text)
    # every token of the guided request after its first came from a single
    # step (windows serve the plain request once the guided one is done)
    assert launches["single"] >= len(ids) - 1


def test_enforcer_advances_before_next_mask_with_async_prefill():
    """Every allowed_mask() after generation starts has seen advance() of
    every token emitted before it, the in-flight prefill's first token
    included (tests/test_guided.py's check, on the port's Engine with
    decode_steps_per_launch = 3)."""
    import dashinfer_tpu_torch as tp
    from tests.test_torch_transformer import port_config, tiny_qwen2
    cfg, params = tiny_qwen2()
    events = []

    class SpyEnforcer:
        complete = False

        def __init__(self, vocab):
            self.vocab = vocab
            self.n_advanced = 0

        def allowed_mask(self):
            events.append(("mask", self.n_advanced))
            return np.ones((self.vocab,), bool)

        def advance(self, tok):
            self.n_advanced += 1
            events.append(("advance", self.n_advanced))

    rt = (tp.RuntimeConfigBuilder("g").max_length(64).max_batch(2)
          .kv_cache_page_size(16).kv_cache_num_pages(24).dtype("float32")
          .update({"min_prefill_bucket": 16, "decode_steps_per_launch": 3})
          .build())
    eng = tp.Engine().install_model("g", rt, params=params,
                                    model_config=port_config(cfg),
                                    device="cpu")
    eng._models["g"]._make_enforcer = \
        lambda req: (SpyEnforcer(cfg.vocab_size)
                     if req.gen_cfg.response_format else None)
    eng.start_model("g")
    try:
        gen = tp.GenerationConfig(max_length=12, do_sample=False, top_k=1,
                                  eos_token_id=-1,
                                  response_format={"type": "json_object"})
        _, h, q = eng.start_request("g", [5, 9, 2], gen)
        eng.sync_request("g", h, timeout_s=300)
        assert len(q.GetAllGeneratedTokens()) == 12 - 3
    finally:
        eng.release_model("g")
    mask_counts = [n for kind, n in events if kind == "mask"]
    assert mask_counts == list(range(len(mask_counts))), events
    assert len(mask_counts) == 12 - 3
