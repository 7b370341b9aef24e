"""Bad-words / n-gram bans and logprobs: the port against the JAX package on
the same numpy inputs (CPU).

`device_banned_mask` equal to the JAX one and to the host oracle
`_banned_ids` (exactly: a mask of integers); `process_logits` with the host
channel `banned` and the on-device `banned_mask` equal to the JAX one
(rtol 1e-6, as `tests/test_torch_sampling.py` holds it); `sample` with
`top_logprobs = 5`: tokens and top ids equal, logprobs within 1e-5. Then
the Engine: bans keep the multi-step window and give the host channel's
tokens (which take single steps), an oversized ban config goes through the
host channel, and the banned words and n-grams never appear, with the same
tokens as the JAX Engine's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.hf_util as hf_util
from dashinfer_tpu.ops import sampling as jsamp
from dashinfer_tpu.runtime.batch_state import SamplingParams as JSP
from dashinfer_tpu_torch.ops import sampling as tsamp
from dashinfer_tpu_torch.runtime.batch_state import SamplingParams as TSP
from tests.test_torch_transformer import port_config, tiny_qwen2

V, T, MW, WL, NG = 64, 48, 8, 4, 8
LOGPROB_ATOL = 1e-5


def _oracle(ctx, bad_words, n, cap=V):
    """The port's runtime oracle `_banned_ids` on a request with this
    context and config (a set; capped at the vocab, so not capped)."""
    from dashinfer_tpu_torch.engine.model_runtime import ModelRuntime

    class R:
        input_ids, generated_ids = list(ctx), []

        class gen_cfg:
            bad_words_ids = bad_words
            no_repeat_ngram_size = n

    class Self:
        class rt:
            max_banned_tokens = cap
    out = ModelRuntime._banned_ids(Self, R)
    return set() if out is None else {t for t in out if t >= 0}


def _ban_case(rng, B):
    hist = np.full((B, T), -1, np.int32)
    lens = rng.randint(0, T + 1, size=B).astype(np.int32)
    bw = np.full((B, MW, WL), -1, np.int32)
    ng = rng.choice([0, 1, 2, 3, 8], size=B).astype(np.int32)
    ctxs, words = [], []
    for b in range(B):
        # a small alphabet, so that n-grams repeat and words match
        ctx = rng.randint(0, 6, size=lens[b]).tolist()
        hist[b, :lens[b]] = ctx
        ctxs.append(ctx)
        ws = []
        for j in range(rng.randint(0, MW + 1)):
            # words as long as the array allows: longer than a short
            # history, and single-token ones
            w = rng.randint(0, 6, size=rng.randint(1, WL + 1)).tolist()
            ws.append(w)
            bw[b, j, WL - len(w):] = w
        words.append(ws)
    return hist, lens, bw, ng, ctxs, words


@pytest.mark.parametrize("seed", range(6))
def test_device_banned_mask_matches_jax_and_host_oracle(seed):
    """Random histories (-1 pads past lens, lens 0 .. T), words longer than
    the history, single-token words, ngram_n in {0, 1, 2, 3, 8}: the mask
    equals the JAX mask and the host oracle, row by row."""
    rng = np.random.RandomState(100 + seed)
    hist, lens, bw, ng, ctxs, words = _ban_case(rng, 5)
    want = np.asarray(jsamp.device_banned_mask(
        jnp.asarray(hist), jnp.asarray(lens), jnp.asarray(bw),
        jnp.asarray(ng), V, NG))
    got = tsamp.device_banned_mask(
        torch.from_numpy(hist), torch.from_numpy(lens), torch.from_numpy(bw),
        torch.from_numpy(ng), V, NG).numpy()
    assert got.dtype == bool and got.shape == (5, V)
    assert np.array_equal(got, want)
    for b in range(5):
        assert set(np.nonzero(got[b])[0].tolist()) == \
            _oracle(ctxs[b], words[b], int(ng[b])), (seed, b)


def _sampling(seed, B):
    rng = np.random.RandomState(seed)
    p = dict(
        temperature=rng.uniform(0.5, 1.5, B).astype(np.float32),
        top_k=rng.choice([0, 1, 5, 20], size=B).astype(np.int32),
        top_p=rng.choice([1.0, 0.9, 0.6], size=B).astype(np.float32),
        repetition_penalty=rng.uniform(1.0, 1.3, B).astype(np.float32),
        presence_penalty=rng.uniform(0.0, 0.5, B).astype(np.float32),
        frequency_penalty=rng.uniform(0.0, 0.2, B).astype(np.float32),
        seed=np.arange(B).astype(np.uint32),
        min_gen_len=rng.randint(0, 4, B).astype(np.int32),
        stop_token_ids=rng.randint(-1, V, (B, 4)).astype(np.int32),
    )
    jsp = JSP(**{k: jnp.asarray(v) for k, v in p.items()})
    tsp = TSP(**{k: torch.from_numpy(v) for k, v in p.items()
                 if k != "seed"})
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    counts = (rng.randint(0, 3, (B, V)) * (rng.rand(B, V) < 0.2)).astype(
        np.int32)
    gen_lens = rng.randint(0, 6, B).astype(np.int32)
    banned = rng.randint(-1, V, (B, 7)).astype(np.int32)
    mask = rng.rand(B, V) < 0.1
    return p, jsp, tsp, logits, counts, gen_lens, banned, mask


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("channel", ["banned", "banned_mask", "both"])
def test_process_logits_bans_match_jax(seed, channel):
    _, jsp, tsp, logits, counts, gen_lens, banned, mask = _sampling(seed, 6)
    kw = {}
    if channel in ("banned", "both"):
        kw["banned"] = banned
    if channel in ("banned_mask", "both"):
        kw["banned_mask"] = mask
    want = np.asarray(jsamp.process_logits(
        jnp.asarray(logits), jsp, jnp.asarray(counts), jnp.asarray(gen_lens),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tsamp.process_logits(
        torch.from_numpy(logits), tsp, torch.from_numpy(counts),
        torch.from_numpy(gen_lens),
        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if "banned" in kw:
        rows, cols = np.nonzero(banned >= 0)
        assert (got[rows, banned[rows, cols]] == tsamp._NEG).all()
    if "banned_mask" in kw:
        assert (got[mask] == tsamp._NEG).all()


@pytest.mark.parametrize("seed", range(3))
def test_sample_logprobs_match_jax(seed):
    """`top_logprobs = 5` with bans and seeded rows: tokens and top ids
    equal, the token and top logprobs within 1e-5 (log_softmax of the
    scaled logits over the whole vocab)."""
    B = 8
    p, jsp, tsp, logits, counts, gen_lens, banned, mask = _sampling(
        20 + seed, B)
    steps = np.random.RandomState(seed).randint(0, 999, B).astype(np.int32)
    want = jsamp.sample(
        jnp.asarray(logits), jsp, jnp.asarray(counts), jnp.asarray(gen_lens),
        jnp.asarray(steps), max_top_k=16, top_logprobs=5,
        banned=jnp.asarray(banned), banned_mask=jnp.asarray(mask),
        exact_topk=True)
    rows = [None if p["top_k"][b] == 1 else (int(p["seed"][b]),
                                             int(steps[b]))
            for b in range(B)]
    got = tsamp.sample(
        torch.from_numpy(logits), tsp, torch.from_numpy(counts),
        torch.from_numpy(gen_lens), tsamp.gumbel_noise(rows, 16, "cpu"),
        max_top_k=16, top_logprobs=5, banned=torch.from_numpy(banned),
        banned_mask=torch.from_numpy(mask))
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert np.array_equal(got.top_ids.numpy(), np.asarray(want.top_ids))
    np.testing.assert_allclose(got.token_logprobs.numpy(),
                               np.asarray(want.token_logprobs), rtol=0,
                               atol=LOGPROB_ATOL)
    np.testing.assert_allclose(got.top_logprobs.numpy(),
                               np.asarray(want.top_logprobs), rtol=0,
                               atol=LOGPROB_ATOL)
    plain = tsamp.sample(
        torch.from_numpy(logits), tsp, torch.from_numpy(counts),
        torch.from_numpy(gen_lens), tsamp.gumbel_noise(rows, 16, "cpu"),
        max_top_k=16)
    assert plain.token_logprobs is None and plain.top_ids is None


# -- the Engine ------------------------------------------------------------

def _engines():
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    cfg, params = tiny_qwen2()
    out = []
    for mod, kw in ((jp, {}), (tp, dict(device="cpu"))):
        rt = (mod.RuntimeConfigBuilder("bp").max_length(96).max_batch(2)
              .kv_cache_page_size(16).kv_cache_num_pages(32)
              .dtype("float32").update({"min_prefill_bucket": 16,
                                        "decode_steps_per_launch": 4})
              .build())
        out.append(mod.Engine().install_model(
            "bp", rt, params=params,
            model_config=cfg if mod is jp else port_config(cfg), **kw)
            .start_model("bp"))
    return out


@pytest.fixture(scope="module")
def ban_engines():
    jeng, teng = _engines()
    yield jeng, teng
    jeng.release_model("bp")
    teng.release_model("bp")


PROMPT = np.random.RandomState(5).randint(1, 500, size=9).tolist()


def _ban_gen(mod, base, **over):
    kw = dict(max_length=len(PROMPT) + 16, do_sample=False, top_k=1,
              eos_token_id=-1, no_repeat_ngram_size=2,
              bad_words_ids=[[base[0]], [base[1], base[2]]])
    kw.update(over)
    return mod.GenerationConfig(**kw)


def _serve(eng, gen, prompt=PROMPT):
    _, h, q = eng.start_request("bp", prompt, gen)
    eng.sync_request("bp", h, timeout_s=600)
    toks = q.GetAllGeneratedTokens()
    eng.release_request("bp", h)
    return toks


def _assert_bans_held(toks, gen):
    seq = PROMPT + toks
    n = gen.no_repeat_ngram_size
    grams = [tuple(seq[i:i + n]) for i in range(len(seq) - n + 1)]
    assert len(grams) == len(set(grams)), seq
    for w in gen.bad_words_ids:
        for i in range(len(PROMPT), len(seq) - len(w) + 1):
            assert seq[i:i + len(w)] != list(w), (w, seq)


def test_bans_keep_the_window_and_equal_the_host_channel(ban_engines):
    """The on-device bans keep the 4-step window (windows launched) and
    give the tokens of the host channel (`_device_ban_fits` forced false:
    single steps only) and of the JAX Engine; no banned word or repeated
    2-gram appears."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    jeng, teng = ban_engines
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    base = hf_util.hf_greedy_tokens(hf, PROMPT, 4)
    want = _serve(jeng, _ban_gen(jp, base))
    run = teng._models["bp"]
    before = dict(run.decode_launches)
    dev = _serve(teng, _ban_gen(tp, base))
    mid = dict(run.decode_launches)
    run._device_ban_fits = lambda g: False
    try:
        host = _serve(teng, _ban_gen(tp, base))
    finally:
        del run._device_ban_fits
    after = dict(run.decode_launches)
    assert dev == host == want and len(dev) == 16
    assert dev != hf_util.hf_greedy_tokens(hf, PROMPT, 16)
    _assert_bans_held(dev, _ban_gen(tp, base))
    assert mid["multi"] - before["multi"] == 4           # 16 tokens
    assert after["multi"] == mid["multi"]
    assert after["single"] - mid["single"] == 15


def test_oversized_ban_config_takes_the_host_channel(ban_engines):
    """A word longer than max_bad_word_len (4) and more words than the
    state holds go through the host channel (single synchronous steps),
    with the JAX Engine's tokens; the bans hold."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    jeng, teng = ban_engines
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    base = hf_util.hf_greedy_tokens(hf, PROMPT, 6)
    words = [[base[0]], base[1:6], [3], [4]]

    def gen(mod):
        return _ban_gen(mod, base, bad_words_ids=words,
                        no_repeat_ngram_size=3, max_length=len(PROMPT) + 12)
    run = teng._models["bp"]
    assert not run._device_ban_fits(gen(tp))
    before = dict(run.decode_launches)
    got = _serve(teng, gen(tp))
    after = dict(run.decode_launches)
    assert got == _serve(jeng, gen(jp)) and len(got) == 12
    _assert_bans_held(got, gen(tp))
    assert after["multi"] == before["multi"]
    assert after["single"] - before["single"] == 11
