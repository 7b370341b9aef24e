"""Multi-step decode (decode_steps_per_launch N > 1) on the CPU.

Steps level: the port's window `build_multi_decode_step(N = 3)` equals
three of the runtime's single decode steps, bit for bit (tokens, every
state tensor, the pool), with a page crossing inside the window, on the
per-op path and on a megakernel plan's plain version, without and with the
on-device bans; and it equals the JAX window on the per-op path (tokens
and state equal, the pool within the per-op tolerance of
tests/test_torch_transformer.py, 1e-4 of its largest value).

Engine level, N = 3 against the JAX Engine with N = 3: greedy tokens (two
windows, then single steps near the length limit), a batch of greedy and
seeded requests, a stop word inside a window, a pool too small for a
window's pages (the single step's eviction), logprobs within 1e-5, and a
LoRA batch, which takes single steps, as in the JAX package."""

import contextlib
import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

import tests.hf_util as hf_util
from tests.test_torch_transformer import (_assert_pools_close, port_config,
                                          tiny_qwen2)

PS = 16
N = 3
LOGPROB_ATOL = 1e-5
# slot 0: 14 cached tokens (its window writes 14, 15, 16: a new page at
# step 2); slot 1: 5
PROMPTS = ([4, 9, 2, 7, 5, 1, 8, 3, 6, 2, 9, 4, 7, 5], [11, 3, 5, 8, 2])


def _runtime(path):
    """A port runtime (not started) of the tiny Qwen2 (per-op) or of
    tests/test_megakernel.py's tiny a16w4 model (the decode megakernel's
    plain version), with decode_steps_per_launch = 3."""
    import dashinfer_tpu_torch as tp
    if path == "per-op":
        cfg, params = tiny_qwen2()
        rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(2)
              .kv_cache_page_size(PS).kv_cache_num_pages(24)
              .dtype("float32").update({"min_prefill_bucket": 16,
                                        "decode_steps_per_launch": N})
              .build())
        eng = tp.Engine().install_model("m", rt, params=params,
                                        model_config=port_config(cfg),
                                        device="cpu")
        run = eng._models["m"]
        assert run.mega_plan is None
        return run
    from tests.test_torch_engine import (_megakernel_fixture,
                                         _port_megakernel_engine)
    cfg, rt, _, np_params = _megakernel_fixture()
    _, run = _port_megakernel_engine(cfg, rt, np_params,
                                     decode_steps_per_launch=N)
    assert run.mega_plan is not None
    return run


def _prefill(run, bans):
    """Admit PROMPTS through the runtime's prefill (first tokens drained);
    returns the window's page installs [N, B]."""
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu_torch.runtime.request import Request
    from dashinfer_tpu_torch.runtime.result_queue import ResultQueue
    reqs = []
    for i, p in enumerate(PROMPTS):
        g = tp.GenerationConfig(max_length=run.rt.max_length,
                                do_sample=False, top_k=1, eos_token_id=-1,
                                **bans[i])
        req = Request(uuid=f"r{i}", input_ids=list(p), gen_cfg=g)
        run.register(req, ResultQueue(req.uuid))
        run.enqueue(req)
        assert run.try_prefill_one()
        reqs.append(req)
    run._drain_prefill_tokens()
    npi = np.full((N, run.rt.max_batch), -1, np.int32)
    npi[2, reqs[0].slot] = run.allocator.alloc(1)[0]
    return npi


def _steps_run(path, bans, with_banned):
    """(single-step tokens [N, B], state, cache) and the window's, from the
    same prefilled state."""
    run = _runtime(path)
    npi = _prefill(run, bans)
    params = run.mega_params if run.mega_plan is not None else run.params
    start = copy.deepcopy((run.state, run.cache))
    single = run._decode_fn(False, False, False, with_banned)
    rows = [None] * run.rt.max_batch
    toks = []
    for i in range(N):
        t, lp, run.cache, run.state = single(
            params, run.cache, run.state, torch.from_numpy(npi[i]), rows)
        assert lp is None
        toks.append(t.clone())
    got_single = (torch.stack(toks), run.state, run.cache)
    run.state, run.cache = start
    window = run._multi_decode_fn(with_banned)
    wt, run.cache, run.state = window(params, run.cache, run.state, npi,
                                      [rows] * N)
    assert window.window.captures == 0          # the CPU runs it eagerly
    return got_single, (wt, run.state, run.cache)


def _tensors(tree):
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


@pytest.mark.parametrize("with_banned", [False, True])
@pytest.mark.parametrize("path", ["per-op", "megakernel"])
def test_window_equals_single_steps(path, with_banned):
    """Bit-equal tokens, state and pool. With bans, slot 0 bans the token
    its unbanned first step chose and repeated 2-grams, slot 1 the 2-token
    word of its unbanned first two steps: the bans move the tokens."""
    nobans = ({}, {})
    (plain, _, _), _ = _steps_run(path, nobans, False)
    bans = nobans
    if with_banned:
        bans = ({"bad_words_ids": [[int(plain[0, 0])]],
                 "no_repeat_ngram_size": 2},
                {"bad_words_ids": [[int(plain[0, 1]), int(plain[1, 1])]]})
    (st, s_state, s_cache), (wt, w_state, w_cache) = _steps_run(
        path, bans, with_banned)
    assert wt.shape == (N, 2) and torch.equal(wt, st)
    if with_banned:
        assert not torch.equal(wt, plain)
        assert int(wt[0, 0]) != int(plain[0, 0])
    for name, t in _tensors(s_state).items():
        if name == "sampling":
            continue
        assert torch.equal(t, getattr(w_state, name)), name
    for name, t in _tensors(s_cache).items():
        if t is not None:
            assert torch.equal(t, getattr(w_cache, name)), name
    # the window wrote its tokens into the history after the prompt and
    # the prefill's token
    for b, p in enumerate(PROMPTS):
        assert w_state.history[b, len(p) + 1:len(p) + 1 + N].tolist() == \
            wt[:, b].tolist()
    assert w_state.context_lens.tolist() == [len(p) + N for p in PROMPTS]


@pytest.mark.parametrize("with_banned", [False, True])
def test_window_matches_jax_window(with_banned):
    """The per-op window against the JAX `build_multi_decode_step` on the
    same prefilled pool and state (tests/test_multistep_decode.py's setup,
    the slots' history holding their prompts): tokens, lengths, history,
    counts and page tables equal; the pool within 1e-4 of its largest
    value."""
    import jax
    import jax.numpy as jnp
    from dashinfer_tpu.config import CacheConfig as JCC
    from dashinfer_tpu.config import RuntimeConfig as JRC
    from dashinfer_tpu.engine import steps as jsteps
    from dashinfer_tpu.models import transformer as jtr
    from dashinfer_tpu.runtime.batch_state import make_decode_state as jmds
    from dashinfer_tpu.runtime.kv_cache import create_kv_cache as jkv
    from dashinfer_tpu_torch.config import CacheConfig as TCC
    from dashinfer_tpu_torch.config import RuntimeConfig as TRC
    from dashinfer_tpu_torch.engine import steps as tsteps
    from dashinfer_tpu_torch.loader.convert import params_from_numpy
    from dashinfer_tpu_torch.models import transformer as ttr
    from dashinfer_tpu_torch.runtime.batch_state import \
        make_decode_state as tmds
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache as tkv

    cfg, params = tiny_qwen2()
    tcfg = port_config(cfg)
    kw = dict(model_name="ms", max_length=64, max_batch=2,
              dtype="float32", min_prefill_bucket=16)
    jrt = JRC(cache=JCC(page_size=PS, num_pages=16), **kw)
    trt = TRC(cache=TCC(page_size=PS, num_pages=16), **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    pages = 16 * cfg.num_layers + 1
    jc = jkv(cfg, jrt.cache, pages, model_dtype=jnp.float32)
    tc = tkv(tcfg, trt.cache, pages, torch.float32, "cpu")
    toks = np.zeros((2, 16), np.int32)
    lens = [len(p) for p in PROMPTS]
    for b, p in enumerate(PROMPTS):
        toks[b, :len(p)] = p
    pt = np.array([[1, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    for b in range(2):
        _, jc = jtr.prefill_forward(
            cfg, jparams, jnp.asarray(toks[b]), jc, jnp.asarray(pt[b, :2]),
            jnp.int32(0), jnp.int32(lens[b]), mode=jrt.cache.mode,
            use_kernel=False)
        _, tc = ttr.prefill_forward(
            tcfg, tparams, torch.from_numpy(toks[b]), tc,
            torch.from_numpy(pt[b, :2]), 0, lens[b], mode=trt.cache.mode)
    hist = np.full((2, 64), -1, np.int32)
    first = [toks[0][13], toks[1][4]]      # the "first token": the last id
    for b, p in enumerate(PROMPTS):
        hist[b, :len(p)] = p
        hist[b, len(p)] = first[b]
    bw = np.full((2, jrt.max_bad_words, jrt.max_bad_word_len), -1, np.int32)
    ng = np.zeros((2,), np.int32)
    if with_banned:
        bw[0, 0, -1] = 7
        bw[1, 0, -2:] = [2, 5]
        ng[:] = [2, 3]
    fields = dict(token_ids=np.asarray(first, np.int32),
                  context_lens=np.asarray(lens, np.int32),
                  prompt_lens=np.asarray(lens, np.int32),
                  gen_lens=np.ones((2,), np.int32), page_tables=pt,
                  active=np.ones((2,), bool), history=hist, bad_words=bw,
                  ngram_n=ng)
    jstate = dataclasses.replace(jmds(cfg, jrt), **{
        k: jnp.asarray(v) for k, v in fields.items()})
    tstate = tmds(tcfg, trt, "cpu")
    for k, v in fields.items():
        getattr(tstate, k).copy_(torch.from_numpy(v))
    npi = np.full((N, 2), -1, np.int32)
    npi[2, 0] = 2

    jfn = jsteps.build_multi_decode_step(cfg, jrt, N, use_kernel=False,
                                         with_banned=with_banned)
    jt, jc, jstate = jfn(jparams, jc, jstate, jnp.asarray(npi))
    tfn = tsteps.build_multi_decode_step(tcfg, trt, N,
                                         with_banned=with_banned)
    tt, tc, tstate = tfn(tparams, tc, tstate, npi, [[None, None]] * N)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for k in ("token_ids", "context_lens", "gen_lens", "page_tables",
              "history", "token_counts"):
        assert np.array_equal(getattr(tstate, k).numpy(),
                              np.asarray(getattr(jstate, k))), k
    _assert_pools_close(jc, tc, "default", 1e-4)


# -- the Engine against the JAX Engine ---------------------------------------

def _rt(mod, num_pages=24, **update):
    return (mod.RuntimeConfigBuilder("ms").max_length(64).max_batch(3)
            .kv_cache_page_size(PS).kv_cache_num_pages(num_pages)
            .dtype("float32")
            .update({"min_prefill_bucket": 16, "decode_steps_per_launch": N,
                     **update}).build())


def _engine(mod, **rt_kw):
    cfg, params = tiny_qwen2()
    kw = dict(device="cpu") if mod.__name__ == "dashinfer_tpu_torch" else {}
    return mod.Engine().install_model(
        "ms", _rt(mod, **rt_kw), params=params,
        model_config=port_config(cfg) if kw else cfg, **kw).start_model("ms")


@pytest.fixture(scope="module")
def engines():
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    jeng, teng = _engine(jp), _engine(tp)
    yield jeng, teng
    jeng.release_model("ms")
    teng.release_model("ms")


@contextlib.contextmanager
def held_admission(eng, name):
    """The engine's scheduler loop (JAX or port) waits on a control message
    while the block starts requests, so that its next tick admits them all
    together: every decode step then sees the same batch on both Engines,
    whatever the threads' timing."""
    go, waiting = threading.Event(), threading.Event()

    def wait():
        waiting.set()
        go.wait(60)
    eng._loops[name].submit(wait)
    assert waiting.wait(60)
    try:
        yield
    finally:
        go.set()


def _serve(eng, prompts, gens):
    with held_admission(eng, "ms"):
        hs = [eng.start_request("ms", p, g) for p, g in zip(prompts, gens)]
    for _, h, _q in hs:
        eng.sync_request("ms", h, timeout_s=600)
    out = [(q.GetAllGeneratedTokens(), q.GenerateStatus().value, q)
           for _, _, q in hs]
    for _, h, _q in hs:
        eng.release_request("ms", h)
    return out


def _both(engines, prompts, make):
    """The requests `make(mod)` through both Engines; returns (port, JAX)
    results and the port runtime's window / single-step launch counts of
    the run."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    jeng, teng = engines
    run = teng._models["ms"]
    before = dict(run.decode_launches)
    got = _serve(teng, prompts, make(tp))
    launches = {k: v - before[k] for k, v in run.decode_launches.items()}
    return got, _serve(jeng, prompts, make(jp)), launches


def _greedy(mod, n, **kw):
    return mod.GenerationConfig(max_length=n, do_sample=False, top_k=1,
                                eos_token_id=-1, **kw)


def test_greedy_windows_then_single_steps_near_the_limit(engines):
    """7 new tokens: the prefill's, two windows of 3, then one single step
    (a window needs 3 tokens of budget; its last row is dropped): the HF
    model's greedy tokens, equal to the JAX Engine's."""
    prompt = [3, 14, 15, 9, 2, 6]
    got, want, launches = _both(
        engines, [prompt], lambda m: [_greedy(m, len(prompt) + 7)])
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    assert got[0][0] == want[0][0] == hf_util.hf_greedy_tokens(hf, prompt, 7)
    assert got[0][1] == "GenerateFinished"
    assert launches == {"multi": 2, "single": 1}


def test_batched_greedy_and_seeded_same_tokens_as_jax(engines):
    """Three concurrent requests of other lengths, one seeded top-k and one
    seeded top-p: windows draw each row's noise at (seed, position), so the
    tokens equal the JAX Engine's."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (6, 11, 4)]

    def gens(m):
        return [_greedy(m, len(prompts[0]) + 9),
                m.GenerationConfig(max_length=len(prompts[1]) + 5,
                                   do_sample=True, top_k=20, temperature=1.3,
                                   seed=7, eos_token_id=-1),
                m.GenerationConfig(max_length=len(prompts[2]) + 12,
                                   do_sample=True, top_k=0, top_p=0.9,
                                   seed=2 ** 32 - 1, eos_token_id=-1)]
    got, want, launches = _both(engines, prompts, gens)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [len(g[0]) for g in got] == [9, 5, 12]
    assert launches["multi"] > 0
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    assert got[0][0] == hf_util.hf_greedy_tokens(hf, prompts[0], 9)


def test_stop_word_inside_a_window(engines):
    """A single-token stop word at the 5th token, inside the second window:
    generation ends there, the window's later rows are dropped, the slot
    and its pages are freed, and a request admitted next is served
    right."""
    prompt = [5, 9, 2, 41, 77, 3]
    hf = hf_util.make_torch_model(hf_util.tiny_qwen2_config())
    ref = hf_util.hf_greedy_tokens(hf, prompt, 8)
    stop = int(ref[4])
    assert stop not in ref[:4]
    got, want, launches = _both(
        engines, [prompt, [8, 1, 4]],
        lambda m: [_greedy(m, 64, stop_words_ids=[[stop]]),
                   _greedy(m, 14)])
    assert got[0][0] == want[0][0] == ref[:5]
    assert got[1][0] == want[1][0] == hf_util.hf_greedy_tokens(
        hf, [8, 1, 4], 11)
    assert launches["multi"] >= 2
    assert engines[1].get_engine_stat("ms")["used_span"] == 0


def test_logprobs_same_as_jax_and_single_steps(engines):
    """A logprobs request (top_logprobs 3) beside a greedy one: every token
    has its logprob and top pairs, within 1e-5 of the JAX Engine's, the
    token is its top-1 id; while it runs, no window is launched."""
    prompt = [5, 9, 2, 41, 77, 3]
    got, want, launches = _both(
        engines, [prompt], lambda m: [_greedy(m, 16, logprobs=True,
                                               top_logprobs=3)])
    (toks, _, q), (jtoks, _, jq) = got[0], want[0]
    assert toks == jtoks and len(toks) == 10
    # (the pipeline launches one step past the last token, as in the JAX
    # runtime: its row is dropped)
    assert launches == {"multi": 0, "single": 10}
    el, jel = q.GetNoWait(), jq.GetNoWait()
    assert len(el.token_logprobs_list) == len(el.log_probs_list) == 10
    np.testing.assert_allclose(el.token_logprobs_list,
                               jel.token_logprobs_list, rtol=0,
                               atol=LOGPROB_ATOL)
    for t, pairs, jpairs, lp in zip(toks, el.log_probs_list,
                                    jel.log_probs_list,
                                    el.token_logprobs_list):
        assert [i for i, _ in pairs] == [i for i, _ in jpairs]
        assert len(pairs) == 3 and pairs[0][0] == t
        np.testing.assert_allclose([v for _, v in pairs],
                                   [v for _, v in jpairs], rtol=0,
                                   atol=LOGPROB_ATOL)
        assert abs(pairs[0][1] - lp) <= LOGPROB_ATOL and lp <= 0


def test_no_free_pages_for_a_window_falls_through_to_the_single_step():
    """A pool of 3 pages, full after two prompts (30 and 15 tokens, admitted
    in one tick), each crossing into a new page inside its next window: the
    window cannot get its pages ahead (NoFreePages), so the tick is a single
    step, which evicts the longer request when the shorter one crosses; the
    outcomes equal the JAX Engine's."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (30, 15)]
    out = {}
    for mod in (jp, tp):
        eng = _engine(mod, num_pages=3)
        try:
            out[mod] = [(t, s) for t, s, _ in _serve(
                eng, prompts, [_greedy(mod, 40), _greedy(mod, 24)])]
            if mod is tp:
                launches = dict(eng._models["ms"].decode_launches)
        finally:
            eng.release_model("ms")
    assert out[tp] == out[jp]
    assert [s for _, s in out[tp]] == ["GenerateInterrupted",
                                       "GenerateFinished"]
    assert launches["single"] > 0 and launches["multi"] > 0


def test_lora_batch_takes_single_steps():
    """With decode_steps_per_launch = 3 a batch that carries an adapter
    decodes in single steps (the JAX package's window has no LoRA form),
    with the JAX Engine's tokens; a batch without one takes windows."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from tests.test_torch_lora import ALPHA, RANK, adapter
    from tests.test_torch_lora_engine import _greedy as lgreedy
    from tests.test_torch_lora_engine import _rt as lrt
    from tests.test_torch_lora_engine import _serve as lserve
    cfg, params = tiny_qwen2()
    ad = adapter(cfg, 7)
    got = {}
    for mod, kw in ((jp, {}), (tp, dict(device="cpu"))):
        eng = mod.Engine().install_model(
            "m", lrt(mod, decode_steps_per_launch=N), params=params,
            model_config=cfg if mod is jp else port_config(cfg), **kw)
        eng.load_lora("m", "a", ad, alpha=ALPHA, rank=RANK)
        eng.start_model("m")
        try:
            if mod is tp:
                run = eng._models["m"]
                first = lserve(eng, mod, [lgreedy(mod, 7, lora="a")])
                mid = dict(run.decode_launches)
                second = lserve(eng, mod, [lgreedy(mod, 7)])
                got[mod] = first + second
                end = dict(run.decode_launches)
            else:
                got[mod] = lserve(eng, mod, [lgreedy(mod, 7, lora="a")]) + \
                    lserve(eng, mod, [lgreedy(mod, 7)])
        finally:
            eng.release_model("m")
    assert got[tp] == got[jp] and got[tp][0] != got[tp][1]
    assert mid == {"multi": 0, "single": 7}
    assert end["multi"] - mid["multi"] == 2
