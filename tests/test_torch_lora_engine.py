"""The port's Engine serving LoRA adapters on the CPU, against the JAX
Engine and a dense-merged golden: a mixed batch (one adapter, another, none)
on the per-op path, the decode megakernel's LoRA branch (its plain version)
with every flag at its default, a MoE model's LoRA batches per-op, slot
reuse, and the refusals (LoRA off, an unknown adapter, a mesh,
pack_only)."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_lora import ALPHA, RANK, adapter
from tests.test_torch_transformer import port_config, tiny_qwen2

PROMPT = [5, 9, 2, 41, 77, 3, 8, 1, 4]


def _greedy(mod, n_new=6, lora=None):
    return mod.GenerationConfig(max_length=len(PROMPT) + n_new,
                                do_sample=False, top_k=1, eos_token_id=-1,
                                lora_name=lora)


def _rt(mod, **update):
    b = (mod.RuntimeConfigBuilder("m").max_length(64).max_batch(3)
         .kv_cache_page_size(16).kv_cache_num_pages(24).dtype("float32")
         .lora(True, max_num=2, max_rank=8)
         .update({"min_prefill_bucket": 16, **update}))
    return b.build()


def _serve(eng, mod, gens, name="m", prompt=PROMPT):
    hs = [eng.start_request(name, prompt, g)[1:] for g in gens]
    for h, _ in hs:
        eng.sync_request(name, h, timeout_s=600)
    out = [q.GetAllGeneratedTokens() for _, q in hs]
    for h, _ in hs:
        eng.release_request(name, h)
    return out


def _merged(params, cfg, tensors, scale):
    """Dense-merged weights: w' = w + scale * A^T B^T on every target."""
    from dashinfer_tpu_torch.lora.manager import TARGETS
    p2 = dict(params)
    p2["layers"] = dict(params["layers"])
    for t in TARGETS:
        w = np.array(p2["layers"][t]["w"], np.float32)
        for l in range(cfg.num_layers):
            w[l] += scale * (tensors[(l, t, "A")].T @ tensors[(l, t, "B")].T)
        p2["layers"][t] = dict(p2["layers"][t], w=w)
    return p2


def test_mixed_batch_same_tokens_as_jax_and_merged_golden():
    """Three concurrent greedy requests on the tiny Qwen2 (f32, per-op):
    adapter a, adapter b, none. The tokens equal the JAX Engine's, the
    adapters' rows equal the dense-merged golden's (JAX
    tests/test_lora.py's), and each adapter moves the tokens."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from tests.test_model_parity import _run_prefill_decode
    cfg, params = tiny_qwen2()
    ad = {"a": adapter(cfg, 7), "b": adapter(cfg, 8)}
    got = {}
    for mod, kw in ((jp, {}), (tp, dict(device="cpu"))):
        model_cfg = cfg if mod is jp else port_config(cfg)
        eng = mod.Engine().install_model("m", _rt(mod), params=params,
                                         model_config=model_cfg, **kw)
        eng.load_lora("m", "a", ad["a"], alpha=ALPHA, rank=RANK)
        eng.start_model("m")
        try:
            eng.load_lora("m", "b", ad["b"], alpha=ALPHA, rank=RANK)
            got[mod] = _serve(eng, mod, [_greedy(mod, lora="a"),
                                         _greedy(mod, lora="b"),
                                         _greedy(mod)])
        finally:
            eng.release_model("m")
    assert got[tp] == got[jp]
    _, _, base = _run_prefill_decode(cfg, params, PROMPT, 6)
    assert got[tp][2] == base
    for i, k in enumerate("ab"):
        _, _, golden = _run_prefill_decode(
            cfg, _merged(params, cfg, ad[k], ALPHA / RANK), PROMPT, 6)
        assert golden != base
        assert got[tp][i] == golden


def test_slot_reuse_serves_the_new_adapter():
    """Unload an adapter from a started engine and load another into its
    slot: the next request on it follows the new adapter (the
    dense-merged golden), not the old."""
    import dashinfer_tpu_torch as tp
    from tests.test_model_parity import _run_prefill_decode
    cfg, params = tiny_qwen2()
    x, y = adapter(cfg, 11), adapter(cfg, 12)
    eng = tp.Engine().install_model("m", _rt(tp), params=params,
                                    model_config=port_config(cfg),
                                    device="cpu").start_model("m")
    try:
        eng.load_lora("m", "x", x, alpha=ALPHA, rank=RANK)
        run = eng._models["m"]
        before = _serve(eng, tp, [_greedy(tp, lora="x")])[0]
        eng.unload_lora("m", "x")
        with pytest.raises(KeyError):
            eng.start_request("m", PROMPT, _greedy(tp, lora="x"))
        eng.load_lora("m", "y", y, alpha=ALPHA, rank=RANK)
        assert run.lora_manager.index_of("y") == 0
        after = _serve(eng, tp, [_greedy(tp, lora="y")])[0]
    finally:
        eng.release_model("m")
    for toks, t in ((before, x), (after, y)):
        _, _, golden = _run_prefill_decode(
            cfg, _merged(params, cfg, t, ALPHA / RANK), PROMPT, 6)
        assert toks == golden
    assert before != after


def test_megakernel_lora_branch_same_tokens_as_jax():
    """tests/test_megakernel.py's tiny a16w4 model (head_dim 128, INT8 KV)
    with every flag at its default: the port decodes a batch that carries
    an adapter through the decode megakernel's LoRA branch (its plain
    version on the CPU) and a batch without one through the dense step;
    the JAX Engine runs its interpret-mode megakernel with the LoRA
    epilogue. The kernels round at the TPU kernel's points and sum in
    another order: the first 10 of 14 tokens must agree (the bound of
    tests/test_torch_engine.py's dense case); the adapter's tokens differ
    from the plain request's."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from dashinfer_tpu.engine.model_runtime import ModelRuntime as JRuntime
    from tests.test_torch_engine import PROMPT as MK_PROMPT
    from tests.test_torch_engine import (_megakernel_fixture,
                                         _port_megakernel_engine)
    cfg, rt, params, np_params = _megakernel_fixture()
    rt = dataclasses.replace(rt, enable_lora=True, lora_max_num=2,
                             lora_max_rank=8)
    ad = adapter(cfg, 5, std=0.08)
    gens = lambda mod: [mod.GenerationConfig(
        max_length=20, do_sample=False, top_k=1, eos_token_id=-1,
        lora_name=lora) for lora in ("a", None)]
    jrt = JRuntime("mk", cfg, params, rt, use_kernel=True)
    assert jrt._mega_lora_ok
    jeng = jp.Engine()
    jeng._models["mk"] = jrt
    jeng.load_lora("mk", "a", ad, alpha=16.0, rank=RANK)
    jeng.start_model("mk")
    try:
        want = _serve(jeng, jp, gens(jp), "mk", MK_PROMPT)
    finally:
        jeng.release_model("mk")
    teng, trun = _port_megakernel_engine(
        cfg, rt, np_params, enable_lora=True, lora_max_num=2,
        lora_max_rank=8)
    assert trun.mega_plan is not None and trun._mega_lora_ok
    assert trun._lora_decode_step.forward.plan is trun.mega_plan
    teng.load_lora("mk", "a", ad, alpha=16.0, rank=RANK)
    teng.start_model("mk")
    try:
        got = _serve(teng, tp, gens(tp), "mk", MK_PROMPT)
    finally:
        teng.release_model("mk")
    assert [len(t) for t in got] == [len(t) for t in want] == [14, 14]
    for g, w in zip(got, want):
        assert g[:10] == w[:10], (got, want)
    assert got[0] != got[1]


def test_moe_lora_batches_decode_per_op():
    """A MoE model with `enable_lora`: the runtime keeps the decode
    megakernel for batches without adapters, and a batch that carries one
    decodes per-op (no LoRA branch for a MoE plan, as in the JAX package),
    where the adapter's q|k|v and o deltas apply and the MoE block takes
    none. Greedy tokens equal the JAX Engine's (its XLA path)."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from tests.test_torch_engine import _moe_fixture, _port_megakernel_engine
    cfg, rt, np_params = _moe_fixture()
    rt = dataclasses.replace(rt, enable_lora=True, lora_max_num=2,
                             lora_max_rank=8)
    ad = adapter(cfg, 6, std=0.1)
    gen = lambda mod: [mod.GenerationConfig(
        max_length=len(PROMPT) + 6, do_sample=False, top_k=1,
        eos_token_id=-1, lora_name="a")]
    name = rt.model_name
    jeng = jp.Engine().install_model(name, rt, params=np_params,
                                     model_config=cfg)
    jeng.load_lora(name, "a", ad, alpha=16.0, rank=RANK)
    jeng.start_model(name)
    try:
        want = _serve(jeng, jp, gen(jp), name)
    finally:
        jeng.release_model(name)
    teng, trun = _port_megakernel_engine(
        cfg, rt, np_params, enable_lora=True, lora_max_num=2,
        lora_max_rank=8)
    assert trun.mega_plan is not None and trun.mega_plan.E == 4
    assert not trun._mega_lora_ok
    assert trun._lora_decode_step.forward.plan is None
    teng.load_lora("mk", "a", ad, alpha=16.0, rank=RANK)
    teng.start_model("mk")
    try:
        got = _serve(teng, tp, gen(tp), "mk")
    finally:
        teng.release_model("mk")
    assert got == want


def test_lora_refusals():
    """lora_name with LoRA off (ValueError) or not loaded (KeyError);
    load_lora with LoRA off (RuntimeError); LoRA on a mesh
    (NotImplementedError, named); pack_only with LoRA (ValueError)."""
    import dashinfer_tpu_torch as tp
    cfg, params = tiny_qwen2()
    eng = tp.Engine().install_model("m", _rt(tp, enable_lora=False),
                                    params=params,
                                    model_config=port_config(cfg),
                                    device="cpu").start_model("m")
    try:
        with pytest.raises(ValueError):
            eng.start_request("m", PROMPT, _greedy(tp, lora="a"))
        with pytest.raises(RuntimeError):
            eng.load_lora("m", "a", adapter(cfg, 1), alpha=ALPHA, rank=RANK)
    finally:
        eng.release_model("m")
    eng = tp.Engine().install_model("m", _rt(tp), params=params,
                                    model_config=port_config(cfg),
                                    device="cpu").start_model("m")
    try:
        with pytest.raises(KeyError):
            eng.start_request("m", PROMPT, _greedy(tp, lora="a"))
        eng.load_lora("m", "a", adapter(cfg, 1), alpha=ALPHA, rank=RANK)
        with pytest.raises(ValueError):         # already loaded
            eng.load_lora("m", "a", adapter(cfg, 1), alpha=ALPHA, rank=RANK)
    finally:
        eng.release_model("m")
    mesh_rt = dataclasses.replace(_rt(tp), mesh_shape=(1, 2))
    with pytest.raises(NotImplementedError, match="LoRA on a mesh"):
        tp.Engine().install_model("m", mesh_rt, params=params,
                                  model_config=port_config(cfg),
                                  device=["cpu", "cpu"])
    from tests.test_torch_engine import _megakernel_fixture
    mcfg, mrt, _, mparams = _megakernel_fixture(max_length=256)
    with pytest.raises(ValueError, match="pack_only"):
        tp.Engine().install_model(
            "p", _rt(tp, weight_residency="pack_only", max_length=256),
            params=mparams, model_config=port_config(mcfg), device="cpu")
