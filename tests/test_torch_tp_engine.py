"""The port's Engine on a (1, 2) mesh on the CPU (ranks ["cpu", "cpu"]):
with the default flags (decode through the TP segments' plain versions,
prefill per-op TP) and with DI_MEGAKERNEL=0 (per-op TP throughout), the
greedy tokens of the JAX Engine on a (1, 2) mesh on the same path (as
tests/test_tp_megakernel.py holds its TP megakernel: the first 10 of 14
equal) and of the port's single-device serving; a MoE model on the mesh
(its experts split over the ranks, decode through the attn and moe
segments or per-op TP, every prefill per-op TP) against the port's and
the JAX package's single-device engines; and the mesh install's
refusals."""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

PROMPT = [5, 9, 2, 41, 77, 3]


def _jax_tokens(mesh_shape, use_kernel):
    """The JAX runtime of tests/test_tp_megakernel.py's engine test, on
    `mesh_shape`, with its prefill per-op (DI_PREFILL_MEGAKERNEL=0, set by
    the caller), as the port's on a mesh."""
    from dashinfer_tpu import Engine, GenerationConfig
    from dashinfer_tpu.config import CacheMode
    from dashinfer_tpu.engine.model_runtime import ModelRuntime
    cfg, rt, params = tp_fixture("a16w8")
    rt = dataclasses.replace(
        rt, max_length=160, max_batch=2, min_prefill_bucket=128,
        mesh_shape=mesh_shape,
        cache=dataclasses.replace(rt.cache, mode=CacheMode.INT8,
                                  num_pages=48))
    runtime = ModelRuntime("tpk", cfg, params, rt, use_kernel=use_kernel)
    tp = mesh_shape[1] > 1
    assert (runtime.tp_mega_plan is not None) == (use_kernel and tp)
    assert (runtime.mega_plan is not None) == (use_kernel and not tp)
    assert not runtime._tp_pmk_plans and not runtime._pmk_plans
    eng = Engine()
    eng._models["tpk"] = runtime
    eng.start_model("tpk")
    try:
        _, h, q = eng.start_request("tpk", PROMPT, GenerationConfig(
            max_length=20, do_sample=False, top_k=1, eos_token_id=-1))
        eng.sync_request("tpk", h, timeout_s=900)
        return q.GetAllGeneratedTokens()
    finally:
        eng.release_model("tpk")


def _port(devices, mesh=2, **update):
    """(runtime, 14 greedy tokens) of the port's Engine on the same
    model."""
    import dashinfer_tpu_torch as tp
    cfg, _, params = tp_fixture("a16w8")
    b = (tp.RuntimeConfigBuilder("tpk").max_length(160).max_batch(2)
         .kv_cache_page_size(16).kv_cache_num_pages(48)
         .kv_cache_mode(tp.CacheMode.INT8).dtype("float32")
         .update({"min_prefill_bucket": 128, **update}))
    if mesh > 1:
        b = b.mesh(1, mesh)
    eng = tp.Engine().install_model("tpk", b.build(), params=params,
                                    model_config=port_config(cfg),
                                    device=devices)
    run = eng._models["tpk"]
    eng.start_model("tpk")
    try:
        _, h, q = eng.start_request("tpk", PROMPT, tp.GenerationConfig(
            max_length=20, do_sample=False, top_k=1, eos_token_id=-1))
        eng.sync_request("tpk", h, timeout_s=300)
        assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
        return run, q.GetAllGeneratedTokens()
    finally:
        eng.release_model("tpk")


CPU2 = ["cpu", "cpu"]


@pytest.mark.parametrize("per_op", [False, True])
def test_engine_on_a_mesh_same_tokens_as_jax(per_op, monkeypatch):
    """DI_MEGAKERNEL=0: per-op TP, the JAX engine's XLA-SPMD tokens on a
    (1, 2) mesh. Default flags: the TP segments decode (the runtime holds a
    TP plan and no megakernel or prefill plan), the tokens of the JAX
    decode megakernel on the same per-op prefill; against the JAX TP
    megakernel on its (1, 2) mesh the first 5: at the 6th step this
    model's two best logits lie 0.0064 apart (of a largest of 2.75, 0.2%,
    inside the 1e-2 the kernels are held to), and there the JAX TP
    megakernel itself parts from the JAX decode megakernel. Both paths
    also give the port's single-device tokens."""
    monkeypatch.setenv("DI_PREFILL_MEGAKERNEL", "0")
    if per_op:
        monkeypatch.setenv("DI_MEGAKERNEL", "0")
    run, tp_toks = _port(CPU2)
    assert (run.tp_mega_plan is not None) != per_op
    assert run.mega_plan is None and not run._pmk_plans
    assert run.residency == "both" and len(run.cache) == 2
    assert run.cache[0].k.shape[-1] == 128          # one KV head a rank
    _, single = _port("cpu", mesh=1)
    jax_mesh = _jax_tokens((1, 2), use_kernel=not per_op)
    assert len(tp_toks) == len(single) == len(jax_mesh) == 14
    assert tp_toks[:10] == single[:10], (tp_toks, single)
    if per_op:
        assert tp_toks[:10] == jax_mesh[:10], (tp_toks, jax_mesh)
        return
    assert tp_toks[:5] == jax_mesh[:5], (tp_toks, jax_mesh)
    jax_single = _jax_tokens((1, 1), use_kernel=True)
    assert tp_toks[:10] == jax_single[:10], (tp_toks, jax_single)


def test_mesh_install_refusals():
    import dashinfer_tpu_torch as tp
    from tests.test_megakernel import _tiny_moe
    # an explicit pack_only needs a single-chip mesh (the reference's error)
    with pytest.raises(ValueError, match="mesh=True"):
        _port(CPU2, weight_residency="pack_only")
    # too few devices, unless the list repeats one explicitly
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _port("cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        _port("cuda")
    # a data axis
    cfg, _, params = tp_fixture("none")
    rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(2)
          .kv_cache_page_size(16).kv_cache_num_pages(24).dtype("float32")
          .mesh(2, 1).build())
    with pytest.raises(NotImplementedError, match="data"):
        tp.Engine().install_model("m", rt, params=params,
                                  model_config=port_config(cfg),
                                  device=CPU2)
    # a MoE model whose experts do not divide among the ranks (the port
    # splits the experts over them)
    mcfg, _, mparams = _tiny_moe(KH=2, H=2, E=3)
    import jax
    rt = dataclasses.replace(rt, mesh_shape=(1, 2))
    with pytest.raises(NotImplementedError, match=r"MoE experts \(3\)"):
        tp.Engine().install_model("m", rt,
                                  params=jax.tree.map(np.asarray, mparams),
                                  model_config=port_config(mcfg),
                                  device=CPU2)


def test_engine_on_a_mesh_prefills_through_the_tp_segments(monkeypatch):
    """Default flags, max_length >= 128: the mesh install holds a TP
    prefill plan for bucket 128 that adopts the TP decode plan's streams,
    and the bucket-128 prompt goes through `tp_prefill` (its step key
    (128, "tp")); DI_PREFILL_MEGAKERNEL=0 prefills per-op TP and decodes
    through the same segments. Each gives the single-device serving's
    greedy tokens under the same flags (the first 10 of 14 as above): the
    TP prefill segments those of the prefill megakernel, the per-op TP
    prefill those of the per-op prefill. The two prefills agree on the
    first token; from the second on this random model's near-ties follow
    the pool's roundings (the segments quantize K/V from the bf16-rounded
    products, the per-op prefill from f32 ones), on one device as on the
    mesh."""
    from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
    calls = []
    real = ttpk.tp_prefill

    def spy(*a, **k):
        calls.append(a[0].S)
        return real(*a, **k)

    monkeypatch.setattr(ttpk, "tp_prefill", spy)
    run, toks = _port(CPU2)
    assert sorted(run._tp_pmk_plans) == [128] and not run._pmk_plans
    assert run._tp_pmk_plans[128].qkv is run.tp_mega_plan.qkv
    assert set(run._prefill_steps) == {(128, "tp")} and calls == [128]
    monkeypatch.setenv("DI_PREFILL_MEGAKERNEL", "0")
    run_off, toks_off = _port(CPU2)
    assert run_off.tp_mega_plan is not None and not run_off._tp_pmk_plans
    assert set(run_off._prefill_steps) == {(128, False)} and calls == [128]
    run_1, single_off = _port("cpu", mesh=1)
    assert set(run_1._prefill_steps) == {(128, False)}
    monkeypatch.delenv("DI_PREFILL_MEGAKERNEL")
    run_1, single = _port("cpu", mesh=1)
    assert set(run_1._prefill_steps) == {(128, True)}
    assert len(toks) == len(toks_off) == len(single) == 14
    assert toks[:10] == single[:10], (toks, single)
    assert toks_off[:10] == single_off[:10], (toks_off, single_off)
    assert toks[0] == toks_off[0]


@pytest.mark.parametrize("per_op", [False, True])
def test_moe_engine_on_a_mesh_same_tokens(per_op, monkeypatch):
    """The tiny Qwen2-MoE of tests/test_torch_engine.py (a16w4, 4 experts
    top-2, a gated shared expert; one query and one KV head a rank) on a
    (1, 2) CPU mesh: each rank holds 2 experts and routes over all 4. With
    the default flags the install holds a TP plan over the global router
    and no TP prefill plan (the JAX prefill segments compute a dense MLP),
    decode runs the attn and moe segments (their plain versions) and the
    prompt prefills per-op TP; its greedy tokens agree with the port's and
    the JAX package's single-device engines for the first 8 of 14 (the
    decode megakernel's MoE bound against the XLA path,
    tests/test_torch_engine.py). DI_MEGAKERNEL=0: per-op TP throughout, the
    first 10 against the single-device per-op engines (the dense mesh's
    bound above: the ranks' partials are summed in another order)."""
    import dashinfer_tpu as jp
    import dashinfer_tpu_torch as tp
    from tests.test_torch_engine import _greedy, _moe_fixture
    cfg, rt, np_params = _moe_fixture(max_length=160)
    if per_op:
        monkeypatch.setenv("DI_MEGAKERNEL", "0")

    def port(mesh):
        b = (tp.RuntimeConfigBuilder("moe").max_length(rt.max_length)
             .max_batch(rt.max_batch).kv_cache_page_size(rt.cache.page_size)
             .kv_cache_num_pages(rt.cache.num_pages)
             .kv_cache_mode(tp.CacheMode.INT8).dtype(rt.dtype)
             .update({"min_prefill_bucket": rt.min_prefill_bucket}))
        if mesh:
            b = b.mesh(1, 2)
        eng = tp.Engine().install_model(
            "moe", b.build(), params=np_params, model_config=port_config(cfg),
            device=CPU2 if mesh else "cpu")
        run = eng._models["moe"]
        eng.start_model("moe")
        try:
            _, h, q = eng.start_request("moe", PROMPT, _greedy(tp))
            eng.sync_request("moe", h, timeout_s=300)
        finally:
            eng.release_model("moe")
        assert q.GenerateStatus() == \
            tp.GenerateRequestStatus.GenerateFinished
        return run, q.GetAllGeneratedTokens()

    run, mesh_toks = port(True)
    assert len(run.cache) == 2 and not run._tp_pmk_plans
    assert run.mega_plan is None and not run._pmk_plans
    assert 128 in run.buckets
    assert set(run._prefill_steps) == {(16, False)}
    if per_op:
        assert run.tp_mega_plan is None
    else:
        plan = run.tp_mega_plan
        assert (plan.E, plan.E_global, plan.EP) == (2, 4, 128)
    assert run.params[1]["layers"]["router"]["w"].shape[-1] == 4
    _, single = port(False)
    name = rt.model_name
    jeng = jp.Engine().install_model(name, rt, params=np_params,
                                     model_config=cfg).start_model(name)
    try:
        _, h, jq = jeng.start_request(name, PROMPT, _greedy(jp))
        jeng.sync_request(name, h, timeout_s=600)
    finally:
        jeng.release_model(name)
    jax_single = jq.GetAllGeneratedTokens()
    k = 10 if per_op else 8
    assert len(mesh_toks) == len(single) == len(jax_single) == 14
    assert mesh_toks[:k] == single[:k], (mesh_toks, single)
    assert mesh_toks[:k] == jax_single[:k], (mesh_toks, jax_single)
