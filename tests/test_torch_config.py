"""The port's RuntimeConfigBuilder and GenerationConfig accept and reject the
same inputs as the JAX package's (the port raises ValueError where the JAX
package asserts)."""

import dataclasses

import pytest

import dashinfer_tpu.config as jcfg
import dashinfer_tpu_torch.config as tcfg

_BUILDS = {
    "defaults": lambda b, m: b,
    "engine_limits": lambda b, m: b.max_length(96).max_batch(2),
    "page16_int8": lambda b, m: b.kv_cache_page_size(16).kv_cache_mode(
        m.CacheMode.INT8).kv_cache_num_pages(24),
    "uint4_page512": lambda b, m: b.kv_cache_mode(m.CacheMode.UINT4)
    .kv_cache_page_size(512),
    "a16w4_g128": lambda b, m: b.weight_quant("a16w4", 128),
    "update": lambda b, m: b.update({"min_prefill_bucket": 16,
                                     "enable_megakernel": False}),
    "min_length": lambda b, m: b.max_length(2).max_batch(1),
    "bad_page_size": lambda b, m: b.kv_cache_page_size(24),
    "bad_max_batch": lambda b, m: b.max_batch(0),
    "bad_max_length": lambda b, m: b.max_length(1),
}


def _build(mod, name):
    try:
        return _BUILDS[name](mod.RuntimeConfigBuilder("m"), mod).build()
    except (AssertionError, ValueError):
        return "rejected"


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_runtime_config_builder_parity(name):
    want = _build(jcfg, name)
    got = _build(tcfg, name)
    if want == "rejected":
        assert got == "rejected"
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_pages_per_seq == want.max_pages_per_seq


_GEN = {
    "defaults": {},
    "greedy": {"do_sample": False, "top_k": 1},
    "top_p_one": {"top_p": 1.0},
    "top_p_zero": {"top_p": 0.0},
    "top_p_big": {"top_p": 1.5},
    "top_k_negative": {"top_k": -1},
    "top_k_vocab": {"top_k": 512},
    "top_k_over_vocab": {"top_k": 513},
    "temperature_zero": {"temperature": 0.0},
    "temperature_negative": {"temperature": -0.5},
    "top_logprobs_10": {"top_logprobs": 10},
    "top_logprobs_11": {"top_logprobs": 11},
    "beams": {"num_beams": 2},
    "max_length_engine": {"max_length": 96},
    "max_length_over": {"max_length": 97},
}


def _validate(mod, name):
    g = mod.GenerationConfig(**_GEN[name])
    try:
        g.validate(vocab_size=512, engine_max_length=96)
        return "ok"
    except ValueError:
        return "rejected"


@pytest.mark.parametrize("name", sorted(_GEN))
def test_generation_config_validation_parity(name):
    assert _validate(tcfg, name) == _validate(jcfg, name)


def test_generation_config_update_parity():
    for mod in (jcfg, tcfg):
        g = mod.GenerationConfig().update({"top_k": 3, "seed": 9})
        assert (g.top_k, g.seed) == (3, 9)
        with pytest.raises(KeyError):
            g.update({"no_such_field": 1})
