"""Sampler: the port against the JAX package on the same numpy inputs (CPU).

The port draws its Gumbel noise as the JAX package does (threefry2x32,
fold_in, the partitionable random bits): raw bits and uniforms equal to
jax.random's, the noise within the last bits of the two libraries' `log`,
and sampled tokens equal, greedy and seeded."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu.ops import sampling as jsamp
from dashinfer_tpu.runtime.batch_state import SamplingParams as JSP
from dashinfer_tpu_torch.ops import sampling as tsamp
from dashinfer_tpu_torch.runtime.batch_state import SamplingParams as TSP

B, V = 6, 96


def _params(seed: int, **over):
    rng = np.random.RandomState(seed)
    p = dict(
        temperature=rng.uniform(0.5, 1.5, B).astype(np.float32),
        top_k=np.asarray([1, 0, 5, 20, 1, 3], np.int32),
        top_p=np.asarray([1.0, 0.9, 0.5, 1.0, 0.7, 1.0], np.float32),
        repetition_penalty=rng.uniform(1.0, 1.3, B).astype(np.float32),
        presence_penalty=rng.uniform(0.0, 0.5, B).astype(np.float32),
        frequency_penalty=rng.uniform(0.0, 0.2, B).astype(np.float32),
        seed=np.arange(B).astype(np.uint32),     # JAX's noise; the port
                                                 # takes (seed, step) rows
        min_gen_len=np.asarray([0, 5, 0, 9, 2, 0], np.int32),
        stop_token_ids=rng.randint(-1, V, (B, 4)).astype(np.int32),
    )
    p.update(over)
    jsp = JSP(**{k: jnp.asarray(v) for k, v in p.items()})
    tsp = TSP(**{k: torch.from_numpy(v) for k, v in p.items()
                 if k != "seed"})
    return jsp, tsp


def _inputs(seed: int):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    counts = rng.randint(0, 3, (B, V)).astype(np.int32) * \
        (rng.rand(B, V) < 0.2)
    gen_lens = rng.randint(0, 10, B).astype(np.int32)
    return logits, counts.astype(np.int32), gen_lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_process_logits_matches_jax(seed):
    jsp, tsp = _params(seed)
    logits, counts, gen_lens = _inputs(seed)
    want = np.asarray(jsamp.process_logits(
        jnp.asarray(logits), jsp, jnp.asarray(counts), jnp.asarray(gen_lens)))
    got = tsamp.process_logits(torch.from_numpy(logits), tsp,
                               torch.from_numpy(counts),
                               torch.from_numpy(gen_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_tokens_match_jax(seed):
    """Rows with top_k=1 are greedy: the same token whatever the noise."""
    jsp, tsp = _params(seed, top_k=np.ones(B, np.int32))
    logits, counts, gen_lens = _inputs(seed)
    steps = np.full(B, 7, np.int32)
    want = np.asarray(jsamp.sample(
        jnp.asarray(logits), jsp, jnp.asarray(counts), jnp.asarray(gen_lens),
        jnp.asarray(steps), max_top_k=16, exact_topk=True).tokens)
    noise = tsamp.gumbel_noise([(s, 7) for s in range(B)], 16, "cpu")
    for gumbel in (None, noise):
        got = tsamp.sample(torch.from_numpy(logits), tsp,
                           torch.from_numpy(counts),
                           torch.from_numpy(gen_lens), gumbel,
                           max_top_k=16).tokens.numpy()
        assert np.array_equal(got, want)


def test_same_seed_same_tokens():
    jsp, tsp = _params(0)
    logits, counts, gen_lens = _inputs(0)

    def draw(seeds, step):
        noise = tsamp.gumbel_noise([(s, step) for s in seeds], 16, "cpu")
        return tsamp.sample(torch.from_numpy(logits), tsp,
                            torch.from_numpy(counts),
                            torch.from_numpy(gen_lens), noise,
                            max_top_k=16).tokens.numpy()

    seeds = list(range(100, 100 + B))
    a, b = draw(seeds, 3), draw(seeds, 3)
    assert np.array_equal(a, b)
    # other seeds / steps draw other noise (rows with top_k 1 stay greedy)
    n1 = tsamp.gumbel_noise([(1, 3)], 16, "cpu")
    assert not torch.equal(n1, tsamp.gumbel_noise([(2, 3)], 16, "cpu"))
    assert not torch.equal(n1, tsamp.gumbel_noise([(1, 4)], 16, "cpu"))
    assert torch.equal(tsamp.gumbel_noise([None], 16, "cpu"),
                       torch.zeros(1, 16))
    greedy = np.asarray(tsp.top_k) == 1
    assert np.array_equal(a[greedy], draw([7] * B, 9)[greedy])


SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1]
STEPS = [0, 1, 7, 1000, 2 ** 31 - 1]
K_DRAW = 67                   # odd: jax pads no count for the iota's bits


def _jax_key(seed, step):
    import jax
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(step))


@pytest.mark.parametrize("seed", SEEDS)
def test_noise_bits_and_uniforms_match_jax_random(seed):
    """The port's raw bits and uniforms equal jax.random's for
    fold_in(PRNGKey(seed), step); its Gumbel noise is jax.random.gumbel's
    within 2 ulp of the value plus 2 ulp of the inner -log(u) carried
    through the outer log (XLA's f32 `log` on the CPU is not correctly
    rounded: it differs from numpy's and torch's in ~14% of its last
    bits)."""
    import jax
    f32 = jnp.float32
    tiny = float(jnp.finfo(f32).tiny)
    seeds = torch.full((len(STEPS),), seed, dtype=torch.int64)
    steps = torch.tensor(STEPS, dtype=torch.int64)
    bits = tsamp.random_bits(seeds, steps, K_DRAW)
    u = tsamp.uniform_from_bits(bits)
    g = tsamp.gumbel_noise([(seed, t) for t in STEPS], K_DRAW, "cpu")
    assert bits.dtype == torch.int64 and u.dtype == torch.float32
    for i, step in enumerate(STEPS):
        key = _jax_key(seed, step)
        want_bits = np.asarray(jax.random.bits(key, (K_DRAW,), jnp.uint32))
        assert np.array_equal(bits[i].numpy(), want_bits.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(key, (K_DRAW,), f32,
                                               minval=tiny, maxval=1.0))
        assert np.array_equal(u[i].numpy(), want_u)
        want_g = np.asarray(jax.random.gumbel(key, (K_DRAW,), f32))
        t = -np.log(want_u)
        tol = 2 * np.spacing(np.abs(want_g)) + 2 * np.spacing(t) / t
        assert np.all(np.abs(g[i].numpy() - want_g) <= tol), (seed, step)


def test_noise_rows_greedy_zero():
    g = tsamp.gumbel_noise([(5, 3), None, (5, 3)], 16, "cpu")
    assert torch.equal(g[1], torch.zeros(16))
    assert torch.equal(g[0], g[2]) and bool((g[0] != 0).all())


@pytest.mark.parametrize("draw", [0, 1, 2])
def test_seeded_tokens_match_jax(draw):
    """Seeded top-k / top-p rows: the port's sampled tokens equal the JAX
    `sample`'s over B = 8 rows, each with its own seed and step."""
    Bs = 8
    rng = np.random.RandomState(40 + draw)
    p = dict(
        temperature=rng.uniform(0.7, 1.3, Bs).astype(np.float32),
        top_k=np.asarray([0, 5, 20, 1, 40, 0, 3, 64], np.int32),
        top_p=np.asarray([1.0, 0.9, 0.5, 1.0, 0.95, 0.8, 1.0, 0.7],
                         np.float32),
        repetition_penalty=np.ones(Bs, np.float32),
        presence_penalty=np.zeros(Bs, np.float32),
        frequency_penalty=np.zeros(Bs, np.float32),
        seed=np.asarray([0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 11, 12, 99,
                         123456789], np.uint32),
        min_gen_len=np.zeros(Bs, np.int32),
        stop_token_ids=np.full((Bs, 4), -1, np.int32),
    )
    jsp = JSP(**{k: jnp.asarray(v) for k, v in p.items()})
    tsp = TSP(**{k: torch.from_numpy(v) for k, v in p.items()
                 if k != "seed"})
    logits = (rng.randn(Bs, V) * 2).astype(np.float32)
    counts = np.zeros((Bs, V), np.int32)
    gen_lens = np.zeros(Bs, np.int32)
    steps = rng.randint(0, 5000, Bs).astype(np.int32)
    want = np.asarray(jsamp.sample(
        jnp.asarray(logits), jsp, jnp.asarray(counts), jnp.asarray(gen_lens),
        jnp.asarray(steps), max_top_k=64, exact_topk=True).tokens)
    rows = [None if p["top_k"][b] == 1 else (int(p["seed"][b]),
                                             int(steps[b]))
            for b in range(Bs)]
    noise = tsamp.gumbel_noise(rows, 64, "cpu")
    got = tsamp.sample(torch.from_numpy(logits), tsp,
                       torch.from_numpy(counts), torch.from_numpy(gen_lens),
                       noise, max_top_k=64).tokens.numpy()
    assert np.array_equal(got, want)
    # the noise moves tokens: without it some seeded rows pick otherwise
    plain = tsamp.sample(torch.from_numpy(logits), tsp,
                         torch.from_numpy(counts), torch.from_numpy(gen_lens),
                         None, max_top_k=64).tokens.numpy()
    assert not np.array_equal(got, plain)
