"""Sampler: the port against the JAX package on the same numpy inputs (CPU).

The Gumbel noise differs by design (torch.Generator seeded from (seed,
step) against jax.random threefry), so sampled rows are compared on
determinism, and greedy rows token for token."""

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
        seed=np.arange(B).astype(np.uint32),     # JAX's noise only
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
                           max_top_k=16).numpy()
        assert np.array_equal(got, want)


def test_same_seed_same_tokens():
    jsp, tsp = _params(0)
    logits, counts, gen_lens = _inputs(0)

    def draw(seeds, step):
        noise = tsamp.gumbel_noise([(s, step) for s in seeds], 16, "cpu")
        return tsamp.sample(torch.from_numpy(logits), tsp,
                            torch.from_numpy(counts),
                            torch.from_numpy(gen_lens), noise,
                            max_top_k=16).numpy()

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
