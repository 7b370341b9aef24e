"""The port's two design probes on the CPU: their plain versions (which the
wrappers run for CPU tensors) against the JAX package's probe tools on the
same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu_torch.tools import probe_magic_dequant as tpm
from dashinfer_tpu_torch.tools import probe_reshape as tpr
from tools import probe_magic_dequant as jpm

# the port's chain -> the reference tool's variant of the same arithmetic
JAX_VARIANT = {"cvt": "i32", "magic16": "magic16", "magicf32": "magicf32"}


@pytest.mark.parametrize("chain", tpm.CHAINS)
def test_dequant_chain_equals_the_jax_tool(chain):
    """Levels (plus the chain's offset) exactly equal to the reference
    tool's `dequant` and to its Pallas check kernel in interpret mode."""
    pay = np.random.RandomState(7).randint(
        0, 256, size=(jpm.ROWS, jpm.HALF)).astype(np.uint8)
    lo, hi = tpm.dequant(chain, torch.from_numpy(pay))
    assert lo.dtype == torch.bfloat16 and tuple(lo.shape) == pay.shape
    jlo, jhi, off = jpm.dequant(JAX_VARIANT[chain], jnp.asarray(pay))
    assert off == tpm.OFFSET[chain]
    klo, khi = jpm.build_check(JAX_VARIANT[chain])(jnp.asarray(pay))
    for got, want, kern in ((lo, jlo, klo), (hi, jhi, khi)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(kern, np.float32))
    np.testing.assert_array_equal(lo.float().numpy() - off, pay & 0xF)
    np.testing.assert_array_equal(hi.float().numpy() - off, pay >> 4)


def test_dequant_dot_is_the_jax_tools_timed_loop():
    """acc += x @ lo + x @ hi over S chunks, `rounds` times: the reference's
    `build_timed` kernel (interpret mode) on the same payload and x."""
    S, rounds = 3, 2
    f = jpm.build_timed("i32", S, rounds)     # x = ones, payload from seed 0
    want = np.asarray(f())
    payload = np.random.RandomState(0).randint(
        0, 256, size=(S, jpm.ROWS, jpm.HALF)).astype(np.uint8)
    x = torch.ones((jpm.B, jpm.ROWS), dtype=torch.bfloat16)
    assert (tpm.B, tpm.ROWS, tpm.HALF) == (jpm.B, jpm.ROWS, jpm.HALF)
    for chain in tpm.CHAINS:
        got = tpm.dequant_dot(chain, x, torch.from_numpy(payload), rounds)
        np.testing.assert_array_equal(got.numpy(), want)   # integer sums


def test_relayout_is_the_reference_probes_q_pack():
    """q [B, H*D] -> [B, KH, 8, D]: the reference probe's per-(h, g) slice
    copies, `q4[:, h, g, :] = x[:, j:j+D]`, and zeros in the pad rows."""
    from tools import probe_reshape as jpr
    assert (tpr.B, tpr.H, tpr.KH, tpr.D, tpr.G8) == \
        (jpr.B, jpr.H, jpr.KH, jpr.D, jpr.G8)
    x = np.random.RandomState(1).randn(jpr.B, jpr.HD).astype(np.float32)
    want = np.zeros((jpr.B, jpr.KH, jpr.G8, jpr.D), np.float32)
    for h in range(jpr.KH):
        for g in range(jpr.G):
            j = (h * jpr.G + g) * jpr.D
            want[:, h, g, :] = x[:, j:j + jpr.D]
    for variant in tpr.VARIANTS:
        got = tpr.relayout(torch.from_numpy(x), jpr.KH, variant)
        np.testing.assert_array_equal(got.numpy(), want)


def test_timed_loop_refuses_other_shapes():
    """The kernel's chunk geometry is fixed; the guard runs before any
    build."""
    with pytest.raises(ValueError):
        tpm._Dot("cvt", torch.ones((4, 4), dtype=torch.bfloat16),
                 torch.zeros((1, 4, 4), dtype=torch.uint8), 1)
    assert tpr.relayout_plain(torch.ones((1, 2 * tpr.D)), 2).shape == \
        (1, 2, tpr.G8, tpr.D)
