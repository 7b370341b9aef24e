"""The quant_matmul kernel's K split and arithmetic, on the CPU (no card here):

* the plain version against the Pallas kernel in interpret mode at the
  quant group sizes the kernel now splits inside (per-channel, 64);
* the wrapper's split plan (`split_plan`, `split_chunks`) at Qwen2-7B's
  projection shapes and a (1, 2) mesh's shards: every (tile, K row) covered
  exactly once, the grid filled as far as the chunks and the card's
  resident blocks allow, the partials inside the scratch;
* a numpy model of csrc/quant_matmul.cu (the lanes' bytes as the A tiles'
  columns, u4 levels fed as 128 + n, each split's part of a group under that
  group's affine, the partials summed in split order) against the plain
  version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu.loader import quantize as jq
from dashinfer_tpu.ops.pallas import quant_matmul as jqmm
from dashinfer_tpu_torch.ops import quant_matmul as tqmm

H100_SMS = 132
H100_BLOCKS_PER_SM = 2   # what the kernel reports on the H100


def _leaf(K, N, gs, bits, seed=0):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32) * 0.1
    return jq.quantize_weight(w, bits, gs)


def _x(M, K, seed=1):
    return np.random.RandomState(seed).randn(M, K).astype(np.float32) * 0.5


def _torch_leaf(leaf):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in leaf.items()}


@pytest.mark.parametrize("gs,K", [(-1, 1024), (64, 256)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 5, 32])
def test_plain_matches_pallas_in_group_sizes(gs, K, bits, M):
    """Per-channel (one group of K rows) and 64-row groups: the plain twin
    against the Pallas kernel in interpret mode; both sum bf16 x exact-level
    products in f32 in another order: max|d| <= 1e-5 * max|ref|."""
    N = 256
    leaf = _leaf(K, N, gs, bits)
    x = _x(M, K)
    want = np.asarray(jqmm.quant_matmul(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in leaf.items()},
        jnp.float32))
    got = tqmm.quant_matmul_plain(torch.from_numpy(x), _torch_leaf(leaf),
                                  torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# Qwen2-7B (K, N): q|o, k|v, gate|up, down, lm_head; a (1, 2) mesh's
# shards: q|o and k|v columns, gate|up columns, down rows
SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
          (3584, 152064), (3584, 1792), (3584, 256), (3584, 9472),
          (9472, 3584)]


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("group", [128, 0])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_sm", [H100_BLOCKS_PER_SM, 1])
def test_split_plan_covers_and_fills(K, N, group, bits, per_sm):
    """Every K row of a tile lies in exactly one chunk of exactly one split,
    a chunk inside one quant group; a block's tiles pair up, and its rows
    are all M but for a small product at M > 16 (two blocks of 16); the
    split blocks fit the scratch and one wave of the card's resident
    blocks; and K is split as far as those allow, unless its chunks or the
    partials' summing stop it (or one pass of the sum already has blocks
    on half the SMs, each streaming at most ONE_PASS chunks)."""
    G = K // group if group else 1
    gs = K // G
    for sms in (H100_SMS, 114):
        for M in (1, 8, 32):
            plan = tqmm.split_plan(K, N, G, M, bits, sms, per_sm)
            assert plan.tb in (1, 2) and plan.cols * plan.tb * 256 == N
            assert plan.tb == 1 or (bits == 4 and M <= 8)
            seen = np.zeros(K, np.int32)
            for s in range(plan.splits):
                chunks = tqmm.split_chunks(plan, s)
                assert chunks, "an empty split"
                for g, k0, rows in chunks:
                    assert g * gs <= k0 and k0 + rows <= (g + 1) * gs
                    assert 1 <= rows <= tqmm.CHUNK_K
                    seen[k0:k0 + rows] += 1
            assert (seen == 1).all()
            across = plan.cols * plan.slices   # blocks across N and M
            blocks = across * plan.splits
            assert plan.slices == 1 or (M > 16 and plan.slices == 2)
            rows = -(-M // plan.slices)        # a block's x rows
            cap = per_sm * sms
            if plan.splits > 1:
                assert blocks <= cap   # one wave; the partials fit the
                                       # scratch (32 x 256 f32 a block)
                assert rows * 256 * plan.tb <= tqmm.MAX_FUSED_M * tqmm.TILE_N
            one_pass = (plan.splits == tqmm.ONE_PASS and
                        2 * blocks >= sms and
                        plan.chunks <= tqmm.ONE_PASS * plan.splits)
            assert (plan.splits == plan.chunks or blocks + across > cap
                    or plan.splits == tqmm.reduce_optimum(plan, rows, bits)
                    or one_pass)
    if group == 0 and N <= 3584:
        assert plan.splits > 1          # per-channel leaves split in-group


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def kernel_model(x: np.ndarray, leaf, plan) -> np.ndarray:
    """csrc/quant_matmul.cu in numpy (f32): block column by block column,
    the levels read as the lanes read them (warp w's units U, lane group
    gid, A tile t, row half h), each split's chunks summed, its part of a
    group under that group's affine, the splits' partials summed in split
    order in groups of `reduce_fan`, then the groups in order."""
    w_q = np.asarray(leaf["w_q"])
    scale, zero = np.asarray(leaf["scale"]), np.asarray(leaf["zero"])
    bits = 8 if w_q.dtype == np.int8 else 4
    M, K = x.shape
    N = scale.shape[1]
    off = 128.0 if bits == 4 else 0.0
    xb = _bf16(x)
    boxes = (1 if bits == 4 else 2) * plan.tb    # 128-byte boxes of a row
    cols = 256 * plan.tb                         # a block's columns
    uw = boxes                                   # units a warp
    w, gid, u, h = np.meshgrid(np.arange(8), np.arange(8), np.arange(uw),
                               np.arange(2), indexing="ij")
    U = uw * w + u
    if bits == 4:       # tiles t = 0, 1 of unit U: bytes 2 gid + t
        U, gid, h = (np.stack([a, a], -1) for a in (U, gid, h))
        t = np.zeros_like(U)
        t[..., 1] = 1
        byte = 128 * (U >> 3) + 16 * (U & 7) + 2 * gid + t
        col = 256 * (U >> 3) + 128 * h + 16 * (U & 7) + 2 * gid + t
    else:               # one tile of unit U: bytes 2 gid (h 0), + 1 (h 1)
        byte = col = 16 * U + 2 * gid + h
    byte, col, h = byte.ravel(), col.ravel(), h.ravel()
    assert sorted(col) == list(range(cols))   # the A rows: every column once
    rb = boxes * 128                          # a block's payload row bytes
    out = np.zeros((M, N), np.float32)
    for bx in range(plan.cols):
        cs = bx * cols + col
        rowb = w_q[:, bx * rb:(bx + 1) * rb]
        if bits == 4:
            lev = ((rowb[:, byte] >> (4 * h)) & 15).astype(np.float32) + off
        else:
            lev = rowb[:, byte].astype(np.float32)
        parts = []
        for s in range(plan.splits):
            chunks = tqmm.split_chunks(plan, s)
            acc = np.zeros((M, cols), np.float32)
            part = np.zeros((M, cols), np.float32)
            xs = np.zeros(M, np.float32)
            xbs = np.zeros(M, np.float32)
            for i, (g, k0, rows) in enumerate(chunks):
                part += xb[:, k0:k0 + rows] @ lev[k0:k0 + rows]
                xs += x[:, k0:k0 + rows].sum(1)
                xbs += xb[:, k0:k0 + rows].sum(1)
                if k0 + rows == (g + 1) * plan.gs or i + 1 == len(chunks):
                    acc += ((part - off * xbs[:, None]) * scale[g, cs] +
                            xs[:, None] * zero[g, cs])
                    part[:] = 0
                    xs[:] = 0
                    xbs[:] = 0
            parts.append(acc)
        # summed in groups of `fan` splits, then the groups, each in order
        fan = tqmm.reduce_fan(plan.splits)
        total = np.zeros((M, cols), np.float32)
        for g0 in range(0, plan.splits, fan):
            group = np.zeros((M, cols), np.float32)
            for acc in parts[g0:g0 + fan]:
                group += acc
            total += group
        out[:, cs] = total
    return out


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,gs,sms", [
    (1024, -1, 8),    # per-channel: 16 chunks in 4..16 splits, in-group
    (1024, 128, 6),   # 16 chunks in 3..12 splits: starting mid-group
    (768, 96, 4),     # 64 + 32-row chunks of 96-row groups
    (512, 32, 4),     # 32-row groups, a chunk each
    (1024, 128, 64),  # up to one chunk a split (fan 4 of 16 splits)
])
@pytest.mark.parametrize("M", [1, 8, 9, 32])
def test_kernel_model_matches_plain(bits, K, gs, sms, M):
    """The split arithmetic is the plain version's up to the order of the
    f32 sums, with one tile a block and (u4, M <= 8) two: max|d| <= 1e-5 *
    max|ref|."""
    N = 512
    leaf = _leaf(K, N, gs, bits, seed=K + gs)
    G = leaf["scale"].shape[0]
    plan = tqmm.split_plan(K, N, G, M, bits, sms, H100_BLOCKS_PER_SM)
    assert plan.splits > 1
    x = _x(M, K, seed=M)
    want = tqmm.quant_matmul_plain(torch.from_numpy(x), _torch_leaf(leaf),
                                   torch.float32).numpy()
    got = kernel_model(x, leaf, plan)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

