"""The attention's redesigned hand-off in the TP attn segment and the
decode megakernel (csrc/di_product.cuh `qkv_epilogue` / `sum_tile`,
csrc/di_layer.cuh `attention_phase` / `merge_group`), as numpy models on
the CPU (no card here):

* the TP attn segment's q|k|v product epilogue: the work items (pass,
  256-column tile, K split) of the split plan the wrappers compute finish
  in a random order; each takes its (pass, tile) ticket, and the block
  that takes the last sums the tile's split partials in ascending split
  order, adds the bias and writes q|k|v at the true widths
  (`qkv_epilogue_columns`, the kernel's mapping). Every q|k|v column of
  every active row is written exactly once, no padding column and no
  inactive row is,
  the tickets are back at 0, and the values are bit-equal to the sums the
  attention items make (the partials at the leaves' padded offsets +
  bias), on the local plans of (1, 2) and (1, 4) meshes
  (`tp_megakernel.make_tp_plan`, KH 2 and 4) and at Qwen2-7B's widths;
* the merge's ticket a (slot, KV head), both kernels': the attention
  items the kernel enumerates (chunks of `attention_chunks`, past-lens
  chunks and inactive slots skipped) finish in a random order; the last
  of a pair merges it, once, after all of its chunks, and an inactive
  slot's zero records are written once, by its chunk 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dashinfer_tpu_torch.loader import params_from_numpy
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_torch_megakernel import _port_rt
from tests.test_torch_tp_split import tp_fixture
from tests.test_torch_transformer import port_config

D = 128


def _tp_plan(KH: int, n: int, quant: str = "a16w4"):
    cfg, rt, params = tp_fixture(quant, KH=KH)
    tcfg = port_config(cfg)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    plan, _ = ttpk.make_tp_plan(tcfg, _port_rt(rt, "int8"),
                                ttpk.split_params_tp(tparams, tcfg, n))
    return plan


def _qwen2_7b_plan(n: int):
    """A local plan at Qwen2-7B's widths (28 heads on 4 KV heads, hid
    3584) on a (1, n) mesh: the tiny plan with its attention streams and
    head counts replaced."""
    base = _tp_plan(2, 2)
    H, KH, hid = 28 // n, 4 // n, 3584
    qkv = tmk.StreamPlan("qkv", base.qkv.leaves, 4, hid,
                         (H * D, KH * D, KH * D), 128)
    o = tmk.StreamPlan("o", base.o.leaves, 4, H * D, (hid,), 128)
    return dataclasses.replace(base, H=H, KH=KH, G=H // KH, hid=hid,
                               QKVN=(H + 2 * KH) * D, qkv=qkv, o=o, B=8)


def _plans():
    return {"tiny_kh2_n2": lambda: _tp_plan(2, 2),
            "tiny_kh4_n2": lambda: _tp_plan(4, 2),
            "tiny_kh4_n4": lambda: _tp_plan(4, 4, "none"),
            "qwen2_7b_n1": lambda: _qwen2_7b_plan(1),
            "qwen2_7b_n2": lambda: _qwen2_7b_plan(2),
            "qwen2_7b_n4": lambda: _qwen2_7b_plan(4)}


def qkv_epilogue_columns(plan) -> np.ndarray:
    """Where the TP attn segment's q|k|v product epilogue
    (csrc/di_product.cuh `sum_tile`) puts each column of its partial sums:
    int64 [tiles, 256], the column of q|k|v at their true widths ([B,
    QKVN]: q, then k, then v), or -1 for a column of a leaf's 256-column
    padding."""
    widths = (plan.H * D, plan.KH * D, plan.KH * D)
    out, base = [], 0
    for np_, w in zip(plan.qkv.Np, widths):
        lc = np.arange(np_, dtype=np.int64)
        out.append(np.where(lc < w, base + lc, -1).reshape(-1, 256))
        base += w
    return np.concatenate(out)


def _parent_columns(plan) -> np.ndarray:
    """For each column of q|k|v at its true width, the column of the
    partials the attention items summed before the epilogue did
    (csrc/di_layer.cuh at the parent: the leaf's first column at its
    padded offset)."""
    H, KH = plan.H, plan.KH
    n0, n1, _ = plan.qkv.Np
    col = np.arange(plan.QKVN)
    return np.where(col < H * D, col,
                    np.where(col < (H + KH) * D, col + n0 - H * D,
                             col + n0 + n1 - (H + KH) * D))


@pytest.mark.parametrize("grid", [8, 264])
@pytest.mark.parametrize("B", [1, 8, 20])
@pytest.mark.parametrize("which", sorted(_plans()))
def test_qkv_epilogue_writes_each_column_once(which, B, grid):
    plan = _plans()[which]()
    sp = plan.qkv
    mpad = tmk.padded_rows(B)
    passes = tmk.product_passes(mpad)
    rows = mpad // passes
    tiles = sp.Nptot // 256
    ksplit, _ = tmk.choose_split(tiles, sp.K // tmk.CHUNK_K,
                                 tmk.CHUNK_K * 256 * sp.bits // 8, B,
                                 passes, grid)
    rng = np.random.default_rng(B * 1000 + grid)
    partial = rng.standard_normal((ksplit, B, sp.Nptot)).astype(np.float32)
    partial[rng.random(partial.shape) < 0.02] = -0.0
    bias = rng.standard_normal(plan.QKVN).astype(np.float32)
    active = rng.random(B) < 0.8
    active[0] = True
    cols = qkv_epilogue_columns(plan)
    assert cols.shape == (tiles, 256)

    n_tile_tickets = tmk.epilogue_tickets(plan, mpad)
    tickets = np.zeros(n_tile_tickets, np.int64)
    out = np.full((B, plan.QKVN), np.nan, np.float32)
    writes = np.zeros((B, plan.QKVN), np.int64)
    items = [(p, t, s) for p in range(passes) for t in range(tiles)
             for s in range(ksplit)]
    for i in rng.permutation(len(items)):
        p, t, _ = items[i]
        k = p * tiles + t
        assert k < n_tile_tickets
        tickets[k] += 1
        if tickets[k] != ksplit:
            continue
        tickets[k] = 0
        m = np.arange(p * rows, min((p + 1) * rows, B))
        m = m[active[m]]
        c = np.nonzero(cols[t] >= 0)[0]
        v = np.zeros((len(m), len(c)), np.float32)
        for s in range(ksplit):          # ascending, from 0
            v = v + partial[s][np.ix_(m, t * 256 + c)]
        out[np.ix_(m, cols[t, c])] = v + bias[cols[t, c]]
        writes[np.ix_(m, cols[t, c])] += 1
    assert not tickets.any()
    assert (writes[active] == 1).all() and not writes[~active].any()

    # the parent's sums at the leaves' padded offsets, in the same order
    pc = _parent_columns(plan)
    ref = np.zeros((B, plan.QKVN), np.float32)
    for s in range(ksplit):
        ref = (ref + partial[s][:, pc]).astype(np.float32)
    ref = (ref + bias).astype(np.float32)
    np.testing.assert_array_equal(out[active].view(np.uint32),
                                  ref[active].view(np.uint32))
    # every padding column of the partials is one the epilogue skips
    pad = np.setdiff1d(np.arange(sp.Nptot), pc)
    assert (cols.reshape(-1)[pad] == -1).all()


@pytest.mark.parametrize("case,lens,active", [
    ("chunk0_only", [1, 37, 100, 127], [1, 1, 1, 1]),
    ("several_chunks", [1500, 128, 129, 2047], [1, 1, 1, 1]),
    ("inactive_slot", [300, 0, 999, 64], [1, 0, 1, 1]),
    ("served", [37, 64, 150, 300, 1, 127, 256, 500],
     [1, 1, 1, 1, 1, 0, 1, 1]),
])
@pytest.mark.parametrize("KH,grid", [(2, 264), (4, 132), (1, 16)])
def test_merge_ticket_merges_each_pair_once(case, lens, active, KH, grid):
    B = len(lens)
    lens = np.asarray(lens)
    active = np.asarray(active, bool)
    NC, CT = tmk.attention_chunks(B, KH, 2048, grid)
    n_items = B * KH * NC
    rng = np.random.default_rng(len(case) * 7 + KH)
    items = []
    zero_writes = np.zeros((B, KH), np.int64)
    for item in range(n_items):          # the kernel's enumeration
        j, h, b = item // (B * KH), item % KH, (item // KH) % B
        if not active[b]:
            if j == 0:
                zero_writes[b, h] += 1
            continue
        if j > 0 and j * CT >= lens[b]:
            continue
        items.append((j, b, h))
    tickets = np.zeros((B, KH), np.int64)
    done = np.zeros((B, KH, NC), bool)
    merges = np.zeros((B, KH), np.int64)
    for i in rng.permutation(len(items)):
        j, b, h = items[i]
        done[b, h, j] = True
        used = max(1, min(-(-int(lens[b]) // CT), NC))
        tickets[b, h] += 1
        if tickets[b, h] == used:
            tickets[b, h] = 0
            # every chunk the merge reads has been written
            assert done[b, h, :used].all() and not done[b, h, used:].any()
            merges[b, h] += 1
    assert not tickets.any()
    np.testing.assert_array_equal(merges, np.where(active, 1, 0)[:, None]
                                  * np.ones(KH, np.int64))
    np.testing.assert_array_equal(zero_writes,
                                  np.where(active, 0, 1)[:, None] *
                                  np.ones(KH, np.int64))
