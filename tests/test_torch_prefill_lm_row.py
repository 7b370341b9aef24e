"""The lm_head's one-row product of both prefill kernels
(csrc/di_prefill_layer.cuh `lm_row`: the TP prefill lm segment's and the
prefill megakernel's last phase, the decode kernels' `product_phase` at one
row) on the CPU: its K split (ops/prefill_megakernel.py `choose_row_split`)
at the served geometries, a numpy model of its lanes (the decode product's
model, tests/test_torch_megakernel_geometry.py `product_model`, run over
each split's chunks, the splits then summed in ascending order), a plain
torch model of the split-summed product against the kernel's own rounding
(`lm_row_ref`), `prefill_lm_segment_ref` and the JAX
`build_prefill_lm_segment` in interpret mode, the row the kernel leaves in
its scratch (`kernel_x_last`), and the scratch the splits need.

Tolerances: the split models and the kernel's own rounding (`lm_row_ref`,
the decode plain product `megakernel.leaf_dot`: bf16 x by the bf16 levels,
the group affine on the f32 sums) compute the same products exactly in f32
and differ only in the order of the f32 sums (per split, then the splits
in order), so they agree within 1e-5 of the largest |logit| (K = 256
here). The plain versions (`prefill_lm_ref`) and the JAX kernel dequantize
weight-side (each weight rounded to bf16 before the dot): against them the
split sum is held to 1e-2 of their largest, the logits rule of PERF.md §2
(tests/test_torch_tp_prefill_segments.py holds the port's plain lm segment
to the JAX one at the same 1e-2)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashinfer_tpu.ops.pallas import tp_megakernel as jtpk
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_torch_megakernel import LOGITS_RTOL
from tests.test_torch_megakernel_geometry import (_leaf, product_model,
                                                  records)
from tests.test_torch_tp_prefill_segments import prefill_case, prompt_inputs

ORDER_RTOL = 1e-5
GRID = 132                  # one block an SM of an H100 SXM
CHUNK = tmk.CHUNK_K
# (blocks, blocks an SM): the prefill megakernel's grid and the TP lm
# segment's (two blocks an SM)
GRIDS = [(GRID, 1), (2 * GRID, 2)]

# (what, vocab columns of the shard, K chunks): Qwen2-7B (hidden 3584) at
# n = 1 / 2 / 4, Qwen3-8B (hidden 4096) whole and at n = 2, Baichuan2-13B
# (hidden 5120) whole and its TP check geometry's shard at n = 2
SERVED = [("qwen2-7b", 152064, 56), ("qwen2-7b n=2", 76032, 56),
          ("qwen2-7b n=4", 38016, 56), ("qwen3-8b", 151936, 64),
          ("qwen3-8b n=2", 75968, 64), ("baichuan2-13b", 125696, 80),
          ("baichuan2-13b n=2", 62848, 80)]


def split_chunks(ks, cps, chunks):
    """The chunks of each split, as `row_item` takes them."""
    return [range(s * cps, min(cps, chunks - s * cps) + s * cps)
            for s in range(ks)]


def block_items(tiles, ks, grid):
    """Each block's (tile, split) items, in its order (`lm_row_phase`)."""
    return [[(i // ks, i % ks) for i in range(b, tiles * ks, grid)]
            for b in range(grid)]


@pytest.mark.parametrize("grid,per_sm", GRIDS)
@pytest.mark.parametrize("what,columns,chunks", SERVED)
def test_row_split_covers_every_item_once(what, columns, chunks, grid,
                                          per_sm):
    tiles = -(-columns // 256)
    ks, cps = tpmk.choose_row_split(tiles, chunks, grid, per_sm)
    assert ks >= 1 and cps >= 1 and -(-chunks // cps) == ks, what
    # the kernel's own check (`lm_row_args_ok`): no empty split
    assert (ks - 1) * cps < chunks
    parts = split_chunks(ks, cps, chunks)
    assert all(len(p) > 0 for p in parts)
    assert sorted(c for p in parts for c in p) == list(range(chunks))
    seen = [it for items in block_items(tiles, ks, grid) for it in items]
    assert sorted(seen) == [(t, s) for t in range(tiles) for s in range(ks)]
    # at most one item a block more than the fewest
    counts = [len(items) for items in block_items(tiles, ks, grid)]
    assert max(counts) - min(counts) <= 1
    # a split streams fewer chunks on the busiest SM than whole-K items
    sms = grid // per_sm
    assert -(-tiles * ks // sms) * cps <= -(-tiles // sms) * chunks


@pytest.mark.parametrize("columns,grid,per_sm", [
    (152064, GRID, 1), (76032, GRID, 1), (76032, 2 * GRID, 2)])
def test_row_split_takes_the_measured_fastest(columns, grid, per_sm):
    """Qwen2-7B's whole vocab (the prefill megakernel's lm_head: 594 x 2
    items, 9 whole waves of 132) and its n = 2 shard (the TP lm segment):
    2 splits of 28 chunks, the split its sweep on an H100 read fastest on
    both grids (`tools/ab_decode.py --lm-splits`), where 4 of 14 would
    fill whole waves of the shard; one split left the last of 3 (5) waves
    partly idle."""
    tiles = columns // 256
    assert tpmk.choose_row_split(tiles, 56, grid, per_sm) == (2, 28)
    if tiles == 594:
        assert tiles * 2 % grid == 0 and tiles * 2 // grid == 9


def split_mask(ks, cps, chunks):
    """[ks, chunks * 64] f32: 1 where a row of K is in the split."""
    m = np.zeros((ks, chunks * CHUNK), np.float32)
    for s, r in enumerate(split_chunks(ks, cps, chunks)):
        m[s, CHUNK * r.start:CHUNK * r.stop] = 1.0
    return m


def row_model(x, packed, bits, ks, cps, nvalid):
    """`lm_row` in numpy: each split's items as the decode product runs
    them on one row of records (`product_model` on x zeroed outside the
    split's chunks: the zero chunks add exact zeros to the sums and to the
    group affine, so each split's partial is the kernel's item arithmetic),
    then the splits added from 0 up."""
    mask = split_mask(ks, cps, x.shape[0] // CHUNK)
    parts = [product_model((x * m)[None], packed, bits,
                           tpmk.ROW_RECORD_BYTES // (2 * CHUNK + 4))[0]
             for m in mask]
    out = parts[0].copy()
    for p in parts[1:]:
        out += p
    return out[:nvalid]


def split_sum(x_last, leaf, ks, cps, nvalid):
    """The split-summed product in torch, in the kernel's order: each
    split's decode-rounded product (`leaf_dot` of x zeroed outside its
    chunks), then the splits added from 0 up."""
    mask = torch.from_numpy(split_mask(ks, cps, x_last.shape[-1] // CHUNK))
    parts = [tmk.leaf_dot((x_last.float() * m).to(torch.bfloat16), leaf)[0]
             for m in mask]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out[:nvalid]


@pytest.mark.parametrize("bits,G,ks,cps", [
    (4, 2, 1, 4),       # u4 group 128, one split (logits written straight)
    (4, 2, 2, 2),       # a split a group
    (4, 4, 3, 2),       # group 64, a ragged last split of one chunk
    (8, 1, 4, 1),       # int8 per channel: the qparams at each item's start
    (8, 2, 2, 2),       # int8 group-wise
    (16, 1, 2, 2),      # bf16
])
def test_lanes_give_the_plain_product(bits, G, ks, cps):
    K, N, nvalid = 256, 512, 510       # two tiles; a width short of them
    leaf = _leaf(bits, K, N, G, seed=7 * bits + ks)
    packed = tmk.packed_leaf(leaf)
    x = np.random.RandomState(ks + bits).randn(K).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)[None]
    want = tmk.leaf_dot(xb, packed)[0, :nvalid].numpy()
    got = row_model(x, packed, bits, ks, cps, nvalid)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ORDER_RTOL * np.abs(want).max())
    # and the prefill's weight-side rounding within the logits rule
    wside = (xb.float() @ tpmk.dequantized_leaf(packed))[0, :nvalid].numpy()
    assert np.abs(got - wside).max() <= LOGITS_RTOL * np.abs(wside).max()


@pytest.mark.parametrize("quant,mode,KH", [
    ("a16w4", "int8", 2), ("a16w8", "uint4", 4), ("none", "default", 2)])
def test_split_sum_matches_plain_and_jax(quant, mode, KH):
    """Each rank's lm segment on the tiny TP shape (hidden 256: 4 chunks;
    a 256-column shard) as the split-summed product at every split of its
    four chunks, against the port's plain lm segment and the JAX segment in
    interpret mode."""
    c = prefill_case(quant, mode, KH)
    plan, jplan = c["plan"], c["jplan"]
    n_tok = 45
    inp = prompt_inputs(c, n_tok)
    x = inp["x"]
    seg_lm = jtpk.build_prefill_lm_segment(jplan, interpret=True)
    chunks = plan.lm.K // CHUNK
    for r in range(2):
        pk = c["packs"][r]
        jpk = jax.tree.map(lambda a: a[r], c["jpacked"])
        lg_j = np.asarray(seg_lm(jnp.asarray(x), jnp.int32(n_tok),
                                 jpk))[0, :plan.V]
        ref = ttpk.prefill_lm_segment_ref(plan, pk, torch.from_numpy(
            x.copy()), inp["n"]).numpy()
        x_last = tmk._rms(torch.from_numpy(x[n_tok - 1:n_tok]),
                          pk["final_norm"], plan.rms_eps).to(torch.bfloat16)
        one = tmk.leaf_dot(x_last, pk["lm_head"])[0, :plan.V].numpy()
        np.testing.assert_array_equal(
            tpmk.lm_row_ref(plan, pk, x_last[0]).numpy(), one)
        for ks in range(1, chunks + 1):
            cps = -(-chunks // ks)
            if -(-chunks // cps) != ks:
                continue
            got = split_sum(x_last, pk["lm_head"], ks, cps, plan.V).numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(
                got, one, rtol=0, atol=ORDER_RTOL * np.abs(one).max())
            for want in (ref, lg_j):
                err = np.abs(got - want).max()
                assert err <= LOGITS_RTOL * np.abs(want).max(), (r, ks, err)
        # the geometry the wrapper would give a small grid of this shard
        ks, cps = tpmk.choose_row_split(plan.lm.Nptot // 256, chunks, 1)
        assert (ks - 1) * cps < chunks


@pytest.mark.parametrize("K", [64, 256, 3584])
def test_kernel_x_last_reads_the_records(monkeypatch, K):
    """`kernel_x_last` gives back the bf16 row a launch wrote as row 0 of
    x_last's records (the numpy model of `write_record`), the rows 1..15
    and the row sums left out."""
    x = np.random.RandomState(K).randn(K).astype(np.float32)
    rec = records(x[None], tpmk.ROW_RECORD_BYTES // (2 * CHUNK + 4))
    assert rec.shape == (K // CHUNK, tpmk.ROW_RECORD_BYTES)
    sc = tpmk._Scratch(torch.device("cpu"))
    # a scratch grown past this plan's need: the tail is not read
    sc.bufs["x_last"] = torch.cat([
        torch.from_numpy(rec.reshape(-1)).view(torch.bfloat16),
        torch.full((77,), float("nan"), dtype=torch.bfloat16)])
    monkeypatch.setitem(tpmk._scratch, torch.device("cpu"), sc)
    got = tpmk.kernel_x_last(types.SimpleNamespace(hid=K), "cpu")
    want = torch.from_numpy(x).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (K,)
    assert torch.equal(got, want)


def test_scratch_need_counts_the_lm_partials():
    """The lm_head's split partials share `partial` with the layers'
    products (sized for the larger), with one ticket a 256-column tile and
    x_last one row's records."""
    c = prefill_case("a16w4", "int8", 2)
    plan = c["plan"]
    splits = {sp.name: (1, sp.K // CHUNK) for sp in plan.streams}
    base = tpmk.scratch_need(plan, splits, resid=False)
    tiles = plan.lm.Nptot // 256
    assert base["tickets"] == tiles
    assert 2 * base["x_last"] == plan.hid // CHUNK * tpmk.ROW_RECORD_BYTES
    assert tpmk._SCRATCH_DTYPES["x_last"].itemsize == 2
    assert tpmk.ROW_RECORD_BYTES == 16 * 132    # di_product.cuh rec_bytes(16)
    big = plan.S * max(sp.Nptot for sp in plan.layer_streams) // \
        plan.lm.Nptot + 1
    splits["lm"] = (big, 1)
    need = tpmk.scratch_need(plan, splits, resid=False)
    assert need["partial"] == big * plan.lm.Nptot > base["partial"]
    assert need["tickets"] == tiles
    assert tpmk._SCRATCH_DTYPES["tickets"] == torch.int32
