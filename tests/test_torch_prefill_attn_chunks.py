"""The prefill attention phase's items and a model of its rounding
(csrc/di_prefill_layer.cuh `attention_phase`, run by the TP prefill attn
segment and the prefill megakernel), on the CPU (no card here):

* the items: (query head, 64-row half of a query tile), each half's key
  tiles shared by two warp groups (even and odd tiles), the halves with
  the most key tiles first, dealt to the blocks in rounds that turn back
  at each end (round r's item r x grid + b to block b, or to block grid -
  1 - b in odd rounds). Every item goes to one block, every (head, query
  row, key <= row) of the row tiles a prompt occupies is covered once,
  and the busiest block has no more steps (128 x 64 blocks of scores)
  than with the parent's (query head, query tile) items dealt
  round-robin, and fewer for every full bucket, on the local plans of
  (1, 1), (1, 2) and (1, 4) meshes at Qwen2-7B's widths and buckets 128
  .. 1024, at prompt lengths 1, 127, 129 and full;
* the rounding of a one-pass form that was built and measured (PERF.md
  §6): items of one or two 64-key tiles, a running maximum and sum with p
  rounded to bf16 before its division by the sum, the chunks merged in
  ascending order. A torch model of it stays within PERF.md §2's
  tolerance (1e-2 of the largest |output|) of the plain version's
  attention (ops/prefill_megakernel.py `prefill_attention_block_ref`:
  softmax, then p / l rounded to bf16) and, through the o product of the
  tiny TP model, of the plain segment and of the JAX package's prefill
  attn segment in interpret mode; on the card its deeper pool rows of the
  prefill megakernel left §2's bound, so the kernel keeps the plain
  version's rounding (two passes), and the model's two-pass form, the
  chunks' (max, sum) combined first, is held the same way."""

import dataclasses
import math

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
from tests.test_torch_tp_prefill_segments import (BUCKET, N, port_cache,
                                                  prefill_case, prompt_inputs)
from tests.test_torch_tp_segments import pool_shard

KEY_TILE = 64
M_TILE = tpmk.M_TILE
D = 128
GRID = 132                      # one block an SM of an H100
NEG = torch.finfo(torch.float32).min


def block_items(n_items, grid, turn_back=True):
    """csrc `attention_phase`'s dealing: the items of each block, round r's
    item r x grid + b to block b (to block grid - 1 - b in odd rounds when
    `turn_back`; the parent dealt round-robin)."""
    out = [[] for _ in range(grid)]
    for r in range(-(-n_items // grid)):
        for b in range(grid):
            item = r * grid + (grid - 1 - b if turn_back and r & 1 else b)
            if item < n_items:
                out[b].append(item)
    return out


def item_of(item, H, mtiles):
    """An item's (query head, query tile, 64-row half), the halves with the
    most key tiles first."""
    r = item // H
    return item % H, mtiles - 1 - r // 2, 1 - r % 2


def key_tiles(item, H, mtiles):
    """The key tiles up to a half's last row."""
    _, qt, hf = item_of(item, H, mtiles)
    return 2 * qt + hf + 1


def busiest(blocks, cost):
    return max(sum(cost(i) for i in b) for b in blocks)


def att_chunks(qt, C):
    """Chunks of C 64-key tiles of query tile qt's 2 (qt + 1) tiles."""
    return -(-2 * (qt + 1) // C)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("S", [128, 256, 512, 1024])
def test_items_cover_the_causal_range_once(n, S):
    H = 28 // n
    for n_tok in sorted({1, 127, 129, S}):
        if n_tok > S:
            continue
        mtiles = -(-n_tok // M_TILE)
        rows = mtiles * M_TILE
        n_items = 2 * H * mtiles
        dealt = block_items(n_items, GRID)
        assert sorted(i for b in dealt for i in b) == list(range(n_items))
        covered = np.zeros((H, rows, rows), np.int32)
        for b in dealt:
            for item in b:
                hh, qt, hf = item_of(item, H, mtiles)
                r0 = qt * M_TILE + hf * 64
                r = np.arange(r0, r0 + 64)
                for grp in range(2):             # the groups' key tiles
                    for kt in range(grp, key_tiles(item, H, mtiles), 2):
                        keys = np.arange(kt * KEY_TILE, (kt + 1) * KEY_TILE)
                        covered[hh, r[0]:r[-1] + 1, keys[0]:keys[-1] + 1] += \
                            keys[None, :] <= r[:, None]
        causal = np.tril(np.ones((rows, rows), np.int32))
        assert (covered == causal[None]).all(), (S, n_tok)
        # steps: a step is a 128 x 64 block of scores a block computes (two
        # groups of 4 warps on two key tiles; the parent's 8 warps on one)
        got = busiest(dealt, lambda i: -(-key_tiles(i, H, mtiles) // 2))
        # the parent's items (query head, query tile), dealt round robin
        was = busiest(block_items(H * mtiles, GRID, False),
                      lambda i: 2 * (mtiles - 1 - i // H + 1))
        assert got <= was
        if n_tok == S:
            assert got < was, (got, was)


def chunked_attention(q, k, v, G, C, scale, one_pass=False):
    """The kernel's attention of one layer on bf16-valued f32 q [S, H, D],
    k / v [S, KH, D], items of C 64-key tiles, 16-row warp groups skipping
    a tile wholly past their rows -> attn [S, H, D] rounded to bf16. Two
    passes (the kernel's): each chunk's running maximum and sum (f32) of
    exp(s - m), the chunks' combined in ascending order into the row's
    (m, l), then o_c = sum of bf16(exp(s - m) / l) v over the chunk's
    tiles, and attn = the chunks' o_c added in ascending order. One pass
    (`one_pass`, built and measured, PERF.md §6): o = sum of
    bf16(exp(s - m)) v with a running m and l, both rescaled by exp(m_old -
    m_new), the chunks merged in ascending order, attn = o / l."""
    S, H, _ = q.shape
    M = S // M_TILE
    out = torch.empty_like(q)
    rows = torch.arange(S)
    for hh in range(H):
        kk, vv = k[:, hh // G], v[:, hh // G]
        for qt in range(M):
            r = rows[qt * M_TILE:(qt + 1) * M_TILE]
            qq = q[r, hh]

            def tiles(c):
                for t in range(min(C, 2 * (qt + 1) - c * C)):
                    k0 = (c * C + t) * KEY_TILE
                    keys = torch.arange(k0, k0 + KEY_TILE)
                    # the warps that read the tile: k0 <= their last row
                    live = (r // 16) * 16 + 15 >= k0
                    s = (qq @ kk[keys].T) * scale
                    yield keys, live, torch.where(
                        keys[None, :] <= r[:, None], s, torch.tensor(NEG))

            nch = att_chunks(qt, C)
            states = []
            for c in range(nch):
                m = torch.full((M_TILE,), NEG)
                l = torch.zeros(M_TILE)
                o = torch.zeros(M_TILE, D)
                for keys, live, s in tiles(c):
                    mn = torch.maximum(m, s.max(1).values)
                    p = torch.exp(s - mn[:, None])
                    ln = l * torch.exp(m - mn) + p.sum(1)
                    if one_pass:
                        on = o * torch.exp(m - mn)[:, None] + \
                            p.to(torch.bfloat16).float() @ vv[keys]
                        o = torch.where(live[:, None], on, o)
                    m = torch.where(live, mn, m)
                    l = torch.where(live, ln, l)
                states.append((m, l, o))
            mx = torch.stack([s_[0] for s_ in states]).max(0).values
            L = torch.zeros(M_TILE)
            for m, l, _ in states:
                L = L + l * torch.exp(m - mx)
            O = torch.zeros(M_TILE, D)
            for c, (m, _, o) in enumerate(states):
                if one_pass:
                    O = O + o * torch.exp(m - mx)[:, None]
                    continue
                oc = torch.zeros(M_TILE, D)
                for keys, live, s in tiles(c):
                    p = (torch.exp(s - mx[:, None]) / L[:, None]).to(
                        torch.bfloat16).float()
                    oc = torch.where(live[:, None], oc + p @ vv[keys], oc)
                O = O + oc
            if one_pass:
                O = O / L[:, None]
            out[r, hh] = O.to(torch.bfloat16).float()
    return out


def plain_attention(q, k, v, G, scale):
    """prefill_attention_block_ref's attention: f32 softmax of the causal
    scores, p rounded to bf16, times bf16 v, rounded to bf16."""
    S, H, _ = q.shape
    KH = k.shape[1]
    s = torch.einsum("qhgd,khd->hgqk", q.reshape(S, KH, G, D), k) * scale
    causal = torch.arange(S)[None, :] <= torch.arange(S)[:, None]
    s = torch.where(causal, s, torch.tensor(NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hgqk,khd->qhgd", p.to(torch.bfloat16).float(),
                        v).reshape(S, H, D).to(torch.bfloat16).float()


@pytest.mark.parametrize("one_pass", [False, True])
@pytest.mark.parametrize("S,H,KH,C", [(128, 4, 2, 1), (512, 2, 1, 2),
                                      (384, 2, 2, 1)])
def test_chunked_model_holds_to_the_plain_attention(S, H, KH, C, one_pass):
    g = torch.Generator().manual_seed(S + H + C)
    bf = torch.bfloat16
    q = (torch.randn(S, H, D, generator=g) * 2).to(bf).float()
    k = (torch.randn(S, KH, D, generator=g) * 2).to(bf).float()
    v = torch.randn(S, KH, D, generator=g).to(bf).float()
    scale = 1.0 / math.sqrt(D)
    got = chunked_attention(q, k, v, H // KH, C, scale, one_pass)
    want = plain_attention(q, k, v, H // KH, scale)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= LOGITS_RTOL * want.abs().max().item(), err


def _chunked_block(plan, packed, layer, x, cos, sin, page_row, n_tokens,
                   cache, C, one_pass):
    """prefill_attention_block_ref with `chunked_attention` in place of the
    plain softmax (q and k rounded to bf16 for the scores, as the kernel's
    tensor cores take them)."""
    S, H, KH = plan.S, plan.H, plan.KH
    bf = torch.bfloat16
    inp = tpmk.PrefillInputs(plan, cos, sin, page_row, n_tokens)
    xn = tmk._rms(x, packed["norms"][layer, 0], plan.rms_eps).to(bf)
    qkv = tpmk._wdeq_dot(xn, packed, plan.qkv, layer)
    if packed["qkv_b"] is not None:
        qkv = qkv + packed["qkv_b"][layer]
    HD, KD = H * D, KH * D
    q = tpmk._rope(qkv[:, :HD].reshape(S, H, D), inp.cosf, inp.sinf)
    k = tpmk._rope(qkv[:, HD:HD + KD].reshape(S, KH, D), inp.cosf, inp.sinf)
    v = qkv[:, HD + KD:].reshape(S, KH, D)
    attn = chunked_attention(q.to(bf).float(), k.to(bf).float(),
                             v.to(bf).float(), H // KH, C,
                             1.0 / math.sqrt(D), one_pass)
    return tpmk._wdeq_dot(attn.reshape(S, HD).to(bf), packed, plan.o, layer)


@pytest.mark.parametrize("one_pass", [False, True])
@pytest.mark.parametrize("n_tokens", [45, BUCKET])
@pytest.mark.parametrize("C", [1, 2])
def test_chunked_segment_holds_to_plain_and_jax(n_tokens, C, one_pass):
    c = prefill_case("a16w4", "int8", 2)
    plan, ps = c["plan"], c["ps"]
    inp = prompt_inputs(c, n_tokens)
    x, page_row = inp["x"], inp["page_row"]
    seg_a = jtpk.build_prefill_attn_segment(c["jplan"], interpret=True)
    layer = 1
    for r in range(N):
        pk = jax.tree.map(lambda a: a[r], c["jpacked"])
        before = pool_shard(c["pools"], r, N, 2, "int8")
        o_j, _ = seg_a(layer, jnp.asarray(x), inp["cos"], inp["sin"],
                       jnp.asarray(page_row), jnp.int32(n_tokens), pk,
                       *[jnp.asarray(p) for p in before])
        o_j = np.asarray(o_j)[:n_tokens]
        args = (torch.from_numpy(page_row), inp["n"], port_cache(before, ps))
        got = _chunked_block(plan, c["packs"][r], layer,
                             torch.from_numpy(x.copy()), inp["tcos"],
                             inp["tsin"], *args, C,
                             one_pass).numpy()[:n_tokens]
        plain = ttpk.prefill_attn_segment_ref(
            plan, c["packs"][r], layer, torch.from_numpy(x.copy()),
            inp["tcos"], inp["tsin"], torch.from_numpy(page_row), inp["n"],
            port_cache(before, ps), bf16_scores=True).numpy()[:n_tokens]
        assert np.isfinite(got).all()
        for ref, what in ((plain, "plain"), (o_j, "jax")):
            err = np.abs(got - ref).max()
            assert err <= LOGITS_RTOL * np.abs(ref).max(), (what, r, err)
