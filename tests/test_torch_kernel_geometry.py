"""The redesigned paged_attention and grouped_quant_matmul kernels' host-side
geometry and decomposition, on the CPU (no card here):

* `paged_attention_chunked` (here), the kernel's order (chunks of whole
  tiles, an online softmax per warp step, warps merged, then chunks
  merged; with `split_p`, P entering the V product as bf16 hi + lo parts),
  against the Pallas kernel in interpret mode on the same numpy inputs;
* the grouped GEMM's decomposition (blocks of <= 32 rows of an M tile,
  64-row K chunks, u4 levels as 128 + n with 128 * sum(x) taken off in
  each group's affine, rows past the tile's real rows 0) against the Pallas
  `_gkernel` in interpret mode;
* the wrappers' geometry as pure functions at the served shapes (paged
  attention's tile and chunk count, the grouped GEMM's block shape), and
  its agreement with the constants of the CUDA sources;
* the wrappers' refusal rules, which run before anything touches a card.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashinfer_tpu.config import CacheMode as JMode
from dashinfer_tpu.ops.pallas import grouped_quant_matmul as jgqm
from dashinfer_tpu.ops.pallas import paged_attention as jpa
from dashinfer_tpu.runtime.kv_cache import KVCache as JCache
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.ops import grouped_quant_matmul as tgqm
from dashinfer_tpu_torch.ops import paged_attention as tpa
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.runtime.kv_cache import KVCache as TCache
from tests.test_grouped_quant_matmul import _quant_expert_stack

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dashinfer_tpu_torch", "csrc")

# ---------------------------------------------------------------------------
# paged attention in the kernel's order
# ---------------------------------------------------------------------------

KH, PS, D, MAXP = 2, 16, 16, 6
P = 48
LENS = np.asarray([0, 1, PS - 1, PS, PS + 1, MAXP * PS], np.int32)


def _pools(mode: str, seed: int):
    """Random pools in the JAX package's layout (qparams' lane dim padded to
    128) and the port's view of the same numbers (lanes [:ps])."""
    rng = np.random.RandomState(seed)
    if mode == "default":
        k = rng.randn(P, PS, KH * D).astype(np.float32)
        v = rng.randn(P, PS, KH * D).astype(np.float32)
        kq = vq = None
    else:
        lo, hi, dt, ds = ((-128, 128, np.int8, D) if mode == "int8"
                          else (0, 256, np.uint8, D // 2))
        k = rng.randint(lo, hi, (P, PS, KH * ds)).astype(dt)
        v = rng.randint(lo, hi, (P, PS, KH * ds)).astype(dt)
        kq = (rng.rand(P, 2 * KH, 128) * 0.05).astype(np.float32)
        vq = (rng.rand(P, 2 * KH, 128) * 0.05).astype(np.float32)
    jc = JCache(*(None if a is None else jnp.asarray(a)
                  for a in (k, v, kq, vq)))
    tc = TCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                *(None if a is None else torch.from_numpy(a[..., :PS].copy())
                  for a in (kq, vq)))
    return jc, tc


def paged_attention_chunked(q: torch.Tensor, cache: TCache, mode: TMode,
                            page_tables: torch.Tensor, lens: torch.Tensor,
                            scale: float, chunk_tokens: int, tile: int = 64,
                            warps: int = 4, split_p: bool = False
                            ) -> torch.Tensor:
    """The kernel's order on the CPU: the sequence cut into
    chunks of `chunk_tokens` (a multiple of `tile`); in a chunk, warp w
    takes tokens [w * step, (w + 1) * step) of every tile (step = tile /
    warps) and keeps an online softmax in the log2 domain, rescaled once a
    step; the warps' (max, sum, acc) merge, then the chunks' (a chunk past
    lens[b] has none). Tokens past lens are masked by select and their V
    rows are 0. With `split_p`, P (folded with the V scale) enters the V
    product as bf16 hi + lo parts, as on the tensor-core path. Same
    contract as `tpa.paged_attention_plain`; f32 sums."""
    B, H, D = q.shape
    KH = tpa._kv_heads(cache, D)
    G = H // KH
    ps = cache.page_size
    S = page_tables.shape[1] * ps
    n_ch = -(-S // chunk_tokens)
    Sp = n_ch * chunk_tokens
    step = tile // warps
    idx = page_tables.long().clamp(0, cache.num_pages - 1)

    def levels(pool):            # -> [B, KH, S, D] payload levels, f32
        x = pool[idx].reshape(B, S, KH, -1).permute(0, 2, 1, 3)
        if mode == TMode.UINT4:
            xi = x.to(torch.int32)
            x = torch.cat([xi & 0xF, (xi >> 4) & 0xF], dim=-1)
        return x.float()

    def qparams(qp):             # -> scale, zero [B, KH, S]
        r = qp[idx][..., :ps].permute(0, 2, 1, 3).reshape(B, 2 * KH, S)
        return r[:, 0::2], r[:, 1::2]

    qf = q.float().reshape(B, KH, G, D)
    k_lev, v_lev = levels(cache.k), levels(cache.v)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_lev)
    if mode != TMode.DEFAULT:
        k_scale, k_zero = qparams(cache.k_qparams)
        v_scale, v_zero = qparams(cache.v_qparams)
        s = s * k_scale[:, :, None] + qf.sum(-1, keepdim=True) * \
            k_zero[:, :, None]
    else:
        v_scale = torch.ones((B, KH, S), device=q.device)
        v_zero = torch.zeros((B, KH, S), device=q.device)
    s = s * (scale * np.log2(np.e))
    pad = Sp - S
    s = torch.nn.functional.pad(s, (0, pad))
    v_lev = torch.nn.functional.pad(v_lev, (0, 0, 0, pad))
    v_scale = torch.nn.functional.pad(v_scale, (0, pad))
    v_zero = torch.nn.functional.pad(v_zero, (0, pad))
    ninf = torch.tensor(float("-inf"), device=q.device)

    def merge(states):           # [(m, l, acc)] -> (m, l, acc)
        m = torch.stack([st[0] for st in states]).amax(0)
        mu = torch.where(m == ninf, 0.0, m)
        f = [torch.exp2(st[0] - mu) for st in states]
        return (m, sum(st[1] * fi for st, fi in zip(states, f)),
                sum(st[2] * fi[..., None] for st, fi in zip(states, f)))

    out = torch.zeros((B, KH, G, D), device=q.device)
    for b in range(B):
        L = int(lens[b])
        chunks = []
        for c in range(n_ch):
            t0, t1 = c * chunk_tokens, min(L, (c + 1) * chunk_tokens)
            if t0 >= t1:
                continue
            states = []
            for w in range(warps):
                m = torch.full((KH, G), float("-inf"), device=q.device)
                l = torch.zeros((KH, G), device=q.device)
                z = torch.zeros((KH, G), device=q.device)
                acc = torch.zeros((KH, G, D), device=q.device)
                for a in range(t0 + w * step, t1, tile):
                    tok = torch.arange(a, a + step, device=q.device)
                    sv = torch.where(tok < t1, s[b, :, :, a:a + step], ninf)
                    m_new = torch.maximum(m, sv.amax(-1))
                    mu = torch.where(m_new == ninf, 0.0, m_new)
                    alpha = torch.exp2(m - mu)
                    p = torch.exp2(sv - mu[..., None])
                    pv = p * v_scale[b, :, None, a:a + step]
                    if split_p:
                        hi = pv.to(torch.bfloat16).float()
                        pv = hi + (pv - hi).to(torch.bfloat16).float()
                    vrow = torch.where((tok < t1)[:, None],
                                       v_lev[b, :, a:a + step], 0.0)
                    l = l * alpha + p.sum(-1)
                    z = z * alpha + (p * v_zero[b, :, None, a:a + step]
                                     ).sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "hgs,hsd->hgd", pv, vrow)
                    m = m_new
                states.append((m, l, acc + z[..., None]))
            chunks.append(merge(states))
        if chunks:
            _, l, acc = merge(chunks)
            out[b] = torch.where(l[..., None] > 0,
                                 acc / torch.where(l > 0, l, 1.0)[..., None],
                                 0.0)
    return out.reshape(B, H, D).to(q.dtype)


# Tolerance: the chunked order against the interpret-mode kernel differs in
# the order of f32 sums: |d| <= 1e-5 * max|ref|. With split_p the V product
# takes P * v_scale as bf16 hi + lo parts, which keep >= 16 bits of each
# term: 1e-5 + 2^-15 of max|ref|.
ORDER_RTOL, SPLIT_RTOL = 1e-5, 2.0 ** -15


@pytest.mark.parametrize("mode", ["default", "int8", "uint4"])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("chunk_pages", [1, 3])
def test_chunked_order_matches_pallas_interpret(mode, G, chunk_pages):
    """Chunks of 1 and 3 pages (tiles of one page, 4 warps of 4 tokens),
    lens 0 / 1 / ps-1 / ps / ps+1 / a full table, G = 1 and 7, every KV
    mode: the kernel's order of the online softmax and the merges against
    the Pallas kernel in interpret mode; lens 0 gives 0."""
    jc, tc = _pools(mode, seed=31 + G)
    rng = np.random.RandomState(41 + G)
    pt = rng.permutation(P)[:len(LENS) * MAXP].reshape(len(LENS), MAXP) \
        .astype(np.int32)
    q = rng.randn(len(LENS), KH * G, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jc, JMode(mode), jnp.asarray(pt), jnp.asarray(LENS),
        scale, interpret=True))
    args = (torch.from_numpy(q), tc, TMode(mode), torch.from_numpy(pt),
            torch.from_numpy(LENS), scale)
    for split_p, rtol in ((False, ORDER_RTOL),
                          (True, ORDER_RTOL + SPLIT_RTOL)):
        got = paged_attention_chunked(
            *args, chunk_tokens=chunk_pages * PS, tile=PS, warps=4,
            split_p=split_p).numpy()
        assert np.abs(got - want).max() <= rtol * np.abs(want).max()
        assert np.all(got[LENS == 0] == 0.0)


def test_plain_ignores_nan_garbage_past_lens():
    """A float pool may hold NaN past lens (and in pages no slot owns); the
    plain version, like the kernel, reads only what tokens < lens own: the
    same result as with the garbage zeroed, and finite."""
    _, tc = _pools("default", seed=5)
    _, tq = _pools("int8", seed=5)
    rng = np.random.RandomState(6)
    pt = torch.from_numpy(rng.permutation(P)[:len(LENS) * MAXP]
                          .reshape(len(LENS), MAXP).astype(np.int32))
    lens = torch.from_numpy(LENS)
    q = torch.from_numpy(rng.randn(len(LENS), KH * 7, D).astype(np.float32))
    for cache, mode in ((tc, TMode.DEFAULT), (tq, TMode.INT8)):
        owned = torch.zeros((P, PS), dtype=torch.bool)
        for b, n in enumerate(LENS.tolist()):
            for j in range(-(-n // PS)):
                owned[pt[b, j], :min(PS, n - j * PS)] = True
        clean = tpa.paged_attention_plain(q, cache, mode, pt, lens, 0.25)
        if mode == TMode.DEFAULT:
            for t in (cache.k, cache.v):
                t.masked_fill_(~owned[:, :, None], float("nan"))
        else:
            for t in (cache.k_qparams, cache.v_qparams):
                t.masked_fill_(~owned[:, None, :], float("nan"))
        dirty = tpa.paged_attention_plain(q, cache, mode, pt, lens, 0.25)
        assert torch.isfinite(dirty).all()
        torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the grouped GEMM's decomposition
# ---------------------------------------------------------------------------

def _grouped_decomposed(xs, tile_expert, tile_rows, leaf, rows_blk=32,
                        chunk=64):
    """The CUDA kernel's decomposition in f32: per (M tile, block of <= 32
    rows), 64-row K chunks of bf16(x) . levels (u4 as 128 + n), and at a
    quant group's end acc += (part - off * xsum) * scale + xsum * zero;
    rows past the tile's real rows 0. Returns [Mcap, N] f32."""
    Mcap, K = xs.shape
    TM = Mcap // tile_expert.shape[0]
    scale, zero = leaf["scale"].float(), leaf["zero"].float()
    E, G, N = scale.shape
    bits = 8 if leaf["w_q"].dtype == torch.int8 else 4
    off = 128.0 if bits == 4 else 0.0
    cpg = K // G // chunk
    out = torch.zeros((Mcap, N))
    xb = xs.to(torch.bfloat16).float()
    for m in range(tile_expert.shape[0]):
        e = int(tile_expert[m])
        lev = weight_levels(leaf["w_q"][e]).float() + off      # [K, N]
        real = TM if tile_rows is None else min(int(tile_rows[m]), TM)
        for r0 in range(0, TM, rows_blk):
            n = max(0, min(real - r0, rows_blk))
            if n == 0:
                continue
            x = xb[m * TM + r0:m * TM + r0 + n]
            acc = torch.zeros((n, N))
            part = torch.zeros((n, N))
            xsum = torch.zeros((n, 1))
            for c in range(K // chunk):
                ks = slice(c * chunk, (c + 1) * chunk)
                part += x[:, ks] @ lev[ks]
                xsum += x[:, ks].sum(-1, keepdim=True)
                if (c + 1) % cpg == 0:
                    g = c // cpg
                    acc += (part - off * xsum) * scale[e, g] + \
                        xsum * zero[e, g]
                    part.zero_()
                    xsum.zero_()
            out[m * TM + r0:m * TM + r0 + n] = acc
    return out


@pytest.mark.parametrize("bits,N,gs,TM", [
    (4, 512, 64, 64),        # u4 TILE-128, tiles of two row blocks
    (4, 256, 128, 16),
    (8, 256, 64, 32),        # int8
])
def test_grouped_decomposition_matches_pallas_interpret(bits, N, gs, TM):
    """The kernel's decomposition (row blocks, K chunks, the u4 offset taken
    off per group, padded rows written 0) against the Pallas `_gkernel` in
    interpret mode, at a routing where some tiles hold more than 32 rows,
    some few and some none. Tolerance: f32 sums in another order, and the
    plain version's check: |d| <= 1e-3 * max|ref| + 2^-8 |ref| on bf16."""
    rng = np.random.default_rng(7 + bits)
    E, K, ktop = 5, 256, 2
    T = 48
    leaf_np = {k: v[0] for k, v in
               _quant_expert_stack(rng, 1, E, K, N, bits, gs).items()}
    # expert 0 takes most rows (> 32 in a tile at TM = 64), 4 takes none
    topk = np.stack([np.asarray([0, 1 + (t % 3)]) if t % 4 else
                     np.asarray([0, 2]) for t in range(T)]).astype(np.int32)
    # bf16-exact rows, as the kernel receives them (the Pallas kernel sums
    # the f32 x for its zero term)
    x = torch.from_numpy(rng.standard_normal((T, K), dtype=np.float32) *
                         0.5).to(torch.bfloat16).float().numpy()
    order, stok, pos, te = jgqm.build_group_layout(jnp.asarray(topk), E, TM)
    Mcap = int(te.shape[0]) * TM
    xs = np.zeros((Mcap, K), np.float32)
    xs[np.asarray(pos)] = x[np.asarray(stok)]
    jleaf = {k: jnp.asarray(v) for k, v in leaf_np.items()}
    want = np.asarray(jgqm.grouped_quant_matmul(
        jnp.asarray(xs), te, jleaf, out_dtype=jnp.float32, interpret=True))
    tleaf = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in leaf_np.items()}
    te_t = torch.from_numpy(np.array(te))
    rows = tgqm.tile_row_counts(torch.from_numpy(np.array(pos)),
                                te_t.shape[0], TM)
    assert int(rows.max()) > (32 if TM == 64 else 0)
    got = _grouped_decomposed(torch.from_numpy(xs), te_t, rows, tleaf)
    got = got.to(torch.bfloat16).float().numpy()
    assert np.all(np.abs(got - want) <=
                  1e-3 * np.abs(want).max() + 2.0 ** -8 * np.abs(want))
    pad = np.ones(Mcap, bool)
    pad[np.asarray(pos)] = False
    assert not got[pad].any()


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

SM_H100 = 132


@pytest.mark.parametrize("B,KH,maxP,want", [
    (8, 4, 32, (256, 8)),       # Qwen2-7B, B = 8, the check pool's table
    (8, 16, 32, (1024, 2)),     # Qwen1.5-MoE (16 KV heads)
    (32, 4, 32, (1024, 2)),     # Qwen2-7B at B = 32
    (40, 16, 32, (2048, 1)),    # pairs fill the card: one chunk
    (1, 1, 1, (128, 1)),
])
def test_chunk_geometry_at_served_shapes(B, KH, maxP, want):
    """INT8 KV at D = 128 (tiles of 128 tokens), pages of 64, 132 SMs."""
    tile = tpa.tile_tokens(2, 128)
    chunk_tokens, n_chunks = tpa.chunk_geometry(B, KH, maxP, 64, tile,
                                                SM_H100)
    assert (chunk_tokens, n_chunks) == want
    tokens = maxP * 64
    assert chunk_tokens % tile == 0
    assert (n_chunks - 1) * chunk_tokens < tokens <= n_chunks * chunk_tokens
    # one wave: within CHUNK_BLOCKS_PER_SM resident blocks an SM, unless
    # the (slot, head) pairs alone exceed it
    slots = tpa.CHUNK_BLOCKS_PER_SM * SM_H100
    assert B * KH * n_chunks <= max(slots, B * KH)


def test_tile_tokens_match_the_kernel():
    """16 tokens a warp (4 for an f32 pool at D = 256), 8 warps a block
    where a head row is at most 128 bytes, else 4."""
    want = {(0, 64): 64, (0, 128): 64, (0, 256): 16, (1, 64): 128,
            (1, 128): 64, (1, 256): 64, (2, 64): 128, (2, 128): 128,
            (2, 256): 64, (3, 64): 128, (3, 128): 128, (3, 256): 128}
    assert {kd: tpa.tile_tokens(*kd) for kd in want} == want
    # the tile geometry lives in the header that paged_attention.cu and the
    # decode megakernel's attention phase share
    src = open(os.path.join(CSRC, "paged_attention.cu")).read()
    assert '#include "di_attn_tile.cuh"' in src and "Geo<KIND, D>" in src
    src = open(os.path.join(CSRC, "di_attn_tile.cuh")).read()
    for line in ("kWarps = kRowBytes <= 128 ? 8 : 4;",
                 "KIND == kF32 ? (D == 256 ? 4 : (SMALL ? 8 : 16)) : 16;",
                 "kTileT = kWarpT * kWarps;"):
        assert line in src


def test_grouped_shapes_match_the_kernel():
    src = open(os.path.join(CSRC, "grouped_quant_matmul.cu")).read()
    shapes = ", ".join("{%d, %d, %d}" % s for s in tgqm.SHAPES)
    assert f"constexpr int kShapes[3][3] = {{{shapes}}};" in src
    assert "constexpr int item_bytes() { return 32 * LB; }" in src


@pytest.mark.parametrize("T,E,shape", [
    (8, 60, 0),       # per-op MoE decode at B = 8: narrow items
    (32, 60, 1),      # bucket-32 prefill: 16 rows a block
    (128, 60, 1),
    (256, 60, 2),     # 32 rows a block
    (1024, 60, 2),
])
def test_grouped_block_shape_at_served_shapes(T, E, shape):
    """Qwen1.5-MoE (top-4, TM 64): the wrapper's block shape from the
    static Mcap = rup(T * 4, 64) + E * 64."""
    Mcap = -(-T * 4 // 64) * 64 + E * 64
    assert tgqm.block_shape(Mcap, 64, E) == shape


# ---------------------------------------------------------------------------
# refusal rules
# ---------------------------------------------------------------------------

def _pa_operands(mode="int8", H=4, KHh=2, Dh=128, ps=16):
    kind = {"default": torch.bfloat16, "int8": torch.int8,
            "uint4": torch.uint8}[mode]
    ds = Dh // 2 if mode == "uint4" else Dh
    k = torch.zeros((6, ps, KHh * ds), dtype=kind)
    v = torch.zeros_like(k)
    qp = None if mode == "default" else torch.zeros((6, 2 * KHh, ps))
    cache = TCache(k, v, qp, None if qp is None else qp.clone())
    q = torch.zeros((3, H, Dh), dtype=torch.bfloat16)
    pt = torch.zeros((3, 2), dtype=torch.int32)
    lens = torch.zeros(3, dtype=torch.int32)
    return q, cache, TMode(mode), pt, lens


def test_paged_attention_refusal_rules():
    for mode in ("default", "int8", "uint4"):
        q, cache, m, pt, lens = _pa_operands(mode)
        assert tpa.check_operands(q, cache, m, pt, lens) == (
            2, {"default": 1, "int8": 2, "uint4": 3}[mode])
    q, cache, m, pt, lens = _pa_operands()
    with pytest.raises(TypeError):       # pool kind against the mode
        tpa.check_operands(q, cache, TMode.UINT4, pt, lens)
    with pytest.raises(TypeError):       # q dtype
        tpa.check_operands(q.half(), cache, m, pt, lens)
    with pytest.raises(ValueError):      # page table dtype
        tpa.check_operands(q, cache, m, pt.long(), lens)
    with pytest.raises(ValueError):      # lens shape
        tpa.check_operands(q, cache, m, pt, lens[:2])
    with pytest.raises(ValueError):      # non-contiguous q
        tpa.check_operands(q.transpose(0, 1).contiguous().transpose(0, 1),
                           cache, m, pt, lens)
    bad = TCache(cache.k, cache.v, cache.k_qparams[:, :2], cache.v_qparams)
    with pytest.raises(ValueError):      # qparams [P, 2 KH, >= ps]
        tpa.check_operands(q, bad, m, pt, lens)
    q, cache, m, pt, lens = _pa_operands(Dh=96)
    with pytest.raises(ValueError):      # head dim
        tpa.check_operands(q, cache, m, pt, lens)
    q, cache, m, pt, lens = _pa_operands(H=18)
    with pytest.raises(ValueError):      # G = 9 > 8
        tpa.check_operands(q, cache, m, pt, lens)
    q, cache, m, pt, lens = _pa_operands()
    with pytest.raises(ValueError):      # pool row against KH and D
        tpa.check_operands(torch.zeros((3, 4, 64), dtype=torch.bfloat16),
                           TCache(cache.k[..., :64 * 2 + 8],
                                  cache.v[..., :64 * 2 + 8],
                                  cache.k_qparams, cache.v_qparams),
                           m, pt, lens)
    # a CPU tensor takes the plain version and launches nothing
    before = tpa.paged_attention.counter.read()
    tpa.paged_attention(q, cache, m, pt, lens, 0.1)
    assert tpa.paged_attention.counter.read() == before


def _gqm_operands(bits=4, N=256, gs=64, TM=16, E=3, K=128):
    w_q = (torch.zeros((E, K, N // 2), dtype=torch.uint8) if bits == 4
           else torch.zeros((E, K, N), dtype=torch.int8))
    leaf = {"w_q": w_q, "scale": torch.ones((E, K // gs, N)),
            "zero": torch.zeros((E, K // gs, N))}
    xs = torch.zeros((4 * TM, K), dtype=torch.bfloat16)
    te = torch.zeros(4, dtype=torch.int32)
    return xs, te, leaf


def test_grouped_refusal_rules():
    xs, te, leaf = _gqm_operands()
    assert tgqm.check_operands(xs, te, leaf) == (4, 16, 256, 2, 3)
    assert tgqm.check_operands(*_gqm_operands(bits=8, TM=64)) == \
        (8, 64, 256, 2, 3)
    with pytest.raises(TypeError):       # f32 xs
        tgqm.check_operands(xs.float(), te, leaf)
    with pytest.raises(TypeError):       # f32 out
        tgqm.check_operands(xs, te, leaf, out_dtype=torch.float32)
    with pytest.raises(ValueError):      # M tile 8
        tgqm.check_operands(*_gqm_operands(TM=8))
    with pytest.raises(ValueError):      # N % 256
        tgqm.check_operands(*_gqm_operands(bits=8, N=384))
    with pytest.raises(ValueError):      # quant group 32
        tgqm.check_operands(*_gqm_operands(gs=32))
    with pytest.raises(ValueError):      # tile_rows dtype
        tgqm.check_operands(xs, te, leaf, tile_rows=te.long())
    with pytest.raises(ValueError):      # tile_expert shape
        tgqm.check_operands(xs, te[:3], leaf)
    bad = dict(leaf, w_q=leaf["w_q"][:, :64])
    with pytest.raises(ValueError):      # payload against K
        tgqm.check_operands(xs, te, bad)
    bad = dict(leaf, scale=leaf["scale"].double())
    with pytest.raises(ValueError):      # f32 qparams
        tgqm.check_operands(xs, te, bad)
    with pytest.raises(ValueError):      # non-contiguous xs
        tgqm.check_operands(torch.zeros((128, 64), dtype=torch.bfloat16).t(),
                            te, leaf)
