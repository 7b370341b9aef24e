"""The redesigned decode megakernel's geometry and decomposition, on the CPU
(no card here):

* a numpy model of its product phase with the operands swapped: the bytes
  `pack_payload` lays out, read as the mma's A fragments (the warp's 16
  columns of a tile half), and the x records, read as its B fragments (n8
  tiles of batch rows), through the m16n8k16 fragment definitions, with
  the per-group affine from the record's row sums and the staged qparams,
  give x . W as `decode_megakernel_ref`'s product does, for every weight
  kind, at B = 1 .. 20;
* the attention phase's chunk geometry (`attention_chunks`) at the served
  (B, KV heads, lengths), G = 1 at B = 32 included;
* the attention phase's decomposition (chunks of whole tiles, 16 tokens a
  warp with one online-softmax rescale a step, P in three bf16 parts on the
  tensor-core kinds, the new token folded into chunk 0, the chunks merged
  as the merge phase merges them) as the plain version's attention, against
  the Pallas kernel in interpret mode.
"""

import math

import numpy as np
import pytest
import torch

from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops.u4pack import weight_levels

# ---------------------------------------------------------------------------
# the product phase with the weights as the A operand
# ---------------------------------------------------------------------------

GID = np.arange(32) >> 2          # lane -> gid
TIG = np.arange(32) & 3           # lane -> tig


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)


def _bits_f32(h: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> f32 values."""
    return (h.astype(np.uint32) << 16).view(np.float32)


def _halves(word: np.ndarray):
    """A 32-bit register of two bf16 -> (low value, high value) in f32."""
    word = word.astype(np.uint32)
    return _bits_f32(word & 0xFFFF), _bits_f32(word >> 16)


def frag_a(regs: np.ndarray) -> np.ndarray:
    """[32 lanes][a0 a1 a2 a3] -> the 16 x 16 A of mma.m16n8k16 (row):
    a0 = A[gid][2tig..+1], a1 = A[gid+8][2tig..], a2 = A[gid][2tig+8..],
    a3 = A[gid+8][2tig+8..] (lower k in the low half)."""
    A = np.zeros((16, 16), np.float32)
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = _halves(regs[:, r])
        A[GID + dr, 2 * TIG + dk] = lo
        A[GID + dr, 2 * TIG + dk + 1] = hi
    return A


def frag_b(b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """b0 = B[2tig..+1][gid], b1 = B[2tig+8..+9][gid] -> the 16 x 8 B."""
    B = np.zeros((16, 8), np.float32)
    for reg, dk in ((b0, 0), (b1, 8)):
        lo, hi = _halves(reg)
        B[2 * TIG + dk, GID] = lo
        B[2 * TIG + dk + 1, GID] = hi
    return B


def frag_c(D: np.ndarray) -> np.ndarray:
    """The 16 x 8 accumulator as the lanes hold it: [32][c0 c1 c2 c3] =
    D[gid][2tig], D[gid][2tig+1], D[gid+8][2tig], D[gid+8][2tig+1]."""
    return np.stack([D[GID, 2 * TIG], D[GID, 2 * TIG + 1],
                     D[GID + 8, 2 * TIG], D[GID + 8, 2 * TIG + 1]], 1)


def records(x: np.ndarray, mpad: int) -> np.ndarray:
    """x [B, K] f32 -> the x records (csrc/di_product.cuh `write_record`):
    [K / 64][mpad * 132] bytes, the bf16 fragments then the f32 row sums
    of the bf16 values."""
    B, K = x.shape
    rb = mpad * 132
    rec = np.zeros((K // 64, rb), np.uint8)
    xb = _bf16_bits(x)
    for c in range(K // 64):
        words = rec[c, :mpad * 128].view(np.uint16)
        sums = rec[c, mpad * 128:].view(np.float32)
        for m in range(B):
            for lane in range(32):
                k0 = 2 * lane
                s, kk = k0 >> 4, k0 & 15
                tig, khalf = (kk & 7) >> 1, kk >> 3
                mt, gid, rhalf = m >> 4, m & 7, (m >> 3) & 1
                off = ((mt * 4 + s) * 32 + gid * 4 + tig) * 16 + \
                    (rhalf + 2 * khalf) * 4
                words[off // 2] = xb[m, 64 * c + k0]
                words[off // 2 + 1] = xb[m, 64 * c + k0 + 1]
            sums[m] = _bits_f32(xb[m, 64 * c:64 * (c + 1)]).sum(
                dtype=np.float32)
    return rec


def _i8x2(w: np.ndarray) -> np.ndarray:
    """two int8 in the low 16 bits -> two bf16 (exact)."""
    lo = ((w & 0xFF).astype(np.uint8)).view(np.int8).astype(np.float32)
    hi = (((w >> 8) & 0xFF).astype(np.uint8)).view(np.int8).astype(
        np.float32)
    return _bf16_bits(lo).astype(np.uint32) | \
        (_bf16_bits(hi).astype(np.uint32) << 16)


def _u4x2(w: np.ndarray):
    """two u4 bytes in the low 16 bits -> bf16(128 + low nibbles),
    bf16(128 + high nibbles): 0x4300 | n is 128 + n."""
    pair = (w & 0xFF) | (((w >> 8) & 0xFF) << 16)
    return (pair & 0x000F000F) | 0x43004300, \
        ((pair >> 4) & 0x000F000F) | 0x43004300


def payload_frags(chunk: np.ndarray, bits: int, warp: int, s: int):
    """The lanes' payload registers of k16 step s of warp `warp` in one
    packed chunk, as product_phase reads them -> (lo, hi), each [32][nt][i]
    (uint32): the B-operand layout of the pack."""
    quarters = {4: 2, 8: 4, 16: 8}[bits]
    q = {4: s >> 1, 8: s, 16: 2 * s}[bits]
    base = warp * quarters * 512

    def words(qq):
        return chunk[base + qq * 512:base + qq * 512 + 512].view(
            np.uint32).reshape(32, 4).astype(np.uint64).astype(np.uint32)

    lo = np.zeros((32, 2, 2), np.uint32)
    hi = np.zeros((32, 2, 2), np.uint32)
    if bits == 4:
        v = words(q)
        w0 = v[:, 2] if s & 1 else v[:, 0]
        w1 = v[:, 3] if s & 1 else v[:, 1]
        lo[:, 0, 0], hi[:, 0, 0] = _u4x2(w0)
        lo[:, 0, 1], hi[:, 0, 1] = _u4x2(w0 >> 16)
        lo[:, 1, 0], hi[:, 1, 0] = _u4x2(w1)
        lo[:, 1, 1], hi[:, 1, 1] = _u4x2(w1 >> 16)
    elif bits == 8:
        v = words(q)
        for nt in range(2):
            for i in range(2):
                lo[:, nt, i] = _i8x2(v[:, nt * 2 + i])
                hi[:, nt, i] = _i8x2(v[:, nt * 2 + i] >> 16)
    else:
        for nt in range(2):
            v = words(q + nt)
            lo[:, nt, 0], hi[:, nt, 0] = v[:, 0], v[:, 1]
            lo[:, nt, 1], hi[:, nt, 1] = v[:, 2], v[:, 3]
    return lo, hi


def product_model(x: np.ndarray, leaf, bits: int, mpad: int) -> np.ndarray:
    """csrc/di_product.cuh `product_phase` on one leaf with one K split, in
    numpy: out [B, N] f32."""
    B, K = x.shape
    MT = 1 if mpad == 16 else 2
    kNT = 2 * MT
    w_f = leaf["w_f"]                                # [T, C, chunk] packed
    if bits == 16:
        w_f = w_f.view(torch.int16)
    w_f = np.ascontiguousarray(w_f.numpy()).view(np.uint8)
    T, C = w_f.shape[:2]
    rec = records(x, mpad)
    G = 1 if bits == 16 else leaf["scale"].shape[0]
    cpg = C // G
    off = 128.0 if bits == 4 else 0.0
    out = np.zeros((B, T * 256), np.float32)
    live = min(kNT, (B + 7) >> 3)
    for t in range(T):
        for w in range(8):
            acc = np.zeros((2, kNT, 32, 4), np.float32)
            part = np.zeros_like(acc)
            xs = np.zeros((kNT, 32, 2), np.float32)
            for c in range(C):
                sums = rec[c, mpad * 128:].view(np.float32)
                for r in range(kNT):
                    xs[r, :, 0] += sums[8 * r + 2 * TIG]
                    xs[r, :, 1] += sums[8 * r + 2 * TIG + 1]
                xw = rec[c, :mpad * 128].view(np.uint32)
                for s in range(4):
                    bx = []
                    for mt in range(MT):
                        v = xw[(mt * 4 + s) * 128:(mt * 4 + s + 1) * 128] \
                            .reshape(32, 4)
                        bx += [(v[:, 0], v[:, 2]), (v[:, 1], v[:, 3])]
                    lo, hi = payload_frags(w_f[t, c], bits, w, s)
                    alo = np.stack([lo[:, 0, 0], lo[:, 1, 0], lo[:, 0, 1],
                                    lo[:, 1, 1]], 1)
                    ahi = np.stack([hi[:, 0, 0], hi[:, 1, 0], hi[:, 0, 1],
                                    hi[:, 1, 1]], 1)
                    for r in range(live):
                        Bm = frag_b(*bx[r])
                        part[0, r] += frag_c(frag_a(alo) @ Bm)
                        part[1, r] += frag_c(frag_a(ahi) @ Bm)
                if c % cpg == cpg - 1 or c == C - 1:
                    g = c // cpg
                    for h in range(2):
                        cols = 256 * t + 128 * h + 16 * w + GID
                        if bits == 16:
                            sc = np.ones((32, 2), np.float32)
                            ze = np.zeros((32, 2), np.float32)
                        else:
                            s_ = leaf["scale"][g].to(torch.bfloat16).float()
                            z_ = leaf["zero"][g].to(torch.bfloat16).float()
                            sc = np.stack([s_[cols], s_[cols + 8]], 1)
                            ze = np.stack([z_[cols], z_[cols + 8]], 1)
                        for r in range(kNT):
                            for i in range(4):
                                x_ = xs[r, :, i & 1]
                                acc[h, r, :, i] += \
                                    (part[h, r, :, i] - off * x_) * \
                                    sc[:, i >> 1] + x_ * ze[:, i >> 1]
                    part[:] = 0.0
                    xs[:] = 0.0
            # the stores: column gid / gid + 8 of the warp's 16, batch rows
            # 2 tig / 2 tig + 1 of n8 tile r
            for h in range(2):
                for r in range(kNT):
                    for i in range(4):
                        m = 8 * r + 2 * TIG + (i & 1)
                        col = 256 * t + 128 * h + 16 * w + GID + 8 * (i >> 1)
                        ok = m < B
                        out[m[ok], col[ok]] = acc[h, r, ok, i]
    return out


def _leaf(bits: int, K: int, N: int, G: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    if bits == 16:
        return {"w": torch.randn((K, N), generator=gen) * 0.05}
    if bits == 4:
        w_q = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8,
                            generator=gen)
    else:
        w_q = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                            generator=gen)
    return {"w_q": w_q, "scale": torch.rand((G, N), generator=gen) * 0.02,
            "zero": torch.randn((G, N), generator=gen) * 0.05}


@pytest.mark.parametrize("bits,G,B", [
    (4, 2, 8),        # u4 group 128 (two chunks a group), the served B
    (4, 2, 1),        # one live row
    (4, 4, 13),       # group 64, both n8 tiles of mpad 16
    (4, 2, 20),       # mpad 32: two m16 tiles of records, four n8 tiles
    (8, 1, 8),        # int8 per channel (the u4 -> i8 stream rule)
    (8, 2, 5),        # int8 group-wise
    (16, 1, 8),       # bf16 (the MoE router)
])
def test_weights_as_a_operand_give_the_plain_product(bits, G, B):
    """The pack's bytes as A fragments and the x records as B fragments,
    through the mma fragment definitions and the kernel's affine and store
    indices, compute the plain version's x . W (f32 sums in another
    order)."""
    K, N = 256, 512
    leaf = _leaf(bits, K, N, G, seed=bits * 100 + B)
    packed = tmk.packed_leaf(leaf)
    rng = np.random.RandomState(B)
    x = rng.randn(B, K).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = tmk.leaf_dot(xb, packed).numpy()
    got = product_model(x, packed, bits, tmk.padded_rows(B))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the attention phase's chunks
# ---------------------------------------------------------------------------

SERVED = [
    # B, KH, max tokens, grid, lens
    (8, 4, 2048, 264, [37, 64, 150, 300, 1, 127, 256, 500]),
    (8, 4, 2048, 264, [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]),
    (32, 4, 2048, 132, [(37 + 61 * i) % 1500 + 1 for i in range(32)]),
    (1, 4, 2048, 264, [700]),
    (8, 16, 2048, 264, [37, 64, 150, 300, 1, 127, 256, 500]),   # G = 1
    (32, 16, 2048, 132, [(37 + 61 * i) % 1500 + 1 for i in range(32)]),
    (8, 2, 2048, 264, [37, 64, 150, 300, 1, 127, 256, 500]),    # TP n = 2
    (8, 1, 2048, 264, [37, 64, 150, 300, 1, 127, 256, 500]),    # TP n = 4
]


@pytest.mark.parametrize("B,KH,tokens,grid,lens", SERVED)
def test_attention_chunks_at_served_shapes(B, KH, tokens, grid, lens):
    nc, ct = tmk.attention_chunks(B, KH, tokens, grid)
    assert ct % tmk.ATT_TILE == 0 and ct >= tmk.ATT_TILE
    assert 1 <= nc <= tmk.MAX_ATT_CHUNKS
    assert (nc - 1) * ct < tokens <= nc * ct      # the table, no empty tail
    # each slot's chunks: every one holding tokens has at least one tile,
    # and the slot's last token falls in a chunk the table has
    for n in lens:
        used = max(1, -(-n // ct))
        assert used <= nc
        assert all(j * ct < n for j in range(1, used))
    # about two items a block where the (slot, head) pairs leave room
    items = B * KH * nc
    assert items <= max(2 * grid + B * KH, B * KH)


def test_attention_chunks_at_b32_g1_cover_a_whole_sequence():
    """Qwen1.5-MoE at B = 32: 512 (slot, KV head) pairs over 132 blocks
    leave one chunk a pair, the whole page table in whole tiles."""
    assert tmk.attention_chunks(32, 16, 2048, 132) == (1, 2048)
    assert tmk.attention_chunks(8, 4, 2048, 264) == (16, 128)
    assert tmk.attention_chunks(32, 4, 2048, 132) == (3, 768)
    assert tmk.attention_chunks(8, 16, 2048, 264) == (4, 512)


# ---------------------------------------------------------------------------
# the attention phase's order of sums, against the Pallas kernel
# ---------------------------------------------------------------------------

def attention_chunked(plan, q, k_new, v_new, cache, phys, len_eff, scale,
                      slopes=None, chunk_tokens=32, warp_tokens=16,
                      p_terms=None):
    """The megakernel attention phase's order on the CPU (the signature of
    `megakernel._attend_ref`): a slot's tokens cut into chunks of
    `chunk_tokens`; in a chunk, runs of `warp_tokens` (a warp's share of a
    tile) each keep an online softmax, rescaled once a
    run; the runs merge with the new token (its unquantized f32 K / V) in
    chunk 0; then the chunks merge as the merge phase does (natural
    exponentials, as the megakernel's softmax). Tokens past
    lens are masked by select. On the tensor-core kinds (a quantized or
    bf16 pool) P, folded with the V scale, enters the V product as
    `p_terms` bf16 parts (the kernel's three by default; None: f32).
    Inactive slots (len 0 here) still attend the new token, as the plain
    version does. `slopes` (ALiBi): the plain version's bias, one origin
    (the slot's new token) for every chunk. f32 sums."""
    B, KH, G, D = q.shape[0], plan.KH, plan.G, plan.D
    ps = plan.ps
    S = plan.maxP * ps
    mode = plan.kv_mode
    if p_terms is None and (mode != TMode.DEFAULT or
                            cache.k.dtype == torch.bfloat16):
        p_terms = 3
    idx = phys.long().clamp(0, cache.num_pages - 1)
    qf = q.reshape(B, KH, G, D).float()

    def levels(pool):
        x = pool[idx].reshape(B, S, KH, -1).permute(0, 2, 1, 3)
        if mode == TMode.UINT4:
            xi = x.to(torch.int32)
            x = torch.cat([xi & 0xF, (xi >> 4) & 0xF], dim=-1)
        return x.float()

    def qparams(qp):
        r = qp[idx][..., :ps].permute(0, 2, 1, 3).reshape(B, 2 * KH, S)
        return r[:, 0::2], r[:, 1::2]

    k_lev, v_lev = levels(cache.k), levels(cache.v)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_lev)
    if mode != TMode.DEFAULT:
        ks, kz = qparams(cache.k_qparams)
        vs, vz = qparams(cache.v_qparams)
        s = s * ks[:, :, None] + qf.sum(-1, keepdim=True) * kz[:, :, None]
    else:
        vs = torch.ones((B, KH, S))
        vz = torch.zeros((B, KH, S))
    s = s * scale
    if slopes is not None:
        s = s + tmk.alibi_bias(plan, slopes, torch.arange(S), len_eff)
    valid = torch.arange(S)[None, :] < len_eff[:, None]          # [B, S]
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    v_lev = torch.where(valid[:, None, :, None], v_lev, 0.0)
    vs = torch.where(valid[:, None, :], vs, 0.0)
    vz = torch.where(valid[:, None, :], vz, 0.0)
    s_new = torch.einsum("bhgd,bhd->bhg", qf, k_new.float()) * scale

    def bf(t):
        return t.to(torch.bfloat16).float()

    out = torch.zeros((B, KH, G, D))
    for b in range(B):
        n = int(len_eff[b])
        used = max(1, -(-n // chunk_tokens))
        chunks = []                                   # (m, l, acc) each
        for j in range(used):
            t0 = j * chunk_tokens
            states = []
            for r0 in range(t0, t0 + chunk_tokens, warp_tokens):
                if r0 >= max(n, 1) and r0 > t0:
                    break
                m = torch.full((KH, G), -math.inf)
                sv = s[b, :, :, r0:r0 + warp_tokens]
                mt = torch.maximum(m, sv.max(-1).values)
                mu = torch.where(torch.isinf(mt), 0.0, mt)
                p = torch.exp(sv - mu[..., None])
                pv = p * vs[b, :, None, r0:r0 + warp_tokens]
                vrow = v_lev[b, :, r0:r0 + warp_tokens]
                if p_terms:
                    acc = 0.0
                    for _ in range(p_terms):
                        acc = acc + torch.einsum("hgs,hsd->hgd", bf(pv),
                                                 vrow)
                        pv = pv - bf(pv)
                else:
                    acc = torch.einsum("hgs,hsd->hgd", pv, vrow)
                z = (p * vz[b, :, None, r0:r0 + warp_tokens]).sum(-1)
                states.append((mt, p.sum(-1), acc + z[..., None]))
            if j == 0:
                states.append((s_new[b], torch.ones((KH, G)),
                               v_new[b, :, None, :].float().expand(KH, G, D)))
            mx = torch.stack([st[0] for st in states]).max(0).values
            mu = torch.where(torch.isinf(mx), 0.0, mx)
            f = [torch.exp(st[0] - mu) for st in states]
            chunks.append((mx, sum(fi * st[1] for fi, st in zip(f, states)),
                           sum(fi[..., None] * st[2]
                               for fi, st in zip(f, states))))
        mx = torch.stack([c[0] for c in chunks]).max(0).values
        mu = torch.where(torch.isinf(mx), 0.0, mx)
        f = [torch.exp(c[0] - mu) for c in chunks]
        lsum = sum(fi * c[1] for fi, c in zip(f, chunks))
        o = sum(fi[..., None] * c[2] for fi, c in zip(f, chunks))
        out[b] = o / torch.where(lsum == 0, 1.0, lsum)[..., None]
    return out.reshape(B, KH * G * D)


@pytest.mark.parametrize("quant,mode,chunk", [
    ("none", "default", 32),      # an f32 pool: the CUDA-core path
    ("none", "int8", 32),
    ("a16w4", "int8", 16),        # one warp run a chunk
    ("a16w8", "uint4", 64),       # the whole table in one chunk
])
def test_attention_order_matches_pallas_interpret(monkeypatch, quant, mode,
                                                  chunk):
    """The plain decode step with its attention in the kernel's order holds
    to the interpret-mode TPU kernel at the plain version's own tolerances
    (tests/test_torch_megakernel.py); lens 17, 16, 5 cross chunk and run
    borders at chunks of 16 .. 64 tokens."""
    from tests.test_megakernel import _quantized_fixture
    from tests.test_torch_megakernel import _check_against_pallas
    import dataclasses
    from dashinfer_tpu.config import CacheMode as JMode
    kh = 2 if mode == "uint4" else 1
    cfg, rt, params = _quantized_fixture(quant, False, False, 16, kh)
    rt = dataclasses.replace(
        rt, cache=dataclasses.replace(rt.cache, mode=JMode(mode)))
    calls = []

    def chunked(*args):
        calls.append(1)
        return attention_chunked(*args, chunk_tokens=chunk,
                                 warp_tokens=min(16, chunk))

    monkeypatch.setattr(tmk, "_attend_ref", chunked)
    _check_against_pallas(cfg, rt, params, mode, np.asarray([17, 16, 5, 0]),
                          np.asarray([1, 1, 1, 0]), np.asarray([7, 11, 13, 0]))
    assert len(calls) == cfg.num_layers


def test_attention_order_equals_one_softmax():
    """On one random state the chunked order and the plain version's single
    softmax agree to f32 rounding (and the hi + lo split of P to ~2^-16)."""
    from dashinfer_tpu_torch.config import CacheConfig, ModelConfig
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    cfg = ModelConfig(arch="qwen2", vocab_size=512, hidden_size=256,
                      intermediate_size=256, num_layers=1, num_heads=4,
                      num_kv_heads=2, head_dim=128)
    gen = torch.Generator().manual_seed(3)
    for mode in (TMode.INT8, TMode.UINT4, TMode.DEFAULT):
        rt = (RuntimeConfigBuilder("g").max_length(128).max_batch(3)
              .kv_cache_page_size(16).kv_cache_mode(mode).dtype("bfloat16")
              .build())
        lp = {"q_proj": {"w": torch.zeros(256, 512)},
              "k_proj": {"w": torch.zeros(256, 256)},
              "v_proj": {"w": torch.zeros(256, 256)},
              "o_proj": {"w": torch.zeros(512, 256)},
              "gate_proj": {"w": torch.zeros(256, 256)},
              "up_proj": {"w": torch.zeros(256, 256)},
              "down_proj": {"w": torch.zeros(256, 256)}}
        plan = tmk.make_plan(cfg, rt, {"layers": lp,
                                       "lm_head": {"w": torch.zeros(256,
                                                                    512)}})
        cache = create_kv_cache(cfg, CacheConfig(page_size=16, mode=mode),
                                3 * 8 + 1, torch.bfloat16, "cpu")
        for t in (cache.k, cache.v):
            if mode == TMode.DEFAULT:
                t.normal_(generator=gen)
            else:
                t.view(torch.uint8).random_(0, 256, generator=gen)
        if mode != TMode.DEFAULT:
            for t in (cache.k_qparams, cache.v_qparams):
                t.uniform_(0.004, 0.008, generator=gen)
        pt = (1 + torch.arange(3 * 8, dtype=torch.int32)).reshape(3, 8)
        lens = torch.tensor([0, 33, 128], dtype=torch.int32)
        q = torch.randn((3, 4, 128), generator=gen).to(torch.bfloat16).float()
        k_new = torch.randn((3, 2, 128), generator=gen)
        v_new = torch.randn((3, 2, 128), generator=gen)
        want = tmk._attend_ref(plan, q, k_new, v_new, cache, pt, lens,
                               1 / math.sqrt(128))
        for chunk in (16, 48, 128):
            got = attention_chunked(plan, q, k_new, v_new, cache, pt, lens,
                                    1 / math.sqrt(128), chunk_tokens=chunk)
            tol = 1e-4 if mode == TMode.DEFAULT else 2e-4
            assert (got - want).abs().max() <= tol * want.abs().max(), \
                (mode, chunk)
