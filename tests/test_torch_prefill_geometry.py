"""The redesigned prefill megakernel's geometry and decomposition, on the CPU
(no card here):

* a numpy model of its product with the weights as wgmma's register A
  operand and x as its shared-memory B operand: the bytes `pack_payload`
  lays out, dequantized weight-side into the A fragments (a warpgroup's 64
  columns of a tile half, 16 a warp), and x written in the kernel's x
  layout (`xoff` of csrc/di_prefill_layer.cuh) and read back as the tensor
  cores read a K-major, 128-byte swizzled tile, through the m64nNk16
  fragment definitions and the kernel's store indices, give `_wdeq_dot`'s
  product for every weight kind, at ragged row counts 1 .. 256 and both row
  tiles (128 dense, 64 routed);
* `route_rows`, the plain mirror of the kernel's routing phase (counts,
  ascending row lists, slots, routed-row tiles), against a direct count,
  and its routed decomposition of a MoE layer (`moe_routed`) against the
  every-expert `moe_ref`, with an expert of no rows and with one expert
  taking most rows, and through the whole plain prefill against the JAX
  MoE prefill kernel in interpret mode;
* `scratch_need` of the routed layout: the slots grow with n x k, not with
  the experts, and hold every routing.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dashinfer_tpu.config import QuantConfig
from dashinfer_tpu.loader.quantize import quantize_params
from dashinfer_tpu_torch.config import CacheMode as TMode
from dashinfer_tpu_torch.ops import megakernel as tmk
from dashinfer_tpu_torch.ops import prefill_megakernel as tpmk
from dashinfer_tpu_torch.ops.megakernel import StreamPlan
from tests.test_megakernel import _tiny_moe
from tests.test_torch_megakernel_geometry import (GID, TIG, _bf16_bits,
                                                  _bits_f32, _halves, _leaf,
                                                  frag_a, payload_frags)
from tests.test_torch_prefill_megakernel import (BUCKET, PS,
                                                 _check_against_pallas)

# ---------------------------------------------------------------------------
# the product: weights as the register A operand, x as the swizzled B
# ---------------------------------------------------------------------------


def xoff(R: int, r, k):
    """csrc/di_prefill_layer.cuh `xoff`: element k of row r of an R-row x
    operand (k // 64 the chunk, the 16-byte unit (k % 64) // 8 of row r
    stored at unit ^ (r % 8))."""
    return ((k >> 6) * R + r) * 64 + ((((k >> 3) & 7) ^ (r & 7)) << 3) + \
        (k & 7)


def x_layout(x: np.ndarray, R: int) -> np.ndarray:
    """x [M, K] f32 -> the bf16 bits of the x layout of an R-row operand
    (rows past M zero), as the norm / attention / SwiGLU phases write it."""
    M, K = x.shape
    out = np.zeros(R * K, np.uint16)
    r, k = np.meshgrid(np.arange(M), np.arange(K), indexing="ij")
    out[xoff(R, r, k)] = _bf16_bits(x)
    return out


def swizzled_tile(stage: np.ndarray, NR: int) -> np.ndarray:
    """The B operand the tensor cores read from a 1024-byte aligned stage
    of NR rows x 128 bytes under the 128-byte swizzle (K-major): element
    (k, n) at byte n * 128 + ((k // 8) ^ (n % 8)) * 16 + (k % 8) * 2 ->
    [64, NR] f32."""
    n, k = np.meshgrid(np.arange(NR), np.arange(64), indexing="xy")
    byte = n * 128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7) * 2
    return _bits_f32(stage[byte // 2])


def _bf16_round(v: np.ndarray) -> np.ndarray:
    """f64 / f32 values rounded once to bf16 (nearest even), as f32."""
    return _bits_f32(_bf16_bits(np.asarray(v, np.float64).astype(
        np.float32)))


def a_operand(chunk: np.ndarray, bits: int, warp: int, s: int, sc, ze):
    """The A registers of k16 step s of `warp`'s 16 columns of each tile
    half, dequantized weight-side as `a_frags` computes them -> (alo, ahi)
    [32][4] uint32. `sc` / `ze` [32][4]: this lane's bf16-rounded scale and
    zero of its columns [half * 2 + nt]."""
    lo, hi = payload_frags(chunk, bits, warp, s)    # [32][nt][i]
    out = []
    for h, regs in ((0, lo), (1, hi)):
        words = np.zeros((32, 2, 2), np.uint32)
        for nt in range(2):
            for i in range(2):
                a, b = _halves(regs[:, nt, i])
                if bits == 16:
                    words[:, nt, i] = regs[:, nt, i]
                    continue
                if bits == 4:       # bf16(128 + n) -> n
                    a, b = a - 128.0, b - 128.0
                s_, z_ = sc[:, 2 * h + nt], ze[:, 2 * h + nt]
                # one rounding of the exact q * s + z (the fused bf16 fma;
                # the int8 f32 fma is exact before its bf16 rounding too)
                wa = _bf16_round(a.astype(np.float64) * s_ + z_)
                wb = _bf16_round(b.astype(np.float64) * s_ + z_)
                words[:, nt, i] = _bf16_bits(wa).astype(np.uint32) | \
                    (_bf16_bits(wb).astype(np.uint32) << 16)
        out.append(np.stack([words[:, 0, 0], words[:, 1, 0],
                             words[:, 0, 1], words[:, 1, 1]], 1))
    return out


def wgmma_product_model(x: np.ndarray, leaf: dict, bits: int, NR: int,
                        rows: int, R: int) -> np.ndarray:
    """csrc/di_prefill_layer.cuh `gemm_phase` (one K split, every row tile
    holding a row < rows) on one packed leaf, in numpy -> out [rows, N]."""
    K = x.shape[1]
    w_f = leaf["w_f"]
    if bits == 16:
        w_f = w_f.view(torch.int16)
    w_f = np.ascontiguousarray(w_f.numpy()).view(np.uint8)
    T, C = w_f.shape[:2]
    G = 1 if bits == 16 else leaf["scale"].shape[0]
    cpg = C // G
    xl = x_layout(x, R)
    out = np.zeros((rows, T * 256), np.float32)
    for t in range(T):
        for rt in range(-(-rows // NR)):
            row0 = rt * NR
            nn = NR                      # the products read every row
            acc = np.zeros((8, 2, 32, NR // 2), np.float32)   # [warp][half]
            for c in range(C):
                # the stage's x tile: NR rows of chunk c, one contiguous run
                run = xl[(c * R + row0) * 64:(c * R + row0 + nn) * 64]
                B = swizzled_tile(run, nn)                    # [64, nn]
                for w in range(8):
                    cols = 256 * t + 16 * w + GID
                    if bits == 16:
                        sc = np.ones((32, 4), np.float32)
                        ze = np.zeros((32, 4), np.float32)
                    else:
                        g = c // cpg
                        s_ = leaf["scale"][g].to(torch.bfloat16).float()
                        z_ = leaf["zero"][g].to(torch.bfloat16).float()
                        idx = np.stack([cols, cols + 8, cols + 128,
                                        cols + 136], 1)
                        sc, ze = s_.numpy()[idx], z_.numpy()[idx]
                    for s in range(4):
                        for h, regs in enumerate(a_operand(
                                w_f[t, c], bits, w, s, sc, ze)):
                            A = frag_a(regs)                  # [16 cols, 16 k]
                            D = A @ B[16 * s:16 * s + 16]     # [16, nn]
                            # the m64nNk16 accumulator of this warp's 16
                            # rows: d[4 j + q] = D[gid + 8 (q >> 1)]
                            # [8 j + 2 tig + (q & 1)]
                            for j in range(nn // 8):
                                for q in range(4):
                                    acc[w, h, :, 4 * j + q] += D[
                                        GID + 8 * (q >> 1),
                                        8 * j + 2 * TIG + (q & 1)]
            # the stores: column 128 h + 16 w + gid (+ 8), rows 8 j + 2 tig
            for w in range(8):
                for h in range(2):
                    for j in range(nn // 8):
                        for q in range(4):
                            r = 8 * j + 2 * TIG + (q & 1)
                            col = 256 * t + 128 * h + 16 * w + GID + \
                                8 * (q >> 1)
                            ok = row0 + r < rows
                            out[row0 + r[ok], col[ok]] = \
                                acc[w, h, ok, 4 * j + q]
    return out


@pytest.mark.parametrize("bits,G,NR,rows", [
    (4, 2, 128, 1),       # u4 group 128 (two chunks a group), one row
    (4, 2, 128, 100),     # a served prompt's ragged last tile
    (4, 4, 128, 256),     # group 64, two full row tiles
    (4, 2, 64, 37),       # an expert's routed rows (N = 64)
    (4, 2, 64, 5),        # a ragged expert tile
    (8, 1, 64, 80),       # 64 + 16 routed rows
    (8, 1, 128, 129),     # int8 per channel, a second tile of one row
    (8, 2, 64, 200),      # int8 group-wise, four routed tiles
    (16, 1, 128, 45),     # bf16 (the MoE router)
    (16, 1, 64, 64),
])
def test_weights_as_register_a_and_swizzled_x_give_the_plain_product(
        bits, G, NR, rows):
    """The pack's bytes, dequantized weight-side into wgmma's register A
    fragments, times x read from its swizzled layout as the B operand,
    through the m64nNk16 fragment definitions and the kernel's store
    indices, compute `_wdeq_dot`'s product (f32 sums in another order)."""
    K, N = 256, 256
    leaf = tmk.packed_leaf(_leaf(bits, K, N, G, seed=bits * 10 + rows))
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, K).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    sp = StreamPlan("t", ("w",), bits, K, (N,), 0 if bits == 16 else K // G)
    packed = {"layers": {"w": {k: v[None] for k, v in leaf.items()}}}
    want = tpmk._wdeq_dot(xb, packed, sp, 0).numpy()
    R = -(-rows // NR) * NR          # the operand's rows: whole tiles
    got = wgmma_product_model(_bits_f32(_bf16_bits(x)), leaf, bits, NR,
                              rows, R)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


RING_BYTES = 200 * 1024   # the products' shared memory (csrc kRingBytes)
SMEM_LIMIT = 232448       # dynamic shared memory a block of the H100 takes
MAX_E = 512               # csrc kMaxE: the routed tables' experts


def product_ring_layout(bits: int, NR: int) -> dict:
    """csrc/di_prefill_layer.cuh `PRing` (the wgmma products' ring), in
    bytes from the 1024-byte aligned base: the stages (x tile of NR rows,
    the payload chunk, the qparam rows of a quantized stream), the
    mbarriers, the cursor and the context (`end`)."""
    chunk = 64 * {4: 128, 8: 256, 16: 512}[bits]
    stage = NR * 128 + chunk + (0 if bits == 16 else 2048)
    stages = min(8, RING_BYTES // stage)
    bar = stages * stage
    return dict(stage=stage, stages=stages, bar=bar,
                end=bar + 16 * stages + 96 + 96)


def kernel_smem_bytes() -> int:
    """csrc `pmk_smem_bytes`: the alignment slack, the products' ring and
    the routed tables."""
    return 1024 + RING_BYTES + 1024 + (3 * MAX_E + 1) * 4


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("stream", ["u4", "i8", "bf16"])
def test_dense_product_stage_budget(n, stream):
    """The dense and the expert products' rings at Qwen2-7B's shapes on
    one card and a rank's of (1, 2) / (1, 4) meshes: every product's K a
    whole number of chunks, every x tile 1024-byte aligned, at least three
    stages (the next chunk is issued two back), the ring within its bytes
    and the whole block within the card's 227 KB."""
    bits = {"u4": 4, "i8": 8, "bf16": 16}[stream]
    hid, inter, H, D = 3584, 18944, 28, 128
    K_of = {"qkv": hid, "o": H * D // n, "gu": hid, "dn": inter // n}
    for name, K in K_of.items():
        assert K % tmk.CHUNK_K == 0, name
    for NR in (tpmk.M_TILE, 64):
        lay = product_ring_layout(bits, NR)
        assert lay["stage"] % 1024 == 0
        assert lay["stages"] >= 3
        assert lay["end"] <= RING_BYTES + 1024
    assert kernel_smem_bytes() <= SMEM_LIMIT
    if bits == 4:
        assert product_ring_layout(4, tpmk.M_TILE)["stages"] == 7


@pytest.mark.parametrize("R", [128, 4672])
def test_x_layout_is_a_permutation_with_whole_tiles(R):
    """Every element of an R-row operand has its own place, and the rows of
    a tile at a multiple of 8 are one contiguous run a chunk: a bulk copy
    of NR x 128 bytes."""
    K = 256
    r, k = np.meshgrid(np.arange(R), np.arange(K), indexing="ij")
    off = xoff(R, r, k)
    assert np.array_equal(np.sort(off.reshape(-1)), np.arange(R * K))
    for row0 in (0, 64, R - 64):
        for c in range(K // 64):
            o = off[row0:row0 + 64, 64 * c:64 * c + 64]
            assert o.min() == (c * R + row0) * 64 and \
                o.max() == (c * R + row0 + 64) * 64 - 1


# ---------------------------------------------------------------------------
# the routing phase and the routed decomposition of a MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,E,k,skew", [
    (45, 4, 2, None),        # the tiny model's shapes
    (3, 8, 2, None),         # most experts without rows
    (1024, 60, 4, None),     # Qwen1.5-MoE at bucket 1024
    (300, 60, 4, 7),         # one expert in every row
    (129, 16, 8, 0),
])
def test_route_rows_lays_out_the_routing_phase(n, E, k, skew):
    gen = np.random.RandomState(n + E)
    eidx = np.stack([gen.choice(E, k, replace=False) for _ in range(n)])
    if skew is not None:
        for row in eidx:
            if skew not in row:
                row[0] = skew
    eidx = torch.from_numpy(np.sort(eidx, 1))
    r = tpmk.route_rows(eidx, E)
    counts = np.bincount(eidx.reshape(-1).numpy(), minlength=E)
    assert r["counts"].tolist() == counts.tolist()
    assert int(r["counts"].sum()) == n * k
    if skew is not None:
        assert int(r["counts"][skew]) == n
    padded = -(-counts // tpmk.SLOT_ALIGN) * tpmk.SLOT_ALIGN
    assert r["base"].tolist() == (np.cumsum(padded) - padded).tolist()
    seen = set()
    for e in range(E):
        rows = r["rows"][e]
        assert rows.tolist() == sorted(
            i for i in range(n) if e in eidx[i].tolist())
        for rank, row in enumerate(rows.tolist()):
            j = eidx[row].tolist().index(e)
            assert int(r["slots"][row, j]) == int(r["base"][e]) + rank
            seen.add(int(r["slots"][row, j]))
    assert len(seen) == n * k                 # one slot a (row, expert)
    # the tiles: expert order, at most E_TILE rows, every routed row once
    tiles = r["tiles"]
    assert [t[0] for t in tiles] == sorted(t[0] for t in tiles)
    assert sum(t[2] for t in tiles) == n * k
    assert all(0 < t[2] <= tpmk.E_TILE for t in tiles)
    assert len(tiles) == sum(-(-c // tpmk.E_TILE) for c in counts)
    # a full bucket's slots and a tile's reach fit the scratch's capacity
    plan = _moe_plan(S=-(-n // 128) * 128, E=E, k=k)
    assert max(t[1] + tpmk.E_TILE for t in tiles) <= \
        tpmk.slot_capacity(plan)


def _tiny_moe_port(shared=True, bias_expert=None, quant="a16w4"):
    """(plan, pack) of the tiny MoE model (4 experts, top 2); with
    `bias_expert`, that expert's router column follows the rows' common
    direction so that it takes most rows."""
    from tests.test_torch_prefill_megakernel import _port_side
    cfg, rt, params = _tiny_moe(ps=PS, KH=2, H=2, shared=shared,
                                shared_gate=shared, norm_topk=not shared)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    rt = dataclasses.replace(rt, max_length=BUCKET + PS)
    if bias_expert is not None:
        w = np.array(params["layers"]["router"]["w"])
        w[:, :, bias_expert] = 0.3
        params = dict(params, layers=dict(params["layers"],
                                          router={"w": w}))
    return _port_side(cfg, rt, params, "int8")[3:]


def _moe_x(plan, n, seed, common=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(plan.S, plan.hid).astype(np.float32) + common
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("n,bias,common,shared", [
    (45, None, 0.0, True),
    (128, None, 0.0, False),
    (1, None, 0.0, True),      # two of the four experts have no row
    (100, 3, 1.0, True),       # expert 3 in every row
])
def test_moe_routed_matches_every_expert_moe_ref(n, bias, common, shared):
    """The kernel's decomposition (the prompt rows' routed slots, each
    expert over its routed-row tiles, the gated sum by slot in ascending
    expert order) gives the every-expert `moe_ref` on the prompt rows."""
    plan, packed = _tiny_moe_port(shared=shared, bias_expert=bias)
    x = _moe_x(plan, n, seed=n, common=common)

    def mm(x_, sp, l_, e):
        return tpmk._wdeq_dot(x_, packed, sp, l_, e)

    for layer in range(plan.L):
        routing = []
        got = tpmk.moe_routed(plan, x, layer, mm, n, routing)
        want = tmk.moe_ref(plan, x, layer, mm)
        np.testing.assert_allclose(got[:n].numpy(), want[:n].numpy(),
                                   rtol=0,
                                   atol=1e-5 * want[:n].abs().max().item())
        eidx = tpmk.chosen_experts(plan, routing[0][:n])
        counts = tpmk.route_rows(eidx, plan.E)["counts"]
        gates, _ = tmk.route(plan, routing[0][:n])
        assert counts.tolist() == (gates > 0).sum(0).tolist()
        if n == 1:
            assert int((counts == 0).sum()) == plan.E - plan.k_top
        if bias is not None:
            assert int(counts[bias]) == n


@pytest.mark.parametrize("quant,shared,kh", [("a16w4", True, 2),
                                             ("none", False, 1)])
def test_routed_prefill_matches_pallas_interpret(monkeypatch, quant, shared,
                                                 kh):
    """The whole plain prefill with the MoE layers in the kernel's routed
    decomposition, against the interpret-mode TPU kernel (every expert on
    every row), as tests/test_torch_prefill_megakernel.py holds the plain
    version: logits, the written pool rows (at most 2 tokens' rows off for
    a near-tie flip) and nothing else written."""
    monkeypatch.setattr(tpmk, "prefill_megakernel_ref", functools.partial(
        tpmk.prefill_megakernel_ref, routed=True))
    cfg, rt, params = _tiny_moe(ps=PS, KH=kh, H=2, shared=shared,
                                shared_gate=shared, norm_topk=not shared)
    if quant != "none":
        params = quantize_params(params, QuantConfig(mode=quant,
                                                     group_size=128))
    rt = dataclasses.replace(rt, max_length=BUCKET + PS)
    _check_against_pallas(cfg, rt, params, "int8", 45, flip_budget=2)


# ---------------------------------------------------------------------------
# the scratch of the routed layout
# ---------------------------------------------------------------------------

def _moe_plan(S=1024, E=60, k=4, hid=2048, Im=1408, sIm=5632, L=24):
    """A PrefillPlan of Qwen1.5-MoE-A2.7B's shapes (u4 group 128; the
    experts' 1408 columns padded to 1536 in the pack)."""
    def u4(name, leaves, K, N, E_=0):
        return StreamPlan(name, leaves, 4, K, N, 128, E_)
    return tpmk.PrefillPlan(
        S=S, L=L, hid=hid, H=16, KH=16, D=128, G=1, inter=Im,
        QKVN=3 * hid, V=151936, ps=64, maxPb=S // 64, kv_mode=TMode.INT8,
        kv_bits=8, kv_dtype_name="int8", has_qkv_bias=True,
        qkv=u4("qkv", ("q_proj", "k_proj", "v_proj"), hid, (hid,) * 3),
        o=u4("o", ("o_proj",), hid, (hid,)),
        gu=u4("gu", ("gate_proj", "up_proj"), hid, (Im, Im), E),
        dn=u4("dn", ("down_proj",), Im, (hid,), E),
        lm=u4("lm", ("lm_head",), hid, (151936,)),
        rms_eps=1e-6, E=E, k_top=k, norm_topk=False, has_shared=True,
        has_shared_gate=True, EP=128, shared_inter=sIm,
        rt=StreamPlan("rt", ("router",), 16, hid, (E + 1,), 0),
        sgu=u4("sgu", ("gate_proj", "up_proj"), hid, (sIm, sIm)),
        sdn=u4("sdn", ("down_proj",), sIm, (hid,)))


@pytest.mark.parametrize("S", [128, 256, 512, 1024])
def test_scratch_need_of_the_routed_layout(S):
    """The experts' buffers are sized by the S x k routed slots (each
    expert's first slot rounded up to 8, a tile's reach past the last),
    not by a batch of experts over every row."""
    plan = _moe_plan(S=S)
    scap = tpmk.slot_capacity(plan)
    assert scap % 64 == 0
    assert S * 4 + 8 * 60 + tpmk.E_TILE <= scap < S * 4 + 8 * 60 + 128
    splits = {sp.name: (1, sp.K // 64) for sp in plan.streams}
    splits["dn"] = (2, 11)
    need = tpmk.scratch_need(plan, splits)
    assert need["xe"] == scap * plan.hid
    assert need["edn"] == 2 * scap * plan.hid
    assert need["act"] == max(scap * plan.inter, S * plan.shared_inter)
    assert need["partial"] == max(scap * plan.gu.Nptot,
                                  S * plan.sgu.Nptot, S * plan.qkv.Nptot)
    assert need["eidx"] == need["eslot"] == S * tmk.MAX_TOPK
    assert need["ecount"] == plan.L * plan.E
    # the expert streams' K splits are chosen for a full bucket's routed
    # tiles: each expert's rows in tiles of 64, a ragged last one each
    assert tpmk.routed_tiles(plan) == -(-S * 4 // 64) + 60
    dense = dataclasses.replace(plan, E=0, k_top=0, rt=None, sgu=None,
                                sdn=None, has_shared=False,
                                has_shared_gate=False, shared_inter=0)
    assert tpmk.slot_capacity(dense) == 0
    assert "xe" not in tpmk.scratch_need(dense, splits)
