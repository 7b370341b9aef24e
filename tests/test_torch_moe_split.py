"""The MoE phases' item space (csrc/di_product.cuh `product_phase` with
`Part`s, csrc/di_moe_layer.cuh), modelled in numpy on the CPU.

The TP moe segment deals the routed experts' products, and beside them
the shared expert's, as one item space a phase, with the experts' K splits
read from `ops.tp_megakernel.moe_split_table` at the routed count the
kernel finds after its gates. The model below deals the
items as the kernel's `decode` does: every (expert, pass, tile, chunk) of
each routed count 0..E must be covered exactly once, no phase may leave most
of the grid idle while a few blocks stream whole experts, and the segment
computed over those items, with the split sums, the experts (ascending) and
the shared expert summed in `moe_out_phase`'s order, must equal the plain
`moe_segment_ref` (held against the JAX segment by test_torch_tp_moe.py)
within 1e-3 of its largest value (both f32, the SwiGLU activation rounded to
bf16 at the same point; they differ in the order of the split sums).

`deal` is this module's own copy of the kernel's dealing: it does not read
the CUDA `decode`, so these tests hold the plan's split table and the
design's arithmetic, not the kernel's indexing. That the kernel covers
every chunk is held on the card by chip_smoke.py, which checks the segment
against `moe_segment_ref` at every case."""

import types

import numpy as np
import pytest
import torch

from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops import tp_megakernel as ttpk
from tests.test_torch_tp_moe import moe_case
from tests.test_torch_tp_segments import ACTIVE, N

CHUNK = mk.CHUNK_K


def deal(parts, passes, grid, first=0):
    """The items of `parts` ([dict(tiles, chunks, ks, cps, groups)]) as
    product_phase deals them: part 0's, then part 1's, item i to block
    first + i % (grid - first), each (group, pass, tile, split) with split
    fastest. Returns [(block, part, group, pass, tile, c0, nc)]."""
    out, i = [], 0
    for p, pt in enumerate(parts):
        pg = passes * pt["tiles"] * pt["ks"]
        for li in range(pg * pt["groups"]):
            g, r = divmod(li, pg)
            split = r % pt["ks"]
            t = (r // pt["ks"]) % pt["tiles"]
            ps = r // (pt["ks"] * pt["tiles"])
            c0 = split * pt["cps"]
            out.append((first + i % (grid - first), p, g, ps, t, c0,
                        min(pt["cps"], pt["chunks"] - c0)))
            i += 1
    return out


def check_cover(items, parts, passes, grid, what, first=0):
    """Every (part, group, pass, tile, chunk) exactly once, no empty item,
    and the busiest of the `grid` blocks from `first` on streams at most
    twice the chunks of a fair share (one item more where items are
    few)."""
    seen = {}
    per_block = np.zeros(grid, np.int64)
    for b, p, g, ps, t, c0, nc in items:
        assert nc >= 1, (what, "empty item")
        per_block[b - first] += nc
        for c in range(c0, c0 + nc):
            key = (p, g, ps, t, c)
            assert key not in seen, (what, "chunk twice", key)
            seen[key] = True
    want = sum(passes * pt["tiles"] * pt["chunks"] * pt["groups"]
               for pt in parts)
    assert len(seen) == want, (what, len(seen), want)
    if want:
        fair = -(-want // grid)
        largest = max(pt["cps"] for pt in parts if pt["groups"])
        assert per_block.max() <= max(2 * fair, largest), \
            (what, int(per_block.max()), fair)


def _sp(N, K, bits=4):
    return types.SimpleNamespace(Nptot=N, K=K, bits=bits)


# Qwen1.5-MoE-A2.7B at its served widths: the TP moe segment's share of a
# rank (n = 2, 4) at B = 8 and 32 (experts, gate|up width, shared slice,
# grid, B)
SHAPES = [(30, 3072, 2816, 264, 8), (30, 3072, 2816, 132, 32),
          (15, 3072, 1408, 264, 8), (15, 3072, 1408, 132, 32)]


def _plan(E, gu_n, shared):
    sg_n = -(-shared // 256) * 256
    return types.SimpleNamespace(
        E=E, gu=_sp(gu_n, 2048), dn=_sp(2048, 1408),
        sgu=_sp(2 * sg_n, 2048), sdn=_sp(2048, shared),
        rt=_sp(256, 2048, 16))


def phase_parts(plan, table, splits, r):
    """The parts of the three MoE product phases at routed count r: the
    shared gate|up (beside the gates, dealt from block B on), the experts'
    gate|up, and their down beside the shared down."""
    e = table[r]

    def part(sp, ks, cps, groups):
        return dict(tiles=sp.Nptot // 256, chunks=sp.K // CHUNK, ks=int(ks),
                    cps=int(cps), groups=groups)
    return dict(
        gates=[part(plan.sgu, *splits["sgu"], 1)],
        gate_up=[part(plan.gu, e[0], e[1], r)],
        down=[part(plan.dn, e[2], e[3], r), part(plan.sdn, e[4], e[5], 1)])


@pytest.mark.parametrize("E,gu_n,shared,grid,B", SHAPES)
def test_item_space_covers_every_chunk_once(E, gu_n, shared, grid, B):
    plan = _plan(E, gu_n, shared)
    passes = 1 if B <= 32 else 2
    # the static splits the wrappers give every stream first
    splits = {name: mk.choose_split(sp.Nptot // 256, sp.K // CHUNK,
                                    CHUNK * 32 * sp.bits, B, passes, grid)
              for name, sp in (("rt", plan.rt), ("sgu", plan.sgu),
                               ("sdn", plan.sdn))}
    table = ttpk.moe_launch_splits(plan, B, passes, grid, splits)
    assert table.shape == (E + 1, ttpk.MOE_SPLIT_ARGS)
    for r in range(E + 1):
        ph = phase_parts(plan, table, splits, r)
        for name, parts in ph.items():
            first = B if name == "gates" else 0     # the gates' blocks
            check_cover(deal(parts, passes, grid, first), parts, passes,
                        grid - first, f"E={E} r={r} {name}", first)
        # the runtime splits fit the strides the scratch was laid out with;
        # the shared expert's is the same at every routed count
        assert table[r, 0] <= splits["gu"][0]
        assert table[r, 2] <= splits["dn"][0]
        assert tuple(table[r, 4:6]) == splits["sdn"]


def _stream_w(packed, sp, layer, e=None):
    """The stream's leaves of one layer (one expert's), their true columns
    side by side: f64 of the bf16 weights [K, Ntot]."""
    ws = []
    for name, n in zip(sp.leaves, sp.N):
        leaf = {k: v[layer] if e is None else v[layer][e]
                for k, v in packed["layers"][name].items()}
        ws.append(mk.loader_view(leaf)["w"][:, :n])
    return torch.cat(ws, 1).to(torch.bfloat16).double().numpy()


def _splits_dot(x, w, ks, cps):
    """x [B, K] . w [K, N] as the kernel's K splits, summed in split order
    (f32)."""
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for s in range(ks):
        k0, k1 = s * cps * CHUNK, min((s + 1) * cps * CHUNK, w.shape[0])
        out = out + (x[:, k0:k1].astype(np.float64) @ w[k0:k1]).astype(
            np.float32)
    return out


def _model_segment(plan, packed, layer, x, rank, forced, table, splits):
    """The moe segment over the kernel's item space (f32 weights rounded to
    bf16 as the bf16 stream): the partials by split, SwiGLU of the summed
    splits, the out phase's order."""
    xt = torch.from_numpy(x)
    xn = mk._rms(xt, packed["norms"][layer, 1], plan.rms_eps).to(
        torch.bfloat16)
    logits = mk._stream_dot(xn, packed, plan.rt, layer)
    gates, sg = mk.route(plan, logits, forced)
    gates, sg = gates.numpy(), sg.numpy()
    xnn = xn.float().numpy()
    e0 = ttpk.first_expert(rank, plan.E)
    act_rows = np.nonzero(ACTIVE)[0]
    routed = sorted({e - e0 for e in forced[act_rows].flatten().tolist()
                     if e0 <= e < e0 + plan.E})
    sp = table[len(routed)]

    def swiglu(gu, inter):
        g, u = gu[:, :inter], gu[:, inter:]
        a = g * (np.float32(1) / (np.float32(1) + np.exp(-g))) * u
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    down = {}
    for e in routed:
        act = swiglu(_splits_dot(xnn, _stream_w(packed, plan.gu, layer, e),
                                 sp[0], sp[1]), plan.inter)
        down[e] = _splits_dot(act, _stream_w(packed, plan.dn, layer, e),
                              sp[2], sp[3])
    out = np.zeros((plan.B, plan.hid), np.float32)
    for m in range(plan.B):
        if ACTIVE[m]:
            for e in sorted(int(i) for i in np.nonzero(gates[m])[0]):
                if e0 <= e < e0 + plan.E:
                    out[m] += np.float32(gates[m, e]) * down[e - e0][m]
    if plan.has_shared:
        act = swiglu(_splits_dot(xnn, _stream_w(packed, plan.sgu, layer),
                                 *splits["sgu"]), plan.shared_inter)
        y = _splits_dot(act, _stream_w(packed, plan.sdn, layer), sp[4],
                        sp[5])
        out += sg[:, None].astype(np.float32) * y
    return out, len(routed)


@pytest.mark.parametrize("grid", [3, 8, 264])
def test_item_space_sums_as_the_plain_segment(grid):
    """The tiny model's moe segment over the item space, at routed counts
    0, 1 and 2 of a rank's two experts (forced routing), equals the plain
    `moe_segment_ref` within 1e-3 of its largest value."""
    c = moe_case("none")
    plan = c["plan"]
    assert plan.rt.bits == 16 and plan.gu.bits == 16
    B, passes = plan.B, 1
    splits = {sp.name: mk.choose_split(sp.Nptot // 256, sp.K // CHUNK,
                                       CHUNK * 32 * sp.bits, B, passes, grid)
              for sp in plan.layer_streams}
    table = ttpk.moe_launch_splits(plan, B, passes, grid, splits)
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((B, plan.hid)) * 0.5).astype(np.float32)
    seen = set()
    # rank 0 holds experts 0, 1 and rank 1 experts 2, 3
    for forced_pair in ([2, 3], [0, 3], [0, 1], [1, 2]):
        forced = torch.tensor([forced_pair] * B)
        for rank in range(N):
            want = ttpk.moe_segment_ref(plan, c["packs"][rank], 1,
                                        torch.from_numpy(x.copy()), rank,
                                        forced_routing=forced).numpy()
            got, r = _model_segment(plan, c["packs"][rank], 1, x, rank,
                                    forced, table, splits)
            seen.add(r)
            rows = np.nonzero(ACTIVE)[0]
            assert np.abs(got[rows] - want[rows]).max() <= \
                1e-3 * np.abs(want[rows]).max(), (forced_pair, rank)
    assert seen == {0, 1, 2}
