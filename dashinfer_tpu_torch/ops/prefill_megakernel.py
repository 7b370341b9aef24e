"""Whole-model PREFILL megakernel: one kernel launch per fresh prefill.

Counterpart of `dashinfer_tpu.ops.pallas.prefill_megakernel`. A prompt whose
bucket S is a multiple of 128 up to 1024 is prefilled by ONE launch of
csrc/prefill_megakernel.cu, which reads the decode pack already on the card
(`ops.megakernel.pack_params`: q, k, v, o, gate, up, down and lm_head as
separate fragment-ordered leaves, so the two kernels share one weight set
and no payload is copied a third time), writes the prompt's K/V straight
into the paged pool and returns the last valid token's logits. What lives
here:

* `supports_prefill`, `PrefillPlan`, `make_prefill_plan`: which buckets
  take the path and the shapes of one launch (the decode plan's
  `StreamPlan`s adopted verbatim);
* `prefill_megakernel_ref`, the plain PyTorch version, built from its
  per-layer pieces (`PrefillInputs`, `prefill_attention_block_ref`,
  `prefill_mlp_block_ref`, `prefill_lm_ref`), which the TP prefill
  segments' plain versions reuse (ops/tp_megakernel.py), and
  `prefill_megakernel`, the wrapper that launches the kernel on CUDA
  tensors (and takes the plain version only for CPU tensors), with its
  launch count `prefill_megakernel.counter`;
* the kernel's MoE decomposition, plain: `chosen_experts`, `route_rows`
  (the routing phase's counts, ascending row lists, slots and routed-row
  tiles) and `moe_routed` (the experts over their routed rows only, which
  the kernel runs; `prefill_megakernel_ref(routed=True)`), and the routed
  scratch's size (`slot_capacity`, `routed_tiles`);
* the device's one scratch set (`reserve_scratch`, `device_scratch`,
  `release_scratch`, `check_status`), which the TP prefill segments of
  every rank on the device share, and what a launch leaves in it
  (`kernel_gates`, `kernel_counts`, `kernel_x_last`).

Numerics (the TPU kernel's rounding points): residual in f32; x_norm bf16;
WEIGHT-SIDE dequant, `w = bf16(f32(q) * s + z)` with s and z rounded to bf16
where they are applied, then a plain bf16 x bf16 product with f32 sums (not the
decode kernel's affine after the dot); the q|k|v result in f32, bias added in
f32, a QK-norm model's per-head RMSNorm of q and k in f32, RoPE from bf16
cos/sin tiles in f32 (V gets bias and no RoPE; an ALiBi model rotates
nothing and reads no tiles); causal softmax over scores scaled by 1/sqrt(D)
(an ALiBi model's plus slope_h * (key - row), before the mask), `p` and `v` rounded to bf16 for the PV product, attn_out
bf16; K/V quantized per token and KV head from the unquantized f32 values; the
SwiGLU activation rounded to bf16; the last valid row n-1 through the final
norm, bf16, then the lm_head in f32. The TPU kernel feeds the score product f32
q and k; the CUDA kernel's tensor-core operands are bf16, which
`bf16_scores=True` reproduces in the plain version. The CUDA kernel's
lm_head is the decode product at one row (the group affine on the f32 sums
of bf16 x by the levels), summed in K splits: the plain version keeps the
TPU kernel's weight-side form, and `lm_row_ref` the CUDA kernel's own. The pool rows `< n` of the
owned pages are written and nothing else (the TPU kernel copies whole pages).
"""

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.config import CacheMode, ModelConfig, RuntimeConfig
from dashinfer_tpu_torch.ops import kernel_build, kv_ops
from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops.megakernel import MegaPlan, StreamPlan
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

MAX_BUCKET = 1024
M_TILE = 128        # prompt rows per product item and per attention item
# bytes of the lm_head's x records a 64-row chunk: one m16 tile of bf16
# rows (row n - 1 and 15 zero rows) and their f32 sums (csrc/di_product.cuh
# `rec_bytes(16)`)
ROW_RECORD_BYTES = 16 * (mk.CHUNK_K * 2 + 4)
E_TILE = 64         # routed rows per expert product item (csrc kETile)
SLOT_ALIGN = 8      # an expert's first routed slot is a multiple of this
_NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    S: int                    # padded bucket length (tokens)
    L: int
    hid: int
    H: int
    KH: int
    D: int
    G: int
    inter: int                # MLP width (a MoE model: each expert's)
    QKVN: int
    V: int
    ps: int
    maxPb: int                # pages covering S
    kv_mode: CacheMode
    kv_bits: int
    kv_dtype_name: str
    has_qkv_bias: bool
    qkv: StreamPlan
    o: StreamPlan
    gu: StreamPlan
    dn: StreamPlan
    lm: StreamPlan
    rms_eps: float
    qk_norm: bool = False     # per-head RMSNorm of q and k (Qwen3)
    alibi: bool = False       # ALiBi score bias in place of RoPE
    # MoE: the decode plan's fields (ops/megakernel.py MegaPlan)
    E: int = 0
    k_top: int = 0
    norm_topk: bool = False
    has_shared: bool = False
    has_shared_gate: bool = False
    EP: int = 0
    shared_inter: int = 0
    rt: Optional[StreamPlan] = None
    sgu: Optional[StreamPlan] = None
    sdn: Optional[StreamPlan] = None

    kernel_streams = mk.MegaPlan.kernel_streams
    streams = mk.MegaPlan.streams
    layer_streams = mk.MegaPlan.layer_streams
    layer_bytes = mk.MegaPlan.layer_bytes
    weight_bytes = mk.MegaPlan.weight_bytes

    def operations(self, n: int) -> float:
        """Multiply-adds x 2 that n valid prompt rows need: the layer
        products for each row (a MoE model's router, the k experts each row
        is routed to and the shared expert: the routed work, not every
        expert), causal attention, and the lm_head for one."""
        per_row = sum(s.K * s.Ntot * (self.k_top if s.E else 1)
                      for s in self.layer_streams if s.name != "rt")
        if self.E:
            per_row += self.hid * (self.E + int(self.has_shared_gate))
        attn = 2.0 * self.L * self.H * self.D * n * (n + 1)   # QK^T and PV
        return n * 2.0 * self.L * per_row + attn + \
            2.0 * self.lm.K * self.lm.Ntot


def supports_prefill(cfg: ModelConfig, rt: RuntimeConfig, params: Dict,
                     bucket: int) -> bool:
    """Whether a fresh prompt of this bucket takes the prefill megakernel:
    the JAX package's rules (bucket rule, weight-only view, `supports`; a
    dense model: equal bits over gate / up / down and down's groups a
    multiple of 128 or one group; a MoE model: equal bits over the experts'
    gate / up / down and over the shared expert's; QK-norm and ALiBi under
    `ops.megakernel.supports`' rules)."""
    if bucket > MAX_BUCKET or bucket % 128:
        return False
    view = mk.weight_only_decode_view(params)
    if view is None or not mk.supports(cfg, rt, view):
        return False
    lp = view["layers"]
    if cfg.moe is not None:
        ex = lp["experts"]
        if len({mk._weight_bits(ex[n]) for n in mk._MLP}) != 1:
            return False
        if cfg.moe.shared_expert_intermediate_size:
            se = lp["shared_expert"]
            if len({mk._weight_bits(se[n]) for n in mk._MLP}) != 1:
                return False
        return True
    bits = {mk._weight_bits(lp[n]) for n in ("gate_proj", "up_proj",
                                             "down_proj")}
    if len(bits) != 1:
        return False
    dnl = lp["down_proj"]
    if "w_q" in dnl:
        Kdn = dnl["w_q"].shape[1]
        gs = Kdn // dnl["scale"].shape[1]
        if gs % 128 and gs != Kdn:
            return False
    return True


def make_prefill_plan(cfg: ModelConfig, rt: RuntimeConfig, params: Dict,
                      bucket: int,
                      decode_plan: Optional[MegaPlan] = None) -> PrefillPlan:
    """Shapes of one prefill launch. `decode_plan`: the decode MegaPlan
    whose StreamPlans this plan adopts verbatim, so that both kernels index
    ONE packed weight set; without it the plan is made from `params`."""
    dp = decode_plan
    if dp is None:
        dp = mk.make_plan(cfg, rt, mk.weight_only_decode_view(params))
    mode = rt.cache.mode
    if mode == CacheMode.DEFAULT:
        kv_dtype_name = "float32" if rt.dtype == "float32" else "bfloat16"
    else:
        kv_dtype_name = "int8" if mode == CacheMode.INT8 else "uint8"
    return PrefillPlan(
        S=bucket, L=dp.L, hid=dp.hid, H=dp.H, KH=dp.KH, D=dp.D, G=dp.G,
        inter=dp.inter, QKVN=dp.QKVN, V=dp.V, ps=rt.cache.page_size,
        maxPb=-(-bucket // rt.cache.page_size), kv_mode=mode,
        kv_bits={CacheMode.DEFAULT: 16, CacheMode.INT8: 8,
                 CacheMode.UINT4: 4}[mode],
        kv_dtype_name=kv_dtype_name, has_qkv_bias=dp.has_qkv_bias,
        qkv=dp.qkv, o=dp.o, gu=dp.gu, dn=dp.dn, lm=dp.lm,
        rms_eps=dp.rms_eps, qk_norm=dp.qk_norm, alibi=dp.alibi, E=dp.E,
        k_top=dp.k_top,
        norm_topk=dp.norm_topk,
        has_shared=dp.has_shared, has_shared_gate=dp.has_shared_gate,
        EP=dp.EP, shared_inter=dp.shared_inter, rt=dp.rt, sgu=dp.sgu,
        sdn=dp.sdn)


def cuda_kernel_gaps(plan: PrefillPlan, any_lm_width: bool = False
                     ) -> List[str]:
    """Why csrc/prefill_megakernel.cu (and the TP prefill segments, which
    share its phases) cannot run this plan (empty = it can): the pack's
    64-row chunks and columns a multiple of 128 (padded to its 256-column
    tiles, each leaf read at its padded offset), head_dim 128, the router's
    lanes; `any_lm_width` as `ops.megakernel.stream_gaps`' (the TP prefill
    lm segment's one-row product writes the true columns of any even
    width)."""
    gaps = [g for sp in plan.streams
            for g in mk.stream_gaps(sp, any_lm_width)]
    if plan.D != 128:
        gaps.append("head_dim != 128")
    if plan.S % M_TILE or plan.S > MAX_BUCKET:
        gaps.append(f"bucket {plan.S} not a multiple of {M_TILE} up to "
                    f"{MAX_BUCKET}")
    if plan.EP > mk.MAX_EXPERTS or plan.k_top > mk.MAX_TOPK:
        gaps.append(f"{plan.EP} router lanes / top-{plan.k_top}")
    return gaps


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def dequantized_leaf(leaf: Dict) -> torch.Tensor:
    """One leaf (a layer's slice, either layout) as the kernel's product
    sees it: f32 values of `bf16(f32(q) * s + z)` [K, N], with s and z
    rounded to bf16; a bf16 leaf as it is."""
    leaf = mk.loader_view(leaf)
    if "w" in leaf:
        return leaf["w"].to(torch.bfloat16).float()
    scale = leaf["scale"].to(torch.bfloat16).float()
    zero = leaf["zero"].to(torch.bfloat16).float()
    q = weight_levels(leaf["w_q"]).float()
    gs = q.shape[0] // scale.shape[0]
    w = q * scale.repeat_interleave(gs, dim=0) + \
        zero.repeat_interleave(gs, dim=0)
    return w.to(torch.bfloat16).float()


def _wdeq_dot(x: torch.Tensor, packed: Dict, sp: StreamPlan,
              layer: Optional[int], expert: Optional[int] = None
              ) -> torch.Tensor:
    """x [M, K] bf16 . the stream's leaves (one expert's, for an expert
    stream), dequantized weight-side -> f32 [M, Ntot] (the true columns)."""
    xf = x.float()
    outs = []
    for name, n in zip(sp.leaves, sp.N):
        if layer is None:
            leaf = packed["lm_head"]
        else:
            leaf = {k: v[layer] if expert is None else v[layer][expert]
                    for k, v in packed["layers"][name].items()}
        outs.append(xf @ dequantized_leaf(leaf)[:, :n])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [S, n, D] f32; cos/sin [S, D] f32 full-D tiles (half-split)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


class PrefillInputs:
    """The per-prefill inputs of the layer pieces below, derived once: the
    bf16 RoPE tiles as f32, the prompt length n, each prompt row's page
    (layer 0's physical page of the logical page it falls in) and offset,
    the causal mask of the bucket and its ALiBi distances key - row [q, k]
    f32."""

    def __init__(self, plan: PrefillPlan, cos: torch.Tensor,
                 sin: torch.Tensor, page_row: torch.Tensor, n_tokens):
        bf = torch.bfloat16
        dev = cos.device
        self.n = n = int(n_tokens)
        self.cosf, self.sinf = cos.to(bf).float(), sin.to(bf).float()
        pos = torch.arange(n, device=dev)
        self.pages0 = page_row.to(dev).long()[
            (pos // plan.ps).clamp(0, plan.maxPb - 1)]
        self.offs = pos % plan.ps
        t = torch.arange(plan.S, device=dev)
        self.causal = t[None, :] <= t[:, None]               # [q, k]
        self.dist = (t[None, :] - t[:, None]).float()


def prefill_attention_block_ref(plan: PrefillPlan, packed: Dict, layer: int,
                                resid: torch.Tensor, inp: PrefillInputs,
                                cache: KVCache, bf16_scores: bool = False
                                ) -> torch.Tensor:
    """One layer's RMSNorm, q|k|v (+ bias), RoPE (an ALiBi plan: the score
    bias slope_h * (key - row) instead), the K/V write of rows < n, causal
    attention and o product, from the f32 residual [S, hid]; updates the
    pool in place and returns the o product [S, hid] f32.
    `bf16_scores` rounds q and k to bf16 before the score product, as the
    CUDA kernel's tensor-core operands are."""
    S, H, KH, D, G = plan.S, plan.H, plan.KH, plan.D, plan.G
    bf = torch.bfloat16
    HD, KD = H * D, KH * D
    n = inp.n
    x = mk._rms(resid, packed["norms"][layer, 0], plan.rms_eps).to(bf)
    qkv = _wdeq_dot(x, packed, plan.qkv, layer)
    if packed["qkv_b"] is not None:
        qkv = qkv + packed["qkv_b"][layer]
    qn, kn = mk.qk_norm_heads(plan, packed, layer, qkv[:, :HD],
                              qkv[:, HD:HD + KD])
    q, k = qn.reshape(S, H, D), kn.reshape(S, KH, D)
    if not plan.alibi:
        q, k = _rope(q, inp.cosf, inp.sinf), _rope(k, inp.cosf, inp.sinf)
    v = qkv[:, HD + KD:].reshape(S, KH, D)
    qs, ks = (q.to(bf).float(), k.to(bf).float()) if bf16_scores else (q, k)
    s = torch.einsum("qhgd,khd->hgqk", qs.reshape(S, KH, G, D), ks) * \
        (1.0 / math.sqrt(D))
    if plan.alibi:
        s = s + packed["slopes"].reshape(KH, G, 1, 1) * inp.dist
    s = torch.where(inp.causal, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("hgqk,khd->qhgd", p.to(bf).float(),
                        v.to(bf).float()).reshape(S, HD).to(bf)
    kv_ops._write(cache, plan.kv_mode, k[:n], v[:n], inp.pages0 + layer,
                  inp.offs)
    return _wdeq_dot(attn, packed, plan.o, layer)


def prefill_mlp_block_ref(plan: PrefillPlan, packed: Dict, layer: int,
                          resid: torch.Tensor) -> torch.Tensor:
    """One dense layer's RMSNorm, gate|up, SwiGLU and down product, from the
    f32 residual [S, hid] -> the down product [S, hid] f32."""
    x = mk._rms(resid, packed["norms"][layer, 1], plan.rms_eps).to(
        torch.bfloat16)
    gu = _wdeq_dot(x, packed, plan.gu, layer)
    g, u = gu[:, :plan.inter], gu[:, plan.inter:]
    act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    return _wdeq_dot(act, packed, plan.dn, layer)


def prefill_lm_ref(plan: PrefillPlan, packed: Dict, resid: torch.Tensor,
                   n: int) -> torch.Tensor:
    """The final RMSNorm of row n - 1, bf16, and the lm_head -> logits [V]
    f32, dequantized weight-side as the TPU kernel does (the reference of
    PERF.md §2's logits rule)."""
    x = mk._rms(resid[n - 1:n], packed["final_norm"], plan.rms_eps).to(
        torch.bfloat16)
    return _wdeq_dot(x, packed, plan.lm, None)[0]


def lm_row_ref(plan: PrefillPlan, packed: Dict,
               x_last: torch.Tensor) -> torch.Tensor:
    """The lm_head of one final-normed bf16 row `x_last` [hid] -> logits
    [V] f32 with the CUDA kernels' own rounding (di_prefill_layer.cuh
    `lm_row`, the decode product: bf16 x by the levels, the group affine
    on the f32 sums). Fed the kernel's own row (`kernel_x_last`), it parts
    from the kernel's logits only by the order of the f32 sums (the K
    split and the splits' sum)."""
    return mk._stream_dot(x_last[None], packed, plan.lm, None)[0]


def chosen_experts(plan, logits: torch.Tensor) -> torch.Tensor:
    """The k experts each row of the router product [M, EP] routes to, in
    ascending order ([M, k] int64): `ops.megakernel.route`'s choice (k
    rounds of the largest softmax probability, the lowest lane on ties),
    which the kernel's gates phase writes to its `eidx` rows."""
    E = plan.E
    ml = logits[:, :E]
    p = torch.exp(ml - ml.max(-1, keepdim=True).values)
    p = p / p.sum(-1, keepdim=True)
    lane = torch.arange(E, device=logits.device)[None, :]
    idx = []
    for _ in range(plan.k_top):
        mi = p.max(-1, keepdim=True).values
        fl = torch.where(p >= mi, lane, E).min(-1, keepdim=True).values
        idx.append(fl)
        p = torch.where(lane == fl, torch.full_like(p, -1.0), p)
    return torch.cat(idx, 1).sort(1).values


def route_rows(eidx: torch.Tensor, E: int) -> Dict:
    """The kernel's routing phase, plain: from each prompt row's experts
    (eidx [n, k], ascending) the per-expert row counts [E], each expert's
    rows in ascending order, the slots: expert e's rows are the slots
    base[e] .. base[e] + counts[e] - 1, base[e] the counts of the experts
    before e each rounded up to SLOT_ALIGN and summed, slots [n, k] the slot
    of each (row, j); and the routed-row tiles of the expert products, in
    their item order (expert, then tile): (e, first slot, rows) with at
    most E_TILE rows each, an expert of no rows having none."""
    n, k = eidx.shape
    flat = eidx.reshape(-1).long().cpu()
    counts = torch.bincount(flat, minlength=E)[:E]
    padded = (counts + SLOT_ALIGN - 1) // SLOT_ALIGN * SLOT_ALIGN
    base = torch.cumsum(padded, 0) - padded
    rows = [torch.nonzero((eidx == e).any(1))[:, 0].cpu() for e in range(E)]
    slots = torch.empty((n, k), dtype=torch.int64)
    tiles = []
    for e in range(E):
        r = rows[e]
        j = (eidx[r] == e).long().argmax(1).cpu()
        slots[r, j] = base[e] + torch.arange(r.numel())
        tiles += [(e, int(base[e]) + t, min(E_TILE, r.numel() - t))
                  for t in range(0, r.numel(), E_TILE)]
    return dict(counts=counts, base=base, rows=rows, slots=slots,
                tiles=tiles)


def moe_routed(plan, x: torch.Tensor, layer: int, mm, n: int,
               routing: Optional[list] = None) -> torch.Tensor:
    """`ops.megakernel.moe_ref` as the kernel decomposes it, from x_norm
    [M, hid] bf16 and the kernel's product `mm(x, stream, layer, expert)`:
    the router product of every row; the experts of the n prompt rows
    (`chosen_experts`) laid out by `route_rows`; each routed-row tile's
    gate|up of its expert over its rows' x_norm, SwiGLU rounded to bf16 by
    slot, and down; then each prompt row's sum over its experts in
    ascending order of gate x down at its slot (a gate of 0 skipped), and
    the shared expert over every row. Rows >= n take no expert (the kernel
    leaves them out: no prompt row reads them). `routing`, a list, receives
    the layer's router product."""
    logits = mm(x, plan.rt, layer, None)
    gates, sg = mk.route(plan, logits)
    if routing is not None:
        routing.append(logits)
    eidx = chosen_experts(plan, logits[:n])
    r = route_rows(eidx, plan.E)
    dev = x.device
    slots = r["slots"].to(dev)
    cap = int(r["base"][-1] + r["counts"][-1])
    xe = x.new_zeros((cap, x.shape[1]))
    xe[slots.reshape(-1)] = x[:n].repeat_interleave(plan.k_top, 0)
    edn = torch.zeros((cap, plan.hid), dtype=torch.float32, device=dev)
    for e, s0, m in r["tiles"]:
        gu = mm(xe[s0:s0 + m], plan.gu, layer, e)
        g, u = gu[:, :plan.inter], gu[:, plan.inter:]
        act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
        edn[s0:s0 + m] = mm(act, plan.dn, layer, e)
    acc = torch.zeros((x.shape[0], plan.hid), dtype=torch.float32,
                      device=dev)
    for j in range(plan.k_top):
        w = gates[:n].gather(1, eidx[:, j:j + 1].to(dev))
        acc[:n] = torch.where(w == 0, acc[:n], acc[:n] + w * edn[slots[:, j]])
    if plan.has_shared:
        gu = mm(x, plan.sgu, layer, None)
        g, u = gu[:, :plan.shared_inter], gu[:, plan.shared_inter:]
        act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
        acc = acc + sg[:, None] * mm(act, plan.sdn, layer, None)
    return acc


def prefill_megakernel_ref(plan: PrefillPlan, packed: Dict, x0: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           page_row: torch.Tensor, n_tokens, cache: KVCache,
                           bf16_scores: bool = False,
                           routing: Optional[list] = None,
                           routed: bool = False,
                           forced_routing: Optional[torch.Tensor] = None,
                           resid_norms: Optional[list] = None
                           ) -> torch.Tensor:
    """The whole prefill, phase by phase (see `prefill_megakernel`), from
    the layer pieces above. Updates the pool in place; returns logits [V]
    f32 of token n-1. `bf16_scores`: see `prefill_attention_block_ref`. A
    MoE layer runs `ops.megakernel.moe_ref` on every row of the bucket with
    weight-side dequant (`routed`: `moe_routed`, the kernel's decomposition
    over the prompt rows' routed slots); `routing`, a list, receives each
    layer's router product; `forced_routing` [L, S, k_top] (expert ids, -1
    for none) routes each layer's rows to these experts instead
    (`ops.megakernel.moe_ref`'s `forced`); `resid_norms`, a list, receives
    the RMS of each row's residual entering each layer ([S] f32 a layer, as
    `ops.megakernel.decode_megakernel_ref`'s)."""
    inp = PrefillInputs(plan, cos, sin, page_row, n_tokens)
    resid = x0.to(torch.bfloat16).float()

    def mm(x_, sp, l_, e):
        return _wdeq_dot(x_, packed, sp, l_, e)

    for l in range(plan.L):
        if resid_norms is not None:
            resid_norms.append(resid.pow(2).mean(-1).sqrt())
        resid = resid + prefill_attention_block_ref(
            plan, packed, l, resid, inp, cache, bf16_scores)
        if plan.E:
            x = mk._rms(resid, packed["norms"][l, 1], plan.rms_eps).to(
                torch.bfloat16)
            forced = None if forced_routing is None else forced_routing[l]
            resid = resid + (
                moe_routed(plan, x, l, mm, inp.n, routing) if routed else
                mk.moe_ref(plan, x, l, mm, routing, forced))
            continue
        resid = resid + prefill_mlp_block_ref(plan, packed, l, resid)
    return prefill_lm_ref(plan, packed, resid, inp.n)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

# order of the integer arguments of di_prefill_megakernel
# (csrc/prefill_megakernel.cu IArg)
_IARGS = ("norms", "final_norm", "qkv_b", "x0", "cos", "sin", "page_row",
          "n_tokens", "k_pool", "v_pool", "k_qp", "v_qp", "logits", "resid",
          "xn", "partial", "qb", "kb", "vb", "attn", "act", "x_last",
          "tickets", "barrier", "status", "edn", "acc", "gates", "sgate",
          "xe", "eidx", "eslot", "ecount", "launches", "trace", "S", "L",
          "hid", "H", "KH", "inter", "V", "ps", "maxPb", "kv_kind", "ql",
          "grid", "E", "k_top", "norm_topk", "has_shared", "has_sgate",
          "shared_inter", "EP", "scap", "qk_norm", "slopes")
_P, _I = mk._P, mk._I

# the kernel's phases, in order, each followed by a grid barrier
LAYER_PHASES = ("norm1", "qkv", "rope_kv", "attention", "o", "norm2",
                "gate_up", "swiglu", "down")
TAIL_PHASES = ("final_norm", "lm_head")
# a MoE layer: the router, the gates, the routing of the prompt rows to
# their experts' slots, the experts' gate|up, SwiGLU and down over those
# slots, then their gated sum with the shared expert's gate|up, its SwiGLU
# and its down
MOE_HEAD_PHASES = LAYER_PHASES[:6] + ("router", "gates", "route")
MOE_EXPERT_PHASES = ("expert_gate_up", "expert_swiglu", "expert_down",
                     "moe_sum")


def _phase_names(plan: "PrefillPlan") -> Tuple[str, ...]:
    if not plan.E:
        return LAYER_PHASES * plan.L + TAIL_PHASES
    layer = MOE_HEAD_PHASES + MOE_EXPERT_PHASES + \
        (("shared_swiglu", "shared_down") if plan.has_shared else ())
    return layer * plan.L + TAIL_PHASES


def choose_split(tiles: int, chunks: int, mtiles: int,
                 grid: int) -> Tuple[int, int]:
    """K split of one product: (ksplit, chunks per split). An item is one
    (256-column tile, split, 128-row tile); a block walks its items one
    after the other. The cost of a split, in chunk times on the slowest
    block: waves x (chunks of an item + the pipeline's fill and the
    epilogue, which with a split also writes partial sums that the next
    phase reads back)."""
    best = None
    for ks in range(1, chunks + 1):
        cps = -(-chunks // ks)
        if -(-chunks // cps) != ks:
            continue
        items = tiles * ks * mtiles
        cost = -(-items // grid) * (cps + (8 if ks > 1 else 4))
        if best is None or cost < best[0]:
            best = (cost, ks, cps)
    return best[1], best[2]


# chunk times an item of the one-row product costs beyond its chunks (the
# ring's fill and drain, the epilogue, a split's partial sums and ticket):
# fitted to the lm segment's times on one block an SM at 1 .. 14 splits
# (PERF.md §6, the one-row lm_head; `tools/ab_decode.py --lm-splits`
# times them)
ROW_ITEM_CHUNKS = 5


def choose_row_split(tiles: int, chunks: int, grid: int,
                     per_sm: int = 1) -> Tuple[int, int]:
    """K split of the lm_head's one-row product (di_prefill_layer.cuh
    `lm_row`): (ksplit, chunks per split). An item is one (256-column tile,
    split), dealt round the grid, `per_sm` blocks on an SM, which share its
    bandwidth: the cost of a split, in chunk times on the busiest SM, is
    the items the SM streams x (chunks of an item + ROW_ITEM_CHUNKS). Ties
    go to the fewer splits. Qwen2-7B's whole vocab (the prefill
    megakernel's lm_head, 132 blocks): 594 tiles x 2 splits of 28 chunks,
    9 items an SM; its n = 2 shard (the TP lm segment, two blocks an SM):
    297 x 2 of 28 (5 x 33 chunk times an SM), where 4 splits of 14 would
    fill whole waves at 9 x 19."""
    sms = max(1, grid // per_sm)
    best = None
    for ks in range(1, chunks + 1):
        cps = -(-chunks // ks)
        if -(-chunks // cps) != ks:
            continue
        cost = -(-tiles * ks // sms) * (cps + ROW_ITEM_CHUNKS)
        if best is None or cost < best[0]:
            best = (cost, ks, cps)
    return best[1], best[2]


# the kernel's scratch buffers (flat; IArg names of the same spelling)
_SCRATCH_DTYPES = dict(
    partial=torch.float32, resid=torch.float32, xn=torch.bfloat16,
    qb=torch.bfloat16, kb=torch.bfloat16, vb=torch.bfloat16,
    attn=torch.bfloat16, act=torch.bfloat16, x_last=torch.bfloat16,
    barrier=torch.int32, status=torch.int32, edn=torch.float32,
    acc=torch.float32, gates=torch.float32, sgate=torch.float32,
    xe=torch.bfloat16, eidx=torch.int32, eslot=torch.int32,
    ecount=torch.int32, tickets=torch.int32)


class _Launch:
    """Per (plan, device) launch geometry of the kernel: grid, K splits and
    what the plan needs of the device's scratch (elements per buffer)."""

    def __init__(self, plan: PrefillPlan, dev: torch.device):
        gaps = cuda_kernel_gaps(plan)
        if gaps:
            raise ValueError("prefill_megakernel: " + "; ".join(gaps))
        lib = kernel_build.load("prefill_megakernel")
        self.fn = kernel_build.function(
            "prefill_megakernel", "di_prefill_megakernel", [_P, _P, _P])
        grid_fn = lib.di_prefill_megakernel_grid
        grid_fn.argtypes, grid_fn.restype = [_I], _I
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        self.grid = grid_fn(idx)
        if self.grid <= 0:
            raise RuntimeError("prefill_megakernel: the kernel does not fit "
                               "on the device (occupancy query gave 0)")
        mtiles = plan.S // M_TILE
        self.splits = {}
        for sp in plan.streams:
            if sp.name == "lm":
                self.splits[sp.name] = choose_row_split(
                    sp.Nptot // 256, sp.K // mk.CHUNK_K, self.grid)
            else:
                # an expert stream's row tiles: those of a full bucket's
                # routed slots
                self.splits[sp.name] = choose_split(
                    sp.Nptot // 256, sp.K // mk.CHUNK_K,
                    routed_tiles(plan) if sp.E else mtiles, self.grid)
        self.need = scratch_need(plan, self.splits)

    def scratch_bytes(self) -> int:
        return sum(n * _SCRATCH_DTYPES[k].itemsize
                   for k, n in self.need.items())


def slot_capacity(plan: PrefillPlan) -> int:
    """Routed slots a MoE launch's scratch holds: the S x k (row, expert)
    pairs of a full bucket, each expert's first slot rounded up to
    SLOT_ALIGN, and an expert tile's reach past the last slot, in whole
    64-row groups (0 for a dense plan)."""
    if not plan.E:
        return 0
    need = plan.S * plan.k_top + SLOT_ALIGN * plan.E + E_TILE
    return -(-need // 64) * 64


def routed_tiles(plan: PrefillPlan) -> int:
    """Routed-row tiles of a full bucket's expert products when its rows
    spread over the experts: the S x k slots in E_TILE tiles, and a ragged
    last tile an expert (the K splits of the expert streams are chosen
    for it)."""
    return -(-plan.S * plan.k_top // E_TILE) + plan.E


def scratch_need(plan: PrefillPlan, splits: Dict,
                 resid: bool = True) -> Dict[str, int]:
    """Elements of each scratch buffer a launch of `plan` with these K
    splits needs; `resid`: the f32 residual in the scratch (the whole-model
    kernel's; a TP segment updates its rank's own). A MoE plan's experts
    work over the routed slots (`slot_capacity`): their x_norm, gate|up
    partials, SwiGLU activation and down partials are by slot, so they
    grow with n x k and not with the experts. The lm_head's K splits
    (`choose_row_split`) write their partial sums into `partial` too, after
    the last layer's are read, and count on one ticket a 256-column tile."""
    S = plan.S
    HD, KD = plan.H * plan.D, plan.KH * plan.D
    scap = slot_capacity(plan)
    parts = [splits[sp.name][0] * (scap if sp.E else S) * sp.Nptot
             for sp in plan.layer_streams if sp.name != "dn" or not plan.E]
    parts.append(splits["lm"][0] * plan.lm.Nptot)
    need = dict(
        partial=max(parts), xn=S * plan.hid, qb=S * HD, kb=S * KD,
        vb=S * KD, attn=S * HD,
        act=max(S * plan.shared_inter,
                (scap if plan.E else S) * plan.inter),
        x_last=plan.hid // mk.CHUNK_K * ROW_RECORD_BYTES // 2,   # bf16
        tickets=plan.lm.Nptot // 256, barrier=1, status=1)
    if resid:
        need["resid"] = S * plan.hid
    if plan.E:
        need.update(edn=splits["dn"][0] * scap * plan.hid,
                    acc=S * plan.hid, gates=plan.L * S * plan.EP,
                    sgate=plan.L * S, xe=scap * plan.hid,
                    eidx=S * mk.MAX_TOPK, eslot=S * mk.MAX_TOPK,
                    ecount=plan.L * plan.E)
    return need


class _Scratch:
    """One device's scratch. Prefills run one after the other on one stream,
    so every bucket's launches share ONE set of flat buffers, each as large
    as the largest plan seen so far needs: the kernel strides them by the
    launch's own S. The TP prefill segments (ops/tp_megakernel.py) of every
    rank on the device use the same set: their launches run one after the
    other too, and what one segment leaves for the all-reduce is a tensor of
    its rank's, not scratch. A buffer is zeroed when it is allocated (the
    tickets must start at 0, and each launch leaves them so; rows 1.. of
    x_last's records stay zero; the rest is written before it is read)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.bufs: Dict[str, torch.Tensor] = {}

    def fit(self, need: Dict[str, int]) -> None:
        for name, n in need.items():
            t = self.bufs.get(name)
            if t is not None and t.numel() >= n:
                continue
            if self.dev.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "prefill_megakernel: the scratch of a plan must be "
                    "reserved (or its first launch made) outside CUDA graph "
                    "capture")
            self.bufs[name] = torch.zeros(n, dtype=_SCRATCH_DTYPES[name],
                                          device=self.dev)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.bufs.values())


_launches: Dict = {}      # (plan, device) -> _Launch
_scratch: Dict = {}       # device -> _Scratch


def device_scratch(dev: torch.device, need: Dict[str, int]) -> _Scratch:
    """The device's one scratch set, grown to `need`."""
    sc = _scratch.get(dev)
    if sc is None:
        sc = _scratch[dev] = _Scratch(dev)
    sc.fit(need)
    return sc


def _launch_state(plan: PrefillPlan, dev: torch.device):
    """(geometry, scratch) of a launch of `plan`, the scratch grown to it."""
    key = (plan, dev)
    st = _launches.get(key)
    if st is None:
        st = _launches[key] = _Launch(plan, dev)
    return st, device_scratch(dev, st.need)


def reserve_scratch(plans, device) -> int:
    """Builds the kernel and allocates the device's scratch for the largest
    of `plans` now (an installer calls this before it sizes the KV pool from
    free memory). Returns the scratch bytes on the device."""
    dev = mk._indexed(device)
    for plan in plans:
        _launch_state(plan, dev)
    return scratch_bytes(dev)


def scratch_bytes(device) -> int:
    """Bytes of prefill scratch the device holds now."""
    sc = _scratch.get(mk._indexed(device))
    return sc.nbytes() if sc else 0


def release_scratch(device) -> None:
    """Frees the device's scratch; a later launch allocates it anew."""
    _scratch.pop(mk._indexed(device), None)


def kernel_gates(plan: PrefillPlan, device) -> torch.Tensor:
    """The gates of the device's last MoE launch of `plan` (f32 [L, S, E],
    0 where a row is not routed to an expert)."""
    sc = _scratch[mk._indexed(device)]
    return sc.bufs["gates"][:plan.L * plan.S * plan.EP].reshape(
        plan.L, plan.S, plan.EP)[..., :plan.E]


def kernel_routing(plan: PrefillPlan, n: int, device) -> torch.Tensor:
    """The experts the device's last MoE launch of `plan` routed each of
    its n prompt rows to, in each layer ([L, S, k_top] int64, ascending;
    -1 for the rows from n on): `prefill_megakernel_ref`'s
    `forced_routing`."""
    g = kernel_gates(plan, device)
    out = torch.full((plan.L, plan.S, plan.k_top), -1, dtype=torch.int64,
                     device=g.device)
    out[:, :n] = g[:, :n].topk(plan.k_top, dim=-1).indices.sort(-1).values
    return out


def kernel_counts(plan: PrefillPlan, device) -> torch.Tensor:
    """The prompt rows the device's last MoE launch of `plan` routed to
    each expert in each layer (int32 [L, E]: the rows its expert products
    ran over)."""
    sc = _scratch[mk._indexed(device)]
    return sc.bufs["ecount"][:plan.L * plan.E].reshape(plan.L, plan.E)


def kernel_x_last(plan: PrefillPlan, device) -> torch.Tensor:
    """The final-normed bf16 row [hid] the device's last launch of a
    kernel's lm_head (`plan`'s: the prefill megakernel or a TP lm segment)
    left in x_last's records (csrc/di_product.cuh `write_record`, row 0 of
    each 64-row chunk's m16 tile): `lm_row_ref`'s input."""
    sc = _scratch[mk._indexed(device)]
    chunks = plan.hid // mk.CHUNK_K
    rec = sc.bufs["x_last"][:chunks * ROW_RECORD_BYTES // 2].reshape(
        chunks, ROW_RECORD_BYTES // 2)
    # element k of a chunk: lane k // 2's bf16 pair, k16 step s = k // 16,
    # (tig, khalf) from k % 16, at ((s * 32 + tig) * 16 + 8 * khalf) bytes
    k = torch.arange(mk.CHUNK_K)
    kk = k % 16
    idx = (k // 16 * 32 + (kk % 8) // 2) * 8 + 4 * (kk // 8) + k % 2
    return rec[:, idx.to(rec.device)].reshape(plan.hid)


def check_status(device, who: str = "prefill_megakernel") -> None:
    """Waits for the device and raises if a launch on it that uses the
    device's prefill scratch (`who`: the kernel named in the error) gave up
    at a grid barrier (blocks that never became co-resident) or at a wait
    of a product's copy ring."""
    sc = _scratch.get(mk._indexed(device))
    if sc is None or "status" not in sc.bufs:
        return
    code = int(sc.bufs["status"].item())
    if code:
        # a launch that gave up may leave the barrier or tickets counted
        for name in ("status", "barrier", "tickets"):
            if name in sc.bufs:
                sc.bufs[name].zero_()
        raise RuntimeError(f"{who}: {mk.status_fault(code)}")


def launch_geometry(plan: PrefillPlan, device) -> Dict:
    """Grid and K splits of this plan's launches, the scratch bytes the
    plan needs and those the device holds for all its plans."""
    st, sc = _launch_state(plan, mk._indexed(device))
    return dict(grid=st.grid, splits=dict(st.splits),
                routed_slots=slot_capacity(plan),
                scratch_bytes=st.scratch_bytes(),
                device_scratch_bytes=sc.nbytes())


def prefill_megakernel(plan: PrefillPlan, packed: Dict, x0: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       page_row: torch.Tensor, n_tokens: torch.Tensor,
                       cache: KVCache,
                       trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One whole fresh prefill of a bucket.

    x0 [S, hid] bf16: the embedded prompt, padded to the bucket; cos/sin
    [S, D] bf16: the full-D RoPE tiles of positions 0..S-1; page_row
    [maxPb] int32: the PHYSICAL base row `g * L` of each logical page g the
    request owns (layer l's page is base + l); n_tokens: int32 tensor with
    one element, the prompt length n (1 <= n <= S); cache: the pool,
    updated in place at rows `< n` of the owned pages. Returns logits [V]
    f32 of token n-1. CPU tensors take `prefill_megakernel_ref`; CUDA
    tensors launch the kernel or raise. Nothing is read back, and the
    device's one scratch set is allocated at `reserve_scratch` or at the
    first launch of a larger plan. `trace` (int64 [trace_len(plan)] on
    the card) receives block 0's timestamps: see `phase_times`."""
    if x0.device.type == "cpu":
        return prefill_megakernel_ref(plan, packed, x0, cos, sin, page_row,
                                      n_tokens, cache)
    if not x0.is_cuda:
        raise ValueError(f"prefill_megakernel: unsupported device "
                         f"{x0.device}")
    dev = x0.device
    S = plan.S
    for name, t, dt, shape in (
            ("x0", x0, torch.bfloat16, (S, plan.hid)),
            ("cos", cos, torch.bfloat16, (S, plan.D)),
            ("sin", sin, torch.bfloat16, (S, plan.D)),
            ("page_row", page_row, torch.int32, (plan.maxPb,)),
            ("norms", packed["norms"], torch.float32, (plan.L, 2, plan.hid)),
            ("final_norm", packed["final_norm"], torch.float32,
             (plan.hid,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"prefill_megakernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"contiguous {dt} {shape} on {dev}")
    if not isinstance(n_tokens, torch.Tensor) or n_tokens.numel() != 1 or \
            n_tokens.dtype != torch.int32 or n_tokens.device != dev:
        raise ValueError("prefill_megakernel: n_tokens must be an int32 "
                         f"tensor with one element on {dev}")
    kv_dt = getattr(torch, plan.kv_dtype_name)
    Ds = plan.D // 2 if plan.kv_bits == 4 else plan.D
    quant = plan.kv_bits != 16
    for t in (cache.k, cache.v):
        if t.dtype != kv_dt or t.shape[1:] != (plan.ps, plan.KH * Ds) or \
                t.device != dev or not t.is_contiguous():
            raise ValueError("prefill_megakernel: pool "
                             f"{t.dtype} {tuple(t.shape)} for {plan.kv_mode}")
    if quant and (cache.k_qparams is None or
                  cache.k_qparams.shape[1] != 2 * plan.KH or
                  cache.k_qparams.dtype != torch.float32):
        raise ValueError("prefill_megakernel: pool qparams missing or "
                         "misshaped")
    if packed["qkv_b"] is not None and \
            tuple(packed["qkv_b"].shape) != (plan.L, plan.QKVN):
        raise ValueError("prefill_megakernel: qkv_b shape")
    if trace is not None and (
            trace.dtype != torch.int64 or trace.device != dev or
            trace.numel() < trace_len(plan) or not trace.is_contiguous()):
        raise ValueError("prefill_megakernel: trace must be contiguous int64 "
                         f"[{trace_len(plan)}] on {dev}")
    st, sc = _launch_state(plan, dev)
    buf = sc.bufs
    logits = torch.empty((plan.V,), dtype=torch.float32, device=dev)
    vals = dict(
        norms=packed["norms"].data_ptr(),
        final_norm=packed["final_norm"].data_ptr(),
        qkv_b=0 if packed["qkv_b"] is None else packed["qkv_b"].data_ptr(),
        x0=x0.data_ptr(), cos=cos.data_ptr(), sin=sin.data_ptr(),
        page_row=page_row.data_ptr(), n_tokens=n_tokens.data_ptr(),
        k_pool=cache.k.data_ptr(), v_pool=cache.v.data_ptr(),
        k_qp=cache.k_qparams.data_ptr() if quant else 0,
        v_qp=cache.v_qparams.data_ptr() if quant else 0,
        logits=logits.data_ptr(),
        **{k: buf[k].data_ptr() if k in buf else 0 for k in _SCRATCH_DTYPES},
        launches=prefill_megakernel.counter.pointer(dev),
        trace=0 if trace is None else trace.data_ptr(),
        S=S, L=plan.L, hid=plan.hid, H=plan.H, KH=plan.KH, inter=plan.inter,
        V=plan.V, ps=plan.ps, maxPb=plan.maxPb,
        kv_kind=mk._KV_KIND[plan.kv_dtype_name],
        ql=cache.k_qparams.shape[2] if quant else 0, grid=st.grid,
        E=plan.E, k_top=plan.k_top, norm_topk=int(plan.norm_topk),
        has_shared=int(plan.has_shared), has_sgate=int(plan.has_shared_gate),
        shared_inter=plan.shared_inter, EP=plan.EP,
        scap=slot_capacity(plan),
        qk_norm=mk.qk_norm_arg(plan, packed, dev, "prefill_megakernel"),
        slopes=mk.slopes_arg(plan, packed, dev, "prefill_megakernel"))
    ia = [vals[k] for k in _IARGS]
    ia += mk.packed_stream_args(plan, packed, st.splits, dev,
                                "prefill_megakernel", lm_valid=plan.V)
    ia_arr = np.asarray(ia, np.int64)
    fa_arr = np.asarray([plan.rms_eps, 1.0 / math.sqrt(plan.D)], np.float64)
    rc = st.fn(ia_arr.ctypes.data, fa_arr.ctypes.data,
               kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"prefill_megakernel launch failed: CUDA error "
                           f"{rc}")
    return logits


prefill_megakernel.counter = kernel_build.LaunchCounter()


def trace_len(plan: PrefillPlan) -> int:
    """Timestamps a trace buffer must hold."""
    return 2 * len(_phase_names(plan)) + 1


def phase_times(plan: PrefillPlan, trace: torch.Tensor) -> Dict[str, Dict]:
    """A traced launch's time by phase kind, summed over the layers, in ms
    (`ops.megakernel.phase_times`' layout: work, then wait at the grid
    barrier, from block 0's timestamps)."""
    names = _phase_names(plan)
    return mk.phase_times_of(names, trace[:2 * len(names) + 1])
