"""Tensor parallelism: the per-rank split of the weights, the local plan,
the four decode segment kernels and the three prefill segment kernels of
one rank.

Counterpart of `dashinfer_tpu.ops.pallas.tp_megakernel`.
The whole-model decode megakernel adds the residual between layers inside
one launch, which a model axis cannot do: after the o product and after the
down product the ranks' partial sums must be summed first. So each layer is
cut there into two segment launches a rank, with an all-reduce after each:

  for each layer l:
    attn segment: x += add; rms1 -> q|k|v (column share) -> RoPE -> new-token
                  KV write into the rank's pool -> attention over the rank's
                  KV heads -> o (row share)          => o partial [B, hid] f32
    add = all_reduce(o partials)
    mlp segment:  x += add; rms2 -> gate|up (column share) -> SwiGLU -> down
                  (row share)                        => down partial
    add = all_reduce(down partials)
  lm segment:     x += add; final rms -> lm_head over the rank's vocab shard
  logits = gather of the shards

A MoE layer (Qwen1.5/2-MoE) runs the moe segment in place of the mlp one:
x += add; rms2 -> the router product over the GLOBAL router (every rank
holds it whole) -> softmax, top-k and the shared gate over all experts,
recorded (`kernel_routing`) -> the rank's experts that some active row
routes to (its contiguous group of E/n, the reference EPSPLIT) and its
slice of the shared expert (split as the dense MLP) => moe partial.

The JAX package adds `psum(partial)` to x between its segments; here each
segment adds the reduced partial of the one before to its rank's f32
residual x in its first phase (the same sum, without an add kernel of its
own after each all-reduce).

The split follows the reference WeightSplitter, as the JAX function does:
column split of q/k/v/gate/up (and their bias), row split of o/down (a
row-split bias on rank 0 only), vocab split of lm_head; per-channel qparams
(one group) replicate on the row split, group-wise ones follow the rows. It
works on the port's tensors, on their device, and gives leaves bit-equal to
the JAX `split_params_tp` of the same numpy tree. Each rank's plan and pack
are the port's `make_plan` / `pack_params` on `local_config`, so the pack's
fragment order and its padding of widths of 128 mod 256 come with them.

`attn_segment_ref`, `mlp_segment_ref`, `moe_segment_ref`, `lm_segment_ref`
and `tp_decode_ref` are the plain PyTorch versions (the decode megakernel's
plain pieces); the wrappers `tp_attn_segment`, `tp_mlp_segment`,
`tp_moe_segment`, `tp_lm_segment` take them for CPU tensors and launch
csrc/tp_segments.cu for CUDA tensors, or raise.

A fresh prompt of a bucket 128 .. 1024 is prefilled the same way
(`tp_prefill`, the counterpart of the JAX `build_tp_prefill_fn`): per layer
every rank's prefill attn segment (the prefill megakernel's RMSNorm, q|k|v,
RoPE + K/V write of the prompt rows, causal attention and o product over
the rank's heads => o partial [S, hid] f32), an all-reduce, every rank's
prefill mlp segment (=> down partial), an all-reduce; then every rank's
prefill lm segment (row n - 1: final norm, lm_head over the vocab shard)
and the gather. `supports_prefill_tp` and `make_tp_prefill_plans` (local
`PrefillPlan`s that adopt the TP decode plan's streams, so the segments
read each rank's TP decode pack: no third copy of the payloads, where the
JAX package packs its TP prefill apart); the plain versions
`prefill_attn_segment_ref`, `prefill_mlp_segment_ref`,
`prefill_lm_segment_ref` and `tp_prefill_ref` (the prefill megakernel's
plain pieces); the wrappers `tp_prefill_attn_segment`,
`tp_prefill_mlp_segment`, `tp_prefill_lm_segment` over
csrc/tp_prefill_segments.cu, whose scratch is the device's one prefill
scratch set (ops/prefill_megakernel.py). A MoE model takes no TP prefill
segment (`supports_prefill_tp`): it prefills per-op TP.
"""

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.config import ModelConfig, RuntimeConfig
from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
from dashinfer_tpu_torch.ops.moe import first_expert, rank_moe
from dashinfer_tpu_torch.ops.u4pack import pack_u4_weight, unpack_u4_weight
from dashinfer_tpu_torch.parallel.collectives import (all_gather_vocab,
                                                      all_reduce_)
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

# ---------------------------------------------------------------------------
# per-rank split of the raw params (reference WeightSplitter semantics)
# ---------------------------------------------------------------------------

_COL_SPLIT = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_SPLIT = ("o_proj", "down_proj")
# per-head [L, D] weights (Qwen3's QK-norm): the same for every head, so
# whole on every rank
_REPLICATED = ("q_norm", "k_norm")


def _share(a: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """Rank r's 1/n of `a` along `dim` (rows r*N//n .. (r+1)*N//n, as the
    JAX function slices), as a contiguous tensor."""
    N = a.shape[dim]
    return a.narrow(dim, r * N // n, (r + 1) * N // n - r * N // n
                    ).contiguous()


def _slice_u4_cols(w_q: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's share of the UNPACKED out dim of a u4 weight [..., K, N/2]
    (ops/u4pack.py layouts). A share of whole 256-column tiles is a slice
    of the packed bytes; any other is unpacked, sliced and repacked in the
    layout of its own width."""
    N = w_q.shape[-1] * 2
    Nl = N // n
    if N % 256 == 0 and Nl % 256 == 0:
        return _share(w_q, -1, n, r)
    lead, K = tuple(w_q.shape[:-2]), w_q.shape[-2]
    flat = w_q.reshape(-1, K, N // 2)
    out = torch.stack([
        pack_u4_weight(unpack_u4_weight(m)[:, r * Nl:(r + 1) * Nl])
        for m in flat])
    return out.reshape(lead + (K, Nl // 2))


def _split_leaf(name: str, leaf, n: int, r: int):
    """One `layers` leaf (stacked [L, ...]) -> rank r's share."""
    if name in _REPLICATED:
        return leaf
    col = any(k in name for k in _COL_SPLIT)
    row = any(k in name for k in _ROW_SPLIT)
    if not (col or row):
        return leaf                          # norms: replicated
    if not isinstance(leaf, dict):
        return _share(leaf, -1 if col else -2, n, r)
    out = {}
    for k, a in leaf.items():
        if k == "b":
            # a row-split bias is added once, on rank 0 (the reference
            # zeroes it on the other ranks, weight_splitter.cpp:425)
            out[k] = _share(a, -1, n, r) if col else (
                a if r == 0 else torch.zeros_like(a))
        elif k in ("w", "w_q8", "w_q"):
            if not col:
                out[k] = _share(a, -2, n, r)
            elif k == "w_q" and a.dtype == torch.uint8:
                out[k] = _slice_u4_cols(a, n, r)
            else:
                out[k] = _share(a, -1, n, r)
        elif k in ("scale", "zero"):         # [L, G, N]
            if col:
                out[k] = _share(a, -1, n, r)
            elif a.shape[-2] == 1:
                out[k] = a                   # per-channel: every rank's rows
            else:
                out[k] = _share(a, -2, n, r)
        else:
            out[k] = a
    return out


def _slice_experts(leaf, n: int, r: int):
    """An expert stack [L, E, ...] (or its quantized dict) -> rank r's
    contiguous group of E/n experts (the reference EPSPLIT; the JAX
    `_slice_experts`)."""
    if isinstance(leaf, dict):
        return {k: _share(a, 1, n, r) for k, a in leaf.items()}
    return _share(leaf, 1, n, r)


def _split_rank(params: Dict, cfg: ModelConfig, n: int, r: int) -> Dict:
    """Rank r's share of the raw params. A MoE layer's experts go to the
    ranks in contiguous groups, its shared expert splits as the dense MLP
    (column gate|up, row down), and the router and the shared expert's gate
    stay whole on every rank: every rank routes over all experts. (The JAX
    `_split_rank` slices the router too and its `make_tp_plan` puts the
    global one back in the pack; the per-op path here reads it from the
    tree.)"""
    lp = {}
    for k, v in params["layers"].items():
        if k == "experts":
            lp[k] = {nm: _slice_experts(lf, n, r) for nm, lf in v.items()}
        elif k == "shared_expert":
            lp[k] = {nm: _split_leaf(nm, lf, n, r) for nm, lf in v.items()}
        elif k in ("router", "shared_expert_gate"):
            lp[k] = v
        else:
            lp[k] = _split_leaf(k, v, n, r)
    lm = params.get("lm_head")
    if lm is None or cfg.tie_word_embeddings:
        lm = {"w": params["embed_tokens"]["w"].t()}
    lm_r = {}
    for k, a in lm.items():
        if k == "w_q" and a.dtype == torch.uint8:
            lm_r[k] = _slice_u4_cols(a, n, r)
        else:        # w / w_q int8 [hid, V]; scale / zero [G, V]
            lm_r[k] = _share(a, -1, n, r)
    out = {"embed_tokens": params["embed_tokens"], "norm": params["norm"],
           "lm_head": lm_r, "layers": lp}
    if "embed_norm" in params:
        out["embed_norm"] = params["embed_norm"]
    return out


def split_params_tp(params: Dict, cfg: ModelConfig, n: int) -> List[Dict]:
    """Raw params -> n per-rank trees, on the params' device."""
    return [_split_rank(params, cfg, n, r) for r in range(n)]


def local_config(cfg: ModelConfig, n: int) -> ModelConfig:
    """The config one rank computes: 1/n of the heads, KV heads, MLP width
    and vocab; of a MoE model's experts and shared expert width
    (`ops.moe.rank_moe`)."""
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n,
        num_kv_heads=cfg.num_kv_heads // n,
        intermediate_size=cfg.intermediate_size // n,
        vocab_size=cfg.vocab_size // n, tie_word_embeddings=False,
        moe=None if cfg.moe is None else rank_moe(cfg.moe, n))


def supports_tp(cfg: ModelConfig, rt: RuntimeConfig, params: Dict, n: int,
                local: Optional[Dict] = None) -> bool:
    """Whether a model decodes through the segments on a model axis of n:
    the JAX rules (RoPE or ALiBi; heads, KV heads, MLP width and vocab divisible by n; a
    dense model's rank MLP width a multiple of 128; a MoE model's experts
    divisible by n and its shared expert's rank width a multiple of 128;
    group sizes of the row-split leaves, the shared expert's down among
    them, dividing among the ranks, or one group) and the port's `supports`
    on the local config. The JAX `supports` also refuses a UINT4 pool whose
    rank holds fewer than 128 K/V lanes (KH/n * D/2), a Mosaic tiling rule
    of its RMW merge; the port's kernel writes a token's bytes where they
    go, and its pool keeps QL = page_size, so like the port's `supports`
    this keeps no such rule. `local`: rank 0's split tree when the caller
    has it (only shapes are read)."""
    if n < 2:
        return False
    if cfg.position_embedding.value not in ("rope", "alibi"):
        return False
    if (cfg.num_heads % n or cfg.num_kv_heads % n or
            cfg.intermediate_size % n or cfg.vocab_size % n):
        return False
    moe = cfg.moe
    if moe is None and (cfg.intermediate_size // n) % 128:
        return False
    if moe is not None:
        sh = moe.shared_expert_intermediate_size
        if moe.num_experts % n or (sh and (sh % n or (sh // n) % 128)):
            return False
    view = mk.weight_only_decode_view(params)
    if view is None:
        return False
    lp = view["layers"]
    row = [lp.get("o_proj")] + ([lp.get("down_proj")] if moe is None else
                                [lp.get("shared_expert", {}).get(
                                    "down_proj")])
    for leaf in row:
        if isinstance(leaf, dict) and "scale" in leaf:
            G = leaf["scale"].shape[1]
            if G != 1 and G % n:
                return False
    if local is None:
        local = _split_rank(_as_tensors(view), cfg, n, 0)
    return mk.supports(local_config(cfg, n), rt, local)


def _as_tensors(tree):
    """numpy leaves (ml_dtypes bf16 too) as CPU tensors, without a copy;
    tensor leaves as they are."""
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    a = np.ascontiguousarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def make_tp_plan(cfg: ModelConfig, rt: RuntimeConfig, parts: Sequence[Dict]):
    """(the local MegaPlan, one pack a rank) from the ranks' split trees,
    each packed on its own device. A MoE plan's experts are the rank's
    (`E`), its router the global one over `E_global` experts, packed on
    every rank as [L, hid, EP] bf16 with EP = the experts and the shared
    expert's gate lane rounded up to 128 (the gate at lane E_global), as
    the JAX `make_tp_plan` packs `router_w`. An ALiBi plan's `slopes` are
    each rank's slice of the GLOBAL table, heads r * H/n .. (r + 1) * H/n
    (the local pack's `alibi_slopes(H/n)` would be another table), as the
    JAX `make_tp_plan` replaces them."""
    n = len(parts)
    cfg_l = local_config(cfg, n)
    plan = mk.make_plan(cfg_l, rt, parts[0])
    if plan.E:
        E_g = cfg.moe.num_experts
        EP = -(-(E_g + int(plan.has_shared)) // 128) * 128
        plan = dataclasses.replace(
            plan, E_global=E_g, EP=EP,
            rt=mk.StreamPlan("rt", ("router",), 16, plan.hid, (EP,), 0))
    packs = [mk.pack_params(cfg_l, plan, p) for p in parts]
    if plan.alibi:
        glob = mk.alibi_slopes(cfg.num_heads)
        for r, pk in enumerate(packs):
            pk["slopes"] = glob[r * plan.H:(r + 1) * plan.H].to(
                pk["norms"].device)
    return plan, packs


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------

def attn_segment_ref(plan: mk.MegaPlan, packed: Dict, layer: int,
                     x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     page_tables: torch.Tensor, lens: torch.Tensor,
                     active: torch.Tensor, cache: KVCache,
                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's attention segment of one rank (see `tp_attn_segment`)."""
    if add is not None:
        x.add_(add)
    inp = mk.StepInputs(plan, cos, sin, page_tables, lens, active)
    return mk.attention_block_ref(plan, packed, layer, x, inp, cache)


def mlp_segment_ref(plan: mk.MegaPlan, packed: Dict, layer: int,
                    x: torch.Tensor,
                    add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's MLP segment of one rank (see `tp_mlp_segment`)."""
    if add is not None:
        x.add_(add)
    return mk.mlp_block_ref(plan, packed, layer, x)


def moe_segment_ref(plan: mk.MegaPlan, packed: Dict, layer: int,
                    x: torch.Tensor, rank: int,
                    add: Optional[torch.Tensor] = None,
                    routing: Optional[list] = None,
                    forced_routing: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One MoE layer's MLP segment of rank `rank` (see `tp_moe_segment`):
    the decode megakernel's plain MoE block (`ops.megakernel.moe_ref`)
    routed over all experts and run over the rank's. `routing`, a list,
    receives the layer's router product [B, EP] f32; `forced_routing` [B,
    k_top] routes each row to those (global) experts instead."""
    if add is not None:
        x.add_(add)
    xn = mk._rms(x, packed["norms"][layer, 1], plan.rms_eps).to(
        torch.bfloat16)
    return mk.moe_ref(
        plan, xn, layer,
        lambda x_, sp, l_, e: mk._stream_dot(x_, packed, sp, l_, e),
        routing, forced_routing, first_expert=first_expert(rank, plan.E))


def lm_segment_ref(plan: mk.MegaPlan, packed: Dict, x: torch.Tensor,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The lm segment of one rank (see `tp_lm_segment`)."""
    if add is not None:
        x.add_(add)
    return mk.lm_head_ref(plan, packed, x)


def tp_decode(plan: mk.MegaPlan, packs: Sequence[Dict], x0: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor,
              page_tables: torch.Tensor, lens: torch.Tensor,
              active: torch.Tensor, caches: Sequence[KVCache],
              devices: Sequence[torch.device],
              plain: bool = False, routing: Optional[list] = None,
              forced_routing: Optional[torch.Tensor] = None,
              resid_norms: Optional[list] = None) -> torch.Tensor:
    """The whole TP decode forward over the ranks on `devices`: per layer
    every rank's attn segment, an all-reduce, every rank's mlp segment (a
    MoE model's moe segment), an all-reduce; then every rank's lm segment
    and the gather. x0 [B, hid] bf16 (the embedded tokens) and the step
    inputs (as `decode_megakernel` takes them) live on rank 0's device;
    `caches`: each rank's pool, updated in place. `plain` runs the plain
    versions; with them a MoE model's `routing` (a list) receives rank 0's
    router product of each layer, and `forced_routing` [L, B, k_top] routes
    every rank's rows as given (a kernel's, `kernel_routing`); `resid_norms`
    (a list) receives the RMS of each row's residual entering each layer
    (`ops.megakernel.decode_megakernel_ref`'s). Returns logits [B, V] f32
    on rank 0's device."""
    attn, lm = ((attn_segment_ref, lm_segment_ref) if plain
                else (tp_attn_segment, tp_lm_segment))
    if not plan.E:
        mlp = mlp_segment_ref if plain else tp_mlp_segment
    elif plain:
        def mlp(plan, packed, l, x, r, active, add=None):
            return moe_segment_ref(
                plan, packed, l, x, r, add, routing if r == 0 else None,
                None if forced_routing is None else forced_routing[l])
    else:
        mlp = tp_moe_segment
    lead = x0.device
    step = (cos, sin, page_tables, lens, active)
    inputs = {d: step if d == lead else
              tuple(t.to(d, non_blocking=True) for t in step)
              for d in dict.fromkeys(devices)}
    n = len(devices)
    xs = [x0.to(d).float() for d in devices]     # each rank's residual
    add: List[Optional[torch.Tensor]] = [None] * n
    for l in range(plan.L):
        if resid_norms is not None:
            x = xs[0] if add[0] is None else xs[0] + add[0]
            resid_norms.append(x.pow(2).mean(-1).sqrt())
        add = all_reduce_([attn(plan, packs[r], l, xs[r],
                                *inputs[devices[r]], caches[r], add=add[r])
                           for r in range(n)])
        add = all_reduce_([mlp(plan, packs[r], l, xs[r],
                               *((r, inputs[devices[r]][4]) if plan.E
                                 else ()), add=add[r])
                           for r in range(n)])
    return all_gather_vocab([lm(plan, packs[r], xs[r], add=add[r])
                             for r in range(n)])


def tp_decode_ref(plan, packs, x0, cos, sin, page_tables, lens, active,
                  caches, devices, routing: Optional[list] = None,
                  forced_routing: Optional[torch.Tensor] = None,
                  resid_norms: Optional[list] = None) -> torch.Tensor:
    """`tp_decode` through the plain versions."""
    return tp_decode(plan, packs, x0, cos, sin, page_tables, lens, active,
                     caches, devices, plain=True, routing=routing,
                     forced_routing=forced_routing, resid_norms=resid_norms)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_KINDS = {"attn": 0, "mlp": 1, "lm": 2, "moe": 3}
_STREAM_KIND = {"qkv": "attn", "o": "attn", "gu": "mlp", "dn": "mlp",
                "rt": "moe", "sgu": "moe", "sdn": "moe"}


def _stream_kind(plan, name: str) -> str:
    """The segment that streams `name` (a MoE plan's experts: the moe
    segment)."""
    return "moe" if plan.E and name in ("gu", "dn") else _STREAM_KIND[name]


def cuda_kernel_gaps(plan: mk.MegaPlan) -> List[str]:
    """Why csrc/tp_segments.cu cannot run this TP plan (empty = it can):
    the decode megakernel's gaps, but the lm segment takes a vocab shard of
    any even width (64 or 32 mod 128: Qwen1.5's 151936 over 2 or 4
    ranks); a MoE plan's expert and shared streams in one payload format
    (the moe segment deals their downs as one item space)."""
    gaps = mk.cuda_kernel_gaps(plan, any_lm_width=True)
    if plan.E and plan.sgu is not None and len(
            {sp.bits for sp in (plan.gu, plan.dn, plan.sgu, plan.sdn)}) > 1:
        gaps.append("the experts' and the shared expert's streams in "
                    "different payload formats")
    return gaps


MOE_SPLIT_ARGS = 8        # integers a routed count (csrc/di_product.cuh
                          # MoeSplit)


def moe_split_table(plan: mk.MegaPlan, B: int, passes: int, grid: int,
                    shared_down: Optional[Tuple[int, int]]) -> np.ndarray:
    """The MoE phases' K splits by routed count r = 0 .. plan.E (int32
    [E + 1, MOE_SPLIT_ARGS], csrc/di_product.cuh `MoeSplit`): the r
    experts' gate|up, and their downs dealt beside the shared expert's down
    (`shared_down`: its split, the same at every r, so that a row's shared
    expert sums alike whatever the batch routes), each `choose_split` over
    the grid. The kernel reads the entry of the routed count it finds on
    the card after the gates."""
    table = np.zeros((plan.E + 1, MOE_SPLIT_ARGS), np.int32)
    chunk_bytes = mk.CHUNK_K * 256 * plan.gu.bits // 8
    gu = (plan.gu.Nptot // 256, plan.gu.K // mk.CHUNK_K)
    dn = (plan.dn.Nptot // 256, plan.dn.K // mk.CHUNK_K)
    s_items = 0 if shared_down is None else \
        passes * (plan.sdn.Nptot // 256) * shared_down[0]
    for r in range(plan.E + 1):
        table[r, :2] = mk.choose_split(r * gu[0], gu[1], chunk_bytes, B,
                                       passes, grid)
        table[r, 2:4] = mk.choose_split(r * dn[0], dn[1], chunk_bytes, B,
                                        passes, grid, s_items)
        if shared_down is not None:
            table[r, 4:6] = shared_down
    return table


def moe_launch_splits(plan: mk.MegaPlan, B: int, passes: int, grid: int,
                      splits: Dict) -> np.ndarray:
    """A MoE plan's K splits by routed count (`moe_split_table`, which it
    returns); `splits` holds every stream's static split already (the
    router's, the shared expert's), and the expert streams take their
    largest of the table (the strides of their partial sums)."""
    table = moe_split_table(plan, B, passes, grid, splits.get("sdn"))
    for name, col in (("gu", 0), ("dn", 2)):
        ks = int(table[:, col].max())
        splits[name] = (ks, -(-(getattr(plan, name).K // mk.CHUNK_K) // ks))
    return table


def moe_partial_floats(plan: mk.MegaPlan, B: int, splits: Dict) -> int:
    """Floats of the split-K partial scratch a MoE plan's phases need
    beyond the dense streams': the router's partials and the shared
    expert's gate|up partials after them (the gates read the one while the
    other is written)."""
    if plan.sgu is None:
        return 0
    return B * (splits["rt"][0] * plan.rt.Nptot +
                splits["sgu"][0] * plan.sgu.Nptot)


class _Launch:
    """Per (plan, device) launch geometry and scratch of the segments (the
    ranks of one card share it: their launches run one after the other on
    one stream)."""

    def __init__(self, plan: mk.MegaPlan, dev: torch.device):
        gaps = cuda_kernel_gaps(plan)
        if gaps:
            raise ValueError("tp segments: " + "; ".join(gaps))
        lib = kernel_build.load("tp_segments")
        self.fn = kernel_build.function("tp_segments", "di_tp_segment",
                                        [_I, _I, _P, _P, _P])
        grid_fn = lib.di_tp_segment_grid
        grid_fn.argtypes, grid_fn.restype = [_I, _I, _I, _I], _I
        B = plan.B
        self.mpad = mk.padded_rows(B)
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        kinds = ("attn", "moe" if plan.E else "mlp", "lm")
        with torch.cuda.device(idx):
            self.grid = {k: grid_fn(idx, self.mpad, plan.hid, _KINDS[k])
                         for k in kinds}
        if min(self.grid.values()) <= 0:
            raise RuntimeError("tp segments: a kernel does not fit on the "
                               "device (occupancy query gave 0)")
        passes = mk.product_passes(self.mpad)
        self.splits = {"lm": (1, plan.lm.K // mk.CHUNK_K)}
        for sp in plan.layer_streams:
            self.splits[sp.name] = mk.choose_split(
                sp.Nptot // 256, sp.K // mk.CHUNK_K,
                mk.CHUNK_K * 256 * sp.bits // 8, B, passes,
                self.grid[_stream_kind(plan, sp.name)])
        # a MoE plan: the rank's experts' splits by the routed count of the
        # step
        self.moe_table = moe_launch_splits(
            plan, B, passes, self.grid["moe"], self.splits) if plan.E \
            else None
        self.nsplit, self.split_len = mk.attention_chunks(
            B, plan.KH, plan.maxP * plan.ps, self.grid["attn"])

        def zeros(n, dt):
            return torch.zeros(n, dtype=dt, device=dev)

        kmax = max(sp.K for sp in plan.streams)
        self.rec = zeros((kmax // mk.CHUNK_K) * self.mpad *
                         (mk.CHUNK_K * 2 + 4), torch.uint8)
        self.partial = zeros(max(
            [self.splits[sp.name][0] * B * sp.Nptot
             for sp in plan.layer_streams if not sp.E] +
            [moe_partial_floats(plan, B, self.splits)]), torch.float32)
        self.msplit = None if plan.E == 0 else torch.from_numpy(
            self.moe_table.reshape(-1)).to(dev)
        # a MoE plan: the rank's experts' partial sums [E][split][B][N] and
        # down x records (as the decode megakernel's), and each rank's
        # routing record [rank][L][B][top-k] (global expert ids, ascending;
        # the ranks of a card share the rest of this scratch)
        ranks = plan.E_global // plan.E if plan.E else 0
        self.epart = zeros(plan.E * max(
            [self.splits[sp.name][0] * B * sp.Nptot
             for sp in plan.streams if sp.E] + [0]), torch.float32)
        self.erec = zeros(plan.E * (plan.inter // mk.CHUNK_K) * self.mpad *
                          (mk.CHUNK_K * 2 + 4), torch.uint8)
        self.topk_e = zeros(ranks * plan.L * B * mk.MAX_TOPK, torch.int32)
        self.topk_w = zeros(ranks * plan.L * B * mk.MAX_TOPK, torch.float32)
        self.sgate = zeros(ranks * plan.L * B, torch.float32)
        # the attn segment's q|k|v + bias, the tickets of its q|k|v
        # epilogue (one a pass and 256-column tile) and of its merge (one a
        # slot and KV head)
        self.qkv = zeros(B * plan.QKVN, torch.float32)
        self.tickets = zeros(mk.epilogue_tickets(plan, self.mpad),
                             torch.int32)
        self.att_tickets = zeros(B * plan.KH, torch.int32)
        self.att_ml = zeros(B * plan.H * self.nsplit * 2, torch.float32)
        self.att_acc = zeros(B * plan.H * self.nsplit * plan.D,
                             torch.float32)
        self.ssq = zeros(B * (plan.hid // 128), torch.float32)
        self.barrier = zeros(1, torch.int32)
        self.status = zeros(1, torch.int32)


_launches: Dict = {}


def _launch_state(plan: mk.MegaPlan, dev: torch.device) -> _Launch:
    key = (plan, dev)
    st = _launches.get(key)
    if st is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tp segments: the first launch of a plan "
                               "must not be under CUDA graph capture")
        st = _launches[key] = _Launch(plan, dev)
    return st


def check_status(plan: mk.MegaPlan, device) -> None:
    """Waits for the device and raises if a segment launch of this plan
    gave up at a grid barrier or a product ring wait."""
    st = _launches.get((plan, mk._indexed(device)))
    if st is None:
        return
    code = int(st.status.item())
    if code:
        st.status.zero_()
        st.barrier.zero_()
        st.tickets.zero_()
        st.att_tickets.zero_()
        raise RuntimeError(f"tp segments: {mk.status_fault(code)}")


def kernel_routing(plan: mk.MegaPlan, device, rank: int) -> torch.Tensor:
    """The experts (global ids) that rank `rank`'s last moe segment launch
    of each layer routed each row to: int32 [L, B, k_top], ascending."""
    st = _launch_state(plan, mk._indexed(device))
    ranks = plan.E_global // plan.E
    return st.topk_e.reshape(ranks, plan.L, plan.B,
                             mk.MAX_TOPK)[rank, ..., :plan.k_top]


def launch_geometry(plan: mk.MegaPlan, device) -> Dict:
    """Grids, K splits and attention chunks of this plan's launches."""
    st = _launch_state(plan, mk._indexed(device))
    return dict(grid=dict(st.grid), mpad=st.mpad, splits=dict(st.splits),
                nsplit=st.nsplit, split_len=st.split_len,
                moe_splits=None if st.moe_table is None
                else st.moe_table.tolist())


def _expect(who: str, name: str, t: torch.Tensor, dt, shape, dev) -> None:
    if t.dtype != dt or tuple(t.shape) != tuple(shape) or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{who}: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}; expected contiguous {dt} "
                         f"{tuple(shape)} on {dev}")


def _launch(kind: str, plan: mk.MegaPlan, packed: Dict, layer: int,
            x: torch.Tensor, add: Optional[torch.Tensor], out: torch.Tensor,
            counter: kernel_build.LaunchCounter, rank: int = 0,
            trace: Optional[torch.Tensor] = None, **step) -> None:
    who = f"tp_{kind}_segment"
    dev = x.device
    B = plan.B
    _expect(who, "x", x, torch.float32, (B, plan.hid), dev)
    if add is not None:
        _expect(who, "add", add, torch.float32, (B, plan.hid), dev)
    _expect(who, "norms", packed["norms"], torch.float32,
            (plan.L, 2, plan.hid), dev)
    _expect(who, "final_norm", packed["final_norm"], torch.float32,
            (plan.hid,), dev)
    if packed["qkv_b"] is not None:
        _expect(who, "qkv_b", packed["qkv_b"], torch.float32,
                (plan.L, plan.QKVN), dev)
    st = _launch_state(plan, dev)
    vals = dict.fromkeys(mk._IARGS, 0)
    vals.update(
        norms=packed["norms"].data_ptr(),
        final_norm=packed["final_norm"].data_ptr(),
        qkv_b=0 if packed["qkv_b"] is None else packed["qkv_b"].data_ptr(),
        logits=out.data_ptr(), resid=x.data_ptr(), rec=st.rec.data_ptr(),
        partial=st.partial.data_ptr(), **mk.scratch_args(plan, st),
        barrier=st.barrier.data_ptr(), status=st.status.data_ptr(),
        launches=counter.pointer(dev),
        trace=0 if trace is None else trace.data_ptr(),
        B=B, L=plan.L, hid=plan.hid, H=plan.H, KH=plan.KH, inter=plan.inter,
        V=plan.V, ps=plan.ps, maxP=plan.maxP,
        kv_kind=mk._KV_KIND[plan.kv_dtype_name], nsplit=st.nsplit,
        split_len=st.split_len, mpad=st.mpad, grid=st.grid[kind],
        qk_norm=mk.qk_norm_arg(plan, packed, dev, who),
        slopes=mk.slopes_arg(plan, packed, dev, who))
    if kind == "attn":
        cache = step["cache"]
        for name, dt, shape in (
                ("cos", torch.bfloat16, (B, plan.D)),
                ("sin", torch.bfloat16, (B, plan.D)),
                ("page_tables", torch.int32, (B, plan.maxP)),
                ("lens", torch.int32, (B,)), ("active", torch.bool, (B,))):
            _expect(who, name, step[name], dt, shape, dev)
        kv_dt = getattr(torch, plan.kv_dtype_name)
        Ds = plan.D // 2 if plan.kv_bits == 4 else plan.D
        quant = plan.kv_bits != 16
        for t in (cache.k, cache.v):
            if t.dtype != kv_dt or t.shape[1:] != (plan.ps, plan.KH * Ds) or \
                    t.device != dev or not t.is_contiguous():
                raise ValueError(f"{who}: pool {t.dtype} {tuple(t.shape)} "
                                 f"for {plan.kv_mode} with {plan.KH} KV heads")
        if quant and (cache.k_qparams is None or
                      tuple(cache.k_qparams.shape[1:]) != (2 * plan.KH,
                                                           plan.ps) or
                      cache.k_qparams.dtype != torch.float32):
            raise ValueError(f"{who}: pool qparams missing or misshaped")
        vals.update(
            cos=step["cos"].data_ptr(), sin=step["sin"].data_ptr(),
            pt=step["page_tables"].data_ptr(), lens=step["lens"].data_ptr(),
            active=step["active"].data_ptr(), k_pool=cache.k.data_ptr(),
            v_pool=cache.v.data_ptr(),
            k_qp=cache.k_qparams.data_ptr() if quant else 0,
            v_qp=cache.v_qparams.data_ptr() if quant else 0,
            ql=plan.ps if quant else 0)
    if kind == "moe":
        ranks = plan.E_global // plan.E
        if not 0 <= rank < ranks:
            raise ValueError(f"{who}: rank {rank} of {ranks}")
        rec = plan.L * B * mk.MAX_TOPK
        vals.update(
            epart=st.epart.data_ptr(), erec=st.erec.data_ptr(),
            topk_e=st.topk_e[rank * rec:].data_ptr(),
            topk_w=st.topk_w[rank * rec:].data_ptr(),
            sgate=st.sgate[rank * plan.L * B:].data_ptr(),
            msplit=st.msplit.data_ptr(),
            E=plan.E_global, k_top=plan.k_top,
            norm_topk=int(plan.norm_topk), has_shared=int(plan.has_shared),
            has_sgate=int(plan.has_shared_gate),
            shared_inter=plan.shared_inter, active=step["active"].data_ptr())
        _expect(who, "active", step["active"], torch.bool, (B,), dev)
    ia = [vals[k] for k in mk._IARGS]
    ia += mk.packed_stream_args(plan, packed, st.splits, dev, who)
    # add, then a moe segment's first expert and expert count
    ia += [0 if add is None else add.data_ptr(),
           first_expert(rank, plan.E), plan.E]
    ia_arr = np.asarray(ia, np.int64)
    fa_arr = np.asarray([plan.rms_eps, 1.0 / math.sqrt(plan.D)], np.float64)
    with torch.cuda.device(dev):        # the C side launches on it
        rc = st.fn(_KINDS[kind], layer, ia_arr.ctypes.data,
                   fa_arr.ctypes.data, kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{who} launch failed: CUDA error {rc}")


def _check_device(who: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{who}: unsupported device {x.device}")


# the attn segment's phases, each followed by a grid barrier (q|k|v's K
# splits are summed in its epilogue, the attention chunks merged in the
# attention phase; the last phase, the sum of o's splits, is not traced)
ATTN_SEG_PHASES = ("resid", "norm", "qkv", "attention", "o")
# the mlp segment's, likewise (the last phase, the sum of down's splits,
# is not traced)
MLP_SEG_PHASES = ("resid", "norm", "gate_up", "swiglu", "down")
# the moe segment's, likewise (its last phase, the gated sum into the
# partial, is not traced)
MOE_SEG_PHASES = ("resid", "norm", "router", "gates", "gate_up", "swiglu",
                  "down")


def _check_trace(who: str, names, trace: Optional[torch.Tensor],
                 dev: torch.device) -> None:
    if trace is not None and (
            trace.dtype != torch.int64 or trace.device != dev or
            trace.numel() < 2 * len(names) + 1 or
            not trace.is_contiguous()):
        raise ValueError(f"{who}: trace must be contiguous int64 "
                         f"[{2 * len(names) + 1}] on {dev}")


def tp_attn_segment(plan: mk.MegaPlan, packed: Dict, layer: int,
                    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    page_tables: torch.Tensor, lens: torch.Tensor,
                    active: torch.Tensor, cache: KVCache,
                    add: Optional[torch.Tensor] = None,
                    trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's attention segment of one rank. x [B, hid] f32: the
    rank's residual, first increased by `add` in place (the all-reduced
    partial of the segment before, None in layer 0); packed: the rank's
    pack of `plan` (the local plan); cos/sin [B, D] bf16, page_tables
    [B, maxP] int32 LOGICAL pages, lens [B] int32, active [B] bool as
    `decode_megakernel` takes them; cache: the rank's pool (its KV heads),
    updated in place at each active slot's new token. Returns the o partial
    [B, hid] f32. `trace` (int64 [2 * len(ATTN_SEG_PHASES) + 1] on the
    card) gets block 0's timestamps as `decode_megakernel`'s does: read it
    with `megakernel.phase_times_of(ATTN_SEG_PHASES, trace)`. CPU tensors
    take `attn_segment_ref`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return attn_segment_ref(plan, packed, layer, x, cos, sin,
                                page_tables, lens, active, cache, add)
    _check_device("tp_attn_segment", x)
    out = torch.empty((plan.B, plan.hid), dtype=torch.float32,
                      device=x.device)
    _check_trace("tp_attn_segment", ATTN_SEG_PHASES, trace, x.device)
    _launch("attn", plan, packed, layer, x, add, out,
            tp_attn_segment.counter, trace=trace, cos=cos, sin=sin,
            page_tables=page_tables, lens=lens, active=active, cache=cache)
    return out


def tp_mlp_segment(plan: mk.MegaPlan, packed: Dict, layer: int,
                   x: torch.Tensor, add: Optional[torch.Tensor] = None,
                   trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's MLP segment of one rank: x += add, then the down partial
    [B, hid] f32 (see `tp_attn_segment`). `trace` (int64
    [2 * len(MLP_SEG_PHASES) + 1] on the card): block 0's timestamps, read
    with `megakernel.phase_times_of(MLP_SEG_PHASES, trace)`."""
    if x.device.type == "cpu":
        return mlp_segment_ref(plan, packed, layer, x, add)
    _check_device("tp_mlp_segment", x)
    out = torch.empty((plan.B, plan.hid), dtype=torch.float32,
                      device=x.device)
    _check_trace("tp_mlp_segment", MLP_SEG_PHASES, trace, x.device)
    _launch("mlp", plan, packed, layer, x, add, out, tp_mlp_segment.counter,
            trace=trace)
    return out


def tp_lm_segment(plan: mk.MegaPlan, packed: Dict, x: torch.Tensor,
                  add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The final norm and lm_head over the rank's vocab shard: x += add,
    then logits [B, V/n] f32 (the kernel writes the pack's padded columns
    too; this is the view of the true shard width)."""
    if x.device.type == "cpu":
        return lm_segment_ref(plan, packed, x, add)
    _check_device("tp_lm_segment", x)
    out = torch.empty((plan.B, plan.lm.Nptot), dtype=torch.float32,
                      device=x.device)
    _launch("lm", plan, packed, 0, x, add, out, tp_lm_segment.counter)
    return out[:, :plan.V]


def tp_moe_segment(plan: mk.MegaPlan, packed: Dict, layer: int,
                   x: torch.Tensor, rank: int, active: torch.Tensor,
                   add: Optional[torch.Tensor] = None,
                   trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MoE layer's MLP segment of rank `rank` (the TPU kernel's
    `build_moe_mlp_segment`): x += add, RMSNorm, the global router over
    all E_global experts (softmax, top-k, renormalisation, the shared
    gate), the rank's experts that some active row routes to and its slice
    of the shared expert => the moe partial [B, hid] f32 (active rows:
    their experts of the rank's group times their gates, ascending, then
    the shared slice times its gate; inactive rows: the shared slice
    alone). active [B] bool: the slots that step. The launch records its
    routing (`kernel_routing`). `trace` (int64 [2 * len(MOE_SEG_PHASES) +
    1] on the card): block 0's timestamps, read with
    `megakernel.phase_times_of(MOE_SEG_PHASES, trace)`. CPU tensors take
    `moe_segment_ref`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return moe_segment_ref(plan, packed, layer, x, rank, add)
    _check_device("tp_moe_segment", x)
    out = torch.empty((plan.B, plan.hid), dtype=torch.float32,
                      device=x.device)
    _check_trace("tp_moe_segment", MOE_SEG_PHASES, trace, x.device)
    _launch("moe", plan, packed, layer, x, add, out, tp_moe_segment.counter,
            rank=rank, trace=trace, active=active)
    return out


tp_attn_segment.counter = kernel_build.LaunchCounter()
tp_mlp_segment.counter = kernel_build.LaunchCounter()
tp_moe_segment.counter = kernel_build.LaunchCounter()
tp_lm_segment.counter = kernel_build.LaunchCounter()


# ---------------------------------------------------------------------------
# TP prefill: the prefill megakernel's layer cut into segments + all-reduce
# ---------------------------------------------------------------------------

def supports_prefill_tp(cfg: ModelConfig, rt: RuntimeConfig, params: Dict,
                        bucket: int, n: int,
                        local: Optional[Dict] = None) -> bool:
    """Whether a fresh prompt of this bucket is prefilled through the TP
    prefill segments on a model axis of n: the JAX rules (RoPE or ALiBi;
    `supports_tp`; the prefill megakernel's `supports_prefill` on the local
    config and rank 0's split tree). A MoE model says no at every bucket: the JAX package
    admits it, but its prefill segments stream the expert pack as one dense
    MLP (no router, no expert loop, no shared expert), so they compute
    another function (ROADMAP C.3: on a tiny MoE model at n = 2 its
    last-row logits differ from the per-op prefill's by 1.09 x their
    largest); the port prefills a MoE model per-op TP. `local`: rank 0's
    split tree when the caller has it (only shapes are read)."""
    if cfg.moe is not None or \
            cfg.position_embedding.value not in ("rope", "alibi"):
        return False
    if not supports_tp(cfg, rt, params, n, local=local):
        return False     # before any split of rank 0's share below
    if local is None:
        local = _split_rank(_as_tensors(mk.weight_only_decode_view(params)),
                            cfg, n, 0)
    return pmk.supports_prefill(local_config(cfg, n), rt, local, bucket)


def prefill_cuda_kernel_gaps(plan) -> List[str]:
    """Why csrc/tp_prefill_segments.cu cannot run this local prefill plan
    (empty = it can): the prefill megakernel's gaps, but the lm segment
    takes a vocab shard of any even width (Qwen3's 151936 over 2 ranks is
    75968, 64 mod 128: its one-row product writes the true columns); no
    MoE plan (`supports_prefill_tp`)."""
    gaps = pmk.cuda_kernel_gaps(plan, any_lm_width=True)
    if plan.E:
        gaps.append("MoE")
    return gaps


def make_tp_prefill_plans(cfg: ModelConfig, rt: RuntimeConfig,
                          parts: Sequence[Dict], buckets: Sequence[int],
                          tp_plan: mk.MegaPlan) -> Dict:
    """{bucket: the local PrefillPlan} over the ranks' split trees. Each
    plan adopts the TP decode plan's streams, so the prefill segments read
    each rank's TP decode pack (`make_tp_plan`): no third copy of the
    payloads, where the JAX package packs its TP prefill apart."""
    cfg_l = local_config(cfg, len(parts))
    return {b: pmk.make_prefill_plan(cfg_l, rt, parts[0], b,
                                     decode_plan=tp_plan) for b in buckets}


def prefill_attn_segment_ref(plan, packed: Dict, layer: int,
                             x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor, page_row: torch.Tensor,
                             n_tokens, cache: KVCache,
                             add: Optional[torch.Tensor] = None,
                             bf16_scores: bool = False) -> torch.Tensor:
    """One layer's prefill attention segment of one rank (see
    `tp_prefill_attn_segment`); `bf16_scores` as
    `ops.prefill_megakernel.prefill_attention_block_ref`."""
    if add is not None:
        x.add_(add)
    inp = pmk.PrefillInputs(plan, cos, sin, page_row, n_tokens)
    return pmk.prefill_attention_block_ref(plan, packed, layer, x, inp,
                                           cache, bf16_scores)


def prefill_mlp_segment_ref(plan, packed: Dict, layer: int, x: torch.Tensor,
                            n_tokens,
                            add: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One layer's prefill MLP segment of one rank (see
    `tp_prefill_mlp_segment`); every row of the bucket is computed."""
    if add is not None:
        x.add_(add)
    return pmk.prefill_mlp_block_ref(plan, packed, layer, x)


def prefill_lm_segment_ref(plan, packed: Dict, x: torch.Tensor, n_tokens,
                           add: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The prefill lm segment of one rank (see `tp_prefill_lm_segment`)."""
    n = int(n_tokens)
    if add is not None:
        x[n - 1].add_(add[n - 1])
    return pmk.prefill_lm_ref(plan, packed, x, n)


def tp_prefill(plan, packs: Sequence[Dict], x0: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, page_row: torch.Tensor,
               n_tokens: torch.Tensor, caches: Sequence[KVCache],
               devices: Sequence[torch.device], plain: bool = False,
               bf16_scores: bool = False) -> torch.Tensor:
    """The whole TP prefill of one fresh prompt over the ranks on `devices`
    (the counterpart of the JAX `build_tp_prefill_fn`): per layer every
    rank's prefill attn segment, an all-reduce, every rank's prefill mlp
    segment, an all-reduce; then every rank's lm segment and the gather of
    the vocab shards. The ranks of a layer are launched one after the other
    on their devices' current streams, with no host sync between them.
    `plan`: the local PrefillPlan; x0 [S, hid] bf16 (the embedded prompt,
    padded to the bucket), cos/sin [S, D] bf16, page_row [maxPb] int32
    PHYSICAL base rows, n_tokens int32 [1], all on rank 0's device;
    `caches`: each rank's pool, updated in place at rows < n of the owned
    pages. `plain` runs the plain versions (`bf16_scores` as theirs).
    Returns the last prompt row's logits [V] f32 on rank 0's device."""
    if plain:
        attn = functools.partial(prefill_attn_segment_ref,
                                 bf16_scores=bf16_scores)
        mlp, lm = prefill_mlp_segment_ref, prefill_lm_segment_ref
    else:
        attn, mlp, lm = (tp_prefill_attn_segment, tp_prefill_mlp_segment,
                         tp_prefill_lm_segment)
    lead = x0.device
    step = (cos, sin, page_row, n_tokens)
    inputs = {d: step if d == lead else
              tuple(t.to(d, non_blocking=True) for t in step)
              for d in dict.fromkeys(devices)}
    n = len(devices)
    xs = [x0.to(d).float() for d in devices]     # each rank's residual
    add: List[Optional[torch.Tensor]] = [None] * n
    for l in range(plan.L):
        add = all_reduce_([attn(plan, packs[r], l, xs[r],
                                *inputs[devices[r]], caches[r], add=add[r])
                           for r in range(n)])
        add = all_reduce_([mlp(plan, packs[r], l, xs[r],
                               inputs[devices[r]][3], add=add[r])
                           for r in range(n)])
    return all_gather_vocab([lm(plan, packs[r], xs[r],
                                inputs[devices[r]][3], add=add[r])
                             for r in range(n)])


def tp_prefill_ref(plan, packs, x0, cos, sin, page_row, n_tokens, caches,
                   devices, bf16_scores: bool = False) -> torch.Tensor:
    """`tp_prefill` through the plain versions."""
    return tp_prefill(plan, packs, x0, cos, sin, page_row, n_tokens, caches,
                      devices, plain=True, bf16_scores=bf16_scores)


class _PrefillLaunch:
    """Per (local prefill plan, device) launch geometry of the prefill
    segments: each kind's grid, the streams' K splits and what the plan
    needs of the device's prefill scratch (`ops.prefill_megakernel`'s one
    set a device, shared with the whole-model kernel and every rank on the
    device)."""

    def __init__(self, plan, dev: torch.device):
        gaps = prefill_cuda_kernel_gaps(plan)
        if gaps:
            raise ValueError("tp prefill segments: " + "; ".join(gaps))
        lib = kernel_build.load("tp_prefill_segments")
        self.fn = kernel_build.function(
            "tp_prefill_segments", "di_tp_prefill_segment",
            [_I, _I, _P, _P, _P])
        grid_fn = lib.di_tp_prefill_segment_grid
        grid_fn.argtypes, grid_fn.restype = [_I, _I], _I
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        with torch.cuda.device(idx):
            self.grid = {k: grid_fn(idx, v) for k, v in _KINDS.items()}
        if min(self.grid.values()) <= 0:
            raise RuntimeError("tp prefill segments: a kernel does not fit "
                               "on the device (occupancy query gave 0)")
        mtiles = plan.S // pmk.M_TILE
        # the lm segment's blocks: two an SM where they fit
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        self.splits = {"lm": pmk.choose_row_split(
            plan.lm.Nptot // 256, plan.lm.K // mk.CHUNK_K, self.grid["lm"],
            self.grid["lm"] // sms)}
        for sp in plan.layer_streams:
            self.splits[sp.name] = pmk.choose_split(
                sp.Nptot // 256, sp.K // mk.CHUNK_K, mtiles,
                self.grid[_STREAM_KIND[sp.name]])
        self.need = pmk.scratch_need(plan, self.splits, resid=False)


_prefill_launches: Dict = {}


def _prefill_launch_state(plan, dev: torch.device):
    """(geometry, the device's prefill scratch grown to the plan)."""
    key = (plan, dev)
    st = _prefill_launches.get(key)
    if st is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tp prefill segments: the first launch of a "
                               "plan must not be under CUDA graph capture")
        st = _prefill_launches[key] = _PrefillLaunch(plan, dev)
    return st, pmk.device_scratch(dev, st.need)


def reserve_prefill_scratch(plans, device) -> int:
    """Builds the segments and grows the device's prefill scratch to the
    largest of `plans` now (an installer calls this for every device of the
    mesh before it sizes the KV pools from free memory). Returns the
    scratch bytes on the device; `ops.prefill_megakernel.release_scratch`
    frees it."""
    dev = mk._indexed(device)
    for plan in plans:
        _prefill_launch_state(plan, dev)
    return pmk.scratch_bytes(dev)


def check_prefill_status(device) -> None:
    """Waits for the device and raises if a prefill segment launch on it
    gave up at a grid barrier or a product ring wait."""
    pmk.check_status(device, who="tp prefill segments")


def prefill_launch_geometry(plan, device) -> Dict:
    """Grids and K splits of this plan's segment launches, the scratch
    bytes the plan needs and those the device holds."""
    st, sc = _prefill_launch_state(plan, mk._indexed(device))
    return dict(grid=dict(st.grid), splits=dict(st.splits),
                scratch_bytes=sum(n * pmk._SCRATCH_DTYPES[k].itemsize
                                  for k, n in st.need.items()),
                device_scratch_bytes=sc.nbytes())


def _prefill_launch(kind: str, plan, packed: Dict, layer: int,
                    x: torch.Tensor, n_tokens: torch.Tensor,
                    add: Optional[torch.Tensor], out: torch.Tensor,
                    counter: kernel_build.LaunchCounter,
                    trace: Optional[torch.Tensor] = None, **step) -> None:
    who = f"tp_prefill_{kind}_segment"
    dev = x.device
    S = plan.S
    _expect(who, "x", x, torch.float32, (S, plan.hid), dev)
    if add is not None:
        _expect(who, "add", add, torch.float32, (S, plan.hid), dev)
    _expect(who, "n_tokens", n_tokens, torch.int32, (1,), dev)
    _expect(who, "norms", packed["norms"], torch.float32,
            (plan.L, 2, plan.hid), dev)
    _expect(who, "final_norm", packed["final_norm"], torch.float32,
            (plan.hid,), dev)
    if packed["qkv_b"] is not None:
        _expect(who, "qkv_b", packed["qkv_b"], torch.float32,
                (plan.L, plan.QKVN), dev)
    st, sc = _prefill_launch_state(plan, dev)
    buf = sc.bufs
    vals = dict.fromkeys(pmk._IARGS, 0)
    vals.update(
        {k: buf[k].data_ptr() for k in pmk._SCRATCH_DTYPES if k in buf},
        norms=packed["norms"].data_ptr(),
        final_norm=packed["final_norm"].data_ptr(),
        qkv_b=0 if packed["qkv_b"] is None else packed["qkv_b"].data_ptr(),
        n_tokens=n_tokens.data_ptr(), resid=x.data_ptr(),
        launches=counter.pointer(dev),
        trace=0 if trace is None else trace.data_ptr(),
        S=S, L=plan.L, hid=plan.hid,
        H=plan.H, KH=plan.KH, inter=plan.inter, V=plan.V, ps=plan.ps,
        maxPb=plan.maxPb, kv_kind=mk._KV_KIND[plan.kv_dtype_name],
        grid=st.grid[kind], qk_norm=mk.qk_norm_arg(plan, packed, dev, who),
        slopes=mk.slopes_arg(plan, packed, dev, who))
    if kind == "attn":
        cache = step["cache"]
        for name, dt, shape in (
                ("cos", torch.bfloat16, (S, plan.D)),
                ("sin", torch.bfloat16, (S, plan.D)),
                ("page_row", torch.int32, (plan.maxPb,))):
            _expect(who, name, step[name], dt, shape, dev)
        kv_dt = getattr(torch, plan.kv_dtype_name)
        Ds = plan.D // 2 if plan.kv_bits == 4 else plan.D
        quant = plan.kv_bits != 16
        for t in (cache.k, cache.v):
            if t.dtype != kv_dt or t.shape[1:] != (plan.ps, plan.KH * Ds) or \
                    t.device != dev or not t.is_contiguous():
                raise ValueError(f"{who}: pool {t.dtype} {tuple(t.shape)} "
                                 f"for {plan.kv_mode} with {plan.KH} KV heads")
        if quant and (cache.k_qparams is None or
                      cache.k_qparams.shape[1] != 2 * plan.KH or
                      cache.k_qparams.dtype != torch.float32):
            raise ValueError(f"{who}: pool qparams missing or misshaped")
        vals.update(
            cos=step["cos"].data_ptr(), sin=step["sin"].data_ptr(),
            page_row=step["page_row"].data_ptr(), k_pool=cache.k.data_ptr(),
            v_pool=cache.v.data_ptr(),
            k_qp=cache.k_qparams.data_ptr() if quant else 0,
            v_qp=cache.v_qparams.data_ptr() if quant else 0,
            ql=cache.k_qparams.shape[2] if quant else 0)
    ia = [vals[k] for k in pmk._IARGS]
    ia += mk.packed_stream_args(plan, packed, st.splits, dev, who,
                                lm_valid=plan.V)
    ia += [0 if add is None else add.data_ptr(), out.data_ptr()]
    ia_arr = np.asarray(ia, np.int64)
    fa_arr = np.asarray([plan.rms_eps, 1.0 / math.sqrt(plan.D)], np.float64)
    with torch.cuda.device(dev):        # the C side launches on it
        rc = st.fn(_KINDS[kind], layer, ia_arr.ctypes.data,
                   fa_arr.ctypes.data, kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{who} launch failed: CUDA error {rc}")


def tp_prefill_attn_segment(plan, packed: Dict, layer: int, x: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor,
                            page_row: torch.Tensor, n_tokens: torch.Tensor,
                            cache: KVCache,
                            add: Optional[torch.Tensor] = None,
                            trace: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One layer's prefill attention segment of one rank. `plan`: the local
    PrefillPlan; packed: the rank's pack (its TP decode pack); x [S, hid]
    f32: the rank's residual, first increased by `add` in place (the
    all-reduced partial of the segment before, None in layer 0); cos/sin
    [S, D] bf16, page_row [maxPb] int32 PHYSICAL base rows and n_tokens
    int32 [1] as `prefill_megakernel` takes them; cache: the rank's pool
    (its KV heads), updated in place at rows < n of the owned pages.
    Returns the o partial [S, hid] f32. The kernel computes the row tiles
    that hold prompt rows (their x rows take `add`) and returns zeros in the
    rows after them. `trace` (int64 [2 * len(PREFILL_ATTN_SEG_PHASES) +
    1] on the card) gets block 0's timestamps: read it with
    `megakernel.phase_times_of(PREFILL_ATTN_SEG_PHASES, trace)`. CPU
    tensors take `prefill_attn_segment_ref`; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return prefill_attn_segment_ref(plan, packed, layer, x, cos, sin,
                                        page_row, n_tokens, cache, add)
    _check_device("tp_prefill_attn_segment", x)
    out = torch.empty((plan.S, plan.hid), dtype=torch.float32,
                      device=x.device)
    _check_trace("tp_prefill_attn_segment", PREFILL_ATTN_SEG_PHASES, trace,
                 x.device)
    _prefill_launch("attn", plan, packed, layer, x, n_tokens, add, out,
                    tp_prefill_attn_segment.counter, trace=trace, cos=cos,
                    sin=sin, page_row=page_row, cache=cache)
    return out


# the prefill segments' phases, each followed by a grid barrier (the
# barrier after the splits' sum is a traced launch's alone)
PREFILL_ATTN_SEG_PHASES = ("norm", "qkv", "rope_kv", "attention", "o",
                           "sum")
PREFILL_MLP_SEG_PHASES = ("norm", "gate_up", "swiglu", "down", "sum")


def tp_prefill_mlp_segment(plan, packed: Dict, layer: int, x: torch.Tensor,
                           n_tokens: torch.Tensor,
                           add: Optional[torch.Tensor] = None,
                           trace: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One layer's prefill MLP segment of one rank: x += add, then the down
    partial [S, hid] f32 (see `tp_prefill_attn_segment`). `trace` (int64
    [2 * len(PREFILL_MLP_SEG_PHASES) + 1] on the card) gets block 0's
    timestamps: read it with `megakernel.phase_times_of(
    PREFILL_MLP_SEG_PHASES, trace)`."""
    if x.device.type == "cpu":
        return prefill_mlp_segment_ref(plan, packed, layer, x, n_tokens, add)
    _check_device("tp_prefill_mlp_segment", x)
    out = torch.empty((plan.S, plan.hid), dtype=torch.float32,
                      device=x.device)
    _check_trace("tp_prefill_mlp_segment", PREFILL_MLP_SEG_PHASES, trace,
                 x.device)
    _prefill_launch("mlp", plan, packed, layer, x, n_tokens, add, out,
                    tp_prefill_mlp_segment.counter, trace=trace)
    return out


def tp_prefill_lm_segment(plan, packed: Dict, x: torch.Tensor,
                          n_tokens: torch.Tensor,
                          add: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The final norm of the last prompt row n - 1 and the lm_head over the
    rank's vocab shard: x[n - 1] += add[n - 1], then logits [V/n] f32 (the
    kernel writes the true columns only)."""
    if x.device.type == "cpu":
        return prefill_lm_segment_ref(plan, packed, x, n_tokens, add)
    _check_device("tp_prefill_lm_segment", x)
    out = torch.empty((plan.V,), dtype=torch.float32, device=x.device)
    _prefill_launch("lm", plan, packed, 0, x, n_tokens, add, out,
                    tp_prefill_lm_segment.counter)
    return out


tp_prefill_attn_segment.counter = kernel_build.LaunchCounter()
tp_prefill_mlp_segment.counter = kernel_build.LaunchCounter()
tp_prefill_lm_segment.counter = kernel_build.LaunchCounter()
