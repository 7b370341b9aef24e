"""Mixture-of-experts block: counterpart of `dashinfer_tpu.ops.moe`.

Softmax router in f32, top-k experts (optionally renormalised), the routed
experts' SwiGLU MLPs, then the shared expert with its sigmoid gate
(Qwen1.5/2-MoE). Two routes for the experts, as in the JAX package:

* grouped: tokens sorted by expert and boundary-padded to the M tile
  (`ops.grouped_quant_matmul.build_group_layout`), three launches of the
  grouped fused-dequant kernel a layer (gate, up, down), each expert's
  payload read once per tile;
* ragged: plain PyTorch over the dequantized expert stacks, one masked
  product per expert. It holds no host sync, so a decode forward through
  it stays CUDA-graph capturable, but it dequantizes every expert of the
  layer each call.

Dispatch. The JAX rule `T * k >= E` ("ragged wins at tiny batches") is a
TPU cost rule. On this card the ragged route dequantizes all experts of a
layer (~1 GB of bf16 at Qwen1.5-MoE width) where the grouped kernel reads
each routed expert's u4 payload once, so a CUDA tensor takes the grouped
kernel at every T (PERF.md gives the measured reason), and an expert leaf
that is not in the kernel's layout raises there rather than falling back.
`DI_MOE_GROUPED=0` turns the kernel off; off the card the port runs what
the JAX package runs off-TPU: ragged, or the grouped route's plain version
when `DI_MOE_GROUPED=1`.

On a model axis of n (the per-op TP path, models/transformer.py) each rank
runs `moe_block(..., rank=r, n=n)` on its tree: the replicated router and
top-k over all experts, the (token, expert) pairs whose expert is in the
rank's group kept and renumbered to its stack (the others' weights set to
0 and their rows computed by no expert), its slice of the shared expert;
the result is the rank's f32 partial, summed over the ranks by the
all-reduce. The JAX package computes the same sum through XLA SPMD.
"""

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from dashinfer_tpu_torch.config import MoEConfig, ModelConfig
from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
from dashinfer_tpu_torch.ops.linear import linear
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.utils import EnvConfig


def _expert_stack(leaf, dtype, n: int) -> torch.Tensor:
    """Expert weights: a raw [E, K, N] tensor, or a weight-only quantized
    leaf {"w_q" [E, K, N(/2)], "scale"/"zero" [E, G, N]} -> dense [E, K, n]
    (q * scale + zero in f32, then `dtype`); `n`, the model's width, drops
    the zero columns of a leaf padded for the grouped kernel
    (`prepare_grouped_experts`)."""
    if not isinstance(leaf, dict):
        return leaf[..., :n].to(dtype)
    w_q, scale, zero = leaf["w_q"], leaf["scale"].float(), leaf["zero"].float()
    E, K = w_q.shape[:2]
    q = weight_levels(w_q.reshape(E * K, -1)).float().reshape(E, K, -1)
    N = q.shape[-1]
    G = scale.shape[1]
    w = q.reshape(E, G, K // G, N) * scale[:, :, None, :] + \
        zero[:, :, None, :]
    return w.reshape(E, K, N)[..., :n].to(dtype)


def _use_grouped(lp: Dict, x: torch.Tensor) -> bool:
    """Whether the experts take the grouped route. A CUDA tensor takes the
    kernel for quantized experts unless DI_MOE_GROUPED=0, and raises when a
    leaf is not in the kernel's layout; off the card the grouped route (its
    plain version) runs only with DI_MOE_GROUPED=1, and only where every
    leaf tiles. bf16 expert stacks take the ragged route."""
    env = EnvConfig.moe_grouped()
    if env and not int(env):
        return False
    ex = lp["experts"]
    names = ("gate_proj", "up_proj", "down_proj")
    if not all(isinstance(ex[n], dict) and "w_q" in ex[n] for n in names):
        return False
    if not x.is_cuda:
        return bool(env) and all(gqm.supports_grouped(ex[n]) for n in names)
    for n in names:
        if not gqm.supports_grouped(ex[n]):
            w_q, scale = ex[n]["w_q"], ex[n]["scale"]
            raise ValueError(
                f"moe_block: expert leaf {n} (w_q {tuple(w_q.shape)} "
                f"{w_q.dtype}, {scale.shape[-1]} columns) is not in the "
                "grouped kernel's layout and has no padded copy: run "
                "ops.grouped_quant_matmul.prepare_grouped_experts on the "
                "param tree (Engine.install_model does), or set "
                "DI_MOE_GROUPED=0 for the ragged route")
    return True


def _moe_grouped(cfg: ModelConfig, x: torch.Tensor, lp: Dict,
                 topk_p: torch.Tensor, topk_i: torch.Tensor,
                 use_kernel: bool, others: bool = False) -> torch.Tensor:
    """`others`: pairs of expert id E (another rank's expert) are in
    topk_i; they sort last, their tiles compute nothing (0 rows) and their
    rows are dropped."""
    moe = cfg.moe
    T, H = x.shape
    E, Im = moe.num_experts, moe.moe_intermediate_size
    ex = lp["experts"]
    TM = gqm.default_tm()
    order, sorted_token, pos, tile_expert = gqm.build_group_layout(
        topk_i, E + others, TM)
    Mcap = tile_expert.shape[0] * TM
    rows = gqm.tile_row_counts(pos, tile_expert.shape[0], TM)
    if others:
        rows = torch.where(tile_expert == E, 0, rows)
        tile_expert = tile_expert.clamp(max=E - 1)
    sorted_w = topk_p.reshape(-1)[order]
    mm = gqm.grouped_quant_matmul if use_kernel else \
        gqm.grouped_quant_matmul_plain
    xs = torch.zeros((Mcap, H), dtype=x.dtype, device=x.device)
    xs[pos] = x[sorted_token]
    g = mm(xs, tile_expert, ex["gate_proj"], tile_rows=rows)
    u = mm(xs, tile_expert, ex["up_proj"], tile_rows=rows)
    h = (F.silu(g[:, :Im].float()) * u[:, :Im].float()).to(x.dtype)
    dn = mm(h, tile_expert, ex["down_proj"], tile_rows=rows)
    out = dn[pos, :H] * sorted_w[:, None].to(dn.dtype)
    if others:
        out = torch.where((topk_i.reshape(-1)[order] < E)[:, None], out, 0)
    return torch.zeros((T, H), dtype=out.dtype, device=x.device).index_add_(
        0, sorted_token, out)


def _ragged_dot(xs: torch.Tensor, stack: torch.Tensor,
                sorted_expert: torch.Tensor) -> torch.Tensor:
    """jax.lax.ragged_dot over expert-sorted rows, as one masked product per
    expert (no host sync)."""
    out = torch.zeros((xs.shape[0], stack.shape[-1]), dtype=xs.dtype,
                      device=xs.device)
    for e in range(stack.shape[0]):
        mask = (sorted_expert == e)[:, None]
        out = torch.where(mask, xs @ stack[e], out)
    return out


def rank_moe(moe: MoEConfig, n: int) -> MoEConfig:
    """The port's expert split over a model axis of n, on both TP paths
    (parallel/sharding.py): each rank holds a contiguous group of E/n
    experts, each of its full width (`first_expert`), and 1/n of the shared
    expert's width; the router and the shared expert's gate stay whole.
    Returns a rank's MoE config; raises NotImplementedError when the
    experts or the shared width do not divide among the ranks."""
    if moe.num_experts % n or moe.shared_expert_intermediate_size % n:
        raise NotImplementedError(
            f"model axis {n}: the MoE experts ({moe.num_experts}) and the "
            f"shared expert's width ({moe.shared_expert_intermediate_size}) "
            "must divide among the ranks (the port splits the experts over "
            "the ranks)")
    return dataclasses.replace(
        moe, num_experts=moe.num_experts // n,
        shared_expert_intermediate_size=(
            moe.shared_expert_intermediate_size // n))


def first_expert(rank: int, local_experts: int) -> int:
    """The global id of rank `rank`'s first expert (`rank_moe`'s split;
    `local_experts`: a rank's count)."""
    return rank * local_experts


def moe_block(cfg: ModelConfig, x: torch.Tensor, lp: Dict,
              use_kernel: bool = True, rank: int = 0,
              n: int = 1) -> torch.Tensor:
    """x: [T, hidden]; lp["router"]: {"w": [hidden, E]}; lp["experts"]:
    {"gate_proj"/"up_proj": [E, hidden, Im], "down_proj": [E, Im, hidden]}
    (raw or weight-only-quantized leaves); optional lp["shared_expert"]
    and lp["shared_expert_gate"]. `use_kernel=False` runs the grouped
    kernel's plain version where the kernel would run. On a model axis
    (n > 1): `cfg` is the rank's (its E experts), lp the rank's layer tree
    (its experts and shared slice, the router of all n E experts); returns
    rank `rank`'s f32 partial."""
    moe = cfg.moe
    T, H = x.shape
    E, k = moe.num_experts, moe.num_experts_per_tok
    router_logits = x.float() @ lp["router"]["w"].float()
    probs = torch.softmax(router_logits, dim=-1)               # [T, n E]
    topk_p, topk_i = torch.topk(probs, k, dim=-1)
    if moe.norm_topk_prob:
        topk_p = topk_p / topk_p.sum(-1, keepdim=True)
    out_dtype = x.dtype
    if n > 1:
        # the rank's pairs, renumbered; the others go to "expert E"
        e0 = first_expert(rank, E)
        mine = (topk_i >= e0) & (topk_i < e0 + E)
        topk_i = torch.where(mine, topk_i - e0, E)
        topk_p = torch.where(mine, topk_p, 0)
        out_dtype = torch.float32

    if _use_grouped(lp, x):
        combined = _moe_grouped(cfg, x, lp, topk_p, topk_i, use_kernel,
                                others=n > 1)
        return _with_shared(x, lp, combined, use_kernel,
                            out_dtype).to(out_dtype)

    flat_expert = topk_i.reshape(-1)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_w = topk_p.reshape(-1)[order]
    xs = x[sorted_token]
    ex = lp["experts"]
    Im = moe.moe_intermediate_size
    g = _ragged_dot(xs, _expert_stack(ex["gate_proj"], x.dtype, Im),
                    sorted_expert)
    u = _ragged_dot(xs, _expert_stack(ex["up_proj"], x.dtype, Im),
                    sorted_expert)
    h = F.silu(g) * u
    out = _ragged_dot(h.to(x.dtype),
                      _expert_stack(ex["down_proj"], x.dtype, H),
                      sorted_expert)
    out = out * sorted_w[:, None].to(out.dtype)
    combined = torch.zeros((T, H), dtype=out.dtype,
                           device=x.device).index_add_(0, sorted_token, out)
    return _with_shared(x, lp, combined, use_kernel,
                        out_dtype).to(out_dtype)


def _with_shared(x: torch.Tensor, lp: Dict, combined: torch.Tensor,
                 use_kernel: bool, out_dtype=None) -> torch.Tensor:
    """combined + the shared expert's output times its gate; `out_dtype`
    (f32: a rank's partial): the down product's and the sum's type."""
    if out_dtype == x.dtype:
        out_dtype = None
    if out_dtype is not None:
        combined = combined.to(out_dtype)
    if "shared_expert" not in lp:
        return combined
    se = lp["shared_expert"]
    sg = F.silu(linear(x, se["gate_proj"], use_kernel=use_kernel)) * \
        linear(x, se["up_proj"], use_kernel=use_kernel)
    shared = linear(sg, se["down_proj"], out_dtype=out_dtype,
                    use_kernel=use_kernel)
    if "shared_expert_gate" in lp:
        gate = torch.sigmoid(x.float() @
                             lp["shared_expert_gate"]["w"].float())
        shared = shared * gate.to(shared.dtype)
    return combined + shared
