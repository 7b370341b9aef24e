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
"""

from typing import Dict

import torch
import torch.nn.functional as F

from dashinfer_tpu_torch.config import ModelConfig
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
                 use_kernel: bool) -> torch.Tensor:
    moe = cfg.moe
    T, H = x.shape
    E, Im = moe.num_experts, moe.moe_intermediate_size
    ex = lp["experts"]
    TM = gqm.default_tm()
    order, sorted_token, pos, tile_expert = gqm.build_group_layout(
        topk_i, E, TM)
    Mcap = tile_expert.shape[0] * TM
    rows = gqm.tile_row_counts(pos, tile_expert.shape[0], TM)
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


def moe_block(cfg: ModelConfig, x: torch.Tensor, lp: Dict,
              use_kernel: bool = True) -> torch.Tensor:
    """x: [T, hidden]; lp["router"]: {"w": [hidden, E]}; lp["experts"]:
    {"gate_proj"/"up_proj": [E, hidden, Im], "down_proj": [E, Im, hidden]}
    (raw or weight-only-quantized leaves); optional lp["shared_expert"]
    and lp["shared_expert_gate"]. `use_kernel=False` runs the grouped
    kernel's plain version where the kernel would run."""
    moe = cfg.moe
    T, H = x.shape
    E, k = moe.num_experts, moe.num_experts_per_tok
    router_logits = x.float() @ lp["router"]["w"].float()
    probs = torch.softmax(router_logits, dim=-1)               # [T, E]
    topk_p, topk_i = torch.topk(probs, k, dim=-1)
    if moe.norm_topk_prob:
        topk_p = topk_p / topk_p.sum(-1, keepdim=True)

    if _use_grouped(lp, x):
        combined = _moe_grouped(cfg, x, lp, topk_p, topk_i, use_kernel)
        return _with_shared(x, lp, combined, use_kernel).to(x.dtype)

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
    return _with_shared(x, lp, combined, use_kernel).to(x.dtype)


def _with_shared(x: torch.Tensor, lp: Dict, combined: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    if "shared_expert" not in lp:
        return combined
    se = lp["shared_expert"]
    sg = F.silu(linear(x, se["gate_proj"], use_kernel=use_kernel)) * \
        linear(x, se["up_proj"], use_kernel=use_kernel)
    shared = linear(sg, se["down_proj"], use_kernel=use_kernel)
    if "shared_expert_gate" in lp:
        gate = torch.sigmoid(x.float() @
                             lp["shared_expert_gate"]["w"].float())
        shared = shared * gate.to(shared.dtype)
    return combined + shared
