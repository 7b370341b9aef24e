"""The per-rank form of the JAX package's sharding rules
(`dashinfer_tpu.parallel.sharding`), for the explicit rank loop of the
per-op TP path (models/transformer.py) and the segments.

The JAX package declares a PartitionSpec on each leaf and lets XLA's SPMD
partitioner insert the collectives. Here each rank holds its own tree:
  column split  q/k/v/gate/up and their bias (the reference's VSPLIT);
  row split     o/down, with a row-split bias on rank 0 only (HSPLIT; the
                reference zeroes the bias on the other ranks);
  vocab split   lm_head;
  replicated    the norms and the embedding (the TP megakernel replicates
                the embedding too);
  experts       a MoE layer's experts in contiguous groups of E/n a rank
                (the reference EPSPLIT), its shared expert as the dense MLP,
                its router and shared expert gate replicated.
A MoE model's experts split over the ranks on both TP paths, whatever
`use_ep` says. The JAX package splits them so only under `use_ep`, and
otherwise splits each expert by its inner width, where XLA SPMD replicates
a leaf whose dim does not divide; an explicit per-rank tree cannot do
that, and at Qwen1.5-MoE's width the inner split would cut a down group in
half (1408 / 2 = 704 rows, 5.5 groups of 128). The sum over the ranks is
the same function, and one tree serves the per-op TP path and the
segments (which split over the experts in the JAX package too). A MoE
model whose experts do not divide among the ranks is not served (the JAX
package serves it per-op through SPMD).
The split itself is `ops.tp_megakernel.split_params_tp`, so both TP paths
hold the same leaves. When the KV heads do not divide among the ranks, the
K/V weights and the KV pool are replicated on every rank (the reference
replicates GQA groups the same way), with the JAX package's warning.
"""

import dataclasses
from typing import Dict, List

import torch

from dashinfer_tpu_torch.config import CacheConfig, ModelConfig
from dashinfer_tpu_torch.parallel.mesh import Mesh
from dashinfer_tpu_torch.runtime.batch_state import DecodeState
from dashinfer_tpu_torch.runtime.kv_cache import KVCache, create_kv_cache
from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("sharding")


def _to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def kv_replicated(cfg: ModelConfig, n: int) -> bool:
    return cfg.num_kv_heads % n != 0


def rank_kv_heads(cfg: ModelConfig, n: int) -> int:
    """KV heads a rank holds: its share, or all of them when replicated."""
    return cfg.num_kv_heads if kv_replicated(cfg, n) else \
        cfg.num_kv_heads // n


def shard_params(params: Dict, cfg: ModelConfig, mesh: Mesh) -> List[Dict]:
    """Per-rank trees, each on its rank's device (params: the stacked
    tensor tree, on rank 0's device). Heads, MLP width and vocab must
    divide among the ranks."""
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.ops.moe import rank_moe
    n = mesh.n
    if cfg.num_heads % n or cfg.intermediate_size % n or cfg.vocab_size % n:
        raise NotImplementedError(
            f"model axis {n}: heads ({cfg.num_heads}), intermediate "
            f"({cfg.intermediate_size}) and vocab ({cfg.vocab_size}) must "
            "divide among the ranks")
    if cfg.moe is not None:
        rank_moe(cfg.moe, n)          # raises when the experts do not divide
    parts = tpk.split_params_tp(params, cfg, n)
    if kv_replicated(cfg, n):
        for p in parts:
            for name in ("k_proj", "v_proj"):
                p["layers"][name] = params["layers"][name]
    return [_to(p, dev) for p, dev in zip(parts, mesh.devices)]


def shard_cache(cfg: ModelConfig, cache_cfg: CacheConfig, mesh: Mesh,
                num_physical_pages: int, model_dtype: torch.dtype
                ) -> List[KVCache]:
    """One pool a rank, on its device, over the rank's KV heads (all of
    them when the heads do not divide among the ranks)."""
    n = mesh.n
    if kv_replicated(cfg, n):
        logger.warning("kv heads (%d) not divisible by model axis (%d); "
                       "replicating KV cache", cfg.num_kv_heads, n)
    cfg_r = dataclasses.replace(cfg, num_kv_heads=rank_kv_heads(cfg, n))
    return [create_kv_cache(cfg_r, cache_cfg, num_physical_pages,
                            model_dtype, dev) for dev in mesh.devices]


def shard_state(state: DecodeState, mesh: Mesh) -> DecodeState:
    """The decode state and the sampler stay on rank 0's device: the JAX
    package replicates them and every shard computes the same tokens; one
    controller needs them once."""
    def move(obj):
        return type(obj)(**{f.name: (getattr(obj, f.name).to(mesh.lead)
                                     if isinstance(getattr(obj, f.name),
                                                   torch.Tensor)
                                     else move(getattr(obj, f.name)))
                            for f in dataclasses.fields(obj)})
    return move(state)
