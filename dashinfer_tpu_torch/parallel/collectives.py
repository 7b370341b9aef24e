"""The collectives of the TP paths: the JAX package's `psum` inside
`shard_map` and the all-reduce / all-gather that XLA inserts after a
row-split product and a vocab-split lm_head.

One process drives every rank (the JAX single controller's model), so a
collective takes the ranks' tensors as a list, in rank order. Its form
follows the mesh's devices, decided once (`collective_kind`), never by a
caught error:
  "same-device sum"  every rank on one device (the CPU, or one card that
                     runs all ranks' kernels): the partials are summed on
                     that device in rank order;
  "nccl"             one rank a CUDA card: `torch.cuda.nccl.all_reduce`
                     over the list, which keeps one NCCL communicator for
                     the list's cards (the mesh's).
Both are plain stream work, so a CUDA graph can capture them (NCCL
captures on the ranks' streams). A mesh that shares some devices but not
all is not served.
"""

from typing import List, Sequence

import torch

from dashinfer_tpu_torch.parallel.mesh import Mesh
from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("collectives")

SAME_DEVICE = "same-device sum"
NCCL = "nccl"


def collective_kind(devices: Sequence[torch.device]) -> str:
    """The collectives' form for these rank devices."""
    devices = list(devices)
    if len(set(devices)) == 1:
        return SAME_DEVICE
    if len(set(devices)) == len(devices) and \
            all(d.type == "cuda" for d in devices):
        return NCCL
    raise NotImplementedError(
        f"ranks on {[str(d) for d in devices]}: a mesh whose ranks share "
        "some devices but not all (or several CPU ranks on distinct "
        "devices) is not served")


def log_choice(mesh: Mesh) -> str:
    kind = collective_kind(mesh.devices)
    logger.info("TP mesh %s on %s: collectives by %s", mesh.shape,
                [str(d) for d in mesh.devices], kind)
    return kind


def all_reduce_(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sums the ranks' partials (one tensor a rank, same shape) in f32 and
    writes the sum back into every part. Returns `parts`."""
    kind = collective_kind([p.device for p in parts])
    if kind == NCCL:
        if any(p.dtype != torch.float32 for p in parts):
            raise ValueError("all_reduce_: NCCL partials must be f32")
        torch.cuda.nccl.all_reduce(parts)
        return parts
    acc = parts[0] if parts[0].dtype == torch.float32 else parts[0].float()
    for p in parts[1:]:
        acc.add_(p)
    for p in parts:
        if p is not acc:
            p.copy_(acc)
    return parts


def all_gather_vocab(shards: List[torch.Tensor]) -> torch.Tensor:
    """The ranks' vocab shards [..., V/n] -> [..., V] on rank 0's device."""
    lead = shards[0].device
    return torch.cat([s.to(lead, non_blocking=True) for s in shards], dim=-1)
