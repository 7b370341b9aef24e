"""Device mesh (counterpart of `dashinfer_tpu.parallel.mesh`).

A `(data, model)` mesh whose model axis holds the tensor-parallel ranks.
The JAX package builds a `jax.sharding.Mesh` and XLA schedules the
collectives; here the mesh is the list of rank devices that the runtime
loops over. Only a data axis of 1 is served (the JAX TP megakernel needs
it too). A list that names one device several times puts several ranks on
that device: their all-reduce is then a sum on the device, which lets one
card run every rank's kernels at their real widths. Such a list is taken
only when the caller passes it.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the model axis, in rank order, and the mesh shape."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]            # (data, model)

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def lead(self) -> torch.device:
        """Rank 0's device: the embedding gather, the sampler and the
        decode state live there."""
        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in rank order."""
        return tuple(dict.fromkeys(self.devices))


def _indexed(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(mesh_shape: Tuple[int, int] = (1, 1),
              devices: Optional[Sequence] = None) -> Mesh:
    """(data, model) mesh over `devices`, by default every visible CUDA
    card, one rank each. Raises as the JAX function does when there are
    fewer devices than ranks."""
    d, m = mesh_shape
    if d < 1 or m < 1:
        raise ValueError(f"mesh {mesh_shape}: axes must be >= 1")
    if d > 1:
        raise NotImplementedError(
            f"mesh {mesh_shape}: a data axis > 1 is not ported to the "
            "PyTorch package yet")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(x) for x in devices]
    if d * m > len(devices):
        raise ValueError(f"mesh {mesh_shape} needs {d * m} devices, "
                         f"have {len(devices)}")
    ranks = tuple(devices[:m])
    if len({x.type for x in ranks}) > 1:
        raise ValueError(f"mesh {mesh_shape}: ranks on mixed device types "
                         f"{[str(x) for x in ranks]}")
    return Mesh(ranks, (d, m))
