"""Tensor parallelism over a (data, model) mesh: counterpart of
`dashinfer_tpu.parallel`. The JAX package declares shardings and lets XLA
insert the collectives; here the ranks are an explicit loop over per-rank
param trees and KV pools, joined by the collectives of `collectives.py`."""

from dashinfer_tpu_torch.parallel.collectives import (all_gather_vocab,
                                                      all_reduce_,
                                                      collective_kind)
from dashinfer_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                               make_mesh)
from dashinfer_tpu_torch.parallel.sharding import (shard_cache, shard_params,
                                                   shard_state)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_gather_vocab",
           "all_reduce_", "collective_kind", "make_mesh", "shard_cache",
           "shard_params", "shard_state"]
