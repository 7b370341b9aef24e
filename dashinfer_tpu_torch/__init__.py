"""dashinfer_tpu_torch: the PyTorch + CUDA port of dashinfer_tpu for one
NVIDIA H100.

The JAX package `dashinfer_tpu` is the reference this port is held against;
the port imports nothing of it, nor JAX. This first slice serves dense
pre-LN RoPE decoders (Qwen2, Llama) with weight-only a16w8/a16w4 weights and
DEFAULT/INT8/UINT4 paged KV on the per-op path, whose two kernels are the
hand-written CUDA `quant_matmul` and `paged_attention` (csrc/).
"""

from dashinfer_tpu_torch.config import (CacheMode, GenerationConfig,
                                        ModelConfig, RuntimeConfig,
                                        RuntimeConfigBuilder)
from dashinfer_tpu_torch.engine.engine import Engine
from dashinfer_tpu_torch.runtime.request import (GenerateRequestStatus,
                                                 RequestHandle)
from dashinfer_tpu_torch.runtime.result_queue import ResultQueue

__all__ = ["CacheMode", "Engine", "GenerateRequestStatus", "GenerationConfig",
           "ModelConfig", "RequestHandle", "ResultQueue", "RuntimeConfig",
           "RuntimeConfigBuilder"]
