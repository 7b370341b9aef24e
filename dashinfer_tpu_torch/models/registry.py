"""Model-architecture registry: counterpart of `dashinfer_tpu.models.registry`.

A "model builder" maps a HF config dict to a ModelConfig and a HF
state-dict to the param tree; the compute graph is the generic transformer
(models/transformer.py). The lazy imports name only the builders the port
has.
"""

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(*hf_archs: str):
    def deco(fn):
        for a in hf_archs:
            _REGISTRY[a.lower()] = fn
        return fn
    return deco


def get_model_builder(hf_arch: str):
    key = hf_arch.lower()
    if key not in _REGISTRY:
        # import side-effect registration
        import dashinfer_tpu_torch.models.baichuan  # noqa: F401
    if key not in _REGISTRY:
        raise KeyError(f"unsupported architecture {hf_arch}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
