"""Multi-adapter LoRA serving (counterpart of `dashinfer_tpu.lora.manager`).

A runtime holds a pool of at most `lora_max_num` adapters of rank at most
`lora_max_rank`, loaded and unloaded by name and chosen per request by
`GenerationConfig.lora_name`. The pool is the device layout, as in the JAX
package: per target module, A `[L, max_num, in, max_rank]` and B `[L,
max_num, max_rank, out]` in the runtime's dtype (rank-padded with zeros),
and `scale [max_num]` f32 = alpha / rank. Unlike the JAX package, which
rebuilds its arrays functionally, `load` and `unload` write into the pool
IN PLACE (`copy_` / `zero_`): its tensors keep their addresses for the
runtime's life, so a decode step captured in a CUDA graph before a load
reads the new adapter at its next replay. The decode megakernel's LoRA
branch (ops/megakernel.py) reads these tensors as they are: it folds the
scale into B as it reads it, so the port keeps no second view of the pool
(the JAX package's `build_mega_view`) that a load would have to rebuild.

The plain functions `apply_lora_batch` (a decode batch, one adapter a row)
and `apply_lora_single` (one prompt, one adapter) compute the per-op path's
deltas in f32, as the JAX package's do.

PEFT checkpoints: `adapter_config.json` gives `r` and `lora_alpha`;
`adapter_model.safetensors` is read by this module's own reader (an 8-byte
header length, a JSON header, raw little-endian data: the machine with the
card has no `safetensors` package), `adapter_model.bin` with
`torch.load(weights_only=True)`.
"""

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.config import ModelConfig, RuntimeConfig
from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("lora")

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj")


def _dims(cfg: ModelConfig, target: str) -> Tuple[int, int]:
    """(in, out) of a target module."""
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    return {
        "q_proj": (hid, H * D), "k_proj": (hid, KH * D),
        "v_proj": (hid, KH * D), "o_proj": (H * D, hid),
        "gate_proj": (hid, inter), "up_proj": (hid, inter),
        "down_proj": (inter, hid),
    }[target]


class LoraManager:
    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig,
                 dtype=torch.bfloat16, device="cpu"):
        self.cfg = cfg
        self.max_num = rt.lora_max_num
        self.max_rank = rt.lora_max_rank
        self.dtype = dtype
        self.device = torch.device(device)
        self.names: List[Optional[str]] = [None] * self.max_num
        self.pool = self._empty_pool()

    def _empty_pool(self) -> Dict:
        L, N, R = self.cfg.num_layers, self.max_num, self.max_rank

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        pool = {"A": {}, "B": {}, "scale": zeros(N, dtype=torch.float32)}
        for t in TARGETS:
            i, o = _dims(self.cfg, t)
            pool["A"][t] = zeros(L, N, i, R)
            pool["B"][t] = zeros(L, N, R, o)
        return pool

    # -- load / unload ----------------------------------------------------
    def load(self, name: str, adapter_path_or_tensors, alpha: float = None,
             rank: int = None) -> int:
        """Loads an adapter into the first free slot and returns the slot.
        `adapter_path_or_tensors`: a PEFT checkpoint directory, or the
        tensors {(layer, target, "A" | "B"): array} in PEFT's layout
        (lora_A [r, in], lora_B [out, r]) with `alpha` and `rank`."""
        if name in self.names:
            raise ValueError(f"lora '{name}' already loaded")
        try:
            slot = self.names.index(None)
        except ValueError:
            raise RuntimeError(
                f"lora pool full ({self.max_num}); unload one first")
        if isinstance(adapter_path_or_tensors, (str, os.PathLike)):
            tensors, alpha, rank = read_peft(str(adapter_path_or_tensors))
        else:
            tensors = adapter_path_or_tensors
            if alpha is None or rank is None:
                raise ValueError("adapter tensors need alpha and rank")
        if rank > self.max_rank:
            raise ValueError(
                f"lora rank {rank} > lora_max_rank {self.max_rank}")
        L, R = self.cfg.num_layers, self.max_rank
        for t in TARGETS:
            i, o = _dims(self.cfg, t)
            A = np.zeros((L, i, R), np.float32)
            B = np.zeros((L, R, o), np.float32)
            for l in range(L):
                a_t = tensors.get((l, t, "A"))
                b_t = tensors.get((l, t, "B"))
                if a_t is None:
                    continue
                r = a_t.shape[0]
                A[l, :, :r] = np.asarray(a_t, np.float32).T
                B[l, :r, :] = np.asarray(b_t, np.float32).T
            self.pool["A"][t][:, slot].copy_(torch.from_numpy(A))
            self.pool["B"][t][:, slot].copy_(torch.from_numpy(B))
        self.pool["scale"][slot] = float(alpha) / float(rank)
        self.names[slot] = name
        logger.info("loaded lora '%s' (rank %d, alpha %.1f) into slot %d",
                    name, rank, alpha, slot)
        return slot

    def unload(self, name: str) -> bool:
        if name not in self.names:
            return False
        slot = self.names.index(name)
        self.names[slot] = None
        for t in TARGETS:
            self.pool["A"][t][:, slot].zero_()
            self.pool["B"][t][:, slot].zero_()
        self.pool["scale"][slot] = 0.0
        return True

    def index_of(self, name: Optional[str]) -> int:
        if name is None:
            return -1
        if name not in self.names:
            raise KeyError(f"lora '{name}' not loaded")
        return self.names.index(name)


def from_jax_pool(pool, dtype, device="cpu") -> Dict:
    """The JAX `LoraManager.pool` (numpy or JAX arrays of the same layout)
    as the port's pool: tensors of `dtype` on `device`."""
    def conv(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=dtype)
    return {"A": {t: conv(v) for t, v in pool["A"].items()},
            "B": {t: conv(v) for t, v in pool["B"].items()},
            "scale": conv(pool["scale"]).float()}


# -- PEFT checkpoints ---------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a `.safetensors` file as float32 numpy arrays (bf16
    widened exactly)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        b0, b1 = info["data_offsets"]
        raw = data[b0:b1]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[info["dtype"]])
                                .newbyteorder("<"))
        out[key] = arr.reshape(shape).astype(np.float32)
    return out


def read_peft(path: str):
    """(tensors {(layer, target, "A" | "B"): f32 array}, alpha, rank) of a
    PEFT adapter directory: `adapter_config.json` with
    `adapter_model.safetensors`, or else `adapter_model.bin`."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    alpha = float(acfg.get("lora_alpha", 16))
    rank = int(acfg.get("r", 8))
    st = os.path.join(path, "adapter_model.safetensors")
    bn = os.path.join(path, "adapter_model.bin")
    if os.path.exists(st):
        raw = read_safetensors(st)
    elif os.path.exists(bn):
        raw = {k: v.float().numpy() for k, v in torch.load(
            bn, map_location="cpu", weights_only=True).items()}
    else:
        raise FileNotFoundError(f"no adapter weights under {path}")
    tensors = {}
    for k, v in raw.items():
        # e.g. base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight
        parts = k.split(".")
        if "layers" not in parts:
            continue
        l = int(parts[parts.index("layers") + 1])
        target = next((t for t in TARGETS if t in parts), None)
        if target is None:
            continue
        tensors[(l, target, "A" if "lora_A" in parts else "B")] = v
    return tensors, alpha, rank


# -- the per-op path's deltas -------------------------------------------------

def apply_lora_batch(x: torch.Tensor, A_l: torch.Tensor, B_l: torch.Tensor,
                     scale: torch.Tensor, onehot: torch.Tensor
                     ) -> torch.Tensor:
    """Batched multi-adapter delta for decode. x: [B, in]; A_l: [N, in, R];
    B_l: [N, R, out]; scale: [N]; onehot: [B, N] f32 (an all-zero row: no
    adapter). Returns [B, out] in x's dtype. N <= B: the dense one-hot
    contraction over the whole pool; N > B: each row's adapter gathered."""
    B, N = x.shape[0], A_l.shape[0]
    xf = x.float()
    if N <= B:
        h = torch.einsum("bi,nir->bnr", xf, A_l.float())
        h = h * (onehot * scale[None, :])[..., None]
        return torch.einsum("bnr,nro->bo", h, B_l.float()).to(x.dtype)
    idx = onehot.argmax(1)
    has = (onehot > 0).any(1)
    s = torch.where(has, scale[idx], torch.zeros_like(scale[idx]))
    h = torch.einsum("bi,bir->br", xf, A_l[idx].float()) * s[:, None]
    return torch.einsum("br,bro->bo", h, B_l[idx].float()).to(x.dtype)


def apply_lora_single(x: torch.Tensor, A_l: torch.Tensor, B_l: torch.Tensor,
                      scale: torch.Tensor, idx: int) -> torch.Tensor:
    """Single-adapter delta for prefill. x: [T, in]; idx: the slot (-1 =
    none, which gives zeros)."""
    safe = max(int(idx), 0)
    s = scale[safe] if idx >= 0 else torch.zeros_like(scale[safe])
    h = (x.float() @ A_l[safe].float()) * s
    return (h @ B_l[safe].float()).to(x.dtype)
