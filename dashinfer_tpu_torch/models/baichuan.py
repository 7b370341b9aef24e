"""Baichuan 1/2: counterpart of `dashinfer_tpu.models.baichuan`.

7B is Llama-style with RoPE and a fused W_pack q|k|v; 13B uses ALiBi (its
HF config carries no flag: a 40-layer model with `model_max_length` >= 4096
is taken as ALiBi, as the JAX package does). Baichuan2 normalizes the
lm_head rows at load (as HF's NormHead does on its first forward).
"""

from typing import Dict

import numpy as np

from dashinfer_tpu_torch.config import ModelConfig, PositionEmbedding
from dashinfer_tpu_torch.models.common import (_cast, _to_np,
                                               stack_layer_trees)
from dashinfer_tpu_torch.models.registry import register_model


def _model_config(hf: dict) -> ModelConfig:
    heads = hf["num_attention_heads"]
    hidden = hf["hidden_size"]
    alibi = hf.get("position_embedding", "").lower() == "alibi" or (
        hf.get("num_hidden_layers") == 40 and
        hf.get("model_max_length", 0) >= 4096)
    return ModelConfig(
        arch="baichuan",
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=hidden // heads,
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        max_position_embeddings=hf.get("model_max_length",
                                       hf.get("max_position_embeddings", 4096)),
        position_embedding=(PositionEmbedding.ALIBI if alibi
                            else PositionEmbedding.ROPE),
        tie_word_embeddings=False,
    )


class _BaichuanConverter:
    """HF tensors -> the param tree (leaves [in, out], stacked over the
    layers): W_pack split into q, k, v; with `normalize_head` each lm_head
    row divided by its L2 norm + 1e-7 in f32 before the cast."""

    def __init__(self, normalize_head: bool):
        self.normalize_head = normalize_head

    def convert(self, tensors: Dict, cfg: ModelConfig, dtype) -> Dict:
        t = tensors

        def get(name):
            return _to_np(t[name])

        def lin(w):
            return {"w": _cast(w.T, dtype)}

        def layer(i):
            base = f"model.layers.{i}"
            q_w, k_w, v_w = np.split(get(f"{base}.self_attn.W_pack.weight"),
                                     3, axis=0)
            return {
                "input_layernorm": _cast(
                    get(f"{base}.input_layernorm.weight"), dtype),
                "post_attention_layernorm": _cast(
                    get(f"{base}.post_attention_layernorm.weight"), dtype),
                "q_proj": lin(q_w),
                "k_proj": lin(k_w),
                "v_proj": lin(v_w),
                "o_proj": lin(get(f"{base}.self_attn.o_proj.weight")),
                "gate_proj": lin(get(f"{base}.mlp.gate_proj.weight")),
                "up_proj": lin(get(f"{base}.mlp.up_proj.weight")),
                "down_proj": lin(get(f"{base}.mlp.down_proj.weight")),
            }

        head = get("lm_head.weight").astype(np.float32)
        if self.normalize_head:
            head = head / (np.linalg.norm(head, axis=-1, keepdims=True) +
                           1e-7)
        return {
            "embed_tokens": {"w": _cast(get("model.embed_tokens.weight"),
                                        dtype)},
            "norm": _cast(get("model.norm.weight"), dtype),
            "lm_head": {"w": _cast(head.T, dtype)},
            "layers": stack_layer_trees([layer(i)
                                         for i in range(cfg.num_layers)]),
        }


@register_model("BaichuanForCausalLM", "BaiChuanForCausalLM", "baichuan")
def build_baichuan():
    # Baichuan2's NormHead; v1 and v2 look alike in their configs, so v2's
    # semantics (the JAX package's default)
    return _model_config, _BaichuanConverter(normalize_head=True)
