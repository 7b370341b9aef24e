"""Model architecture configuration.

The reference carries model-intrinsic config in its protobuf IR `ConfigProto`
(csrc/proto/allspark.proto:85-109) produced by the Python converters
(python/pyhie/allspark/model/*.py). Here it is a frozen (hashable)
dataclass, a copy of `dashinfer_tpu.config.model_config` so that the port
imports nothing of the JAX package. The per-op PyTorch path of this package
serves dense pre-LN RoPE models; the other fields are kept so that configs
built for the JAX package load unchanged.
"""

import dataclasses
import enum
from typing import Optional, Tuple


class PositionEmbedding(str, enum.Enum):
    """Positional scheme (reference rotary invfreq types: allspark.proto:78-83)."""

    ROPE = "rope"                # standard rotary (Llama/Qwen)
    ROPE_NTK = "rope_ntk"        # dynamic NTK scaling
    ROPE_YARN = "rope_yarn"      # YaRN scaling
    ALIBI = "alibi"              # Baichuan-13B / Bloom style
    LEARNED = "learned"          # GPT-2 learned positional embeddings
    MROPE = "mrope"              # Qwen2-VL multimodal 3D rotary


class Activation(str, enum.Enum):
    SILU = "silu"
    GELU = "gelu"
    GELU_TANH = "gelu_tanh"
    RELU = "relu"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (reference: MOE op, moe_op.cpp; Qwen2-MoE
    converter python/pyhie/allspark/model/qwen_v20_moe.py)."""

    num_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    shared_expert_intermediate_size: int = 0  # Qwen2-MoE shared expert
    norm_topk_prob: bool = False
    # layers that are dense instead of MoE (e.g. qwen2-moe decoder_sparse_step)
    mlp_only_layers: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE scaling parameters (reference: qwen_v15.py:224-256 NTK/YaRN/logn)."""

    kind: str = "none"  # none | dynamic_ntk | yarn | linear
    factor: float = 1.0
    original_max_position: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None
    # logn attention scaling (Qwen1 style)
    use_logn_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for the generic decoder transformer.

    One generic config covers the reference's model zoo (SURVEY.md §2.3):
    Qwen (qkv bias), Llama, Qwen3 (per-head QK RMSNorm, qwen_v30.py:228-319),
    ChatGLM (MQA + interleaved rotary), Baichuan (ALiBi for 13B), Qwen2-MoE.
    """

    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 32768
    activation: Activation = Activation.SILU
    position_embedding: PositionEmbedding = PositionEmbedding.ROPE
    rope_scaling: RopeScaling = RopeScaling()
    # rotary applied to only the first `rotary_dim` dims of each head
    # (ChatGLM2+ uses head_dim//2); 0 means full head_dim.
    rotary_dim: int = 0
    rope_interleaved: bool = False  # ChatGLM-style pairwise interleave
    qkv_bias: bool = False          # Qwen1/2 use attention bias
    o_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False           # Qwen3 per-head QK RMSNorm
    tie_word_embeddings: bool = False
    # logit soft-capping (not in reference zoo but cheap to support)
    final_logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    # mrope section sizes for Qwen2-VL (t, h, w)
    mrope_section: Tuple[int, ...] = ()
    # GPT-NeoX-style parallel residual: h += attn(ln1 h) + mlp(ln2 h)
    parallel_residual: bool = False
    # ChatGLM v1 (GLM) structure (reference converter chatglm_v1.py):
    # alpha-scaled post-LN residuals h = ln(x)*alpha + sublayer(ln(x)) with
    # alpha = sqrt(2*num_layers); 2-D rotary over head_dim/2 halves
    # (position, block-position); prefix-LM attention (bidirectional over
    # the prompt except its final token).
    glm_residual_alpha: float = 0.0
    rope_glm_2d: bool = False
    prefix_lm: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def validate(self) -> None:
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.hidden_size % self.num_heads and self.head_dim <= 0:
            raise ValueError("head_dim must be set when hidden_size is not "
                             "a multiple of num_heads")
