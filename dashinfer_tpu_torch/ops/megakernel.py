"""Whole-model decode megakernel: one kernel launch per decode forward.

Counterpart of `dashinfer_tpu.ops.pallas.megakernel`. What lives here:

* the install-time helpers on numpy leaves, leaf for leaf equal to the JAX
  package's: `weight_only_decode_view` (a8w8 leaves re-expressed as
  per-channel weight-only int8) and `expand_u4_to_i8` (group-wise u4 leaves
  re-quantized to per-channel int8: twice the bytes, one affine per column);
* `supports`: which models take the path;
* `MegaPlan` / `make_plan` / `pack_params` / `pack_cache_key_fields`;
* `decode_megakernel_ref`, the plain PyTorch version of the whole step, and
  `decode_megakernel`, the wrapper that launches csrc/megakernel.cu on a
  CUDA tensor (and takes the plain version only for CPU tensors), with its
  launch count `decode_megakernel.counter` (`.lora_counter` for launches
  with an adapter pool: the kernel's LoRA branch, `LoraStep` its
  arithmetic, `supports_lora_epilogue` which plans take it).

Pack geometry (the port's own). The TPU kernel streams a re-laid copy of
the weights: fused q|k|v rows, chunked payloads, 128-lane padded bf16
qparams. The CUDA kernel also streams a re-laid copy, for this card's
reason. Its dot is the tensor cores' `mma.sync`, whose B operand pairs two
K rows of one column in a register; the loader's leaves `[L, K, N]` keep K
as the slow axis, so a kernel that streams them as they are gathers its
operands from shared memory byte by byte, and that gather, not the card's
memory, set its rate (tools/bench_stream.py: 1.1-1.2 TB/s for u4, the dot
alone as slow as the loads alone). `pack_params` therefore lays each
payload out in FRAGMENT ORDER, `[L, N/256, K/64, chunk]`: each 256-column
tile's 64-row chunks one after the other (a chunk is one contiguous run of
8 / 16 / 32 KB for u4 / int8 / bf16), and inside a chunk the 16 bytes each
lane needs next to each other, so a stage reads its operands with 16-byte
loads. q, k, v, o, gate, up, down and lm_head stay separate leaves; the f32
`scale` / `zero` `[L, G, N]` are streamed as the loader holds them. The
prefill megakernel (ops/prefill_megakernel.py) reads the same pack. The
pack is a second copy of the payloads while the raw params stay resident
for the per-op path (`weight_residency` "both": prefill buckets the
prefill megakernel does not take, or a model it turns down): for Qwen2-7B
a16w4 3.3 GiB beside 4.7 GiB of raw params, which the runtime logs at
install; under `weight_residency` "pack_only" the runtime moves the raw
payloads to host memory and the pack is the only copy on the card. Under
the u4 -> i8 stream rule the pack is the int8 re-expansion
itself (6.6 GiB). It also holds small f32 arrays: the norm weights, the
fused q|k|v bias and a QK-norm model's per-head q / k norm weights
(`qk_norms` [L, 2, D]), rounded to bf16 as the TPU pack rounds them, and an
ALiBi model's slopes (`slopes` [H] f32; on a model axis the rank's slice of
the global table, ops/tp_megakernel.py `make_tp_plan`). A
plain tile-major copy without the fragment order was measured too and
streams no faster than the loader's leaves (PERF.md).

Numerics (the TPU kernel's rounding points): residual in f32; x_norm, the
rotated q, attn_out and the SwiGLU activation rounded to bf16; dots on bf16
operands with f32 accumulation and the per-group affine after the dot,
`out = sum_g (x_g @ q_g) * s_g + xsum_g * z_g` with xsum over the bf16 x;
bias, a QK-norm model's per-head RMSNorm of q and k in f32 (`blk *
rsqrt(mean(blk^2) + eps) * w`), then RoPE with bf16 cos/sin tiles (an ALiBi
model: no rotation, the tiles are not read; each score gains
`slope_h * (t - lens[b])` after the scale, 0 for the new token). The new
token is attended from its
unquantized f32 K/V and only what is written to the pool is quantized, so
this path differs from `transformer.decode_forward` (which appends the
quantized token and then attends) by design. Inactive slots write nothing
to the pool and their logits rows are unspecified. The weight
qparams are streamed as the loader's f32 leaves and rounded to bf16 where
they are applied, because the TPU pack stores them in bf16.
"""

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.config import CacheMode, ModelConfig, RuntimeConfig
# the targets in the kernel's order (csrc LoraTarget)
from dashinfer_tpu_torch.lora.manager import TARGETS as LORA_TARGETS
from dashinfer_tpu_torch.ops import kernel_build, kv_ops
from dashinfer_tpu_torch.ops.attention import alibi_slopes
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

PACK_VERSION = 3   # bump when what pack_params returns changes
MAX_BATCH = 64
CHUNK_K = 64        # K rows per pipeline stage of the kernel
ATT_TILE = 128      # attention chunks are whole tiles of this many tokens
MAX_ATT_CHUNKS = 16  # attention chunks a slot (csrc kMaxChunks)
_NEG_INF = torch.finfo(torch.float32).min
_LAYER_STREAMS = (("qkv", ("q_proj", "k_proj", "v_proj")),
                  ("o", ("o_proj",)),
                  ("gu", ("gate_proj", "up_proj")),
                  ("dn", ("down_proj",)))


# ---------------------------------------------------------------------------
# install-time helpers on numpy leaves
# ---------------------------------------------------------------------------

def _is_int8(a) -> bool:
    return str(a.dtype).endswith("int8") and not str(a.dtype).endswith("uint8")


def _weight_bits(leaf) -> int:
    if not isinstance(leaf, dict) or "w_q" not in leaf:
        return 16
    return 8 if _is_int8(leaf["w_q"]) else 4


def _unpack_u4_np(w_q: np.ndarray) -> np.ndarray:
    """Loader's packed u4 [K, N/2] -> levels [K, N] (TILE-128 halves when
    N % 256 == 0, plain halves otherwise: ops/u4pack.py)."""
    K, half = w_q.shape
    N = 2 * half
    lo, hi = w_q & 0xF, w_q >> 4
    if N % 256 == 0:
        return np.concatenate([lo.reshape(K, N // 256, 128),
                               hi.reshape(K, N // 256, 128)],
                              axis=-1).reshape(K, N)
    return np.concatenate([lo, hi], axis=-1)


def weight_only_decode_view(params: Dict) -> Optional[Dict]:
    """An a8w8 model decodes weight-only: each symmetric per-channel int8
    leaf {w_q8 [.., K, N], wscale [.., 1, N]} becomes {w_q, scale, zero=0}
    with one group. Returns params untouched when it has no such leaf, a
    converted shallow copy when it has, or None when the model cannot take
    the weight-only path (fp8 payloads; K not a multiple of 128)."""

    def convert(leaf):
        if not isinstance(leaf, dict) or "w_q8" not in leaf:
            return leaf
        w = np.asarray(leaf["w_q8"])
        s = np.asarray(leaf["wscale"], np.float32)
        if w.shape[-2] % 128:
            raise ValueError
        gshape = s.shape[:-2] + (1, s.shape[-1])
        out = {"w_q": w, "scale": s.reshape(gshape),
               "zero": np.zeros(gshape, np.float32)}
        if "b" in leaf:
            out["b"] = leaf["b"]
        return out

    try:
        found = False
        new_layers = {}
        for name, leaf in params["layers"].items():
            if isinstance(leaf, dict) and "w_f8" in leaf:
                return None
            nl = convert(leaf)
            found |= nl is not leaf
            new_layers[name] = nl
        lm = params.get("lm_head")
        if isinstance(lm, dict) and "w_f8" in lm:
            return None
        new_lm = convert(lm) if isinstance(lm, dict) else lm
        found |= new_lm is not lm
        if not found:
            return params
        out = dict(params)
        out["layers"] = new_layers
        if new_lm is not lm:
            out["lm_head"] = new_lm
        return out
    except (ValueError, KeyError):
        return None


def expand_u4_to_i8(params: Dict, meta_only: bool = False) -> Optional[Dict]:
    """Group-wise asymmetric u4 leaves -> PER-CHANNEL asymmetric int8 leaves
    ("serve u4 checkpoints through the i8 stream"): twice the streamed
    bytes, but one convert per element and one affine per column instead of
    one per group. Per channel the i8 grid has 255 steps over the channel's
    whole range; unless one group's range is ~17x another's in the same
    channel the added error stays below the u4 error already there.

    meta_only=True gives leaves of the right shape and dtype with zero
    payloads, for `supports` / `make_plan`. Returns a converted shallow
    copy, or None when params hold no u4 leaf."""

    def convert(leaf):
        if _is_int8(leaf["w_q"]):
            return leaf
        wq = np.asarray(leaf["w_q"])
        s = np.asarray(leaf["scale"], np.float32)
        z = np.asarray(leaf["zero"], np.float32)
        lead = wq.shape[:-2]
        K, N = wq.shape[-2], 2 * wq.shape[-1]
        if meta_only:
            out = {"w_q": np.zeros(lead + (K, N), np.int8),
                   "scale": np.zeros(lead + (1, N), np.float32),
                   "zero": np.zeros(lead + (1, N), np.float32)}
        else:
            out_q = np.empty(lead + (K, N), np.int8)
            out_s = np.empty(lead + (1, N), np.float32)
            out_z = np.empty(lead + (1, N), np.float32)
            gs = K // s.shape[-2]
            for idx in np.ndindex(lead if lead else (1,)):
                sl = idx if lead else ()
                q = _unpack_u4_np(wq[sl]).astype(np.float32)
                w = q * np.repeat(s[sl], gs, axis=0) + \
                    np.repeat(z[sl], gs, axis=0)
                wmin, wmax = w.min(axis=0), w.max(axis=0)
                s8 = np.maximum((wmax - wmin) / 255.0, 1e-8)
                out_q[sl] = np.clip(np.rint((w - wmin) / s8) - 128.0,
                                    -128, 127).astype(np.int8)
                out_s[sl] = s8[None]
                out_z[sl] = (wmin + 128.0 * s8)[None]
            out = {"w_q": out_q, "scale": out_s, "zero": out_z}
        if "b" in leaf:
            out["b"] = leaf["b"]
        return out

    found = False

    def walk(tree):
        nonlocal found
        if isinstance(tree, dict) and "w_q" in tree:
            nl = convert(tree)
            found |= nl is not tree
            return nl
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    out = walk(params)
    return out if found else None


def expand_u4_to_i8_tensors(params: Dict, col_block: int = 16384
                            ) -> Optional[Dict]:
    """`expand_u4_to_i8` for tensor leaves, on the device that holds them:
    the same arithmetic in the same order, so the leaves equal the numpy
    function's. The runtime's params are tensors by the time the stream
    rule runs, and a 7B model re-expands on the card in seconds; columns
    are converted `col_block` at a time to bound the f32 temporaries."""

    def convert(leaf):
        wq = leaf["w_q"]
        if wq.dtype == torch.int8:
            return leaf
        s, z = leaf["scale"].float(), leaf["zero"].float()
        lead = tuple(wq.shape[:-2])
        K, N = wq.shape[-2], 2 * wq.shape[-1]
        gs = K // s.shape[-2]
        out_q = torch.empty(lead + (K, N), dtype=torch.int8, device=wq.device)
        out_s = torch.empty(lead + (1, N), dtype=torch.float32,
                            device=wq.device)
        out_z = torch.empty_like(out_s)
        for idx in np.ndindex(lead if lead else (1,)):
            sl = idx if lead else ()
            levels = weight_levels(wq[sl])
            for c0 in range(0, N, col_block):
                c = slice(c0, min(N, c0 + col_block))
                w = levels[:, c].float() * \
                    s[sl][:, c].repeat_interleave(gs, dim=0) + \
                    z[sl][:, c].repeat_interleave(gs, dim=0)
                wmin, wmax = w.amin(dim=0), w.amax(dim=0)
                s8 = ((wmax - wmin) / 255.0).clamp_min(1e-8)
                out_q[sl][:, c] = (torch.round((w - wmin) / s8) - 128.0
                                   ).clamp(-128, 127).to(torch.int8)
                out_s[sl][0, c] = s8
                out_z[sl][0, c] = wmin + 128.0 * s8
        out = {"w_q": out_q, "scale": out_s, "zero": out_z}
        if "b" in leaf:
            out["b"] = leaf["b"]
        return out

    found = False

    def walk(tree):
        nonlocal found
        if isinstance(tree, dict) and "w_q" in tree:
            nl = convert(tree)
            found |= nl is not tree
            return nl
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    out = walk(params)
    return out if found else None


def _group_ok(leaf, K: int) -> bool:
    """A quantized leaf's groups: a multiple of 128 rows, or one group."""
    if not isinstance(leaf, dict) or "w_q" not in leaf:
        return True
    gs = K // leaf["scale"].shape[-2]
    return not (gs % 128 and gs != K)


def _moe_supports(cfg: ModelConfig, lp: Dict) -> bool:
    """The JAX package's MoE rules (ops/pallas/megakernel.py
    `_moe_supports`): homogeneous MoE layers, at most 512 router lanes and
    8 experts a token, weight-only experts with equal gate / up bits and
    group sizes a multiple of 128 (or one group), a bias-free shared expert
    with the same rules."""
    moe = cfg.moe
    if moe.mlp_only_layers:
        return False
    lanes = moe.num_experts + (1 if moe.shared_expert_intermediate_size
                               else 0)
    if lanes > 512 or moe.num_experts_per_tok > 8:
        return False
    ex = lp.get("experts")
    if not isinstance(ex, dict) or "router" not in lp:
        return False
    for name in _MLP:
        leaf = ex.get(name)
        if leaf is None or (isinstance(leaf, dict) and
                            ("w_q8" in leaf or "w_f8" in leaf)):
            return False
    if _weight_bits(ex["gate_proj"]) != _weight_bits(ex["up_proj"]):
        return False
    Im, hid = moe.moe_intermediate_size, cfg.hidden_size
    for name, K in (("gate_proj", hid), ("up_proj", hid), ("down_proj", Im)):
        if not _group_ok(ex[name], K):
            return False
    if moe.shared_expert_intermediate_size:
        se = lp.get("shared_expert")
        if not isinstance(se, dict):
            return False
        sIm = moe.shared_expert_intermediate_size
        for name, K in (("gate_proj", hid), ("up_proj", hid),
                        ("down_proj", sIm)):
            leaf = se.get(name)
            if leaf is None or "w_q8" in leaf or "w_f8" in leaf or \
                    "b" in leaf or not _group_ok(leaf, K):
                return False
        if _weight_bits(se["gate_proj"]) != _weight_bits(se["up_proj"]):
            return False
    return True


def supports(cfg: ModelConfig, rt: RuntimeConfig, params: Dict) -> bool:
    """Whether the model takes the megakernel path (the per-op path serves
    it otherwise). The JAX package's rules for what the port has: pre-LN
    RoPE models, dense or MoE (`_moe_supports`), head_dim 128, max_batch
    <= 64, no activation-quant leaves, equal bits within q/k/v and within
    gate/up, no o or MLP bias, group sizes a multiple of 128 (or one group);
    QK-norm (Qwen3) with plain [D] `q_norm` / `k_norm` leaves; ALiBi
    (Baichuan-13B) with RMSNorm leaves (a LayerNorm model, Bloom, says no).
    A tied quantized lm_head is not in the port's kernel yet and says no. Two
    TPU tiling rules are dropped because they mean
    nothing on this card: page_size % 8 (the RMW window) and the UINT4
    `KH * D / 2 >= 128` lane rule. Params may be numpy or tensor leaves
    (only shapes are read)."""
    try:
        lp = params["layers"]
        if cfg.qk_norm:
            # the kernels' per-head RMS needs plain [D] norm weights
            qn = lp.get("q_norm")
            if qn is None or isinstance(qn, dict) or "k_norm" not in lp:
                return False
        if cfg.moe is not None:
            if not _moe_supports(cfg, lp):
                return False
        else:
            for name in ("gate_proj", "down_proj"):
                if "w_q8" in lp[name] or "w_f8" in lp[name]:
                    return False
            for name in _MLP:
                if "b" in lp[name]:
                    return False
            if _weight_bits(lp["gate_proj"]) != _weight_bits(lp["up_proj"]):
                return False
            if not (_group_ok(lp["gate_proj"], cfg.hidden_size) and
                    _group_ok(lp["down_proj"], cfg.intermediate_size)):
                return False
        for name in ("q_proj", "o_proj"):
            if "w_q8" in lp[name] or "w_f8" in lp[name]:
                return False
        if cfg.head_dim != 128:
            return False
        if cfg.hidden_size % 128 or (cfg.num_heads * cfg.head_dim) % 128:
            return False
        pe = cfg.position_embedding.value
        if pe == "alibi":
            # the kernels' RMSNorm: a plain [hid] leaf, not LayerNorm's w / b
            if isinstance(lp["input_layernorm"], dict):
                return False
        elif pe != "rope" or cfg.rope_interleaved:
            return False
        if cfg.rope_glm_2d or cfg.glm_residual_alpha or cfg.prefix_lm:
            return False
        if cfg.rotary_dim and cfg.rotary_dim != cfg.head_dim:
            return False
        if cfg.final_logit_softcap or cfg.rope_scaling.use_logn_attn:
            return False
        if cfg.rope_scaling.kind != "none" or cfg.parallel_residual or \
                cfg.tie_word_embeddings:
            return False   # not in the port's model code yet
        if rt.max_batch > MAX_BATCH:
            return False
        if "b" in lp["o_proj"]:
            return False
        for name in ("q_proj", "k_proj", "v_proj"):
            if _weight_bits(lp[name]) != _weight_bits(lp["q_proj"]):
                return False
        return (_group_ok(lp["q_proj"], cfg.hidden_size) and
                _group_ok(lp["o_proj"], cfg.num_heads * cfg.head_dim))
    except Exception:
        return False


LORA_KC = 512          # K rows of a rank-projection item (csrc kLoraKC)
LORA_MAX_RANK = 64     # csrc kMaxLoraRank (and a multiple of 8)
LORA_MAX_SLOTS = 64    # csrc kMaxLoraSlots
LORA_ARGS = 21         # integers of the LoRA tail (csrc kLoraArgs)


def supports_lora_epilogue(plan, max_num: int, max_rank: int) -> bool:
    """Whether the kernel's LoRA branch takes batches with adapters: a
    dense RoPE plan (a MoE model decodes LoRA batches per-op, as in the JAX
    package; an ALiBi one too, its kernel an instantiation without the
    branch) and a pool the branch can read (at most LORA_MAX_SLOTS slots,
    a rank that is a multiple of 8 up to LORA_MAX_RANK). The JAX rule's
    `interleave` is a TPU pack geometry its runtime always builds."""
    return (plan.E == 0 and not plan.alibi and
            0 < max_num <= LORA_MAX_SLOTS and
            0 < max_rank <= LORA_MAX_RANK and max_rank % 8 == 0)


def lora_bytes(plan, pool: Dict, slots_used: int) -> int:
    """Bytes of the adapter pool one step must read: A and B of the seven
    targets of every layer for each slot that some active row uses."""
    return slots_used * sum(
        (pool["A"][t][:, 0].numel() + pool["B"][t][:, 0].numel()) *
        pool["A"][t].element_size() for t in LORA_TARGETS)


# ---------------------------------------------------------------------------
# plan and pack
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One weight stream: the leaves whose columns it concatenates. A MoE
    expert stream (E > 0) has E such matrices a layer, one per expert."""

    name: str
    leaves: Tuple[str, ...]
    bits: int                 # 4, 8 or 16 (bf16)
    K: int
    N: Tuple[int, ...]        # columns of each leaf (the model's widths)
    gs: int                   # quant group size along K (0 for bf16)
    E: int = 0                # experts (0: one matrix a layer)

    @property
    def Ntot(self) -> int:
        return sum(self.N)

    @property
    def Np(self) -> Tuple[int, ...]:
        """Columns of each leaf in the pack: padded to the kernels'
        256-column tiles."""
        return tuple(-(-n // 256) * 256 for n in self.N)

    @property
    def Nptot(self) -> int:
        return sum(self.Np)

    @property
    def payload_bytes(self) -> int:
        """Bytes of one matrix (one expert's, for an expert stream)."""
        return self.K * self.Ntot * self.bits // 8

    @property
    def qparam_bytes(self) -> int:
        return 0 if not self.gs else 2 * 4 * (self.K // self.gs) * self.Ntot

    @property
    def matrix_bytes(self) -> int:
        return self.payload_bytes + self.qparam_bytes


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    B: int
    L: int
    hid: int
    H: int
    KH: int
    D: int
    G: int
    inter: int                # MLP width (a MoE model: each expert's)
    QKVN: int
    V: int
    ps: int
    maxP: int
    kv_mode: CacheMode
    kv_bits: int              # 16 / 8 / 4
    kv_dtype_name: str
    has_qkv_bias: bool
    qkv: StreamPlan
    o: StreamPlan
    gu: StreamPlan            # a MoE model: the experts' gate|up
    dn: StreamPlan            # a MoE model: the experts' down
    lm: StreamPlan
    rms_eps: float
    qk_norm: bool = False     # per-head RMSNorm of q and k (Qwen3)
    alibi: bool = False       # ALiBi score bias in place of RoPE
    # MoE (the TPU kernel's router phase + per-expert streams + shared
    # expert): E experts, top-k gates from a softmax over the bf16 router
    # product; the router stream has EP columns (E, then the shared
    # expert's gate column when there is one, padded to 128)
    E: int = 0
    k_top: int = 0
    norm_topk: bool = False
    has_shared: bool = False
    has_shared_gate: bool = False
    EP: int = 0
    shared_inter: int = 0
    rt: Optional[StreamPlan] = None
    sgu: Optional[StreamPlan] = None
    sdn: Optional[StreamPlan] = None
    # a TP plan of a MoE model (ops/tp_megakernel.py): E is the rank's
    # experts, E_global all of them; the router stream (EP columns) is the
    # global one, which every rank computes
    E_global: int = 0

    @property
    def kernel_streams(self) -> Tuple[Optional[StreamPlan], ...]:
        """The streams in the kernels' order (csrc/di_product.cuh
        StreamId); None where the model has no such stream."""
        return (self.qkv, self.o, self.gu, self.dn, self.lm, self.rt,
                self.sgu, self.sdn)

    @property
    def streams(self) -> Tuple[StreamPlan, ...]:
        return tuple(sp for sp in self.kernel_streams if sp is not None)

    @property
    def layer_streams(self) -> Tuple[StreamPlan, ...]:
        return tuple(sp for sp in self.streams if sp.name != "lm")

    def layer_bytes(self, experts: Optional[float] = None) -> float:
        """Bytes of one layer's weights; `experts`: how many experts' streams
        count (all E by default)."""
        n_e = self.E if experts is None else experts
        return sum(sp.matrix_bytes * (n_e if sp.E else 1)
                   for sp in self.layer_streams)

    @property
    def weight_bytes(self) -> int:
        """Bytes one step streams when every expert streams: every payload
        and qparam once."""
        return int(self.L * self.layer_bytes() + self.lm.matrix_bytes)


def _stream_plan(name, leaf_names, leaves, gaxis, E=0,
                 widths: Optional[Tuple[int, ...]] = None) -> StreamPlan:
    """`widths`: the leaves' true columns, where a leaf may hold more (an
    expert leaf padded by `prepare_grouped_experts`)."""
    first = leaves[0]
    bits = _weight_bits(first)
    if bits == 16:
        K = first["w"].shape[-2]
        N = widths or tuple(int(lf["w"].shape[-1]) for lf in leaves)
        return StreamPlan(name, leaf_names, 16, int(K), N, 0, E)
    K = first["w_q"].shape[-2]
    N = widths or tuple(int(lf["scale"].shape[-1]) for lf in leaves)
    g = first["scale"].shape[gaxis]
    return StreamPlan(name, leaf_names, bits, int(K), N, int(K // g), E)


def _expert_leaf(leaf) -> Dict:
    """An expert stack as a leaf dict (a raw [L, E, K, N] array -> {"w"})."""
    return leaf if isinstance(leaf, dict) else {"w": leaf}


_MLP = ("gate_proj", "up_proj", "down_proj")


def make_plan(cfg: ModelConfig, rt: RuntimeConfig, params: Dict) -> MegaPlan:
    """Shapes of one decode step. Params may be numpy or tensor leaves."""
    lp = params["layers"]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hid = cfg.hidden_size
    sp = {name: _stream_plan(name, leaves, [lp[n] for n in leaves], 1)
          for name, leaves in _LAYER_STREAMS[:2]}
    moe_kw, inter = {}, cfg.intermediate_size
    if cfg.moe is not None:
        moe = cfg.moe
        ex = {n: _expert_leaf(lp["experts"][n]) for n in _MLP}
        E = moe.num_experts
        inter = moe.moe_intermediate_size
        sp["gu"] = _stream_plan("gu", ("experts.gate_proj", "experts.up_proj"),
                                [ex["gate_proj"], ex["up_proj"]], 2, E,
                                (inter, inter))
        sp["dn"] = _stream_plan("dn", ("experts.down_proj",),
                                [ex["down_proj"]], 2, E, (hid,))
        has_shared = bool(moe.shared_expert_intermediate_size)
        has_sg = has_shared and "shared_expert_gate" in lp
        EP = -(-(E + int(has_sg)) // 128) * 128
        moe_kw = dict(E=E, k_top=moe.num_experts_per_tok,
                      norm_topk=moe.norm_topk_prob, has_shared=has_shared,
                      has_shared_gate=has_sg, EP=EP,
                      rt=StreamPlan("rt", ("router",), 16, hid, (EP,), 0))
        if has_shared:
            se = lp["shared_expert"]
            moe_kw.update(
                shared_inter=moe.shared_expert_intermediate_size,
                sgu=_stream_plan("sgu", ("shared.gate_proj",
                                         "shared.up_proj"),
                                 [se["gate_proj"], se["up_proj"]], 1),
                sdn=_stream_plan("sdn", ("shared.down_proj",),
                                 [se["down_proj"]], 1))
    else:
        sp.update({name: _stream_plan(name, leaves, [lp[n] for n in leaves],
                                      1)
                   for name, leaves in _LAYER_STREAMS[2:]})
    lm = _stream_plan("lm", ("lm_head",), [params["lm_head"]], 0)
    mode = rt.cache.mode
    if mode == CacheMode.DEFAULT:
        kv_dtype_name = "float32" if rt.dtype == "float32" else "bfloat16"
    else:
        kv_dtype_name = "int8" if mode == CacheMode.INT8 else "uint8"
    return MegaPlan(
        B=rt.max_batch, L=cfg.num_layers, hid=hid, H=H, KH=KH,
        D=D, G=H // KH, inter=inter,
        QKVN=(H + 2 * KH) * D, V=cfg.vocab_size, ps=rt.cache.page_size,
        maxP=rt.max_pages_per_seq, kv_mode=mode,
        kv_bits={CacheMode.DEFAULT: 16, CacheMode.INT8: 8,
                 CacheMode.UINT4: 4}[mode],
        kv_dtype_name=kv_dtype_name, has_qkv_bias="b" in lp["q_proj"],
        qkv=sp["qkv"], o=sp["o"], gu=sp["gu"], dn=sp["dn"], lm=lm,
        rms_eps=cfg.rms_norm_eps, qk_norm=cfg.qk_norm,
        alibi=cfg.position_embedding.value == "alibi", **moe_kw)


def pack_cache_key_fields(plan: MegaPlan) -> tuple:
    """The plan fields the packed arrays depend on: not the batch, the page
    geometry or the KV mode, so those may change under one pack."""
    return (PACK_VERSION, plan.L, plan.hid, plan.H, plan.KH, plan.D, plan.V,
            plan.has_qkv_bias, plan.qk_norm, plan.alibi, plan.E, plan.EP,
            plan.E_global) + \
        plan.kernel_streams


# Fragment order (csrc/di_product.cuh `Tile`): a payload row index is
# 16 s + 8 i + 2 tig + p within its 64-row chunk C, a column is
# 256 T + 128 half + 16 w + 8 nt + gid (a u4 byte holds both halves). The
# kernel wants, per (tile T, chunk C, warp w), runs of 512 bytes that hold
# 16 bytes for each lane (gid, tig).
_ROWS = (("s", 4), ("i", 2), ("tig", 4), ("p", 2))
_FRAG = {
    4: ((("C", 0), ("q", 2), ("s2", 2)) + _ROWS[1:] +
        (("T", 0), ("w", 8), ("nt", 2), ("gid", 8)),
        ("T", "C", "w", "q", "gid", "tig", "s2", "nt", "i", "p")),
    8: ((("C", 0),) + _ROWS +
        (("T", 0), ("half", 2), ("w", 8), ("nt", 2), ("gid", 8)),
        ("T", "C", "w", "s", "gid", "tig", "nt", "i", "half", "p")),
    16: ((("C", 0),) + _ROWS +
         (("T", 0), ("half", 2), ("w", 8), ("nt", 2), ("gid", 8)),
         ("T", "C", "w", "s", "nt", "gid", "tig", "i", "half", "p")),
}
_PAY_BITS = {torch.uint8: 4, torch.int8: 8, torch.bfloat16: 16}


def can_pack_payload(pay: torch.Tensor) -> bool:
    """Whether a payload goes into the pack: K in 64-row chunks (the pack
    pads any width to its 256-column tiles)."""
    return pay.shape[-2] % CHUNK_K == 0


def pad_payload(pay: torch.Tensor, n: int) -> torch.Tensor:
    """A loader payload of n columns zero-padded to the next multiple of
    256, in the loader's layout for that width (a u4 payload of n % 256 !=
    0 holds plain halves, whatever n mod 256 is; the padded one TILE-128
    halves)."""
    np_ = -(-n // 256) * 256
    if np_ == n:
        return pay
    if pay.dtype != torch.uint8:
        return torch.nn.functional.pad(pay, (0, np_ - n))
    *lead, K, half = pay.shape
    q = torch.zeros((math.prod(lead) * K, np_), dtype=torch.uint8,
                    device=pay.device)
    q[:, :n] = weight_levels(pay.reshape(-1, half))
    t = q.reshape(-1, np_ // 256, 2, 128)
    return (t[:, :, 0] | (t[:, :, 1] << 4)).reshape(*lead, K, np_ // 2)


def pack_payload(pay: torch.Tensor) -> torch.Tensor:
    """Loader payload [.., K, N*] (TILE-128 u4 bytes, int8 or bf16; N a
    multiple of 256) -> [.., N/256, K/64, chunk] in the kernel's fragment
    order (a copy): each 256-column tile's 64-row chunks one after the
    other, each chunk laid out so that every lane of the product finds its
    mma operands in 16-byte pieces."""
    src, dst = _FRAG[_PAY_BITS[pay.dtype]]
    *lead, K, n = pay.shape
    units = 128 if pay.dtype == torch.uint8 else 256
    size = dict(src, C=K // CHUNK_K, T=n // units)
    x = pay.reshape(*lead, *(size[d] for d, _ in src))
    names = [d for d, _ in src]
    perm = list(range(len(lead))) + [len(lead) + names.index(d) for d in dst]
    return x.permute(perm).reshape(*lead, size["T"], size["C"],
                                   CHUNK_K * units).contiguous()


def unpack_payload(w_f: torch.Tensor) -> torch.Tensor:
    """pack_payload's inverse (a copy; the plain version uses it)."""
    src, dst = _FRAG[_PAY_BITS[w_f.dtype]]
    *lead, T, C, _ = w_f.shape
    units = 128 if w_f.dtype == torch.uint8 else 256
    size = dict(src, C=C, T=T)
    x = w_f.reshape(*lead, *(size[d] for d in dst))
    names = [d for d, _ in src]
    perm = list(range(len(lead))) + [len(lead) + dst.index(d) for d in names]
    return x.permute(perm).reshape(*lead, C * CHUNK_K, T * units)


def packed_leaf(leaf: Dict) -> Dict:
    """One weight leaf of the loader as the pack holds it: the payload in
    fragment order under "w_f" (a copy), scale / zero as they are. Columns
    that are not a multiple of 256 (a vocab or an expert width of 128 mod
    256, a vocab shard of 64 or 32 mod 128 on a model axis) are
    zero-padded in the pack, payload and scale / zero alike, so the padded
    columns compute 0; the plan keeps the true width, and the kernels'
    callers read only those columns. An expert leaf that the install
    already padded for the grouped kernel (ops/grouped_quant_matmul.py
    `prepare_grouped_experts`) is packed as it is, sharing its scale /
    zero. A leaf the kernel cannot take (K % 64: tiny models, which only
    the plain version runs) keeps the loader's layout."""
    pay = leaf["w_q"] if "w_q" in leaf else leaf["w"].to(torch.bfloat16)
    out = {k: leaf[k] for k in ("scale", "zero") if k in leaf}
    n = leaf["scale"].shape[-1] if "scale" in leaf else pay.shape[-1]
    if not can_pack_payload(pay):
        out["w_q" if "w_q" in leaf else "w"] = pay.contiguous()
        return out
    if n % 256:
        pad = -(-n // 256) * 256 - n
        out = {k: torch.nn.functional.pad(v, (0, pad))
               for k, v in out.items()}
    out["w_f"] = pack_payload(pad_payload(pay, n))
    return out


def loader_view(leaf: Dict) -> Dict:
    """A leaf in either layout with its payload under the loader's key
    (an unpacked copy for a packed leaf)."""
    if "w_f" not in leaf:
        return leaf
    pay = unpack_payload(leaf["w_f"])
    out = {k: v for k, v in leaf.items() if k != "w_f"}
    out["w" if pay.dtype == torch.bfloat16 else "w_q"] = pay
    return out


def _bf16_rounded_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float().contiguous()


def _router_leaf(plan: MegaPlan, lp: Dict) -> Dict:
    """The router (+ the shared expert's gate as column E) rounded to bf16
    and zero-padded to EP columns, as the JAX pack holds it. A TP plan's
    router is the global one (E_global lanes) on every rank."""
    w = lp["router"]["w"]
    E = plan.E_global or plan.E
    rw = torch.zeros((plan.L, plan.hid, plan.EP), dtype=torch.bfloat16,
                     device=w.device)
    rw[..., :E] = w.to(torch.bfloat16)
    if plan.has_shared_gate:
        rw[..., E:E + 1] = lp["shared_expert_gate"]["w"].to(torch.bfloat16)
    return packed_leaf({"w": rw})


def pack_params(cfg: ModelConfig, plan: MegaPlan, params: Dict) -> Dict:
    """The kernel's weight arguments from the tensor param tree
    (`params_from_numpy` output, already on the device): each payload
    re-laid in fragment order (a copy: see the module docstring), the f32
    scale / zero leaves as they are, and the small f32 norm / bias arrays
    (a QK-norm model's `qk_norms` [L, 2, D]: q_norm, k_norm; the TPU pack
    tiles them over the heads to its lane width, which means nothing here;
    an ALiBi model's `slopes` [H] f32, `alibi_slopes(plan.H)`: a rank's
    pack takes its slice of the global table instead, `make_tp_plan`).
    A MoE model's experts are packed per (layer, expert), [L, E, N/256,
    K/64, chunk], under "experts.<name>", its shared expert under
    "shared.<name>" and the bf16 router under "router"."""
    lp = params["layers"]
    layers = {n: packed_leaf(lp[n]) for _, names in _LAYER_STREAMS[:2]
              for n in names}
    if plan.E:
        for n in _MLP:
            layers["experts." + n] = packed_leaf(
                _expert_leaf(lp["experts"][n]))
            if plan.has_shared:
                layers["shared." + n] = packed_leaf(lp["shared_expert"][n])
        layers["router"] = _router_leaf(plan, lp)
    else:
        layers.update({n: packed_leaf(lp[n]) for n in _MLP})
    out = {"layers": layers,
           "lm_head": packed_leaf(params["lm_head"]),
           "norms": _bf16_rounded_f32(torch.stack(
               [lp["input_layernorm"], lp["post_attention_layernorm"]],
               dim=1)),                                       # [L, 2, hid]
           "final_norm": _bf16_rounded_f32(params["norm"]),
           "qkv_b": None, "qk_norms": None, "slopes": None}
    if plan.has_qkv_bias:
        out["qkv_b"] = _bf16_rounded_f32(torch.cat(
            [lp[n]["b"] for n in ("q_proj", "k_proj", "v_proj")], dim=1))
    if plan.qk_norm:
        out["qk_norms"] = _bf16_rounded_f32(torch.stack(
            [lp["q_norm"], lp["k_norm"]], dim=1))             # [L, 2, D]
    if plan.alibi:
        out["slopes"] = alibi_slopes(plan.H).to(out["norms"].device)
    return out


def packed_extra_bytes(packed: Dict, params: Dict) -> int:
    """Device bytes the pack holds beyond the param tree it was made from."""
    seen = set()

    def ptrs(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                ptrs(v)
        elif isinstance(tree, torch.Tensor):
            seen.add(tree.data_ptr())

    ptrs(params)
    extra = 0

    def walk(tree):
        nonlocal extra
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, torch.Tensor) and tree.data_ptr() not in seen:
            extra += tree.numel() * tree.element_size()

    walk(packed)
    return extra


MAX_EXPERTS = 512     # router lanes the kernels take (csrc kMaxLanes)
MAX_TOPK = 8


def stream_gaps(sp: StreamPlan, any_lm_width: bool = False) -> List[str]:
    """Why csrc/di_product.cuh cannot run this stream (empty = it can): its
    K chunks are 64 rows deep and its 256-column tiles take any width that
    is a multiple of 128 (the pack pads it; the phases after a layer
    product read whole heads and 64-column chunks). With `any_lm_width`
    (the TP lm segments, `ops.tp_megakernel.cuda_kernel_gaps` and
    `prefill_cuda_kernel_gaps`) the lm_head takes any even width: its
    columns are the logits alone, and a vocab shard of 64 or 32 mod 128 on
    a model axis (Qwen1.5's and Qwen3's 151936 over 2 or 4 ranks) runs
    there; the megakernels keep the 128 rule."""
    gaps = []
    if any_lm_width and sp.name == "lm":
        if sp.bits == 4 and any(n % 2 for n in sp.N):
            gaps.append(f"{sp.name}: u4 columns {sp.N} not even")
    elif any(n % 128 for n in sp.N):
        gaps.append(f"{sp.name}: columns {sp.N} not multiples of 128")
    if sp.K % CHUNK_K or (sp.gs and sp.gs % CHUNK_K):
        gaps.append(f"{sp.name}: K {sp.K} / group {sp.gs} not multiples "
                    f"of {CHUNK_K}")
    return gaps


def cuda_kernel_gaps(plan: MegaPlan, any_lm_width: bool = False
                     ) -> List[str]:
    """Why csrc/megakernel.cu cannot run this plan (empty = it can);
    `any_lm_width` as `stream_gaps`'."""
    gaps = [g for sp in plan.streams for g in stream_gaps(sp, any_lm_width)]
    if plan.G > 8:
        gaps.append(f"{plan.G} query heads per KV head (kernel takes 8)")
    if plan.D != 128:
        gaps.append("head_dim != 128")
    if plan.EP > MAX_EXPERTS or plan.k_top > MAX_TOPK:
        gaps.append(f"{plan.EP} router lanes / top-{plan.k_top} (kernel "
                    f"takes {MAX_EXPERTS} / {MAX_TOPK})")
    return gaps


def target_pages(page_tables: torch.Tensor, lens: torch.Tensor,
                 ps: int) -> torch.Tensor:
    """The LOGICAL page each slot's new token lands in
    (`build_schedule`'s tgt_page; the kernel walks page tables itself and
    needs no flat page schedule)."""
    col = (lens // ps).long().clamp(0, page_tables.shape[1] - 1)
    return torch.gather(page_tables, 1, col[:, None])[:, 0]


# ---------------------------------------------------------------------------
# the plain PyTorch version of the step
# ---------------------------------------------------------------------------

def leaf_dot(x: torch.Tensor, leaf: Dict) -> torch.Tensor:
    """x [B, K] bf16 . one leaf (a layer's slice) -> f32 [B, N]."""
    xf = x.float()
    leaf = loader_view(leaf)
    if "w" in leaf:
        return xf @ leaf["w"].to(torch.bfloat16).float()
    scale = leaf["scale"].to(torch.bfloat16).float()
    zero = leaf["zero"].to(torch.bfloat16).float()
    G, N = scale.shape
    B, K = xf.shape
    gs = K // G
    q = weight_levels(leaf["w_q"]).float().reshape(G, gs, N)
    xg = xf.reshape(B, G, gs).transpose(0, 1)                 # [G, B, gs]
    part = torch.bmm(xg, q)                                   # [G, B, N]
    xsum = xg.sum(-1)                                         # [G, B]
    return (part * scale[:, None, :] +
            xsum[:, :, None] * zero[:, None, :]).sum(0)


def _stream_dot(x, packed, sp: StreamPlan, layer: Optional[int],
                expert: Optional[int] = None):
    """x . the stream's leaves of one layer (one expert's, for an expert
    stream) -> f32 [B, Ntot]: each leaf's true columns, the pack's padding
    dropped."""
    outs = []
    for name, n in zip(sp.leaves, sp.N):
        if layer is None:
            leaf = packed["lm_head"]
        else:
            leaf = {k: v[layer] if expert is None else v[layer][expert]
                    for k, v in packed["layers"][name].items()}
        outs.append(leaf_dot(x, leaf)[..., :n])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def route(plan, logits: torch.Tensor, forced: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernels' router phase on the f32 router product [M, EP]:
    softmax over the first E lanes, k rounds of max (the lowest lane on
    ties), optional renormalisation; the shared expert's gate is
    sigmoid(lane E), or 1. `forced` [M, k_top] (expert ids): route each row
    to these experts instead of its k largest, with their gates from the
    same softmax (-1: no expert). Returns (gates [M, E] f32, 0 where not
    routed; shared gate [M] f32, 0 without a shared expert). A TP plan
    routes over all ranks' experts (`E_global`; a PrefillPlan has none:
    MoE prefills per-op on a mesh)."""
    E = getattr(plan, "E_global", 0) or plan.E
    ml = logits[:, :E]
    p = torch.exp(ml - ml.max(-1, keepdim=True).values)
    p = p / p.sum(-1, keepdim=True)
    lane = torch.arange(E, device=logits.device)[None, :]
    gates = torch.zeros_like(p)
    pw = p.clone()
    for j in range(plan.k_top):
        if forced is not None:
            sel = lane == forced[:, j:j + 1].to(lane.dtype)
            gates = torch.where(sel, p, gates)
            continue
        mi = pw.max(-1, keepdim=True).values
        fl = torch.where(pw >= mi, lane, E).min(-1, keepdim=True).values
        sel = lane == fl
        gates = torch.where(sel, p, gates)
        pw = torch.where(sel, torch.full_like(pw, -1.0), pw)
    if plan.norm_topk:
        # a row routed to no expert (`forced` -1: a prefill row past the
        # prompt) keeps its zeros instead of 0 / 0
        total = gates.sum(-1, keepdim=True)
        gates = torch.where(total > 0, gates / total, gates)
    if not plan.has_shared:
        sg = torch.zeros_like(logits[:, 0])
    elif plan.has_shared_gate:
        sg = torch.sigmoid(logits[:, E])
    else:
        sg = torch.ones_like(logits[:, 0])
    return gates, sg


def moe_ref(plan, x: torch.Tensor, layer: int, mm, routing=None,
            forced: Optional[torch.Tensor] = None,
            first_expert: Optional[int] = None) -> torch.Tensor:
    """The MoE block of one layer as both kernels compute it, from x_norm
    [M, hid] bf16, with `mm(x, stream, layer, expert)` the kernel's product
    -> f32 [M, hid]: sum over experts in ascending order of gate x down(bf16
    SwiGLU(gate|up)), then the shared expert's gate x its output. Experts no
    row routes to are skipped (their gate is 0 everywhere). `routing`, a
    list, receives the layer's f32 router product [M, EP]; `forced` [M,
    k_top]: the experts each row is routed to (`route`). A TP plan routes
    over all `E_global` experts and runs only the rank's `E`, those from
    `first_expert` on (`mm` takes their local index); its shared expert is
    the rank's slice."""
    logits = mm(x, plan.rt, layer, None)
    gates, sg = route(plan, logits, forced)
    if routing is not None:
        routing.append(logits)
    acc = torch.zeros((x.shape[0], plan.hid), dtype=torch.float32,
                      device=x.device)
    e0 = first_expert or 0
    for e in torch.nonzero(gates.amax(0) > 0)[:, 0].tolist():
        if not e0 <= e < e0 + plan.E:
            continue
        gu = mm(x, plan.gu, layer, e - e0)
        g, u = gu[:, :plan.inter], gu[:, plan.inter:]
        act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
        acc = acc + gates[:, e:e + 1] * mm(act, plan.dn, layer, e - e0)
    if plan.has_shared:
        gu = mm(x, plan.sgu, layer, None)
        g, u = gu[:, :plan.shared_inter], gu[:, plan.shared_inter:]
        act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
        acc = acc + sg[:, None] * mm(act, plan.sdn, layer, None)
    return acc


def _rms(x, w, eps):
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * w


def qk_norm_heads(plan, packed: Dict, layer: int, q: torch.Tensor,
                  k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A QK-norm plan's per-head RMSNorm of q [.., H*D] and k [.., KH*D]
    (f32, after the bias, before RoPE) with the layer's q_norm / k_norm;
    q and k as they are without QK-norm."""
    if not plan.qk_norm:
        return q, k
    w = packed["qk_norms"][layer]
    D = plan.D

    def heads(x, wv):
        return _rms(x.reshape(*x.shape[:-1], -1, D), wv,
                    plan.rms_eps).reshape(x.shape)
    return heads(q, w[0]), heads(k, w[1])


def _rot_half(x, D):
    """rotate_half per D-sized head block of [B, n*D]."""
    x3 = x.reshape(x.shape[0], -1, D)
    h = D // 2
    return torch.cat([-x3[..., h:], x3[..., :h]], dim=-1).reshape(x.shape)


def alibi_bias(plan, slopes: torch.Tensor, pos: torch.Tensor,
               origin: torch.Tensor) -> torch.Tensor:
    """The ALiBi score bias [B, KH, G, S]: slope_h * (t - origin[b]) for the
    pool tokens t = `pos` [S] of queries at `origin` [B] (each slot's new
    token: the same origin for every chunk of the slot's attention)."""
    return slopes.reshape(1, plan.KH, plan.G, 1) * (
        pos - origin[:, None, None, None])


def _attend_ref(plan: MegaPlan, q, k_new, v_new, cache: KVCache, phys,
                len_eff, scale, slopes=None):
    """q [B, H, D] (bf16-rounded f32), k_new/v_new [B, KH, D] f32; phys
    [B, maxP] physical pages of this layer; attends tokens t < len_eff[b]
    of the pool plus the new token. `slopes` [H] (ALiBi): each pool token's
    score gains slope_h * (t - len_eff[b]) after the scale, the new token's
    (at position len_eff[b]) nothing."""
    B, KH, G, D = q.shape[0], plan.KH, plan.G, plan.D
    S = plan.maxP * plan.ps
    idx = phys.long().clamp(0, cache.num_pages - 1)
    mode = plan.kv_mode

    def tokens(pool):
        return pool[idx].reshape(B, S, KH, -1).float().permute(0, 2, 1, 3)

    def qparams(qp):
        r = qp[idx][..., :plan.ps].permute(0, 2, 1, 3).reshape(B, 2 * KH, S)
        return r[:, 0::2, None, :], r[:, 1::2, None, :]

    qf = q.reshape(B, KH, G, D)
    k_raw, v_raw = tokens(cache.k), tokens(cache.v)
    if mode == CacheMode.UINT4:
        def unpack(x):
            xi = x.to(torch.int32)
            return torch.cat([(xi & 0xF).float(), ((xi >> 4) & 0xF).float()],
                             dim=-1)
        k_raw, v_raw = unpack(k_raw), unpack(v_raw)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_raw)
    if mode != CacheMode.DEFAULT:
        k_scale, k_zero = qparams(cache.k_qparams)
        s = s * k_scale + qf.sum(-1, keepdim=True) * k_zero
    s = s * scale
    pos = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + alibi_bias(plan, slopes, pos, len_eff)
    mask = (pos[None, :] < len_eff[:, None])[:, None, None, :]
    s = torch.where(mask, s, _NEG_INF)
    s_new = torch.einsum("bhgd,bhd->bhg", qf, k_new)[..., None] * scale
    p = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    p_old = p[..., :S] * mask
    # what lies past lens is garbage (a float pool or the qparams may hold
    # NaN there): the V side reads it as 0, by select
    vmask = mask[:, :, 0, :, None]
    v_raw = torch.where(vmask, v_raw, 0.0)
    if mode == CacheMode.DEFAULT:
        out = torch.einsum("bhgs,bhsd->bhgd", p_old, v_raw)
    else:
        v_scale, v_zero = (torch.where(mask, t, 0.0)
                           for t in qparams(cache.v_qparams))
        out = torch.einsum("bhgs,bhsd->bhgd", p_old * v_scale, v_raw) + \
            (p_old * v_zero).sum(-1, keepdim=True)
    out = out + p[..., S:] * v_new[:, :, None, :]
    return out.reshape(B, KH * G * D)


class LoraStep:
    """A decode step's adapters as the LoRA branch takes them: the pool
    (lora/manager.py) and each row's slot (-1: none; an inactive row has
    none). `add` is the branch's arithmetic: h = x_bf16 . A[n] in f32,
    then bf16(h) . (B[n] * scale[n] rounded to the pool's dtype), added to
    the product of a row on slot n; a row without an adapter keeps its
    product as it is."""

    def __init__(self, pool: Dict, lora_idx: torch.Tensor,
                 active: torch.Tensor):
        self.pool = pool
        self.slots = torch.where(active.bool() & (lora_idx >= 0),
                                 lora_idx.long(), -1)
        self.has = self.slots >= 0
        self.used = sorted(set(self.slots[self.has].tolist()))

    def delta(self, target: str, layer: int, x: torch.Tensor
              ) -> torch.Tensor:
        """Target's delta [B, out] f32 for x [B, in] (bf16 values)."""
        A, Bm = self.pool["A"][target][layer], self.pool["B"][target][layer]
        out = torch.zeros((x.shape[0], Bm.shape[-1]), dtype=torch.float32,
                          device=x.device)
        for n in self.used:
            rows = self.slots == n
            h = x[rows].float() @ A[n].float()
            bs = (Bm[n].float() * self.pool["scale"][n]).to(Bm.dtype).float()
            out[rows] = h.to(torch.bfloat16).float() @ bs
        return out

    def add(self, y: torch.Tensor, targets, layer: int, x: torch.Tensor
            ) -> torch.Tensor:
        """y [B, out] plus the deltas of `targets` (one name, or names
        whose outputs y concatenates)."""
        if isinstance(targets, str):
            targets = (targets,)
        d = torch.cat([self.delta(t, layer, x) for t in targets], dim=-1)
        return torch.where(self.has[:, None], y + d, y)


class StepInputs:
    """The per-step inputs of the layer pieces below, derived once: the
    bf16 RoPE tiles repeated over the q and k heads, the attended lengths,
    and each slot's target page and offset for the new token."""

    def __init__(self, plan: MegaPlan, cos, sin, page_tables, lens, active):
        bf = torch.bfloat16
        cosf, sinf = cos.to(bf).float(), sin.to(bf).float()
        self.cq, self.sq = cosf.repeat(1, plan.H), sinf.repeat(1, plan.H)
        self.ck, self.sk = cosf.repeat(1, plan.KH), sinf.repeat(1, plan.KH)
        self.active = active.bool()
        self.len_eff = torch.where(self.active, lens, torch.zeros_like(lens))
        self.tgt = target_pages(page_tables, lens, plan.ps).long()
        self.offs = (lens % plan.ps).long()
        self.page_tables = page_tables


def attention_block_ref(plan: MegaPlan, packed: Dict, layer: int,
                        resid: torch.Tensor, inp: StepInputs,
                        cache: KVCache, skip_attention: bool = False,
                        lora: Optional[LoraStep] = None) -> torch.Tensor:
    """One layer's RMSNorm, q|k|v (+ bias), RoPE (or an ALiBi plan's score
    bias), new-token KV write, attention and o product, from the f32
    residual [B, hid]; updates the
    pool in place and returns the o product [B, hid] f32. `lora`: the
    q|k|v deltas (before the bias) and o's."""
    B, L, H, KH, D = resid.shape[0], plan.L, plan.H, plan.KH, plan.D
    bf = torch.bfloat16
    HD, KD = H * D, KH * D
    x = _rms(resid, packed["norms"][layer, 0], plan.rms_eps).to(bf)
    qkv = _stream_dot(x, packed, plan.qkv, layer)
    if lora is not None:
        qkv = lora.add(qkv, LORA_TARGETS[:3], layer, x)
    if packed["qkv_b"] is not None:
        qkv = qkv + packed["qkv_b"][layer]
    qr, kr, vr = qkv[:, :HD], qkv[:, HD:HD + KD], qkv[:, HD + KD:]
    qr, kr = qk_norm_heads(plan, packed, layer, qr, kr)
    if plan.alibi:              # no rotation: the scores carry the position
        q_rot, k_rot = qr.to(bf).float(), kr
    else:
        q_rot = (qr * inp.cq + _rot_half(qr, D) * inp.sq).to(bf).float()
        k_rot = kr * inp.ck + _rot_half(kr, D) * inp.sk
    k3, v3 = k_rot.reshape(B, KH, D), vr.reshape(B, KH, D)
    if skip_attention:
        attn = torch.zeros((B, HD), dtype=torch.float32, device=x.device)
    else:
        attn = _attend_ref(plan, q_rot.reshape(B, H, D), k3, v3, cache,
                           inp.page_tables * L + layer, inp.len_eff,
                           1.0 / math.sqrt(D), packed.get("slopes"))
        act = inp.active
        kv_ops._write(cache, plan.kv_mode, k3[act], v3[act],
                      (inp.tgt * L + layer)[act], inp.offs[act])
    o = _stream_dot(attn.to(bf), packed, plan.o, layer)
    if lora is not None:
        o = lora.add(o, "o_proj", layer, attn.to(bf))
    return o


def mlp_block_ref(plan: MegaPlan, packed: Dict, layer: int,
                  resid: torch.Tensor, lora: Optional[LoraStep] = None
                  ) -> torch.Tensor:
    """One dense layer's RMSNorm, gate|up, SwiGLU and down product, from the
    f32 residual [B, hid] -> the down product [B, hid] f32. `lora`: gate's
    and up's deltas before SwiGLU, down's after its product."""
    x = _rms(resid, packed["norms"][layer, 1], plan.rms_eps).to(torch.bfloat16)
    gu = _stream_dot(x, packed, plan.gu, layer)
    g, u = gu[:, :plan.inter], gu[:, plan.inter:]
    if lora is not None:
        g = lora.add(g, "gate_proj", layer, x)
        u = lora.add(u, "up_proj", layer, x)
    act = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    dn = _stream_dot(act, packed, plan.dn, layer)
    if lora is not None:
        dn = lora.add(dn, "down_proj", layer, act)
    return dn


def lm_head_ref(plan: MegaPlan, packed: Dict,
                resid: torch.Tensor) -> torch.Tensor:
    """The final RMSNorm and the lm_head -> logits [B, V] f32."""
    x = _rms(resid, packed["final_norm"], plan.rms_eps).to(torch.bfloat16)
    return _stream_dot(x, packed, plan.lm, None)


def decode_megakernel_ref(plan: MegaPlan, packed: Dict, x0: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          page_tables: torch.Tensor, lens: torch.Tensor,
                          active: torch.Tensor, cache: KVCache,
                          skip_attention: bool = False,
                          routing: Optional[list] = None,
                          forced_routing: Optional[torch.Tensor] = None,
                          resid_norms: Optional[list] = None,
                          lora: Optional[Dict] = None,
                          lora_idx: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The whole decode step, phase by phase (see `decode_megakernel`).
    Updates the pool in place; returns logits [B, V] f32. A MoE model's
    rows are routed from their own x_norm, inactive rows too (their logits
    are unspecified); `routing`, a list, receives each layer's router
    product (`moe_ref`); `forced_routing` [L, B, k_top] routes each layer's
    rows to those experts instead (a kernel's, `kernel_routing`), so that a
    row's activations can be held to the kernel's in every layer whatever
    a near-tie of the router chose; `resid_norms`, a list, receives the
    RMS of each row's residual entering each layer ([B] f32 a layer: the
    inverse of the gain with which that layer's RMSNorm passes the row's
    rounding differences on). `lora` (the adapter pool, lora/manager.py)
    and `lora_idx` [B] int32 (each row's slot, -1 none): the LoRA branch
    (`LoraStep`; a dense plan only)."""
    inp = StepInputs(plan, cos, sin, page_tables, lens, active)
    ls = None if lora is None else LoraStep(lora, lora_idx, active)
    resid = x0.to(torch.bfloat16).float()
    for l in range(plan.L):
        if resid_norms is not None:
            resid_norms.append(resid.pow(2).mean(-1).sqrt())
        resid = resid + attention_block_ref(plan, packed, l, resid, inp,
                                            cache, skip_attention, ls)
        if plan.E:
            x = _rms(resid, packed["norms"][l, 1], plan.rms_eps).to(
                torch.bfloat16)
            resid = resid + moe_ref(
                plan, x, l, lambda x_, sp, l_, e: _stream_dot(
                    x_, packed, sp, l_, e), routing,
                None if forced_routing is None else forced_routing[l])
            continue
        resid = resid + mlp_block_ref(plan, packed, l, resid, ls)
    return lm_head_ref(plan, packed, resid)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

# order of the integer arguments of di_megakernel (csrc/megakernel.cu IArg)
_IARGS = ("norms", "final_norm", "qkv_b", "x0", "cos", "sin", "pt", "lens",
          "active", "k_pool", "v_pool", "k_qp", "v_qp", "logits", "resid",
          "rec", "partial", "qkv", "tickets", "att_tickets", "att_ml",
          "att_acc", "ssq", "barrier", "status",
          "launches", "trace", "epart", "erec", "topk_e", "topk_w", "sgate",
          "msplit", "B", "L", "hid", "H", "KH", "inter", "V", "ps", "maxP",
          "kv_kind", "ql", "nsplit", "split_len", "mpad", "skip_attn", "grid",
          "E", "k_top", "norm_topk", "has_shared", "has_sgate",
          "shared_inter", "qk_norm", "slopes")
_KV_KIND = {"float32": 0, "bfloat16": 1, "int8": 2, "uint8": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int
STREAM_ARGS = 32          # integers per stream (csrc/di_product.cuh)


def padded_rows(B: int) -> int:
    """Rows of the kernel's x records: 16 (one m16 tile), 32, or 64 (two
    passes of two tiles)."""
    return 16 if B <= 16 else (32 if B <= 32 else 64)


def product_passes(mpad: int) -> int:
    """Passes of a decode product over the padded rows (16 rows a pass at
    mpad 16, else 32)."""
    return mpad // (16 if mpad == 16 else 32)


def epilogue_tickets(plan: MegaPlan, mpad: int) -> int:
    """Tickets of the q|k|v product epilogue's sums (the TP attn
    segment's): one a pass and 256-column tile."""
    return product_passes(mpad) * (plan.qkv.Nptot // 256)


def attention_chunks(B: int, KH: int, max_tokens: int, grid: int
                     ) -> Tuple[int, int]:
    """(chunks a slot, tokens a chunk) of the kernels' attention phase
    (csrc/di_layer.cuh), from static shapes alone: its items are (slot, KV
    head, chunk), chunk j the tokens [j * chunk_tokens, (j + 1) *
    chunk_tokens), a whole number of ATT_TILE-token tiles; as many chunks
    as give about two items a block of the grid (items past a slot's
    length are empty), at most MAX_ATT_CHUNKS, each at least one tile."""
    tiles = max(1, -(-max_tokens // ATT_TILE))
    want = max(1, min(MAX_ATT_CHUNKS, tiles, -(-2 * grid // (B * KH))))
    per = -(-tiles // want)
    return -(-tiles // per), per * ATT_TILE


def choose_split(tiles: int, chunks: int, chunk_bytes: int, B: int,
                 passes: int, grid: int, extra_items: int = 0
                 ) -> Tuple[int, int]:
    """K split of one product: (ksplit, chunks per split). Each block walks
    its work items (tile x split x pass) one after the other, so the cost
    of a split is waves x (payload + partial sums written and read back +
    a fixed per-item share) in bytes on the slowest block; `extra_items`:
    another product's items dealt in the same phase."""
    best = None
    for ks in range(1, chunks + 1):
        cps = -(-chunks // ks)
        if -(-chunks // cps) != ks:
            continue
        items = tiles * ks * passes
        per_item = cps * chunk_bytes + 2 * min(B, 32) * 256 * 4 + 24576
        cost = -(-(items + extra_items) // grid) * per_item
        if best is None or cost < best[0]:
            best = (cost, ks, cps)
    return best[1], best[2]


def stream_args(sp: Optional[StreamPlan], leaves: List[Dict], layered: bool,
                ksplit: int = 1, cps: int = 0,
                valid: Optional[int] = None) -> List[int]:
    """One stream of packed leaves as csrc/di_product.cuh `fill_stream`
    reads it: per leaf its payload, scale and zero addresses, the strides
    between layers and between experts and its padded width; then the
    stream's shape, its K split, the row stride of the product's output
    (every padded column of its partial sums) and the columns written back
    (`valid`: the true width of a one-leaf stream whose output is the
    result, as the prefill kernels' logits; else every padded column, as
    the decode kernel writes its logits too). None gives an empty
    stream."""
    if sp is None:
        return [0] * STREAM_ARGS
    w, s, z, w_ls, q_ls, n, e_ls, qe_ls = ([0] * 3 for _ in range(8))
    for j, leaf in enumerate(leaves):
        pay = leaf["w_f"]
        w[j] = pay.data_ptr()
        w_ls[j] = pay.stride(0) * pay.element_size() if layered else 0
        e_ls[j] = pay.stride(1) * pay.element_size() if sp.E else 0
        n[j] = sp.Np[j]
        if sp.bits != 16:
            s[j], z[j] = leaf["scale"].data_ptr(), leaf["zero"].data_ptr()
            q_ls[j] = leaf["scale"].stride(0) if layered else 0
            qe_ls[j] = leaf["scale"].stride(1) if sp.E else 0
    G = 1 if not sp.gs else sp.K // sp.gs
    return w + s + z + w_ls + q_ls + n + e_ls + qe_ls + [
        len(leaves), sp.K, G, sp.bits, ksplit, cps, sp.Nptot,
        sp.Nptot if valid is None else valid]


def qk_norm_arg(plan, packed: Dict, dev, who: str) -> int:
    """The kernels' `qk_norm` argument: the address of the pack's
    `qk_norms` [L, 2, D] f32 for a QK-norm plan (checked), else 0."""
    if not plan.qk_norm:
        return 0
    t = packed.get("qk_norms")
    if t is None or t.dtype != torch.float32 or \
            tuple(t.shape) != (plan.L, 2, plan.D) or t.device != dev or \
            not t.is_contiguous():
        raise ValueError(f"{who}: qk_norms must be contiguous float32 "
                         f"({plan.L}, 2, {plan.D}) on {dev}")
    return t.data_ptr()


def slopes_arg(plan, packed: Dict, dev, who: str) -> int:
    """The kernels' `slopes` argument: the address of the pack's `slopes`
    [H] f32 for an ALiBi plan (checked; the plan's H, a rank's own), else
    0 (a RoPE plan: the kernels rotate q and k)."""
    if not plan.alibi:
        return 0
    t = packed.get("slopes")
    if t is None or t.dtype != torch.float32 or \
            tuple(t.shape) != (plan.H,) or t.device != dev or \
            not t.is_contiguous():
        raise ValueError(f"{who}: slopes must be contiguous float32 "
                         f"({plan.H},) on {dev}")
    return t.data_ptr()


def _check_leaf(sp: StreamPlan, leaf: Dict, n: int, lead: Tuple[int, ...],
                dev, who: str = "decode_megakernel") -> None:
    """`n`: the leaf's padded width; `lead`: (L,), (L, E) or ()."""
    if "w_f" not in leaf:
        raise ValueError(f"{who}: {sp.name} is not packed "
                         "(pack_params / packed_leaf)")
    pay_dt = {16: torch.bfloat16, 8: torch.int8, 4: torch.uint8}[sp.bits]
    ts = {"w_f": (leaf["w_f"], pay_dt,
                  lead + (n // 256, sp.K // CHUNK_K,
                          CHUNK_K * (128 if sp.bits == 4 else 256)))}
    if sp.bits != 16:
        G = sp.K // sp.gs
        ts.update(scale=(leaf["scale"], torch.float32, lead + (G, n)),
                  zero=(leaf["zero"], torch.float32, lead + (G, n)))
    for key, (t, dt, shape) in ts.items():
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{who}: {sp.name}.{key} is {t.dtype} "
                f"{tuple(t.shape)} on {t.device}; the kernel takes "
                f"contiguous 16-byte aligned {dt} {shape} on {dev}")


def packed_stream_args(plan, packed: Dict, splits: Dict, dev,
                       who: str, lm_valid: Optional[int] = None
                       ) -> List[int]:
    """Every kernel stream of `plan` (a decode or prefill plan) checked and
    flattened for the kernel, in the kernels' stream order; `lm_valid`: the
    lm_head's `valid` columns (`stream_args`)."""
    ia = []
    for sp in plan.kernel_streams:
        if sp is None:
            ia += stream_args(None, [], False)
            continue
        layered = sp.name != "lm"
        leaves = [packed["layers"][n] if layered else packed["lm_head"]
                  for n in sp.leaves]
        lead = (plan.L, plan.E) if sp.E else ((plan.L,) if layered else ())
        for leaf, n in zip(leaves, sp.Np):
            _check_leaf(sp, leaf, n, lead, dev, who)
        ia += stream_args(sp, leaves, layered, *splits[sp.name],
                          valid=lm_valid if sp.name == "lm" else None)
    return ia


class _Launch:
    """Per (plan, device, LoRA branch) launch geometry and scratch of the
    kernel. The LoRA branch's launches have their own (its instantiation's
    occupancy sets its grid) and the rank projection's partials."""

    def __init__(self, plan: MegaPlan, dev: torch.device, lora: bool = False):
        gaps = cuda_kernel_gaps(plan)
        if gaps:
            raise ValueError("decode_megakernel: " + "; ".join(gaps))
        lib = kernel_build.load("megakernel")
        self.fn = kernel_build.function(
            "megakernel", "di_megakernel", [_P, _P, _P])
        grid_fn = lib.di_megakernel_grid
        grid_fn.argtypes, grid_fn.restype = [_I, _I, _I, _I], _I
        B = plan.B
        self.mpad = padded_rows(B)
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        # kind: 0 dense, 1 MoE, 2 dense with the LoRA branch
        self.grid = grid_fn(idx, self.mpad, plan.hid,
                            2 if lora else int(plan.E > 0))
        if self.grid <= 0:
            raise RuntimeError("decode_megakernel: the kernel does not fit "
                               "on the device (occupancy query gave 0)")
        passes = product_passes(self.mpad)
        # an expert stream's items are spread over the experts a step
        # routes to: at most E, at most B * k
        routed = min(plan.E, B * plan.k_top)
        self.splits = {}
        for sp in plan.streams:
            chunk_bytes = CHUNK_K * 256 * sp.bits // 8
            if sp.name == "lm":     # its partial sums ARE the logits
                self.splits[sp.name] = (1, sp.K // CHUNK_K)
            else:
                self.splits[sp.name] = choose_split(
                    sp.Nptot // 256 * (routed if sp.E else 1),
                    sp.K // CHUNK_K, chunk_bytes, B, passes, self.grid)
        self.nsplit, self.split_len = attention_chunks(
            B, plan.KH, plan.maxP * plan.ps, self.grid)

        def zeros(n, dt):
            return torch.zeros(n, dtype=dt, device=dev)

        kmax = max(sp.K for sp in plan.streams)
        self.rec = zeros((kmax // CHUNK_K) * self.mpad *
                         (CHUNK_K * 2 + 4), torch.uint8)
        self.partial = zeros(max(self.splits[sp.name][0] * B * sp.Nptot
                                 for sp in plan.layer_streams if not sp.E),
                             torch.float32)
        # a MoE model's experts: their products' partial sums [E][split][B]
        # [N] (gate|up, then down) and the down product's x records
        self.epart = zeros(plan.E * max(
            [self.splits[sp.name][0] * B * sp.Nptot
             for sp in plan.streams if sp.E] + [0]), torch.float32)
        self.erec = zeros(plan.E * (plan.inter // CHUNK_K) * self.mpad *
                          (CHUNK_K * 2 + 4), torch.uint8)
        # each layer's routing [L][B][top-k], kept for the step
        self.topk_e = zeros(plan.L * B * MAX_TOPK, torch.int32)
        self.topk_w = zeros(plan.L * B * MAX_TOPK, torch.float32)
        self.sgate = zeros(plan.L * B, torch.float32)
        self.resid = zeros(B * plan.hid, torch.float32)
        # the attention merge's tickets, one a slot and KV head (0 between
        # launches: each is set back by the block that takes its last
        # number); no q|k|v scratch and no q|k|v epilogue's tickets: this
        # kernel's attention items sum q|k|v themselves
        self.qkv = self.tickets = None
        self.att_tickets = zeros(B * plan.KH, torch.int32)
        self.att_ml = zeros(B * plan.H * self.nsplit * 2, torch.float32)
        self.att_acc = zeros(B * plan.H * self.nsplit * plan.D,
                             torch.float32)
        self.ssq = zeros(B * (plan.hid // 128), torch.float32)
        self.barrier = zeros(1, torch.int32)
        self.status = zeros(1, torch.int32)
        # the LoRA branch's rank-space partials [7][kc][B][rank]
        self.lora_kc = -(-max(plan.hid, plan.H * plan.D, plan.inter) //
                         LORA_KC)
        self.lora_h = zeros(7 * self.lora_kc * B * LORA_MAX_RANK,
                            torch.float32) if lora else None


def scratch_args(plan: MegaPlan, st) -> Dict[str, int]:
    """The attention's scratch of a launch state (this module's or the TP
    segments'): q|k|v and the q|k|v epilogue's tickets (0: none), the
    merge's tickets, the chunks' states, the norms' sums."""
    return dict(qkv=0 if st.qkv is None else st.qkv.data_ptr(),
                tickets=0 if st.tickets is None else st.tickets.data_ptr(),
                att_tickets=st.att_tickets.data_ptr(),
                att_ml=st.att_ml.data_ptr(), att_acc=st.att_acc.data_ptr(),
                ssq=st.ssq.data_ptr())


_launches: Dict = {}


def _indexed(device) -> torch.device:
    """`cuda` -> `cuda:<current>`: tensors always report the index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _launch_state(plan: MegaPlan, dev: torch.device,
                  lora: bool = False) -> _Launch:
    key = (plan, dev, lora)
    st = _launches.get(key)
    if st is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_megakernel: the first launch of a "
                               "plan must not be under CUDA graph capture")
        st = _launches[key] = _Launch(plan, dev, lora)
    return st


RING_TIMEOUT = -1     # status of a product ring wait that gave up (csrc)


def status_fault(code: int) -> str:
    """What a nonzero status word of the decode kernels says."""
    if code == RING_TIMEOUT:
        return "a product phase's bulk-copy ring wait timed out"
    return f"grid barrier after phase {code - 1} timed out"


def check_status(plan: MegaPlan, device) -> None:
    """Waits for the device and raises if a launch of this plan gave up at
    a grid barrier (blocks that never became co-resident) or at a wait of
    a product's copy ring (its dense and its LoRA launches)."""
    for lora in (False, True):
        st = _launches.get((plan, _indexed(device), lora))
        if st is None:
            continue
        code = int(st.status.item())
        if code:
            st.status.zero_()
            st.barrier.zero_()
            st.att_tickets.zero_()
            raise RuntimeError(f"decode_megakernel: {status_fault(code)}"
                               + (" (LoRA branch)" if lora else ""))


def kernel_routing(plan: MegaPlan, device) -> torch.Tensor:
    """The experts the last launch of `plan` routed each row to, per layer:
    int32 [L, B, k_top] in ascending order (a MoE plan's scratch)."""
    st = _launch_state(plan, _indexed(device))
    return st.topk_e.reshape(plan.L, plan.B, MAX_TOPK)[..., :plan.k_top]


def launch_geometry(plan: MegaPlan, device, lora: bool = False) -> Dict:
    """Grid, K splits and attention chunks of this plan's launches (of its
    LoRA branch's with `lora`)."""
    st = _launch_state(plan, _indexed(device), lora)
    return dict(grid=st.grid, mpad=st.mpad, splits=dict(st.splits),
                nsplit=st.nsplit, split_len=st.split_len)


def lora_args(plan: MegaPlan, pool: Optional[Dict],
              lora_idx: Optional[torch.Tensor], st: Optional[_Launch],
              dev) -> List[int]:
    """The LoRA tail of the kernel's integers (csrc `fill_lora`), checked:
    the pool's A and B of each target, its scales, the rows' slots, the
    partials' scratch, then slots, rank, whether the pool is f32, and the
    K chunks a target has at most. No pool: zeros (the dense kernel)."""
    if pool is None:
        return [0] * LORA_ARGS
    if plan.E:
        raise ValueError("decode_megakernel: a MoE plan has no LoRA branch "
                         "(its LoRA batches decode per-op)")
    N, R = pool["scale"].shape[0], pool["A"]["q_proj"].shape[-1]
    dt = pool["A"]["q_proj"].dtype
    if not supports_lora_epilogue(plan, N, R) or \
            dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_megakernel: a pool of {N} slots of rank "
                         f"{R} ({dt}) is not one the LoRA branch takes")
    dims = dict(q_proj=(plan.hid, plan.H * plan.D),
                k_proj=(plan.hid, plan.KH * plan.D),
                v_proj=(plan.hid, plan.KH * plan.D),
                o_proj=(plan.H * plan.D, plan.hid),
                gate_proj=(plan.hid, plan.inter),
                up_proj=(plan.hid, plan.inter),
                down_proj=(plan.inter, plan.hid))
    checks = [(f"lora_idx", lora_idx, torch.int32, (plan.B,)),
              ("lora scale", pool["scale"], torch.float32, (N,))]
    for t in LORA_TARGETS:
        i, o = dims[t]
        checks += [(f"lora A[{t}]", pool["A"][t], dt, (plan.L, N, i, R)),
                   (f"lora B[{t}]", pool["B"][t], dt, (plan.L, N, R, o))]
    for name, t, want_dt, shape in checks:
        if t is None or t.dtype != want_dt or tuple(t.shape) != shape or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f"decode_megakernel: {name} must be contiguous "
                             f"{want_dt} {shape} on {dev}")
    return ([pool["A"][t].data_ptr() for t in LORA_TARGETS] +
            [pool["B"][t].data_ptr() for t in LORA_TARGETS] +
            [pool["scale"].data_ptr(), lora_idx.data_ptr(),
             st.lora_h.data_ptr(), N, R, int(dt == torch.float32),
             st.lora_kc])


def decode_megakernel(plan: MegaPlan, packed: Dict, x0: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      page_tables: torch.Tensor, lens: torch.Tensor,
                      active: torch.Tensor, cache: KVCache,
                      skip_attention: bool = False,
                      trace: Optional[torch.Tensor] = None,
                      lora: Optional[Dict] = None,
                      lora_idx: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One whole decode forward.

    x0 [B, hid] bf16: the embedded input tokens; cos/sin [B, D] bf16: the
    full-D RoPE tiles at each slot's position (an ALiBi plan reads neither:
    its pack's `slopes` take their place); page_tables [B, maxP] int32
    LOGICAL pages (logical page g owns pool pages g*L + l); lens [B] int32
    tokens already cached; active [B] bool; cache: the pool, updated in
    place at each active slot's new token. Returns logits [B, V] f32
    (rows of inactive slots unspecified). CPU tensors take
    `decode_megakernel_ref`; CUDA tensors launch the kernel or raise.
    `skip_attention` (the stream probe's replica mode) leaves out attention
    and the pool writes. `trace` (int64 [trace_len(plan)] on the
    card) receives block 0's timestamps: see `phase_times`. `lora` (the
    adapter pool of lora/manager.py, its tensors at fixed addresses) with
    `lora_idx` [B] int32 (each row's slot, -1 none): the kernel's LoRA
    branch, a separate instantiation (`LoraStep` is its arithmetic); a
    launch without `lora` runs the dense kernel."""
    if lora is not None and (plan.E or plan.alibi):
        raise ValueError("decode_megakernel: a MoE or ALiBi plan has no "
                         "LoRA branch (its LoRA batches decode per-op)")
    if x0.device.type == "cpu":
        return decode_megakernel_ref(plan, packed, x0, cos, sin, page_tables,
                                     lens, active, cache, skip_attention,
                                     lora=lora, lora_idx=lora_idx)
    if not x0.is_cuda:
        raise ValueError(f"decode_megakernel: unsupported device {x0.device}")
    dev = x0.device
    B = plan.B
    for name, t, dt, shape in (
            ("x0", x0, torch.bfloat16, (B, plan.hid)),
            ("cos", cos, torch.bfloat16, (B, plan.D)),
            ("sin", sin, torch.bfloat16, (B, plan.D)),
            ("page_tables", page_tables, torch.int32, (B, plan.maxP)),
            ("lens", lens, torch.int32, (B,)),
            ("active", active, torch.bool, (B,)),
            ("norms", packed["norms"], torch.float32, (plan.L, 2, plan.hid)),
            ("final_norm", packed["final_norm"], torch.float32,
             (plan.hid,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"decode_megakernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"contiguous {dt} {shape} on {dev}")
    kv_dt = getattr(torch, plan.kv_dtype_name)
    Ds = plan.D // 2 if plan.kv_bits == 4 else plan.D
    quant = plan.kv_bits != 16
    for t in (cache.k, cache.v):
        if t.dtype != kv_dt or t.shape[1:] != (plan.ps, plan.KH * Ds) or \
                t.device != dev or not t.is_contiguous():
            raise ValueError("decode_megakernel: pool "
                             f"{t.dtype} {tuple(t.shape)} for {plan.kv_mode}")
    if quant and (cache.k_qparams is None or
                  cache.k_qparams.shape[1] != 2 * plan.KH or
                  cache.k_qparams.dtype != torch.float32):
        raise ValueError("decode_megakernel: pool qparams missing or "
                         "misshaped")
    if trace is not None and (
            trace.dtype != torch.int64 or trace.device != dev or
            trace.numel() < trace_len(plan) or not trace.is_contiguous()):
        raise ValueError("decode_megakernel: trace must be contiguous int64 "
                         f"[{trace_len(plan)}] on {dev}")
    st = _launch_state(plan, dev, lora is not None)
    lora_tail = lora_args(plan, lora, lora_idx, st, dev)
    vals = dict(
        norms=packed["norms"].data_ptr(),
        final_norm=packed["final_norm"].data_ptr(),
        qkv_b=0 if packed["qkv_b"] is None else packed["qkv_b"].data_ptr(),
        x0=x0.data_ptr(), cos=cos.data_ptr(), sin=sin.data_ptr(),
        pt=page_tables.data_ptr(), lens=lens.data_ptr(),
        active=active.data_ptr(), k_pool=cache.k.data_ptr(),
        v_pool=cache.v.data_ptr(),
        k_qp=cache.k_qparams.data_ptr() if quant else 0,
        v_qp=cache.v_qparams.data_ptr() if quant else 0,
        resid=st.resid.data_ptr(), rec=st.rec.data_ptr(),
        partial=st.partial.data_ptr(), **scratch_args(plan, st),
        barrier=st.barrier.data_ptr(),
        status=st.status.data_ptr(),
        launches=(decode_megakernel.counter if lora is None else
                  decode_megakernel.lora_counter).pointer(dev),
        trace=0 if trace is None else trace.data_ptr(),
        epart=st.epart.data_ptr(), erec=st.erec.data_ptr(),
        topk_e=st.topk_e.data_ptr(), topk_w=st.topk_w.data_ptr(),
        sgate=st.sgate.data_ptr(),
        msplit=0,
        B=B, L=plan.L, hid=plan.hid, H=plan.H, KH=plan.KH, inter=plan.inter,
        V=plan.V, ps=plan.ps, maxP=plan.maxP,
        kv_kind=_KV_KIND[plan.kv_dtype_name],
        ql=cache.k_qparams.shape[2] if quant else 0, nsplit=st.nsplit,
        split_len=st.split_len, mpad=st.mpad, skip_attn=int(skip_attention),
        grid=st.grid, E=plan.E, k_top=plan.k_top,
        norm_topk=int(plan.norm_topk), has_shared=int(plan.has_shared),
        has_sgate=int(plan.has_shared_gate), shared_inter=plan.shared_inter,
        qk_norm=qk_norm_arg(plan, packed, dev, "decode_megakernel"),
        slopes=slopes_arg(plan, packed, dev, "decode_megakernel"))
    # the lm_head's padded columns are written too (they compute 0): a
    # bound on the columns in the product would cost the 128-register
    # kernel spills
    logits = torch.empty((B, plan.lm.Nptot), dtype=torch.float32,
                         device=dev)
    vals["logits"] = logits.data_ptr()
    ia = [vals[k] for k in _IARGS]
    if packed["qkv_b"] is not None and \
            tuple(packed["qkv_b"].shape) != (plan.L, plan.QKVN):
        raise ValueError("decode_megakernel: qkv_b shape")
    ia += packed_stream_args(plan, packed, st.splits, dev,
                             "decode_megakernel")
    ia += lora_tail
    ia_arr = np.asarray(ia, np.int64)
    fa_arr = np.asarray([plan.rms_eps, 1.0 / math.sqrt(plan.D)], np.float64)
    rc = st.fn(ia_arr.ctypes.data, fa_arr.ctypes.data,
               kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"decode_megakernel launch failed: CUDA error "
                           f"{rc}")
    return logits[:, :plan.V]


decode_megakernel.counter = kernel_build.LaunchCounter()
# the launches of the LoRA branch (a launch with an adapter pool) apart
decode_megakernel.lora_counter = kernel_build.LaunchCounter()

# the kernel's phases, in order, each followed by a grid barrier (q|k|v's
# K splits are summed in its epilogue, the attention chunks merged in the
# attention phase)
LAYER_PHASES = ("resid1", "norm1", "qkv", "attention", "o", "resid2",
                "norm2", "gate_up", "swiglu", "down")
MOE_LAYER_PHASES = LAYER_PHASES[:7] + ("router", "gates", "gate_up",
                                       "swiglu", "down")
TAIL_PHASES = ("resid", "final_norm", "lm_head")


def _phase_names(plan: MegaPlan) -> Tuple[str, ...]:
    layer = MOE_LAYER_PHASES if plan.E else LAYER_PHASES
    return layer * plan.L + TAIL_PHASES


def trace_len(plan: MegaPlan) -> int:
    return 2 * len(_phase_names(plan)) + 1


def phase_times(plan: MegaPlan, trace: torch.Tensor) -> Dict[str, Dict]:
    """A traced launch's time by phase kind, summed over the layers, in ms:
    `work` is what block 0 spent in the phase itself, `wait` what it then
    spent in the grid barrier (the phase's slower blocks and the barrier's
    own cost). The kernel writes trace[0] at its start, trace[2p + 1] where
    block 0 ends phase p and trace[2p + 2] where it leaves p's barrier. A
    MoE layer's gate_up, swiglu and down phases hold its routed experts and
    its shared expert."""
    return phase_times_of(_phase_names(plan), trace[:trace_len(plan)])


def phase_times_of(names, trace: torch.Tensor) -> Dict[str, Dict]:
    """`phase_times` for any kernel that stamps its phases this way."""
    t = trace.cpu().tolist()
    out: Dict[str, Dict] = {}
    for p, name in enumerate(names):
        d = out.setdefault(name, dict(work=0.0, wait=0.0))
        d["work"] += (t[2 * p + 1] - t[2 * p]) / 1e6
        d["wait"] += (t[2 * p + 2] - t[2 * p + 1]) / 1e6
    out["total"] = dict(work=(t[-1] - t[0]) / 1e6, wait=0.0)
    return out
