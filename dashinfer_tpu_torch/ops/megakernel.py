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
  launch count `decode_megakernel.counter`.

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
itself (6.6 GiB). It also holds three small f32 arrays: the norm weights
and the fused q|k|v bias, rounded to bf16 as the TPU pack rounds them. A
plain tile-major copy without the fragment order was measured too and
streams no faster than the loader's leaves (PERF.md).

Numerics (the TPU kernel's rounding points): residual in f32; x_norm, the
rotated q, attn_out and the SwiGLU activation rounded to bf16; dots on bf16
operands with f32 accumulation and the per-group affine after the dot,
`out = sum_g (x_g @ q_g) * s_g + xsum_g * z_g` with xsum over the bf16 x;
bias, then RoPE with bf16 cos/sin tiles. The new token is attended from its
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
from dashinfer_tpu_torch.ops import kernel_build, kv_ops
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

PACK_VERSION = 1   # bump when what pack_params returns changes
MAX_BATCH = 64
CHUNK_K = 64        # K rows per pipeline stage of the kernel
ATT_UNIT = 64       # tokens per unit of an attention stripe
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


def supports(cfg: ModelConfig, rt: RuntimeConfig, params: Dict) -> bool:
    """Whether the model takes the megakernel path (the per-op path serves
    it otherwise). The JAX package's rules for what the port has: dense
    pre-LN RoPE models, head_dim 128, max_batch <= 64, no activation-quant
    leaves, equal bits within q/k/v and within gate/up, no o or MLP bias,
    group sizes a multiple of 128 (or one group). MoE, QK-norm, ALiBi and
    a tied quantized lm_head are not in the port's kernel yet and say no.
    Two TPU tiling rules are dropped because they mean nothing on this card:
    page_size % 8 (the RMW window) and the UINT4 `KH * D / 2 >= 128` lane
    rule. Params may be numpy or tensor leaves (only shapes are read)."""
    try:
        lp = params["layers"]
        if cfg.moe is not None or cfg.qk_norm:
            return False
        for name in ("q_proj", "o_proj", "gate_proj", "down_proj"):
            if "w_q8" in lp[name] or "w_f8" in lp[name]:
                return False
        if cfg.head_dim != 128:
            return False
        if cfg.hidden_size % 128 or (cfg.num_heads * cfg.head_dim) % 128:
            return False
        if cfg.position_embedding.value != "rope" or cfg.rope_interleaved:
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
        for name in ("gate_proj", "up_proj", "down_proj", "o_proj"):
            if "b" in lp[name]:
                return False
        if _weight_bits(lp["gate_proj"]) != _weight_bits(lp["up_proj"]):
            return False
        for name in ("q_proj", "k_proj", "v_proj"):
            if _weight_bits(lp[name]) != _weight_bits(lp["q_proj"]):
                return False
        for name in ("q_proj", "o_proj", "gate_proj", "down_proj"):
            leaf = lp[name]
            if "w_q" in leaf:
                K = leaf["w_q"].shape[1]
                gs = K // leaf["scale"].shape[1]
                if gs % 128 and gs != K:
                    return False
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# plan and pack
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One weight stream: the leaves whose columns it concatenates."""

    name: str
    leaves: Tuple[str, ...]
    bits: int                 # 4, 8 or 16 (bf16)
    K: int
    N: Tuple[int, ...]        # columns of each leaf
    gs: int                   # quant group size along K (0 for bf16)

    @property
    def Ntot(self) -> int:
        return sum(self.N)

    @property
    def payload_bytes(self) -> int:
        return self.K * self.Ntot * self.bits // 8

    @property
    def qparam_bytes(self) -> int:
        return 0 if not self.gs else 2 * 4 * (self.K // self.gs) * self.Ntot


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    B: int
    L: int
    hid: int
    H: int
    KH: int
    D: int
    G: int
    inter: int
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
    gu: StreamPlan
    dn: StreamPlan
    lm: StreamPlan
    rms_eps: float

    @property
    def streams(self) -> Tuple[StreamPlan, ...]:
        return (self.qkv, self.o, self.gu, self.dn, self.lm)

    @property
    def weight_bytes(self) -> int:
        """Bytes one step streams: every payload and qparam once."""
        per_layer = sum(s.payload_bytes + s.qparam_bytes
                        for s in self.streams[:4])
        return self.L * per_layer + self.lm.payload_bytes + \
            self.lm.qparam_bytes


def _stream_plan(name, leaf_names, leaves, gaxis) -> StreamPlan:
    first = leaves[0]
    bits = _weight_bits(first)
    if bits == 16:
        K = first["w"].shape[-2]
        N = tuple(int(lf["w"].shape[-1]) for lf in leaves)
        return StreamPlan(name, leaf_names, 16, int(K), N, 0)
    K = first["w_q"].shape[-2]
    N = tuple(int(lf["scale"].shape[-1]) for lf in leaves)
    g = first["scale"].shape[gaxis]
    return StreamPlan(name, leaf_names, bits, int(K), N, int(K // g))


def make_plan(cfg: ModelConfig, rt: RuntimeConfig, params: Dict) -> MegaPlan:
    """Shapes of one decode step. Params may be numpy or tensor leaves."""
    lp = params["layers"]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = {name: _stream_plan(name, leaves, [lp[n] for n in leaves], 1)
          for name, leaves in _LAYER_STREAMS}
    lm = _stream_plan("lm", ("lm_head",), [params["lm_head"]], 0)
    mode = rt.cache.mode
    if mode == CacheMode.DEFAULT:
        kv_dtype_name = "float32" if rt.dtype == "float32" else "bfloat16"
    else:
        kv_dtype_name = "int8" if mode == CacheMode.INT8 else "uint8"
    return MegaPlan(
        B=rt.max_batch, L=cfg.num_layers, hid=cfg.hidden_size, H=H, KH=KH,
        D=D, G=H // KH, inter=cfg.intermediate_size,
        QKVN=(H + 2 * KH) * D, V=cfg.vocab_size, ps=rt.cache.page_size,
        maxP=rt.max_pages_per_seq, kv_mode=mode,
        kv_bits={CacheMode.DEFAULT: 16, CacheMode.INT8: 8,
                 CacheMode.UINT4: 4}[mode],
        kv_dtype_name=kv_dtype_name, has_qkv_bias="b" in lp["q_proj"],
        qkv=sp["qkv"], o=sp["o"], gu=sp["gu"], dn=sp["dn"], lm=lm,
        rms_eps=cfg.rms_norm_eps)


def pack_cache_key_fields(plan: MegaPlan) -> tuple:
    """The plan fields the packed arrays depend on: not the batch, the page
    geometry or the KV mode, so those may change under one pack."""
    return (PACK_VERSION, plan.L, plan.hid, plan.H, plan.KH, plan.D, plan.V,
            plan.has_qkv_bias, plan.qkv, plan.o, plan.gu, plan.dn, plan.lm)


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
    units = 128 if pay.dtype == torch.uint8 else 256
    return pay.shape[-2] % CHUNK_K == 0 and pay.shape[-1] % units == 0


def pack_payload(pay: torch.Tensor) -> torch.Tensor:
    """Loader payload [.., K, N*] (TILE-128 u4 bytes, int8 or bf16) ->
    [.., N/256, K/64, chunk] in the kernel's fragment order (a copy): each
    256-column tile's 64-row chunks one after the other, each chunk laid
    out so that every lane of the product finds its mma operands in
    16-byte pieces."""
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
    fragment order under "w_f" (a copy), scale / zero as they are. A leaf
    narrower than the kernel takes (K % 64 or N % 256: tiny models, which
    only the plain version runs) keeps the loader's layout."""
    pay = leaf["w_q"] if "w_q" in leaf else leaf["w"].to(torch.bfloat16)
    out = {k: leaf[k] for k in ("scale", "zero") if k in leaf}
    if can_pack_payload(pay):
        out["w_f"] = pack_payload(pay)
    else:
        out["w_q" if "w_q" in leaf else "w"] = pay.contiguous()
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


def pack_params(cfg: ModelConfig, plan: MegaPlan, params: Dict) -> Dict:
    """The kernel's weight arguments from the tensor param tree
    (`params_from_numpy` output, already on the device): each payload
    re-laid in fragment order (a copy: see the module docstring), the f32
    scale / zero leaves as they are, and the small f32 norm / bias
    arrays."""
    lp = params["layers"]

    out = {"layers": {n: packed_leaf(lp[n]) for _, names in _LAYER_STREAMS
                      for n in names},
           "lm_head": packed_leaf(params["lm_head"]),
           "norms": _bf16_rounded_f32(torch.stack(
               [lp["input_layernorm"], lp["post_attention_layernorm"]],
               dim=1)),                                       # [L, 2, hid]
           "final_norm": _bf16_rounded_f32(params["norm"]),
           "qkv_b": None}
    if plan.has_qkv_bias:
        out["qkv_b"] = _bf16_rounded_f32(torch.cat(
            [lp[n]["b"] for n in ("q_proj", "k_proj", "v_proj")], dim=1))
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


def stream_gaps(sp: StreamPlan) -> List[str]:
    """Why csrc/di_product.cuh cannot run this stream (empty = it can): its
    tiles are 256 columns wide and its K chunks 64 rows deep."""
    gaps = []
    if any(n % 256 for n in sp.N):
        gaps.append(f"{sp.name}: columns {sp.N} not multiples of 256")
    if sp.K % CHUNK_K or (sp.gs and sp.gs % CHUNK_K):
        gaps.append(f"{sp.name}: K {sp.K} / group {sp.gs} not multiples "
                    f"of {CHUNK_K}")
    return gaps


def cuda_kernel_gaps(plan: MegaPlan) -> List[str]:
    """Why csrc/megakernel.cu cannot run this plan (empty = it can)."""
    gaps = [g for sp in plan.streams for g in stream_gaps(sp)]
    if plan.G > 8:
        gaps.append(f"{plan.G} query heads per KV head (kernel takes 8)")
    if plan.D != 128:
        gaps.append("head_dim != 128")
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


def _stream_dot(x, packed, sp: StreamPlan, layer: Optional[int]):
    outs = []
    for name in sp.leaves:
        leaf = packed["lm_head"] if layer is None else \
            {k: v[layer] for k, v in packed["layers"][name].items()}
        outs.append(leaf_dot(x, leaf))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _rms(x, w, eps):
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * w


def _rot_half(x, D):
    """rotate_half per D-sized head block of [B, n*D]."""
    x3 = x.reshape(x.shape[0], -1, D)
    h = D // 2
    return torch.cat([-x3[..., h:], x3[..., :h]], dim=-1).reshape(x.shape)


def _attend_ref(plan: MegaPlan, q, k_new, v_new, cache: KVCache, phys,
                len_eff, scale):
    """q [B, H, D] (bf16-rounded f32), k_new/v_new [B, KH, D] f32; phys
    [B, maxP] physical pages of this layer; attends tokens t < len_eff[b]
    of the pool plus the new token."""
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
    mask = (torch.arange(S, device=q.device)[None, :] <
            len_eff[:, None])[:, None, None, :]
    s = torch.where(mask, s, _NEG_INF)
    s_new = torch.einsum("bhgd,bhd->bhg", qf, k_new)[..., None] * scale
    p = torch.softmax(torch.cat([s, s_new], dim=-1), dim=-1)
    p_old = p[..., :S] * mask
    if mode == CacheMode.DEFAULT:
        out = torch.einsum("bhgs,bhsd->bhgd", p_old, v_raw)
    else:
        v_scale, v_zero = qparams(cache.v_qparams)
        out = torch.einsum("bhgs,bhsd->bhgd", p_old * v_scale, v_raw) + \
            (p_old * v_zero).sum(-1, keepdim=True)
    out = out + p[..., S:] * v_new[:, :, None, :]
    return out.reshape(B, KH * G * D)


def decode_megakernel_ref(plan: MegaPlan, packed: Dict, x0: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          page_tables: torch.Tensor, lens: torch.Tensor,
                          active: torch.Tensor, cache: KVCache,
                          skip_attention: bool = False) -> torch.Tensor:
    """The whole decode step, phase by phase (see `decode_megakernel`).
    Updates the pool in place; returns logits [B, V] f32."""
    B, L, H, KH, D = x0.shape[0], plan.L, plan.H, plan.KH, plan.D
    bf = torch.bfloat16
    HD, KD = H * D, KH * D
    cosf, sinf = cos.to(bf).float(), sin.to(bf).float()
    cq, sq = cosf.repeat(1, H), sinf.repeat(1, H)
    ck, sk = cosf.repeat(1, KH), sinf.repeat(1, KH)
    active = active.bool()
    len_eff = torch.where(active, lens, torch.zeros_like(lens))
    tgt = target_pages(page_tables, lens, plan.ps).long()
    offs = (lens % plan.ps).long()
    scale = 1.0 / math.sqrt(D)
    norms = packed["norms"]
    resid = x0.to(bf).float()
    for l in range(L):
        x = _rms(resid, norms[l, 0], plan.rms_eps).to(bf)
        qkv = _stream_dot(x, packed, plan.qkv, l)
        if packed["qkv_b"] is not None:
            qkv = qkv + packed["qkv_b"][l]
        qr, kr, vr = qkv[:, :HD], qkv[:, HD:HD + KD], qkv[:, HD + KD:]
        q_rot = (qr * cq + _rot_half(qr, D) * sq).to(bf).float()
        k_rot = kr * ck + _rot_half(kr, D) * sk
        k3, v3 = k_rot.reshape(B, KH, D), vr.reshape(B, KH, D)
        if skip_attention:
            attn = torch.zeros((B, HD), dtype=torch.float32, device=x.device)
        else:
            attn = _attend_ref(plan, q_rot.reshape(B, H, D), k3, v3, cache,
                               page_tables * L + l, len_eff, scale)
            kv_ops._write(cache, plan.kv_mode, k3[active], v3[active],
                          (tgt * L + l)[active], offs[active])
        resid = resid + _stream_dot(attn.to(bf), packed, plan.o, l)
        x = _rms(resid, norms[l, 1], plan.rms_eps).to(bf)
        gu = _stream_dot(x, packed, plan.gu, l)
        g, u = gu[:, :plan.inter], gu[:, plan.inter:]
        act = (g * torch.sigmoid(g) * u).to(bf)
        resid = resid + _stream_dot(act, packed, plan.dn, l)
    x = _rms(resid, packed["final_norm"], plan.rms_eps).to(bf)
    return _stream_dot(x, packed, plan.lm, None)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

# order of the integer arguments of di_megakernel (csrc/megakernel.cu IArg)
_IARGS = ("norms", "final_norm", "qkv_b", "x0", "cos", "sin", "pt", "lens",
          "active", "k_pool", "v_pool", "k_qp", "v_qp", "logits", "resid",
          "rec", "partial", "att_ml", "att_acc", "ssq", "barrier", "status",
          "launches", "trace", "B", "L", "hid", "H", "KH", "inter", "V", "ps", "maxP",
          "kv_kind", "ql", "nsplit", "split_len", "mpad", "skip_attn", "grid")
_KV_KIND = {"float32": 0, "bfloat16": 1, "int8": 2, "uint8": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int


def padded_rows(B: int) -> int:
    """Rows of the kernel's x records: 16 (one m16 tile), 32, or 64 (two
    passes of two tiles)."""
    return 16 if B <= 16 else (32 if B <= 32 else 64)


def choose_split(tiles: int, chunks: int, chunk_bytes: int, B: int,
                 passes: int, grid: int) -> Tuple[int, int]:
    """K split of one product: (ksplit, chunks per split). Each block walks
    its work items (tile x split x pass) one after the other, so the cost
    of a split is waves x (payload + partial sums written and read back +
    a fixed per-item share) in bytes on the slowest block."""
    best = None
    for ks in range(1, chunks + 1):
        cps = -(-chunks // ks)
        if -(-chunks // cps) != ks:
            continue
        items = tiles * ks * passes
        per_item = cps * chunk_bytes + 2 * min(B, 32) * 256 * 4 + 24576
        cost = -(-items // grid) * per_item
        if best is None or cost < best[0]:
            best = (cost, ks, cps)
    return best[1], best[2]


def stream_args(sp: StreamPlan, leaves: List[Dict], layered: bool,
                ksplit: int, cps: int) -> List[int]:
    """One stream of packed leaves as csrc/di_product.cuh `fill_stream`
    reads it."""
    w, s, z, w_ls, q_ls, n = ([0] * 3 for _ in range(6))
    for j, leaf in enumerate(leaves):
        pay = leaf["w_f"]
        w[j] = pay.data_ptr()
        w_ls[j] = pay.stride(0) * pay.element_size() if layered else 0
        n[j] = sp.N[j]
        if sp.bits != 16:
            s[j], z[j] = leaf["scale"].data_ptr(), leaf["zero"].data_ptr()
            q_ls[j] = leaf["scale"].stride(0) if layered else 0
    G = 1 if not sp.gs else sp.K // sp.gs
    return w + s + z + w_ls + q_ls + n + [len(leaves), sp.K, G, sp.bits,
                                          ksplit, cps]


def _check_leaf(sp: StreamPlan, leaf: Dict, n: int, lead: Tuple[int, ...],
                dev, who: str = "decode_megakernel") -> None:
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


class _Launch:
    """Per (plan, device) launch geometry and scratch of the kernel."""

    def __init__(self, plan: MegaPlan, dev: torch.device):
        gaps = cuda_kernel_gaps(plan)
        if gaps:
            raise ValueError("decode_megakernel: " + "; ".join(gaps))
        lib = kernel_build.load("megakernel")
        self.fn = kernel_build.function(
            "megakernel", "di_megakernel", [_P, _P, _P])
        grid_fn = lib.di_megakernel_grid
        grid_fn.argtypes, grid_fn.restype = [_I, _I, _I], _I
        B = plan.B
        self.mpad = padded_rows(B)
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        self.grid = grid_fn(idx, self.mpad, plan.hid)
        if self.grid <= 0:
            raise RuntimeError("decode_megakernel: the kernel does not fit "
                               "on the device (occupancy query gave 0)")
        passes = self.mpad // (16 if self.mpad == 16 else 32)
        self.splits = {}
        for sp in plan.streams:
            chunk_bytes = CHUNK_K * 256 * sp.bits // 8
            if sp.name == "lm":     # its partial sums ARE the logits
                self.splits[sp.name] = (1, sp.K // CHUNK_K)
            else:
                self.splits[sp.name] = choose_split(
                    sp.Ntot // 256, sp.K // CHUNK_K, chunk_bytes, B, passes,
                    self.grid)
        # attention items are (slot, KV head, stripe): about two items a
        # block, at most 16 stripes (the kernel's kMaxStripes); a stripe's
        # units are ATT_UNIT tokens
        self.split_len = ATT_UNIT
        units = -(-plan.maxP * plan.ps // ATT_UNIT)
        self.nsplit = max(1, min(16, units,
                                 -(-2 * self.grid // (B * plan.KH))))

        def zeros(n, dt):
            return torch.zeros(n, dtype=dt, device=dev)

        kmax = max(sp.K for sp in plan.streams)
        self.rec = zeros((kmax // CHUNK_K) * self.mpad *
                         (CHUNK_K * 2 + 4), torch.uint8)
        self.partial = zeros(max(self.splits[sp.name][0] * B * sp.Ntot
                                 for sp in plan.streams[:4]), torch.float32)
        self.resid = zeros(B * plan.hid, torch.float32)
        self.att_ml = zeros(B * plan.H * self.nsplit * 2, torch.float32)
        self.att_acc = zeros(B * plan.H * self.nsplit * plan.D,
                             torch.float32)
        self.ssq = zeros(B * (plan.hid // 128), torch.float32)
        self.barrier = zeros(1, torch.int32)
        self.status = zeros(1, torch.int32)


_launches: Dict = {}


def _indexed(device) -> torch.device:
    """`cuda` -> `cuda:<current>`: tensors always report the index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _launch_state(plan: MegaPlan, dev: torch.device) -> _Launch:
    key = (plan, dev)
    st = _launches.get(key)
    if st is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_megakernel: the first launch of a "
                               "plan must not be under CUDA graph capture")
        st = _launches[key] = _Launch(plan, dev)
    return st


def check_status(plan: MegaPlan, device) -> None:
    """Waits for the device and raises if a launch of this plan gave up at
    a grid barrier (blocks that never became co-resident)."""
    st = _launches.get((plan, _indexed(device)))
    if st is None:
        return
    code = int(st.status.item())
    if code:
        st.status.zero_()
        st.barrier.zero_()
        raise RuntimeError(f"decode_megakernel: grid barrier after phase "
                           f"{code - 1} timed out")


def launch_geometry(plan: MegaPlan, device) -> Dict:
    """Grid, K splits and attention splits of this plan's launches."""
    st = _launch_state(plan, _indexed(device))
    return dict(grid=st.grid, mpad=st.mpad, splits=dict(st.splits),
                nsplit=st.nsplit, split_len=st.split_len)


def decode_megakernel(plan: MegaPlan, packed: Dict, x0: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      page_tables: torch.Tensor, lens: torch.Tensor,
                      active: torch.Tensor, cache: KVCache,
                      skip_attention: bool = False,
                      trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One whole decode forward.

    x0 [B, hid] bf16: the embedded input tokens; cos/sin [B, D] bf16: the
    full-D RoPE tiles at each slot's position; page_tables [B, maxP] int32
    LOGICAL pages (logical page g owns pool pages g*L + l); lens [B] int32
    tokens already cached; active [B] bool; cache: the pool, updated in
    place at each active slot's new token. Returns logits [B, V] f32
    (rows of inactive slots unspecified). CPU tensors take
    `decode_megakernel_ref`; CUDA tensors launch the kernel or raise.
    `skip_attention` (the stream probe's replica mode) leaves out attention
    and the pool writes. `trace` (int64 [trace_len(plan)] on the
    card) receives block 0's timestamps: see `phase_times`."""
    if x0.device.type == "cpu":
        return decode_megakernel_ref(plan, packed, x0, cos, sin, page_tables,
                                     lens, active, cache, skip_attention)
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
    st = _launch_state(plan, dev)
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
        partial=st.partial.data_ptr(), att_ml=st.att_ml.data_ptr(),
        att_acc=st.att_acc.data_ptr(), ssq=st.ssq.data_ptr(),
        barrier=st.barrier.data_ptr(),
        status=st.status.data_ptr(),
        launches=decode_megakernel.counter.pointer(dev),
        trace=0 if trace is None else trace.data_ptr(),
        B=B, L=plan.L, hid=plan.hid, H=plan.H, KH=plan.KH, inter=plan.inter,
        V=plan.V, ps=plan.ps, maxP=plan.maxP,
        kv_kind=_KV_KIND[plan.kv_dtype_name],
        ql=cache.k_qparams.shape[2] if quant else 0, nsplit=st.nsplit,
        split_len=st.split_len, mpad=st.mpad, skip_attn=int(skip_attention),
        grid=st.grid)
    logits = torch.empty((B, plan.V), dtype=torch.float32, device=dev)
    vals["logits"] = logits.data_ptr()
    ia = [vals[k] for k in _IARGS]
    if packed["qkv_b"] is not None and \
            tuple(packed["qkv_b"].shape) != (plan.L, plan.QKVN):
        raise ValueError("decode_megakernel: qkv_b shape")
    for sp in plan.streams:
        layered = sp.name != "lm"
        leaves = [packed["layers"][n] if layered else packed["lm_head"]
                  for n in sp.leaves]
        for leaf, n in zip(leaves, sp.N):
            _check_leaf(sp, leaf, n, (plan.L,) if layered else (), dev)
        ia += stream_args(sp, leaves, layered, *st.splits[sp.name])
    ia_arr = np.asarray(ia, np.int64)
    fa_arr = np.asarray([plan.rms_eps, 1.0 / math.sqrt(plan.D)], np.float64)
    rc = st.fn(ia_arr.ctypes.data, fa_arr.ctypes.data,
               kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"decode_megakernel launch failed: CUDA error "
                           f"{rc}")
    return logits


decode_megakernel.counter = kernel_build.LaunchCounter()

# the kernel's phases, in order, each followed by a grid barrier
LAYER_PHASES = ("resid1", "norm1", "qkv", "attention", "merge", "o",
                "resid2", "norm2", "gate_up", "swiglu", "down")
TAIL_PHASES = ("resid", "final_norm", "lm_head")


def trace_len(plan: MegaPlan) -> int:
    return 2 * (len(LAYER_PHASES) * plan.L + len(TAIL_PHASES)) + 1


def phase_times(plan: MegaPlan, trace: torch.Tensor) -> Dict[str, Dict]:
    """A traced launch's time by phase kind, summed over the layers, in ms:
    `work` is what block 0 spent in the phase itself, `wait` what it then
    spent in the grid barrier (the phase's slower blocks and the barrier's
    own cost). The kernel writes trace[0] at its start, trace[2p + 1] where
    block 0 ends phase p and trace[2p + 2] where it leaves p's barrier."""
    return phase_times_of(LAYER_PHASES * plan.L + TAIL_PHASES,
                          trace[:trace_len(plan)])


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
