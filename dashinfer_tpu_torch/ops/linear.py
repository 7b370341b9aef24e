"""Linear layers over plain or quantized weight leaves.

Counterpart of `dashinfer_tpu.ops.linear`. A weight leaf is a dict:
  {"w": [in, out]}                                        plain
  {"w_q": int8 [in, out] or uint8 (packed u4) [in, out/2],
   "scale": [groups, out] f32, "zero": [groups, out] f32}  weight-only
plus optional {"b": [out]}.

Dispatch mirrors the JAX package (linear.py:81-104, quant_matmul.py:31-42):
small M on the accelerator runs the fused-dequant `quant_matmul` kernel;
everything else takes the large-M formulation, a bf16 dequantized operand
and an f32 zero-term product through `torch.matmul` (the JAX package leaves
that product to XLA). Off the accelerator, the JAX package never takes its
kernel, so the port takes the large-M formulation at every M on the CPU.
"""

from typing import Dict

import torch

from dashinfer_tpu_torch.ops import quant_matmul as _qmm
from dashinfer_tpu_torch.ops.u4pack import weight_levels


def weight_bits(wd: Dict) -> int:
    """int8 payload = 8-bit; uint8 payload = packed uint4."""
    return 8 if wd["w_q"].dtype == torch.int8 else 4


def dequantize_weight(wd: Dict, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the weight [in, out] from a quantized leaf (group g
    covers input rows [g*gs, (g+1)*gs); per-channel = one group)."""
    scale, zero = wd["scale"], wd["zero"]
    q = weight_levels(wd["w_q"]).float()
    in_dim = q.shape[0]
    groups = scale.shape[0]
    qg = q.reshape(groups, in_dim // groups, -1)
    w = qg * scale[:, None, :] + zero[:, None, :]
    return w.reshape(in_dim, -1).to(out_dtype)


def _quant_matmul_large_m(x: torch.Tensor, wd: Dict) -> torch.Tensor:
    """x [..., K] @ dequant(wd) -> f32, as the JAX package formulates it:
      x @ (q*s_rep + z_rep) == bf16(x) @ bf16(q * s_rep)  +  xsum_g @ zero
    The scale product is rounded to bf16 like the JAX operand, and the
    product has bf16 operands and an f32 result: on the card one tensor-core
    GEMM with f32 output; on the CPU, which has no such GEMM, an f32 GEMM of
    the same (exactly representable) operands. Only the order of the f32
    sums differs from the reference."""
    scale, zero = wd["scale"], wd["zero"]
    q = weight_levels(wd["w_q"]).to(torch.bfloat16)
    K, N = q.shape
    G = scale.shape[0]
    gs = K // G
    sb = scale.to(torch.bfloat16).repeat_interleave(gs, dim=0)     # [K, N]
    xb = x.reshape(-1, K).to(torch.bfloat16)
    if xb.is_cuda:
        part = torch.mm(xb, q * sb, out_dtype=torch.float32)
    else:
        part = torch.mm(xb.float(), (q * sb).float())
    xg = x.float().reshape(*x.shape[:-1], G, gs).sum(-1)           # [..., G]
    return part.reshape(*x.shape[:-1], N) + torch.matmul(xg, zero)


def use_fused_gemv(m: int, wd: Dict, x: torch.Tensor) -> bool:
    """The kernel's gate: a CUDA tensor, M <= 32, out % 256 == 0 and the
    Pallas kernel's K-tile rule."""
    if not x.is_cuda or m > _qmm.MAX_FUSED_M:
        return False
    k = wd["w_q"].shape[-2]
    n_eff = wd["scale"].shape[-1]
    gs = k // wd["scale"].shape[-2]
    kt = min(gs, 512)
    return k % kt == 0 and gs % kt == 0 and n_eff % 256 == 0


def linear(x: torch.Tensor, wd: Dict, out_dtype=None,
           use_kernel: bool = True) -> torch.Tensor:
    """x: [..., in] @ w [in, out] (+ b). `use_kernel=False` runs the
    kernel's plain version where the kernel would run (a check of the
    kernel against its twin on the same inputs)."""
    out_dtype = out_dtype or x.dtype
    if "w_q" in wd:
        m = x.numel() // x.shape[-1]
        if use_fused_gemv(m, wd, x):
            mm = _qmm.quant_matmul if use_kernel else _qmm.quant_matmul_plain
            out = mm(x, wd, out_dtype)
        else:
            out = _quant_matmul_large_m(x, wd).to(out_dtype)
    elif "w" in wd:
        out = torch.matmul(x, wd["w"].to(x.dtype)).to(out_dtype)
    else:
        raise NotImplementedError(
            f"weight leaf {sorted(wd)} (activation-quantized weights are not "
            "ported to the PyTorch package yet)")
    b = wd.get("b")
    if b is not None:
        out = out + b.to(out_dtype)
    return out
