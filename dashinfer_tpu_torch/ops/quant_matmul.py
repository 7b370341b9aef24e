"""Fused-dequant weight-only GEMV/GEMM for small M (A16W8 / A16W4).

Counterpart of `dashinfer_tpu.ops.pallas.quant_matmul`. Three things live
here: the launch wrapper `quant_matmul` of the CUDA kernel in
csrc/quant_matmul.cu, its plain PyTorch twin `quant_matmul_plain` (the same
math as the Pallas `_kernel`), and the kernel's launch count
(`quant_matmul.counter`, which the kernel itself increments on the card).

Math (asymmetric, w = q * scale_g + zero_g per group g of input rows):
    out[m, n] = sum_g scale[g,n] * (bf16(x_g) @ q_g)[m,n] + xsum[m,g] * zero[g,n]
with xsum over the f32 x, f32 accumulation and the integer payload exact.
"""

import ctypes
from typing import Dict

import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.ops.u4pack import weight_levels

MAX_FUSED_M = 32   # above this the large-M path of ops/linear.py runs

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, x_bf16, w, bits, scale, zero, out, out_bf16, partial, records, M, K,
# N, G, ksplit, launches, stream
_ARGTYPES = [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
             _P]
_CHUNK_K = 64     # K rows per chunk of the kernel (csrc/quant_matmul.cu)


def quant_matmul_plain(x: torch.Tensor, wd: Dict,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x: [..., K]; returns [..., N]."""
    scale, zero = wd["scale"], wd["zero"]
    G, N = scale.shape
    K = x.shape[-1]
    gs = K // G
    xf = x.reshape(-1, K).float()
    M = xf.shape[0]
    q = weight_levels(wd["w_q"]).float().reshape(G, gs, N)
    xb = xf.to(torch.bfloat16).float().reshape(M, G, gs).transpose(0, 1)
    part = torch.bmm(xb, q)                                   # [G, M, N]
    xsum = xf.reshape(M, G, gs).sum(-1).t()                   # [G, M]
    out = (part * scale[:, None, :] +
           xsum[:, :, None] * zero[:, None, :]).sum(0)
    return out.to(out_dtype).reshape(*x.shape[:-1], N)


def _ksplit(n_tiles: int, groups: int, device) -> int:
    """Split K over blocks until there are ~2 blocks per SM; every split
    holds at least one whole quant group."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(groups, max(1, -(-2 * sms // n_tiles)))
    per = -(-groups // want)
    return -(-groups // per)


def quant_matmul(x: torch.Tensor, wd: Dict,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: [..., K] bf16/f32 with prod(lead) <= 32; wd: quantized leaf.
    Returns [..., N] in out_dtype. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, wd, out_dtype)
    w_q, scale, zero = wd["w_q"], wd["scale"], wd["zero"]
    if not x.is_cuda:
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    G, N = scale.shape
    bits = 8 if w_q.dtype == torch.int8 else 4
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul: x dtype {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul: out dtype {out_dtype}")
    if w_q.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"quant_matmul: payload dtype {w_q.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError("quant_matmul: scale/zero must be float32")
    if not 1 <= M <= MAX_FUSED_M:
        raise ValueError(f"quant_matmul: M={M} outside [1, {MAX_FUSED_M}]")
    if N % 256 or K % G:
        raise ValueError(f"quant_matmul: N={N} (needs % 256) K={K} G={G}")
    if tuple(w_q.shape) != (K, N if bits == 8 else N // 2) or \
            tuple(zero.shape) != (G, N):
        raise ValueError("quant_matmul: weight shapes "
                         f"{tuple(w_q.shape)} {tuple(zero.shape)} for K={K} "
                         f"N={N} G={G}")
    for t in (x2, w_q, scale, zero):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul: operands must be contiguous "
                             "and on one device")
    if w_q.data_ptr() % 16:
        raise ValueError("quant_matmul: payload must be 16-byte aligned")

    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ksplit = _ksplit(N // 256, G, x.device)
    partial = (torch.empty((ksplit, M, N), dtype=torch.float32,
                           device=x.device) if ksplit > 1 else None)
    # the kernel's per-chunk x records: [16*MT, 64] bf16 + [2, 16*MT] f32
    rows = 32 if M > 16 else 16
    n_chunks = G * -(-(K // G) // _CHUNK_K)
    records = torch.empty((n_chunks, rows * (_CHUNK_K * 2 + 8)),
                          dtype=torch.uint8, device=x.device)
    fn = kernel_build.function("quant_matmul", "di_quant_matmul", _ARGTYPES)
    with torch.cuda.device(x.device):   # the C side launches on it
        rc = fn(x2.data_ptr(), int(x.dtype == torch.bfloat16),
                w_q.data_ptr(), bits, scale.data_ptr(), zero.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                partial.data_ptr() if partial is not None else None,
                records.data_ptr(), M, K, N, G, ksplit,
                quant_matmul.counter.pointer(x.device),
                kernel_build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    return out.reshape(*x.shape[:-1], N)


quant_matmul.counter = kernel_build.LaunchCounter()
