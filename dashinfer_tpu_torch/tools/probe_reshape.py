"""What the per-layer q re-layout `[B, H*D] -> [B, KH, 8, D]` costs.

Counterpart of the JAX package's `tools/probe_reshape.py`, which asked which
layout transforms its compiler lowers and what the decode megakernel's
per-layer q pack costs there. On this card every variant "lowers": a kernel
computes its own addresses. What is left to measure is the cost of the copy
itself (csrc/probes.cu `relayout_kernel`): query head `h * G + g` goes to
`[h, g]` of a KV head's padded group of 8, rows `g >= G` zeroed, with one
warp a head row (`rows`, the reference's per-row slices) or one thread a
float4 of the output (`flat`, its whole-array reshape + scatter). The port's
decode megakernel needs no such copy (its attention phase addresses q by
head); the probe says what a design that did would pay per layer.

    python -m dashinfer_tpu_torch.tools.probe_reshape
"""

import ctypes
import json
import sys
from typing import Dict, List

import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.tools.bench_stream import graph_ms

VARIANTS = ("rows", "flat")
B, H, KH, D, G8 = 16, 28, 4, 128, 8      # the reference probe's shapes
_P, _I = ctypes.c_void_p, ctypes.c_int

counter = kernel_build.LaunchCounter()


def relayout_plain(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """q [B, H*D] -> [B, KH, 8, D] with the G = H / KH query heads of each
    KV head in rows 0..G-1 and zeros below."""
    b = q.shape[0]
    g = q.shape[1] // D // kv_heads
    out = torch.zeros((b, kv_heads, G8, D), dtype=q.dtype, device=q.device)
    out[:, :, :g] = q.reshape(b, kv_heads, g, D)
    return out


def relayout(q: torch.Tensor, kv_heads: int, variant: str = "rows",
             out: torch.Tensor = None) -> torch.Tensor:
    """`relayout_plain` through the kernel. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return relayout_plain(q, kv_heads)
    heads = q.shape[1] // D
    if not q.is_cuda or q.dtype != torch.float32 or q.dim() != 2 or \
            q.shape[1] % D or heads % kv_heads or heads // kv_heads > G8 or \
            not q.is_contiguous():
        raise ValueError(f"relayout: contiguous float32 [B, H*{D}] on a CUDA "
                         f"device, H / KH <= {G8}")
    fn = kernel_build.function("probes", "di_probe_relayout",
                               [_P, _P, _I, _I, _I, _I, _P, _P])
    if out is None:
        out = torch.empty((q.shape[0], kv_heads, G8, D), dtype=q.dtype,
                          device=q.device)
    rc = fn(q.data_ptr(), out.data_ptr(), q.shape[0], heads, kv_heads,
            VARIANTS.index(variant), counter.pointer(q.device),
            kernel_build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"relayout launch failed: CUDA error {rc}")
    return out


def measure(device="cuda", seed: int = 0) -> List[Dict]:
    """Per variant: equality with the plain version and us per re-layout
    (a CUDA graph of 28 launches, one per layer of a step), and beside it
    the same graph of one-row re-layouts (B = 1: 30 KB moved, so what it
    takes is the floor of one kernel node in a graph replay)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H * D), generator=gen, device=dev)
    q1 = q[:1].contiguous()
    want = relayout_plain(q, KH)
    plain_ms = graph_ms(lambda: relayout_plain(q, KH), 28)
    rows = []
    for variant in VARIANTS:
        out = torch.full((B, KH, G8, D), float("nan"), device=dev)
        out1 = torch.empty((1, KH, G8, D), device=dev)
        relayout(q, KH, variant, out)
        equal = bool(torch.equal(out, want))
        ms = graph_ms(lambda: relayout(q, KH, variant, out), 28)
        floor_ms = graph_ms(lambda: relayout(q1, KH, variant, out1), 28)
        rows.append(dict(variant=variant, equal=equal,
                         max_abs_err=(out - want).abs().max().item(),
                         ms=ms, plain_ms=plain_ms,
                         bytes=q.numel() * 4 + out.numel() * 4,
                         floor_ms=floor_ms,
                         floor_bytes=q1.numel() * 4 + out1.numel() * 4))
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_reshape: no CUDA device", file=sys.stderr)
        return 2
    with torch.no_grad():
        for r in measure():
            print(f"{r['variant']:5s} equal={r['equal']} "
                  f"{1e3 * r['ms']:.2f} us/re-layout (plain version "
                  f"{1e3 * r['plain_ms']:.2f}; one row, the launch floor, "
                  f"{1e3 * r['floor_ms']:.2f})", flush=True)
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
