"""Fused-dequant weight-only GEMV/GEMM for small M (A16W8 / A16W4).

Counterpart of `dashinfer_tpu.ops.pallas.quant_matmul`. Here: the launch
wrapper `quant_matmul` of the CUDA kernel in csrc/quant_matmul.cu, its plain
PyTorch twin `quant_matmul_plain` (the same math as the Pallas `_kernel`),
the kernel's K split (`split_plan`, `split_chunks`) and its launch count
(`quant_matmul.counter`, which the kernel itself increments on the card).

Math (asymmetric, w = q * scale_g + zero_g per group g of input rows):
    out[m, n] = sum_g scale[g,n] * (bf16(x_g) @ q_g)[m,n] + xsum[m,g] * zero[g,n]
with xsum over the f32 x, f32 accumulation and the integer payload exact.
"""

import ctypes
import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.ops.u4pack import weight_levels

MAX_FUSED_M = 32   # above this the large-M path of ops/linear.py runs
TILE_N = 256       # output columns of a u4 TILE-128 tile
CHUNK_K = 64       # K rows a chunk, at most (the kernel refuses more than
                   # its stage holds)
# How many times faster per byte a tile's partials are summed than a split
# block streams its payload (fitted on the H100)
REDUCE_SPEEDUP = 20
# The most splits whose partials one block sums in one pass; more are summed
# in two (groups, then the groups' sums: `reduce_fan`)
ONE_PASS = 8
# Payload chunks a resident block at most of a product that runs M > 16 on
# two blocks of 16 rows a tile (`split_plan`)
SMALL_CHUNKS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, x_bf16, w, bits, scale, zero, out, out_bf16, partial, tickets, status,
# M, K, N, G, rows, cols, slices, splits, fan, tb, launches, stream
_ARGTYPES = [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _P, _P]


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


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's grid for one product: `cols` blocks across N of `tb`
    256-column tiles each, `slices` across M (one block takes all M rows,
    or two take 16 each), each split over K into `splits` ranges of its
    `chunks` chunks. A chunk is at most `rows` K rows of one quant group
    (`cpg` chunks a group), so a split may start or end inside a group."""
    gs: int
    rows: int
    cpg: int
    chunks: int
    tb: int
    cols: int
    slices: int
    splits: int


def reduce_optimum(plan: SplitPlan, M: int, bits: int) -> int:
    """The split count S that minimizes a block's time (M x rows), C / S
    chunks streamed + S partials summed by the tile's last blocks:
    sqrt(C * speedup * chunk bytes / partial bytes)."""
    chunk_bytes = plan.rows * TILE_N * plan.tb * bits // 8
    partial_bytes = M * TILE_N * plan.tb * 4
    return math.ceil(math.sqrt(plan.chunks * REDUCE_SPEEDUP * chunk_bytes /
                               partial_bytes))


def split_plan(K: int, N: int, G: int, M: int, bits: int, sms: int,
               blocks_per_sm: int) -> SplitPlan:
    """A u4 block takes two tiles (a 256-byte payload row, as an int8
    tile's) at M <= 8 where the tiles pair up and are many (at least one
    for every two SMs: a narrower product is split over K, where the single
    tiles' partials sum faster). A block takes all M rows (the payload
    dequantized once), but for a product at M > 16 whose payload is at
    most SMALL_CHUNKS chunks a resident block: there it is bound by its
    latency, not by the dequant, and two blocks of 16 rows a tile halve
    the partials each sums. K is split until the grid holds as many blocks
    as the card keeps resident (`blocks_per_sm` on each of `sms`; more
    would leave a second, partial wave that streams its bytes with the card
    mostly idle), and no further than `reduce_optimum`. It stops at
    ONE_PASS where that already puts a block on half the SMs and a block
    streams no more than ONE_PASS chunks: there a second pass of the sum
    costs more than the chunks it saves. (`tools/qmm_probe.py --splits` on
    the H100: q|o and k|v_proj take two 16-row blocks and q|o one pass;
    gate|up and down one block.)"""
    gs = K // G
    rows = min(CHUNK_K, gs)
    cpg = -(-gs // rows)
    tiles = N // TILE_N
    tb = 2 if (bits == 4 and M <= 8 and tiles % 2 == 0 and
               2 * tiles >= sms) else 1
    plan = SplitPlan(gs, rows, cpg, G * cpg, tb, tiles // tb, 1, 1)
    if M > 16 and plan.cols * plan.chunks <= \
            SMALL_CHUNKS * blocks_per_sm * sms:
        plan = dataclasses.replace(plan, slices=2)
    across = plan.cols * plan.slices
    splits = min(plan.chunks, blocks_per_sm * sms // across,
                 reduce_optimum(plan, -(-M // plan.slices), bits))
    if splits > ONE_PASS and 2 * across * ONE_PASS >= sms and \
            plan.chunks <= ONE_PASS * ONE_PASS:
        splits = ONE_PASS
    return dataclasses.replace(plan, splits=max(1, splits))


def reduce_fan(splits: int) -> int:
    """Splits a tile's partials are summed in groups of (the kernel sums
    each group's, then the groups'): all at once up to ONE_PASS, else
    ~sqrt."""
    return splits if splits <= ONE_PASS else math.ceil(math.sqrt(splits))


def split_chunks(plan: SplitPlan, split: int) -> List[Tuple[int, int, int]]:
    """(group, first K row, rows) of each chunk that split `split` of a tile
    runs, in order: the kernel's own arithmetic (csrc/quant_matmul.cu)."""
    c0 = split * plan.chunks // plan.splits
    c1 = (split + 1) * plan.chunks // plan.splits
    out = []
    for c in range(c0, c1):
        g, kc = divmod(c, plan.cpg)
        kc *= plan.rows
        out.append((g, g * plan.gs + kc, min(plan.rows, plan.gs - kc)))
    return out


class _Scratch:
    """A device's split-K scratch, allocated once at its largest: f32
    partials for the blocks the card keeps resident, of MAX_FUSED_M x 256
    outputs each (a split plan never has more split blocks, nor a block's
    slot more outputs: 32 x 256, 16 x 256 or 8 x 512), the tickets (a
    block column's groups' and its own: at most twice the blocks; zero
    between launches, each reset by the block that takes its last number)
    and the ring timeout flag. Products run one after another on a stream,
    so one set serves them all."""

    def __init__(self, device):
        self.sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        per_sm = ctypes.c_int(0)
        fn = kernel_build.function("quant_matmul",
                                   "di_quant_matmul_blocks_per_sm", [_P])
        with torch.cuda.device(device):
            rc = fn(ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(f"quant_matmul: no resident block on {device} "
                               f"(CUDA error {rc})")
        self.blocks_per_sm = per_sm.value
        blocks = self.blocks_per_sm * self.sms
        self.partial = torch.empty(blocks * MAX_FUSED_M * TILE_N,
                                   dtype=torch.float32, device=device)
        self.tickets = torch.zeros(2 * blocks, dtype=torch.int32,
                                   device=device)
        self.status = torch.zeros(1, dtype=torch.int32, device=device)


_scratch: Dict[torch.device, _Scratch] = {}


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _scratch_for(device) -> _Scratch:
    sc = _scratch.get(device)
    if sc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quant_matmul's first launch on a device must "
                               "not be under CUDA graph capture")
        sc = _scratch[device] = _Scratch(device)
    return sc


def check_status(device) -> None:
    """Waits for `device` and raises if a ring wait of the kernel there gave
    up (a payload copy that never landed): that launch's output, and that
    of every launch after it until now, is garbage. The status and the
    tickets are cleared first, so that later launches run."""
    sc = _scratch.get(_indexed(device))
    if sc is None:
        return
    code = int(sc.status.item())
    if code:
        sc.status.zero_()
        sc.tickets.zero_()
        raise RuntimeError(f"quant_matmul: a ring wait timed out on {device} "
                           f"(status {code})")


def _launch(x2: torch.Tensor, wd: Dict, out: torch.Tensor, plan: SplitPlan,
            fn=None) -> None:
    """One launch of the kernel (or of `fn`, a build of it with the same
    interface) on validated operands."""
    w_q, scale, zero = wd["w_q"], wd["scale"], wd["zero"]
    M, K = x2.shape
    G, N = scale.shape
    sc = _scratch_for(x2.device)
    if plan.splits > 1 and plan.cols * plan.slices * plan.splits > \
            sc.blocks_per_sm * sc.sms:
        raise ValueError(f"quant_matmul: {plan} needs more scratch")
    if fn is None:
        fn = kernel_build.function("quant_matmul", "di_quant_matmul",
                                   _ARGTYPES)
    with torch.cuda.device(x2.device):   # the C side launches on it
        rc = fn(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                w_q.data_ptr(), 8 if w_q.dtype == torch.int8 else 4,
                scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
                int(out.dtype == torch.bfloat16), sc.partial.data_ptr(),
                sc.tickets.data_ptr(), sc.status.data_ptr(), M, K, N, G,
                plan.rows, plan.cols, plan.slices, plan.splits,
                reduce_fan(plan.splits), plan.tb,
                quant_matmul.counter.pointer(x2.device),
                kernel_build.stream_handle(x2.device))
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")


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
    if N % TILE_N or K % 8 or K % G:
        raise ValueError(f"quant_matmul: N={N} (needs % 256) K={K} (needs "
                         f"% 8) G={G}")
    if tuple(w_q.shape) != (K, N if bits == 8 else N // 2) or \
            tuple(zero.shape) != (G, N):
        raise ValueError("quant_matmul: weight shapes "
                         f"{tuple(w_q.shape)} {tuple(zero.shape)} for K={K} "
                         f"N={N} G={G}")
    for t in (x2, w_q, scale, zero):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul: operands must be contiguous "
                             "and on one device")
    if w_q.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError("quant_matmul: x and the payload must be 16-byte "
                         "aligned")

    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    sc = _scratch_for(x.device)
    plan = split_plan(K, N, G, M, bits, sc.sms, sc.blocks_per_sm)
    _launch(x2, wd, out, plan)
    return out.reshape(*x.shape[:-1], N)


quant_matmul.counter = kernel_build.LaunchCounter()
