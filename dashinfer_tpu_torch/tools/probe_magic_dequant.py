"""Which u4 -> bf16 dequant chain is exact and cheapest on the card.

Counterpart of the JAX package's `tools/probe_magic_dequant.py`. A packed
u4 byte holds two levels: the low nibble is column j, the high nibble
column j + HALF. Each chain turns a payload [ROWS, HALF] uint8 into the bf16
operands `lo`, `hi` [ROWS, HALF] of a dot (csrc/probes.cu):

  cvt       integer -> f32 convert, then f32 -> bf16 (the reference's `i32`
            chain: widen, AND / shift, convert);
  magic16   `(n | 0x4300)` IS the bf16 bit pattern of 128 + n (granularity 1
            at exponent 2^7), so there is no convert at all; the dot's extra
            128 * sum(x) is taken back off after it;
  magicf32  `(n | 0x4B000000)` IS the f32 bit pattern of 2^23 + n; subtract
            2^23 in f32, then convert to bf16.

(The reference's `magiclo` mixes an 8-bit AND with a bf16 multiply, a
TPU lane-width trick with no counterpart among this card's instructions.)
For each chain: the levels against the plain version, which must be EXACT,
then the time per chunk of `acc += x @ lo + x @ hi` over many chunks in one
launch, x [32, ROWS] bf16, as the reference's timed loop does.

    python -m dashinfer_tpu_torch.tools.probe_magic_dequant [cvt|magic16|magicf32|all]
"""

import ctypes
import json
import sys
from typing import Dict, List, Tuple

import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.tools.bench_stream import graph_ms

CHAINS = ("cvt", "magic16", "magicf32")
OFFSET = {"cvt": 0.0, "magic16": 128.0, "magicf32": 0.0}
ROWS, HALF, B = 512, 256, 32    # csrc/probes.cu kRows, kHalf, kB
_P, _I = ctypes.c_void_p, ctypes.c_int

# launches of either dequant kernel of csrc/probes.cu
counter = kernel_build.LaunchCounter()


def dequant_plain(chain: str, p8: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p8 [rows, half] uint8 -> (lo, hi) bf16 [rows, half]: each nibble's
    level plus the chain's offset (128 + n <= 143 is exact in bf16)."""
    off = OFFSET[chain]
    return ((p8 & 0xF).float() + off).to(torch.bfloat16), \
        ((p8 >> 4).float() + off).to(torch.bfloat16)


def dequant(chain: str, p8: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's levels (+ offset). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if p8.device.type == "cpu":
        return dequant_plain(chain, p8)
    if not p8.is_cuda or p8.dtype != torch.uint8 or p8.dim() != 2 or \
            p8.shape[0] % 2 or not p8.is_contiguous():
        raise ValueError("dequant: contiguous uint8 [even rows, half] on a "
                         "CUDA device")
    fn = kernel_build.function("probes", "di_probe_dequant_levels",
                               [_I, _P, _P, _P, _I, _I, _P, _P])
    lo = torch.empty(p8.shape, dtype=torch.bfloat16, device=p8.device)
    hi = torch.empty_like(lo)
    rc = fn(CHAINS.index(chain), p8.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            p8.shape[0], p8.shape[1], counter.pointer(p8.device),
            kernel_build.stream_handle(p8.device))
    if rc != 0:
        raise RuntimeError(f"dequant launch failed: CUDA error {rc}")
    return lo, hi


def dequant_dot_plain(x: torch.Tensor, payload: torch.Tensor,
                      rounds: int = 1) -> torch.Tensor:
    """x [B, ROWS] bf16, payload [S, ROWS, HALF] uint8 -> f32 [B, HALF]:
    the sum over `rounds` passes over the S chunks of x @ lo + x @ hi."""
    lv = (payload & 0xF).float() + (payload >> 4).float()     # [S, ROWS, HALF]
    return rounds * (x.float() @ lv.sum(0))


class _Dot:
    """One chain's timed loop, prepared once so that `launch` is the kernel
    alone."""

    def __init__(self, chain: str, x: torch.Tensor, payload: torch.Tensor,
                 rounds: int):
        dev = x.device
        if x.dtype != torch.bfloat16 or tuple(x.shape) != (B, ROWS) or \
                payload.dtype != torch.uint8 or payload.dim() != 3 or \
                tuple(payload.shape[1:]) != (ROWS, HALF) or \
                payload.device != dev or not x.is_contiguous() or \
                not payload.is_contiguous():
            raise ValueError(f"dequant_dot: x bf16 [{B}, {ROWS}] and payload "
                             f"uint8 [S, {ROWS}, {HALF}], contiguous, on one "
                             "CUDA device")
        self.fn = kernel_build.function(
            "probes", "di_probe_dequant_dot",
            [_I, _P, _P, _P, _I, _I, _I, _P, _P])
        self.chain, self.x, self.payload = CHAINS.index(chain), x, payload
        self.total = rounds * payload.shape[0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.grid = min(self.total, 2 * sms)
        self.out = torch.empty((self.grid, B, HALF), dtype=torch.float32,
                               device=dev)

    def launch(self) -> None:
        dev = self.x.device
        rc = self.fn(self.chain, self.x.data_ptr(), self.payload.data_ptr(),
                     self.out.data_ptr(), self.payload.shape[0], self.total,
                     self.grid, counter.pointer(dev),
                     kernel_build.stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"dequant_dot launch failed: CUDA error {rc}")


def dequant_dot(chain: str, x: torch.Tensor, payload: torch.Tensor,
                rounds: int = 1) -> torch.Tensor:
    """`dequant_dot_plain` through the chain's kernel (the blocks' partial
    sums are added here). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return dequant_dot_plain(x, payload, rounds)
    d = _Dot(chain, x, payload, rounds)
    d.launch()
    return d.out.sum(0)


def measure(device="cuda", chains=CHAINS, seed: int = 0) -> List[Dict]:
    """Per chain: exactness of the levels, the dot against the plain
    version, and us per chunk over a payload larger than the L2 cache."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pay = torch.randint(0, 256, (ROWS, HALF), dtype=torch.uint8,
                        generator=gen, device=dev)
    S, rounds = (64 << 20) // (ROWS * HALF), 4       # 64 MiB of chunks
    payload = torch.randint(0, 256, (S, ROWS, HALF), dtype=torch.uint8,
                            generator=gen, device=dev)
    x = torch.randn((B, ROWS), generator=gen, device=dev).to(torch.bfloat16)
    ref = dequant_dot_plain(x, payload, rounds)
    plain_ms = graph_ms(lambda: dequant_dot_plain(x, payload, rounds), 2)
    rows = []
    for chain in chains:
        lo, hi = dequant(chain, pay)
        want_lo, want_hi = dequant_plain(chain, pay)
        exact = bool(torch.equal(lo, want_lo) and torch.equal(hi, want_hi))
        d = _Dot(chain, x, payload, rounds)
        d.launch()
        err = (d.out.sum(0) - ref).abs().max().item()
        ms = graph_ms(d.launch, 3)
        rows.append(dict(
            chain=chain, exact=exact, max_abs_err=err,
            ref_max=ref.abs().max().item(), ms=ms, plain_ms=plain_ms,
            chunks=d.total, us_per_chunk=1e3 * ms / d.total,
            bytes=d.total * ROWS * HALF + x.numel() * 2 + d.out.numel() * 4,
            operations=2.0 * B * ROWS * 2 * HALF * d.total,
            gbps=d.total * ROWS * HALF / (ms * 1e-3) / 1e9))
    return rows


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["all"]
    chains = CHAINS if which[0] == "all" else (which[0],)
    if not torch.cuda.is_available():
        print("probe_magic_dequant: no CUDA device", file=sys.stderr)
        return 2
    with torch.no_grad():
        for r in measure(chains=chains):
            print(f"{r['chain']:9s} exact={r['exact']} dot err "
                  f"{r['max_abs_err']:.2e} (ref max {r['ref_max']:.2e}) "
                  f"{r['us_per_chunk']:.3f} us/chunk ({ROWS}x{HALF} B) -> "
                  f"payload {r['gbps']:.0f} GB/s", flush=True)
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
