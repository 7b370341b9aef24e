"""Weight-stream rate probe for the decode megakernel's design.

Counterpart of the JAX package's `tools/bench_stream.py`. Subcommands:

  rate     one launch of csrc/stream_probe.cu streams a weight-sized buffer
           (larger than the card's 50 MB L2) once, per payload format:
           `copy` (bytes read and summed, no dot), and the megakernel's
           product phase against x [B, K] for `bf16`, `i8_pc` (int8, one
           affine per column), `i8_g128` and `u4_g128` (group-wise affine).
           Prints payload GB/s: the megakernel's weight phases cannot beat
           the rate of their format here.
  replica  the decode megakernel itself over Qwen2-7B shapes with its
           attention and KV phases skipped (`skip_attention=True`, an
           argument this tool alone uses): the weight phases, the norms,
           SwiGLU and the grid barriers, without the cache.

The reference has two rate probes, `build` and `build_loop`, that differ
only in how they keep a per-launch dispatch cost of its chip out of the
reading; a CUDA launch costs microseconds against the ~100 us a buffer
takes, so one kernel, timed by CUDA events over a graph replay, serves both.

    python -m dashinfer_tpu_torch.tools.bench_stream rate [--batch 16]
    python -m dashinfer_tpu_torch.tools.bench_stream replica [--batch 8]

Plain versions (CPU tensors take them; the card is held against them):
`stream_copy_plain` (`torch.sum` of the 32-bit words) and
`ops.megakernel.leaf_dot` (the affine-after-dot product in PyTorch).
"""

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.ops import megakernel as mk

FORMATS = ("copy", "bf16", "i8_pc", "i8_g128", "u4_g128")
# what a timed product launch does (the reference's replica variants
# full | nodot | nogroup bisect the same way): all of it; its loads without
# the dot; its dot without the payload loads; its dot alone, with no copies
# and no block barriers; its copy pipeline alone (x records, barriers), with
# neither payload nor dot. Only "full" computes the product.
VARIANTS = ("full", "nodot", "noload", "computeonly", "pipeonly")
HID, INTER = 3584, 18944          # Qwen2-7B: x [B, HID] against gate|up
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# launches of either kernel of csrc/stream_probe.cu
counter = kernel_build.LaunchCounter()


def random_leaf(fmt: str, K: int, N: int, gen: torch.Generator, dev,
                group: int = 128) -> Dict[str, torch.Tensor]:
    """A weight leaf of one format, as the loader lays it out."""
    if fmt == "bf16":
        return {"w": (torch.randn((K, N), generator=gen, device=dev) * 0.02
                      ).to(torch.bfloat16)}
    G = 1 if fmt == "i8_pc" else K // group
    if fmt == "u4_g128":
        w_q = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8,
                            generator=gen, device=dev)
        scale = torch.rand((G, N), generator=gen, device=dev) * 0.002 + 1e-4
        return {"w_q": w_q, "scale": scale, "zero": -scale * 8.0}
    w_q = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=gen,
                        device=dev)
    scale = torch.rand((G, N), generator=gen, device=dev) * 1.2e-4 + 1e-5
    zero = (torch.rand((G, N), generator=gen, device=dev) - 0.5) * 1e-3
    return {"w_q": w_q, "scale": scale, "zero": zero}


def leaf_bytes(leaf: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in leaf.values())


def stream_copy_plain(buf: torch.Tensor) -> int:
    """Sum of the buffer's 32-bit words, modulo 2^32."""
    return int(buf.view(torch.int32).sum().item()) & 0xFFFFFFFF


class _Copy:
    def __init__(self, buf: torch.Tensor):
        if buf.dtype != torch.uint8 or not buf.is_contiguous() or \
                buf.numel() % 16 or buf.data_ptr() % 16:
            raise ValueError("stream_copy: contiguous uint8 buffer of a "
                             "multiple of 16 bytes, 16-byte aligned")
        lib = kernel_build.load("stream_probe")
        lib.di_stream_probe_grid.argtypes = [_I, _I]
        lib.di_stream_probe_grid.restype = _I
        self.fn = kernel_build.function(
            "stream_probe", "di_stream_probe_copy",
            [_P, _LL, _P, _I, _P, _P])
        self.buf = buf
        self.grid = lib.di_stream_probe_grid(_dev_index(buf.device), 0)
        if self.grid <= 0:
            raise RuntimeError("stream_copy: occupancy query failed")
        self.sums = torch.zeros(self.grid, dtype=torch.int32,
                                device=buf.device)

    def launch(self) -> None:
        dev = self.buf.device
        rc = self.fn(self.buf.data_ptr(), self.buf.numel(),
                     self.sums.data_ptr(), self.grid, counter.pointer(dev),
                     kernel_build.stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"stream_copy launch failed: CUDA error {rc}")


def stream_copy(buf: torch.Tensor) -> int:
    """Reads `buf` (uint8) once and returns the sum of its 32-bit words
    modulo 2^32. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if buf.device.type == "cpu":
        return stream_copy_plain(buf)
    c = _Copy(buf)
    c.launch()
    return int(c.sums.to(torch.int64).sum().item()) & 0xFFFFFFFF


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


class _Product:
    """One leaf's product, prepared once (x records, split, output) so that
    `launch` is the kernel alone."""

    def __init__(self, x: torch.Tensor, leaf: Dict[str, torch.Tensor],
                 variant: str = "full"):
        dev = x.device
        B, K = x.shape
        self.variant = VARIANTS.index(variant)
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or \
                B > mk.MAX_BATCH:
            raise ValueError("stream_product: x must be contiguous bf16 "
                             f"[B <= {mk.MAX_BATCH}, K]")
        sp = mk._stream_plan("probe", ("w",), [mk.loader_view(leaf)], 0)
        if sp.K != K:
            raise ValueError(f"stream_product: x has K={K}, leaf {sp.K}")
        gaps = mk.stream_gaps(sp)
        if gaps:
            raise ValueError("stream_product: " + "; ".join(gaps))
        mk._check_leaf(sp, leaf, sp.N[0], (), dev)
        lib = kernel_build.load("stream_probe")
        lib.di_stream_probe_grid.argtypes = [_I, _I]
        lib.di_stream_probe_grid.restype = _I
        self.mpad = mk.padded_rows(B)
        self.grid = lib.di_stream_probe_grid(_dev_index(dev), self.mpad)
        if self.grid <= 0:
            raise RuntimeError("stream_product: occupancy query failed")
        passes = self.mpad // (16 if self.mpad == 16 else 32)
        ksplit, cps = mk.choose_split(
            sp.Ntot // 256, K // mk.CHUNK_K,
            mk.CHUNK_K * 256 * sp.bits // 8, B, passes, self.grid)
        self.sa = np.asarray(mk.stream_args(sp, [leaf], False, ksplit, cps),
                             np.int64)
        self.rec = torch.zeros((K // mk.CHUNK_K) * self.mpad *
                               (mk.CHUNK_K * 2 + 4), dtype=torch.uint8,
                               device=dev)
        self.out = torch.empty((ksplit, B, sp.Ntot), dtype=torch.float32,
                               device=dev)
        self.B, self.dev, self.leaf = B, dev, leaf
        records = kernel_build.function(
            "stream_probe", "di_stream_probe_records",
            [_P, _P, _I, _I, _I, _P])
        rc = records(x.data_ptr(), self.rec.data_ptr(), B, K, self.mpad,
                     kernel_build.stream_handle(dev))
        if rc != 0:
            raise RuntimeError(f"stream_product records: CUDA error {rc}")
        self.fn = kernel_build.function(
            "stream_probe", "di_stream_probe_product",
            [_P, _P, _P, _I, _I, _I, _I, _P, _P])

    def launch(self) -> None:
        rc = self.fn(self.sa.ctypes.data, self.rec.data_ptr(),
                     self.out.data_ptr(), self.B, self.mpad, self.grid,
                     self.variant, counter.pointer(self.dev),
                     kernel_build.stream_handle(self.dev))
        if rc != 0:
            raise RuntimeError(f"stream_product launch failed: CUDA error "
                               f"{rc}")


def stream_product(x: torch.Tensor, leaf: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """x [B, K] bf16 . one weight leaf -> [B, N] f32, through the
    megakernel's product phase as one persistent-grid launch (the split-K
    partial sums are added up here, in a fixed order). CPU tensors take
    the plain version `ops.megakernel.leaf_dot`."""
    if x.device.type == "cpu":
        return mk.leaf_dot(x, leaf)
    p = _Product(x, mk.packed_leaf(leaf) if "w_f" not in leaf else leaf)
    p.launch()
    return p.out.sum(0)


def graph_ms(launches, iters: int = 10) -> float:
    """Mean device ms of a launch, from a CUDA graph of `iters` launches
    replayed between two CUDA events (no host time in it). `launches` is one
    callable or a list that the graph cycles through: copies of one buffer
    that together exceed the card's 50 MB L2, so that every launch streams
    from device memory."""
    if callable(launches):
        launches = [launches]
    iters = max(iters, len(launches))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches[0]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            launches[i % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _copies(leaf: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The leaf and clones of it, >= 200 MB together."""
    n = max(1, -(-200_000_000 // leaf_bytes(leaf)))
    return [leaf] + [{k: v.clone() for k, v in leaf.items()}
                     for _ in range(n - 1)]


def measure_rates(batch: int = 16, device="cuda", K: int = HID,
                  N: int = 2 * INTER, seed: int = 0,
                  formats: Tuple[str, ...] = FORMATS) -> List[Dict]:
    """Each format once against its plain version, then timed: the whole
    product, its loads alone and its dot alone. The buffer is the gate|up
    leaf of Qwen2-7B (K 3584, N 37888: 68 MB in u4, 136 MB in int8, 272 MB
    in bf16; the copy reads 256 MiB)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_rates times the card; it needs a CUDA "
                           "device")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((batch, K), generator=gen, device=dev).to(torch.bfloat16)
    rows = []

    def row(fmt, nbytes, ms, plain_ms, err, ref_max):
        rows.append(dict(format=fmt, B=batch, K=K, N=N, bytes=nbytes, ms=ms,
                         gbps=nbytes / ms / 1e6, plain_ms=plain_ms,
                         max_abs_err=err, ref_max=ref_max))

    for fmt in formats:
        if fmt == "copy":
            buf = torch.randint(0, 256, (256 * 1024 * 1024,),
                                dtype=torch.uint8, generator=gen, device=dev)
            got, ref = stream_copy(buf), stream_copy_plain(buf)
            c = _Copy(buf)
            row(fmt, buf.numel(), graph_ms(c.launch),
                graph_ms(lambda: buf.view(torch.int32).sum(), 3),
                float(got != ref), 1.0)
            del c, buf
            continue
        raw = random_leaf(fmt, K, N, gen, dev)
        ref = mk.leaf_dot(x, raw)
        plain_ms = graph_ms(lambda: mk.leaf_dot(x, raw), 3)
        leaf = mk.packed_leaf(raw)     # as the megakernel's pack holds it
        del raw
        got = stream_product(x, leaf)
        torch.cuda.synchronize()
        leaves = _copies(leaf)
        ps = [_Product(x, lf) for lf in leaves]
        row(fmt, leaf_bytes(leaf), graph_ms([p.launch for p in ps]), plain_ms,
            (got - ref).abs().max().item(), ref.abs().max().item())
        for variant in VARIANTS[1:]:
            pv = [_Product(x, lf, variant) for lf in leaves]
            rows[-1][variant + "_ms"] = graph_ms([p.launch for p in pv])
        del ps, pv, leaf, leaves
    return rows


def random_a16w4_params(cfg, seed: int, dev, group: int = 128,
                        stream: str = "u4") -> Dict:
    """Random weights at a dense model's widths, made on the card: a16w4
    group-wise u4 leaves (`stream="u4"`), or the same leaves re-expanded to
    per-channel int8 by the u4 -> i8 stream rule (`stream="i8"`). Norm
    weights are ones, q|k|v biases (`cfg.qkv_bias`) zero; a QK-norm model's
    `q_norm` / `k_norm` [L, D] are 1 + 0.25 N(0, 1), drawn after the rest,
    so that the other leaves are those of the same seed without them."""
    L, D = cfg.num_layers, cfg.head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    hid, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(kin, kout, layers=True, bias=False):
        lead = (L,) if layers else ()
        w_q = torch.randint(0, 256, lead + (kin, kout // 2),
                            dtype=torch.uint8, generator=gen, device=dev)
        scale = torch.rand(lead + (kin // group, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        d = {"w_q": w_q, "scale": scale, "zero": -scale * 8.0}
        if stream == "i8":
            d = mk.expand_u4_to_i8_tensors(d)
        if bias:
            d["b"] = torch.zeros(lead + (kout,), dtype=torch.bfloat16,
                                 device=dev)
        return d

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    bias = cfg.qkv_bias
    params = {
        "embed_tokens": {"w": (torch.randn((V, hid), generator=gen,
                                           device=dev) * 0.02
                               ).to(torch.bfloat16)},
        "norm": ones(hid),
        "lm_head": qlin(hid, V, layers=False),
        "layers": {
            "input_layernorm": ones(L, hid),
            "post_attention_layernorm": ones(L, hid),
            "q_proj": qlin(hid, H * D, bias=bias),
            "k_proj": qlin(hid, KH * D, bias=bias),
            "v_proj": qlin(hid, KH * D, bias=bias),
            "o_proj": qlin(H * D, hid),
            "gate_proj": qlin(hid, inter),
            "up_proj": qlin(hid, inter),
            "down_proj": qlin(inter, hid),
        },
    }
    if cfg.qk_norm:
        params["layers"].update(qk_norm_weights(L, D, gen, dev))
    return params


def qk_norm_weights(L: int, D: int, gen, dev) -> Dict:
    """Random QK-norm weights [L, D] bf16, 1 + 0.25 N(0, 1): not all ones,
    so that a kernel that skips or misplaces them shows."""
    return {name: (1.0 + 0.25 * torch.randn((L, D), generator=gen,
                                            device=dev)).to(torch.bfloat16)
            for name in ("q_norm", "k_norm")}


def measure_replica(batch: int = 8, device="cuda", seed: int = 0,
                    stream: str = "u4", num_layers: int = 28) -> Dict:
    """ms per launch of the decode megakernel with attention and KV
    skipped, at Qwen2-7B widths with random weights."""
    from dashinfer_tpu_torch.config import (CacheMode, ModelConfig,
                                            RuntimeConfigBuilder)
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    dev = torch.device(device)
    cfg = ModelConfig(arch="qwen2", vocab_size=152064, hidden_size=HID,
                      intermediate_size=INTER, num_layers=num_layers,
                      num_heads=28, num_kv_heads=4, head_dim=128,
                      qkv_bias=True, rope_theta=1000000.0)
    rt = (RuntimeConfigBuilder("replica").max_length(2048).max_batch(batch)
          .kv_cache_page_size(64).kv_cache_mode(CacheMode.INT8)
          .dtype("bfloat16").build())
    params = random_a16w4_params(cfg, seed, dev, stream=stream)
    plan = mk.make_plan(cfg, rt, params)
    packed = mk.pack_params(cfg, plan, params)
    cache = create_kv_cache(cfg, rt.cache, cfg.num_layers + 1,
                            torch.bfloat16, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    x0 = (torch.randn((batch, HID), generator=gen, device=dev) * 0.02
          ).to(torch.bfloat16)
    cos = torch.ones((batch, 128), dtype=torch.bfloat16, device=dev)
    sin = torch.zeros_like(cos)
    pt = torch.zeros((batch, plan.maxP), dtype=torch.int32, device=dev)
    lens = torch.zeros(batch, dtype=torch.int32, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)

    def launch():
        mk.decode_megakernel(plan, packed, x0, cos, sin, pt, lens, active,
                             cache, skip_attention=True)

    ms = graph_ms(launch, 5)
    mk.check_status(plan, dev)
    return dict(B=batch, stream=stream, L=num_layers, ms=ms,
                weight_bytes=plan.weight_bytes,
                gbps=plan.weight_bytes / ms / 1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("rate", "replica"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--stream", choices=("u4", "i8"), default="u4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stream: no CUDA device", file=sys.stderr)
        return 2
    with torch.no_grad():
        if args.command == "rate":
            for r in measure_rates(args.batch or 16):
                print(json.dumps(r))
        else:
            print(json.dumps(measure_replica(args.batch or 8,
                                             stream=args.stream)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
