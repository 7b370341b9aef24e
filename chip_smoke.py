#!/usr/bin/env python3
"""Drive the PyTorch port (dashinfer_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--details out/chip_smoke.json] [--only a,b,...]

Phases (any failure exits non-zero; `--only` runs a subset while working
on one of them, and then prints no final result line):
  build       device name, `nvidia-smi` name + power limit, and the build of
              every CUDA kernel (one nvcc per source, all started together);
  quant_matmul, paged_attention, grouped_quant_matmul, stream_probe, probes,
  megakernel, prefill_megakernel
              each kernel's wrapper on the card at the shapes the serving
              path gives it, held against its plain PyTorch version on the
              same inputs, and timed beside the plain version and, where one
              PyTorch call computes the same function, that call.
              quant_matmul also with per-channel u4 and int8 leaves at every
              projection shape, M = 2, 9, 16, 17, f32 x and output (q|o at
              8 and 32, gate|up u4 and int8 at 32), a (1, 2)
              mesh's q / k shards per-channel and at group 128, int8 group
              128 at M = 1 and 32; one kernel launch a product under
              `torch.profiler`; two replays of one graph bit-equal. Paged
              attention also at every G 1..8, D 64 / 256, every pool kind,
              NaN garbage past lens and a one-chunk batch, and on a
              long-context state at B = 8 and 32 beside SDPA. The grouped
              GEMM: Qwen1.5-MoE's expert shapes at the bucket-32 .. 1024
              prefills, int8, without `tile_rows` and on a rank's share
              (and the ragged route against it at a decode batch). The
              megakernel: one decode step at Qwen2-7B width for INT8, UINT4
              and DEFAULT KV and for the u4 and the per-channel i8 weight
              stream, logits and pool writes against the plain version;
              then ms per step at B = 8 and 32 beside the byte bound and the
              per-op forward's graph replay on the same state. The prefill
              megakernel: one prefill of bucket 128 (n = 100) for the same
              KV modes and streams (and the bf16 stream at a depth of two
              layers) and of buckets 256, 512 and 1024 (a served prompt
              length and the full bucket each),
              logits and the pool against the plain version; then ms per
              launch for buckets 128 .. 1024 beside the bound and the per-op
              `prefill_forward`. The probes: the two design probes of
              csrc/probes.cu through their tools;
  serve       the slices end to end: Qwen2-7B width (28 layers, random a16w4
              group-128 weights made on the card from a seed), INT8 KV,
              concurrent greedy and seeded top-k requests through `Engine`
              after one warm-up request: with every flag at its default (the
              decode megakernel, and the prefill megakernel for buckets
              128 .. 1024), through the per-op path, and with
              `weight_residency="pack_only"` (the pack alone on the card);
              each kernel's launch count is zeroed just before the timed
              requests and read just after;
  decode_logits
              one per-op decode step's logits through the kernels against
              the same step through their plain versions, and its profile;
  tp_segments the tensor-parallel segment kernels (csrc/tp_segments.cu) of
              every rank of a (1, n) mesh whose ranks share the card, at
              Qwen2-7B width, B = 8: n = 2 with INT8 and UINT4 KV and n = 4
              with INT8, each segment against its plain version, the whole
              TP decode forward (CUDA-graph replay) against `tp_decode_ref`
              and against the single-device decode megakernel on the same
              weights and state; then (n = 2, INT8) ms per segment launch
              beside its bound and plain version, and ms per TP step beside
              the single-device megakernel's;
  tp_prefill  the tensor-parallel prefill segment kernels
              (csrc/tp_prefill_segments.cu) of every rank of a (1, n) mesh
              whose ranks share the card, at Qwen2-7B width and depth:
              n = 2 with INT8 KV at buckets 128 / 256 / 512 / 1024 (a
              served prompt length and full), with UINT4 at 128 and 1024,
              n = 4 with INT8 at 128 and 1024; each segment (layers 0 and
              27) against its plain version, the whole TP prefill against
              `tp_prefill_ref` and against the single-device prefill
              megakernel on the same weights and prompt; that the runtime's
              TP prefill install takes buckets 128 .. 1024 at n = 2 and 4;
              then (n = 2, INT8, full buckets) ms per segment launch beside
              its bound and plain version, and the whole TP prefill by graph
              replay and eagerly beside the single-device prefill
              megakernel and the per-op TP prefill;
  serve_tp    Qwen2-7B served on a (1, 2) mesh with `serve`'s traffic, with
              every flag at its default (decode through the segments, the
              prefills of buckets 128 .. 1024 through the prefill segments,
              the bucket-32 prompt per-op TP), with DI_PREFILL_MEGAKERNEL=0
              (every prefill per-op TP) and per-op; launch counts checked,
              greedy tokens held to the single-device serving's, TTFT and
              ms/step printed for the first two. The ranks take distinct
              cards (NCCL) when the machine has two, else share this one
              (a sum on the card).
Then Qwen2-7B's weights go, and the MoE slice runs at Qwen1.5-MoE-A2.7B width
(24 layers, 60 experts top-4 + a shared expert, random a16w4 weights made on
the card): `megakernel` and `prefill_megakernel` hold the two kernels' MoE
branches against their plain versions (KV modes, B = 8 / 32, every bucket
128 .. 1024 the serving launches; a router near-tie that routes a row
differently is counted and capped) and time them beside the routed bounds;
`serve` serves the MoE model with every flag at its default and per-op
(and, for `serve_tp_moe`, with DI_PREFILL_MEGAKERNEL=0).
The MoE decode check also runs the plain version routed as the kernel
routed (`kernel_routing`) and holds every active row to it, rows the two
route differently included. Then, on a (1, n) mesh whose ranks share the
card:
  tp_moe      the TP MoE segment (csrc/tp_segments.cu `kMoeSeg`) of every
              rank at Qwen1.5-MoE width: n = 2 with INT8 and UINT4 KV at
              B = 8 and INT8 at B = 32, n = 4 with INT8 at B = 8; each rank's
              segment at layers 0 and 23 against its plain version routed
              as the kernel routed (and unforced, with the router flip caps
              and the planted fault), the whole TP forward (CUDA-graph
              replay) against `tp_decode_ref` routed as the kernel and
              unforced and against the single-device MoE megakernel; then
              (n = 2, INT8, B = 8) ms per segment launch beside its routed
              byte bound and plain version, and ms per TP step beside the
              single-device MoE megakernel's;
  serve_tp_moe
              the MoE model served on a (1, 2) mesh with `serve`'s traffic,
              with every flag at its default (decode through the attn and
              moe segments, every prefill per-op TP) and per-op; launch
              counts checked (no TP prefill segment), the greedy requests'
              first 8 tokens held to the single-device serving's on the
              same path, TTFT and ms/step printed.
It prints a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. It needs the repository around it (the
`dashinfer_tpu_torch` package) and a CUDA card; without either it exits
non-zero before printing any result. It imports no JAX.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the bound
# of a kernel is the larger of bytes / bandwidth and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# Qwen2-7B (bench.py's shape): vocab 152064, hidden 3584, inter 18944,
# 28 layers, 28 heads, 4 KV heads, head_dim 128, qkv bias, rope 1e6
QWEN2_7B = dict(arch="qwen2", vocab_size=152064, hidden_size=3584,
                intermediate_size=18944, num_layers=28, num_heads=28,
                num_kv_heads=4, head_dim=128, qkv_bias=True,
                rope_theta=1000000.0)
# Qwen1.5-MoE-A2.7B (bench.py's MoE shape): vocab 151936, hidden 2048, 24
# layers, 16 heads on 16 KV heads (one query head a KV head), head_dim 128,
# qkv bias; 60 experts, top-4, expert width 1408, a shared expert of 5632
# with a sigmoid gate, norm_topk_prob False
QWEN15_MOE = dict(arch="qwen2_moe", vocab_size=151936, hidden_size=2048,
                  intermediate_size=5632, num_layers=24, num_heads=16,
                  num_kv_heads=16, head_dim=128, qkv_bias=True,
                  rope_theta=1000000.0)
QWEN15_MOE_EXPERTS = dict(num_experts=60, num_experts_per_tok=4,
                          moe_intermediate_size=1408,
                          shared_expert_intermediate_size=5632,
                          norm_topk_prob=False)
GROUP = 128
DECODE_BATCH = 8          # max_batch of the served model and of the timings
PAGE = 64
SEED = 0                  # of every random weight, cache and input

# (name, K, N, launches per decode step)
PROJECTIONS = [("q_proj+o_proj", 3584, 3584, 2 * 28),
               ("k_proj+v_proj", 3584, 512, 2 * 28),
               ("gate_proj+up_proj", 3584, 18944, 2 * 28),
               ("down_proj", 18944, 3584, 28),
               ("lm_head", 3584, 152064, 1)]

# Tolerances. quant_matmul: kernel and plain version compute the same bf16
# products exactly in f32 and differ only in the order of the f32 sums:
# |d| <= 1e-3 * max|ref|. Each kernel is checked in the dtypes the serving
# path gives it (bf16 x; bf16 out for the projections, f32 for lm_head), and
# a bf16 output may land one rounding step (<= 2^-7 |ref|) the other side
# of a small f32 difference, so bf16 outputs get that step on top,
# elementwise. paged_attention: the same, online against one-pass softmax in
# f32, with bf16 q and output as served. The decode-step logits (B=8) pass
# through 28 layers whose bf16 activations may round differently after an
# f32 order change; the readings were ~1e-3 * max|ref| at B=4, so they are
# held to max|d| <= 1e-2 * max|ref|.
# The decode megakernel against its plain version: logits of the active
# rows as above (1e-2 * max|ref|) with equal argmax, where a row whose two
# best logits the plain version holds closer than twice the measured
# difference counts as a tie; the written token's payload at most one
# quantization level apart (for an unquantized pool one bf16 step on top of
# the tolerance the qparams get) and its qparams within 1e-3 of the token's range in layer 0, where both sides see
# the same input (readings ~1e-6). Deeper layers quantize activations that
# already differ between the two sides: a slot that attends hundreds of
# random cached tokens has an attention output ~1/sqrt(n) of its terms,
# and under UINT4 the affine-after-dot score cancels two large f32 terms,
# so a different summation order moves that slot's small early-layer
# activations by up to ~2e-2 of their range (INT8: 3e-4) while the logits
# stay within 5e-4 of max|ref|; those layers are held to 5e-2. Every other
# pool byte is unchanged.
KERNEL_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
LOGITS_RTOL = 1e-2
QPARAM_RTOL = 1e-3
DEEP_QPARAM_RTOL = 5e-2
# The prefill megakernel against its plain version run with the kernel's
# bf16 score operands: logits as above (1e-2 * max|ref|), the written rows
# and the rest of the pool as for the decode megakernel. The TPU kernel
# feeds its score product f32 q and k; against the plain version with f32
# scores the logits are held to 3e-2 * max|ref| (q and k rounded to bf16
# move a score by ~2^-9 of |q||k| in each of 28 layers). The pool: every
# element outside rows < n of the owned pages unchanged; rows of layer 0,
# where both sides quantize the same input, within one level and their
# qparams within 1e-3 of the token's range; a row of a deeper layer, in
# dequantized values, within one and a half levels plus 1e-2 of the (token,
# head)'s range (readings <= 7e-3 of the range with INT8 at n = 1000). A
# random model has the odd token whose residual nearly cancels in an early
# layer, so that its RMSNorm amplifies the last bits of the layer before: on
# one such token of 1000 the two PLAIN versions, which differ only in
# rounding q and k to bf16, differ by 11% of the range in layer 2 (and by
# < 1% in every other row and layer). A row beyond the tolerance therefore
# passes only where the two plain versions differ by at least a quarter as
# much on that same row, and only for at most 16 (row, head) pairs of a pool
# (of 112,000 at n = 1000; the readings are 0 to 8 for K and V together);
# their count and their largest difference are printed. Such a row has no
# bound of its own: on one such token at n = 1000 the plain versions differ
# by 1.1 of the range, and the kernel from them by 1.3.
F32_SCORES_RTOL = 3e-2
PREFILL_POOL_RTOL = 1e-2
ILL_ROWS_MAX = 16
# MoE: kernel and plain version route with the same bf16 router, but their
# inputs to it differ by the roundings above (an x_norm element one bf16
# step apart moves a router logit by ~2e-4 here), which can flip a near-tie
# top-k choice in some layer; from there on that row's activations
# legitimately differ. The checks compare every layer's routing of the
# two and count the rows (decode) or tokens (prefill) with a flip; a flip
# passes only where the plain version's own logits hold the two candidates
# (its k-th and k+1-th) within TIE_LOGIT at the first layer that flipped
# (router logits spread ~2.3 here), for at most MAX_FLIPPED_ROWS rows, or
# MAX_FLIPPED_SHARE of a prompt's tokens (read: 1 of 90, 5 of 200, 18 of
# 450, 36 of 1000; gaps 3e-5 .. 5e-3, first layers 0-5), or
# MAX_FLIPPED_ROW_SHARE of a decode batch's active rows, each routed in 24
# layers (read: 0-2 of 7 at B = 8, 3 of 31 at B = 32; gaps 1e-5 .. 3e-2).
# A flipped row is exempt from the logits check and from the pool check in
# every layer: such a row can drift before its first flip (B = 8 int8 read a
# row whose K qparams differ 1e-3 of their range at layer 1, growing ~1.9x a
# layer to 0.14 at layer 9, where it flipped; with the uint4 pool the same
# row does not flip and is held within the tolerances), so the flip is
# where the drift shows, not where it starts. Every other row is held to the
# tolerances above. A planted router fault shows that the caps
# lie between a sound kernel and a faulty one: the plain version's router
# logits with PLANTED_ROUTER_ERR of noise added (under 1% of their spread)
# must route enough rows differently from the plain version to fail them.
MAX_FLIPPED_ROWS = 2
MAX_FLIPPED_SHARE = 0.05
MAX_FLIPPED_ROW_SHARE = 0.1
TIE_LOGIT = 5e-2
PLANTED_ROUTER_ERR = 2e-2
# The decode megakernel's MoE pool: a deeper layer's written row is held in
# dequantized values, within one and a half of its levels plus
# DEEP_QPARAM_RTOL (the bound the dense check puts on deeper layers'
# qparams) of the largest range among that layer's written rows (of that KV
# head). Deeper layers quantize activations that already differ between the
# two sides, and a MoE row's differences pass its routed experts' gates and
# the long-context rows' small attention outputs (~1/sqrt(n)) on: a deep
# row's scale moves by up to ~1e-2 (UINT4: 6.7e-3 read), which shifts the
# far end of an INT8 row's levels by ~3 (B = 32), and one V row of the
# B = 32 state (contexts to 1,500 tokens) read 2.9e-2 of its own range and
# 2.1e-2 of its layer's while the logits held 5e-4 of their largest.
MOE_DEEP_RTOL = DEEP_QPARAM_RTOL
# The MoE decode branch against its plain version routed as the kernel
# routed (forced_routing_check): a (row, layer) whose K or V differs by more
# than CONDITIONED_RTOL of the row's range is held to the bounds unless its
# residual entering the layer is below ILL_NORM_SHARE of the batch's median.
CONDITIONED_RTOL = 2.5e-2
ILL_NORM_SHARE = 1.0 / 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bounds(nbytes: float, ops: float) -> dict:
    """The two floors of a kernel's time on the card, in ms."""
    return dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / BF16_OPS_PER_S)


def aggregate(rows, weights) -> dict:
    """Sum a kernel's per-shape numbers over its launches in one decode
    step; bound_ms sums each launch's larger floor."""
    agg = {k: sum(r[k] * w for r, w in zip(rows, weights))
           for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    agg["bound_ms"] = sum(max(r["bytes_ms"], r["ops_ms"]) * w
                          for r, w in zip(rows, weights))
    agg["bound_by"] = ("bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms")
                       else "operations")
    return agg


def time_ms(fn, args_list, iters: int = 10) -> float:
    """Mean device ms per call. The calls are captured in one CUDA graph and
    the replay is timed with CUDA events, so the host's launch overhead is
    not counted. The calls cycle through args_list: for the weight products,
    copies of the operands together larger than the 50 MB L2, so each call
    reads its weights from HBM as the serving path does."""
    import torch
    n = max(iters, len(args_list))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def copies_for(nbytes: int) -> int:
    return max(1, min(32, math.ceil(160e6 / nbytes)))


def held_to_plain(got, ref, what: str) -> float:
    """Checks a kernel's output against its plain version's (the
    tolerances above) and returns max|d|."""
    import torch
    d = (got.float() - ref.float()).abs()
    tol = KERNEL_RTOL * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * ref.float().abs()
    err = d.max().item()
    over = (d > tol).sum().item()
    check(math.isfinite(err) and over == 0,
          f"{what}: {over} elements over tolerance, max|d| {err:.3e}, "
          f"max|ref| {ref.float().abs().max().item():.3e}")
    return err


# -- phase 2: kernels against their plain versions --------------------------

def random_qleaf(K, N, gen, dev, bits=4, group=GROUP):
    """A random quantized leaf; `group` K rows a quant group (K: one group,
    per-channel)."""
    import torch
    G = K // group
    if bits == 4:
        w_q = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8,
                            generator=gen, device=dev)
    else:
        w_q = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                            generator=gen, device=dev)
    scale = torch.rand((G, N), generator=gen, device=dev) * 0.002 + 1e-4
    zero = -scale * 8.0 if bits == 4 else torch.zeros_like(scale)
    return {"w_q": w_q, "scale": scale, "zero": zero}


# quant_matmul cases beyond the projections at M = 1, 8, 32 (u4, group 128):
# (name, K, N, M, bits, group, x and out f32). Per-channel u4 and int8 leaves
# at every projection shape; the n8-tile boundaries on k_proj and gate_proj;
# f32 x with f32 output (q|o on 16-row blocks, gate|up on one block of 32
# rows, u4 and int8); a rank's q|o and k|v shard of a (1, 2) mesh
# (N = 1792, 256) at group 128 and per-channel; int8 group 128.
QMM_CASES = (
    [(f"{name} (per-channel)", K, N, M, bits, K, False)
     for bits in (4, 8) for name, K, N, _ in PROJECTIONS for M in (1, 8, 32)]
    + [(name, 3584, N, M, 4, GROUP, False)
       for name, N in (("k_proj+v_proj", 512), ("gate_proj+up_proj", 18944))
       for M in (2, 9, 16, 17)]
    + [("q_proj+o_proj (f32 x, f32 out)", 3584, 3584, M, 4, GROUP, True)
       for M in (8, 32)]
    + [("gate_proj+up_proj (f32 x, f32 out)", 3584, 18944, 32, bits, GROUP,
        True) for bits in (4, 8)]
    + [(f"{name} (1, 2) shard{tag}", 3584, N, M, 4, group, False)
       for name, N in (("q_proj", 1792), ("k_proj", 256))
       for tag, group in (("", GROUP), (" (per-channel)", 3584))
       for M in (8, 32)]
    + [("q_proj (int8)", 3584, 3584, M, 8, GROUP, False) for M in (1, 32)])


def quant_matmul_case(name, K, N, M, bits, group, f32, n_step, gen, dev):
    """One quant_matmul shape: the kernel held to its plain version, then
    timed beside it and beside `torch.matmul` on the dequantized bf16
    weight (cold: copies of the weights larger than L2)."""
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.ops.linear import dequantize_weight
    wd = random_qleaf(K, N, gen, dev, bits, group)
    x = torch.randn((M, K), generator=gen, device=dev)
    if not f32:
        x = x.to(torch.bfloat16)
    out_dtype = (torch.float32 if f32 or name.startswith("lm_head")
                 else torch.bfloat16)
    got = qm.quant_matmul(x, wd, out_dtype)
    ref = qm.quant_matmul_plain(x, wd, out_dtype)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, f"quant_matmul {name} M={M} bits={bits}")
    scale_ref = ref.float().abs().max().item()
    w_bytes = sum(t.numel() * t.element_size() for t in wd.values())
    copies = [(x, random_qleaf(K, N, gen, dev, bits, group) if i else wd,
               out_dtype) for i in range(copies_for(w_bytes))]
    ms = time_ms(qm.quant_matmul, copies)
    plain_ms = time_ms(qm.quant_matmul_plain, copies[:1], iters=3)
    del copies
    w_lib = dequantize_weight(wd, torch.bfloat16)
    xl = x.to(torch.bfloat16)
    lib_copies = [(xl, w_lib if i == 0 else w_lib.clone())
                  for i in range(copies_for(w_lib.numel() * 2))]
    library_ms = time_ms(torch.matmul, lib_copies)
    del w_lib, lib_copies
    nbytes = (x.numel() * x.element_size() + w_bytes + M * N *
              (4 if out_dtype == torch.float32 else 2))
    row = dict(shape=name, K=K, N=N, M=M, bits=bits, G=K // group,
               max_abs_err=err, ref_max=scale_ref, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, launches_per_step=n_step,
               **bounds(nbytes, 2.0 * M * K * N))
    print(f"quant_matmul {name:38s} M={M:2d} bits={bits} G={K // group:3d} "
          f"err={err:.2e} ms={ms:.4f} bound={row['bytes_ms']:.4f} "
          f"plain={plain_ms:.3f} lib={library_ms:.4f}", flush=True)
    return row


def check_quant_matmul(gen, dev, details):
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    per_shape = []
    cases = ([(name, K, N, M, 4, GROUP, False, n)
              for name, K, N, n in PROJECTIONS for M in (1, 8, 32)]
             + [("q_proj (int8)", 3584, 3584, 8, 8, GROUP, False, 0)]
             + [c + (0,) for c in QMM_CASES])
    for name, K, N, M, bits, group, f32, n_step in cases:
        per_shape.append(quant_matmul_case(name, K, N, M, bits, group, f32,
                                           n_step, gen, dev))
    qm.check_status(dev)
    # one kernel launch a product, split over K (k_proj at group 128 and
    # per-channel) or not (gate_proj), at one n8 tile and at four
    prods = [(random_qleaf(K, N, gen, dev, 4, group),
              torch.randn((M, K), generator=gen, device=dev).to(
                  torch.bfloat16))
             for K, N, group, M in ((3584, 512, GROUP, 8),
                                    (3584, 512, 3584, 8),
                                    (3584, 18944, GROUP, 8),
                                    (3584, 512, 3584, 32))]
    for wd, x in prods:
        qm.quant_matmul(x, wd)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for wd, x in prods:
            qm.quant_matmul(x, wd)
        torch.cuda.synchronize()
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if "CUDA" in str(getattr(ev, "device_type", None))}
    n_kernels = sum(kernels.values())
    print(f"quant_matmul under the profiler: {len(prods)} products, "
          f"{n_kernels} CUDA kernels ({kernels})", flush=True)
    check(n_kernels == len(prods) and all("qmm_kernel" in k for k in kernels),
          f"quant_matmul: {len(prods)} products ran {n_kernels} CUDA "
          f"kernels: {kernels}")
    # the split products' tickets start at zero on every replay: two
    # replays of one graph write the same bits (the output cleared between)
    wd, x = prods[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.quant_matmul(x, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.quant_matmul(x, wd)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(first, out), "quant_matmul: two replays of one graph "
          "differ")
    check(torch.equal(first, qm.quant_matmul(x, wd)),
          "quant_matmul: a graph replay and an eager launch differ")
    qm.check_status(dev)
    del graph, prods
    print("quant_matmul: two graph replays and an eager launch bit-equal",
          flush=True)
    details["quant_matmul"] = per_shape
    step = [r for r in per_shape if r["M"] == DECODE_BATCH and
            r["bits"] == 4 and r["launches_per_step"]]
    return dict(max_abs_err=max(r["max_abs_err"] for r in per_shape),
                **aggregate(step, [r["launches_per_step"] for r in step]))


# prompt rows: the per-op MoE decode batch, then the buckets the per-op MoE
# prefills reach (x 4 routed rows each)
GQM_TS = (DECODE_BATCH, 32, 128, 256, 1024)


def gqm_case(what, leaf, K, N, topk_i, E, gen, dev, rows_hint=True,
             rank_experts=None):
    """One call of the grouped GEMM at a routing `topk_i` [T, k] of E
    experts, held against its plain version and timed beside its bound, the
    plain version and one `torch._grouped_mm` on bf16 stacks dequantized
    beforehand. `rank_experts`: the leaf holds experts [0, n) of the E (a
    rank's share on a mesh, as ops/moe.py lays it out: the other experts'
    rows sort last into tiles of 0 rows). Returns the case's row."""
    import torch
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import moe as moe_ops
    T, k = topk_i.shape
    TM = gqm.default_tm()
    if rank_experts is None:
        order, stok, pos, te = gqm.build_group_layout(topk_i, E, TM)
        trows = gqm.tile_row_counts(pos, te.shape[0], TM)
        mine = torch.ones(T * k, dtype=torch.bool, device=dev)
        ids = topk_i.reshape(-1)
        n_e = E
    else:
        n_e = rank_experts
        ids = torch.where(topk_i < n_e, topk_i, n_e)
        order, stok, pos, te = gqm.build_group_layout(ids, n_e + 1, TM)
        trows = gqm.tile_row_counts(pos, te.shape[0], TM)
        trows = torch.where(te == n_e, 0, trows)
        te = te.clamp(max=n_e - 1)
        ids = ids.reshape(-1)
        mine = ids[order] < n_e
    n_tiles = te.shape[0]
    xs = torch.zeros((n_tiles * TM, K), dtype=torch.bfloat16, device=dev)
    rows_x = torch.randn((T * k, K), generator=gen,
                         device=dev).to(torch.bfloat16)
    xs[pos[mine]] = rows_x[mine]
    hint = trows if rows_hint else None
    got = gqm.grouped_quant_matmul(xs, te, leaf, tile_rows=hint)
    ref = gqm.grouped_quant_matmul_plain(xs, te, leaf)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, what)
    shape = gqm.block_shape(xs.shape[0], TM, leaf["scale"].shape[0])
    ms = time_ms(lambda: gqm.grouped_quant_matmul(xs, te, leaf,
                                                  tile_rows=hint),
                 [()], iters=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gqm.grouped_quant_matmul_plain(xs, te, leaf)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    # yardstick: one grouped product of the library on the sorted rows of
    # the leaf's experts and bf16 stacks dequantized beforehand (timed only)
    Np = leaf["scale"].shape[-1]
    w_bf = moe_ops._expert_stack(leaf, torch.bfloat16, N)
    x_sorted = xs[pos[mine].sort().values].contiguous()
    sizes = torch.bincount(ids[ids < n_e], minlength=n_e)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    library_ms, library_note = None, ""
    if not hasattr(torch, "_grouped_mm"):
        library_note = "torch._grouped_mm missing in this torch"
    else:
        for w_lib in (w_bf, w_bf.transpose(-2, -1).contiguous()
                      .transpose(-2, -1)):
            try:
                torch._grouped_mm(x_sorted, w_lib, offs=offs)
                torch.cuda.synchronize()
                library_ms = time_ms(
                    lambda: torch._grouped_mm(x_sorted, w_lib, offs=offs),
                    [()], iters=20)
                library_note = ""
                break
            except Exception as e:       # timed only: no fallback
                library_note = f"torch._grouped_mm: {e}"[:160]
    del w_bf
    used = int((sizes > 0).sum())
    n_rows = int(sizes.sum())
    bits = 8 if leaf["w_q"].dtype == torch.int8 else 4
    w_bytes = used * (K * N * bits // 8 + 2 * 4 * (K // GROUP) * N)
    nbytes = n_rows * K * 2 + w_bytes + n_rows * N * 2
    row = dict(shape=what, T=T, rows=n_rows, K=K, N=N, Np=Np, bits=bits,
               block_shape=shape,
               experts_used=used, tiles=n_tiles,
               tiles_with_rows=int((trows > 0).sum()),
               rows_hint=rows_hint, rank_experts=rank_experts,
               max_abs_err=err, ref_max=ref.float().abs().max().item(),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               library_note=library_note,
               **bounds(nbytes, 2.0 * n_rows * K * N))
    print(f"{what}: err={err:.2e} ms={ms:.4f} bound="
          f"{max(row['bytes_ms'], row['ops_ms']):.4f} plain="
          f"{plain_ms:.2f} lib="
          + (f"{library_ms:.4f}" if library_ms is not None else
             f"- ({library_note})")
          + f"; {row['tiles_with_rows']} of {n_tiles} tiles hold rows, "
          f"{used} experts, block shape {shape}", flush=True)
    return row


def check_grouped_quant_matmul(dev, details):
    """csrc/grouped_quant_matmul.cu at Qwen1.5-MoE width (60 experts, top-4;
    gate / up 2048 -> 1408, padded to 1536 columns by the install, down
    1408 -> 2048) at the shapes the per-op MoE decode (B = 8: 32 routed
    rows) and the per-op MoE prefills of buckets 32, 128, 256 and 1024 give
    it (128 .. 4,096 routed rows), u4; the int8 leaf at T = 8, 32 and 256,
    so that each of the kernel's 6 instantiations (bits x block shape) is
    held; once each a call without the `tile_rows` hint and a rank's share
    of a (1, 2) mesh (30 experts); each against its plain version, timed
    beside its bound, the plain version and `torch._grouped_mm` on
    pre-dequantized bf16 stacks where the installed torch has it. Then one
    MoE layer's
    experts at a decode batch (T = 8) through the grouped route and through
    the ragged route (`DI_MOE_GROUPED=0`): the measured reason for taking
    the grouped kernel at every T on this card."""
    import torch
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import moe as moe_ops
    cfg = moe_config(layers=1)
    moe = cfg.moe
    E, k, hid, Im = (moe.num_experts, moe.num_experts_per_tok,
                     cfg.hidden_size, moe.moe_intermediate_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)

    def qlin(kin, kout, bits=4):
        scale = torch.rand((1, E, kin // GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        if bits == 4:
            w_q = torch.randint(0, 256, (1, E, kin, kout // 2),
                                dtype=torch.uint8, generator=gen, device=dev)
            zero = -scale * 8.0
        else:
            w_q = torch.randint(-128, 128, (1, E, kin, kout),
                                dtype=torch.int8, generator=gen, device=dev)
            zero = torch.zeros_like(scale)
        return {"w_q": w_q, "scale": scale, "zero": zero}

    lp = {"router": {"w": torch.randn((1, hid, E), generator=gen,
                                      device=dev) * 0.05},
          "experts": {"gate_proj": qlin(hid, Im), "up_proj": qlin(hid, Im),
                      "down_proj": qlin(Im, hid)}}
    i8 = {"layers": {"experts": {"gate_proj": qlin(hid, Im, 8)}}}
    gqm.prepare_grouped_experts({"layers": lp}, cfg)
    gqm.prepare_grouped_experts(i8, cfg)

    def layer0(tree):
        return {k_: layer0(v) if isinstance(v, dict) else v[0]
                for k_, v in tree.items()}

    lp = layer0(lp)
    gate, down = lp["experts"]["gate_proj"], lp["experts"]["down_proj"]
    gate8 = layer0(i8)["layers"]["experts"]["gate_proj"]
    rank = E // 2
    share = {key: t[:rank].contiguous() for key, t in gate.items()}
    rows, max_err = [], 0.0
    for T in GQM_TS:
        topk_i = torch.rand((T, E), generator=gen, device=dev).topk(k).indices
        cases = [("gate", gate, hid, Im, {}), ("down", down, Im, hid, {})]
        if T in (DECODE_BATCH, 32, 256):
            cases.append(("gate (int8)", gate8, hid, Im, {}))
        if T == 32:
            cases += [("gate (no tile_rows)", gate, hid, Im,
                       dict(rows_hint=False)),
                      (f"gate (a rank's {rank} experts)", share, hid, Im,
                       dict(rank_experts=rank))]
        for name, leaf, K, N, kw in cases:
            row = gqm_case(f"grouped_quant_matmul {name} T={T} ({T * k} "
                           "rows)", leaf, K, N, topk_i, E, gen, dev, **kw)
            row["shape"] = name
            rows.append(row)
            max_err = max(max_err, row["max_abs_err"])
            torch.cuda.empty_cache()
            if T == DECODE_BATCH:    # the decode batch's narrow-item shape
                check(row["block_shape"] == 0, f"grouped_quant_matmul {name} "
                      f"T={T}: block shape {row['block_shape']}, not 0")
    held = {(r["bits"], r["block_shape"]) for r in rows}
    check(held == {(b, sh) for b in (4, 8) for sh in range(len(gqm.SHAPES))},
          f"grouped_quant_matmul: (bits, block shape) held {sorted(held)}, "
          "not every instantiation of the kernel")
    # the dispatch: one layer's experts at T = 8 through both routes
    x = torch.randn((DECODE_BATCH, hid), generator=gen,
                    device=dev).to(torch.bfloat16)
    route_ms = {}
    for route, env in (("grouped", None), ("ragged", "0")):
        old = os.environ.pop("DI_MOE_GROUPED", None)
        if env is not None:
            os.environ["DI_MOE_GROUPED"] = env
        try:
            route_ms[route] = time_ms(
                lambda: moe_ops.moe_block(cfg, x, lp), [()], iters=3)
        finally:
            os.environ.pop("DI_MOE_GROUPED", None)
            if old is not None:
                os.environ["DI_MOE_GROUPED"] = old
    print(f"one MoE layer's experts at T={DECODE_BATCH}: grouped route "
          f"{route_ms['grouped']:.3f} ms, ragged route "
          f"{route_ms['ragged']:.3f} ms", flush=True)
    details["grouped_quant_matmul"] = dict(rows=rows, route_ms=route_ms)
    torch.cuda.empty_cache()
    # one layer of a bucket-32 prefill: gate and up (one shape) and down
    b32 = [r for r in rows if r["T"] == 32 and r["shape"] in ("gate", "down")]
    agg = aggregate(
        [dict(r, library_ms=r["library_ms"] or 0.0) for r in b32],
        [2 if r["shape"] == "gate" else 1 for r in b32])
    if any(r["library_ms"] is None for r in b32):
        agg["library_ms"] = None
    return dict(max_abs_err=max_err, shape="one layer of a bucket-32 "
                "prefill (gate + up + down, 128 routed rows)",
                route_ms=route_ms, **agg)


def paged_case(mode, gen, dev, cfg=None, B=DECODE_BATCH, maxP=32,
               lens=None, pool_dtype=None, nan_garbage=False):
    """B=8, H=28, KH=4 (or `cfg`'s heads), D=128, ps=64: ragged lens (incl.
    0 and non-multiples of the page), page tables shuffled over the pool,
    garbage past lens. With `nan_garbage`, every pool element (payload of a
    float pool, qparams) that no token < lens owns is NaN and the page-table
    entries past a slot's last page are out of range: the kernel must read
    none of it."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    if lens is None:
        lens = [0, 1, 63, 64, 65, 517, 1000, 2047]
    lens = torch.tensor(lens, dtype=torch.int32)
    P = B * maxP + 16
    cfg = cfg or ModelConfig(**QWEN2_7B)
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode), P,
                            pool_dtype or torch.bfloat16, dev)
    if mode == CacheMode.DEFAULT:
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    else:
        hi = 127 if mode == CacheMode.INT8 else 255
        lo = -128 if mode == CacheMode.INT8 else 0
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(lo, hi + 1, t.shape, generator=gen,
                                  device=dev).to(t.dtype))
        for t in (cache.k_qparams, cache.v_qparams):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * maxP]
    pt = perm.reshape(B, maxP).to(torch.int32)
    if nan_garbage:
        owned = torch.zeros((P, PAGE), dtype=torch.bool, device=dev)
        for b, n in enumerate(lens.tolist()):
            for j in range(-(-n // PAGE)):
                owned[pt[b, j], :min(PAGE, n - j * PAGE)] = True
        if mode == CacheMode.DEFAULT:
            for t in (cache.k, cache.v):
                t.masked_fill_(~owned[:, :, None], float("nan"))
        else:
            for t in (cache.k_qparams, cache.v_qparams):
                t[:, :, :PAGE].masked_fill_(~owned[:, None, :], float("nan"))
                t[:, :, PAGE:] = float("nan")     # the lanes' padding
        used = (torch.arange(maxP)[None, :] * PAGE <
                lens[:, None]).to(dev)
        pt = torch.where(used, pt, torch.tensor(0x3FFFFFFF, device=dev,
                                                dtype=torch.int32))
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev)
    return cache, pt, lens.to(dev), q, cfg


# paged_attention's coverage: (G, head_dim, pool kind) at KH = 4, every KV
# mode with the served bf16 q, the f32 pool with f32 q; D = 64 / 256 once
# each kind at G = 4; the other (q, pool) pairs the wrapper admits, which
# take the CUDA-core path (f32 q on a bf16 / int8 / uint4 pool, bf16 q on an
# f32 pool), at G = 7 and D = 128 and at G = 4 and D = 64 / 256; plus a
# batch whose (slot, head) pairs fill the card so that the sequence is one
# chunk (the kernel writes the output itself)
PA_COVER_G = (1, 2, 4, 7, 8)
PA_COVER_D = (64, 256)
PA_COVER_LENS = [0, 1, 63, 64, 65, 32 * PAGE, 777, 1500]   # 32 pages: full
PA_KINDS = ("f32", "bf16", "int8", "uint4")
PA_MIXED = (("bf16", "f32"), ("int8", "f32"), ("uint4", "f32"),
            ("f32", "bf16"))                    # (pool kind, q dtype)


def pa_cover_case(kind, G, D, gen, dev, B=DECODE_BATCH, KH=4, lens=None,
                  q_dtype=None):
    """One coverage case of paged_attention against its plain version, NaN
    garbage past lens and out-of-range page-table entries; q in `q_dtype`
    ("f32" or "bf16"; by default f32 on an f32 pool, else bf16). Returns
    max|d|."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import paged_attention as pa
    mode = {"f32": CacheMode.DEFAULT, "bf16": CacheMode.DEFAULT,
            "int8": CacheMode.INT8, "uint4": CacheMode.UINT4}[kind]
    f32 = kind == "f32"
    cfg = ModelConfig(**dict(QWEN2_7B, num_heads=KH * G, num_kv_heads=KH,
                             head_dim=D, hidden_size=KH * G * D))
    cache, pt, lens_t, q, _ = paged_case(
        mode, gen, dev, cfg, B=B, lens=lens or PA_COVER_LENS,
        pool_dtype=torch.float32 if f32 else torch.bfloat16,
        nan_garbage=True)
    q_dtype = q_dtype or ("f32" if f32 else "bf16")
    q = q if q_dtype == "f32" else q.to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    got = pa.paged_attention(q, cache, mode, pt, lens_t, scale)
    ref = pa.paged_attention_plain(q, cache, mode, pt, lens_t, scale)
    torch.cuda.synchronize()
    what = f"paged_attention {kind} ({q_dtype} q) G={G} D={D} B={B} KH={KH}"
    err = held_to_plain(got, ref, what)
    zero = lens_t == 0
    check(bool((got[zero] == 0).all()), f"{what}: lens 0 not 0")
    return err


def check_paged_attention(gen, dev, details):
    import torch
    import torch.nn.functional as F
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import kv_ops
    from dashinfer_tpu_torch.ops import paged_attention as pa

    def sdpa(qs, k, v, m):
        return F.scaled_dot_product_attention(qs, k, v, attn_mask=m,
                                              enable_gqa=True)

    def sdpa_args(qb, cache, mode, pt, lens, kv_heads, copies=1):
        """SDPA's operands on contiguous bf16 K/V gathered beforehand (`copies`
        distinct copies, timed in turn: together larger than the L2)."""
        k, v = kv_ops.gather_kv_pages(cache, mode, pt, kv_heads,
                                      torch.bfloat16)      # [B, S, KH, D]
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        S = k.shape[2]
        mask = (torch.arange(S, device=dev)[None, :] <
                lens[:, None])[:, None, None, :]
        out = [(qb[:, :, None, :], k, v, mask)]
        out += [(qb[:, :, None, :], k.clone(), v.clone(), mask)
                for _ in range(copies - 1)]
        return out

    rows, max_err = [], 0.0
    for mode in (CacheMode.DEFAULT, CacheMode.INT8, CacheMode.UINT4):
        cache, pt, lens, q, cfg = paged_case(mode, gen, dev)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        qb = q.to(torch.bfloat16)          # the served path's q and output
        got = pa.paged_attention(qb, cache, mode, pt, lens, scale)
        ref = pa.paged_attention_plain(qb, cache, mode, pt, lens, scale)
        torch.cuda.synchronize()
        err = held_to_plain(got, ref, f"paged_attention {mode.value}")
        scale_ref = ref.float().abs().max().item()
        check(bool((got[0] == 0).all()), "paged_attention: lens 0 not 0")
        max_err = max(max_err, err)
        ms = time_ms(pa.paged_attention,
                     [(qb, cache, mode, pt, lens, scale)], iters=50)
        plain_ms = time_ms(pa.paged_attention_plain,
                           [(qb, cache, mode, pt, lens, scale)], iters=3)
        # yardstick: SDPA over contiguous bf16 K/V of the same lengths
        library_ms = time_ms(sdpa, sdpa_args(qb, cache, mode, pt, lens,
                                             cfg.num_kv_heads), iters=50)
        ntok = int(lens.sum().item())
        KH, D, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
        per_tok = {CacheMode.DEFAULT: 2 * D, CacheMode.INT8: D + 8,
                   CacheMode.UINT4: D // 2 + 8}[mode]
        nbytes = (2 * ntok * KH * per_tok + 2 * qb.numel() * 2 +
                  pt.numel() * 4 + lens.numel() * 4)
        row = dict(mode=mode.value, B=q.shape[0], H=H, KH=KH, D=D, ps=PAGE,
                   lens=lens.tolist(), max_abs_err=err, ref_max=scale_ref,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   **bounds(nbytes, 4.0 * ntok * H * D))
        rows.append(row)
        print(f"paged_attention {mode.value:7s} err={err:.2e} ms={ms:.4f} "
              f"bound={row['bytes_ms']:.4f} plain={plain_ms:.3f} "
              f"lib={library_ms:.4f}", flush=True)
    # one query head a KV head (Qwen1.5-MoE's 16 on 16), INT8 as served
    cache, pt, lens, q, mcfg = paged_case(CacheMode.INT8, gen, dev,
                                          moe_config())
    qb = q.to(torch.bfloat16)
    got = pa.paged_attention(qb, cache, CacheMode.INT8, pt, lens, scale)
    ref = pa.paged_attention_plain(qb, cache, CacheMode.INT8, pt, lens, scale)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, "paged_attention int8 G=1")
    max_err = max(max_err, err)
    ms = time_ms(pa.paged_attention,
                 [(qb, cache, CacheMode.INT8, pt, lens, scale)], iters=50)
    library_ms = time_ms(sdpa, sdpa_args(qb, cache, CacheMode.INT8, pt, lens,
                                         mcfg.num_kv_heads), iters=50)
    rows.append(dict(mode="int8", H=mcfg.num_heads, KH=mcfg.num_kv_heads,
                     max_abs_err=err, ms=ms, library_ms=library_ms))
    print(f"paged_attention int8 G=1 (16 heads on 16) err={err:.2e} "
          f"ms={ms:.4f} lib={library_ms:.4f}", flush=True)
    del cache
    # coverage: every G the wrapper admits at D = 128, D = 64 / 256, every
    # pool kind, lens 0 / 1 / a page boundary +-1 / a full table, NaN
    # garbage past lens, out-of-range page-table entries
    cover = []
    for kind in PA_KINDS:
        for G in PA_COVER_G:
            cover.append((kind, G, 128, DECODE_BATCH, 4, None))
        for D in PA_COVER_D:
            cover.append((kind, 4, D, DECODE_BATCH, 4, None))
    for kind, q_dtype in PA_MIXED:
        cover.append((kind, 7, 128, DECODE_BATCH, 4, q_dtype))
        for D in PA_COVER_D:
            cover.append((kind, 4, D, DECODE_BATCH, 4, q_dtype))
    cover.append(("int8", 1, 128, 40, 16, None))    # one chunk: 640 blocks
    for kind, G, D, B, KH, q_dtype in cover:
        err = pa_cover_case(kind, G, D, gen, dev, B=B, KH=KH,
                            lens=None if B == DECODE_BATCH else
                            [(0, 1, 63, 64, 65, 2048, 300, 900)[i % 8]
                             for i in range(B)], q_dtype=q_dtype)
        max_err = max(max_err, err)
    print(f"paged_attention coverage: {len(cover)} cases held (G "
          f"{PA_COVER_G} at D=128, D {PA_COVER_D}, kinds {PA_KINDS}, the "
          f"(pool, q) pairs {PA_MIXED}, one single-chunk batch), max|d| "
          f"{max_err:.2e}", flush=True)
    torch.cuda.empty_cache()
    # the long-context state (28 layers' pages of one INT8 pool, larger than
    # the 50 MB L2): one launch a layer in turn (cold) and layer 0 again and
    # again (L2-warm), at B = 8 and B = 32, beside SDPA on contiguous bf16
    # K/V gathered beforehand, cold (distinct copies, together over 50 MB)
    # and warm (one copy)
    big = []
    mode = CacheMode.INT8
    L = cfg.num_layers
    for B in (DECODE_BATCH, 32):
        long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016] * (B // 8)
        st = mk_state(cfg, mode, B, long_lens, None, gen, dev)
        qb = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                         device=dev).to(torch.bfloat16)
        per_layer = [(qb, st["cache"], mode,
                      (st["pt"] * L + l).to(torch.int32), st["lens"], scale)
                     for l in range(L)]
        got = pa.paged_attention(*per_layer[3])
        ref = pa.paged_attention_plain(*per_layer[3])
        torch.cuda.synchronize()
        err = held_to_plain(got, ref, f"paged_attention long context B={B}")
        max_err = max(max_err, err)
        cold_ms = time_ms(pa.paged_attention, per_layer, iters=L)
        warm_ms = time_ms(pa.paged_attention, per_layer[:1], iters=L)
        lib = sdpa_args(qb, st["cache"], mode, per_layer[0][3], st["lens"],
                        cfg.num_kv_heads)
        kv_mb = sum(t.numel() * t.element_size() for t in lib[0][1:3]) / 1e6
        lib_copies = lib + [(a, k.clone(), v.clone(), m) for a, k, v, m in
                            lib * (max(2, math.ceil(160 / kv_mb)) - 1)]
        lib_cold = time_ms(sdpa, lib_copies, iters=len(lib_copies))
        lib_warm = time_ms(sdpa, lib, iters=L)
        del lib, lib_copies
        nbytes = kv_bytes_read(cfg, mode, long_lens, [1] * B) // L \
            + 2 * qb.numel() * 2
        pool_mb = sum(t.numel() * t.element_size() for t in
                      (st["cache"].k, st["cache"].v, st["cache"].k_qparams,
                       st["cache"].v_qparams)) / 1e6
        row = dict(mode="int8", B=B, lens=long_lens, pool_mb=pool_mb,
                   max_abs_err=err, cold_ms=cold_ms, warm_ms=warm_ms,
                   library_cold_ms=lib_cold, library_warm_ms=lib_warm,
                   library_kv_mb=kv_mb,
                   **bounds(nbytes, 4.0 * sum(long_lens) * cfg.num_heads *
                            cfg.head_dim))
        big.append(row)
        print(f"paged_attention int8 B={B} on a {pool_mb:.0f} MB pool, "
              f"{sum(long_lens)} cached tokens: cold {cold_ms:.4f} "
              f"ms/launch, L2-warm {warm_ms:.4f}, bound "
              f"{row['bytes_ms']:.4f}; SDPA cold {lib_cold:.4f}, warm "
              f"{lib_warm:.4f} ({kv_mb:.0f} MB of bf16 K/V a copy); "
              f"err={err:.2e}", flush=True)
        del st, per_layer
        torch.cuda.empty_cache()
    details["paged_attention"] = rows
    details["paged_attention_large_pool"] = big
    # the served model's INT8 cache: one launch per layer per decode step
    int8 = next(r for r in rows if r["mode"] == "int8" and r["KH"] == 4)
    return dict(max_abs_err=max_err,
                **aggregate([int8], [QWEN2_7B["num_layers"]]))


# -- phase 3: the slice end to end ------------------------------------------

def random_qwen2_7b_params(seed: int, dev, stream: str = "u4"):
    """Random a16w4 group-128 weights (the distribution of bench.py's
    build_qwen2_7b_params(quantize_lm=True)), made on the card; with
    stream="i8", per-channel int8 leaves as the u4 -> i8 rule makes them."""
    from dashinfer_tpu_torch.config import ModelConfig
    from dashinfer_tpu_torch.tools import bench_stream
    return bench_stream.random_a16w4_params(ModelConfig(**QWEN2_7B), seed,
                                            dev, GROUP, stream)


def moe_config(layers: int = None):
    from dashinfer_tpu_torch.config import ModelConfig, MoEConfig
    kw = dict(QWEN15_MOE)
    if layers:
        kw["num_layers"] = layers
    return ModelConfig(**kw, moe=MoEConfig(**QWEN15_MOE_EXPERTS))


def random_moe_params(cfg, seed: int, dev):
    """Random a16w4 group-128 weights at Qwen1.5-MoE width (the
    distribution of bench.py's build_qwen15_moe_params: u4 levels uniform,
    scale in [1e-4, 2.1e-3), zero = -8 scale; an f32 router and shared-expert
    gate of std 0.05), made on the card, with the 1408-wide expert stacks
    re-laid out and padded as the install does (`prepare_grouped_experts`)."""
    import torch
    from dashinfer_tpu_torch.ops.grouped_quant_matmul import \
        prepare_grouped_experts
    L, D, hid, V = (cfg.num_layers, cfg.head_dim, cfg.hidden_size,
                    cfg.vocab_size)
    H, KH, moe = cfg.num_heads, cfg.num_kv_heads, cfg.moe
    E, Im, sIm = (moe.num_experts, moe.moe_intermediate_size,
                  moe.shared_expert_intermediate_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(kin, kout, lead=(L,), bias=False):
        scale = torch.rand(lead + (kin // GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        d = {"w_q": torch.randint(0, 256, lead + (kin, kout // 2),
                                  dtype=torch.uint8, generator=gen,
                                  device=dev),
             "scale": scale, "zero": -scale * 8.0}
        if bias:
            d["b"] = torch.zeros(lead + (kout,), dtype=torch.bfloat16,
                                 device=dev)
        return d

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    params = {
        "embed_tokens": {"w": randn(V, hid, std=0.02).to(torch.bfloat16)},
        "norm": ones(hid),
        "lm_head": qlin(hid, V, lead=()),
        "layers": {
            "input_layernorm": ones(L, hid),
            "post_attention_layernorm": ones(L, hid),
            "q_proj": qlin(hid, H * D, bias=True),
            "k_proj": qlin(hid, KH * D, bias=True),
            "v_proj": qlin(hid, KH * D, bias=True),
            "o_proj": qlin(H * D, hid),
            "router": {"w": randn(L, hid, E, std=0.05)},
            "experts": {"gate_proj": qlin(hid, Im, (L, E)),
                        "up_proj": qlin(hid, Im, (L, E)),
                        "down_proj": qlin(Im, hid, (L, E))},
            "shared_expert": {"gate_proj": qlin(hid, sIm),
                              "up_proj": qlin(hid, sIm),
                              "down_proj": qlin(sIm, hid)},
            "shared_expert_gate": {"w": randn(L, hid, 1, std=0.05)},
        },
    }
    return prepare_grouped_experts(params, cfg)


def planted_router_fault(plan, logits_plain, rows, what, budget, seed,
                         ill=None):
    """The routing of a faulty router (the plain version's logits, a list
    of [R, EP], plus PLANTED_ROUTER_ERR of noise) against the plain
    version's: it must fail the flip caps (count or gap; `ill` as
    flipped_rows'). Returns its flipped-row count."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    gen = torch.Generator(device=logits_plain[0].device)
    gen.manual_seed(seed)
    chosen = torch.stack([
        mk.route(plan, lg + PLANTED_ROUTER_ERR * torch.randn(
            lg.shape, generator=gen, device=lg.device))[0] > 0
        for lg in logits_plain])
    flips = flipped_rows(plan, chosen, logits_plain, rows, what)
    check(len(flips) > budget or any(
        g > TIE_LOGIT and not (ill is not None and bool(ill[l, r]))
        for r, l, g in flips),
          f"{what}: a planted router fault (logit noise "
          f"{PLANTED_ROUTER_ERR}) passes the flip caps ({len(flips)} rows, "
          f"at most {budget}): the caps do not tell it from the kernel")
    return len(flips)


def flipped_rows(plan, chosen_kernel, logits_plain, rows, what,
                 budget=None, chosen_ref=None, ill=None):
    """Rows (of `rows`, a bool mask) whose routed experts differ between
    the kernel (chosen_kernel [L, R, E] bool) and the plain version (its
    router products, a list of [R, EP]; or `chosen_ref`, another kernel's
    choices) in some layer, held to the MoE rules above (not held without
    a `budget`): at most `budget` rows, each a near-tie of the plain
    version where it first flips, or ill-conditioned there (`ill` [L, R]
    bool: its residual RMS entering the layer below ILL_NORM_SHARE of the
    batch's median, forced_routing_check's rule). Returns [(row, first
    layer, the plain version's logit gap there)]."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    logits = torch.stack(logits_plain)[..., :plan.E]             # [L, R, E]
    chosen_plain = chosen_ref if chosen_ref is not None else torch.stack(
        [mk.route(plan, lg)[0] > 0 for lg in logits_plain])
    diff = (chosen_kernel != chosen_plain).any(-1) & rows[None, :]   # [L, R]
    top = logits.topk(plan.k_top + 1, dim=-1).values
    gap = top[..., plan.k_top - 1] - top[..., plan.k_top]           # [L, R]
    flips = []
    for r in torch.nonzero(diff.any(0))[:, 0].tolist():
        l = int(torch.nonzero(diff[:, r])[0, 0])
        flips.append((r, l, round(float(gap[l, r]), 6)))
    check(budget is None or (len(flips) <= budget and all(
        g <= TIE_LOGIT or (ill is not None and bool(ill[l, r]))
        for r, l, g in flips)),
          f"{what}: {len(flips)} rows routed differently (at most {budget}, "
          f"each a near-tie of the plain version within {TIE_LOGIT} or "
          f"ill-conditioned there): (row, first layer, logit gap) {flips}"
          + ("" if ill is None else
             f"; ill-conditioned at that layer "
             f"{[bool(ill[l, r]) for r, l, _ in flips]}"))
    return flips


PROMPT_LENS = [20, 90, 200, 450, 700, 1000]   # buckets 32 .. 1024


def serve(params, dev, details, path: str, new_tokens: int, cfg=None,
          devices=None):
    """Six concurrent requests through `Engine`: path "megakernel" (every
    flag at its default: decode and qualifying prefills through the two
    megakernels), "per-op" (`enable_megakernel` off) or "pack_only"
    (`weight_residency="pack_only"`; `params` is then a callable that makes
    the tree, so that the engine alone holds it) or "megakernel prefill
    per-op" (DI_PREFILL_MEGAKERNEL=0: the decode megakernel, every prefill
    per-op); on a (1, n) mesh over `devices`, "tp" (every flag at its
    default: decode through the TP segments, the prefills of buckets 128 ..
    1024 through the TP prefill segments (a MoE model's per-op TP), the
    others per-op TP), "tp prefill per-op" (DI_PREFILL_MEGAKERNEL=0: every
    prefill per-op TP, as before the TP prefill segments) or "tp per-op".
    `cfg`: Qwen2-7B unless given (the MoE model). Returns (launch counts of
    the timed requests, generated tokens per request)."""
    import torch
    from dashinfer_tpu_torch import (CacheMode, Engine, GenerateRequestStatus,
                                     GenerationConfig, ModelConfig,
                                     RuntimeConfigBuilder)
    from dashinfer_tpu_torch.engine.model_runtime import _resident_bytes
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import paged_attention as pa
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    megakernel = path not in ("per-op", "tp per-op")
    counters = {"quant_matmul": qm.quant_matmul.counter,
                "paged_attention": pa.paged_attention.counter,
                "decode_megakernel": mk.decode_megakernel.counter,
                "prefill_megakernel": pmk.prefill_megakernel.counter,
                "grouped_quant_matmul": gqm.grouped_quant_matmul.counter,
                "tp_attn_segment": tpk.tp_attn_segment.counter,
                "tp_mlp_segment": tpk.tp_mlp_segment.counter,
                "tp_moe_segment": tpk.tp_moe_segment.counter,
                "tp_lm_segment": tpk.tp_lm_segment.counter,
                "tp_prefill_attn_segment":
                    tpk.tp_prefill_attn_segment.counter,
                "tp_prefill_mlp_segment": tpk.tp_prefill_mlp_segment.counter,
                "tp_prefill_lm_segment": tpk.tp_prefill_lm_segment.counter}
    cfg = cfg or ModelConfig(**QWEN2_7B)
    name = "qwen1.5-moe" if cfg.moe else "qwen2-7b"
    label = f"{name} {path}"
    b = (RuntimeConfigBuilder(name).max_length(2048)
         .max_batch(DECODE_BATCH).kv_cache_page_size(PAGE)
         .kv_cache_mode(CacheMode.INT8).dtype("bfloat16"))
    if not megakernel:
        b = b.update({"enable_megakernel": False})
    if path == "pack_only":
        b = b.update({"weight_residency": "pack_only"})
    if devices:
        b = b.mesh(1, len(devices))
    rt = b.build()
    check(rt.enable_megakernel == megakernel, "enable_megakernel default")
    torch.cuda.synchronize()
    pmk.release_scratch(dev)    # what the kernel checks left: the install
    torch.cuda.empty_cache()    # reserves its own, before it plans the pool
    mem0 = torch.cuda.memory_allocated(dev)
    if callable(params):
        params = params()
    mem_tree = torch.cuda.memory_allocated(dev) - mem0
    prefill_off = path in ("tp prefill per-op", "megakernel prefill per-op")
    if prefill_off:
        os.environ["DI_PREFILL_MEGAKERNEL"] = "0"
    try:
        eng = Engine().install_model(name, rt, params=params,
                                     model_config=cfg, device=devices or dev)
    finally:
        os.environ.pop("DI_PREFILL_MEGAKERNEL", None)
    del params
    run = eng._models[name]
    caches = run.cache if devices else [run.cache]
    memory = dict(
        residency=run.residency, tree_bytes=mem_tree,
        installed_bytes=torch.cuda.memory_allocated(dev) - mem0,
        weights_resident_bytes=_resident_bytes(run.params, run.mega_params),
        weights_by_device={str(d): _resident_bytes(
            run.params, run.mega_params, device=d)
            for d in dict.fromkeys(devices or [dev])},
        pack_bytes=_resident_bytes(run.mega_params),
        pool_bytes=_resident_bytes(*(vars(c) for c in caches)),
        prefill_scratch_bytes=pmk.scratch_bytes(dev),
        logical_pages=run.num_logical_pages)
    # the TP prefill segments take no MoE model (their MLP is dense)
    tp_buckets = [b for b in (128, 256, 512, 1024)
                  if megakernel and not prefill_off and not cfg.moe]
    if devices:
        check((run.tp_mega_plan is not None) == megakernel and
              run.mega_plan is None and not run._pmk_plans and
              sorted(run._tp_pmk_plans) == tp_buckets,
              f"{label}: the mesh install took the wrong decode or prefill "
              f"path (TP prefill buckets {sorted(run._tp_pmk_plans)})")
    # one scratch set, sized for the largest bucket, is on the card from the
    # install on (none on the per-op paths)
    prefill_kernels = bool(tp_buckets) if devices else \
        (megakernel and not prefill_off)
    check((memory["prefill_scratch_bytes"] > 0) == prefill_kernels,
          f"{path}: prefill scratch after install: "
          f"{memory['prefill_scratch_bytes']} bytes")
    eng.start_model(name)
    g = torch.Generator().manual_seed(7)
    try:
        if path == "pack_only":
            # refused at start_request, with the reference's message
            try:
                eng.start_request(name, [1] * 1025, GenerationConfig(
                    max_length=1030, do_sample=False, top_k=1, eos_token_id=-1))
                refused = ""
            except ValueError as e:
                refused = str(e)
            check(refused == "prompt length 1025 exceeds the prefill megakernel "
                  "coverage (1024 tokens) under weight_residency=pack_only",
                  f"pack_only: a 1025-token prompt gave {refused!r}")
        # warm-up request: the process's first use of each PyTorch kernel
        # and the capture of the decode graph are set-up, not serving
        _, h, _ = eng.start_request(
            name, torch.randint(1, cfg.vocab_size, (20,),
                                generator=g).tolist(),
            GenerationConfig(max_length=24, do_sample=False, top_k=1,
                             eos_token_id=-1))
        eng.sync_request(name, h, timeout_s=600)
        # the kernels count their own launches on the card (CUDA graph
        # replays of the decode forward included)
        for c in counters.values():
            c.reset()
        t0 = time.monotonic()
        handles = []
        for i, n in enumerate(PROMPT_LENS):
            ids = torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            gc = GenerationConfig(max_length=n + new_tokens,
                                  do_sample=bool(i % 2), top_k=20,
                                  temperature=0.8, seed=1000 + i,
                                  eos_token_id=-1)
            _, h, q = eng.start_request(name, ids, gc)
            handles.append((h, q, gc.do_sample))
        for h, _, _ in handles:
            eng.sync_request(name, h, timeout_s=600)
        wall = time.monotonic() - t0
        launches = {k: c.read() for k, c in counters.items()}
    finally:
        eng.release_model(name)
    check(pmk.scratch_bytes(dev) == 0,
          f"{path}: release_model left {pmk.scratch_bytes(dev)} bytes of "
          "prefill scratch on the card")
    reqs, tokens = [], []
    for (h, q, sampled), n in zip(handles, PROMPT_LENS):
        toks = q.GetAllGeneratedTokens()
        tokens.append(list(toks))
        st = q.RequestStatInfo()
        status = q.GenerateStatus()
        reqs.append(dict(prompt_len=n, sampled=sampled, status=status.value,
                         n_tokens=len(toks),
                         ttft_ms=1e3 * st["time_to_first_token"],
                         decode_ms_per_step=(1e3 / st["generate_tps"]
                                             if st["generate_tps"] else None)))
        check(status == GenerateRequestStatus.GenerateFinished,
              f"{path}: request (prompt {n}) ended {status.value}")
        check(len(toks) == new_tokens and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"{path}: request (prompt {n}): {len(toks)} tokens")
    # a per-op prefill runs quant_matmul on its lm_head row (when the vocab
    # fills the kernel's 256-column tiles: Qwen1.5's 151936 does not, and
    # its lm_head takes the large-M formulation, as in the JAX package),
    # and on every projection when its bucket fits the kernel (M <= 32): q,
    # k, v, o and the MLP's (the MoE model's shared expert's) three; a MoE
    # layer runs the grouped kernel three times (gate, up, down) in every
    # per-op prefill and decode step; a prefill whose bucket is 128 .. 1024
    # is one prefill megakernel launch on the megakernel path, and under
    # pack_only every prefill is (the 20-token prompt snaps to bucket 128)
    L = cfg.num_layers
    n_r = len(devices) if devices else 1
    lm = int((cfg.vocab_size // n_r) % 256 == 0)
    per_step = 7 * L + lm
    grouped = 3 * L if cfg.moe else 0
    if path == "pack_only":
        mega_prefills, prefill = len(PROMPT_LENS), 0
    elif megakernel and not prefill_off:
        mega_prefills = sum(64 < n <= 1024 for n in PROMPT_LENS)
        prefill = sum(per_step if n <= 32 else lm for n in PROMPT_LENS
                      if not 64 < n <= 1024)
    else:
        mega_prefills = 0
        prefill = sum(per_step if n <= 32 else lm for n in PROMPT_LENS)
    per_op_prefills = len(PROMPT_LENS) - mega_prefills
    if megakernel and not devices:
        # one megakernel launch is one decode step; nothing else of a step
        # reaches the per-op kernels
        steps = launches["decode_megakernel"]
        check(steps >= new_tokens - 1 and launches["paged_attention"] == 0
              and launches["quant_matmul"] == prefill
              and launches["prefill_megakernel"] == mega_prefills
              and launches["grouped_quant_matmul"] ==
              grouped * per_op_prefills,
              f"{label} path: launch counts {launches} do not match "
              f"{steps} decode steps, {mega_prefills} prefill megakernel "
              f"launches and the other prefills' {prefill} quant_matmul "
              f"and {grouped * per_op_prefills} grouped_quant_matmul "
              "launches")
    elif not devices:
        # every decode step runs paged_attention once per layer and
        # quant_matmul for the 7 projections of each layer and the lm_head
        steps = launches["paged_attention"] // L
        check(launches["paged_attention"] % L == 0 and steps >= new_tokens - 1
              and launches["quant_matmul"] == per_step * steps + prefill
              and launches["grouped_quant_matmul"] ==
              grouped * (steps + len(PROMPT_LENS))
              and launches["decode_megakernel"] == 0
              and launches["prefill_megakernel"] == 0,
              f"{label} path: launch counts {launches} do not match {steps} "
              f"decode steps and {len(PROMPT_LENS)} prefills")
    if devices:
        # a per-op TP prefill runs every rank's projections as a
        # single-device prefill does (at the rank's widths); a prefill of a
        # bucket 128 .. 1024 through the TP prefill segments runs every
        # rank's attn and mlp segments a layer and its lm segment; a decode
        # step runs every rank's two segments a layer and its lm segment,
        # or per-op every rank's kernels of a single-device step
        seg_prefills = sum(64 < n <= 1024 for n in PROMPT_LENS) \
            if tp_buckets else 0
        prefill = n_r * sum(per_step if n <= 32 else lm for n in PROMPT_LENS
                            if not (tp_buckets and 64 < n <= 1024))
        # (a MoE model: its moe segment in place of the mlp one, and every
        # rank's grouped GEMMs in each per-op TP prefill and step)
        mlp_seg = "tp_moe_segment" if cfg.moe else "tp_mlp_segment"
        op_prefills = len(PROMPT_LENS) - seg_prefills
        if megakernel:
            steps = launches["tp_lm_segment"] // n_r
            expect = {"tp_attn_segment": L * n_r * steps,
                      mlp_seg: L * n_r * steps,
                      "tp_lm_segment": n_r * steps, "quant_matmul": prefill,
                      "tp_prefill_attn_segment": L * n_r * seg_prefills,
                      "tp_prefill_mlp_segment": L * n_r * seg_prefills,
                      "tp_prefill_lm_segment": n_r * seg_prefills,
                      "grouped_quant_matmul": grouped * n_r * op_prefills}
        else:
            steps = launches["paged_attention"] // (L * n_r)
            expect = dict(paged_attention=L * n_r * steps,
                          quant_matmul=n_r * per_step * steps + prefill,
                          grouped_quant_matmul=grouped * n_r * (
                              steps + len(PROMPT_LENS)))
        # and no other kernel runs
        check(steps >= new_tokens - 1 and
              {k: v for k, v in launches.items() if v} ==
              {k: v for k, v in expect.items() if v},
              f"{label} path: launch counts {launches} do not match {steps} "
              f"decode steps over {n_r} ranks, {seg_prefills} prefills "
              f"through the TP prefill segments and "
              f"{len(PROMPT_LENS) - seg_prefills} per-op TP prefills "
              f"({expect})")
    details[f"serving_{name}_{path}"] = dict(
        requests=reqs, launches=launches, wall_s=wall, decode_steps=steps,
        memory=memory)
    for r in reqs:
        print(f"{label} request prompt={r['prompt_len']:4d} "
              f"{'top-k' if r['sampled'] else 'greedy':6s} {r['status']} "
              f"tokens={r['n_tokens']} ttft_ms={r['ttft_ms']:.1f} "
              f"decode_ms/step={r['decode_ms_per_step']:.2f}", flush=True)
    print(f"{label}: served {len(reqs)} requests in {wall:.2f} s, {steps} "
          f"decode steps; launches {launches}", flush=True)
    gib = 1024 ** 3
    print(f"{label}: weight residency {memory['residency']}: weights on the "
          f"card {memory['weights_resident_bytes'] / gib:.2f} GiB (the "
          f"megakernels' {memory['pack_bytes'] / gib:.2f}), pool "
          f"{memory['pool_bytes'] / gib:.2f} GiB "
          f"({memory['logical_pages']} logical pages), prefill scratch "
          f"{memory['prefill_scratch_bytes'] / gib:.2f} GiB", flush=True)
    return launches, tokens, memory


def check_serving(params, dev, details):
    """The three serving paths on the same weights; the greedy requests'
    first 8 tokens must agree with the per-op path's (the paths round
    differently by design: the decode megakernel attends the new token
    unquantized, the prefill megakernel attends the prompt's exact K/V)."""
    import torch
    mk_launches, mk_tokens, mk_mem = serve(params, dev, details,
                                           "megakernel", 64)
    op_launches, op_tokens, _ = serve(params, dev, details, "per-op", 64)
    # the same weights again from the same seed, held by the engine alone,
    # so that what pack_only demotes really leaves the card
    po_launches, po_tokens, po_mem = serve(
        lambda: random_qwen2_7b_params(SEED, dev), dev, details, "pack_only",
        24)
    agree = {}
    for path, toks in (("megakernel", mk_tokens), ("pack_only", po_tokens)):
        agree[path] = []
        for i, (a, b) in enumerate(zip(toks, op_tokens)):
            if i % 2:
                continue            # sampled
            n = min(len(a), len(b))
            same = next((j for j in range(n) if a[j] != b[j]), n)
            agree[path].append(same)
            print(f"greedy request prompt={PROMPT_LENS[i]}: {path} and "
                  f"per-op paths agree on the first {same} of {n} tokens "
                  f"compared", flush=True)
            check(same >= 8, f"greedy request (prompt {PROMPT_LENS[i]}): "
                  f"the {path} and per-op paths agree on only {same} tokens")
    details["greedy_agreement"] = agree
    # pack_only: what the install left allocated on the card is the weights
    # it kept and the pool, lower than under `both` (same weights, same
    # pool) by the demoted payloads
    demoted = mk_mem["weights_resident_bytes"] - \
        po_mem["weights_resident_bytes"]
    slack = 64 * 1024 ** 2
    check(demoted > 0.4 * po_mem["tree_bytes"] and
          po_mem["pool_bytes"] == mk_mem["pool_bytes"] and
          po_mem["installed_bytes"] <= po_mem["weights_resident_bytes"] +
          po_mem["pool_bytes"] + po_mem["prefill_scratch_bytes"] + slack,
          f"pack_only did not free the raw payloads: {po_mem} vs {mk_mem}")
    print(f"pack_only: {demoted / 1024**3:.2f} GiB of raw payloads demoted "
          f"to the host; {po_mem['installed_bytes'] / 1024**3:.2f} GiB "
          "allocated on the card after install (weights kept + pool + "
          "prefill scratch), "
          f"against "
          f"{(po_mem['installed_bytes'] + demoted) / 1024**3:.2f} with both "
          "resident", flush=True)
    torch.cuda.empty_cache()
    return (mk_launches, op_launches, po_launches,
            {"megakernel": mk_tokens, "per-op": op_tokens})


def check_serving_moe(params, cfg, dev, details, prefill_per_op=False):
    """The MoE model served with every flag at its default and on the per-op
    path, on the same weights; the greedy requests' agreement is printed
    (the paths route with different sums, so a near-tie may route a token
    differently: only the launch counts and the finished requests are
    held). With `prefill_per_op`, also with DI_PREFILL_MEGAKERNEL=0 (the
    single-device serving that the MoE mesh serving is held to). Returns
    the launches of the first two and the tokens of each path."""
    import torch
    mk_launches, mk_tokens, _ = serve(params, dev, details, "megakernel",
                                      64, cfg)
    op_launches, op_tokens, _ = serve(params, dev, details, "per-op", 64,
                                      cfg)
    tokens = {"megakernel": mk_tokens, "per-op": op_tokens}
    if prefill_per_op:
        tokens["megakernel prefill per-op"] = serve(
            params, dev, details, "megakernel prefill per-op", 64, cfg)[1]
    agree = []
    for i, (a, b) in enumerate(zip(mk_tokens, op_tokens)):
        if i % 2:
            continue
        n = min(len(a), len(b))
        agree.append(next((j for j in range(n) if a[j] != b[j]), n))
        print(f"MoE greedy request prompt={PROMPT_LENS[i]}: megakernel and "
              f"per-op paths agree on the first {agree[-1]} of {n} tokens",
              flush=True)
    details["moe_greedy_agreement"] = agree
    torch.cuda.empty_cache()
    return mk_launches, op_launches, tokens


# -- the decode megakernel against its plain version -------------------------

MK_LENS = [37, 64, 150, 300, 1, 127, 256, 500]   # 64, 256: page boundaries
MK_INACTIVE = 5


def mk_state(cfg, mode, B, lens, inactive, gen, dev, max_len=2048,
             nan_fill=False, dtype="bfloat16"):
    """A random pool (payload and qparams) with distinct logical pages per
    slot, and the step's inputs. `nan_fill`: every pool element of a float
    pool and every qparam element that no token < lens owns (rows past a
    slot's length, pages no slot holds, the qparams' lanes past the page)
    holds NaN, which the kernels must never read. `dtype`: the runtime's
    (an unquantized pool's element type)."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    maxP, L = max_len // PAGE, cfg.num_layers
    # logical pages 1 .. B*maxP; the last physical page is the per-op
    # path's sink for inactive slots
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (B * maxP + 1) * L + 1, getattr(torch, dtype),
                            dev)
    for t in (cache.k, cache.v):
        if mode == CacheMode.DEFAULT:
            t.normal_(generator=gen)
        else:
            t.view(torch.uint8).random_(0, 256, generator=gen)
    if mode != CacheMode.DEFAULT:
        lo = 0.008 if mode == CacheMode.INT8 else 0.13
        for t in (cache.k_qparams, cache.v_qparams):
            t.uniform_(0.5 * lo, lo, generator=gen)
            if mode == CacheMode.UINT4:
                t[:, 1::2] *= -7.5          # zero = min
            else:
                t[:, 1::2] -= 0.75 * lo
    pt = (1 + torch.arange(B * maxP, dtype=torch.int32, device=dev)
          ).reshape(B, maxP)
    if nan_fill:
        owned = torch.zeros(cache.k.shape[:2], dtype=torch.bool, device=dev)
        tok = torch.arange(maxP * PAGE, device=dev)
        for b, n in enumerate(lens):
            keep = tok < n
            pages = pt[b].long()[tok // PAGE][keep]
            for l in range(L):
                owned[pages * L + l, (tok % PAGE)[keep]] = True
        if mode == CacheMode.DEFAULT:
            for t in (cache.k, cache.v):
                t[~owned] = float("nan")
        else:
            for t in (cache.k_qparams, cache.v_qparams):
                t[:, :, PAGE:] = float("nan")
                t[:, :, :PAGE].masked_fill_(~owned[:, None, :], float("nan"))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if inactive is not None:
        active[inactive] = False
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=gen, device=dev)
    cos, sin = _rope_tiles(cfg, lens_t)
    return dict(cache=cache, pt=pt, lens=lens_t, active=active, tokens=tokens,
                cos=cos, sin=sin)


def mk_plan_pack(cfg, params, B, mode, dtype="bfloat16"):
    """(plan, packed) of the megakernel for a max_batch-B runtime."""
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import megakernel as mk
    rt = (RuntimeConfigBuilder("mk").max_length(2048).max_batch(B)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype(dtype)
          .build())
    check(mk.supports(cfg, rt, params), "megakernel.supports said no")
    plan = mk.make_plan(cfg, rt, params)
    return plan, mk.pack_params(cfg, plan, params)


def kv_bytes_read(cfg, mode, lens, active) -> int:
    """Bytes of cached K/V (payload + qparams) one step must read."""
    from dashinfer_tpu_torch.config import CacheMode
    per_tok = {CacheMode.DEFAULT: 2 * cfg.head_dim,
               CacheMode.INT8: cfg.head_dim + 8,
               CacheMode.UINT4: cfg.head_dim // 2 + 8}[mode]
    ntok = sum(n for n, a in zip(lens, active) if a)
    return 2 * ntok * cfg.num_kv_heads * per_tok * cfg.num_layers


def kv_levels(t, mode):
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    if mode == CacheMode.UINT4:
        return torch.cat([t & 0xF, t >> 4], dim=-1).to(torch.int32)
    return t.to(torch.int32) if mode == CacheMode.INT8 else t.float()


def check_written_pool(what, mode, got, ref_cache, before, written, L, dev,
                       exempt=None, moe=False):
    """A kernel's pool against its plain version's on clones of one pool:
    `written` [pages, ps] marks the token rows that must have changed (the
    tolerances above, except at the rows `exempt` marks: a MoE row that
    was routed differently); every other byte must be unchanged. A MoE
    model's written rows of the layers past the first are held in
    dequantized values, as the prefill pool is (MOE_DEEP_RTOL). Returns
    (payload levels apart, qparams rel. difference in layer 0, in all
    layers)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    pool_err = qp_err = qp_err0 = 0.0
    quant = mode != CacheMode.DEFAULT
    held = written if exempt is None else written & ~exempt

    def same(x, y):          # NaN garbage past lens stays NaN
        return bool(((x == y) | (x.isnan() & y.isnan())).all()) \
            if x.is_floating_point() else bool((x == y).all())

    for name in ("k", "v"):
        a, r, b0 = (getattr(c, name) for c in (got, ref_cache,
                                               before))
        check(same(a[~written], b0[~written]),
              f"{what}: {name} pool changed outside the written tokens")
        check(bool((a[written] != b0[written]).any(-1).all()),
              f"{what}: a new token's {name} row was not written")
        written_all, written = written, held
        d = (kv_levels(a[written], mode) - kv_levels(r[written], mode)).abs()
        layer = torch.arange(written.shape[0], device=dev)[:, None] \
            .expand_as(written)[written] % L
        if quant and moe:
            # layer 0 at most one level apart; deeper rows in values
            pool_err = max(pool_err, float(d[layer == 0].max().item()))
            check(pool_err <= 1, f"{what}: {name} layer 0 payload "
                  f"{pool_err} levels")
            KH = getattr(got, name + "_qparams").shape[1] // 2
            val, _, _, _ = written_rows(got, name, written, mode, KH)
            rval, _, rsc, _ = written_rows(ref_cache, name, written, mode,
                                           KH)
            # [R, KH]: the difference less 1.5 of the row's levels, in
            # shares of the largest range of that layer's written rows
            rng = (rval.amax(-1) - rval.amin(-1))
            layer_rng = torch.zeros((L, KH), device=dev).scatter_reduce_(
                0, layer[:, None].expand_as(rng), rng, "amax"
            )[layer].clamp_min(1e-8)
            over = ((val - rval).abs().amax(-1) - 1.5 * rsc).clamp_min(0)
            rel_all = over / layer_rng                         # [R, KH]
            rel = rel_all[layer > 0]
            if rel.numel() and rel.max().item() > MOE_DEEP_RTOL:
                # where: the worst (row, head), and that token's rows in
                # every layer (logical page g: the request's row of pages)
                worst = int(rel_all.amax(-1).argmax())
                page, off = torch.nonzero(written)[worst].tolist()
                head = int(rel_all[worst].argmax())
                g = page // L
                same = torch.nonzero(written)
                rows_g = ((same[:, 0] // L == g) & (same[:, 1] == off))
                profile = [round(v, 4) for v in
                           rel_all[rows_g][:, head].tolist()]
                check(False, f"{what}: {name} rows past layer 0 differ by "
                      f"{rel.max().item():.3e} of their layer's range beyond "
                      f"1.5 levels; worst: logical page {g}, offset {off}, "
                      f"layer {page % L}, head {head}; by "
                      f"layer: {profile}; (row, head) pairs over: "
                      f"{int((rel > MOE_DEEP_RTOL).sum())} of {rel.numel()}")
        elif quant:     # at most one quantization level apart
            pool_err = max(pool_err, float(d.max().item()))
            check(pool_err <= 1, f"{what}: {name} payload {pool_err} levels")
        else:           # one bf16 step on top of the qparams' tolerances
            rv = kv_levels(r[written], mode).abs()
            layer0 = (torch.arange(written.shape[0], device=dev)[:, None]
                      .expand_as(written)[written] % L == 0)[:, None]
            tol = BF16_STEP * rv + rv.amax(-1, keepdim=True) * torch.where(
                layer0, QPARAM_RTOL, DEEP_QPARAM_RTOL)
            check(bool((d <= tol).all()), f"{what}: {name} payload differs "
                  f"by up to {d.max().item():.3e} (max|ref| "
                  f"{rv.max().item():.3e})")
        if quant:
            a, r, b0 = (getattr(c, name + "_qparams") for c in
                        (got, ref_cache, before))
            wq = torch.zeros_like(a, dtype=torch.bool)
            wq[..., :written_all.shape[1]] = written_all[:, None, :]
            check(same(a[~wq], b0[~wq]),
                  f"{what}: {name} qparams changed outside the written "
                  "tokens")
            # [pages, ps, 2*KH] at the written tokens: scale rows even,
            # zero rows odd; both relative to the token's range
            aw, rw = (t.permute(0, 2, 1)[written] for t in (a, r))
            rng_ = rw[:, 0::2] * (255.0 if mode == CacheMode.INT8 else 15.0)
            rel = torch.maximum(
                (aw[:, 0::2] - rw[:, 0::2]).abs() / rw[:, 0::2],
                (aw[:, 1::2] - rw[:, 1::2]).abs() / rng_).amax(-1)
            layer = torch.arange(written.shape[0], device=dev)[:, None] \
                .expand_as(written)[written] % L
            if bool((layer == 0).any()):
                qp_err0 = max(qp_err0, rel[layer == 0].max().item())
            qp_err = max(qp_err, rel.max().item())
            by_layer = [round(rel[layer == l].max().item(), 5)
                        for l in range(L) if bool((layer == l).any())]
            check(qp_err0 <= QPARAM_RTOL and qp_err <= DEEP_QPARAM_RTOL,
                  f"{what}: {name} qparams differ: layer 0 {qp_err0:.2e}, "
                  f"all layers {qp_err:.2e}; by layer {by_layer}")
        written = written_all
    return pool_err, qp_err0, qp_err


def check_megakernel_case(cfg, params, stream, mode, gen, dev,
                          lens=None, inactive=None, nan_fill=False,
                          dtype="bfloat16"):
    """One step (B = 8 unless `lens` says otherwise) through the kernel and
    through the plain version, on clones of one pool: logits of the active
    rows, the written token, and every other pool byte (`nan_fill`: with
    NaN in every element no token < lens owns, `mk_state`; `dtype`
    "float32": an f32 DEFAULT pool, the attention's CUDA-core path)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    if lens is None:
        lens, inactive = MK_LENS, MK_INACTIVE
    B, L = len(lens), cfg.num_layers
    plan, packed = mk_plan_pack(cfg, params, B, mode, dtype)
    st = mk_state(cfg, mode, B, lens, inactive, gen, dev, nan_fill=nan_fill,
                  dtype=dtype)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    before = st["cache"]
    caches = {True: before.clone(), False: before.clone()}
    args = (plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
            st["active"])
    out = {True: mk.decode_megakernel(*args, caches[True])}
    mk.check_status(plan, dev)
    routing = []
    out[False] = mk.decode_megakernel_ref(*args, caches[False],
                                          routing=routing)
    torch.cuda.synchronize()
    what = f"megakernel {stream}/{mode.value}" + (
        f" B={B}" if B != DECODE_BATCH else "") + (
        f" (cached tokens {sum(lens)})" if sum(lens) > 10000 else "") + (
        " NaN past lens" if nan_fill else "") + (
        " f32 pool" if dtype == "float32" else "")
    act = st["active"].clone()
    flips, exempt, planted, budget = [], None, None, None
    if plan.E:
        # each layer's routing of the kernel against the plain version's
        chosen = torch.zeros((L, B, plan.E), dtype=torch.bool, device=dev)
        chosen.scatter_(2, mk.kernel_routing(plan, dev).long(), True)
        budget = max(MAX_FLIPPED_ROWS,
                     math.ceil(MAX_FLIPPED_ROW_SHARE * int(act.sum())))
        flips = flipped_rows(plan, chosen, routing, act, what, budget)
        planted = planted_router_fault(plan, routing, act, what, budget,
                                       SEED + B)
        exempt = torch.zeros(before.k.shape[:2], dtype=torch.bool,
                             device=dev)
        for b, *_ in flips:
            g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
            exempt[g * L:(g + 1) * L, off] = True
            act[b] = False
    got, ref = out[True][act], out[False][act]
    check(bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    check(err <= LOGITS_RTOL * ref_max,
          f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    # equal argmax, unless the plain version itself holds the two
    # candidates closer than twice the measured difference (a tie)
    pick = got.argmax(-1)
    tie = ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]
    same = int((pick == ref.argmax(-1)).sum().item())
    check(bool((tie <= 2 * err).all()), f"{what}: argmax differs")
    # the pool: only the new token's rows may change
    written = torch.zeros(before.k.shape[:2], dtype=torch.bool, device=dev)
    for b in range(B):
        if b == inactive:
            continue
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        written[g * L:(g + 1) * L, off] = True
    pool_err, qp_err0, qp_err = check_written_pool(
        what, mode, caches[True], caches[False], before, written, L, dev,
        exempt, moe=bool(plan.E))
    forced = forced_routing_check(plan, args, caches[True], out[True], before,
                                  written, st, lens, flips, what, dev) \
        if plan.E else None
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}), argmax "
          f"equal {same}/{int(act.sum())}, written payload within "
          f"{pool_err:g} level, qparams rel {qp_err0:.1e} (layer 0) "
          f"{qp_err:.1e} (all layers), rest of the pool "
          "unchanged" + (f"; rows routed differently (row, first layer, "
                         f"logit gap): {flips}, by the planted router "
                         f"fault: {planted} (cap {budget})" if plan.E
                         else ""),
          flush=True)
    return dict(stream=stream, mode=mode.value, B=B, max_abs_err=err,
                ref_max=ref_max, argmax_equal=same, pool_levels=pool_err,
                qparam_rel_layer0=qp_err0, qparam_rel=qp_err,
                flipped_rows=flips, planted_fault_rows=planted,
                forced_routing=forced)


def forced_routing_check(plan, args, got_cache, got, before, written, st,
                         lens, flips, what, dev):
    """The MoE decode branch against its plain version routed as the kernel
    routed each row in each layer (`kernel_routing`): every active row, the
    rows the two route differently (`flips`) included, is held to the
    bounds every other row meets above (logits within LOGITS_RTOL of their
    largest, the written pool rows of every layer by check_written_pool's
    MoE rules), so that a fault in the branch's products or gates cannot
    pass as a router near-tie. One kind of (row, layer) cannot meet them
    with a sound kernel: one whose residual, entering the layer, is still
    near the scale of the row's embedding while the other rows' have grown
    (the RMS of 0.03 against a median of 20 here), so that the layer's
    RMSNorm passes the row's rounding differences (the f32 sums' order, a
    bf16 rounding on the other side of a tie) on with that much more gain.
    A (row, layer) past layer 0 whose K or V differs from the plain
    version's, beyond one and a half of its levels, by more than
    CONDITIONED_RTOL of the row's own range is held to the bounds unless
    the plain version's residual RMS entering that layer is below
    ILL_NORM_SHARE of the median over the active rows; such (row, layer)s
    are printed with the row's profile and not held, for at most
    MAX_FLIPPED_ROWS rows or MAX_FLIPPED_ROW_SHARE of the active rows.
    Returns the readings."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    cf = before.clone()
    norms = []
    ref = mk.decode_megakernel_ref(*args, cf,
                                   forced_routing=mk.kernel_routing(plan, dev),
                                   resid_norms=norms)
    torch.cuda.synchronize()
    return hold_routed_rows(plan.L, plan.KH, plan.kv_mode, got_cache, got,
                            cf, ref, norms, before, written, st, lens, flips,
                            f"{what} (the plain version routed as the "
                            "kernel)", dev)


def hold_routed_rows(L, KH, mode, got_cache, got, cf, ref, norms, before,
                     written, st, lens, flips, what, dev, skip=(),
                     after_ill=False):
    """forced_routing_check's rules for a MoE decode step (`got`,
    `got_cache`: the kernels'; `ref`, `cf`: the step they are held to,
    routed alike; `norms`: its residual RMS entering each layer; KH: the
    pool's KV heads): every active row but those of `skip` (routed
    differently) is held, but ill-conditioned (row, layer)s. `after_ill`
    (the TP MoE forward's check alone) also leaves unheld the layer right
    after an ill-conditioned one, past the rule above: the residual a row
    enters it with is mostly that layer's output, computed from the
    amplified x_norm (the note above TP_MOE_CASES says what backs it)."""
    import torch
    act = st["active"].clone()
    for b in skip:
        act[b] = False
    err = (got[act] - ref[act]).abs().max().item()
    ref_max = ref[act].abs().max().item()
    check(bool(torch.isfinite(got[act]).all()) and
          err <= LOGITS_RTOL * ref_max,
          f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    # [B, L]: the largest K or V difference of a head, dequantized, beyond
    # one and a half of the row's levels, in shares of the row's range
    rows = [b for b in range(len(lens)) if bool(act[b])]
    diff = torch.zeros((len(lens), L), device=dev)
    for b in rows:
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        m = torch.zeros_like(written)
        m[g * L:(g + 1) * L, off] = True
        for name in ("k", "v"):
            val, _, _, _ = written_rows(got_cache, name, m, mode, KH)
            rval, _, rsc, _ = written_rows(cf, name, m, mode, KH)
            lv = 0 if rsc is None else 1.5 * rsc
            d = ((val - rval).abs().amax(-1) - lv).clamp_min(0) / \
                (rval.amax(-1) - rval.amin(-1)).clamp_min(1e-8)
            diff[b] = torch.maximum(diff[b], d.amax(-1))
    norms = torch.stack(norms, 1)                          # [B, L]
    share = norms / norms[rows].median(0).values[None, :]
    low = share < ILL_NORM_SHARE
    if after_ill:
        low[:, 1:] |= low[:, :-1].clone()
    ill = (diff > CONDITIONED_RTOL) & low
    ill[:, 0] = False
    ill_rows = torch.nonzero(ill.any(1))[:, 0].tolist()
    cap = max(MAX_FLIPPED_ROWS, math.ceil(MAX_FLIPPED_ROW_SHARE * len(rows)))
    check(len(ill_rows) <= cap,
          f"{what}: {len(ill_rows)} rows ill-conditioned, at most {cap}: "
          f"{ill_rows}")
    exempt = torch.zeros_like(written)
    for b, l in torch.nonzero(ill).tolist():
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        exempt[g * L + l, off] = True
    for b in skip:
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        exempt[g * L:(g + 1) * L, off] = True
    parted = [b for b in rows if bool((diff[b] > CONDITIONED_RTOL).any())]
    if parted:
        by_row = {b: [(round(d_, 4), round(s_, 4)) for d_, s_ in
                      zip(diff[b].tolist(), share[b].tolist())]
                  for b in parted}
        print(f"{what}: rows whose K / V part by over {CONDITIONED_RTOL} of "
              f"their range somewhere (row: by layer, the difference and the "
              f"residual RMS over the median): {by_row}", flush=True)
    pool = check_written_pool(what, mode, got_cache, cf, before, written, L,
                              dev, exempt, moe=True)
    profile = {b: dict(diff=[round(v, 4) for v in diff[b].tolist()],
                       norm_share=[round(v, 4) for v in share[b].tolist()],
                       not_held=torch.nonzero(ill[b])[:, 0].tolist())
               for b in ill_rows}
    print(f"{what}: every active row held"
          + (f" but {list(skip)} (routed differently)" if skip else "")
          + f" ({len(flips)} routed differently by the kernel and the plain "
          f"version, {[b for b, *_ in flips]}): logits max|d|={err:.3e} "
          f"(ref max {ref_max:.3e}); pool within {pool[0]:g} level in layer "
          f"0, qparams rel {pool[1]:.1e} (layer 0) {pool[2]:.1e} (all "
          f"layers); largest K / V difference of a held (row, layer) "
          f"{float(diff[rows][~ill[rows]].max()):.3e} of the row's range "
          f"beyond 1.5 levels; ill-conditioned rows by layer (difference, "
          f"residual RMS over the median, layers not held): {profile}",
          flush=True)
    return dict(max_abs_err=err, ref_max=ref_max, pool_levels=pool[0],
                qparam_rel_layer0=pool[1], qparam_rel=pool[2],
                held_max=float(diff[rows][~ill[rows]].max()),
                ill_conditioned=profile)


def time_megakernel(cfg, params, stream, B, lens, gen, dev, per_op=True):
    """ms per decode forward (graph replay, CUDA events) through the
    megakernel, through it without its attention phases, and through the
    per-op forward, on the same INT8 state."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import megakernel as mk
    mode = CacheMode.INT8
    plan, packed = mk_plan_pack(cfg, params, B, mode)
    st = mk_state(cfg, mode, B, lens, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)

    def run(skip):
        return mk.decode_megakernel(plan, packed, x0, st["cos"], st["sin"],
                                    st["pt"], st["lens"], st["active"],
                                    st["cache"], skip_attention=skip)

    row = dict(stream=stream, B=B, lens_sum=sum(lens),
               geometry=mk.launch_geometry(plan, dev),
               ms=time_ms(run, [(False,)], iters=5),
               no_attention_ms=time_ms(run, [(True,)], iters=5))
    mk.check_status(plan, dev)
    # at mpad 16 the block's shared memory (the product ring, the attention
    # tiles, the norm slabs) and registers leave two blocks an SM
    geo = row["geometry"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(geo["mpad"] != 16 or geo["grid"] == 2 * sms,
          f"megakernel {stream} B={B}: grid {geo['grid']} at mpad 16, not "
          f"two blocks on each of {sms} SMs")
    # where one launch's time goes: block 0's timestamps, by phase kind
    trace = torch.zeros(mk.trace_len(plan), dtype=torch.int64, device=dev)
    mk.decode_megakernel(plan, packed, x0, st["cos"], st["sin"], st["pt"],
                         st["lens"], st["active"], st["cache"], trace=trace)
    torch.cuda.synchronize()
    row["phases"] = mk.phase_times(plan, trace)
    if per_op:
        row["per_op_ms"] = time_ms(
            lambda: transformer.decode_forward(
                cfg, params, st["tokens"], st["cache"], st["pt"], st["lens"],
                st["active"], mode=mode), [()], iters=3)
    weight_bytes = plan.weight_bytes
    n_w = sum(sp.K * sp.Ntot * (1 if sp.name == "lm" else plan.L)
              for sp in plan.streams if not sp.E)
    if plan.E:
        # what this step's data needs: the experts some row routes to in
        # each layer (the traced launch's routing), k of them a row
        used = [len(set(r.flatten().tolist()))
                for r in mk.kernel_routing(plan, dev)]
        weight_bytes = int(sum(plan.layer_bytes(u) for u in used) +
                           plan.lm.matrix_bytes)
        n_w += plan.L * plan.k_top * sum(sp.K * sp.Ntot for sp in
                                         plan.streams if sp.E)
        row.update(experts_used=used,
                   all_experts_bytes_ms=bounds(plan.weight_bytes, 0)[
                       "bytes_ms"])
    nbytes = (weight_bytes + kv_bytes_read(cfg, mode, lens, [1] * B) +
              B * plan.V * 4)
    ops = 2.0 * B * n_w
    row.update(weight_bytes=weight_bytes, **bounds(nbytes, ops))
    print(f"megakernel {stream} B={B} (cached tokens {sum(lens)}): "
          f"{row['ms']:.3f} ms/step, without attention "
          f"{row['no_attention_ms']:.3f}, byte bound {row['bytes_ms']:.3f}"
          + (f" (routed experts a layer {min(row['experts_used'])}.."
             f"{max(row['experts_used'])}; every expert: "
             f"{row['all_experts_bytes_ms']:.3f})" if plan.E else "")
          + (f", per-op graph {row['per_op_ms']:.3f}" if per_op else "")
          + f"; grid {row['geometry']['grid']}, K splits "
          f"{row['geometry']['splits']}", flush=True)
    print("  phases, ms work+wait (block 0, one traced launch): "
          + ", ".join(f"{k} {v['work']:.2f}+{v['wait']:.2f}"
                      for k, v in row["phases"].items()), flush=True)
    return row


def check_megakernel(params, dev, details):
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.tools import bench_stream
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    i8_params = random_qwen2_7b_params(SEED + 1, dev, stream="i8")
    i8_params["embed_tokens"] = params["embed_tokens"]
    cases, times = [], []
    for stream, p in (("u4", params), ("i8", i8_params)):
        for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
            cases.append(check_megakernel_case(cfg, p, stream, mode, gen,
                                               dev))
    # B = 32: the kernel's two-m-tile instantiation, several norm items a
    # block
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, lens32, 17))
    cases.append(check_megakernel_case(cfg, i8_params, "i8", CacheMode.INT8,
                                       gen, dev, lens32, 17))
    long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
    # B = 1: one live row of the weights-as-A product's first n8 tile; the
    # long-context state (16 chunks of a slot's attention); NaN in every
    # element no token < lens owns, for each KV mode
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, [700], None))
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, long_lens, None))
    for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
        cases.append(check_megakernel_case(cfg, params, "u4", mode, gen, dev,
                                           nan_fill=True))
    # an f32 DEFAULT pool (a float32 runtime): the attention's CUDA-core
    # path, 8-token warp tiles
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.DEFAULT,
                                       gen, dev, nan_fill=True,
                                       dtype="float32"))
    # the plain version's time (one run, host clock around a synchronize)
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, CacheMode.INT8)
    st = mk_state(cfg, CacheMode.INT8, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(plan, packed, x0, st["cos"], st["sin"],
                             st["pt"], st["lens"], st["active"], st["cache"])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    del st, plan, packed
    times.append(time_megakernel(cfg, params, "u4", 8, MK_LENS, gen, dev))
    times.append(time_megakernel(cfg, params, "u4", 8, long_lens, gen, dev))
    times.append(time_megakernel(cfg, params, "u4", 32, lens32, gen, dev))
    times.append(time_megakernel(cfg, i8_params, "i8", 32, lens32, gen, dev,
                                 per_op=False))
    times.append(time_megakernel(cfg, i8_params, "i8", 8, MK_LENS, gen, dev,
                                 per_op=False))
    del i8_params
    torch.cuda.empty_cache()
    replica = bench_stream.measure_replica(DECODE_BATCH, dev, num_layers=4)
    print(f"bench_stream replica (4 layers + lm_head, B={DECODE_BATCH}): "
          f"{replica['ms']:.3f} ms, {replica['gbps']:.0f} GB/s", flush=True)
    details["megakernel"] = dict(cases=cases, times=times, plain_ms=plain_ms,
                                 replica=replica)
    base = times[0]
    print(f"megakernel plain version: {plain_ms:.1f} ms/step", flush=True)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], plain_ms=plain_ms, library_ms=None,
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"))


def check_megakernel_moe(cfg, params, dev, details):
    """The decode megakernel's MoE branch at Qwen1.5-MoE width (G = 1):
    one step against the plain version for the three KV modes at B = 8 and
    at B = 32, then ms per step beside the routed byte bound."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    cases = [check_megakernel_case(cfg, params, "u4 MoE", mode, gen, dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4)]
    drawn = gen.get_state()
    cases.append(check_megakernel_case(cfg, params, "u4 MoE",
                                       CacheMode.DEFAULT, gen, dev))
    # the same DEFAULT state (the same draw) with NaN in every float pool
    # element no token < lens owns (G = 1): what the kernel reads is the
    # state above, so its routing and rows must hold as they did there
    after = gen.get_state()
    gen.set_state(drawn)
    cases.append(check_megakernel_case(cfg, params, "u4 MoE",
                                       CacheMode.DEFAULT, gen, dev,
                                       nan_fill=True))
    gen.set_state(after)
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases.append(check_megakernel_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                       gen, dev, lens32, 17))
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, CacheMode.INT8)
    st = mk_state(cfg, CacheMode.INT8, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(plan, packed, x0, st["cos"], st["sin"],
                             st["pt"], st["lens"], st["active"], st["cache"])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    del st, plan, packed
    times = [time_megakernel(cfg, params, "u4 MoE", 8, MK_LENS, gen, dev),
             time_megakernel(cfg, params, "u4 MoE", 32, lens32, gen, dev,
                             per_op=False)]
    details["megakernel_moe"] = dict(cases=cases, times=times,
                                     plain_ms=plain_ms)
    print(f"megakernel MoE plain version: {plain_ms:.1f} ms/step", flush=True)
    base = times[0]
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], plain_ms=plain_ms, library_ms=None,
                per_op_ms=base["per_op_ms"],
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"),
                flipped_rows=sum(len(c["flipped_rows"]) for c in cases))


# -- the prefill megakernel against its plain version ------------------------

def pmk_plan_pack(cfg, params, bucket, mode):
    """(prefill plan, decode pack) as the runtime makes them."""
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    rt = (RuntimeConfigBuilder("pmk").max_length(2048).max_batch(DECODE_BATCH)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
          .build())
    check(pmk.supports_prefill(cfg, rt, params, bucket),
          "prefill_megakernel.supports_prefill said no")
    dplan = mk.make_plan(cfg, rt, params)
    plan = pmk.make_prefill_plan(cfg, rt, params, bucket, decode_plan=dplan)
    check(pmk.cuda_kernel_gaps(plan) == [], "prefill kernel gaps")
    return plan, mk.pack_params(cfg, dplan, params)


def pmk_inputs(cfg, params, plan, mode, n, gen, dev):
    """A random pool, a request's shuffled logical pages, and the launch's
    inputs for a prompt of n tokens in the plan's bucket."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    L, S = cfg.num_layers, plan.S
    n_logical = 2 * plan.maxPb
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (n_logical + 1) * L + 1, torch.bfloat16, dev)
    for t in (cache.k, cache.v):
        if mode == CacheMode.DEFAULT:
            t.normal_(generator=gen)
        else:
            t.view(torch.uint8).random_(0, 256, generator=gen)
    if mode != CacheMode.DEFAULT:
        for t in (cache.k_qparams, cache.v_qparams):
            t.uniform_(0.5, 1.0, generator=gen)
    pages = (1 + torch.randperm(n_logical, generator=gen, device=dev)
             )[:plan.maxPb].to(torch.int32)
    tokens = torch.zeros(S, dtype=torch.int64, device=dev)
    tokens[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                               device=dev)
    cos, sin = _rope_tiles(cfg, torch.arange(S, device=dev))
    return dict(cache=cache, pages=pages, page_row=pages * L, tokens=tokens,
                x0=params["embed_tokens"]["w"][tokens].to(torch.bfloat16),
                cos=cos, sin=sin,
                n=torch.tensor([n], dtype=torch.int32, device=dev))


def written_rows(cache, name, written, mode, KH):
    """The written token rows of a pool: (dequantized values [R, KH, D],
    levels [R, KH, D], scale [R, KH], zero [R, KH]); for an unquantized pool
    the values twice and no qparams."""
    from dashinfer_tpu_torch.config import CacheMode
    pay = getattr(cache, name)[written]
    lv = kv_levels(pay.reshape(pay.shape[0], KH, -1), mode).float()
    if mode == CacheMode.DEFAULT:
        return lv, lv, None, None
    qp = getattr(cache, name + "_qparams").permute(0, 2, 1)[written]
    sc, ze = qp[:, 0::2], qp[:, 1::2]
    return lv * sc[..., None] + ze[..., None], lv, sc, ze


def check_prefill_pool(what, mode, got, ref, ref32, before, written, cfg,
                       dev, exempt=None):
    """The prefill kernel's pool against its plain version's (`ref`, bf16
    score operands; `ref32`, f32 score operands) on clones of one pool, by
    the tolerances stated above. Returns (levels apart in layer 0, qparams
    rel. difference in layer 0, largest difference of a written row in
    shares of its range, rows passed as ill-conditioned, largest difference
    of such a row, largest difference of a row between the two plain
    versions)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    L, KH = cfg.num_layers, cfg.num_kv_heads
    quant = mode != CacheMode.DEFAULT
    n_levels = {CacheMode.INT8: 255.0, CacheMode.UINT4: 15.0}.get(mode)
    layer0 = (torch.arange(written.shape[0], device=dev)[:, None]
              .expand_as(written)[written] % L) == 0
    # rows of a MoE token that the kernel routed differently (rows of the
    # written mask's order): not held to the tolerances
    held = torch.ones_like(layer0) if exempt is None else \
        ~exempt[written]
    lv_err = qp_err0 = rel_max = plain_max = ill_max = 0.0
    ill = 0
    for name in ("k", "v"):
        names = [name] + ([name + "_qparams"] if quant else [])
        for nm in names:
            a, b0 = getattr(got, nm), getattr(before, nm)
            keep = ~written if nm == name else \
                ~written[:, None, :].expand_as(a)
            check(bool((a[keep] == b0[keep]).all()),
                  f"{what}: {nm} changed outside rows < n of the owned pages")
        check(bool((getattr(got, name)[written] !=
                    getattr(before, name)[written]).any(-1).all()),
              f"{what}: a row < n of {name} was not written")
        val, lv, sc, ze = written_rows(got, name, written, mode, KH)
        rval, rlv, rsc, rze = written_rows(ref, name, written, mode, KH)
        r32 = written_rows(ref32, name, written, mode, KH)[0]
        rng = (rval.amax(-1) - rval.amin(-1)).clamp_min(1e-8)
        rel = (val - rval).abs().amax(-1) / rng * held[:, None]   # [R, KH]
        rel32 = (rval - r32).abs().amax(-1) / rng
        if quant:
            # a check of writes at deeper layers only has no layer-0 rows
            if bool((layer0 & held).any()):
                d0 = (lv - rlv).abs()[layer0 & held]
                lv_err = max(lv_err, d0.max().item())
                q0 = torch.maximum((sc - rsc).abs() / rsc,
                                   (ze - rze).abs() / rng)[layer0 & held]
                qp_err0 = max(qp_err0, q0.max().item())
            check(lv_err <= 1 and qp_err0 <= QPARAM_RTOL,
                  f"{what}: {name} layer 0: payload {lv_err} levels, "
                  f"qparams {qp_err0:.2e}")
            tol = 1.5 / n_levels + PREFILL_POOL_RTOL
        else:
            tol = BF16_STEP + PREFILL_POOL_RTOL
            check(bool((rel[layer0 & held] <= BF16_STEP + QPARAM_RTOL
                        ).all()),
                  f"{what}: {name} layer 0 differs {rel[layer0].max():.2e}")
        over = rel > tol
        bad = over & (rel > 4 * rel32)
        check(not bool(bad.any()),
              f"{what}: {name} rows differ by up to "
              f"{rel[bad].max().item() if bad.any() else 0:.3e} of their "
              f"range ({int(bad.sum())} (row, head) pairs beyond {tol:.3e} "
              "where the two plain versions agree; they differ by "
              f"{rel32[bad].max().item() if bad.any() else 0:.3e} there)")
        check(int(over.sum()) <= ILL_ROWS_MAX,
              f"{what}: {int(over.sum())} (row, head) pairs of {name} beyond "
              f"{tol:.3e} of their range; at most {ILL_ROWS_MAX} may pass as "
              "ill-conditioned")
        ill += int(over.sum())
        if over.any():
            ill_max = max(ill_max, rel[over].max().item())
        rel_max = max(rel_max, rel[~over].max().item())
        plain_max = max(plain_max, rel32.max().item())
    return lv_err, qp_err0, rel_max, ill, ill_max, plain_max


def check_prefill_case(cfg, params, stream, mode, bucket, n, gen, dev,
                       forced=False):
    """One prefill through the kernel and through the plain version (with
    the kernel's bf16 score operands), on clones of one pool: the logits,
    rows < n of the owned pages, and every other pool byte. The plain
    version with the TPU kernel's f32 score operands is read beside it.
    `forced` (a MoE case): the plain version is routed as the kernel routed
    each prompt row in each layer (`kernel_routing`), and every token, the
    ones the two route differently included, is held to those bounds (the
    rule of the MoE decode check, `forced_routing_check`); the tokens
    routed differently are counted and read, not capped, and each must be
    a near-tie of the plain version's router logits (gap <= TIE_LOGIT) or
    ill-conditioned at the layer where it first flips."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    L = cfg.num_layers
    plan, packed = pmk_plan_pack(cfg, params, bucket, mode)
    st = pmk_inputs(cfg, params, plan, mode, n, gen, dev)
    before = st["cache"]
    got_cache, ref_cache = before.clone(), before.clone()
    args = (plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
            st["n"])
    ref32_cache = before.clone()
    got = pmk.prefill_megakernel(*args, got_cache)
    pmk.check_status(dev)
    routes = {True: [], False: []}
    norms = []
    ref = pmk.prefill_megakernel_ref(
        *args, ref_cache, bf16_scores=True, routing=routes[True],
        forced_routing=pmk.kernel_routing(plan, n, dev) if forced else None,
        resid_norms=norms)
    ref32 = pmk.prefill_megakernel_ref(*args, ref32_cache,
                                       routing=routes[False])
    torch.cuda.synchronize()
    what = f"prefill_megakernel {stream}/{mode.value} S={bucket} n={n}"
    check(tuple(got.shape) == (cfg.vocab_size,) and
          bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    # a MoE prompt's tokens that the kernel routed differently from the
    # plain version (and the plain versions from each other) in some layer
    flips, last_flipped, last32_flipped = [], False, False
    written = prompt_written(before, st["pages"], n, L, range(L), dev)
    check(int(written.sum()) == n * L, f"{what}: written mask")
    exempt, planted, budget, ill_tok = None, None, None, None
    if plan.E:
        valid = torch.arange(plan.S, device=dev) < n
        budget = max(MAX_FLIPPED_ROWS, int(MAX_FLIPPED_SHARE * n))
        # forced: every flipped token is held where it first flips, a
        # near-tie of the plain version's router or ill-conditioned there
        # (its residual RMS entering the layer below ILL_NORM_SHARE of the
        # prompt's median, past layer 0: forced_routing_check's rule)
        share = torch.stack(norms)                               # [L, S]
        ill_tok = share / share[:, :n].median(1).values[:, None] < \
            ILL_NORM_SHARE
        ill_tok[0] = False
        flips = flipped_rows(plan, pmk.kernel_gates(plan, dev) > 0,
                             routes[True], valid, what,
                             n if forced else budget,
                             ill=ill_tok if forced else None)
        planted = planted_router_fault(plan, routes[True], valid, what,
                                       budget, SEED + n)
        # the plain version with the TPU kernel's f32 score operands
        chosen = torch.stack([mk.route(plan, lg)[0] > 0
                              for lg in routes[True]])
        flips32 = flipped_rows(plan, chosen, routes[False], valid, what)
        rows = [t for t, *_ in flips]
        last_flipped = n - 1 in rows and not forced
        last32_flipped = n - 1 in [t for t, *_ in flips32]
        exempt = torch.zeros_like(written)
        for t in ([] if forced else rows):
            g = int(st["pages"][t // PAGE])
            exempt[g * L:(g + 1) * L, t % PAGE] = True
        counts = routed_counts_check(plan, dev, routes[True], n, len(rows),
                                     what)
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    err32 = (got - ref32).abs().max().item()
    if not last_flipped:
        check(err <= LOGITS_RTOL * ref_max,
              f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * "
              f"{ref_max:.3e}")
        pick = int(got.argmax())
        check(float(ref.max() - ref[pick]) <= 2 * err,
              f"{what}: argmax differs")
    if not (last_flipped or last32_flipped or forced):
        check(err32 <= F32_SCORES_RTOL * ref_max,
              f"{what}: logits differ from the f32-score plain version by "
              f"{err32:.3e} > {F32_SCORES_RTOL} * {ref_max:.3e}")
    pick = int(got.argmax())
    lv_err, qp_err0, rel_max, ill, ill_max, plain_max = check_prefill_pool(
        what, mode, got_cache, ref_cache, ref32_cache, before, written, cfg,
        dev, exempt)
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}; against "
          f"f32 scores {err32:.3e}), argmax {pick}; layer 0 rows within "
          f"{lv_err:g} level, qparams rel {qp_err0:.1e}; all rows within "
          f"{rel_max:.1e} of their range, but for {ill} ill-conditioned "
          f"(row, head) pairs (up to {ill_max:.1e}; the two plain versions "
          f"differ by up to "
          f"{plain_max:.1e}); rest of the pool unchanged"
          + (f"; tokens routed differently (token, first layer, logit "
             f"gap): {flips}"
             + (" incl. the last: its logits not held" if last_flipped
                else "")
             + (" (the plain version routed as the kernel: every token "
                "held; each flip a near-tie or ill-conditioned where it "
                f"first flips, ill-conditioned: "
                f"{sum(bool(ill_tok[l, t]) for t, l, _ in flips)})"
                if forced else "")
             + f", by the planted router fault: {planted} (cap {budget})"
             if plan.E else ""), flush=True)
    return dict(stream=stream, mode=mode.value, bucket=bucket, n=n,
                flipped_tokens=flips, planted_fault_tokens=planted,
                routed_as_kernel=forced,
                expert_rows=counts.tolist() if plan.E else None,
                max_abs_err=err, max_abs_err_f32_scores=err32,
                ref_max=ref_max, pool_levels_layer0=lv_err,
                qparam_rel_layer0=qp_err0, row_rel_max=rel_max,
                ill_conditioned_rows=ill, ill_row_rel_max=ill_max,
                plain_versions_row_rel_max=plain_max)


def routed_counts_check(plan, dev, logits_plain, n, n_flipped, what):
    """The per-expert row counts the MoE kernel wrote (its expert products
    ran over exactly these rows): each layer's sum is n x k, they are the
    kernel's own routing's (its gates), and they differ from the plain
    router's only by the tokens routed differently (those capped as flips
    above: each moves at most k rows out of and k into other experts).
    Returns the counts [L, E]."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    counts = pmk.kernel_counts(plan, dev).long()
    chosen = (pmk.kernel_gates(plan, dev) > 0)[:, :n]            # [L, n, E]
    check(bool((counts.sum(1) == n * plan.k_top).all()),
          f"{what}: the experts' rows sum to {counts.sum(1).tolist()}, not "
          f"n x k = {n * plan.k_top} in every layer")
    check(bool((counts == chosen.sum(1)).all()),
          f"{what}: the experts' row counts are not the kernel's routing")
    plain = torch.stack([mk.route(plan, lg[:n])[0] > 0
                         for lg in logits_plain])
    moved = (counts - plain.sum(1)).abs().sum(1)                  # [L]
    differ = (chosen != plain).any(-1).sum(1)                     # [L]
    check(bool((moved <= 2 * plan.k_top * differ).all()) and
          int(differ.max()) <= n_flipped,
          f"{what}: the experts' row counts differ from the plain router's "
          f"by {moved.tolist()} rows a layer, beyond the {n_flipped} "
          "tokens routed differently")
    print(f"{what}: the experts' rows a layer sum to n x k = "
          f"{n * plan.k_top}, the plain router's counts in "
          f"{int((moved == 0).sum())} of {plan.L} layers (the rest moved by "
          f"the flipped tokens); experts without rows: "
          f"{int((counts == 0).sum())} (expert, layer) pairs; most rows an "
          f"expert: {int(counts.max())}", flush=True)
    return counts


def skewed_moe_params(params, expert: int, dev):
    """The MoE weights with every prompt row's hidden state sharing one
    direction u (the embedding table + u) and `expert`'s router column
    along u in every layer, so that this expert takes most rows (a router
    skew); the other weights are shared with `params`."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    emb = params["embed_tokens"]["w"]
    u = torch.randn(emb.shape[1], generator=gen, device=dev) * 0.05
    router = params["layers"]["router"]["w"].clone()
    router[:, :, expert] = (0.25 * u / u.norm())[None, :]
    return dict(params,
                embed_tokens={"w": (emb.float() + u).to(emb.dtype)},
                layers=dict(params["layers"], router={"w": router}))


def gate_up_yardstick(cfg, dev, buckets=(128, 1024)):
    """torch.matmul of x [S, hid] bf16 by a bf16 gate|up weight [hid, 2
    inter] (the rate the card's library reaches on the product the
    prefill's gate|up phase computes, with the weight dequantized
    beforehand; a yardstick, never called by the port): ms a call and
    TFLOP/s."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    w = (torch.randn((cfg.hidden_size, 2 * cfg.intermediate_size),
                     generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    out = {}
    for S in buckets:
        x = torch.randn((S, cfg.hidden_size), generator=gen,
                        device=dev).to(torch.bfloat16)
        ms = time_ms(torch.matmul, [(x, w)], iters=20)
        out[str(S)] = dict(ms=ms, tflops=2.0 * S * w.numel() / ms / 1e9)
    del w
    return out


def time_prefill(cfg, params, bucket, gen, dev, trace_it):
    """ms per launch of a full bucket (graph replay, CUDA events) beside its
    bound, the port's per-op `prefill_forward` on the same bucket (eager,
    as serving runs it: CUDA events around two calls after a warm-up, and
    the host's wall time) and the plain version (one run, host clock)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    mode = CacheMode.INT8
    plan, packed = pmk_plan_pack(cfg, params, bucket, mode)
    n = bucket
    st = pmk_inputs(cfg, params, plan, mode, n, gen, dev)
    args = (plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
            st["n"], st["cache"])
    row = dict(bucket=bucket, n=n, geometry=pmk.launch_geometry(plan, dev),
               ms=time_ms(pmk.prefill_megakernel, [args], iters=3))
    pmk.check_status(dev)
    if trace_it:
        trace = torch.zeros(pmk.trace_len(plan), dtype=torch.int64,
                            device=dev)
        pmk.prefill_megakernel(*args, trace=trace)
        torch.cuda.synchronize()
        row["phases"] = pmk.phase_times(plan, trace)

    def per_op():
        transformer.prefill_forward(cfg, params, st["tokens"], st["cache"],
                                    st["pages"], 0, n, mode=mode)

    per_op()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    per_op()
    per_op()
    end.record()
    torch.cuda.synchronize()
    row["per_op_wall_ms"] = 1e3 * (time.perf_counter() - t0) / 2
    row["per_op_ms"] = start.elapsed_time(end) / 2
    t0 = time.perf_counter()
    pmk.prefill_megakernel_ref(*args, bf16_scores=True)
    torch.cuda.synchronize()
    row["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    # each input read once, each output written once: the pack, x0, the
    # rope tiles, the K/V rows written (payload + qparams), the logits
    kv_row = cfg.num_kv_heads * (cfg.head_dim + 8)
    nbytes = (plan.weight_bytes + bucket * plan.hid * 2 +
              2 * bucket * plan.D * 2 + 2 * n * kv_row * plan.L + plan.V * 4)
    row.update(weight_bytes=plan.weight_bytes, operations=plan.operations(n),
               **bounds(nbytes, plan.operations(n)))
    if plan.E:      # the experts' rows: the n x k routed (row, expert)
        counts = pmk.kernel_counts(plan, dev)
        row["routed_rows_per_layer"] = counts.sum(1).tolist()
        row["experts_without_rows"] = int((counts == 0).sum())
    print(f"prefill_megakernel S={bucket} n={n}: {row['ms']:.3f} ms/launch, "
          f"bound {max(row['bytes_ms'], row['ops_ms']):.3f} (bytes "
          f"{row['bytes_ms']:.3f}, operations {row['ops_ms']:.3f}), per-op "
          f"prefill_forward {row['per_op_ms']:.3f} (eager; host wall "
          f"{row['per_op_wall_ms']:.3f}), plain {row['plain_ms']:.1f}; grid "
          f"{row['geometry']['grid']}, K splits {row['geometry']['splits']}, "
          f"scratch {row['geometry']['scratch_bytes'] / 1e6:.0f} MB"
          + (f"; the experts over their routed rows only: "
             f"{row['routed_rows_per_layer'][0]} a layer (n x k), the "
             f"routed operations bound {row['ops_ms']:.3f} ms"
             if plan.E else ""), flush=True)
    if trace_it:
        print("  phases, ms work+wait (block 0, one traced launch): "
              + ", ".join(f"{k} {v['work']:.2f}+{v['wait']:.2f}"
                          for k, v in row["phases"].items()), flush=True)
    return row


def bf16_params(params, layers: int):
    """The first `layers` layers of the u4 model with every weight
    dequantized to a bf16 leaf (the unquantized stream, depth cut: 28 layers
    of bf16 weights are 15 GB)."""
    import torch
    from dashinfer_tpu_torch.ops.linear import dequantize_weight

    def leaf(wd, l=None):
        pick = (lambda t: t) if l is None else (lambda t: t[l])
        return dequantize_weight({k: pick(wd[k])
                                  for k in ("w_q", "scale", "zero")})

    out = {"embed_tokens": params["embed_tokens"], "norm": params["norm"],
           "lm_head": {"w": leaf(params["lm_head"])}, "layers": {}}
    for name, node in params["layers"].items():
        if isinstance(node, dict):
            new = {"w": torch.stack([leaf(node, l) for l in range(layers)])}
            if "b" in node:
                new["b"] = node["b"][:layers]
            out["layers"][name] = new
        else:
            out["layers"][name] = node[:layers]
    return out


def check_prefill_megakernel(params, dev, details):
    import dataclasses
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    i8_params = random_qwen2_7b_params(SEED + 1, dev, stream="i8")
    i8_params["embed_tokens"] = params["embed_tokens"]
    cases = []
    for stream, p in (("u4", params), ("i8", i8_params)):
        for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
            cases.append(check_prefill_case(cfg, p, stream, mode, 128, 100,
                                            gen, dev))
    del i8_params
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    cases.append(check_prefill_case(cfg2, bf16_params(params, 2),
                                    "bf16 (2 layers)", CacheMode.INT8, 128,
                                    100, gen, dev))
    torch.cuda.empty_cache()
    # every other bucket the serving launches (each has K splits and row
    # tiles of its own), at the served prompt lengths and full
    for bucket, n in ((256, 200), (256, 256), (512, 450), (512, 512),
                      (1024, 1000), (1024, 1024)):
        cases.append(check_prefill_case(cfg, params, "u4", CacheMode.INT8,
                                        bucket, n, gen, dev))
    times = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
             for b in (128, 256, 512, 1024)]
    yard = gate_up_yardstick(cfg, dev)
    for t in times:
        if "phases" in t and str(t["bucket"]) in yard:
            y = yard[str(t["bucket"])]
            gu = t["phases"]["gate_up"]["work"] / cfg.num_layers
            print(f"  gate|up at S={t['bucket']}: {gu:.4f} ms a layer in the "
                  f"kernel ({2.0 * t['bucket'] * cfg.hidden_size * 2 * cfg.intermediate_size / gu / 1e9:.0f} "
                  f"TFLOP/s); torch.matmul on the bf16 weight {y['ms']:.4f} ms "
                  f"({y['tflops']:.0f} TFLOP/s, a yardstick)", flush=True)
    details["prefill_megakernel"] = dict(cases=cases, times=times,
                                         gate_up_matmul=yard)
    big = times[-1]
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="bucket 1024, n = 1024", ms=big["ms"],
                plain_ms=big["plain_ms"], library_ms=None,
                per_op_ms=big["per_op_ms"],
                ms_by_bucket={str(t["bucket"]): t["ms"] for t in times},
                gate_up_matmul_ms={k: v["ms"] for k, v in yard.items()},
                bound_ms=max(big["bytes_ms"], big["ops_ms"]),
                bound_by=("bytes" if big["bytes_ms"] >= big["ops_ms"]
                          else "operations"))


def check_prefill_megakernel_moe(cfg, params, dev, details):
    """The prefill megakernel's MoE branch at Qwen1.5-MoE width: one
    prefill of every bucket the MoE serving launches (128 .. 1024, each
    with its own expert batches and K splits) at a served prompt length
    against the plain version, INT8 KV (and UINT4 at bucket 128), a full
    bucket 1024, a prompt of 5 tokens (most experts without a row) and a
    skewed router (one expert in most rows), each with the experts' row
    counts the kernel wrote held to the plain router's; then ms per launch
    of a full bucket beside the routed-operations bound and the per-op
    `prefill_forward`, whose experts run the grouped kernel (the crossover
    that moe_prefill_mega_max_bucket is set from)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    cases = [check_prefill_case(cfg, params, "u4 MoE", mode, 128, 90, gen,
                                dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4)]
    for bucket, n in ((256, 200), (512, 450), (1024, 1000)):
        cases.append(check_prefill_case(cfg, params, "u4 MoE",
                                        CacheMode.INT8, bucket, n, gen, dev))
    # a full bucket 1024 held to the plain version routed as the kernel
    # routed: at this length this random router's near-ties flip more than
    # 5% of the tokens between any tensor-core kernel and the f32 plain
    # version (the every-expert branch too: PERF.md §6), so its tokens
    # routed otherwise are counted, not capped, and each held to be a
    # near-tie or ill-conditioned where it first flips; then a 5-token
    # prompt
    cases.append(check_prefill_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                    1024, 1024, gen, dev, forced=True))
    cases.append(check_prefill_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                    128, 5, gen, dev))
    check(min(sum(r == 0 for r in layer) for layer in cases[-1]
              ["expert_rows"]) >= cfg.moe.num_experts - 5 * cfg.moe
          .num_experts_per_tok, "a 5-token prompt left fewer experts "
          "without rows than it must")
    skew_expert = 7
    skew = skewed_moe_params(params, skew_expert, dev)
    case = check_prefill_case(cfg, skew, "u4 MoE skewed router",
                              CacheMode.INT8, 512, 500, gen, dev)
    share = [layer[skew_expert] / 500 for layer in case["expert_rows"]]
    check(share[0] >= 0.5, f"the skewed router's expert {skew_expert} took "
          f"{share[0]:.2f} of the rows in layer 0, not most")
    print(f"  skewed router: expert {skew_expert} in "
          f"{', '.join(f'{s:.2f}' for s in share)} of the rows by layer",
          flush=True)
    cases.append(case)
    del skew
    times = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
             for b in (128, 256, 512, 1024)]
    details["prefill_megakernel_moe"] = dict(cases=cases, times=times)
    big = times[-1]
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="bucket 1024, n = 1024", ms=big["ms"],
                plain_ms=big["plain_ms"], library_ms=None,
                per_op_ms=big["per_op_ms"],
                ms_by_bucket={str(t["bucket"]): t["ms"] for t in times},
                per_op_ms_by_bucket={str(t["bucket"]): t["per_op_ms"]
                                     for t in times},
                bound_ms=max(big["bytes_ms"], big["ops_ms"]),
                bound_by=("bytes" if big["bytes_ms"] >= big["ops_ms"]
                          else "operations"),
                flipped_tokens=sum(len(c["flipped_tokens"]) for c in cases))


def check_stream_probe(dev, details):
    """csrc/stream_probe.cu through the tool's entry point: every format
    against its plain version, and its rate."""
    from dashinfer_tpu_torch.tools import bench_stream
    bench_stream.counter.reset()
    rows = bench_stream.measure_rates(DECODE_BATCH, dev)
    launches = bench_stream.counter.read()
    rows += bench_stream.measure_rates(32, dev,
                                       formats=("i8_pc", "u4_g128"))
    for r in rows:
        r.update(bounds(r["bytes"], 0 if r["format"] == "copy"
                        else 2.0 * r["B"] * r["K"] * r["N"]))
        print(f"stream_probe {r['format']:8s} B={r['B']:2d} "
              f"{r['bytes'] / 1e6:6.1f} MB err={r['max_abs_err']:.2e} "
              f"ms={r['ms']:.4f} ({r['gbps']:.0f} GB/s) "
              f"bound={r['bytes_ms']:.4f} plain={r['plain_ms']:.3f}"
              + (f"; loads only {r['nodot_ms']:.4f}, dot only "
                 f"{r['noload_ms']:.4f}, compute only "
                 f"{r['computeonly_ms']:.4f}, pipeline only "
                 f"{r['pipeonly_ms']:.4f}" if "nodot_ms" in r else ""),
              flush=True)
        check(r["max_abs_err"] <= KERNEL_RTOL * r["ref_max"],
              f"stream_probe {r['format']} B={r['B']}: max|d| "
              f"{r['max_abs_err']:.3e} vs max|ref| {r['ref_max']:.3e}")
    check(launches > 0, "stream_probe was not launched by measure_rates")
    details["stream_probe"] = rows
    u4 = next(r for r in rows if r["format"] == "u4_g128"
              and r["B"] == DECODE_BATCH)
    # yardstick: one torch.matmul of the same x and a bf16 matrix of the
    # leaf's shape (a dequantized leaf; only the product is timed, as for
    # quant_matmul; 271 MB, so every call reads it from HBM)
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    x = torch.randn((DECODE_BATCH, u4["K"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((u4["K"], u4["N"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    library_ms = time_ms(torch.matmul, [(x, w)], iters=10)
    del w
    print(f"stream_probe u4_g128 B={DECODE_BATCH}: library torch.matmul on "
          f"the bf16 [{u4['K']}, {u4['N']}] leaf {library_ms:.4f} ms",
          flush=True)
    return dict(launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows
                                if r["format"] != "copy"),
                ms=u4["ms"], plain_ms=u4["plain_ms"], library_ms=library_ms,
                bound_ms=max(u4["bytes_ms"], u4["ops_ms"]),
                bound_by="bytes" if u4["bytes_ms"] >= u4["ops_ms"]
                else "operations")


def check_probes(dev, details):
    """csrc/probes.cu through the two tools' entry points: each dequant
    chain's levels exactly equal to the plain version's, its dot within the
    kernels' tolerance, and its time per chunk; each re-layout variant equal
    to the plain version, and its time."""
    from dashinfer_tpu_torch.tools import probe_magic_dequant as pmd
    from dashinfer_tpu_torch.tools import probe_reshape as prs
    out = {}
    pmd.counter.reset()
    rows = pmd.measure(dev)
    launches = pmd.counter.read()
    for r in rows:
        print(f"probe_magic_dequant {r['chain']:9s} exact={r['exact']} dot "
              f"err={r['max_abs_err']:.2e} (ref max {r['ref_max']:.2e}) "
              f"{r['us_per_chunk']:.3f} us/chunk of {pmd.ROWS}x{pmd.HALF} B, "
              f"{r['gbps']:.0f} GB/s of payload; launch {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f}", flush=True)
        check(r["exact"], f"probe_magic_dequant {r['chain']}: levels differ "
              "from the plain version")
        check(r["max_abs_err"] <= KERNEL_RTOL * r["ref_max"],
              f"probe_magic_dequant {r['chain']}: dot max|d| "
              f"{r['max_abs_err']:.3e} vs max|ref| {r['ref_max']:.3e}")
    check(launches > 0, "probe_magic_dequant launched no kernel")
    details["probe_magic_dequant"] = rows
    m16 = next(r for r in rows if r["chain"] == "magic16")
    b = bounds(m16["bytes"], m16["operations"])
    out["probe_magic_dequant"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        shape=f"magic16 chain, {m16['chunks']} chunks", ms=m16["ms"],
        plain_ms=m16["plain_ms"], library_ms=None,
        library_note="no single PyTorch call: unpacking u4 nibbles takes a "
        "shift, a mask and a conversion before the dot",
        us_per_chunk={r["chain"]: r["us_per_chunk"] for r in rows},
        bound_ms=max(b.values()),
        bound_by="bytes" if b["bytes_ms"] >= b["ops_ms"] else "operations")
    prs.counter.reset()
    rows = prs.measure(dev)
    launches = prs.counter.read()
    for r in rows:
        print(f"probe_reshape {r['variant']:5s} equal={r['equal']} "
              f"{1e3 * r['ms']:.2f} us a re-layout of [{prs.B}, "
              f"{prs.H * prs.D}] f32, plain {1e3 * r['plain_ms']:.2f}",
              flush=True)
        check(r["equal"], f"probe_reshape {r['variant']}: differs from the "
              "plain version")
    check(launches > 0, "probe_reshape launched no kernel")
    details["probe_reshape"] = rows
    first = rows[0]
    # yardstick: the one PyTorch call that makes the same layout, F.pad of
    # q.view(B, KH, G, D) with 8 - G zero rows (28 calls in a graph, as the
    # tool times the kernel)
    import torch
    import torch.nn.functional as F
    q = torch.randn((prs.B, prs.H * prs.D), device=dev)
    G = prs.H // prs.KH
    want = prs.relayout_plain(q, prs.KH)
    check(torch.equal(F.pad(q.view(prs.B, prs.KH, G, prs.D),
                            (0, 0, 0, prs.G8 - G)), want),
          "probe_reshape: the F.pad yardstick differs from the plain version")
    library_ms = time_ms(lambda: F.pad(q.view(prs.B, prs.KH, G, prs.D),
                                       (0, 0, 0, prs.G8 - G)), [()], iters=28)
    print(f"probe_reshape library F.pad {1e3 * library_ms:.2f} us a "
          "re-layout", flush=True)
    out["probe_reshape"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        shape=f"variant {first['variant']}", ms=first["ms"],
        plain_ms=first["plain_ms"], library_ms=library_ms,
        us_by_variant={r["variant"]: 1e3 * r["ms"] for r in rows},
        bound_ms=bounds(first["bytes"], 0)["bytes_ms"], bound_by="bytes")
    return out


def check_decode_logits(params, dev, details):
    """One decode step over DECODE_BATCH prefilled slots through the kernels
    and through their plain versions, on clones of one INT8 cache."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    cfg = ModelConfig(**QWEN2_7B)
    mode = CacheMode.INT8
    B, maxP = DECODE_BATCH, 8
    # logical pages 1 .. B*maxP, and the last physical page as the sink
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (B * maxP + 1) * cfg.num_layers + 1,
                            torch.bfloat16, dev)
    g = torch.Generator().manual_seed(11)
    lens = [37, 64, 150, 300, 1, 127, 256, 500]
    pts = torch.zeros((B, maxP), dtype=torch.int32)
    for b, n in enumerate(lens):
        pts[b] = torch.arange(1 + b * maxP, 1 + (b + 1) * maxP)
        S = 1 << max(5, math.ceil(math.log2(n)))
        toks = torch.zeros(S, dtype=torch.int64)
        toks[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=g)
        transformer.prefill_forward(cfg, params, toks.to(dev), cache,
                                    pts[b].to(dev), 0, n, mode=mode)
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=g).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    out = {}
    for use_kernel in (True, False):
        logits, _ = transformer.decode_forward(
            cfg, params, tokens, cache.clone(), pts.to(dev), lens_t, active,
            mode=mode, use_kernel=use_kernel)
        out[use_kernel] = logits
    torch.cuda.synchronize()
    ref = out[False]
    check(bool(torch.isfinite(out[True]).all()) and
          tuple(out[True].shape) == (B, cfg.vocab_size),
          "decode logits not finite / wrong shape")
    err = (out[True] - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    agree = (out[True].argmax(-1) == ref.argmax(-1)).float().mean().item()
    details["decode_logits"] = dict(max_abs_err=err, ref_max=ref_max,
                                    argmax_agreement=agree, lens=lens)
    print(f"decode logits kernels vs plain: max|d|={err:.3e} "
          f"(ref max {ref_max:.3e}), argmax agreement {agree:.2f}",
          flush=True)
    check(err <= LOGITS_RTOL * ref_max,
          f"decode logits differ: {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")

    # where one decode forward's time goes: host wall per step, and the
    # card's kernel time in it (torch.profiler), by kernel
    def step():
        transformer.decode_forward(cfg, params, tokens, cache, pts.to(dev),
                                   lens_t, active, mode=mode)

    step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3 / n
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    details["decode_step_profile"] = dict(
        batch=B, wall_ms=wall_ms, device_busy_ms=busy_ms or None,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_kernels_ms=top)
    print(f"decode forward (B={B}): wall {wall_ms:.2f} ms/step, device busy "
          + (f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%)"
             if busy_ms else "not measured (no device events)"), flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:90]}", flush=True)


# -- tensor parallelism: the segment kernels and TP serving -----------------

# (ranks n, KV mode) of the segment checks: Qwen2-7B at n = 2 (14 query
# heads on 2 KV heads a rank) and n = 4 (7 on 1; q, k, v, the MLP width and
# the vocab shard are widths of 128 mod 256, which the pack pads)
TP_CASES = ((2, "INT8"), (2, "UINT4"), (4, "INT8"))
TP_RANKS = 2            # the served mesh (1, 2)
# The segments against their plain versions: the partials and the logits of
# the active rows within LOGITS_RTOL of their largest (both sides compute
# the same bf16 products in f32 and differ in the order of the sums), the
# residual after `x += add` equal, the pool by check_written_pool's rules
# (one segment at layer 0 sees the plain version's inputs exactly; at the
# last layer the rows are held to the deeper layers' tolerance). The whole
# TP forward against tp_decode_ref, and against the single-device decode
# megakernel on the same weights and state (its pool the ranks' pools side
# by side), the same way.


def tp_setup(cfg, params, n, mode, gen, dev, B=DECODE_BATCH, lens=None,
             inactive=MK_INACTIVE):
    """The ranks' split, plan, packs and pools of a (1, n) mesh whose ranks
    all run on `dev`, and the step's inputs (mk_state's, one pool a rank
    over its KV heads)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.parallel import make_mesh, shard_params
    mode = getattr(CacheMode, mode) if isinstance(mode, str) else mode
    rt = (RuntimeConfigBuilder("tp").max_length(2048).max_batch(B)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
          .mesh(1, n).build())
    mesh = make_mesh((1, n), [dev] * n)
    parts = shard_params(params, cfg, mesh)
    check(tpk.supports_tp(cfg, rt, params, n, local=parts[0]),
          f"supports_tp said no at n = {n}, {mode.value}")
    plan, packs = tpk.make_tp_plan(cfg, rt, parts)
    check(not tpk.cuda_kernel_gaps(plan), f"tp plan: "
          f"{tpk.cuda_kernel_gaps(plan)}")
    cfg_l = tpk.local_config(cfg, n)
    lens = lens or MK_LENS
    states = [mk_state(cfg_l, mode, B, lens, inactive, gen, dev)
              for _ in range(n)]
    st = states[0]
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    return dict(mode=mode, rt=rt, mesh=mesh, parts=parts, plan=plan,
                packs=packs, st=st, caches=[s["cache"] for s in states],
                x0=x0, cfg_l=cfg_l, lens=lens, inactive=inactive)


def tp_written(s, layers, dev):
    """[pages, ps] rows a step writes at `layers` (the active slots')."""
    import torch
    st, L = s["st"], s["plan"].L
    written = torch.zeros(s["caches"][0].k.shape[:2], dtype=torch.bool,
                          device=dev)
    for b, n in enumerate(s["lens"]):
        if b == s["inactive"]:
            continue
        g, off = int(st["pt"][b, n // PAGE]), n % PAGE
        for l in layers:
            written[g * L + l, off] = True
    return written


def held_rows(got, ref, act, what):
    """Rows `act` (a mask or a slice) of a kernel's output within
    LOGITS_RTOL of its plain version's largest there; returns max|d|."""
    got, ref = got[act], ref[act]
    check(bool(torch_isfinite(got)), f"{what}: not finite")
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    check(err <= LOGITS_RTOL * ref_max,
          f"{what}: differs {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    return err


def torch_isfinite(t):
    import torch
    return torch.isfinite(t).all()


def check_argmax(got, ref, act, err, what):
    pick = got[act].argmax(-1)
    tie = ref[act].max(-1).values - ref[act].gather(1, pick[:, None])[:, 0]
    check(bool((tie <= 2 * err).all()), f"{what}: argmax differs")
    return int((pick == ref[act].argmax(-1)).sum().item())


def check_tp_segment_case(cfg, params, n, mode, gen, dev, timing):
    """Each segment kernel of every rank against its plain version, the
    whole TP forward against tp_decode_ref and against the single-device
    decode megakernel; with `timing`, ms per launch and per step."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = tp_setup(cfg, params, n, mode, gen, dev)
    plan, packs, st, caches = s["plan"], s["packs"], s["st"], s["caches"]
    mode, L, B = s["mode"], plan.L, plan.B
    what0 = f"tp n={n} {mode.value}"
    act = st["active"]
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 17 + n)
    errs = dict(attn=0.0, mlp=0.0, lm=0.0)
    for r in range(n):
        add = torch.randn((B, plan.hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            x = s["x0"].float()
            xs = {True: x.clone(), False: x.clone()}
            cs = {True: caches[r].clone(), False: caches[r].clone()}
            out = {True: tpk.tp_attn_segment(plan, packs[r], l, xs[True],
                                             *step, cs[True], add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.attn_segment_ref(plan, packs[r], l, xs[False],
                                              *step, cs[False], add=add)
            what = f"{what0} attn rank {r} layer {l}"
            check(bool((xs[True] == xs[False]).all()),
                  f"{what}: x + add differs")
            errs["attn"] = max(errs["attn"], held_rows(out[True], out[False],
                                                       act, what))
            check_written_pool(what, mode, cs[True], cs[False], caches[r],
                               tp_written(s, (l,), dev), L, dev)
            xs = {True: x.clone(), False: x.clone()}
            out = {True: tpk.tp_mlp_segment(plan, packs[r], l, xs[True],
                                            add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.mlp_segment_ref(plan, packs[r], l, xs[False],
                                             add=add)
            errs["mlp"] = max(errs["mlp"], held_rows(
                out[True], out[False], act, f"{what0} mlp rank {r} layer {l}"))
        xs = {True: s["x0"].float(), False: s["x0"].float()}
        out = {True: tpk.tp_lm_segment(plan, packs[r], xs[True], add=add)}
        tpk.check_status(plan, dev)
        out[False] = tpk.lm_segment_ref(plan, packs[r], xs[False], add=add)
        check(tuple(out[True].shape) == (B, cfg.vocab_size // n),
              f"{what0}: lm shard {tuple(out[True].shape)}")
        errs["lm"] = max(errs["lm"], held_rows(out[True], out[False], act,
                                               f"{what0} lm rank {r}"))
    # the whole forward: CUDA-graph replay of the kernels' forward, against
    # the plain forward and the single-device megakernel on clones of the
    # pools
    torch.cuda.synchronize()
    devices = s["mesh"].devices
    ck = [c.clone() for c in caches]
    cp = [c.clone() for c in caches]

    def fwd():
        return tpk.tp_decode(plan, packs, s["x0"], *step, ck, devices)

    fwd()                           # warm-up: the same writes
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_k = fwd()
    graph.replay()
    tpk.check_status(plan, dev)
    logits_p = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cp, devices)
    torch.cuda.synchronize()
    what = f"{what0} forward"
    f_err = held_rows(logits_k, logits_p, act, what)
    same = check_argmax(logits_k, logits_p, act, f_err, what)
    written = tp_written(s, range(L), dev)
    for r in range(n):
        check_written_pool(f"{what} rank {r}", mode, ck[r], cp[r], caches[r],
                           written, L, dev)
    # the single-device megakernel on the same weights and state: its pool
    # holds every KV head, the ranks' side by side
    plan1, pack1 = mk_plan_pack(cfg, params, B, mode)
    before1 = full_pool(caches)
    c1 = before1.clone()
    logits_1 = mk.decode_megakernel(plan1, pack1, s["x0"], *step, c1)
    mk.check_status(plan1, dev)
    what = f"{what0} forward vs the single-device megakernel"
    m_err = held_rows(logits_k, logits_1, act, what)
    m_same = check_argmax(logits_k, logits_1, act, m_err, what)
    check_written_pool(what, mode, full_pool(ck), c1, before1, written, L,
                       dev)
    row = dict(n=n, mode=mode.value, errs=errs, forward_err=f_err,
               forward_argmax_equal=same, vs_megakernel_err=m_err,
               vs_megakernel_argmax_equal=m_same,
               geometry=tpk.launch_geometry(plan, dev))
    print(f"{what0}: segments max|d| attn {errs['attn']:.3e} mlp "
          f"{errs['mlp']:.3e} lm {errs['lm']:.3e}; forward (graph replay) "
          f"vs plain {f_err:.3e} (argmax equal {same}/{int(act.sum())}), vs "
          f"the single-device megakernel {m_err:.3e} ({m_same}); pools "
          f"held; geometry {row['geometry']}", flush=True)
    if timing:
        row.update(tp_timing(cfg, s, plan1, pack1, c1, step, dev))
    del graph, ck, cp, c1, before1
    return row


def tp_moe_bound(plan, act, dev):
    """(bytes, operations) of rank 0's last moe segment launch of layer 0:
    the global router, the rank's experts that its active rows routed to
    (its routing record), its shared slice, x, the partial."""
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    routed = tpk.kernel_routing(plan, dev, 0)[0]
    rows_of = [int(((routed == e) & act[:, None]).any(-1).sum())
               for e in range(plan.E)]          # rank 0's group: 0 .. E - 1
    shared = [sp for sp in (plan.sgu, plan.sdn) if sp is not None]
    ex = (plan.gu, plan.dn)
    nbytes = plan.rt.matrix_bytes + sum(sp.matrix_bytes for sp in shared) + \
        sum(c > 0 for c in rows_of) * sum(sp.matrix_bytes for sp in ex)
    ops = 2 * plan.B * sum(sp.K * sp.Ntot for sp in [plan.rt] + shared) + \
        2 * sum(rows_of) * sum(sp.K * sp.Ntot for sp in ex)
    return nbytes, ops, sum(c > 0 for c in rows_of)


def tp_timing(cfg, s, plan1, pack1, c1, step, dev):
    """ms per launch of each segment (rank 0, layer 0; graph replay, CUDA
    events) beside its bound and its plain version's time, and ms per step
    of the TP forward beside the single-device megakernel's, the ranks on
    one card. A MoE plan's moe segment is bound by the bytes its timed
    launches' rows route to (`tp_moe_bound`), its forward by the routed
    experts of each layer."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    plan, pk, cache = s["plan"], s["packs"][0], s["caches"][0]
    B, L, n = plan.B, plan.L, s["mesh"].n
    x = s["x0"].float()
    lens, act = s["lens"], [i != s["inactive"] for i in range(B)]
    kv = kv_bytes_read(s["cfg_l"], s["mode"], lens, act) / L
    io = 2 * B * plan.hid * 4
    segs = {
        "attn": (lambda: tpk.tp_attn_segment(plan, pk, 0, x, *step, cache),
                 lambda: tpk.attn_segment_ref(plan, pk, 0, x.clone(), *step,
                                              cache.clone()),
                 plan.qkv.matrix_bytes + plan.o.matrix_bytes + kv + io,
                 2 * B * (plan.qkv.K * plan.qkv.Ntot + plan.o.K *
                          plan.o.Ntot) +
                 4 * plan.H * plan.D * sum(n_ for n_, a in zip(lens, act)
                                           if a))}
    if plan.E:
        active = s["st"]["active"]
        segs["moe"] = (
            lambda: tpk.tp_moe_segment(plan, pk, 0, x, 0, active),
            lambda: tpk.moe_segment_ref(plan, pk, 0, x.clone(), 0), None,
            None)
    else:
        segs["mlp"] = (
            lambda: tpk.tp_mlp_segment(plan, pk, 0, x),
            lambda: tpk.mlp_segment_ref(plan, pk, 0, x.clone()),
            plan.gu.matrix_bytes + plan.dn.matrix_bytes + io,
            2 * B * (plan.gu.K * plan.gu.Ntot + plan.dn.K * plan.dn.Ntot))
    segs["lm"] = (lambda: tpk.tp_lm_segment(plan, pk, x),
                  lambda: tpk.lm_segment_ref(plan, pk, x.clone()),
                  plan.lm.matrix_bytes + B * plan.hid * 4 + B * plan.V * 4,
                  2 * B * plan.lm.K * plan.lm.Ntot)
    traced = {"attn": (tpk.ATTN_SEG_PHASES, lambda t: tpk.tp_attn_segment(
        plan, pk, 0, x, *step, cache, trace=t))}
    if plan.E:
        traced["moe"] = (tpk.MOE_SEG_PHASES, lambda t: tpk.tp_moe_segment(
            plan, pk, 0, x, 0, s["st"]["active"], trace=t))
    out = {}
    for name, (fn, plain, nbytes, ops) in segs.items():
        ms = time_ms(fn, [()], iters=20)
        if name == "moe":
            nbytes, ops, routed = tp_moe_bound(plan, s["st"]["active"], dev)
            nbytes += io
        tpk.check_status(plan, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        b = bounds(nbytes, ops)
        out[name] = dict(ms=ms, plain_ms=1e3 * (time.perf_counter() - t0),
                         bound_ms=max(b["bytes_ms"], b["ops_ms"]),
                         bound_by=("bytes" if b["bytes_ms"] >= b["ops_ms"]
                                   else "operations"),
                         weight_bytes=nbytes - io, **b)
        if name == "moe":
            out[name]["experts_routed"] = routed
        print(f"  tp_{name}_segment (n={n}, rank 0, ranks on one card, "
              f"B={B}): {ms:.4f} ms a launch, bound "
              f"{out[name]['bound_ms']:.4f} ({out[name]['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB" + (
                  f": the router, {routed} of the rank's {plan.E} experts, "
                  "the shared slice" if name == "moe" else "") +
              f"), plain {out[name]['plain_ms']:.1f} ms", flush=True)
        if name in traced:      # block 0's phases in one launch
            names, run = traced[name]
            trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                                device=dev)
            run(trace)
            tpk.check_status(plan, dev)
            out[name]["phases"] = mk.phase_times_of(names, trace)
            print(f"    phases, ms work+wait (block 0, one traced launch): "
                  + ", ".join(f"{k} {v['work']:.4f}+{v['wait']:.4f}"
                              for k, v in out[name]["phases"].items()),
                  flush=True)
    devices = s["mesh"].devices
    caches = s["caches"]
    tp_ms = time_ms(lambda: tpk.tp_decode(plan, s["packs"], s["x0"], *step,
                                          caches, devices), [()], iters=3)
    tpk.check_status(plan, dev)
    mk_ms = time_ms(lambda: mk.decode_megakernel(plan1, pack1, s["x0"], *step,
                                                 c1), [()], iters=3)
    mk.check_status(plan1, dev)
    if plan.E:      # the experts some active row routes to in each layer
        am = s["st"]["active"]
        used = [len(set(r_[am].flatten().tolist()))
                for r_ in tpk.kernel_routing(plan, dev, 0)]
        fwd_bytes = int(sum(plan1.layer_bytes(u) for u in used) +
                        plan1.lm.matrix_bytes)
    else:
        fwd_bytes = n * (L * plan.layer_bytes() + plan.lm.matrix_bytes)
    fwd_bytes += kv_bytes_read(cfg, s["mode"], lens, act)
    print(f"  TP forward (n={n}, the ranks on one card, B={B}): {tp_ms:.3f} "
          f"ms/step ({L * (1 + 1) * n + n} segment launches); single-device "
          f"megakernel {mk_ms:.3f} ms/step; one card's "
          f"{'routed ' if plan.E else ''}byte bound for the whole step "
          f"{1e3 * fwd_bytes / HBM_BYTES_PER_S:.3f} ms", flush=True)
    return dict(segments=out, tp_forward_ms=tp_ms, megakernel_ms=mk_ms,
                forward_bound_ms=1e3 * fwd_bytes / HBM_BYTES_PER_S)


def check_tp_segments(params, dev, details):
    import torch
    from dashinfer_tpu_torch.config import ModelConfig
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    rows = []
    for i, (n, mode) in enumerate(TP_CASES):
        rows.append(check_tp_segment_case(cfg, params, n, mode, gen, dev,
                                          timing=i == 0))
        torch.cuda.empty_cache()
    details["tp_segments"] = rows
    t = rows[0]["segments"]
    return {f"tp_{k}_segment": dict(
        max_abs_err=max(r["errs"][k] for r in rows), ms=t[k]["ms"],
        plain_ms=t[k]["plain_ms"], bound_ms=t[k]["bound_ms"],
        bound_by=t[k]["bound_by"], library_ms=None)
        for k in ("attn", "mlp", "lm")}


def tp_devices(dev):
    """The served mesh's ranks: distinct cards when the machine has as many,
    else every rank on `dev`."""
    import torch
    if torch.cuda.device_count() >= TP_RANKS:
        return [torch.device("cuda", i) for i in range(TP_RANKS)]
    return [dev] * TP_RANKS


def check_serving_tp(params, dev, details, single_tokens):
    """Qwen2-7B on a (1, 2) mesh with serve()'s traffic: every flag at its
    default (decode through the TP segments, the prefills of buckets 128 ..
    1024 through the TP prefill segments), with DI_PREFILL_MEGAKERNEL=0
    (every prefill per-op TP: the serving before the TP prefill segments,
    side by side in one run) and per-op (24 tokens a request); the greedy
    requests' first 8 tokens equal to the single-device serving's on the
    same path (the megakernels' for the first two)."""
    import torch
    from dashinfer_tpu_torch.parallel import collective_kind
    devices = tp_devices(dev)
    print(json.dumps({"tp": {"ranks": TP_RANKS,
                             "cards": torch.cuda.device_count(),
                             "collective": collective_kind(devices)}}),
          flush=True)
    out = {}
    for path, new_tokens in (("tp", 64), ("tp prefill per-op", 64),
                             ("tp per-op", 24)):
        launches, tokens, _ = serve(params, dev, details, path, new_tokens,
                                    devices=devices)
        ref = single_tokens["per-op" if path == "tp per-op"
                            else "megakernel"]
        agree = []
        for i, (a, b) in enumerate(zip(tokens, ref)):
            if i % 2:
                continue                # sampled
            n = min(len(a), len(b))
            same = next((j for j in range(n) if a[j] != b[j]), n)
            agree.append(same)
            print(f"greedy request prompt={PROMPT_LENS[i]}: {path} and "
                  f"single-device serving agree on the first {same} of {n} "
                  "tokens compared", flush=True)
            check(same >= 8, f"greedy request (prompt {PROMPT_LENS[i]}): "
                  f"{path} and single-device serving agree on only {same} "
                  "tokens")
        details[f"greedy_agreement_{path}"] = agree
        out[path] = launches
    summary = {}
    for path in ("tp", "tp prefill per-op"):
        reqs = details[f"serving_qwen2-7b_{path}"]["requests"]
        steps = [r["decode_ms_per_step"] for r in reqs]
        summary[path] = dict(ttft_ms=max(r["ttft_ms"] for r in reqs),
                             ms_per_step=(min(steps), max(steps)))
        print(f"qwen2-7b {path}: TTFT (the six prompts together) "
              f"{summary[path]['ttft_ms']:.1f} ms, decode "
              f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    details["tp_serving_summary"] = summary
    torch.cuda.empty_cache()
    return out


# -- the TP prefill segments --------------------------------------------------

# (ranks, KV mode, (bucket, prompt length) cases): every bucket the serving
# launches at a served length and full for n = 2 with INT8 KV, the smallest
# and the largest bucket with UINT4 and for n = 4 (q 896, k / v 128, MLP
# 4736, vocab 38016: widths of 128 mod 256, padded in the pack)
TP_PREFILL_CASES = (
    (2, "INT8", ((128, 100), (128, 128), (256, 200), (256, 256),
                 (512, 450), (512, 512), (1024, 1000), (1024, 1024))),
    (2, "UINT4", ((128, 100), (1024, 1024))),
    (4, "INT8", ((128, 100), (1024, 1000))))
TP_PREFILL_BUCKETS = (128, 256, 512, 1024)
# The prefill segments against their plain versions run with the kernel's
# bf16 score operands: the o / down partials of the prompt rows and the
# local logits within LOGITS_RTOL of their largest; x + add equal in the
# prompt rows; the kernel's partial zero in the rows after the last row
# tile that holds a prompt row; the pool by check_prefill_pool's rules (the
# plain version with f32 scores beside it for the ill-conditioned rows): a
# segment at layer 0 to the layer-0 bounds, one at the last layer to the
# deeper layers'. The whole TP prefill against tp_prefill_ref, and against
# the single-device prefill megakernel on the same weights and prompt (its
# pool the ranks' pools side by side), by check_prefill_case's rules.


def tp_prefill_rt(n, mode):
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    b = (RuntimeConfigBuilder("tpp").max_length(2048).max_batch(DECODE_BATCH)
         .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16"))
    return (b.mesh(1, n) if n > 1 else b).build()


def tp_prefill_setup(cfg, params, n, dev):
    """The ranks' split trees, the TP decode plan and one pack a rank of a
    (1, n) mesh whose ranks all run on `dev`; the buckets the runtime's TP
    prefill install admits for this model must be 128 .. 1024."""
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.parallel import make_mesh, shard_params
    mesh = make_mesh((1, n), [dev] * n)
    parts = shard_params(params, cfg, mesh)
    rt = tp_prefill_rt(n, CacheMode.INT8)
    tp_plan, packs = tpk.make_tp_plan(cfg, rt, parts)
    qual = [b for b in TP_PREFILL_BUCKETS if tpk.supports_prefill_tp(
        cfg, rt, params, b, n, local=parts[0])]
    plans = tpk.make_tp_prefill_plans(cfg, rt, parts, qual, tp_plan)
    gaps = {b: pmk.cuda_kernel_gaps(p) for b, p in plans.items()}
    check(qual == list(TP_PREFILL_BUCKETS) and not any(gaps.values()),
          f"tp prefill n={n}: the install would prefill buckets {qual} "
          f"through the segments (gaps {gaps}), not 128 .. 1024")
    return dict(n=n, mesh=mesh, parts=parts, tp_plan=tp_plan, packs=packs,
                cfg_l=tpk.local_config(cfg, n))


def tp_prefill_inputs(cfg, params, s, plan, mode, n_tok, gen, dev):
    """pmk_inputs' prompt, pages and RoPE tiles, and one random pool a rank
    over its KV heads."""
    ranks = [pmk_inputs(s["cfg_l"], params, plan, mode, n_tok, gen, dev)
             for _ in range(s["n"])]
    st = ranks[0]
    st["caches"] = [r["cache"] for r in ranks]
    return st


def prompt_written(cache, pages, n, L, layers, dev):
    """[pages, ps] rows a prefill of n tokens writes at `layers`."""
    import torch
    written = torch.zeros(cache.k.shape[:2], dtype=torch.bool, device=dev)
    for j, g in enumerate(pages.tolist()):
        rows = min(PAGE, n - j * PAGE)
        if rows > 0:
            for l in layers:
                written[g * L + l, :rows] = True
    return written


def full_pool(caches):
    """The ranks' pools side by side: the single-device pool's layout."""
    import torch
    from dashinfer_tpu_torch.runtime.kv_cache import KVCache

    def cat(name):
        ts = [getattr(c, name) for c in caches]
        if ts[0] is None:
            return None
        return torch.cat(ts, dim=1 if name.endswith("qparams") else 2)
    return KVCache(*(cat(nm) for nm in ("k", "v", "k_qparams", "v_qparams")))


def check_tp_prefill_case(cfg, params, s, single, mode_name, bucket, n_tok,
                          gen, dev):
    """Each prefill segment kernel of every rank against its plain version
    (layers 0 and L - 1), the whole TP prefill against tp_prefill_ref and
    against the single-device prefill megakernel (`single`: its decode
    plan and pack on the same weights)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    mode = getattr(CacheMode, mode_name)
    n, cfg_l = s["n"], s["cfg_l"]
    rt = tp_prefill_rt(n, mode)
    plan = tpk.make_tp_prefill_plans(cfg, rt, s["parts"], [bucket],
                                     s["tp_plan"])[bucket]
    st = tp_prefill_inputs(cfg, params, s, plan, mode, n_tok, gen, dev)
    S, L, hid = plan.S, plan.L, plan.hid
    rows = -(-n_tok // 128) * 128
    step = (st["cos"], st["sin"], st["page_row"], st["n"])
    what0 = f"tp prefill n={n} {mode.value} S={bucket} n_tok={n_tok}"
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31 + bucket + n)
    errs = dict(attn=0.0, mlp=0.0, lm=0.0)
    pool0 = {}
    for r in range(n):
        pk = s["packs"][r]
        add = torch.randn((S, hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            what = f"{what0} attn rank {r} layer {l}"
            x = st["x0"].float()
            xs = {k: x.clone() for k in ("k", "p", "p32")}
            cs = {k: st["caches"][r].clone() for k in xs}
            out = {"k": tpk.tp_prefill_attn_segment(
                plan, pk, l, xs["k"], *step, cs["k"], add=add)}
            tpk.check_prefill_status(dev)
            for k, bf in (("p", True), ("p32", False)):
                out[k] = tpk.prefill_attn_segment_ref(
                    plan, pk, l, xs[k], *step, cs[k], add=add,
                    bf16_scores=bf)
            check(bool((xs["k"][:rows] == xs["p"][:rows]).all()),
                  f"{what}: x + add differs")
            check(not bool(out["k"][rows:].any()),
                  f"{what}: rows past the prompt's last row tile not zero")
            errs["attn"] = max(errs["attn"], held_rows(
                out["k"], out["p"], slice(0, n_tok), what))
            res = check_prefill_pool(
                what, mode, cs["k"], cs["p"], cs["p32"], st["caches"][r],
                prompt_written(cs["k"], st["pages"], n_tok, L, (l,), dev),
                cfg_l, dev)
            if l == 0:
                pool0[r] = res[:2]
            xs = {k: x.clone() for k in ("k", "p")}
            out = {"k": tpk.tp_prefill_mlp_segment(plan, pk, l, xs["k"],
                                                   st["n"], add=add)}
            tpk.check_prefill_status(dev)
            out["p"] = tpk.prefill_mlp_segment_ref(plan, pk, l, xs["p"],
                                                   st["n"], add=add)
            what = f"{what0} mlp rank {r} layer {l}"
            check(bool((xs["k"][:rows] == xs["p"][:rows]).all()),
                  f"{what}: x + add differs")
            check(not bool(out["k"][rows:].any()),
                  f"{what}: rows past the prompt's last row tile not zero")
            errs["mlp"] = max(errs["mlp"], held_rows(
                out["k"], out["p"], slice(0, n_tok), what))
        xs = {k: st["x0"].float() for k in ("k", "p")}
        lg = {"k": tpk.tp_prefill_lm_segment(plan, pk, xs["k"], st["n"],
                                             add=add)}
        tpk.check_prefill_status(dev)
        lg["p"] = tpk.prefill_lm_segment_ref(plan, pk, xs["p"], st["n"],
                                             add=add)
        what = f"{what0} lm rank {r}"
        check(tuple(lg["k"].shape) == (cfg.vocab_size // n,),
              f"{what}: shard {tuple(lg['k'].shape)}")
        check(bool((xs["k"][n_tok - 1] == xs["p"][n_tok - 1]).all()),
              f"{what}: x + add differs in row n - 1")
        errs["lm"] = max(errs["lm"], held_rows(
            lg["k"][None], lg["p"][None], slice(0, 1), what))
    # the whole prefill, on clones of the ranks' pools
    devices = s["mesh"].devices
    cs = {k: [c.clone() for c in st["caches"]] for k in ("k", "p", "p32")}
    args = (plan, s["packs"], st["x0"], *step)
    logits = {"k": tpk.tp_prefill(*args, cs["k"], devices)}
    tpk.check_prefill_status(dev)
    logits["p"] = tpk.tp_prefill_ref(*args, cs["p"], devices,
                                     bf16_scores=True)
    logits["p32"] = tpk.tp_prefill_ref(*args, cs["p32"], devices)
    torch.cuda.synchronize()
    what = f"{what0} whole prefill"
    f_err = held_rows(logits["k"][None], logits["p"][None], slice(0, 1),
                      what)
    pick = int(logits["k"].argmax())
    check(float(logits["p"].max() - logits["p"][pick]) <= 2 * f_err,
          f"{what}: argmax differs")
    written = prompt_written(cs["k"][0], st["pages"], n_tok, L, range(L),
                             dev)
    ill = 0
    for r in range(n):
        ill += check_prefill_pool(f"{what} rank {r}", mode, cs["k"][r],
                                  cs["p"][r], cs["p32"][r], st["caches"][r],
                                  written, cfg_l, dev)[3]
    # the single-device prefill megakernel on the same weights and prompt
    plan1 = pmk.make_prefill_plan(cfg, tp_prefill_rt(1, mode), params,
                                  bucket, decode_plan=single["dplan"])
    before1 = full_pool(st["caches"])
    c1 = before1.clone()
    logits1 = pmk.prefill_megakernel(plan1, single["pack"], st["x0"], *step,
                                     c1)
    pmk.check_status(dev)
    what = f"{what0} whole prefill vs the single-device prefill megakernel"
    m_err = held_rows(logits["k"][None], logits1[None], slice(0, 1), what)
    check(float(logits1.max() - logits1[pick]) <= 2 * m_err,
          f"{what}: argmax differs")
    m_pool = check_prefill_pool(what, mode, full_pool(cs["k"]), c1,
                                full_pool(cs["p32"]), before1, written, cfg,
                                dev)
    row = dict(n=n, mode=mode.value, bucket=bucket, n_tokens=n_tok,
               errs=errs, layer0_pool=pool0, whole_err=f_err,
               whole_ref_max=logits["p"].abs().max().item(),
               whole_ill_conditioned=ill, vs_megakernel_err=m_err,
               vs_megakernel_pool=m_pool[:4],
               geometry=tpk.prefill_launch_geometry(plan, dev))
    print(f"{what0}: segments max|d| attn {errs['attn']:.3e} mlp "
          f"{errs['mlp']:.3e} lm {errs['lm']:.3e}; whole prefill vs plain "
          f"{f_err:.3e} (ref max {row['whole_ref_max']:.3e}), vs the "
          f"single-device prefill megakernel {m_err:.3e}; pools held "
          f"({ill} ill-conditioned (row, head) pairs); geometry "
          f"{row['geometry']}", flush=True)
    return row, (plan, plan1, st)


def tp_prefill_timing(cfg, params, s, single, case, dev):
    """ms per launch of each prefill segment (rank 0, layer 0, a full
    bucket; graph replay, CUDA events) beside its bound and its plain
    version's time; the whole TP prefill by graph replay (device) and
    eagerly (host wall: what serving pays) beside the single-device
    prefill megakernel and the per-op TP prefill on the same prompt."""
    import torch
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    plan, plan1, st = case
    n, S, L = s["n"], plan.S, plan.L
    n_tok = int(st["n"].item())
    pk, cache = s["packs"][0], st["caches"][0]
    step = (st["cos"], st["sin"], st["page_row"], st["n"])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 41)
    x = st["x0"].float()
    add = torch.randn((S, plan.hid), generator=g, device=dev) * 0.5
    io = 3 * S * plan.hid * 4      # x read and written, add read
    kv = 2 * n_tok * plan.KH * ({8: plan.D + 8, 4: plan.D // 2 + 8}.get(
        plan.kv_bits, 2 * plan.D))
    attn_ops = 2 * n_tok * (plan.qkv.K * plan.qkv.Ntot + plan.o.K *
                            plan.o.Ntot) + \
        2.0 * plan.H * plan.D * n_tok * (n_tok + 1)
    segs = {
        "attn": (lambda: tpk.tp_prefill_attn_segment(plan, pk, 0, x, *step,
                                                     cache, add=add),
                 lambda: tpk.prefill_attn_segment_ref(
                     plan, pk, 0, x.clone(), *step, cache.clone(), add=add,
                     bf16_scores=True),
                 plan.qkv.matrix_bytes + plan.o.matrix_bytes + io + kv +
                 S * plan.hid * 4 + 2 * S * plan.D * 2, attn_ops),
        "mlp": (lambda: tpk.tp_prefill_mlp_segment(plan, pk, 0, x, st["n"],
                                                   add=add),
                lambda: tpk.prefill_mlp_segment_ref(plan, pk, 0, x.clone(),
                                                    st["n"], add=add),
                plan.gu.matrix_bytes + plan.dn.matrix_bytes + io +
                S * plan.hid * 4,
                2 * n_tok * (plan.gu.K * plan.gu.Ntot + plan.dn.K *
                             plan.dn.Ntot)),
        "lm": (lambda: tpk.tp_prefill_lm_segment(plan, pk, x, st["n"],
                                                 add=add),
               lambda: tpk.prefill_lm_segment_ref(plan, pk, x.clone(),
                                                  st["n"], add=add),
               plan.lm.matrix_bytes + 3 * plan.hid * 4 + plan.V * 4,
               2 * plan.lm.K * plan.lm.Ntot),
    }
    out = {}
    for name, (fn, plain, nbytes, ops) in segs.items():
        ms = time_ms(fn, [()], iters=10)
        tpk.check_prefill_status(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        b = bounds(nbytes, ops)
        out[name] = dict(ms=ms, plain_ms=1e3 * (time.perf_counter() - t0),
                         bound_ms=max(b["bytes_ms"], b["ops_ms"]),
                         bound_by=("bytes" if b["bytes_ms"] >= b["ops_ms"]
                                   else "operations"),
                         nbytes=nbytes, operations=ops, **b)
        print(f"  tp_prefill_{name}_segment (n={n}, S={S}, n_tok={n_tok}, "
              f"rank 0, ranks on one card): {ms:.4f} ms a launch, bound "
              f"{out[name]['bound_ms']:.4f} ({out[name]['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP), plain "
              f"{out[name]['plain_ms']:.1f} ms", flush=True)
    devices = s["mesh"].devices
    caches = st["caches"]

    def whole():
        return tpk.tp_prefill(plan, s["packs"], st["x0"], *step, caches,
                              devices)

    tp_ms = time_ms(whole, [()], iters=3)
    tpk.check_prefill_status(dev)
    whole()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole()
    whole()
    torch.cuda.synchronize()
    tp_wall = 1e3 * (time.perf_counter() - t0) / 2
    c1 = full_pool(caches)
    mk_ms = time_ms(lambda: pmk.prefill_megakernel(
        plan1, single["pack"], st["x0"], *step, c1), [()], iters=3)
    pmk.check_status(dev)
    from dashinfer_tpu_torch.config import CacheMode

    def per_op():
        transformer.tp_prefill_forward(
            cfg, s["parts"], st["tokens"], caches, st["pages"], 0, n_tok,
            mode=CacheMode.INT8, devices=devices)

    per_op()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    per_op()
    per_op()
    end.record()
    torch.cuda.synchronize()
    op_wall = 1e3 * (time.perf_counter() - t0) / 2
    op_ms = start.elapsed_time(end) / 2
    b1 = bounds(plan1.weight_bytes, plan1.operations(n_tok))
    row = dict(bucket=S, n_tokens=n_tok, segments=out, tp_prefill_ms=tp_ms,
               tp_prefill_wall_ms=tp_wall, megakernel_ms=mk_ms,
               per_op_tp_ms=op_ms, per_op_tp_wall_ms=op_wall,
               bound_ms=max(b1["bytes_ms"], b1["ops_ms"]),
               launches=2 * L * n + n)
    print(f"  TP prefill (n={n}, the ranks on one card, S={S}): "
          f"{tp_ms:.3f} ms by graph replay, {tp_wall:.3f} ms eager (host "
          f"wall), {row['launches']} segment launches; single-device "
          f"prefill megakernel {mk_ms:.3f} ms; per-op TP prefill "
          f"{op_ms:.3f} ms (eager; host wall {op_wall:.3f}); bound of the "
          f"whole prefill on one card {row['bound_ms']:.3f} ms", flush=True)
    return row


def check_tp_prefill(params, dev, details):
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import megakernel as mk
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    dplan = mk.make_plan(cfg, tp_prefill_rt(1, CacheMode.INT8), params)
    single = dict(dplan=dplan, pack=mk.pack_params(cfg, dplan, params))
    rows, times = [], []
    for n, mode, cases in TP_PREFILL_CASES:
        s = tp_prefill_setup(cfg, params, n, dev)
        for bucket, n_tok in cases:
            row, case = check_tp_prefill_case(cfg, params, s, single, mode,
                                              bucket, n_tok, gen, dev)
            rows.append(row)
            if n == 2 and mode == "INT8" and n_tok == bucket:
                times.append(tp_prefill_timing(cfg, params, s, single, case,
                                               dev))
            del case
        del s
        torch.cuda.empty_cache()
    del single
    torch.cuda.empty_cache()
    details["tp_prefill"] = dict(cases=rows, times=times)
    big = times[-1]["segments"]
    return {f"tp_prefill_{k}_segment": dict(
        max_abs_err=max(r["errs"][k] for r in rows),
        shape="n = 2, rank 0, layer 0, bucket 1024, n = 1024",
        ms=big[k]["ms"], plain_ms=big[k]["plain_ms"],
        bound_ms=big[k]["bound_ms"], bound_by=big[k]["bound_by"],
        library_ms=None,
        ms_by_bucket={str(t["bucket"]): t["segments"][k]["ms"]
                      for t in times})
        for k in ("attn", "mlp", "lm")}


# -- the TP MoE segment (Qwen1.5-MoE on a model axis) -------------------------

# (ranks, KV mode, B): n = 2 with INT8 and UINT4 KV at B = 8 (the MoE
# megakernel check's lens, one slot inactive), INT8 at B = 32 (the kernel's
# two-m-tile instantiation), n = 4 with INT8 at B = 8 (15 experts, a shared
# slice of 1408 and a vocab shard of 37984 a rank: widths the pack pads,
# four KV heads a rank)
TP_MOE_CASES = ((2, "INT8", 8), (2, "UINT4", 8), (2, "INT8", 32),
                (4, "INT8", 8))
# The moe segment against its plain version: per rank at layers 0 and 23 on
# x0 + a random `add`, the partial of the active rows within LOGITS_RTOL of
# its largest with the plain version routed as the kernel routed (its
# routing record) and x + add equal; the rows the kernel routes otherwise
# than the unforced plain version are counted and capped as the MoE
# megakernel's (near-ties of the plain router), the others held unforced
# too. The whole TP forward (CUDA graph replay) against `tp_decode_ref`
# routed as the kernel (every active row held but ill-conditioned (row,
# layer)s: forced_routing_check's rules, and here also the layer right
# after an ill-conditioned one, `after_ill`) and unforced (flips capped,
# each a near-tie of the plain router or ill-conditioned where it first
# flips; a planted router fault must fail the caps; the rest held), and
# against the single-device MoE decode megakernel on the same weights and
# state (rows the two kernels route differently capped as flips and exempt,
# the rest held by forced_routing_check's rules); every rank records the
# same routing.
# What backs the two TP-only widenings: row 29 of the B = 32 state enters
# layers 2-6 with a residual RMS of 0.004-0.011 of the median; the kernel
# routes it otherwise at layer 6 (plain gap 0.463) and its K / V part from
# the plain version's by 0.089 / 0.660 / 0.133 of its range at layers 5 /
# 6 / 7. `python -m dashinfer_tpu_torch.tools.moe_drift --tp` on this state
# read: the plain version itself, with one element of each row of x0 one
# bf16 step up, moves row 29 by 0.189 / 1.298 / 1.357 there and routes it
# otherwise from layer 5 on (gap 0.753); the single-device plain version
# (the same function summed in another order) parts from the TP plain
# version on it at layers 5-6 (0.006 / 0.039) and nowhere else; each
# segment launched on the plain version's own inputs, layer by layer,
# gives row 29's partials within 2e-4 of their largest, as every other
# row's (up to 9e-4), and routes every row as the plain router.


def tp_moe_flips(gplan, routed, routing, act, what, seed=None, ill=None):
    """Rows a kernel's routing ([L, B, k] global ids) sends otherwise than
    the plain version's router products (`routing`), capped as the MoE
    megakernel's; with a `seed`, a planted router fault must fail the caps
    (over a whole forward's layers: one layer's few rows may not flip)."""
    import torch
    L, B = routed.shape[:2]
    chosen = torch.zeros((L, B, gplan.E), dtype=torch.bool,
                         device=routed.device)
    chosen.scatter_(2, routed.long(), True)
    budget = max(MAX_FLIPPED_ROWS,
                 math.ceil(MAX_FLIPPED_ROW_SHARE * int(act.sum())))
    flips = flipped_rows(gplan, chosen, routing, act, what, budget, ill=ill)
    planted = None if seed is None else planted_router_fault(
        gplan, routing, act, what, budget, seed, ill)
    return chosen, flips, planted, budget


def tp_moe_setup(cfg, params, n, mode, B, gen, dev):
    """tp_setup for a TP_MOE_CASES case: B = 8 with the MoE megakernel
    check's lens, B = 32 with longer ones and slot 17 inactive."""
    if B == DECODE_BATCH:
        lens, inactive = MK_LENS, MK_INACTIVE
    else:
        lens, inactive = [(37 + 61 * i) % 1500 + 1 for i in range(B)], 17
    return tp_setup(cfg, params, n, mode, gen, dev, B=B, lens=lens,
                    inactive=inactive)


def check_tp_moe_case(cfg, params, n, mode, B, gen, dev, timing):
    """The moe segment of every rank against its plain version, the whole
    TP forward against tp_decode_ref and the single-device MoE megakernel;
    with `timing`, ms per launch of the moe segment and per TP step."""
    import dataclasses
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = tp_moe_setup(cfg, params, n, mode, B, gen, dev)
    lens = s["lens"]
    plan, packs, st, caches = s["plan"], s["packs"], s["st"], s["caches"]
    mode, L = s["mode"], plan.L
    E_g = cfg.moe.num_experts
    check(plan.E == E_g // n and plan.E_global == E_g and
          not tpk.cuda_kernel_gaps(plan),
          f"tp MoE plan: E {plan.E}/{plan.E_global}, gaps "
          f"{tpk.cuda_kernel_gaps(plan)}")
    gplan = dataclasses.replace(plan, E=E_g)        # routes over all experts
    what0 = f"tp MoE n={n} {mode.value} B={B}"
    act = st["active"]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31 + n + B)
    err, attn_err, seg_flips = 0.0, 0.0, 0
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    for r in range(n):
        add = torch.randn((B, plan.hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            # the attn segment at this model's shapes (16 KV heads over the
            # ranks), as check_tp_segment_case holds it
            what = f"{what0} attn rank {r} layer {l}"
            x = s["x0"].float()
            xs = {True: x.clone(), False: x.clone()}
            cs_ = {True: caches[r].clone(), False: caches[r].clone()}
            out = {True: tpk.tp_attn_segment(plan, packs[r], l, xs[True],
                                             *step, cs_[True], add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.attn_segment_ref(plan, packs[r], l, xs[False],
                                              *step, cs_[False], add=add)
            check(bool((xs[True] == xs[False]).all()),
                  f"{what}: x + add differs")
            attn_err = max(attn_err, held_rows(out[True], out[False], act,
                                               what))
            check_written_pool(what, mode, cs_[True], cs_[False], caches[r],
                               tp_written(s, (l,), dev), L, dev)
            del cs_
            what = f"{what0} moe rank {r} layer {l}"
            xs = {k: x.clone() for k in ("k", "p", "f")}
            out_k = tpk.tp_moe_segment(plan, packs[r], l, xs["k"], r, act,
                                       add=add)
            tpk.check_status(plan, dev)
            routed = tpk.kernel_routing(plan, dev, r)[l].clone()
            routing = []
            out_p = tpk.moe_segment_ref(plan, packs[r], l, xs["p"], r,
                                        add=add, routing=routing)
            out_f = tpk.moe_segment_ref(plan, packs[r], l, xs["f"], r,
                                        add=add, forced_routing=routed)
            torch.cuda.synchronize()
            check(bool((xs["k"] == xs["p"]).all()), f"{what}: x + add "
                  "differs")
            err = max(err, held_rows(out_k, out_f, act,
                                     f"{what} (the plain version routed as "
                                     "the kernel)"))
            _, flips, _, _ = tp_moe_flips(gplan, routed[None], routing, act,
                                          what)
            held = act.clone()
            for b, *_ in flips:
                held[b] = False
            held_rows(out_k, out_p, held, what)
            seg_flips += len(flips)
    # the whole forward: CUDA-graph replay of the kernels' forward (the
    # pools are cloned one check at a time: B = 32's are 6.4 GB a copy)
    devices = s["mesh"].devices
    ck = [c.clone() for c in caches]

    def fwd():
        return tpk.tp_decode(plan, packs, s["x0"], *step, ck, devices)

    fwd()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_k = fwd()
    graph.replay()
    tpk.check_status(plan, dev)
    logits_k = logits_k.clone()
    del graph
    routed = [tpk.kernel_routing(plan, dev, r).clone() for r in range(n)]
    check(all(bool((rt_ == routed[0]).all()) for rt_ in routed),
          f"{what0}: the ranks routed differently")
    what = f"{what0} forward"
    written = tp_written(s, range(L), dev)
    before = full_pool(caches)
    kfull = full_pool(ck)
    del ck
    # routed as the kernel: every active row held (forced_routing_check's
    # rules)
    cf = [c.clone() for c in caches]
    norms = []
    ref = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cf, devices,
                            forced_routing=routed[0], resid_norms=norms)
    torch.cuda.synchronize()
    ffull = full_pool(cf)
    del cf
    failed = []
    try:
        forced = hold_routed_rows(L, cfg.num_kv_heads, mode, kfull,
                                  logits_k, ffull, ref, norms, before,
                                  written, st, lens, [],
                                  f"{what} (the plain version routed as the "
                                  "kernel)", dev, after_ill=True)
    except SmokeFailure as e:         # reported after the checks below
        failed.append(e)
        forced = None
    del ffull
    # [L, B]: a layer past layer 0 that a row enters with its residual RMS
    # below ILL_NORM_SHARE of the median
    rows = [b for b in range(B) if bool(act[b])]
    share = torch.stack(norms)
    ill = share / share[:, rows].median(1).values[:, None] < ILL_NORM_SHARE
    ill[0] = False
    # unforced: the rows the kernel routes otherwise capped, the rest held
    cp = [c.clone() for c in caches]
    routing = []
    logits_p = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cp, devices,
                                 routing=routing)
    del cp
    chosen, flips, planted, budget = tp_moe_flips(
        gplan, routed[0], routing, act, what, SEED + 43, ill)
    held = act.clone()
    for b, *_ in flips:
        held[b] = False
    f_err = held_rows(logits_k, logits_p, held, what)
    # the single-device MoE megakernel on the same weights and state
    plan1, pack1 = mk_plan_pack(cfg, params, B, mode)
    c1 = before.clone()
    logits_1 = mk.decode_megakernel(plan1, pack1, s["x0"], *step, c1)
    mk.check_status(plan1, dev)
    chosen1 = torch.zeros_like(chosen)
    chosen1.scatter_(2, mk.kernel_routing(plan1, dev).long(), True)
    what1 = f"{what0} forward vs the single-device megakernel"
    flips1 = flipped_rows(gplan, chosen, routing, act, what1, budget,
                          chosen_ref=chosen1, ill=ill)
    vs1 = hold_routed_rows(L, cfg.num_kv_heads, mode, kfull, logits_k, c1,
                           logits_1, norms, before, written, st, lens,
                           flips1, what1, dev, skip=[b for b, *_ in flips1])
    if failed:
        raise failed[0]
    kept = act.clone()
    for b, *_ in flips1:
        kept[b] = False
    m_same = check_argmax(logits_k, logits_1, kept, vs1["max_abs_err"],
                          what1)
    row = dict(n=n, mode=mode.value, B=B, segment_err=err,
               attn_segment_err=attn_err, segment_flips=seg_flips,
               forward_err=f_err, forward_flips=flips,
               forward_planted=planted, forced=forced,
               vs_megakernel=vs1, vs_megakernel_flips=flips1,
               vs_megakernel_argmax_equal=m_same,
               geometry=tpk.launch_geometry(plan, dev))
    print(f"{what0}: attn segment max|d| {attn_err:.3e}, moe segment "
          f"max|d| {err:.3e} (routed as the kernel; {seg_flips} rows routed "
          f"otherwise by the unforced plain version over the ranks and "
          f"layers); forward (graph replay) vs plain {f_err:.3e} (flips "
          f"{flips}, planted {planted}), routed as the kernel "
          f"{forced['max_abs_err']:.3e}, vs the single-device megakernel "
          f"{vs1['max_abs_err']:.3e} (rows routed otherwise {flips1}, "
          f"argmax equal {m_same}); geometry {row['geometry']}", flush=True)
    del kfull, before
    if timing:
        row.update(tp_timing(cfg, s, plan1, pack1, c1, step, dev))
    del c1, pack1
    return row


def check_tp_moe(cfg, params, dev, details):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    rows = []
    for i, (n, mode, B) in enumerate(TP_MOE_CASES):
        rows.append(check_tp_moe_case(cfg, params, n, mode, B, gen, dev,
                                      timing=i == 0))
        torch.cuda.empty_cache()
    details["tp_moe"] = rows
    t = rows[0]["segments"]["moe"]
    return dict(max_abs_err=max(r["segment_err"] for r in rows),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None,
                shape="n = 2, rank 0, layer 0, B = 8, INT8",
                tp_forward_ms=rows[0]["tp_forward_ms"],
                megakernel_ms=rows[0]["megakernel_ms"])


def check_serving_tp_moe(params, cfg, dev, details, single_tokens):
    """Qwen1.5-MoE on a (1, 2) mesh with serve()'s traffic: every flag at
    its default (decode through the attn and moe segments, every prefill
    per-op TP with the ranks' experts through the grouped kernel) and
    per-op (24 tokens a request); the greedy requests' first 8 tokens equal
    to the single-device MoE serving's on the same path in the same run
    (for the default flags the single-device serving whose prefills are
    per-op too: DI_PREFILL_MEGAKERNEL=0)."""
    import torch
    devices = tp_devices(dev)
    out = {}
    for path, new_tokens, ref in (("tp", 64, "megakernel prefill per-op"),
                                  ("tp per-op", 24, "per-op")):
        launches, tokens, _ = serve(params, dev, details, path, new_tokens,
                                    cfg, devices=devices)
        for i, (a, b) in enumerate(zip(tokens, single_tokens[ref])):
            if i % 2:
                continue                # sampled
            n = min(len(a), len(b))
            same = next((j for j in range(n) if a[j] != b[j]), n)
            print(f"MoE greedy request prompt={PROMPT_LENS[i]}: {path} and "
                  f"single-device serving ({ref}) agree on the first {same} "
                  f"of {n} tokens compared", flush=True)
            check(same >= 8, f"MoE greedy request (prompt "
                  f"{PROMPT_LENS[i]}): {path} and single-device serving "
                  f"agree on only {same} tokens")
        out[path] = launches
    reqs = details["serving_qwen1.5-moe_tp"]["requests"]
    steps = [r["decode_ms_per_step"] for r in reqs]
    details["tp_moe_serving_summary"] = dict(
        ttft_ms=max(r["ttft_ms"] for r in reqs),
        ms_per_step=(min(steps), max(steps)))
    print(f"qwen1.5-moe tp: TTFT (the six prompts together) "
          f"{max(r['ttft_ms'] for r in reqs):.1f} ms, decode "
          f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    torch.cuda.empty_cache()
    return out

PHASES = ("quant_matmul", "paged_attention", "grouped_quant_matmul",
          "stream_probe", "probes", "megakernel", "prefill_megakernel",
          "serve", "decode_logits", "tp_segments", "tp_prefill", "serve_tp",
          "tp_moe", "serve_tp_moe")
MOE_PHASES = ("megakernel", "prefill_megakernel", "serve", "tp_moe",
              "serve_tp_moe")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", help="write per-shape results as JSON here")
    ap.add_argument("--only", help="comma-separated subset of "
                    f"{', '.join(PHASES)} (after the build); prints no "
                    "final result line")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else PHASES
    if any(p not in PHASES for p in only):
        ap.error(f"--only takes {PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dashinfer_tpu_torch.ops import kernel_build
    except ImportError as e:
        print(f"chip_smoke: the dashinfer_tpu_torch package is missing "
              f"({e})", file=sys.stderr)
        return 3

    dev = torch.device("cuda", 0)
    details, res = {}, {}
    t_start = time.monotonic()

    def phase(name, part=""):
        if name in only:
            print(f"-- {name}{part} (t = {time.monotonic() - t_start:.0f} "
                  "s)", flush=True)
        return name in only

    try:
        with torch.no_grad():
            name = torch.cuda.get_device_name(0)
            smi = nvidia_smi_line()
            print(f"device: {name} | nvidia-smi: {smi} | torch "
                  f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
            t0 = time.monotonic()
            secs = kernel_build.build()
            print(f"kernels built in {time.monotonic() - t0:.1f} s "
                  f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})",
                  flush=True)
            details.update(device=name, nvidia_smi=smi,
                           build_s=secs, build_logs=kernel_build.build_logs)

            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            if phase("quant_matmul"):
                res["quant_matmul"] = check_quant_matmul(gen, dev, details)
            if phase("paged_attention"):
                res["paged_attention"] = check_paged_attention(gen, dev,
                                                               details)
            if phase("grouped_quant_matmul"):
                res["grouped_quant_matmul"] = check_grouped_quant_matmul(
                    dev, details)
            if phase("stream_probe"):
                res["stream_probe"] = check_stream_probe(dev, details)
            if phase("probes"):
                res.update(check_probes(dev, details))
            params = random_qwen2_7b_params(SEED, dev)
            if phase("megakernel"):
                res["decode_megakernel"] = check_megakernel(params, dev,
                                                            details)
            if phase("prefill_megakernel"):
                res["prefill_megakernel"] = check_prefill_megakernel(
                    params, dev, details)
            single_tokens = None
            if phase("serve"):
                mk_launches, op_launches, po_launches, single_tokens = \
                    check_serving(params, dev, details)
            if phase("decode_logits"):
                check_decode_logits(params, dev, details)
            if phase("tp_segments"):
                res.update(check_tp_segments(params, dev, details))
            if phase("tp_prefill"):
                res.update(check_tp_prefill(params, dev, details))
            if phase("serve_tp"):
                if single_tokens is None:     # --only without serve
                    single_tokens = {p: serve(params, dev, details, p, n)[1]
                                     for p, n in (("megakernel", 64),
                                                  ("per-op", 24))}
                tp_launches = check_serving_tp(params, dev, details,
                                               single_tokens)
            # the MoE slice, on the card alone: Qwen2-7B's weights go first
            del params
            torch.cuda.empty_cache()
            if any(p in only for p in MOE_PHASES):
                moe_cfg = moe_config()
                moe_params = random_moe_params(moe_cfg, SEED + 13, dev)
            if phase("megakernel", " (Qwen1.5-MoE)"):
                res["decode_megakernel_moe"] = check_megakernel_moe(
                    moe_cfg, moe_params, dev, details)
            if phase("prefill_megakernel", " (Qwen1.5-MoE)"):
                res["prefill_megakernel_moe"] = check_prefill_megakernel_moe(
                    moe_cfg, moe_params, dev, details)
            moe_single = None
            if phase("serve", " (Qwen1.5-MoE)"):
                moe_launches, moe_op_launches, moe_single = \
                    check_serving_moe(moe_params, moe_cfg, dev, details,
                                      prefill_per_op="serve_tp_moe" in only)
            if phase("tp_moe"):
                res["tp_moe_segment"] = check_tp_moe(moe_cfg, moe_params,
                                                     dev, details)
            if phase("serve_tp_moe"):
                if moe_single is None:        # --only without serve
                    moe_single = {p: serve(moe_params, dev, details, p, n,
                                           moe_cfg)[1]
                                  for p, n in (("megakernel prefill per-op",
                                                64), ("per-op", 24))}
                tp_moe_launches = check_serving_tp_moe(
                    moe_params, moe_cfg, dev, details, moe_single)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if args.details:
            os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                        exist_ok=True)
            with open(args.details, "w") as f:
                json.dump(details, f, indent=1, default=str)
    print(f"-- done (t = {time.monotonic() - t_start:.0f} s)", flush=True)
    if only != PHASES:
        return 0

    # launches: each kernel's count over the timed requests of the path it
    # serves (the per-op path for the first two, the megakernel path for
    # the third and the fifth, the MoE model's default serving for the
    # grouped GEMM and the megakernels' MoE entries, the (1, 2) mesh's
    # default serving for the TP segments and the TP prefill segments, the
    # MoE model's on the (1, 2) mesh for the moe segment), and over the
    # probe tools' own
    # runs for the fourth and the two probes
    csrc = "dashinfer_tpu_torch/csrc/"
    moe_decode = dict(launches=moe_launches["decode_megakernel"],
                      **res["decode_megakernel_moe"])
    moe_prefill = dict(launches=moe_launches["prefill_megakernel"],
                       **res["prefill_megakernel_moe"])
    kernels = [
        dict(name="quant_matmul", route="cuda",
             source=csrc + "quant_matmul.cu",
             replaces="dashinfer_tpu/ops/pallas/quant_matmul.py:80",
             launches=op_launches["quant_matmul"], **res["quant_matmul"]),
        dict(name="paged_attention", route="cuda",
             source=csrc + "paged_attention.cu",
             replaces="dashinfer_tpu/ops/pallas/paged_attention.py:148",
             launches=op_launches["paged_attention"],
             **res["paged_attention"]),
        dict(name="decode_megakernel", route="cuda",
             source=csrc + "megakernel.cu",
             replaces="dashinfer_tpu/ops/pallas/megakernel.py:1297",
             launches=mk_launches["decode_megakernel"],
             **res["decode_megakernel"], moe=moe_decode),
        dict(name="stream_probe", route="cuda",
             source=csrc + "stream_probe.cu",
             replaces="tools/bench_stream.py:41", **res["stream_probe"]),
        dict(name="prefill_megakernel", route="cuda",
             source=csrc + "prefill_megakernel.cu",
             replaces="dashinfer_tpu/ops/pallas/prefill_megakernel.py:480",
             launches=mk_launches["prefill_megakernel"],
             launches_pack_only=po_launches["prefill_megakernel"],
             **res["prefill_megakernel"], moe=moe_prefill),
        dict(name="grouped_quant_matmul", route="cuda",
             source=csrc + "grouped_quant_matmul.cu",
             replaces="dashinfer_tpu/ops/pallas/grouped_quant_matmul.py:206",
             launches=moe_launches["grouped_quant_matmul"],
             launches_per_op_path=moe_op_launches["grouped_quant_matmul"],
             **res["grouped_quant_matmul"]),
        dict(name="probe_magic_dequant", route="cuda",
             source=csrc + "probes.cu",
             replaces="tools/probe_magic_dequant.py:83",
             **res["probe_magic_dequant"]),
        dict(name="probe_reshape", route="cuda", source=csrc + "probes.cu",
             replaces="tools/probe_reshape.py:26", **res["probe_reshape"]),
    ] + [
        # the TP segments' launches: the (1, 2) mesh serving with the
        # default flags
        dict(name=f"tp_{k}_segment", route="cuda",
             source=csrc + "tp_segments.cu",
             replaces=f"dashinfer_tpu/ops/pallas/tp_megakernel.py:{line}",
             launches=tp_launches["tp"][f"tp_{k}_segment"],
             **res[f"tp_{k}_segment"])
        for k, line in (("attn", 346), ("mlp", 849), ("lm", 1167))] + [
        dict(name=f"tp_prefill_{k}_segment", route="cuda",
             source=csrc + "tp_prefill_segments.cu",
             replaces=f"dashinfer_tpu/ops/pallas/tp_megakernel.py:{line}",
             launches=tp_launches["tp"][f"tp_prefill_{k}_segment"],
             **res[f"tp_prefill_{k}_segment"])
        for k, line in (("attn", 1374), ("mlp", 1659), ("lm", 1749))] + [
        # the (1, 2) mesh's MoE serving with the default flags
        dict(name="tp_moe_segment", route="cuda",
             source=csrc + "tp_segments.cu",
             replaces="dashinfer_tpu/ops/pallas/tp_megakernel.py:951",
             launches=tp_moe_launches["tp"]["tp_moe_segment"],
             **res["tp_moe_segment"])]
    for k in kernels:
        check_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")
        parts = [k] + [k[m] for m in ("moe",) if m in k]
        if any(key not in p or (key == "launches" and p[key] <= 0)
               for p in parts for key in check_keys):
            print(f"chip_smoke: FAIL: kernel line of {k['name']}: {k}",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
