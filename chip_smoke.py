#!/usr/bin/env python3
"""Drive the PyTorch port (dashinfer_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--details out/chip_smoke.json] [--only a,b,...]

Phases (any failure exits non-zero; `--only` runs a subset while working
on one of them, and then prints no final result line):
  build       device name, `nvidia-smi` name + power limit, and the build of
              every CUDA kernel (one nvcc per source, all started together);
  quant_matmul, paged_attention, stream_probe, probes, megakernel,
  prefill_megakernel
              each kernel's wrapper on the card at the shapes the serving
              path gives it, held against its plain PyTorch version on the
              same inputs, and timed beside the plain version and, where one
              PyTorch call computes the same function, that call. The
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
              the same step through their plain versions, and its profile.
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

def random_qleaf(K, N, gen, dev, bits=4):
    import torch
    G = K // GROUP
    if bits == 4:
        w_q = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8,
                            generator=gen, device=dev)
    else:
        w_q = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                            generator=gen, device=dev)
    scale = torch.rand((G, N), generator=gen, device=dev) * 0.002 + 1e-4
    zero = -scale * 8.0 if bits == 4 else torch.zeros_like(scale)
    return {"w_q": w_q, "scale": scale, "zero": zero}


def check_quant_matmul(gen, dev, details):
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.ops.linear import dequantize_weight
    per_shape, max_err = [], 0.0
    cases = [(name, K, N, n, M, 4) for name, K, N, n in PROJECTIONS
             for M in (1, 8, 32)] + [("q_proj (int8)", 3584, 3584, 0, 8, 8)]
    for name, K, N, n_step, M, bits in cases:
        wd = random_qleaf(K, N, gen, dev, bits)
        x = (torch.randn((M, K), generator=gen, device=dev)).to(torch.bfloat16)
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        got = qm.quant_matmul(x, wd, out_dtype)
        ref = qm.quant_matmul_plain(x, wd, out_dtype)
        torch.cuda.synchronize()
        err = held_to_plain(got, ref, f"quant_matmul {name} M={M} bits={bits}")
        scale_ref = ref.float().abs().max().item()
        max_err = max(max_err, err)
        w_bytes = sum(t.numel() * t.element_size() for t in wd.values())
        copies = [(x, random_qleaf(K, N, gen, dev, bits) if i else wd,
                   out_dtype) for i in range(copies_for(w_bytes))]
        ms = time_ms(qm.quant_matmul, copies)
        plain_ms = time_ms(qm.quant_matmul_plain, copies[:1], iters=3)
        w_lib = dequantize_weight(wd, torch.bfloat16)
        lib_copies = [(x, w_lib if i == 0 else w_lib.clone())
                      for i in range(copies_for(w_lib.numel() * 2))]
        library_ms = time_ms(torch.matmul, lib_copies)
        del w_lib, lib_copies, copies
        nbytes = (x.numel() * 2 + w_bytes + M * N *
                  (4 if out_dtype == torch.float32 else 2))
        row = dict(shape=name, K=K, N=N, M=M, bits=bits, max_abs_err=err,
                   ref_max=scale_ref, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, launches_per_step=n_step,
                   **bounds(nbytes, 2.0 * M * K * N))
        per_shape.append(row)
        print(f"quant_matmul {name:18s} M={M:2d} bits={bits} "
              f"err={err:.2e} ms={ms:.4f} bound={row['bytes_ms']:.4f} "
              f"plain={plain_ms:.3f} lib={library_ms:.4f}", flush=True)
    details["quant_matmul"] = per_shape
    step = [r for r in per_shape if r["M"] == DECODE_BATCH and r["bits"] == 4]
    return dict(max_abs_err=max_err,
                **aggregate(step, [r["launches_per_step"] for r in step]))


def paged_case(mode, gen, dev):
    """B=8, H=28, KH=4, D=128, ps=64: ragged lens (incl. 0 and non-multiples
    of the page), page tables shuffled over the pool, garbage past lens."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    B, maxP = DECODE_BATCH, 32
    lens = torch.tensor([0, 1, 63, 64, 65, 517, 1000, 2047], dtype=torch.int32)
    P = B * maxP + 16
    cfg = ModelConfig(**QWEN2_7B)
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode), P,
                            torch.bfloat16, dev)
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
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev)
    return cache, pt, lens.to(dev), q, cfg


def check_paged_attention(gen, dev, details):
    import torch
    import torch.nn.functional as F
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import kv_ops
    from dashinfer_tpu_torch.ops import paged_attention as pa
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
        k, v = kv_ops.gather_kv_pages(cache, mode, pt, cfg.num_kv_heads,
                                      torch.bfloat16)      # [B, S, KH, D]
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        S = k.shape[2]
        mask = (torch.arange(S, device=dev)[None, :] <
                lens[:, None])[:, None, None, :]
        qs = qb[:, :, None, :]
        library_ms = time_ms(
            lambda a, b_, c, m: F.scaled_dot_product_attention(
                a, b_, c, attn_mask=m, enable_gqa=True),
            [(qs, k, v, mask)], iters=50)
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
    # the same kernel on a pool larger than the 50 MB L2: one launch per
    # layer over the 28 layers' pages of one long-context state (cold), and
    # layer 0 alone again and again (L2-warm), at the same work per launch
    long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
    mode = CacheMode.INT8
    st = mk_state(cfg, mode, DECODE_BATCH, long_lens, None, gen, dev)
    L = cfg.num_layers
    qb = torch.randn((DECODE_BATCH, cfg.num_heads, cfg.head_dim),
                     generator=gen, device=dev).to(torch.bfloat16)
    per_layer = [(qb, st["cache"], mode, (st["pt"] * L + l).to(torch.int32),
                  st["lens"], scale) for l in range(L)]
    cold_ms = time_ms(pa.paged_attention, per_layer, iters=L)
    warm_ms = time_ms(pa.paged_attention, per_layer[:1], iters=L)
    nbytes = kv_bytes_read(cfg, mode, long_lens, [1] * DECODE_BATCH) // L \
        + 2 * qb.numel() * 2
    pool_mb = sum(t.numel() * t.element_size() for t in
                  (st["cache"].k, st["cache"].v, st["cache"].k_qparams,
                   st["cache"].v_qparams)) / 1e6
    big = dict(mode="int8", lens=long_lens, pool_mb=pool_mb, cold_ms=cold_ms,
               warm_ms=warm_ms, **bounds(nbytes, 4.0 * sum(long_lens) *
                                         cfg.num_heads * cfg.head_dim))
    print(f"paged_attention int8 on a {pool_mb:.0f} MB pool, "
          f"{sum(long_lens)} cached tokens: cold {cold_ms:.4f} ms/launch, "
          f"L2-warm {warm_ms:.4f}, bound {big['bytes_ms']:.4f}", flush=True)
    del st, per_layer
    details["paged_attention"] = rows
    details["paged_attention_large_pool"] = big
    # the served model's INT8 cache: one launch per layer per decode step
    int8 = next(r for r in rows if r["mode"] == "int8")
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


PROMPT_LENS = [20, 90, 200, 450, 700, 1000]   # buckets 32 .. 1024


def serve(params, dev, details, path: str, new_tokens: int):
    """Six concurrent requests through `Engine`: path "megakernel" (every
    flag at its default: decode and qualifying prefills through the two
    megakernels), "per-op" (`enable_megakernel` off) or "pack_only"
    (`weight_residency="pack_only"`; `params` is then a callable that makes
    the tree, so that the engine alone holds it). Returns (launch counts of
    the timed requests, generated tokens per request)."""
    import torch
    from dashinfer_tpu_torch import (CacheMode, Engine, GenerateRequestStatus,
                                     GenerationConfig, ModelConfig,
                                     RuntimeConfigBuilder)
    from dashinfer_tpu_torch.engine.model_runtime import _resident_bytes
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import paged_attention as pa
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    megakernel = path != "per-op"
    counters = {"quant_matmul": qm.quant_matmul.counter,
                "paged_attention": pa.paged_attention.counter,
                "decode_megakernel": mk.decode_megakernel.counter,
                "prefill_megakernel": pmk.prefill_megakernel.counter}
    cfg = ModelConfig(**QWEN2_7B)
    b = (RuntimeConfigBuilder("qwen2-7b").max_length(2048)
         .max_batch(DECODE_BATCH).kv_cache_page_size(PAGE)
         .kv_cache_mode(CacheMode.INT8).dtype("bfloat16"))
    if not megakernel:
        b = b.update({"enable_megakernel": False})
    if path == "pack_only":
        b = b.update({"weight_residency": "pack_only"})
    rt = b.build()
    check(rt.enable_megakernel == megakernel, "enable_megakernel default")
    torch.cuda.synchronize()
    pmk.release_scratch(dev)    # what the kernel checks left: the install
    torch.cuda.empty_cache()    # reserves its own, before it plans the pool
    mem0 = torch.cuda.memory_allocated(dev)
    if callable(params):
        params = params()
    mem_tree = torch.cuda.memory_allocated(dev) - mem0
    eng = Engine().install_model("qwen2-7b", rt, params=params,
                                 model_config=cfg, device=dev)
    del params
    run = eng._models["qwen2-7b"]
    memory = dict(
        residency=run.residency, tree_bytes=mem_tree,
        installed_bytes=torch.cuda.memory_allocated(dev) - mem0,
        weights_resident_bytes=_resident_bytes(run.params, run.mega_params),
        pack_bytes=_resident_bytes(run.mega_params),
        pool_bytes=_resident_bytes(vars(run.cache)),
        prefill_scratch_bytes=pmk.scratch_bytes(dev),
        logical_pages=run.num_logical_pages)
    # one scratch set, sized for the largest bucket, is on the card from the
    # install on (none on the per-op path)
    check((memory["prefill_scratch_bytes"] > 0) == megakernel,
          f"{path}: prefill scratch after install: "
          f"{memory['prefill_scratch_bytes']} bytes")
    eng.start_model("qwen2-7b")
    g = torch.Generator().manual_seed(7)
    try:
        if path == "pack_only":
            # refused at start_request, with the reference's message
            try:
                eng.start_request("qwen2-7b", [1] * 1025, GenerationConfig(
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
            "qwen2-7b", torch.randint(1, cfg.vocab_size, (20,),
                                      generator=g).tolist(),
            GenerationConfig(max_length=24, do_sample=False, top_k=1,
                             eos_token_id=-1))
        eng.sync_request("qwen2-7b", h, timeout_s=600)
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
            _, h, q = eng.start_request("qwen2-7b", ids, gc)
            handles.append((h, q, gc.do_sample))
        for h, _, _ in handles:
            eng.sync_request("qwen2-7b", h, timeout_s=600)
        wall = time.monotonic() - t0
        launches = {k: c.read() for k, c in counters.items()}
    finally:
        eng.release_model("qwen2-7b")
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
    # a per-op prefill runs quant_matmul on its lm_head row, and on every
    # projection when its bucket fits the kernel (M <= 32); a prefill whose
    # bucket is 128 .. 1024 is one prefill megakernel launch on the
    # megakernel path, and under pack_only every prefill is (the 20-token
    # prompt snaps to bucket 128)
    L = cfg.num_layers
    per_step = 7 * L + 1
    if path == "pack_only":
        mega_prefills, prefill = len(PROMPT_LENS), 0
    elif megakernel:
        mega_prefills = sum(64 < n <= 1024 for n in PROMPT_LENS)
        prefill = sum(per_step if n <= 32 else 1 for n in PROMPT_LENS
                      if not 64 < n <= 1024)
    else:
        mega_prefills = 0
        prefill = sum(per_step if n <= 32 else 1 for n in PROMPT_LENS)
    if megakernel:
        # one megakernel launch is one decode step; nothing else of a step
        # reaches the per-op kernels
        steps = launches["decode_megakernel"]
        check(steps >= new_tokens - 1 and launches["paged_attention"] == 0
              and launches["quant_matmul"] == prefill
              and launches["prefill_megakernel"] == mega_prefills,
              f"{path} path: launch counts {launches} do not match "
              f"{steps} decode steps, {mega_prefills} prefill megakernel "
              f"launches and the other prefills' {prefill} quant_matmul "
              "launches")
    else:
        # every decode step runs paged_attention once per layer and
        # quant_matmul for the 7 projections of each layer and the lm_head
        steps = launches["paged_attention"] // L
        check(launches["paged_attention"] % L == 0 and steps >= new_tokens - 1
              and launches["quant_matmul"] == per_step * steps + prefill
              and launches["decode_megakernel"] == 0
              and launches["prefill_megakernel"] == 0,
              f"per-op path: launch counts {launches} do not match {steps} "
              f"decode steps and {len(PROMPT_LENS)} prefills")
    details[f"serving_{path}"] = dict(requests=reqs, launches=launches,
                                      wall_s=wall, decode_steps=steps,
                                      memory=memory)
    for r in reqs:
        print(f"{path} request prompt={r['prompt_len']:4d} "
              f"{'top-k' if r['sampled'] else 'greedy':6s} {r['status']} "
              f"tokens={r['n_tokens']} ttft_ms={r['ttft_ms']:.1f} "
              f"decode_ms/step={r['decode_ms_per_step']:.2f}", flush=True)
    print(f"{path}: served {len(reqs)} requests in {wall:.2f} s, {steps} "
          f"decode steps; launches {launches}", flush=True)
    gib = 1024 ** 3
    print(f"{path}: weight residency {memory['residency']}: weights on the "
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
    return mk_launches, op_launches, po_launches


# -- the decode megakernel against its plain version -------------------------

MK_LENS = [37, 64, 150, 300, 1, 127, 256, 500]   # 64, 256: page boundaries
MK_INACTIVE = 5


def mk_state(cfg, mode, B, lens, inactive, gen, dev, max_len=2048):
    """A random pool (payload and qparams) with distinct logical pages per
    slot, and the step's inputs."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    maxP, L = max_len // PAGE, cfg.num_layers
    # logical pages 1 .. B*maxP; the last physical page is the per-op
    # path's sink for inactive slots
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (B * maxP + 1) * L + 1, torch.bfloat16, dev)
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
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if inactive is not None:
        active[inactive] = False
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=gen, device=dev)
    cos, sin = _rope_tiles(cfg, lens_t)
    return dict(cache=cache, pt=pt, lens=lens_t, active=active, tokens=tokens,
                cos=cos, sin=sin)


def mk_plan_pack(cfg, params, B, mode):
    """(plan, packed) of the megakernel for a max_batch-B runtime."""
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import megakernel as mk
    rt = (RuntimeConfigBuilder("mk").max_length(2048).max_batch(B)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
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


def check_written_pool(what, mode, got, ref_cache, before, written, L, dev):
    """A kernel's pool against its plain version's on clones of one pool:
    `written` [pages, ps] marks the token rows that must have changed (the
    tolerances above); every other byte must be unchanged. Returns (payload
    levels apart, qparams rel. difference in layer 0, in all layers)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    pool_err = qp_err = qp_err0 = 0.0
    quant = mode != CacheMode.DEFAULT
    for name in ("k", "v"):
        a, r, b0 = (getattr(c, name) for c in (got, ref_cache,
                                               before))
        check(bool((a[~written] == b0[~written]).all()),
              f"{what}: {name} pool changed outside the written tokens")
        check(bool((a[written] != b0[written]).any(-1).all()),
              f"{what}: a new token's {name} row was not written")
        d = (kv_levels(a[written], mode) - kv_levels(r[written], mode)).abs()
        if quant:       # at most one quantization level apart
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
            wq = written[:, None, :].expand_as(a)
            check(bool((a[~wq] == b0[~wq]).all()),
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
            qp_err0 = max(qp_err0, rel[layer == 0].max().item())
            qp_err = max(qp_err, rel.max().item())
            by_layer = [round(rel[layer == l].max().item(), 5)
                        for l in range(L)]
            check(qp_err0 <= QPARAM_RTOL and qp_err <= DEEP_QPARAM_RTOL,
                  f"{what}: {name} qparams differ: layer 0 {qp_err0:.2e}, "
                  f"all layers {qp_err:.2e}; by layer {by_layer}")
    return pool_err, qp_err0, qp_err


def check_megakernel_case(cfg, params, stream, mode, gen, dev,
                          lens=None, inactive=None):
    """One step (B = 8 unless `lens` says otherwise) through the kernel and
    through the plain version, on clones of one pool: logits of the active
    rows, the written token, and every other pool byte."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    if lens is None:
        lens, inactive = MK_LENS, MK_INACTIVE
    B, L = len(lens), cfg.num_layers
    plan, packed = mk_plan_pack(cfg, params, B, mode)
    st = mk_state(cfg, mode, B, lens, inactive, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    before = st["cache"]
    caches = {True: before.clone(), False: before.clone()}
    out = {}
    for kernel in (True, False):
        fn = mk.decode_megakernel if kernel else mk.decode_megakernel_ref
        out[kernel] = fn(plan, packed, x0, st["cos"], st["sin"], st["pt"],
                         st["lens"], st["active"], caches[kernel])
    mk.check_status(plan, dev)
    torch.cuda.synchronize()
    what = f"megakernel {stream}/{mode.value}" + (
        f" B={B}" if B != DECODE_BATCH else "")
    act = st["active"]
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
        what, mode, caches[True], caches[False], before, written, L, dev)
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}), argmax "
          f"equal {same}/{int(act.sum())}, written payload within "
          f"{pool_err:g} level, qparams rel {qp_err0:.1e} (layer 0) "
          f"{qp_err:.1e} (all layers), rest of the pool "
          "unchanged", flush=True)
    return dict(stream=stream, mode=mode.value, max_abs_err=err,
                ref_max=ref_max, argmax_equal=same, pool_levels=pool_err,
                qparam_rel_layer0=qp_err0, qparam_rel=qp_err)


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
    nbytes = (plan.weight_bytes + kv_bytes_read(cfg, mode, lens, [1] * B) +
              B * plan.V * 4)
    n_w = sum(sp.K * sp.Ntot * (1 if sp.name == "lm" else plan.L)
              for sp in plan.streams)
    ops = 2.0 * B * n_w
    row.update(weight_bytes=plan.weight_bytes, **bounds(nbytes, ops))
    print(f"megakernel {stream} B={B} (cached tokens {sum(lens)}): "
          f"{row['ms']:.3f} ms/step, without attention "
          f"{row['no_attention_ms']:.3f}, byte bound {row['bytes_ms']:.3f}"
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
    long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
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
                       dev):
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
        rel = (val - rval).abs().amax(-1) / rng               # [R, KH]
        rel32 = (rval - r32).abs().amax(-1) / rng
        if quant:
            d0 = (lv - rlv).abs()[layer0]
            lv_err = max(lv_err, d0.max().item())
            q0 = torch.maximum((sc - rsc).abs() / rsc,
                               (ze - rze).abs() / rng)[layer0]
            qp_err0 = max(qp_err0, q0.max().item())
            check(lv_err <= 1 and qp_err0 <= QPARAM_RTOL,
                  f"{what}: {name} layer 0: payload {lv_err} levels, "
                  f"qparams {qp_err0:.2e}")
            tol = 1.5 / n_levels + PREFILL_POOL_RTOL
        else:
            tol = BF16_STEP + PREFILL_POOL_RTOL
            check(bool((rel[layer0] <= BF16_STEP + QPARAM_RTOL).all()),
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


def check_prefill_case(cfg, params, stream, mode, bucket, n, gen, dev):
    """One prefill through the kernel and through the plain version (with
    the kernel's bf16 score operands), on clones of one pool: the logits,
    rows < n of the owned pages, and every other pool byte. The plain
    version with the TPU kernel's f32 score operands is read beside it."""
    import torch
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
    ref = pmk.prefill_megakernel_ref(*args, ref_cache, bf16_scores=True)
    ref32 = pmk.prefill_megakernel_ref(*args, ref32_cache)
    torch.cuda.synchronize()
    what = f"prefill_megakernel {stream}/{mode.value} S={bucket} n={n}"
    check(tuple(got.shape) == (cfg.vocab_size,) and
          bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    err32 = (got - ref32).abs().max().item()
    check(err <= LOGITS_RTOL * ref_max,
          f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    check(err32 <= F32_SCORES_RTOL * ref_max,
          f"{what}: logits differ from the f32-score plain version by "
          f"{err32:.3e} > {F32_SCORES_RTOL} * {ref_max:.3e}")
    pick = int(got.argmax())
    check(float(ref.max() - ref[pick]) <= 2 * err, f"{what}: argmax differs")
    written = torch.zeros(before.k.shape[:2], dtype=torch.bool, device=dev)
    for j, g in enumerate(st["pages"].tolist()):
        rows = min(PAGE, n - j * PAGE)
        if rows > 0:
            written[g * L:(g + 1) * L, :rows] = True
    check(int(written.sum()) == n * L, f"{what}: written mask")
    lv_err, qp_err0, rel_max, ill, ill_max, plain_max = check_prefill_pool(
        what, mode, got_cache, ref_cache, ref32_cache, before, written, cfg,
        dev)
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}; against "
          f"f32 scores {err32:.3e}), argmax {pick}; layer 0 rows within "
          f"{lv_err:g} level, qparams rel {qp_err0:.1e}; all rows within "
          f"{rel_max:.1e} of their range, but for {ill} ill-conditioned "
          f"(row, head) pairs (up to {ill_max:.1e}; the two plain versions "
          f"differ by up to "
          f"{plain_max:.1e}); rest of the pool unchanged", flush=True)
    return dict(stream=stream, mode=mode.value, bucket=bucket, n=n,
                max_abs_err=err, max_abs_err_f32_scores=err32,
                ref_max=ref_max, pool_levels_layer0=lv_err,
                qparam_rel_layer0=qp_err0, row_rel_max=rel_max,
                ill_conditioned_rows=ill, ill_row_rel_max=ill_max,
                plain_versions_row_rel_max=plain_max)


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
    print(f"prefill_megakernel S={bucket} n={n}: {row['ms']:.3f} ms/launch, "
          f"bound {max(row['bytes_ms'], row['ops_ms']):.3f} (bytes "
          f"{row['bytes_ms']:.3f}, operations {row['ops_ms']:.3f}), per-op "
          f"prefill_forward {row['per_op_ms']:.3f} (eager; host wall "
          f"{row['per_op_wall_ms']:.3f}), plain {row['plain_ms']:.1f}; grid "
          f"{row['geometry']['grid']}, K splits {row['geometry']['splits']}, "
          f"scratch {row['geometry']['scratch_bytes'] / 1e6:.0f} MB",
          flush=True)
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
    details["prefill_megakernel"] = dict(cases=cases, times=times)
    big = times[-1]
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="bucket 1024, n = 1024", ms=big["ms"],
                plain_ms=big["plain_ms"], library_ms=None,
                per_op_ms=big["per_op_ms"],
                ms_by_bucket={str(t["bucket"]): t["ms"] for t in times},
                bound_ms=max(big["bytes_ms"], big["ops_ms"]),
                bound_by=("bytes" if big["bytes_ms"] >= big["ops_ms"]
                          else "operations"))


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
    return dict(launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows
                                if r["format"] != "copy"),
                ms=u4["ms"], plain_ms=u4["plain_ms"], library_ms=None,
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
    out["probe_reshape"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        shape=f"variant {first['variant']}", ms=first["ms"],
        plain_ms=first["plain_ms"], library_ms=None,
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


PHASES = ("quant_matmul", "paged_attention", "stream_probe", "probes",
          "megakernel", "prefill_megakernel", "serve", "decode_logits")


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

    def phase(name):
        if name in only:
            print(f"-- {name} (t = {time.monotonic() - t_start:.0f} s)",
                  flush=True)
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
            if phase("serve"):
                mk_launches, op_launches, po_launches = check_serving(
                    params, dev, details)
            if phase("decode_logits"):
                check_decode_logits(params, dev, details)
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
    # the third and the fifth), and over the probe tools' own runs for the
    # fourth and the last two
    csrc = "dashinfer_tpu_torch/csrc/"
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
             **res["decode_megakernel"]),
        dict(name="stream_probe", route="cuda",
             source=csrc + "stream_probe.cu",
             replaces="tools/bench_stream.py:41", **res["stream_probe"]),
        dict(name="prefill_megakernel", route="cuda",
             source=csrc + "prefill_megakernel.cu",
             replaces="dashinfer_tpu/ops/pallas/prefill_megakernel.py:480",
             launches=mk_launches["prefill_megakernel"],
             launches_pack_only=po_launches["prefill_megakernel"],
             **res["prefill_megakernel"]),
        dict(name="probe_magic_dequant", route="cuda",
             source=csrc + "probes.cu",
             replaces="tools/probe_magic_dequant.py:83",
             **res["probe_magic_dequant"]),
        dict(name="probe_reshape", route="cuda", source=csrc + "probes.cu",
             replaces="tools/probe_reshape.py:26", **res["probe_reshape"]),
    ]
    for k in kernels:
        check_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")
        if any(key not in k for key in check_keys) or k["launches"] <= 0:
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
