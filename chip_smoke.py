#!/usr/bin/env python3
"""Drive the PyTorch port (dashinfer_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--details out/chip_smoke.json]

Phases (any failure exits non-zero):
  1. environment: device name, `nvidia-smi` name + power limit, and the
     build of every CUDA kernel of the per-op path (one nvcc per source, all
     started together);
  2. kernels: each kernel's wrapper on the card at the shapes the serving
     path gives it, held against its plain PyTorch version on the same
     inputs, and timed beside the plain version and one library call;
  3. the slice end to end: Qwen2-7B width (28 layers, random a16w4 group-128
     weights made on the card from a seed), INT8 KV, per-op path, serving
     concurrent greedy and seeded top-k requests through `Engine` after one
     warm-up request; the kernels' launch counts are zeroed just before the
     timed requests and read just after; then
     one decode step's logits through the kernels against the same step
     through the plain versions.
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
KERNEL_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
LOGITS_RTOL = 1e-2


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
    details["paged_attention"] = rows
    # the served model's INT8 cache: one launch per layer per decode step
    int8 = next(r for r in rows if r["mode"] == "int8")
    return dict(max_abs_err=max_err,
                **aggregate([int8], [QWEN2_7B["num_layers"]]))


# -- phase 3: the slice end to end ------------------------------------------

def random_qwen2_7b_params(seed: int, dev):
    """Random a16w4 group-128 weights (the distribution of bench.py's
    build_qwen2_7b_params(quantize_lm=True)), made on the card."""
    import torch
    cfg = QWEN2_7B
    L, D = cfg["num_layers"], cfg["head_dim"]
    H, KH = cfg["num_heads"], cfg["num_kv_heads"]
    hid, inter, V = (cfg["hidden_size"], cfg["intermediate_size"],
                     cfg["vocab_size"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(kin, kout, layers=True, bias=False):
        lead = (L,) if layers else ()
        w_q = torch.randint(0, 256, lead + (kin, kout // 2),
                            dtype=torch.uint8, generator=gen, device=dev)
        scale = torch.rand(lead + (kin // GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        d = {"w_q": w_q, "scale": scale, "zero": -scale * 8.0}
        if bias:
            d["b"] = torch.zeros(lead + (kout,), dtype=torch.bfloat16,
                                 device=dev)
        return d

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    return {
        "embed_tokens": {"w": (torch.randn((V, hid), generator=gen,
                                           device=dev) * 0.02
                               ).to(torch.bfloat16)},
        "norm": ones(hid),
        "lm_head": qlin(hid, V, layers=False),
        "layers": {
            "input_layernorm": ones(L, hid),
            "post_attention_layernorm": ones(L, hid),
            "q_proj": qlin(hid, H * D, bias=True),
            "k_proj": qlin(hid, KH * D, bias=True),
            "v_proj": qlin(hid, KH * D, bias=True),
            "o_proj": qlin(H * D, hid),
            "gate_proj": qlin(hid, inter),
            "up_proj": qlin(hid, inter),
            "down_proj": qlin(inter, hid),
        },
    }


def serve(params, dev, details):
    import torch
    from dashinfer_tpu_torch import (CacheMode, Engine, GenerateRequestStatus,
                                     GenerationConfig, ModelConfig,
                                     RuntimeConfigBuilder)
    from dashinfer_tpu_torch.ops import paged_attention as pa
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    cfg = ModelConfig(**QWEN2_7B)
    rt = (RuntimeConfigBuilder("qwen2-7b").max_length(2048)
          .max_batch(DECODE_BATCH).kv_cache_page_size(PAGE)
          .kv_cache_mode(CacheMode.INT8).dtype("bfloat16")
          .update({"enable_megakernel": False}).build())
    eng = Engine().install_model("qwen2-7b", rt, params=params,
                                 model_config=cfg, device=dev)
    eng.start_model("qwen2-7b")
    new_tokens = 64
    # prompt lengths over the buckets 32 .. 1024 (one <= 32, two > 512)
    prompt_lens = [20, 90, 200, 450, 700, 1000]
    g = torch.Generator().manual_seed(7)
    try:
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
        qm.quant_matmul.counter.reset()
        pa.paged_attention.counter.reset()
        t0 = time.monotonic()
        handles = []
        for i, n in enumerate(prompt_lens):
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
        launches = {"quant_matmul": qm.quant_matmul.counter.read(),
                    "paged_attention": pa.paged_attention.counter.read()}
    finally:
        eng.release_model("qwen2-7b")
    reqs = []
    for (h, q, sampled), n in zip(handles, prompt_lens):
        toks = q.GetAllGeneratedTokens()
        st = q.RequestStatInfo()
        status = q.GenerateStatus()
        reqs.append(dict(prompt_len=n, sampled=sampled, status=status.value,
                         n_tokens=len(toks),
                         ttft_ms=1e3 * st["time_to_first_token"],
                         decode_ms_per_step=(1e3 / st["generate_tps"]
                                             if st["generate_tps"] else None)))
        check(status == GenerateRequestStatus.GenerateFinished,
              f"request (prompt {n}) ended {status.value}")
        check(len(toks) == new_tokens and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"request (prompt {n}): {len(toks)} tokens")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched while serving")
    # every decode step runs paged_attention once per layer and quant_matmul
    # for the 7 projections of each layer and the lm_head; a prefill runs
    # quant_matmul on its lm_head row, and on every projection when its
    # bucket fits the kernel (M <= 32)
    L = cfg.num_layers
    per_step = 7 * L + 1
    steps = launches["paged_attention"] // L
    prefill = sum(per_step if n <= 32 else 1 for n in prompt_lens)
    check(launches["paged_attention"] % L == 0 and steps >= new_tokens - 1
          and launches["quant_matmul"] == per_step * steps + prefill,
          f"launch counts {launches} do not match {steps} decode steps and "
          f"{len(prompt_lens)} prefills")
    details["serving"] = dict(requests=reqs, launches=launches, wall_s=wall)
    for r in reqs:
        print(f"request prompt={r['prompt_len']:4d} "
              f"{'top-k' if r['sampled'] else 'greedy':6s} {r['status']} "
              f"tokens={r['n_tokens']} ttft_ms={r['ttft_ms']:.1f} "
              f"decode_ms/step={r['decode_ms_per_step']:.2f}", flush=True)
    print(f"served {len(reqs)} requests in {wall:.2f} s; launches {launches}",
          flush=True)
    return launches


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", help="write per-shape results as JSON here")
    args = ap.parse_args(argv)

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
    details = {}
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
            qmm = check_quant_matmul(gen, dev, details)
            pa = check_paged_attention(gen, dev, details)

            params = random_qwen2_7b_params(SEED, dev)
            launches = serve(params, dev, details)
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

    kernels = [
        dict(name="quant_matmul", route="cuda",
             source="dashinfer_tpu_torch/csrc/quant_matmul.cu",
             replaces="dashinfer_tpu/ops/pallas/quant_matmul.py:80",
             launches=launches["quant_matmul"], **qmm),
        dict(name="paged_attention", route="cuda",
             source="dashinfer_tpu_torch/csrc/paged_attention.cu",
             replaces="dashinfer_tpu/ops/pallas/paged_attention.py:148",
             launches=launches["paged_attention"], **pa),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
