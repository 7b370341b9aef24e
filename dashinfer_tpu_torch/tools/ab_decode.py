"""The decode or prefill megakernel, or the per-op paged attention and
grouped GEMM, of two checkouts, side by side on one card.

Times one decode forward of csrc/megakernel.cu at Qwen2-7B width (INT8 KV,
chip_smoke.py's states and random weights: the u4 stream at B = 8 with
1,435 and with 15,513 cached tokens and at B = 32, the per-channel i8
stream at B = 8 and 32), each with its attention left out and with block
0's per-phase times, with `--moe`
one decode forward of its MoE branch at Qwen1.5-MoE-A2.7B width at B = 8
and B = 32 (chip_smoke.py's MoE weights and states), or with `--prefill`
one launch of csrc/prefill_megakernel.cu for a full bucket of 128, 256, 512
and 1024 (INT8 KV, chip_smoke.py's inputs) of Qwen2-7B's u4 and i8 streams
and of Qwen1.5-MoE's u4 (with block 0's per-phase times at 128 and 1024),
and the TP prefill segments of csrc/tp_prefill_segments.cu (attn, mlp and
lm of rank 0 at layer 0, a (1, 2) mesh whose ranks share the card, INT8,
the u4 and the i8 stream) at the same buckets (the mlp segment's
per-phase times at 128 and 1024, where the checkout's wrapper takes a
trace) and the lm segment at Qwen3-8B's 75968-column shard and at
Baichuan2-13B's TP check geometry (one layer each), or with
`--tp-prefill` those TP prefill segments alone, or with
`--tp` the TP segments (csrc/tp_segments.cu: attn, mlp or moe, and lm of
rank 0 at layer 0, with the attn and moe segments' per-phase times) and
the TP decode step of Qwen2-7B and of Qwen1.5-MoE on a (1, 2) mesh whose
ranks share the card (INT8 KV, B = 8; the MoE model also at UINT4, with
its attn and moe segments' phases, and at B = 32), or with
`--kernels` the per-op paged_attention (chip_smoke.py's INT8 check pool,
Qwen2-7B's 28 heads on 4 and Qwen1.5-MoE's 16 on 16, and its long-context
state at B = 8 and 32, one launch a layer in turn: cold) and
grouped_quant_matmul (Qwen1.5-MoE width, u4, the bucket-32, 128 and 1024
prefills' routed rows, gate and down), the stream probe's u4 g128 product
(csrc/stream_probe.cu, the decode product phase on Qwen2-7B's gate|up leaf
at B = 8), the TP segments (csrc/tp_segments.cu: attn, mlp or moe, and lm
of rank 0 at layer 0) and the TP decode step of each model on a (1, 2)
mesh whose ranks share the card (INT8 KV, B = 8) and, for what the
kernels move end to end, the per-op decode forward of Qwen2-7B and of
Qwen1.5-MoE at B = 8 on chip_smoke.py's INT8 state and the per-op
bucket-32 prefill forward of Qwen2-7B (graph replays), and the per-op
quant_matmul (csrc/quant_matmul.cu) at each of chip_smoke.py's projection
shapes of Qwen2-7B, M = 1, 8 and 32, for u4 and int8 group-128 and u4
per-channel leaves (cold: copies of the weights larger than L2), its
decode step at M = 8 (the shapes' launches a step) and the device time of
each CUDA kernel a product runs (torch.profiler, k_proj and gate_proj at
M = 8), or with `--qmm` only the quant_matmul rows and the two Qwen2-7B
per-op forwards, or with `--noise` the
sampler's Gumbel noise of one decode step (`ops/sampling.py`
`gumbel_noise`, every row seeded, K = 128, B = 8 and 32) drawn on the card
and drawn on the host and copied: host ms a call, device ms a call with
the host ahead, ms to the noise's arrival, and ms it adds to a step behind
a 4.5 ms forward, or with `--lm-splits` the prefill kernels' one-row
lm_head (di_prefill_layer.cuh `lm_row`) at each K split in LM_SPLITS: a
launch of the TP prefill lm segment (rank 0 of a (1, 2) mesh, bucket 1024,
Qwen2-7B u4) on its own grid and on one block an SM, and the prefill
megakernel's lm_head phase at bucket 128 (block 0's trace), the data that
ops/prefill_megakernel.py `choose_row_split` was fitted to (a checkout
that has that function), for each checkout root
given, in the order
given, each in a process of its own that imports that checkout's
`dashinfer_tpu_torch` and `chip_smoke.py`.
The kernels are built first, all roots at once. Give the parent and the
change as `PARENT CHANGE CHANGE PARENT` to see drift between runs. Prints
one JSON line a run, the card's `nvidia-smi` name and power limit, the
ptxas registers and spills of each root's kernel instantiations (and any
C75xx "wgmma serialized" warning), and `AB_DIFF`: for each output every
run kept on one fixed state, the largest |difference| from the first
run's (the decode mode: the decode megakernel's logits and pool at u4
B = 8 and the TP attn segment's o partial and pool; `--moe`: the MoE
megakernel's logits at B = 8; `--tp`: every segment's output; `--prefill`:
each prefill launch's logits and pool and each TP prefill segment's
output). A
change that keeps the arithmetic shows 0 against the parent.

    python -m dashinfer_tpu_torch.tools.ab_decode build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --moe build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --prefill build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --tp-prefill build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --tp build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --kernels build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --qmm build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --noise build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --lm-splits .
"""

import json
import math
import os
import subprocess
import sys

# ((kernel source, its entry function's name in the ptxas log), ...) by mode
_KERNELS = {"decode": (("megakernel", "mk_kernel"),),
            "moe": (("megakernel", "mk_kernel"),),
            "prefill": (("prefill_megakernel", "pmk_kernel"),
                        ("tp_prefill_segments", "pseg_kernel")),
            "tp_prefill": (("prefill_megakernel", "pmk_kernel"),
                           ("tp_prefill_segments", "pseg_kernel")),
            "kernels": (("paged_attention", "pa_kernel"),
                        ("grouped_quant_matmul", "gqm_kernel"),
                        ("stream_probe", "sp_product"),
                        ("tp_segments", "seg_kernel"),
                        ("quant_matmul", "qmm_")),
            "qmm": (("quant_matmul", "qmm_"),),
            "tp": (("tp_segments", "seg_kernel"), ("megakernel", "mk_kernel")),
            "noise": (),
            "lm_splits": (("prefill_megakernel", "pmk_kernel"),
                          ("tp_prefill_segments", "pseg_kernel"))}
_FLAGS = {"--prefill": "prefill", "--moe": "moe", "--kernels": "kernels",
          "--qmm": "qmm", "--noise": "noise", "--tp": "tp",
          "--tp-prefill": "tp_prefill", "--lm-splits": "lm_splits"}
PREFILL_BUCKETS = (128, 256, 512, 1024)
PREFILL_TRACED = (128, 1024)
PHASE_TRACES = 5              # launches a phase trace is the mean of
MOE_BATCHES = (8, 32)
GQM_TS = (32, 128, 1024)
LONG_LENS = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
NOISE_BATCHES = (8, 32)
NOISE_K = 128                 # RuntimeConfig.sampler_max_top_k's default
NOISE_CALLS = 50
NOISE_FORWARD_MS = 4.5        # the Qwen2-7B decode forward at B = 8
QMM_MS = (1, 8, 32)
# (name, bits, K rows a quant group; 0: per-channel)
QMM_KINDS = (("u4_g128", 4, 128), ("i8_g128", 8, 128), ("u4_pc", 4, 0))
QMM_SPLIT = ("k_proj+v_proj", "gate_proj+up_proj")   # profiled at M = 8
PREFILL_SMALL = 32            # the per-op prefill bucket below 128
LM_SPLITS = (1, 2, 4, 7, 8, 14)   # K splits of Qwen2-7B's 56 lm chunks
# outputs a run keeps for AB_DIFF (name -> tensor on the host), saved where
# the AB_DUMP environment variable says
_DUMPS = {}


def _keep(name: str, t) -> None:
    _DUMPS[name] = t.detach().float().cpu() if t.is_floating_point() \
        else t.detach().cpu()


def _qleaf(K, N, bits, group, gen, dev):
    """chip_smoke.py's random leaf (made here: a parent's chip_smoke.py
    knows no per-channel leaf)."""
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


def _kernel_split(calls, n) -> dict:
    """Device us a call of each CUDA kernel that `calls` (n products)
    launches, by kernel name (template arguments dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        calls()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", None)):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        name = ev.key.split("<")[0].split("::")[-1].split("(")[0]
        k = out.setdefault(name, {"launches": 0, "us": 0.0})
        k["launches"] += ev.count / n
        k["us"] += us / n
    return out


def _qmm(cs, dev, gen) -> dict:
    """The quant_matmul rows (ms a launch, max|kernel - plain| over
    max|plain|), the step at M = 8 by kind, the kernels a product runs."""
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    out = {}
    for kind, bits, group in QMM_KINDS:
        step = 0.0
        for name, K, N, n_step in cs.PROJECTIONS:
            leaves = [_qleaf(K, N, bits, group or K, gen, dev)]
            w_bytes = sum(t.numel() * t.element_size()
                          for t in leaves[0].values())
            leaves += [_qleaf(K, N, bits, group or K, gen, dev)
                       for _ in range(cs.copies_for(w_bytes) - 1)]
            od = torch.float32 if name == "lm_head" else torch.bfloat16
            short = name.split("+")[0]
            for M in QMM_MS:
                x = torch.randn((M, K), generator=gen,
                                device=dev).to(torch.bfloat16)
                ref = qm.quant_matmul_plain(x, leaves[0], od).float()
                got = qm.quant_matmul(x, leaves[0], od).float()
                key = f"qmm_{kind}_{short}_M{M}"
                out[f"{key}_err"] = ((got - ref).abs().max() /
                                     ref.abs().max()).item()
                out[f"{key}_ms"] = cs.time_ms(
                    qm.quant_matmul, [(x, w, od) for w in leaves])
                if M == cs.DECODE_BATCH:
                    step += out[f"{key}_ms"] * n_step
                if M == cs.DECODE_BATCH and name in QMM_SPLIT and \
                        kind != "i8_g128":
                    calls = 10
                    out[f"{key}_kernels"] = _kernel_split(
                        lambda: [qm.quant_matmul(x, leaves[i % len(leaves)],
                                                 od) for i in range(calls)],
                        calls)
            del leaves
            torch.cuda.empty_cache()
        out[f"qmm_{kind}_step_M8_ms"] = step
    return out


def _per_op(cs, name, cfg, params, mode, gen, dev) -> dict:
    """Device ms of one per-op decode forward at B = 8 on chip_smoke.py's
    state and, for a dense model, of one per-op prefill forward of a
    PREFILL_SMALL-token bucket (a 20-token prompt) into its slot 0 (graph
    replays)."""
    import torch
    from dashinfer_tpu_torch.models import transformer
    st = cs.mk_state(cfg, mode, 8, cs.MK_LENS, None, gen, dev)
    out = {f"per_op_decode_{name}_ms": cs.time_ms(
        lambda: transformer.decode_forward(
            cfg, params, st["tokens"], st["cache"], st["pt"], st["lens"],
            st["active"], mode=mode), [()], iters=3)}
    if not cfg.moe:
        tokens = torch.randint(1, cfg.vocab_size, (PREFILL_SMALL,),
                               generator=gen, device=dev)
        out[f"per_op_prefill32_{name}_ms"] = cs.time_ms(
            lambda: transformer.prefill_forward(
                cfg, params, tokens, st["cache"], st["pt"][0], 0, 20,
                mode=mode), [()], iters=3)
    del st
    torch.cuda.empty_cache()
    return out


def _qmm_forwards(cs, root: str) -> dict:
    """`--qmm`: the quant_matmul rows and the per-op Qwen2-7B forwards."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    dev = torch.device("cuda", 0)
    out = {"root": root}
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        cfg = ModelConfig(**cs.QWEN2_7B)
        params = cs.random_qwen2_7b_params(cs.SEED, dev)
        out.update(_per_op(cs, "qwen2_7b", cfg, params, CacheMode.INT8, gen,
                           dev))
        del params
        torch.cuda.empty_cache()
        out.update(_qmm(cs, dev, gen))
    return out


def _gqm_leaves(cs, cfg, dev):
    """gate and down stacks of one layer (chip_smoke.py's distribution),
    in the kernel's layout."""
    import torch
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    E, hid = cfg.moe.num_experts, cfg.hidden_size
    Im = cfg.moe.moe_intermediate_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 11)

    def qlin(kin, kout):
        scale = torch.rand((1, E, kin // cs.GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        w_q = torch.randint(0, 256, (1, E, kin, kout // 2),
                            dtype=torch.uint8, generator=gen, device=dev)
        return {"w_q": w_q, "scale": scale, "zero": -scale * 8.0}

    ex = {"gate_proj": qlin(hid, Im), "down_proj": qlin(Im, hid)}
    gqm.prepare_grouped_experts({"layers": {"experts": ex}}, cfg)
    return {name: {k: v[0] for k, v in ex[key].items()}
            for name, key in (("gate", "gate_proj"), ("down", "down_proj"))}


def _tp(cs, name, cfg, params, gen, dev) -> dict:
    """The TP segments of rank 0 at layer 0 (ms a launch) and the TP decode
    step, on a (1, 2) mesh whose ranks share the card, INT8 KV, B = 8:
    chip_smoke.py's `tp_timing` of its first TP (or TP MoE) case; and,
    where the checkout's attn (and moe) segment takes a trace, block 0's
    time in each of its phases in one launch; for the MoE model also the
    moe segment and the step at UINT4 KV and at B = 32."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = (cs.tp_moe_setup(cfg, params, 2, "INT8", cs.DECODE_BATCH, gen, dev)
         if cfg.moe else cs.tp_setup(cfg, params, 2, "INT8", gen, dev))
    st = s["st"]
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    plan1, pack1 = cs.mk_plan_pack(cfg, params, s["plan"].B, s["mode"])
    c1 = cs.full_pool(s["caches"]).clone()
    t = cs.tp_timing(cfg, s, plan1, pack1, c1, step, dev)
    out = {f"tp_{name}_{seg}_ms": r["ms"]
           for seg, r in t["segments"].items()}
    out[f"tp_{name}_step_ms"] = t["tp_forward_ms"]
    x = s["x0"].float()
    pk = s["packs"][0]
    _keep(f"tp_{name}_attn", tpk.tp_attn_segment(s["plan"], pk, 0, x, *step,
                                                 s["caches"][0]))
    _keep(f"tp_{name}_lm", tpk.tp_lm_segment(s["plan"], pk, x))
    if cfg.moe:
        _keep(f"tp_{name}_moe", tpk.tp_moe_segment(s["plan"], pk, 0, x, 0,
                                                   st["active"]))
    else:
        _keep(f"tp_{name}_mlp", tpk.tp_mlp_segment(s["plan"], pk, 0, x))
    out.update(_seg_phases(mk, tpk, f"tp_{name}", s, step, cfg.moe, dev))
    if cfg.moe:             # the moe segment and the step at UINT4 and B = 32
        for mode, B in (("UINT4", cs.DECODE_BATCH), ("INT8", 32)):
            s2 = cs.tp_moe_setup(cfg, params, 2, mode, B, gen, dev)
            st2 = s2["st"]
            x2, act2 = s2["x0"].float(), st2["active"]
            key = f"tp_{name}_{mode.lower()}_B{B}"
            if mode == "UINT4":
                out[f"{key}_attn_ms"] = cs.time_ms(
                    lambda: tpk.tp_attn_segment(
                        s2["plan"], s2["packs"][0], 0, x2, *(st2[k] for k in (
                            "cos", "sin", "pt", "lens", "active")),
                        s2["caches"][0]), [()], iters=20)
                out.update(_seg_phases(
                    mk, tpk, key, s2, tuple(st2[k] for k in (
                        "cos", "sin", "pt", "lens", "active")), True, dev))
            out[f"{key}_moe_ms"] = cs.time_ms(
                lambda: tpk.tp_moe_segment(s2["plan"], s2["packs"][0], 0, x2,
                                           0, act2), [()], iters=20)
            out[f"{key}_step_ms"] = cs.time_ms(
                lambda: tpk.tp_decode(
                    s2["plan"], s2["packs"], s2["x0"],
                    *(st2[k] for k in ("cos", "sin", "pt", "lens", "active")),
                    s2["caches"], s2["mesh"].devices), [()], iters=3)
            tpk.check_status(s2["plan"], dev)
            del s2, st2
            torch.cuda.empty_cache()
    return out


def _mean_phases(mk, names, launch, dev) -> dict:
    """Block 0's time in each phase (`names`) of a kernel that takes a
    trace: the mean of PHASE_TRACES launches (`launch(trace)`)."""
    import torch
    runs = []
    for _ in range(PHASE_TRACES):
        trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                            device=dev)
        launch(trace)
        runs.append(mk.phase_times_of(names, trace))
    return {k: {f: sum(r[k][f] for r in runs) / len(runs)
                for f in ("work", "wait")} for k in runs[0]}


def _seg_phases(mk, tpk, key, s, step, moe, dev) -> dict:
    """The attn (and, `moe`, the moe) segment's phases of rank 0 at layer
    0 on a `tp_setup` / `tp_moe_setup` state, where the checkout's wrapper
    takes a trace."""
    out = {}
    x = s["x0"].float()
    names = getattr(tpk, "ATTN_SEG_PHASES", None)
    if names:
        out[f"{key}_attn_phases"] = _mean_phases(mk, names, lambda t: (
            tpk.tp_attn_segment(s["plan"], s["packs"][0], 0, x, *step,
                                s["caches"][0], trace=t)), dev)
    names = getattr(tpk, "MLP_SEG_PHASES", None)
    if not moe and names:
        out[f"{key}_mlp_phases"] = _mean_phases(mk, names, lambda t: (
            tpk.tp_mlp_segment(s["plan"], s["packs"][0], 0, x, trace=t)),
            dev)
    names = getattr(tpk, "MOE_SEG_PHASES", None)
    if moe and names:
        out[f"{key}_moe_phases"] = _mean_phases(mk, names, lambda t: (
            tpk.tp_moe_segment(s["plan"], s["packs"][0], 0, x, 0, step[-1],
                               trace=t)), dev)
    tpk.check_status(s["plan"], dev)
    return out


def _prefill(cs, name, cfg, params, gen, dev) -> dict:
    """ms a launch of the prefill megakernel for each full bucket, its
    operations bound, and block 0's per-phase times at PREFILL_TRACED."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    out = {}
    for bucket in PREFILL_BUCKETS:
        plan, packed = cs.pmk_plan_pack(cfg, params, bucket, CacheMode.INT8)
        st = cs.pmk_inputs(cfg, params, plan, CacheMode.INT8, bucket, gen,
                           dev)
        args = (plan, packed, st["x0"], st["cos"], st["sin"],
                st["page_row"], st["n"], st["cache"])
        out[f"{name}_ms_{bucket}"] = cs.time_ms(pmk.prefill_megakernel,
                                                [args], iters=5)
        pmk.check_status(dev)
        _keep(f"{name}_logits_{bucket}", pmk.prefill_megakernel(*args))
        _keep(f"{name}_pool_k_{bucket}", st["cache"].k)
        _keep(f"{name}_pool_v_{bucket}", st["cache"].v)
        out[f"{name}_ops_bound_ms_{bucket}"] = cs.bounds(
            0, plan.operations(bucket))["ops_ms"]
        if bucket in PREFILL_TRACED:
            trace = torch.zeros(pmk.trace_len(plan), dtype=torch.int64,
                                device=dev)
            pmk.prefill_megakernel(*args, trace=trace)
            torch.cuda.synchronize()
            # a checkout whose MoE branch ran its experts in batches names
            # their phases by batch
            geo = pmk.launch_geometry(plan, dev)
            extra = (geo["nbatch"],) if "nbatch" in geo else ()
            out[f"{name}_phases_{bucket}"] = pmk.phase_times(plan, trace,
                                                             *extra)
        del st, packed
        torch.cuda.empty_cache()
    return out


def _tp_prefill(cs, cfg, params, gen, dev, stream="u4") -> dict:
    """ms a launch of each TP prefill segment (rank 0, layer 0, a (1, 2)
    mesh whose ranks share the card, INT8 KV) for each full bucket, the
    `stream`'s weights (its name in the keys of all but u4)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = cs.tp_prefill_setup(cfg, params, 2, dev)
    rt = cs.tp_prefill_rt(2, CacheMode.INT8)
    plans = tpk.make_tp_prefill_plans(cfg, rt, s["parts"],
                                      list(PREFILL_BUCKETS), s["tp_plan"])
    pre = "tp_prefill" if stream == "u4" else f"tp_prefill_{stream}"
    out = {}
    for bucket, plan in plans.items():
        st = cs.tp_prefill_inputs(cfg, params, s, plan, CacheMode.INT8,
                                  bucket, gen, dev)
        pk, cache = s["packs"][0], st["caches"][0]
        step = (st["cos"], st["sin"], st["page_row"], st["n"])
        x = st["x0"].float()
        add = torch.randn((bucket, plan.hid), generator=gen,
                          device=dev) * 0.5
        for seg, fn in (
                ("attn", lambda: tpk.tp_prefill_attn_segment(
                    plan, pk, 0, x, *step, cache, add=add)),
                ("mlp", lambda: tpk.tp_prefill_mlp_segment(
                    plan, pk, 0, x, st["n"], add=add)),
                ("lm", lambda: tpk.tp_prefill_lm_segment(
                    plan, pk, x, st["n"], add=add))):
            out[f"{pre}_{seg}_ms_{bucket}"] = cs.time_ms(fn, [()],
                                                         iters=10)
            tpk.check_prefill_status(dev)
        # the outputs on a fixed x (no add: x stays as it is)
        x = st["x0"].float()
        _keep(f"{pre}_attn_{bucket}", tpk.tp_prefill_attn_segment(
            plan, pk, 0, x, *step, cache.clone()))
        _keep(f"{pre}_mlp_{bucket}", tpk.tp_prefill_mlp_segment(
            plan, pk, 0, x, st["n"]))
        _keep(f"{pre}_lm_{bucket}", tpk.tp_prefill_lm_segment(
            plan, pk, x, st["n"]))
        names = getattr(tpk, "PREFILL_MLP_SEG_PHASES", None)
        if names and bucket in PREFILL_TRACED:
            out[f"{pre}_mlp_phases_{bucket}"] = _mean_phases(
                mk, names, lambda t: tpk.tp_prefill_mlp_segment(
                    plan, pk, 0, x, st["n"], trace=t), dev)
            tpk.check_prefill_status(dev)
        names = getattr(tpk, "PREFILL_ATTN_SEG_PHASES", None)
        if names and bucket in PREFILL_TRACED:
            out[f"{pre}_attn_phases_{bucket}"] = _mean_phases(
                mk, names, lambda t: tpk.tp_prefill_attn_segment(
                    plan, pk, 0, x, *step, cache, trace=t), dev)
            tpk.check_prefill_status(dev)
        del st
        torch.cuda.empty_cache()
    return out


def _lm_shards(cs, gen, dev) -> dict:
    """ms a launch of the TP prefill lm segment (rank 0 of a (1, 2) mesh,
    bucket 1024, n = 1024) at Qwen3-8B's 75968-column shard and at
    Baichuan2-13B's TP check geometry (zero-mean weights, unit-normed lm_head
    columns, as chip_smoke.py's checks take them), each at one layer: the
    segment reads the final norm and the lm_head only."""
    import dataclasses
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.tools import bench_stream
    out = {}
    for name, cfg, make in (
            ("qwen3_8b", dataclasses.replace(ModelConfig(**cs.QWEN3_8B),
                                             num_layers=1),
             lambda c: bench_stream.random_a16w4_params(c, cs.SEED, dev,
                                                        cs.GROUP)),
            ("baichuan_tp_check", cs.baichuan_config(
                **dict(cs.BAICHUAN_TP_GEOMETRY, num_layers=1)),
             lambda c: cs.random_baichuan_params(c, cs.SEED, dev))):
        params = make(cfg)
        s = cs.tp_prefill_setup(cfg, params, 2, dev)
        plan = tpk.make_tp_prefill_plans(
            cfg, cs.tp_prefill_rt(2, CacheMode.INT8), s["parts"], [1024],
            s["tp_plan"])[1024]
        st = cs.tp_prefill_inputs(cfg, params, s, plan, CacheMode.INT8,
                                  1024, gen, dev)
        x = st["x0"].float()
        out[f"tp_prefill_lm_{name}_ms"] = cs.time_ms(
            lambda: tpk.tp_prefill_lm_segment(plan, s["packs"][0], x,
                                              st["n"]), [()], iters=10)
        _keep(f"tp_prefill_lm_{name}", tpk.tp_prefill_lm_segment(
            plan, s["packs"][0], x, st["n"]))
        tpk.check_prefill_status(dev)
        del params, s, plan, st, x
        torch.cuda.empty_cache()
    return out


def _lm_splits(cs, cfg, params, gen, dev) -> dict:
    """`--lm-splits`: ms of the one-row lm_head at each K split in
    LM_SPLITS (see the module's doc), beside the split the wrappers take.
    Each wrapper's own geometry is put back after; the scratch is grown
    for the largest split."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk

    def sweep(launch, key, call):
        grid, split = launch.grid, launch.splits[key]
        out = {}
        try:
            for ks in LM_SPLITS:
                launch.splits[key] = (ks, -(-56 // ks))
                out[str(ks)] = call()
        finally:
            launch.grid, launch.splits[key] = grid, split
        return out

    def grown(launch):
        need = dict(launch.need)
        need["partial"] = max(need["partial"],
                              max(LM_SPLITS) * plan.lm.Nptot)
        pmk.device_scratch(dev, need)

    out = {}
    s = cs.tp_prefill_setup(cfg, params, 2, dev)
    plan = tpk.make_tp_prefill_plans(
        cfg, cs.tp_prefill_rt(2, CacheMode.INT8), s["parts"], [1024],
        s["tp_plan"])[1024]
    st = cs.tp_prefill_inputs(cfg, params, s, plan, CacheMode.INT8, 1024,
                              gen, dev)
    x = st["x0"].float()
    launch, _ = tpk._prefill_launch_state(plan, dev)
    grown(launch)
    grid = dict(launch.grid)
    out["tp_lm_split"] = launch.splits["lm"]
    for g in (grid["lm"], grid["lm"] // 2):
        def one():
            launch.grid = dict(grid, lm=g)
            ms = cs.time_ms(lambda: tpk.tp_prefill_lm_segment(
                plan, s["packs"][0], x, st["n"]), [()], iters=10)
            tpk.check_prefill_status(dev)
            return ms
        out[f"tp_lm_ms_grid{g}"] = sweep(launch, "lm", one)
    del s, plan, st, x
    torch.cuda.empty_cache()
    plan, packed = cs.pmk_plan_pack(cfg, params, 128, CacheMode.INT8)
    st = cs.pmk_inputs(cfg, params, plan, CacheMode.INT8, 128, gen, dev)
    args = (plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
            st["n"], st["cache"])
    launch, _ = pmk._launch_state(plan, dev)
    grown(launch)
    out["pmk_lm_split"] = launch.splits["lm"]
    out["pmk_grid"] = launch.grid

    def phase():
        t = _mean_phases(mk, pmk._phase_names(plan),
                         lambda tr: pmk.prefill_megakernel(*args, trace=tr),
                         dev)["lm_head"]
        pmk.check_status(dev)
        return t["work"] + t["wait"]
    out["pmk_lm_head_ms_128"] = sweep(launch, "lm", phase)
    return out


def _tp_models(cs, root: str) -> dict:
    """`--tp`: the TP segments and steps of both models (`_tp`)."""
    import torch
    from dashinfer_tpu_torch.config import ModelConfig
    dev = torch.device("cuda", 0)
    out = {"root": root}
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        for name, fcfg, make in (
                ("qwen2_7b", ModelConfig(**cs.QWEN2_7B),
                 lambda: cs.random_qwen2_7b_params(cs.SEED, dev)),
                ("qwen15_moe", cs.moe_config(), lambda: cs.random_moe_params(
                    cs.moe_config(), cs.SEED + 13, dev))):
            params = make()
            out.update(_tp(cs, name, fcfg, params, gen, dev))
            del params
            torch.cuda.empty_cache()
    return out


def _keep_decode(cs, name, cfg, params, dev, tp: bool) -> None:
    """The decode megakernel's logits and written pool on a fixed state
    (u4 B = 8, INT8 KV, chip_smoke.py's lens) and, `tp`, the TP attn
    segment's o partial and pool (rank 0, layer 0, a (1, 2) mesh)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    mode = CacheMode.INT8
    plan, packed = cs.mk_plan_pack(cfg, params, cs.DECODE_BATCH, mode)
    st = cs.mk_state(cfg, mode, cs.DECODE_BATCH, cs.MK_LENS, cs.MK_INACTIVE,
                     gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    _keep(f"{name}_logits", mk.decode_megakernel(
        plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
        st["active"], st["cache"]))
    _keep(f"{name}_pool_k", st["cache"].k)
    _keep(f"{name}_pool_k_qp", st["cache"].k_qparams)
    mk.check_status(plan, dev)
    del st, plan, packed
    if tp:
        s = cs.tp_setup(cfg, params, 2, "INT8", gen, dev)
        st = s["st"]
        _keep(f"{name}_tp_attn_o", tpk.tp_attn_segment(
            s["plan"], s["packs"][0], 0, s["x0"].float(), st["cos"],
            st["sin"], st["pt"], st["lens"], st["active"], s["caches"][0]))
        _keep(f"{name}_tp_attn_pool_k", s["caches"][0].k)
        _keep(f"{name}_tp_attn_pool_v", s["caches"][0].v)
        tpk.check_status(s["plan"], dev)
        del s, st
    torch.cuda.empty_cache()


def _kernels(cs, root: str) -> dict:
    """`--kernels`: the per-op attention and grouped GEMM of `root`."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda", 0)
    out = {"root": root}
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        cfg = ModelConfig(**cs.QWEN2_7B)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        mode = CacheMode.INT8
        for name, mcfg in (("G7", None), ("G1", cs.moe_config())):
            cache, pt, lens, q, _ = cs.paged_case(mode, gen, dev, mcfg)
            args = (q.to(torch.bfloat16), cache, mode, pt, lens, scale)
            out[f"pa_check_{name}_ms"] = cs.time_ms(pa.paged_attention,
                                                    [args], iters=50)
            del cache
        L = cfg.num_layers
        for B in (8, 32):
            st = cs.mk_state(cfg, mode, B, LONG_LENS * (B // 8), None, gen,
                             dev)
            qb = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                             device=dev).to(torch.bfloat16)
            per_layer = [(qb, st["cache"], mode,
                          (st["pt"] * L + l).to(torch.int32), st["lens"],
                          scale) for l in range(L)]
            out[f"pa_long_B{B}_cold_ms"] = cs.time_ms(pa.paged_attention,
                                                      per_layer, iters=L)
            del st, per_layer
            torch.cuda.empty_cache()
        mcfg = cs.moe_config(layers=1)
        leaves = _gqm_leaves(cs, mcfg, dev)
        E, k = mcfg.moe.num_experts, mcfg.moe.num_experts_per_tok
        TM = gqm.default_tm()
        gen.manual_seed(cs.SEED + 12)
        for T in GQM_TS:
            topk_i = torch.rand((T, E), generator=gen,
                                device=dev).topk(k).indices
            order, stok, pos, te = gqm.build_group_layout(topk_i, E, TM)
            trows = gqm.tile_row_counts(pos, te.shape[0], TM)
            for name, leaf in leaves.items():
                K = leaf["w_q"].shape[1]
                xs = torch.zeros((te.shape[0] * TM, K), dtype=torch.bfloat16,
                                 device=dev)
                xs[pos] = torch.randn((T * k, K), generator=gen,
                                      device=dev).to(torch.bfloat16)
                out[f"gqm_{name}_T{T}_ms"] = cs.time_ms(
                    lambda: gqm.grouped_quant_matmul(xs, te, leaf,
                                                     tile_rows=trows),
                    [()], iters=20)
        out["gqm_layer_T32_ms"] = (2 * out["gqm_gate_T32_ms"] +
                                   out["gqm_down_T32_ms"])
        del leaves, xs
        torch.cuda.empty_cache()
        from dashinfer_tpu_torch.tools import bench_stream
        u4 = bench_stream.measure_rates(cs.DECODE_BATCH, dev,
                                        formats=("u4_g128",))[0]
        out["stream_u4_B8_ms"] = u4["ms"]
        out["stream_u4_B8_gbps"] = u4["gbps"]
        for name, fcfg, make in (
                ("qwen2_7b", cfg, lambda: cs.random_qwen2_7b_params(
                    cs.SEED, dev)),
                ("qwen15_moe", cs.moe_config(), lambda: cs.random_moe_params(
                    cs.moe_config(), cs.SEED + 13, dev))):
            params = make()
            out.update(_per_op(cs, name, fcfg, params, mode, gen, dev))
            out.update(_tp(cs, name, fcfg, params, gen, dev))
            del params
            torch.cuda.empty_cache()
        out.update(_qmm(cs, dev, gen))
    return out


def _noise(root: str) -> dict:
    """`--noise`: `gumbel_noise` of `root` for a decode step of B seeded
    rows, computed on the card ("card") and computed on the host, then
    copied ("host"). host_ms: the caller's time a call, NOISE_CALLS in a
    row; device_ms: the card's time a call, the calls queued behind a
    `torch.cuda._sleep` longer than their host time, so that the card runs
    them back to back; synced_ms: a call and a sync; step_ms: what a call
    adds to a step whose forward keeps the card busy NOISE_FORWARD_MS (a
    sleep of that length, the call, a sync; less the same without the
    call)."""
    import time
    import torch
    from dashinfer_tpu_torch.ops import sampling
    dev = torch.device("cuda", 0)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    e0.record()
    torch.cuda._sleep(10_000_000)
    e1.record()
    e1.synchronize()
    per_ms = 10_000_000 / e0.elapsed_time(e1)         # sleep cycles a ms

    def step(call, n):
        t0 = time.perf_counter()
        for i in range(n):
            torch.cuda._sleep(int(NOISE_FORWARD_MS * per_ms))
            if call is not None:
                call(i)
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    out = {"root": root, "sleep_cycles_per_ms": per_ms}
    for B in NOISE_BATCHES:
        for where in ("card", "host"):
            def call(i):
                rows = [(1000 + 7 * b, 37 + i) for b in range(B)]
                if where == "card":
                    return sampling.gumbel_noise(rows, NOISE_K, dev)
                return sampling.gumbel_noise(rows, NOISE_K, "cpu").to(
                    dev, non_blocking=True)

            for i in range(5):
                call(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(NOISE_CALLS):
                call(i)
            host = (time.perf_counter() - t0) / NOISE_CALLS
            torch.cuda.synchronize()
            torch.cuda._sleep(int((2e3 * host * NOISE_CALLS + 50) * per_ms))
            e0.record()
            for i in range(NOISE_CALLS):
                call(i)
            e1.record()
            e1.synchronize()
            t0 = time.perf_counter()
            for i in range(NOISE_CALLS):
                call(i)
                torch.cuda.synchronize()
            synced = (time.perf_counter() - t0) / NOISE_CALLS
            bare = step(None, NOISE_CALLS)
            out[f"{where}_B{B}"] = {
                "host_ms": 1e3 * host,
                "device_ms": e0.elapsed_time(e1) / NOISE_CALLS,
                "synced_ms": 1e3 * synced,
                "step_ms": step(call, NOISE_CALLS) - bare}
    return out


def _one(root: str, build_only: bool, mode: str) -> None:
    """Runs in the child: everything is imported from `root`."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path[0] = root
    import torch
    import chip_smoke as cs
    from dashinfer_tpu_torch.ops import kernel_build
    kernel_build.build([source for source, _ in _KERNELS[mode]])
    if build_only:
        regs, warns = [], []
        for source, entry in _KERNELS[mode]:
            lines = kernel_build.build_logs.get(source, "").splitlines()
            regs += [" ".join(lines[i:i + 4]) for i, ln in enumerate(lines)
                     if "Compiling entry function" in ln and entry in ln]
            warns += [ln for ln in lines if "C75" in ln]
        print("AB_BUILD", json.dumps({"root": root, "ptxas": regs,
                                      "wgmma_warnings": warns}), flush=True)
        return
    try:
        _run(cs, root, mode)
    finally:
        if os.environ.get("AB_DUMP") and _DUMPS:
            torch.save(_DUMPS, os.environ["AB_DUMP"])


def _run(cs, root: str, mode: str) -> None:
    import torch
    from dashinfer_tpu_torch.config import ModelConfig
    if mode == "tp":
        print("AB", json.dumps(_tp_models(cs, root)), flush=True)
        return
    if mode == "kernels":
        print("AB", json.dumps(_kernels(cs, root)), flush=True)
        return
    if mode == "qmm":
        print("AB", json.dumps(_qmm_forwards(cs, root)), flush=True)
        return
    if mode == "noise":
        print("AB", json.dumps(_noise(root)), flush=True)
        return
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    if mode == "moe":
        cfg = cs.moe_config()
        params = cs.random_moe_params(cfg, cs.SEED + 13, dev)
        out = {"root": root}
        for B in MOE_BATCHES:
            lens = cs.MK_LENS if B == 8 else \
                [(37 + 61 * i) % 1500 + 1 for i in range(B)]
            row = cs.time_megakernel(cfg, params, "u4 MoE", B, lens, gen,
                                     dev, per_op=False)
            out[f"ms_B{B}"] = row["ms"]
            out[f"B{B}"] = {k: row[k] for k in ("no_attention_ms", "phases",
                                                "bytes_ms")}
        _keep_decode(cs, "moe", cfg, params, dev, tp=False)
        print("AB", json.dumps(out), flush=True)
        return
    cfg = ModelConfig(**cs.QWEN2_7B)
    params = cs.random_qwen2_7b_params(cs.SEED, dev)
    if mode == "lm_splits":
        print("AB", json.dumps(dict(root=root, **_lm_splits(
            cs, cfg, params, gen, dev))), flush=True)
        return
    if mode == "decode":
        out = {"root": root}
        lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
        i8 = None
        for name, stream, B, lens in (
                ("u4_B8", "u4", 8, cs.MK_LENS),
                ("u4_B8_long", "u4", 8, LONG_LENS),
                ("u4_B32", "u4", 32, lens32),
                ("i8_B8", "i8", 8, cs.MK_LENS),
                ("i8_B32", "i8", 32, lens32)):
            if stream == "i8" and i8 is None:
                embed = params["embed_tokens"]
                del params
                torch.cuda.empty_cache()
                i8 = cs.random_qwen2_7b_params(cs.SEED + 1, dev, stream="i8")
                i8["embed_tokens"] = embed
            row = cs.time_megakernel(cfg, params if stream == "u4" else i8,
                                     stream, B, lens, gen, dev, per_op=False)
            out[name] = {k: row[k] for k in ("ms", "no_attention_ms",
                                             "phases", "bytes_ms")}
            if name == "u4_B8":
                _keep_decode(cs, "u4", cfg, params, dev, tp=True)
        print("AB", json.dumps(out), flush=True)
        return
    out = {"root": root}
    tp_only = mode == "tp_prefill"
    if not tp_only:
        out.update(_prefill(cs, "u4", cfg, params, gen, dev))
    out.update(_tp_prefill(cs, cfg, params, gen, dev))
    embed = params["embed_tokens"]
    del params
    torch.cuda.empty_cache()
    i8 = cs.random_qwen2_7b_params(cs.SEED + 1, dev, stream="i8")
    i8["embed_tokens"] = embed
    if not tp_only:
        out.update(_prefill(cs, "i8", cfg, i8, gen, dev))
    out.update(_tp_prefill(cs, cfg, i8, gen, dev, "i8"))
    del i8, embed
    torch.cuda.empty_cache()
    out.update(_lm_shards(cs, gen, dev))
    if tp_only:
        print("AB", json.dumps(out), flush=True)
        return
    mcfg = cs.moe_config()
    out.update(_prefill(cs, "moe_u4", mcfg, cs.random_moe_params(
        mcfg, cs.SEED + 13, dev), gen, dev))
    print("AB", json.dumps(out), flush=True)


def main(argv) -> int:
    flag = [a for a in argv if a in _FLAGS]
    mode = _FLAGS[flag[0]] if flag else "decode"
    if argv[:1] in (["--one"], ["--build"]):
        _one(argv[-1], argv[0] == "--build", mode)
        return 0
    roots = [a for a in argv if a not in _FLAGS]
    if not roots:
        print(__doc__)
        return 2
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", *flag, r],
                               stdout=subprocess.PIPE, text=True)
              for r in dict.fromkeys(roots)]
    rc = 0
    for p in builds:
        out, _ = p.communicate()
        rc |= p.returncode
        print("\n".join(ln for ln in out.splitlines()
                        if ln.startswith("AB_BUILD")), flush=True)
    if rc:
        return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dump_dir = os.path.abspath(os.path.join("build", "ab_dump", mode))
    os.makedirs(dump_dir, exist_ok=True)
    dumps = []
    for i, r in enumerate(roots):
        dumps.append(os.path.join(dump_dir, f"{i}.pt"))
        if os.path.exists(dumps[-1]):
            os.remove(dumps[-1])
        out = subprocess.run([sys.executable, me, "--one", *flag, r],
                             capture_output=True, text=True,
                             env=dict(os.environ, AB_DUMP=dumps[-1]))
        print("\n".join(ln for ln in out.stdout.splitlines()
                        if ln.startswith("AB")) or out.stderr[-2000:],
              flush=True)
        rc |= out.returncode
    print("AB_DIFF", json.dumps(_diffs(roots, dumps)), flush=True)
    return rc


def _diffs(roots, dumps) -> dict:
    """For each kept output, the largest |difference| of each run's from
    the first run's (None where a run did not keep it; a different shape
    or dtype: the string "shape")."""
    import torch
    kept = [torch.load(p) if os.path.exists(p) else {} for p in dumps]
    out = {}
    for name, ref in kept[0].items():
        row = {}
        for i, k in enumerate(kept[1:], 1):
            t = k.get(name)
            key = f"run{i} {roots[i]}"
            if t is None:
                row[key] = None
            elif t.shape != ref.shape or t.dtype != ref.dtype:
                row[key] = "shape"
            elif t.is_floating_point():
                d = (t - ref).abs()
                both_nan = torch.isnan(t) & torch.isnan(ref)
                row[key] = float(torch.where(both_nan, 0.0, d).max()) \
                    if d.numel() else 0.0
            else:
                row[key] = int((t.long() - ref.long()).abs().max()) \
                    if t.numel() else 0
        out[name] = row
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
