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
u4) at the same buckets, or with
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
Qwen1.5-MoE at B = 8 on chip_smoke.py's INT8 state, or with `--noise` the
sampler's Gumbel noise of one decode step (`ops/sampling.py`
`gumbel_noise`, every row seeded, K = 128, B = 8 and 32) drawn on the card
and drawn on the host and copied: host ms a call, device ms a call with
the host ahead, ms to the noise's arrival, and ms it adds to a step behind
a 4.5 ms forward, for each checkout root
given, in the order
given, each in a process of its own that imports that checkout's
`dashinfer_tpu_torch` and `chip_smoke.py`.
The kernels are built first, all roots at once. Give the parent and the
change as `PARENT CHANGE CHANGE PARENT` to see drift between runs. Prints
one JSON line a run, the card's `nvidia-smi` name and power limit, and the
ptxas registers and spills of each root's kernel instantiations.

    python -m dashinfer_tpu_torch.tools.ab_decode build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --moe build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --prefill build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --kernels build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --noise build/parent . . build/parent
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
            "kernels": (("paged_attention", "pa_kernel"),
                        ("grouped_quant_matmul", "gqm_kernel"),
                        ("stream_probe", "sp_product"),
                        ("tp_segments", "seg_kernel")),
            "noise": ()}
_FLAGS = {"--prefill": "prefill", "--moe": "moe", "--kernels": "kernels",
          "--noise": "noise"}
PREFILL_BUCKETS = (128, 256, 512, 1024)
PREFILL_TRACED = (128, 1024)
MOE_BATCHES = (8, 32)
GQM_TS = (32, 128, 1024)
LONG_LENS = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
NOISE_BATCHES = (8, 32)
NOISE_K = 128                 # RuntimeConfig.sampler_max_top_k's default
NOISE_CALLS = 50
NOISE_FORWARD_MS = 4.5        # the Qwen2-7B decode forward at B = 8


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
    names = getattr(tpk, "ATTN_SEG_PHASES", None)
    if names:           # a checkout whose attn segment takes a trace
        trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                            device=dev)
        tpk.tp_attn_segment(s["plan"], s["packs"][0], 0, s["x0"].float(),
                            *step, s["caches"][0], trace=trace)
        out[f"tp_{name}_attn_phases"] = mk.phase_times_of(names, trace)
    names = getattr(tpk, "MOE_SEG_PHASES", None)
    if cfg.moe and names:   # a checkout whose moe segment takes a trace
        trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                            device=dev)
        tpk.tp_moe_segment(s["plan"], s["packs"][0], 0, s["x0"].float(), 0,
                           st["active"], trace=trace)
        tpk.check_status(s["plan"], dev)
        out[f"tp_{name}_moe_phases"] = mk.phase_times_of(names, trace)
    if cfg.moe:             # the moe segment and the step at UINT4 and B = 32
        for mode, B in (("UINT4", cs.DECODE_BATCH), ("INT8", 32)):
            s2 = cs.tp_moe_setup(cfg, params, 2, mode, B, gen, dev)
            st2 = s2["st"]
            x2, act2 = s2["x0"].float(), st2["active"]
            key = f"tp_{name}_{mode.lower()}_B{B}"
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


def _tp_prefill(cs, cfg, params, gen, dev) -> dict:
    """ms a launch of each TP prefill segment (rank 0, layer 0, a (1, 2)
    mesh whose ranks share the card, INT8 KV) for each full bucket."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = cs.tp_prefill_setup(cfg, params, 2, dev)
    rt = cs.tp_prefill_rt(2, CacheMode.INT8)
    plans = tpk.make_tp_prefill_plans(cfg, rt, s["parts"],
                                      list(PREFILL_BUCKETS), s["tp_plan"])
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
            out[f"tp_prefill_{seg}_ms_{bucket}"] = cs.time_ms(fn, [()],
                                                              iters=10)
            tpk.check_prefill_status(dev)
        del st
        torch.cuda.empty_cache()
    return out


def _kernels(cs, root: str) -> dict:
    """`--kernels`: the per-op attention and grouped GEMM of `root`."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.models import transformer
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
            st = cs.mk_state(fcfg, mode, 8, cs.MK_LENS, None, gen, dev)
            out[f"per_op_decode_{name}_ms"] = cs.time_ms(
                lambda: transformer.decode_forward(
                    fcfg, params, st["tokens"], st["cache"], st["pt"],
                    st["lens"], st["active"], mode=mode), [()], iters=3)
            del st
            torch.cuda.empty_cache()
            out.update(_tp(cs, name, fcfg, params, gen, dev))
            del params
            torch.cuda.empty_cache()
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
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import kernel_build
    kernel_build.build([source for source, _ in _KERNELS[mode]])
    if build_only:
        regs = []
        for source, entry in _KERNELS[mode]:
            lines = kernel_build.build_logs.get(source, "").splitlines()
            regs += [" ".join(lines[i:i + 3]) for i, ln in enumerate(lines)
                     if "Compiling entry function" in ln and entry in ln]
        print("AB_BUILD", json.dumps({"root": root, "ptxas": regs}),
              flush=True)
        return
    if mode == "kernels":
        print("AB", json.dumps(_kernels(cs, root)), flush=True)
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
        print("AB", json.dumps(out), flush=True)
        return
    cfg = ModelConfig(**cs.QWEN2_7B)
    params = cs.random_qwen2_7b_params(cs.SEED, dev)
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
        print("AB", json.dumps(out), flush=True)
        return
    out = {"root": root}
    out.update(_prefill(cs, "u4", cfg, params, gen, dev))
    out.update(_tp_prefill(cs, cfg, params, gen, dev))
    embed = params["embed_tokens"]
    del params
    torch.cuda.empty_cache()
    i8 = cs.random_qwen2_7b_params(cs.SEED + 1, dev, stream="i8")
    i8["embed_tokens"] = embed
    out.update(_prefill(cs, "i8", cfg, i8, gen, dev))
    del i8, embed
    torch.cuda.empty_cache()
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
    for r in roots:
        out = subprocess.run([sys.executable, me, "--one", *flag, r],
                             capture_output=True, text=True)
        print("\n".join(ln for ln in out.stdout.splitlines()
                        if ln.startswith("AB")) or out.stderr[-2000:],
              flush=True)
        rc |= out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
