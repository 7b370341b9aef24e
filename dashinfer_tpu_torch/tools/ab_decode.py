"""The decode or prefill megakernel of two checkouts, side by side on one
card.

Times one decode forward of csrc/megakernel.cu at Qwen2-7B width (a16w4,
B = 8, INT8 KV, chip_smoke.py's state and random weights), with `--moe`
one decode forward of its MoE branch at Qwen1.5-MoE-A2.7B width at B = 8
and B = 32 (chip_smoke.py's MoE weights and states), or with `--prefill`
one launch of csrc/prefill_megakernel.cu for a full bucket of 128 and of
1024 (the Qwen2-7B weights, INT8 KV, chip_smoke.py's inputs), for each
checkout root given, in the order given, each in a process of its own
that imports that checkout's `dashinfer_tpu_torch` and `chip_smoke.py`.
The kernels are built first, all roots at once. Give the parent and the
change as `PARENT CHANGE CHANGE PARENT` to see drift between runs. Prints
one JSON line a run, the card's `nvidia-smi` name and power limit, and the
ptxas registers and spills of each root's kernel instantiations.

    python -m dashinfer_tpu_torch.tools.ab_decode build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --moe build/parent . . build/parent
    python -m dashinfer_tpu_torch.tools.ab_decode --prefill build/parent . . build/parent
"""

import json
import os
import subprocess
import sys

# (kernel source, its entry function's name in the ptxas log) by mode
_KERNELS = {"decode": ("megakernel", "mk_kernel"),
            "moe": ("megakernel", "mk_kernel"),
            "prefill": ("prefill_megakernel", "pmk_kernel")}
_FLAGS = {"--prefill": "prefill", "--moe": "moe"}
PREFILL_BUCKETS = (128, 1024)
MOE_BATCHES = (8, 32)


def _one(root: str, build_only: bool, mode: str) -> None:
    """Runs in the child: everything is imported from `root`."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path[0] = root
    import torch
    import chip_smoke as cs
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import kernel_build
    source, entry = _KERNELS[mode]
    kernel_build.build([source])
    if build_only:
        log = kernel_build.build_logs.get(source, "")
        lines = log.splitlines()
        regs = [" ".join(lines[i:i + 3]) for i, ln in enumerate(lines)
                if "Compiling entry function" in ln and entry in ln]
        print("AB_BUILD", json.dumps({"root": root, "ptxas": regs}),
              flush=True)
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
        print("AB", json.dumps(out), flush=True)
        return
    cfg = ModelConfig(**cs.QWEN2_7B)
    params = cs.random_qwen2_7b_params(cs.SEED, dev)
    if mode == "decode":
        row = cs.time_megakernel(cfg, params, "u4", 8, cs.MK_LENS, gen, dev,
                                 per_op=False)
        print("AB", json.dumps({"root": root, "ms": row["ms"],
                                "no_attention_ms": row["no_attention_ms"]}),
              flush=True)
        return
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    out = {"root": root}
    for bucket in PREFILL_BUCKETS:
        plan, packed = cs.pmk_plan_pack(cfg, params, bucket, CacheMode.INT8)
        st = cs.pmk_inputs(cfg, params, plan, CacheMode.INT8, bucket, gen,
                           dev)
        args = (plan, packed, st["x0"], st["cos"], st["sin"],
                st["page_row"], st["n"], st["cache"])
        out[f"ms_{bucket}"] = cs.time_ms(pmk.prefill_megakernel, [args],
                                         iters=5)
        pmk.check_status(dev)
        del st, packed
        torch.cuda.empty_cache()
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
