"""What holds csrc/quant_matmul.cu back: the kernel beside a copy of it
whose consumer warps skip the dot (the producer's ring, the x and qparam
copies, the partials and their sums all run), on one card; or, with
`--splits`, the kernel at each split count the card admits.

Builds the copy from the checkout's source with its full-chunk dot loop
cut out, then times both (CUDA-graph replay of cold calls, chip_smoke.py's
`time_ms`) at Qwen2-7B's projection shapes, u4 group 128, M = 8 and 32,
with the wrapper's split plan. With `--splits`, times the kernel over K
split 1, 2, 3, .. ways (up to one wave of the card's resident blocks) at
q|o, k|v (group 128 and per-channel), gate|up and down, M = 8, 16 and 32
(at 32 with one block for the 32 rows and with two of 16), each output
held to the plain version's (max|d| / max|ref|), beside the wrapper's own
choice. Prints JSON lines, and the card's `nvidia-smi` name
and power limit.

    python -m dashinfer_tpu_torch.tools.qmm_probe
    python -m dashinfer_tpu_torch.tools.qmm_probe --splits
"""

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

_DOT = ("for (int ks = 0; ks < kStageRows / 16; ++ks)\n"
        "          dot_step(st, ks, rows, false);")
SHAPES = (("q_proj", 3584, 3584), ("k_proj", 3584, 512),
          ("gate_proj", 3584, 18944), ("down_proj", 18944, 3584),
          ("lm_head", 3584, 152064))
GROUP = 128
# --splits: (name, K, N, K rows a quant group) and the split counts tried
SPLIT_SHAPES = (("q_proj", 3584, 3584, 128), ("k_proj", 3584, 512, 128),
                ("k_proj_per_channel", 3584, 512, 3584),
                ("gate_proj", 3584, 18944, 128),
                ("down_proj", 18944, 3584, 128))
SPLIT_COUNTS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64)


def _stream_only(kernel_build) -> ctypes._CFuncPtr:
    """The kernel with its full chunks' dot loop cut out, built beside the
    checkout's kernels."""
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    with open(os.path.join(kernel_build.CSRC_DIR, "quant_matmul.cu")) as f:
        src = f.read()
    if _DOT not in src:
        raise RuntimeError("qmm_probe: the kernel's dot loop moved; update "
                           "_DOT")
    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(kernel_build.BUILD_DIR, "quant_matmul_stream.cu")
    lib = os.path.join(kernel_build.BUILD_DIR, "libquant_matmul_stream.so")
    with open(path, "w") as f:
        f.write(src.replace(_DOT, "/* the dot cut out */"))
    subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS,
                    "-I", kernel_build.CSRC_DIR, "-o", lib, path],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).di_quant_matmul
    fn.argtypes = qm._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _splits(cs, qm, dev) -> None:
    """`--splits`: one JSON line a (shape, M, split count)."""
    import torch
    sc = qm._scratch_for(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for name, K, N, group in SPLIT_SHAPES:
        leaf = cs.random_qleaf(K, N, gen, dev, 4, group)
        w_bytes = sum(t.numel() * t.element_size() for t in leaf.values())
        leaves = [leaf] + [cs.random_qleaf(K, N, gen, dev, 4, group)
                           for _ in range(cs.copies_for(w_bytes) - 1)]
        for M in (8, 16, 32):
            x = torch.randn((M, K), generator=gen,
                            device=dev).to(torch.bfloat16)
            ref = qm.quant_matmul_plain(x, leaf).float()
            plan = qm.split_plan(K, N, K // group, M, 4, sc.sms,
                                 sc.blocks_per_sm)
            grids = []
            for slices in ((1, 2) if M > 16 else (1,)):
                cap = min(plan.chunks, sc.blocks_per_sm * sc.sms //
                          (plan.cols * slices))
                grids += [(slices, s) for s in sorted(
                    {s for s in SPLIT_COUNTS if s <= cap} |
                    ({plan.splits} if slices == plan.slices else set()))]
            for slices, splits in grids:
                p = dataclasses.replace(plan, slices=slices, splits=splits)

                def call(x, w, p=p):
                    o = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                    qm._launch(x, w, o, p)
                    return o
                err = ((call(x, leaf).float() - ref).abs().max() /
                       ref.abs().max()).item()
                us = 1000 * cs.time_ms(call, [(x, w) for w in leaves])
                print(json.dumps(dict(
                    shape=name, M=M, slices=slices, splits=splits,
                    cols=plan.cols, tb=plan.tb,
                    plan=[plan.slices, plan.splits], us=us, err=err)),
                    flush=True)
        del leaves, leaf
        torch.cuda.empty_cache()
    qm.check_status(dev)


def main(argv) -> int:
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dashinfer_tpu_torch.ops import kernel_build
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    dev = torch.device("cuda", 0)
    if argv == ["--splits"]:
        with torch.no_grad():
            _splits(cs, qm, dev)
        print("nvidia-smi:", cs.nvidia_smi_line(), flush=True)
        return 0
    kernel_build.build(["quant_matmul"])
    stream = _stream_only(kernel_build)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    sc = qm._scratch_for(dev)
    out = {}
    with torch.no_grad():
        for name, K, N in SHAPES:
            leaf = cs.random_qleaf(K, N, gen, dev, 4, GROUP)
            w_bytes = sum(t.numel() * t.element_size() for t in leaf.values())
            leaves = [leaf] + [cs.random_qleaf(K, N, gen, dev, 4, GROUP)
                               for _ in range(cs.copies_for(w_bytes) - 1)]
            for M in (8, 32):
                x = torch.randn((M, K), generator=gen,
                                device=dev).to(torch.bfloat16)
                plan = qm.split_plan(K, N, K // GROUP, M, 4, sc.sms,
                                     sc.blocks_per_sm)

                def stream_only(x, w):
                    o = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                    qm._launch(x, w, o, plan, fn=stream)

                args = [(x, w) for w in leaves]
                key = f"{name}_M{M}"
                out[f"{key}_ms"] = cs.time_ms(
                    lambda x, w: qm.quant_matmul(x, w), args)
                out[f"{key}_stream_only_ms"] = cs.time_ms(stream_only, args)
                out[f"{key}_bytes_ms"] = cs.bounds(w_bytes, 0)["bytes_ms"]
                out[f"{key}_plan"] = [plan.tb, plan.splits]
            del leaves, leaf
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print("nvidia-smi:", cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
