"""Weight-only quantization at load time (a16w8 / a16w4).

InstantQuant (reference python/pyhie/allspark/quantization.py:13-80):
asymmetric scale+zero, per-channel or group-wise, INT8 or UINT4. A copy of
the weight-only part of `dashinfer_tpu.loader.quantize` in numpy, so that
both packages produce bit-equal leaves from the same weights.

Quantized leaf format (consumed by ops/linear.py + the quant_matmul kernel):
  {"w_q": [*, in, out] int8 | [*, in, out/2] uint8 packed,
   "scale"/"zero": [*, groups, out] f32}     (bits inferred from dtype)
MoE expert stacks [L, E, in, out] give leaves with the leading [L, E].
Per-channel = groups 1. Dequant: w = q * scale + zero.
"""

import re
from typing import Dict

import numpy as np

from dashinfer_tpu_torch.config import QuantConfig
from dashinfer_tpu_torch.ops.u4pack import pack_u4_weight
from dashinfer_tpu_torch.utils import get_logger

logger = get_logger("quantize")


def quantize_weight(w: np.ndarray, bits: int, group_size: int) -> Dict:
    """w: [in, out] float -> quantized leaf (numpy)."""
    K, N = w.shape
    gs = K if group_size <= 0 else group_size
    if K % gs:
        raise ValueError(f"in dim {K} not divisible by group size {gs}")
    G = K // gs
    wf = np.asarray(w, np.float32).reshape(G, gs, N)
    wmin = wf.min(axis=1)                      # [G, N]
    wmax = wf.max(axis=1)
    if bits == 8:
        scale = np.maximum((wmax - wmin) / 255.0, 1e-8)
        q = np.clip(np.rint((wf - wmin[:, None]) / scale[:, None]) - 128,
                    -128, 127).astype(np.int8)
        zero = wmin + 128.0 * scale
        w_q = q.reshape(K, N)
    elif bits == 4:
        scale = np.maximum((wmax - wmin) / 15.0, 1e-8)
        q = np.clip(np.rint((wf - wmin[:, None]) / scale[:, None]),
                    0, 15).astype(np.uint8).reshape(K, N)
        w_q = pack_u4_weight(q)
        zero = wmin
    else:
        raise ValueError(bits)
    return {"w_q": w_q, "scale": scale.astype(np.float32),
            "zero": zero.astype(np.float32)}


def _quantize_stacked(w: np.ndarray, bits: int, gs: int) -> Dict:
    """w: [L, in, out] -> leaves stacked over L."""
    outs = [quantize_weight(w[l], bits, gs) for l in range(w.shape[0])]
    return {
        "w_q": np.stack([o["w_q"] for o in outs]),
        "scale": np.stack([o["scale"] for o in outs]),
        "zero": np.stack([o["zero"] for o in outs]),
    }


def quantize_params(params: Dict, quant: QuantConfig) -> Dict:
    """Walk a numpy params tree; quantize the stacked layer linear weights
    whose path matches the include regex (same walk as the JAX package)."""
    if quant.mode in ("none", ""):
        return params
    if quant.mode not in ("a16w8", "a16w4"):
        raise NotImplementedError(
            f"quant mode {quant.mode!r} is not ported to the PyTorch "
            "package yet (weight-only a16w8/a16w4 only)")
    bits = 8 if quant.mode == "a16w8" else 4
    pattern = re.compile(quant.include)
    n_q = 0

    def walk(tree, path=""):
        nonlocal n_q
        if isinstance(tree, dict):
            if "w" in tree and not isinstance(tree["w"], dict):
                if pattern.match(path) and tree["w"].ndim == 3:
                    out = _quantize_stacked(np.asarray(tree["w"], np.float32),
                                            bits, quant.group_size)
                    if "b" in tree:
                        out["b"] = tree["b"]
                    n_q += 1
                    return out
                return tree
            return {k: walk(v, f"{path}{k}/") for k, v in tree.items()}
        if getattr(tree, "ndim", 0) == 4 and pattern.match(path):
            # stacked MoE expert weights [L, E, in, out] -> per-(layer,
            # expert) weight-only leaves [L, E, in, out(/2)] + [L, E, G, out]
            w = np.asarray(tree, np.float32)
            L, E = w.shape[:2]
            out = _quantize_stacked(w.reshape(L * E, *w.shape[2:]), bits,
                                    quant.group_size)
            n_q += 1
            return {k: v.reshape((L, E) + v.shape[1:])
                    for k, v in out.items()}
        return tree

    out = walk(params)
    logger.info("quantized %d weight stacks to %s (group_size=%d)", n_q,
                quant.mode, quant.group_size)
    return out
