"""Grouped (expert-batched) fused-dequant GEMM for MoE layers.

Counterpart of `dashinfer_tpu.ops.pallas.grouped_quant_matmul`. Tokens are
sorted by expert and each expert's segment is padded up to the M tile, so
every TM-row tile of the buffer belongs to one expert (`build_group_layout`;
the static `Mcap = rup(T*k, TM) + E*TM` keeps the call free of host syncs
and CUDA-graph capturable). `tile_expert` then picks the expert's quantized
weights per tile. What lives here:

* `build_group_layout`, `default_tm`, `supports_grouped`;
* `repack_expert_u4_tile128` / `prepare_grouped_experts`: the install-time
  re-layout of an expert stack whose columns are not a multiple of 256
  (Qwen1.5-MoE's moe_intermediate_size 1408) into the kernel's layout,
  zero-padded. The JAX package keeps it beside the loader's leaf (keys
  w_qg / scale_g / zero_g); the port puts it in the leaf's place, because
  nothing on the card reads the unpadded layout (the megakernels' pack is
  made from it, and the ragged route drops the padded columns). u4 stacks
  get it as in the JAX package; int8 stacks of N % 256 == 128 get it too,
  because the CUDA kernel's column tile is 256 wide where the TPU kernel's
  int8 tile is 128;
* `grouped_quant_matmul`, the wrapper that launches
  csrc/grouped_quant_matmul.cu on CUDA tensors (its plain version only for
  CPU tensors), with its launch count `grouped_quant_matmul.counter`, and
  `grouped_quant_matmul_plain`, the Pallas `_gkernel`'s formulation:
  bf16 operands, the affine after the dot per K tile
  (`acc += part * scale + xsum * zero`, xsum over the f32 x), f32 sums;
* the wrapper's host-side rules as pure functions: `check_operands` (what
  the kernel refuses) and `block_shape` (which of the kernel's block
  shapes a call takes, from static shapes; the kernel's launch derives its
  grid and shared memory from that shape).
"""

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.ops.u4pack import weight_levels
from dashinfer_tpu_torch.utils import EnvConfig

_P, _I = ctypes.c_void_p, ctypes.c_int
# xs, tile_expert, tile_rows, w, bits, scale, zero, out, Mcap, K, N, G, E,
# TM, shape, launches, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
             _P]
KERNEL_TMS = (16, 32, 64)     # M tiles the CUDA kernel is built for
# csrc/grouped_quant_matmul.cu's block shapes (kShapes): payload bytes a
# lane reads of a K row (a block's item: 32x that), tile rows a block
# covers, ring stages
SHAPES = ((2, 32, 4), (4, 16, 4), (4, 32, 3))
ONE_ROW, FEW_ROWS = 1.5, 12   # rows an expert gets on average: shape rule


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def default_tm() -> int:
    """M tile: small enough that per-expert boundary padding stays cheap
    (E * TM/2 dummy rows on average), large enough to fill the tensor
    cores' 16-row tiles."""
    return EnvConfig.gqm_tm()


# ---------------------------------------------------------------------------
# install-time repack
# ---------------------------------------------------------------------------

def _needs_repack(w_q, N: int) -> bool:
    return N % 256 != 0 and str(w_q.dtype) in ("uint8", "int8",
                                               "torch.uint8", "torch.int8")


def repack_expert_u4_tile128(leaf: Dict, N: int) -> Dict:
    """leaf arrays [L, E, K, N/2] plain-halves u4 + [L, E, G, N] qparams ->
    zero-padded TILE-128 arrays under new keys (numpy in, numpy out; the
    JAX package's function, byte for byte)."""
    w_q = np.asarray(leaf["w_q"])
    L, E, K, half = w_q.shape
    assert half * 2 == N, (w_q.shape, N)
    Np = _round_up(N, 256)
    lo = (w_q & np.uint8(0xF)).reshape(L * E * K, half)
    hi = (w_q >> np.uint8(4)).reshape(L * E * K, half)
    q = np.zeros((L * E * K, Np), np.uint8)
    q[:, :half] = lo
    q[:, half:N] = hi
    del lo, hi
    t = q.reshape(-1, Np // 256, 2, 128)
    w_qg = (t[:, :, 0] | (t[:, :, 1] << np.uint8(4))).reshape(L, E, K,
                                                              Np // 2)
    del q, t
    return dict(w_qg=w_qg, **_padded_qparams(leaf, N, Np))


def _padded_qparams(leaf: Dict, N: int, Np: int) -> Dict:
    scale = np.asarray(leaf["scale"], np.float32)
    zero = np.asarray(leaf["zero"], np.float32)
    scale_g = np.ones(scale.shape[:-1] + (Np,), np.float32)
    zero_g = np.zeros(zero.shape[:-1] + (Np,), np.float32)
    scale_g[..., :N] = scale
    zero_g[..., :N] = zero
    return {"scale_g": scale_g, "zero_g": zero_g}


def _repack_tensor_leaf(leaf: Dict, N: int) -> Dict:
    """`repack_expert_u4_tile128` (and the int8 zero-padding) for tensor
    leaves, on their device, one layer at a time."""
    w_q = leaf["w_q"]
    Np = _round_up(N, 256)
    if w_q.dtype == torch.int8:
        w_qg = torch.zeros(w_q.shape[:-1] + (Np,), dtype=torch.int8,
                           device=w_q.device)
        w_qg[..., :N] = w_q
    else:
        L, E, K, half = w_q.shape
        w_qg = torch.empty((L, E, K, Np // 2), dtype=torch.uint8,
                           device=w_q.device)
        for l in range(L):
            src = w_q[l].reshape(E * K, half)
            q = torch.zeros((E * K, Np), dtype=torch.uint8, device=w_q.device)
            q[:, :half] = src & 0xF
            q[:, half:N] = src >> 4
            t = q.reshape(-1, Np // 256, 2, 128)
            w_qg[l] = (t[:, :, 0] | (t[:, :, 1] << 4)).reshape(E, K, Np // 2)
    out = {"w_qg": w_qg}
    for key, fill in (("scale", 1.0), ("zero", 0.0)):
        src = leaf[key].float()
        t = torch.full(src.shape[:-1] + (Np,), fill, dtype=torch.float32,
                       device=src.device)
        t[..., :N] = src
        out[key + "_g"] = t
    return out


def prepare_grouped_experts(params: Dict, cfg) -> Dict:
    """One-time install step: an expert leaf whose columns do not fill the
    kernel's 256-column tiles is replaced, in `params`, by its zero-padded
    copy in the kernel's layout (same keys; its scale / zero padded with
    ones and zeros, so the padded columns compute 0). Numpy or tensor
    trees; a no-op for dense models, tileable layouts and leaves already
    padded. Readers take the true width from the model config."""
    if cfg.moe is None:
        return params
    ex = params.get("layers", {}).get("experts")
    if not isinstance(ex, dict):
        return params
    dims = {"gate_proj": cfg.moe.moe_intermediate_size,
            "up_proj": cfg.moe.moe_intermediate_size,
            "down_proj": cfg.hidden_size}
    for name, N in dims.items():
        leaf = ex.get(name)
        if not (isinstance(leaf, dict) and "w_q" in leaf and
                leaf["scale"].shape[-1] == N and
                _needs_repack(leaf["w_q"], N)):
            continue
        if isinstance(leaf["w_q"], torch.Tensor):
            padded = _repack_tensor_leaf(leaf, N)
        elif leaf["w_q"].dtype == np.uint8:
            padded = repack_expert_u4_tile128(leaf, N)
        else:
            w_q = np.asarray(leaf["w_q"])
            w_qg = np.zeros(w_q.shape[:-1] + (_round_up(N, 256),), np.int8)
            w_qg[..., :N] = w_q
            padded = dict(w_qg=w_qg, **_padded_qparams(leaf, N,
                                                       _round_up(N, 256)))
        ex[name] = {"w_q": padded["w_qg"], "scale": padded["scale_g"],
                    "zero": padded["zero_g"]}
    return params


# ---------------------------------------------------------------------------
# group layout (token sort + boundary padding), free of host syncs
# ---------------------------------------------------------------------------

def build_group_layout(topk_i: torch.Tensor, E: int, TM: int
                       ) -> Tuple[torch.Tensor, ...]:
    """topk_i: [T, k] expert ids. Returns (order [T*k], sorted_token [T*k],
    pos [T*k], tile_expert [Mcap/TM]): pos places each sorted (token,
    expert) row in the boundary-padded buffer of static size
    Mcap = rup(T*k, TM) + E*TM, so that every TM-row tile holds rows of one
    expert; tiles past the padded total are given the last expert, hold no
    row and are never gathered back."""
    T, k = topk_i.shape
    dev = topk_i.device
    M0 = T * k
    flat_e = topk_i.reshape(-1).long()
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_token = flat_token[order]
    sizes = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    psizes = (sizes + TM - 1) // TM * TM
    pstarts = torch.cumsum(psizes, 0) - psizes
    starts = torch.cumsum(sizes, 0) - sizes
    pos = pstarts[sorted_e] + (torch.arange(M0, device=dev) -
                               starts[sorted_e])
    Mcap = _round_up(M0, TM) + E * TM
    t_base = torch.arange(Mcap // TM, device=dev) * TM
    tile_expert = (torch.searchsorted(pstarts, t_base, right=True) - 1
                   ).clamp(0, E - 1).to(torch.int32)
    return order, sorted_token, pos, tile_expert


def tile_row_counts(pos: torch.Tensor, n_tiles: int, TM: int) -> torch.Tensor:
    """Real rows of each M tile (int32 [n_tiles]): the kernel runs its
    tensor cores only over the 16-row slices that hold rows."""
    return torch.zeros(n_tiles, dtype=torch.int32, device=pos.device
                       ).scatter_add_(0, pos // TM,
                                      torch.ones_like(pos, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------

def _leaf_geometry(leaf: Dict) -> Tuple[int, int, int, int]:
    """-> (bits, K, N, gs) of a per-layer grouped leaf [E, K, ...]."""
    w_q, scale = leaf["w_q"], leaf["scale"]
    bits = 8 if w_q.dtype in (torch.int8, np.int8) else 4
    K = w_q.shape[1]
    N = scale.shape[-1]
    G = scale.shape[1]
    gs = K if G == 1 else K // G
    return bits, K, N, gs


def supports_grouped(leaf: Dict) -> bool:
    """Per-layer leaf [E, K, ...]: the JAX package's layout rule (K tiles
    of min(gs, 512) rows; u4 columns a multiple of 256, int8 of 128)."""
    if not isinstance(leaf, dict) or "w_q" not in leaf:
        return False
    bits, K, N, gs = _leaf_geometry(leaf)
    kt = min(gs, 512)
    if K % kt or gs % kt:
        return False
    return N % 256 == 0 if bits == 4 else N % 128 == 0


def grouped_quant_matmul_plain(xs: torch.Tensor, tile_expert: torch.Tensor,
                               leaf: Dict, out_dtype=torch.bfloat16,
                               tile_rows: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The Pallas `_gkernel` in plain PyTorch: per tile, bf16(x) . levels of
    the tile's expert per K tile of KT = min(gs, 512) rows, the affine
    after the dot, f32 sums; [Mcap, N] in out_dtype. `tile_rows` is the
    kernel's hint and changes nothing here (padded rows are zero)."""
    Mcap, K = xs.shape
    n_tiles = tile_expert.shape[0]
    TM = Mcap // n_tiles
    scale, zero = leaf["scale"].float(), leaf["zero"].float()
    E, G, N = scale.shape
    gs = K // G
    kt = min(gs, 512)
    nk = K // kt
    g_of = (torch.arange(nk, device=xs.device) * kt) // gs
    xf = xs.float()
    out = torch.zeros((Mcap, N), dtype=out_dtype, device=xs.device)
    te = tile_expert.cpu().tolist()
    for e in sorted(set(te)):
        rows = torch.cat([torch.arange(m * TM, (m + 1) * TM)
                          for m, t in enumerate(te) if t == e]).to(xs.device)
        x = xf[rows]
        R = x.shape[0]
        q = weight_levels(leaf["w_q"][e]).float().reshape(nk, kt, N)
        xb = x.to(torch.bfloat16).float().reshape(R, nk, kt).transpose(0, 1)
        part = torch.bmm(xb, q)                              # [nk, R, N]
        xsum = x.reshape(R, nk, kt).sum(-1).t()              # [nk, R]
        acc = (part * scale[e][g_of][:, None, :] +
               xsum[:, :, None] * zero[e][g_of][:, None, :]).sum(0)
        out[rows] = acc.to(out_dtype)
    return out


def block_shape(Mcap: int, TM: int, E: int) -> int:
    """The kernel's block shape (a row of SHAPES) from static shapes alone
    (routing is the card's; the call stays CUDA-graph capturable), by the
    routed rows an expert gets on average, r = (Mcap - E * TM) / E (rows
    rounded up to TM): below ONE_ROW (a decode batch: ~25 of 60 experts
    hold a row or two) narrow items of 64 payload bytes a K row, twice the
    blocks; up to FEW_ROWS (prefills up to bucket 128) 128-byte items and
    16 rows a block; beyond, 32 rows a block (the products' operations
    start to count). Measured on the card at Qwen1.5-MoE width
    (PERF.md)."""
    rows = max(Mcap - E * TM, 0)
    if rows < ONE_ROW * E:
        return 0
    return 1 if rows <= FEW_ROWS * E else 2


def check_operands(xs: torch.Tensor, tile_expert: torch.Tensor, leaf: Dict,
                   out_dtype=torch.bfloat16,
                   tile_rows: Optional[torch.Tensor] = None
                   ) -> Tuple[int, int, int, int, int]:
    """The kernel's refusal rules (raise on what it does not take); returns
    (bits, TM, N, G, E). Shapes, dtypes, devices, contiguity and alignment
    only: nothing is launched or synchronised."""
    w_q, scale, zero = leaf["w_q"], leaf["scale"], leaf["zero"]
    Mcap, K = xs.shape
    n_tiles = tile_expert.shape[0]
    TM = Mcap // max(n_tiles, 1)
    bits, Kw, N, gs = _leaf_geometry(leaf)
    E, G = scale.shape[0], scale.shape[1]
    if xs.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError("grouped_quant_matmul: the kernel takes bf16 xs and "
                        f"gives bf16 (xs {xs.dtype}, out {out_dtype})")
    if TM not in KERNEL_TMS or TM * n_tiles != Mcap:
        raise ValueError(f"grouped_quant_matmul: M tile {TM} (Mcap {Mcap}, "
                         f"{n_tiles} tiles); the kernel takes {KERNEL_TMS}")
    if Kw != K or N % 256 or K % 64 or gs % 64:
        raise ValueError(f"grouped_quant_matmul: K={K} (weights {Kw}), "
                         f"N={N} (needs % 256), group {gs} (needs % 64)")
    want = (E, K, N // 2 if bits == 4 else N)
    if tuple(w_q.shape) != want or tuple(zero.shape) != (E, G, N) or \
            scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError(f"grouped_quant_matmul: weights {tuple(w_q.shape)} "
                         f"{tuple(scale.shape)} {scale.dtype}; expected "
                         f"{want} and f32 [{E}, {G}, {N}]")
    for name, t in (("tile_expert", tile_expert), ("tile_rows", tile_rows)):
        if t is not None and (t.dtype != torch.int32 or
                              t.shape != (n_tiles,)):
            raise ValueError(f"grouped_quant_matmul: {name} must be int32 "
                             f"[{n_tiles}]")
    for t in (xs, tile_expert, w_q, scale, zero) + \
            ((tile_rows,) if tile_rows is not None else ()):
        if t.device != xs.device or not t.is_contiguous():
            raise ValueError("grouped_quant_matmul: operands must be "
                             "contiguous and on one device")
    if w_q.data_ptr() % 16 or xs.data_ptr() % 16:
        raise ValueError("grouped_quant_matmul: xs and the payload must be "
                         "16-byte aligned")
    return bits, TM, N, G, E


def grouped_quant_matmul(xs: torch.Tensor, tile_expert: torch.Tensor,
                         leaf: Dict, out_dtype=torch.bfloat16,
                         tile_rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """xs: [Mcap, K] bf16 boundary-padded sorted tokens (Mcap % TM == 0,
    every TM tile single-expert); tile_expert: [Mcap/TM] int32; leaf: the
    per-layer quantized expert stack {"w_q" [E, K, N(/2)], "scale"/"zero"
    [E, G, N]}; tile_rows: optional int32 [Mcap/TM] real rows per tile
    (`tile_row_counts`): the kernel reads only those rows (none: every row)
    and writes 0 past them. Returns [Mcap, N] bf16. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if xs.device.type == "cpu":
        return grouped_quant_matmul_plain(xs, tile_expert, leaf, out_dtype,
                                          tile_rows)
    if not xs.is_cuda:
        raise ValueError(f"grouped_quant_matmul: unsupported device "
                         f"{xs.device}")
    dev = xs.device
    bits, TM, N, G, E = check_operands(xs, tile_expert, leaf, out_dtype,
                                       tile_rows)
    Mcap, K = xs.shape
    out = torch.empty((Mcap, N), dtype=torch.bfloat16, device=dev)
    fn = kernel_build.function("grouped_quant_matmul",
                               "di_grouped_quant_matmul", _ARGTYPES)
    rc = fn(xs.data_ptr(), tile_expert.data_ptr(),
            tile_rows.data_ptr() if tile_rows is not None else None,
            leaf["w_q"].data_ptr(), bits, leaf["scale"].data_ptr(),
            leaf["zero"].data_ptr(), out.data_ptr(), Mcap, K, N, G, E, TM,
            block_shape(Mcap, TM, E),
            grouped_quant_matmul.counter.pointer(dev),
            kernel_build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"grouped_quant_matmul launch failed: CUDA error "
                           f"{rc}")
    return out


grouped_quant_matmul.counter = kernel_build.LaunchCounter()
