"""Paged decode attention: one query token per slot over the page pool.

Counterpart of `dashinfer_tpu.ops.pallas.paged_attention`. What lives here:
the launch wrapper `paged_attention` of the CUDA kernel in
csrc/paged_attention.cu, its plain PyTorch twin `paged_attention_plain`, the
kernel's launch count (`paged_attention.counter`, which the kernel itself
increments on the card), and the wrapper's host-side rules as pure
functions: `check_operands` (what the kernel refuses) and
`chunk_geometry` (how the sequence is cut into chunks, one block a chunk,
KV head and slot).

Both compute, per slot b and KV head h, softmax attention of the query heads
h*G .. (h+1)*G-1 over the tokens t < lens[b] of the slot's pages (lens 0
gives 0), with quantized KV dequantized by the affine-after-dot identity
    q . k_t = (q . q_int_t) * scale_t + (sum_d q_d) * zero_t
and the same on the V side. The plain version takes one softmax over the
whole masked row; the kernel an online softmax per 16 tokens and a merge
of chunks: they differ only in the order of f32 sums and, in the kernel's
tensor-core path, P entering the V product as bf16 hi + lo parts (~16
bits).
"""

import ctypes
from typing import Tuple

import torch

from dashinfer_tpu_torch.config import CacheMode
from dashinfer_tpu_torch.ops import kernel_build
from dashinfer_tpu_torch.runtime.kv_cache import KVCache

_NEG_INF = torch.finfo(torch.float32).min
MAX_GROUP = 8     # query heads per KV head the kernel takes
CHUNK_BLOCKS_PER_SM = 2   # blocks the grid aims at per SM

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, q_bf16, k_pool, v_pool, kv_kind, k_qp, v_qp, ql, page_tables,
# max_pages, lens, out, part_ml, part_acc, B, H, KH, D, ps, chunk_tokens,
# n_chunks, scale, launches, stream
_ARGTYPES = [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I,
             _I, _I, _I, _I, _I, ctypes.c_float, _P, _P]
_SM_COUNT = {}


def tile_tokens(kind: int, D: int) -> int:
    """Tokens the kernel stages per step (csrc `Geo::kTileT`): 16 a warp
    (4 for an f32 pool at D = 256, whose tiles would not fit twice in
    227 KB), 8 warps a block where a head row is at most 128 bytes, else
    4."""
    row = D // 2 if kind == 3 else D * (4, 2, 1)[kind]
    warp_tokens = 4 if (kind == 0 and D == 256) else 16
    return warp_tokens * (8 if row <= 128 else 4)


def chunk_geometry(B: int, KH: int, max_pages: int, ps: int, tile: int,
                   sm_count: int) -> Tuple[int, int]:
    """-> (chunk_tokens, n_chunks) from static shapes alone (the launch is
    CUDA-graph captured): as many chunks a (slot, KV head) as keep the grid
    of B * KH * n_chunks blocks within CHUNK_BLOCKS_PER_SM resident blocks an
    SM (one wave: a second, partial wave cost more than the longer chunks
    on the card), each chunk a whole number of tiles. Blocks past lens[b]
    exit at once."""
    tiles = max(1, -(-max_pages * ps // tile))
    want = max(1, CHUNK_BLOCKS_PER_SM * sm_count // (B * KH))
    per = -(-tiles // min(want, tiles))
    return per * tile, -(-tiles // per)


def _kv_heads(cache: KVCache, head_dim: int) -> int:
    if cache.k_qparams is not None:
        return cache.k_qparams.shape[1] // 2
    return cache.k.shape[2] // head_dim


def paged_attention_plain(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                          page_tables: torch.Tensor, lens: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q: [B, H, D]; page_tables: [B, maxP] physical page ids; lens: [B].
    Returns [B, H, D] in q.dtype."""
    B, H, D = q.shape
    KH = _kv_heads(cache, D)
    G = H // KH
    ps = cache.page_size
    maxP = page_tables.shape[1]
    S = maxP * ps
    idx = page_tables.long().clamp(0, cache.num_pages - 1)

    def tokens(pool):            # -> [B, KH, S, Ds] raw payload as f32
        x = pool[idx].reshape(B, S, KH, -1).float()
        return x.permute(0, 2, 1, 3)

    def qparams(qp):             # -> scale, zero [B, KH, 1, S]
        r = qp[idx][..., :ps]                        # [B, maxP, 2KH, ps]
        r = r.permute(0, 2, 1, 3).reshape(B, 2 * KH, S)
        return r[:, 0::2, None, :], r[:, 1::2, None, :]

    qf = q.float().reshape(B, KH, G, D)
    k_raw, v_raw = tokens(cache.k), tokens(cache.v)
    if mode == CacheMode.UINT4:
        D2 = D // 2

        def unpack(x):
            xi = x.to(torch.int32)
            return (xi & 0xF).float(), ((xi >> 4) & 0xF).float()

        k_lo, k_hi = unpack(k_raw)
        s = (torch.einsum("bhgd,bhsd->bhgs", qf[..., :D2], k_lo) +
             torch.einsum("bhgd,bhsd->bhgs", qf[..., D2:], k_hi))
    else:
        s = torch.einsum("bhgd,bhsd->bhgs", qf, k_raw)
    if mode != CacheMode.DEFAULT:
        k_scale, k_zero = qparams(cache.k_qparams)
        s = s * k_scale + qf.sum(-1, keepdim=True) * k_zero
    s = s * scale
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1) * mask[:, None, None, :]   # lens 0 -> 0
    # what lies past lens is garbage (a float pool may hold NaN there): the
    # V side reads it as 0
    vmask = mask[:, None, :, None]
    if mode == CacheMode.DEFAULT:
        out = torch.einsum("bhgs,bhsd->bhgd", p,
                           torch.where(vmask, v_raw, 0.0))
    else:
        v_scale, v_zero = (torch.where(vmask.transpose(-1, -2), t, 0.0)
                           for t in qparams(cache.v_qparams))
        p_s = p * v_scale
        zero_term = (p * v_zero).sum(-1, keepdim=True)       # [B, KH, G, 1]
        if mode == CacheMode.UINT4:
            v_lo, v_hi = unpack(v_raw)
            out = torch.cat([torch.einsum("bhgs,bhsd->bhgd", p_s, v_lo),
                             torch.einsum("bhgs,bhsd->bhgd", p_s, v_hi)],
                            dim=-1) + zero_term
        else:
            out = torch.einsum("bhgs,bhsd->bhgd", p_s, v_raw) + zero_term
    return out.reshape(B, H, D).to(q.dtype)


_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.uint8: 3}


def check_operands(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                   page_tables: torch.Tensor, lens: torch.Tensor
                   ) -> Tuple[int, int]:
    """The kernel's refusal rules (raise on what it does not take); returns
    (KH, pool kind). Shapes, dtypes, devices and contiguity only: nothing is
    launched or synchronised."""
    B, H, D = q.shape
    KH = _kv_heads(cache, D)
    P, ps, row = cache.k.shape
    quant = mode != CacheMode.DEFAULT
    kind = _KV_KIND.get(cache.k.dtype)
    want_kind = {CacheMode.DEFAULT: (0, 1), CacheMode.INT8: (2,),
                 CacheMode.UINT4: (3,)}[mode]
    if kind not in want_kind or cache.v.dtype != cache.k.dtype:
        raise TypeError(f"paged_attention: pool dtype {cache.k.dtype} for "
                        f"{mode}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_attention: q dtype {q.dtype}")
    if D not in (64, 128, 256) or H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"paged_attention: D={D} H={H} KH={KH} unsupported")
    if row != KH * (D // 2 if mode == CacheMode.UINT4 else D):
        raise ValueError(f"paged_attention: pool row {row} for KH={KH} D={D}")
    if page_tables.dtype != torch.int32 or lens.dtype != torch.int32 or \
            page_tables.dim() != 2 or page_tables.shape[0] != B or \
            tuple(lens.shape) != (B,):
        raise ValueError("paged_attention: page_tables [B, maxP] / lens [B] "
                         "must be int32")
    qp = (cache.k_qparams, cache.v_qparams) if quant else ()
    if quant and any(t is None or t.dtype != torch.float32 or
                     t.shape[:2] != (P, 2 * KH) or t.shape[2] < ps
                     for t in qp):
        raise ValueError("paged_attention: qparams must be [P, 2*KH, >=ps] "
                         "float32")
    for t in (q, cache.k, cache.v, page_tables, lens) + qp:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous "
                             "and on one device")
    if cache.k.data_ptr() % 16 or cache.v.data_ptr() % 16:
        raise ValueError("paged_attention: the pools must be 16-byte aligned")
    return KH, kind


def _sm_count(device) -> int:
    n = _SM_COUNT.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device] = n
    return n


def paged_attention(q: torch.Tensor, cache: KVCache, mode: CacheMode,
                    page_tables: torch.Tensor, lens: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Decode attention over the paged pool (one layer). Same contract as
    `paged_attention_plain`. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, cache, mode, page_tables, lens, scale)
    if not q.is_cuda:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    KH, kind = check_operands(q, cache, mode, page_tables, lens)
    B, H, D = q.shape
    ps = cache.page_size
    quant = mode != CacheMode.DEFAULT
    chunk_tokens, n_chunks = chunk_geometry(
        B, KH, page_tables.shape[1], ps, tile_tokens(kind, D),
        _sm_count(q.device))
    out = torch.empty_like(q)
    scratch = (B * H * n_chunks,) if n_chunks > 1 else (0,)
    part_ml = torch.empty((scratch[0] * 2,), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((scratch[0] * D,), dtype=torch.float32,
                           device=q.device)
    fn = kernel_build.function("paged_attention", "di_paged_attention",
                               _ARGTYPES)
    with torch.cuda.device(q.device):   # the C side launches on it
        rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16),
                cache.k.data_ptr(), cache.v.data_ptr(), kind,
                cache.k_qparams.data_ptr() if quant else None,
                cache.v_qparams.data_ptr() if quant else None,
                cache.k_qparams.shape[2] if quant else 0,
                page_tables.data_ptr(), page_tables.shape[1], lens.data_ptr(),
                out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                B, H, KH, D, ps, chunk_tokens, n_chunks, float(scale),
                paged_attention.counter.pointer(q.device),
                kernel_build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{rc}")
    return out


paged_attention.counter = kernel_build.LaunchCounter()
