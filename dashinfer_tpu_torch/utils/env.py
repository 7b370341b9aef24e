"""Typed environment-variable configuration (the subset of
`dashinfer_tpu.utils.env` that the PyTorch port reads)."""

import os


def _get(name: str, default):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "on", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class EnvConfig:
    """Read-at-call typed env access (values may be monkeypatched in tests)."""

    @staticmethod
    def hbm_mem_ratio() -> float:
        # fraction of the free device memory the KV-pool plan may claim
        return _get("DI_HBM_MEM_RATIO", 0.92)

    @staticmethod
    def kv_pool_bytes() -> int:
        # explicit KV pool size override (0 = plan from device memory)
        return _get("DI_KV_POOL_BYTES", 0)

    @staticmethod
    def log_status_interval_s() -> float:
        return _get("DI_LOG_STATUS_INTERVAL", 30.0)

    @staticmethod
    def megakernel_enabled() -> bool:
        # DI_MEGAKERNEL=0 serves the per-op path whatever the config says
        return _get("DI_MEGAKERNEL", "1") != "0"

    @staticmethod
    def prefill_megakernel_enabled() -> bool:
        # DI_PREFILL_MEGAKERNEL=0 prefills every bucket through the per-op
        # model (the decode megakernel stays on)
        return _get("DI_PREFILL_MEGAKERNEL", "1") != "0"

    @staticmethod
    def mk_stream() -> str:
        # decode megakernel weight-stream format: "auto" (u4 checkpoints
        # re-expand to per-channel i8 at max_batch >= DI_MK_I8_BATCH),
        # "u4" (never re-expand), "i8" (always re-expand)
        return str(_get("DI_MK_STREAM", "auto"))

    @staticmethod
    def mk_i8_batch() -> int:
        # batch threshold of the auto u4 -> i8 re-expansion (the JAX
        # package's default; whether it pays on this card: PERF.md)
        return _get("DI_MK_I8_BATCH", 24)

    @staticmethod
    def weight_residency() -> str:
        # DI_WEIGHT_RESIDENCY overrides RuntimeConfig.weight_residency
        # ("auto" | "both" | "pack_only"); "" = use the config field
        return str(_get("DI_WEIGHT_RESIDENCY", ""))

    @staticmethod
    def moe_grouped() -> str:
        # DI_MOE_GROUPED: unset = the card's rule (ops/moe.py), "0" = never
        # the grouped kernel, "1" = the grouped route also off the card
        return str(_get("DI_MOE_GROUPED", ""))

    @staticmethod
    def gqm_tm() -> int:
        # rows per M tile of the grouped MoE product (the JAX package's
        # default)
        return _get("DI_GQM_TM", 64)
