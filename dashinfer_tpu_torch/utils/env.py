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
