"""Engine logging (reference: glog w/ rank prefix, csrc/utility/allspark_logging.*)."""

import logging
import os
import sys

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s [di-torch] %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
    root = logging.getLogger("dashinfer_tpu_torch")
    root.addHandler(handler)
    root.setLevel(os.environ.get("DI_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("dashinfer_tpu_torch"):
        name = f"dashinfer_tpu_torch.{name}"
    return logging.getLogger(name)
