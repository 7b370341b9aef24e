"""Build and load the hand-written CUDA kernels of `dashinfer_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
`sm_90a` into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash covers the source, the shared headers and the flags, so an edited
source rebuilds) and
loaded with ctypes. Building takes seconds per source; `build()` compiles
several sources in parallel. Nothing is built or imported when this module
is imported: the CPU-only test environment imports every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("quant_matmul", "paged_attention", "megakernel", "stream_probe",
           "prefill_megakernel", "probes", "grouped_quant_matmul",
           "tp_segments", "tp_prefill_segments")
HEADERS = ("di_common.cuh", "di_product.cuh",   # included by the sources
           "di_attn_tile.cuh", "di_layer.cuh", "di_moe_layer.cuh",
           "di_prefill_layer.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # nvcc/ptxas output of each source's build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "dashinfer_tpu_torch need the CUDA toolkit")


def lib_path(name: str) -> str:
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together. Returns {name: seconds}; raises with the
    compiler output when any build fails. `build_logs` gets each source's
    compiler output, kept beside its library for a build that was done
    before."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            if os.path.exists(f"{out}.log"):
                with open(f"{out}.log") as f:
                    build_logs[name] = f.read()
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            with open(f"{out}.log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """`symbol` of csrc/<name>.cu with its ctypes signature (int result:
    the cudaError_t of the launch)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


class LaunchCounter:
    """A kernel's launch count, kept on the card: the wrapper passes
    `pointer(device)` to the kernel, and one thread of each launch adds one
    to it. A launch recorded in a CUDA graph therefore counts at every
    replay, and a launch that never ran counts nothing."""

    def __init__(self):
        self._counts = {}   # torch.device -> int64 [1] tensor on the card

    def pointer(self, device) -> int:
        import torch
        t = self._counts.get(device)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel's first launch on a device must "
                                   "not be under CUDA graph capture")
            t = torch.zeros(1, dtype=torch.int64, device=device)
            self._counts[device] = t
        return t.data_ptr()

    def reset(self) -> None:
        import torch
        for dev, t in self._counts.items():
            torch.cuda.synchronize(dev)
            t.zero_()
            torch.cuda.synchronize(dev)

    def read(self) -> int:
        """Launches since the last reset, on all devices (waits for them)."""
        return sum(int(t.item()) for t in self._counts.values())
