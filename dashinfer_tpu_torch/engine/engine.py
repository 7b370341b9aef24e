"""Engine: the public serving API + control loop.

Counterpart of `dashinfer_tpu.engine.engine` for the per-op path: install /
start / stop models, start / stop / release requests, streaming
ResultQueues, engine stats. One scheduler thread per model drains control
messages, admits prefills by scheduling strategy and runs batched decode
ticks; device work overlaps the host through CUDA's asynchronous launches.
"""

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from dashinfer_tpu_torch.config import (GenerationConfig, ModelConfig,
                                        RuntimeConfig, SchedulingStrategy)
from dashinfer_tpu_torch.engine.model_runtime import (ModelRuntime,
                                                   mesh_devices)
from dashinfer_tpu_torch.loader.convert import params_from_numpy, torch_dtype
from dashinfer_tpu_torch.loader.quantize import quantize_params
from dashinfer_tpu_torch.ops.grouped_quant_matmul import \
    prepare_grouped_experts
from dashinfer_tpu_torch.parallel.mesh import make_mesh
from dashinfer_tpu_torch.runtime.request import (GenerateRequestStatus,
                                                 Request, RequestHandle,
                                                 new_uuid)
from dashinfer_tpu_torch.runtime.result_queue import ResultQueue
from dashinfer_tpu_torch.utils import EnvConfig, get_logger

logger = get_logger("engine")

_FINAL = (GenerateRequestStatus.GenerateFinished,
          GenerateRequestStatus.GenerateInterrupted,
          GenerateRequestStatus.InternalError)


class _ModelLoop:
    """Scheduler loop for one model."""

    def __init__(self, runtime: ModelRuntime):
        self.rt = runtime
        self.msgs: "queue.Queue" = queue.Queue()
        self.wake = threading.Event()
        self.stop_flag = False
        # graceful stop: admit nothing new, drain running requests, exit
        self.draining = False
        self.thread: Optional[threading.Thread] = None
        self.last_stat_log = time.monotonic()

    def start(self):
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"di-loop-{self.rt.name}")
        self.thread.start()

    def submit(self, fn, *args):
        self.msgs.put((fn, args))
        self.wake.set()

    def _run(self):
        if self.rt.device.type == "cuda":
            torch.cuda.set_device(self.rt.device)
        with torch.no_grad():
            self._loop()

    def _loop(self):
        rt = self.rt
        strategy = rt.rt.scheduling_strategy
        while not self.stop_flag:
            # 1. control messages
            try:
                while True:
                    fn, args = self.msgs.get_nowait()
                    try:
                        fn(*args)
                    except Exception:
                        logger.exception("control message failed")
            except queue.Empty:
                pass

            did_work = False
            # 2. prefill admission
            if self.draining:
                try:
                    while rt.pending:
                        req = rt.pending[0]
                        if not rt.stop_request(req.uuid) and \
                                rt.pending and rt.pending[0] is req:
                            rt.pending.popleft()
                except Exception:
                    logger.exception("drain of pending queue failed")
                if not rt.active_requests():
                    rt._drain_inflight()
                    if not rt.active_requests():
                        self.stop_flag = True
                        continue
            else:
                # CONTEXT_PRIORITY admits up to max_prefills_per_tick
                # consecutive prefills, then yields to the decode tick
                cap = rt.rt.max_prefills_per_tick \
                    if strategy == SchedulingStrategy.CONTEXT_PRIORITY else 1
                try:
                    n = 0
                    while (cap <= 0 or n < cap) and rt.try_prefill_one():
                        did_work = True
                        n += 1
                except Exception:
                    logger.exception("prefill scheduling failed")
                    self._fail_head()

            # 3. decode tick
            try:
                did_work |= rt.decode_tick() > 0
            except Exception:
                logger.exception("decode tick failed; interrupting batch")
                for r in rt.active_requests():
                    rt.release_request(r.uuid)

            now = time.monotonic()
            if now - self.last_stat_log > EnvConfig.log_status_interval_s():
                rt.update_stats()
                rt.stat.tick_throughput()
                logger.info("stat: %s", rt.stat.as_dict())
                self.last_stat_log = now

            if not did_work:
                self.wake.wait(timeout=0.005)
                self.wake.clear()

    def _fail_head(self):
        rt = self.rt
        if rt.pending:
            req = rt.pending.popleft()
            rt.stat.pendings -= 1
            req.status = GenerateRequestStatus.InternalError
            q = rt.queues.get(req.uuid)
            if q:
                q.set_status(GenerateRequestStatus.InternalError)

    def shutdown(self, graceful: bool = False, timeout_s: float = 600.0):
        """graceful=True: stop admitting, interrupt never-admitted pending
        requests, let running ones decode to completion, then join."""
        if graceful and self.thread and self.thread.is_alive():
            self.draining = True
            self.wake.set()
            self.thread.join(timeout=timeout_s)
            if self.thread.is_alive():
                logger.warning("graceful stop timed out; forcing")
        self.stop_flag = True
        self.wake.set()
        if self.thread:
            self.thread.join(timeout=10)


def _is_tensor_tree(tree) -> bool:
    if isinstance(tree, dict):
        return all(_is_tensor_tree(v) for v in tree.values())
    return isinstance(tree, torch.Tensor)


class Engine:
    """Public API (mirrors `dashinfer_tpu.Engine`)."""

    def __init__(self):
        self._models: Dict[str, ModelRuntime] = {}
        self._loops: Dict[str, _ModelLoop] = {}
        self._lock = threading.Lock()

    # -- model lifecycle ------------------------------------------------------
    def install_model(self, model, runtime_config: RuntimeConfig,
                      params=None, model_config: Optional[ModelConfig] = None,
                      device: Union[str, torch.device, Sequence] = "cuda",
                      tokenizer=None):
        """Install a model from (model_config, params). `params` is the
        JAX package's stacked param tree, as numpy / ml_dtypes arrays (the
        loader output, quantized here when runtime_config.quant asks) or as
        tensors. It is moved to `device`, the CUDA card unless the caller
        asks for the CPU. On a `(1, n)` mesh (runtime_config.mesh_shape)
        `device` may list the ranks' devices (["cpu", "cpu"] on the CPU;
        one card named n times runs every rank on it); the default "cuda"
        takes cuda:0 .. n-1 and raises when fewer cards exist. `tokenizer`
        (`len()` and `decode` / `batch_decode` of single ids) enables
        guided (JSON) decoding, as in the JAX Engine."""
        if params is None or model_config is None:
            raise NotImplementedError(
                f"loading {model!r} from a checkpoint is not ported to the "
                "PyTorch package yet; pass params= and model_config=")
        name = runtime_config.model_name
        if runtime_config.quant.mode not in ("none", ""):
            if _is_tensor_tree(params):
                raise ValueError("runtime_config.quant needs a numpy param "
                                 "tree (quantize before converting)")
            params = quantize_params(params, runtime_config.quant)
        if tuple(runtime_config.mesh_shape) != (1, 1):
            # the ranks first: too few cards raise before any upload
            device = list(make_mesh(tuple(runtime_config.mesh_shape),
                                    mesh_devices(runtime_config,
                                                  device)).devices)
        lead = device[0] if isinstance(device, (list, tuple)) else device
        if model_config.moe is not None and \
                torch.device(lead).type == "cuda":
            # expert stacks whose columns do not fill the grouped kernel's
            # 256-column tiles are re-laid out, zero-padded, in place of the
            # loader's (a no-op otherwise)
            params = prepare_grouped_experts(params, model_config)
        params = params_from_numpy(params, lead,
                                   torch_dtype(runtime_config.dtype))
        with self._lock:
            if name in self._models:
                raise ValueError(f"model {name} already installed")
            self._models[name] = ModelRuntime(
                name, model_config, params, runtime_config, device=device,
                tokenizer=tokenizer)
        return self

    def start_model(self, name: str):
        with self._lock:
            if name in self._loops:
                return self
            loop = _ModelLoop(self._models[name])
            self._loops[name] = loop
            loop.start()
        return self

    def stop_model(self, name: str, graceful: bool = False,
                   timeout_s: float = 600.0):
        with self._lock:
            loop = self._loops.pop(name, None)
        if loop:
            loop.shutdown(graceful=graceful, timeout_s=timeout_s)
        return self

    def release_model(self, name: str):
        self.stop_model(name)
        with self._lock:
            runtime = self._models.pop(name, None)
        if runtime is not None:
            runtime.release()
        return self

    # -- requests -------------------------------------------------------------
    def start_request(self, name: str, input_ids: List[int],
                      gen_cfg: Optional[GenerationConfig] = None,
                      request_uuid: Optional[str] = None
                      ) -> Tuple[GenerateRequestStatus, RequestHandle,
                                 ResultQueue]:
        gen_cfg = gen_cfg or GenerationConfig()
        runtime = self._models[name]
        loop = self._loops.get(name)
        if loop is None:
            raise RuntimeError(f"model {name} not started")
        gen_cfg.validate(runtime.cfg.vocab_size, runtime.rt.max_length)
        runtime.validate_request(input_ids, gen_cfg)
        if gen_cfg.lora_name is not None:
            if runtime.lora_manager is None:
                raise ValueError("lora_name given but LoRA is not enabled")
            runtime.lora_manager.index_of(gen_cfg.lora_name)  # KeyError
        if len(input_ids) >= gen_cfg.max_length:
            raise ValueError(
                f"prompt length {len(input_ids)} >= max_length "
                f"{gen_cfg.max_length}")
        uuid = request_uuid or new_uuid()
        req = Request(uuid=uuid, input_ids=list(map(int, input_ids)),
                      gen_cfg=gen_cfg)
        req.stat.arrival_time = time.monotonic()
        rq = ResultQueue(uuid)
        runtime.register(req, rq)
        loop.submit(runtime.enqueue, req, rq)
        return GenerateRequestStatus.Init, RequestHandle(uuid, name), rq

    def _call_in_loop(self, name: str, fn, timeout_s: float = 30.0):
        """fn() on model `name`'s loop thread, between its steps (here if
        the model is not started); returns its value and raises its
        exception here, or TimeoutError if the loop did not run it in
        time."""
        loop = self._loops.get(name)
        if loop is None:
            return fn()
        done, out = threading.Event(), {}

        def run():
            try:
                out["value"] = fn()
            except Exception as e:
                out["error"] = e
            done.set()

        loop.submit(run)
        if not done.wait(timeout=timeout_s):
            raise TimeoutError(f"model {name}: the loop did not run the call "
                               f"within {timeout_s} s")
        if "error" in out:
            raise out["error"]
        return out.get("value")

    def stop_request(self, name: str, handle: RequestHandle):
        runtime = self._models[name]
        self._call_in_loop(name, lambda: runtime.stop_request(handle.uuid))
        return self

    def release_request(self, name: str, handle: RequestHandle):
        runtime = self._models[name]
        self._call_in_loop(name, lambda: runtime.release_request(handle.uuid))
        return self

    def sync_request(self, name: str, handle: RequestHandle,
                     timeout_s: Optional[float] = None):
        """Block until the request reaches a final state."""
        q = self._models[name].queues.get(handle.uuid)
        if q is None:
            return self
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while q.GenerateStatus() not in _FINAL:
            if deadline and time.monotonic() > deadline:
                raise TimeoutError(f"sync_request {handle.uuid[:8]}")
            time.sleep(0.002)
        return self

    # -- LoRA -----------------------------------------------------------------
    def load_lora(self, name: str, lora_name: str, adapter_path_or_tensors,
                  alpha: float = None, rank: int = None):
        """Loads an adapter (a PEFT directory, or tensors {(layer, target,
        "A" | "B"): array} with alpha and rank) into model `name`'s pool. A
        started model loads it on its loop's thread, between steps, so the
        copy is ordered with the steps on the loop's stream; errors (name
        already loaded, pool full, rank above lora_max_rank) are raised
        here."""
        runtime = self._models[name]
        if runtime.lora_manager is None:
            raise RuntimeError("LoRA not enabled in RuntimeConfig")
        self._call_in_loop(name, lambda: runtime.lora_manager.load(
            lora_name, adapter_path_or_tensors, alpha, rank), 120.0)
        return self

    def unload_lora(self, name: str, lora_name: str):
        runtime = self._models[name]
        if runtime.lora_manager is None:
            return self
        self._call_in_loop(name, lambda: runtime.lora_manager.unload(
            lora_name), 120.0)
        return self

    # -- stats ----------------------------------------------------------------
    def get_engine_stat(self, name: str) -> Dict:
        runtime = self._models[name]
        runtime.update_stats()
        return runtime.stat.as_dict()
