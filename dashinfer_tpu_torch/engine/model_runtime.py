"""Per-model runtime: device state + synchronous scheduling primitives.

Counterpart of the single-device serving subset of
`dashinfer_tpu.engine.model_runtime`: the megakernel install (weight-only
view, stream rule, plan, pack), request validation, prefill buckets,
KV-pool planning, the decide/execute split of prefill admission and of the
decode tick (single- or multi-step), token drains, finishing, OOM eviction
and stop/release. The Engine's control loop (engine/engine.py) calls into this.
Decode runs through the decode megakernel when `ops.megakernel.supports`
admits the model, else through the per-op path. A fresh prompt whose bucket
is a multiple of 128 up to 1024 is prefilled by one launch of the prefill
megakernel from the same pack; other buckets go per-op. Under
`weight_residency` "pack_only" the pack is the only weight copy on the card
and every prompt is served through the two megakernels.

On a `(1, n)` mesh (the counterpart of the JAX runtime's mesh install) the
params are split per rank (parallel/sharding.py), each rank holds a KV pool
of its KV heads, and decode runs through the TP segment kernels
(ops/tp_megakernel.py) when `supports_tp` admits the model, else through
the per-op TP forward (a MoE model: the attn and moe segments, its experts
split over the ranks). With the TP segments installed, a fresh prompt whose
bucket is a multiple of 128 up to 1024 (and that `supports_prefill_tp`
admits: not a MoE model) is prefilled through the TP prefill segments,
which read each rank's TP decode pack; other buckets, a MoE model, and
DI_PREFILL_MEGAKERNEL=0, prefill per-op TP. The two single-device
megakernels never run on a mesh, and the weights stay resident as
"both".

LoRA (`enable_lora`, single device): the adapter pool (lora/manager.py)
lives on the card at fixed addresses. A prompt with an adapter prefills
per-op with it; a decode batch without an adapter runs the step it runs
without LoRA; a batch that carries one runs the decode megakernel's LoRA
branch (a dense plan: `ops.megakernel.supports_lora_epilogue`), or the
per-op forward with the adapters (a MoE plan, or no plan), each in a CUDA
graph of its own. LoRA on a mesh raises NotImplementedError (the JAX
package serves it through its XLA per-op TP path), and
`weight_residency="pack_only"` with LoRA is refused, as in the JAX
runtime.

Page accounting: the allocator hands out LOGICAL pages; logical page `g`
owns physical pages `g*L + l` for each layer l.

Multi-step decode (`decode_steps_per_launch` N > 1): a tick whose every
request has N tokens of budget left, and none of which needs the host
between tokens (guided JSON, a ban config too large for the state's
arrays: "sync" requests), nor logprobs, nor an adapter, launches a window
of N steps (engine/steps.py `build_multi_decode_step`; one CUDA graph on
the card) with the page crossings of all N steps allocated ahead; when the
pool cannot give them it falls through to the single step, which evicts.
Bad-words and n-gram bans whose config fits the state's arrays run on the
device and keep the window; guided requests and oversized ban configs
(the host channel) take synchronous single steps, drained before the next
mask is computed. `decode_launches` counts windows and single steps.

Token drains: a step's sampled tokens stay on the device until the step
after it has been launched; the drain then reads them with a plain `.cpu()`,
which waits only for the earlier step. Prefill first tokens are read the
same way at the next drain. A window's rows are drained in order; each
token advances the request's JSON enforcer, and a request that finishes
mid-window drops its later rows. Its slot stays active on the card for the
rest of that window and of the one already launched after it: their
writes reach only its own pages, and those pages go to a new request only
through work enqueued after both windows on the same stream.
"""

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dashinfer_tpu_torch.config import (EvictionStrategy, GenerationConfig,
                                        ModelConfig, RuntimeConfig)
from dashinfer_tpu_torch.engine import steps as steps_mod
from dashinfer_tpu_torch.engine.guided import JsonFormatEnforcer
from dashinfer_tpu_torch.engine.stats import EngineStat
from dashinfer_tpu_torch.lora.manager import LoraManager
from dashinfer_tpu_torch.loader.convert import (params_from_numpy,
                                                torch_dtype)
from dashinfer_tpu_torch.models.transformer import check_supported
from dashinfer_tpu_torch.ops import megakernel as mk
from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
from dashinfer_tpu_torch.ops import quant_matmul as qm
from dashinfer_tpu_torch.ops import tp_megakernel as tpk
from dashinfer_tpu_torch.parallel import collectives, sharding
from dashinfer_tpu_torch.parallel.mesh import make_mesh
from dashinfer_tpu_torch.runtime.batch_state import make_decode_state
from dashinfer_tpu_torch.runtime.kv_cache import (create_kv_cache,
                                                  logical_page_bytes)
from dashinfer_tpu_torch.runtime.page_allocator import (NoFreePages,
                                                        PageAllocator)
from dashinfer_tpu_torch.runtime.request import (GenerateRequestStatus,
                                                 Request)
from dashinfer_tpu_torch.runtime.result_queue import ResultQueue
from dashinfer_tpu_torch.utils import EnvConfig, get_logger

logger = get_logger("model_runtime")


@dataclasses.dataclass
class PrefillDecision:
    """One admission decision (request, slot, pages)."""

    req: Request
    slot: int
    pages: List[int]


@dataclasses.dataclass
class DecodeDecision:
    """One decode-tick decision: which slots step, which new pages they
    get: a single step ("single", `new_page_ids` [B]) or a window of
    decode_steps_per_launch steps ("multi", `npi` [N, B])."""

    act: List[Request]
    new_page_ids: Optional[np.ndarray] = None   # [B] logical page, -1 none
    kind: str = "single"
    npi: Optional[np.ndarray] = None            # [N, B]
    with_banned: bool = False       # a window with on-device bans
    sync_mode: bool = False         # drain right after the step


def _unported_runtime_features(rt: RuntimeConfig) -> List[str]:
    return [name for name, on in (
        ("prefix cache", rt.enable_prefix_cache),
        ("a data-parallel mesh axis", rt.mesh_shape[0] != 1),
        ("chunked prefill (max_prefill_chunk)", rt.max_prefill_chunk > 0),
    ) if on]


def _unported_request_features(g: GenerationConfig) -> List[str]:
    return [name for name, on in (
        ("multimodal inputs", g.mm_info is not None or
         g.mrope_positions is not None or g.mrope_position_delta != 0),
    ) if on]


def _host_lp(lp):
    """A launch's logprob tensors -> numpy (None stays None)."""
    return None if lp is None else tuple(t.cpu().numpy() for t in lp)


def _weight_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(_weight_bytes(v) for v in params.values())
    if isinstance(params, np.ndarray):
        return params.nbytes
    return params.numel() * params.element_size()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _resident_bytes(*trees, device=None) -> int:
    """Bytes the trees hold on their devices (on `device` alone when given),
    each tensor counted once (the pack aliases some of the param tree's
    leaves)."""
    seen = {(t.device, t.data_ptr()): t.numel() * t.element_size()
            for tree in trees if tree is not None for t in _tensors(tree)
            if device is None or t.device == device}
    return sum(seen.values())


def _has_leaf_key(tree, key: str) -> bool:
    if not isinstance(tree, dict):
        return False
    return key in tree or any(_has_leaf_key(v, key) for v in tree.values())


def _host_tree(tree):
    """Tensor tree -> numpy tree (bf16 leaves as float32)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _shape_tree(tree):
    """Tensor tree -> numpy leaves of the same shape and dtype that hold no
    data (for the shape-only `expand_u4_to_i8(meta_only=True)`)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    dt = {torch.uint8: np.uint8, torch.int8: np.int8}.get(tree.dtype,
                                                         np.float32)
    return np.lib.stride_tricks.as_strided(
        np.zeros((), dt), tuple(tree.shape), (0,) * tree.dim())


def mesh_devices(rt: RuntimeConfig, device):
    """The ranks' devices for rt.mesh_shape: a list or tuple names them;
    "cuda" means every visible card, one rank each; a single other device
    holds one rank (make_mesh raises when there are fewer than the ranks).
    None for a single-device runtime."""
    if tuple(rt.mesh_shape) == (1, 1):
        return None
    if isinstance(device, (list, tuple)):
        return list(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return None          # make_mesh: every visible card
    return [dev]


class ModelRuntime:
    def __init__(self, name: str, cfg: ModelConfig, params: Dict,
                 rt: RuntimeConfig, device="cuda", tokenizer=None):
        """params: the stacked param tree as tensors on `device` (rank 0's
        device on a mesh: loader.params_from_numpy). `device`: one device,
        or on a `(1, n)` mesh (rt.mesh_shape) the list of the ranks'
        devices; a list that names one device several times puts several
        ranks on it. `tokenizer`: for guided (JSON) requests (without one
        their response_format is ignored, as in the JAX runtime)."""
        check_supported(cfg)
        missing = _unported_runtime_features(rt)
        if missing:
            raise NotImplementedError(
                f"{', '.join(missing)}: not ported to the PyTorch package yet")
        if rt.enable_lora and tuple(rt.mesh_shape) != (1, 1):
            raise NotImplementedError(
                "LoRA on a mesh: not ported to the PyTorch package yet (the "
                "per-op TP forwards would need the adapter pool split by "
                "rank)")
        self.name = name
        self.cfg = cfg
        self.rt = rt
        self.tokenizer = tokenizer
        self.mesh = None
        if tuple(rt.mesh_shape) != (1, 1):
            self.mesh = make_mesh(tuple(rt.mesh_shape),
                                  mesh_devices(rt, device))
            device = self.mesh.lead
        elif isinstance(device, (list, tuple)):
            device = device[0]
        self.device = torch.device(device)
        self.dtype = torch_dtype(rt.dtype)
        self.params = params
        self.mega_plan = None
        self.mega_params = None
        self.tp_mega_plan = None
        self.buckets = self._make_buckets()
        self._pmk_plans: Dict[int, pmk.PrefillPlan] = {}
        self._tp_pmk_plans: Dict[int, pmk.PrefillPlan] = {}
        if self.mesh is not None:
            self._install_mesh()
        else:
            plan_src = self._install_megakernel()
            self._install_prefill_megakernel(plan_src)
            del plan_src            # it may hold the raw params
        self.residency = "both"
        self._raw_params_host = None
        self._decide_residency()

        # the last launched decode step's (tokens, batch), drained one tick
        # later; prefill first tokens awaiting the same drain
        self._inflight = None
        self._inflight_prefills: List = []

        # the adapter pool, on the card before the KV pool is planned from
        # what is free
        self.lora_manager = None
        self._mega_lora_ok = False
        if rt.enable_lora:
            self.lora_manager = LoraManager(cfg, rt, self.dtype, self.device)
            self._mega_lora_ok = self.mega_plan is not None and \
                mk.supports_lora_epilogue(self.mega_plan, rt.lora_max_num,
                                          rt.lora_max_rank)
            logger.info(
                "LoRA: %d slots of rank %d (%.2f GiB); batches with an "
                "adapter decode through %s", rt.lora_max_num,
                rt.lora_max_rank, _resident_bytes(self.lora_manager.pool)
                / 1024**3, "the decode megakernel's LoRA branch"
                if self._mega_lora_ok else "the per-op path")
        self.num_logical_pages = self._plan_pool()
        # + 1: the sink page for inactive decode slots (ops/kv_ops.py)
        pages = self.num_logical_pages * cfg.num_layers + 1
        if self.mesh is None:
            self.cache = create_kv_cache(cfg, rt.cache, pages, self.dtype,
                                         self.device)
        else:           # one pool a rank, over its KV heads
            self.cache = sharding.shard_cache(cfg, rt.cache, self.mesh, pages,
                                              self.dtype)
        self.state = make_decode_state(cfg, rt, self.device)
        if self.mesh is not None:
            self.state = sharding.shard_state(self.state, self.mesh)
        self.allocator = PageAllocator(self.num_logical_pages)

        devices = None if self.mesh is None else self.mesh.devices
        self._decode_step = steps_mod.build_decode_step(
            cfg, rt, megakernel_plan=self.mega_plan,
            tp_megakernel=self.tp_mega_plan, devices=devices)
        self._lora_decode_step = None
        if self.lora_manager is not None:
            self._lora_decode_step = steps_mod.build_decode_step(
                cfg, rt, megakernel_plan=self.mega_plan
                if self._mega_lora_ok else None,
                lora_pool=self.lora_manager.pool)
        self._prefill_steps: Dict = {}     # (bucket, mega) -> step
        # the decode steps of the per-token features and the windows, each
        # around the forward of its path
        self._decode_steps: Dict = {}
        self.decode_launches = {"multi": 0, "single": 0}
        self._deactivate = steps_mod.build_deactivate(cfg, rt)

        self.pending: deque = deque()           # Requests awaiting prefill
        self.requests: Dict[str, Request] = {}  # uuid -> Request (all live)
        self.slots: List[Optional[Request]] = [None] * rt.max_batch
        self.queues: Dict[str, ResultQueue] = {}
        self.stat = EngineStat(model_name=name)
        self._cached_len: Dict[str, int] = {}

    # -- mesh install ---------------------------------------------------------
    def _install_mesh(self) -> None:
        """The JAX runtime's mesh install, in its order: the mesh (made by
        the caller), the per-rank split (the raw params become the ranks'
        trees, each on its device), `supports_tp`, then the local plan and
        one pack a rank, and the TP prefill plans; the pools come after the
        pool plan. A model that `supports_tp` turns down decodes and
        prefills per-op TP. A MoE model's experts split over the ranks
        (parallel/sharding.py; NotImplementedError when they do not
        divide), and it prefills per-op TP at every bucket."""
        rt, cfg, mesh = self.rt, self.cfg, self.mesh
        collectives.log_choice(mesh)
        if cfg.moe is not None and not rt.use_ep:
            logger.info("MoE on a mesh: the experts split over the %d ranks "
                        "(%d a rank) although use_ep is off: the port splits "
                        "them so on both TP paths (parallel/sharding.py)",
                        mesh.n, cfg.moe.num_experts // mesh.n)
        t0 = time.monotonic()
        full = self.params
        self.params = sharding.shard_params(full, cfg, mesh)
        logger.info("TP mesh %s: params split over %d ranks in %.1fs",
                    mesh.shape, mesh.n, time.monotonic() - t0)
        if not (rt.enable_megakernel and EnvConfig.megakernel_enabled()):
            logger.info("megakernel disabled by configuration; decode runs "
                        "the per-op TP path")
            return
        view = full
        if _has_leaf_key(full, "w_q8") or _has_leaf_key(full, "w_f8"):
            view = mk.weight_only_decode_view(_host_tree(full))
            if view is None:
                logger.info("TP segments: the model has no weight-only "
                            "decode view; decode runs the per-op TP path")
                return
            view = params_from_numpy(view, self.device, self.dtype)
            parts = sharding.shard_params(view, cfg, mesh)
        else:
            parts = self.params
        n = mesh.n
        if not tpk.supports_tp(cfg, rt, view, n, local=parts[0]):
            logger.info("TP segments: the model or its quantization is not "
                        "supported (ops.tp_megakernel.supports_tp); decode "
                        "runs the per-op TP path")
            return
        plan, packs = tpk.make_tp_plan(cfg, rt, parts)
        if self.device.type == "cuda":
            gaps = tpk.cuda_kernel_gaps(plan)
            if gaps:
                logger.warning("TP segments: the CUDA kernels do not take "
                               "this model (%s); decode runs the per-op TP "
                               "path", "; ".join(gaps))
                return
        self.tp_mega_plan = plan
        self.mega_params = {"packs": packs,
                            "embed": self.params[0]["embed_tokens"]["w"]}
        logger.info(
            "TP segments packed in %.1fs: %d ranks, streams %s, %.2f GiB "
            "streamed per rank and step; packs %.2f GiB beyond the raw "
            "params", time.monotonic() - t0, n,
            "/".join(f"{s.name}:{s.bits}b" for s in plan.streams),
            plan.weight_bytes / 1024**3,
            sum(mk.packed_extra_bytes(p, r) for p, r in
                zip(packs, parts)) / 1024**3)
        if cfg.moe is not None:
            logger.info("MoE on a mesh: every prefill runs per-op TP (the "
                        "TP prefill segments compute a dense MLP)")
        elif EnvConfig.prefill_megakernel_enabled():
            self._install_tp_prefill(view, parts[0])

    # -- megakernel install ---------------------------------------------------
    def _install_megakernel(self) -> Optional[Dict]:
        """The JAX runtime's install order: weight-only view -> stream rule
        (u4 leaves re-expanded to per-channel i8 at large max_batch, dense
        models only, when the card can hold them beside the raw params) ->
        supports -> make_plan -> pack_params -> mega_params = {"packed",
        "embed"} with the one embedding copy. A model `supports` turns down
        is served per-op, with the reason logged. Returns the tree the plan
        was made from (None without a plan)."""
        rt, cfg = self.rt, self.cfg
        if not (rt.enable_megakernel and EnvConfig.megakernel_enabled()):
            logger.info("megakernel disabled by configuration; serving the "
                        "per-op path")
            return None
        t0 = time.monotonic()
        src = self.params
        if _has_leaf_key(src, "w_q8") or _has_leaf_key(src, "w_f8"):
            view = mk.weight_only_decode_view(_host_tree(src))
            if view is None:
                logger.info("megakernel: the model has no weight-only decode "
                            "view; serving the per-op path")
                return None
            src = params_from_numpy(view, self.device, self.dtype)
        stream = EnvConfig.mk_stream()
        expanded = False
        if stream != "u4" and cfg.moe is None and (
                stream == "i8" or rt.max_batch >= EnvConfig.mk_i8_batch()):
            meta = mk.expand_u4_to_i8(_shape_tree(src), meta_only=True)
            if meta is not None and self._i8_pack_fits(meta):
                if not mk.supports(cfg, rt, meta):
                    self._log_unsupported(meta)
                    return None
                logger.info("decode stream: u4 -> per-channel i8 "
                            "re-expansion (max_batch=%d)", rt.max_batch)
                i8 = mk.expand_u4_to_i8_tensors({"layers": {
                    n: src["layers"][n] for _, names in mk._LAYER_STREAMS
                    for n in names}, "lm_head": src["lm_head"]})
                src = dict(src, lm_head=i8["lm_head"],
                           layers=dict(src["layers"], **i8["layers"]))
                expanded = True
        if not mk.supports(cfg, rt, src):
            self._log_unsupported(src)
            return None
        plan = mk.make_plan(cfg, rt, src)
        if self.device.type == "cuda":
            gaps = mk.cuda_kernel_gaps(plan)
            if gaps:
                logger.warning("megakernel: the CUDA kernel does not take "
                               "this model (%s); serving the per-op path",
                               "; ".join(gaps))
                return None
        packed = mk.pack_params(cfg, plan, src)
        self.mega_plan = plan
        self.mega_params = {"packed": packed,
                            "embed": self.params["embed_tokens"]["w"]}
        logger.info(
            "megakernel packed in %.1fs: streams %s, %.2f GiB streamed per "
            "step; pack %.2f GiB beyond the raw params (%s)",
            time.monotonic() - t0,
            "/".join(f"{s.name}:{s.bits}b" for s in plan.streams),
            plan.weight_bytes / 1024**3,
            mk.packed_extra_bytes(packed, self.params) / 1024**3,
            "the i8 re-expansion in fragment order" if expanded
            else "a fragment-ordered copy of the payloads")
        if plan.E:
            ex = {k: v for k, v in packed["layers"].items()
                  if k.startswith("experts.")}
            logger.info(
                "megakernel MoE: %d experts, top-%d; the experts' pack "
                "%.2f GiB (%.2f GiB per step if every expert streamed; the "
                "kernel reads the routed ones)", plan.E, plan.k_top,
                mk.packed_extra_bytes(ex, self.params) / 1024**3,
                plan.L * plan.E * sum(sp.matrix_bytes for sp in
                                      (plan.gu, plan.dn)) / 1024**3)
        return src

    def _install_prefill_megakernel(self, src: Optional[Dict]) -> None:
        """A prefill plan for every qualifying bucket, sharing the decode
        pack (the stream geometry does not depend on the bucket); `src` is
        the tree the decode plan was made from. Under the u4 -> i8 stream
        prefill serves from the re-expanded pack too.
        DI_PREFILL_MEGAKERNEL=0 disables."""
        if self.mega_plan is None or \
                not EnvConfig.prefill_megakernel_enabled():
            return
        cfg, rt = self.cfg, self.rt
        # a MoE model's buckets stop at moe_prefill_mega_max_bucket (0: no
        # MoE bucket takes the kernel), as in the JAX runtime
        cap = pmk.MAX_BUCKET if cfg.moe is None else \
            min(pmk.MAX_BUCKET, rt.moe_prefill_mega_max_bucket)
        qual = [b for b in self.buckets
                if b <= cap and b % 128 == 0 and
                pmk.supports_prefill(cfg, rt, src, b)]
        plans = {b: pmk.make_prefill_plan(cfg, rt, src, b,
                                          decode_plan=self.mega_plan)
                 for b in qual}
        if qual and self.device.type == "cuda":
            gaps = pmk.cuda_kernel_gaps(plans[qual[0]])
            if gaps:
                logger.warning("prefill megakernel: the CUDA kernel does "
                               "not take this model (%s); prefilling per-op",
                               "; ".join(gaps))
                return
        self._pmk_plans = plans
        if qual:
            logger.info("prefill megakernel shares the decode pack "
                        "(buckets %s)", qual)
        if qual and self.device.type == "cuda":
            # one scratch set for every bucket, on the card before the KV
            # pool is planned from what is free
            logger.info("prefill megakernel scratch: %.2f GiB",
                        pmk.reserve_scratch(plans.values(), self.device)
                        / 1024**3)

    def _install_tp_prefill(self, view: Dict, local: Dict) -> None:
        """The JAX runtime's TP prefill install: a local prefill plan for
        every bucket <= 1024 that is a multiple of 128 and that
        `supports_prefill_tp` admits, each adopting the TP decode plan's
        streams (so the segments read each rank's TP decode pack), and the
        prefill scratch of every device of the mesh reserved before the
        pools are planned from free memory. `view`: the weight-only tree
        the ranks were split from; `local`: rank 0's split tree."""
        cfg, rt, n = self.cfg, self.rt, self.mesh.n
        qual = [b for b in self.buckets
                if b <= pmk.MAX_BUCKET and b % 128 == 0 and
                tpk.supports_prefill_tp(cfg, rt, view, b, n, local=local)]
        if not qual:
            return
        plans = tpk.make_tp_prefill_plans(cfg, rt, [local], qual,
                                          self.tp_mega_plan)
        if self.device.type == "cuda":
            gaps = tpk.prefill_cuda_kernel_gaps(plans[qual[0]])
            if gaps:
                logger.warning("TP prefill segments: the CUDA kernels do not "
                               "take this model (%s); prefilling per-op TP",
                               "; ".join(gaps))
                return
        self._tp_pmk_plans = plans
        logger.info("TP prefill segments share the TP decode packs "
                    "(buckets %s)", qual)
        if self.device.type == "cuda":
            for dev in self.mesh.distinct:
                logger.info("TP prefill scratch on %s: %.2f GiB", dev,
                            tpk.reserve_prefill_scratch(plans.values(), dev)
                            / 1024**3)

    def release(self) -> None:
        """Frees what the runtime holds on its devices beyond its own
        tensors: the prefill scratch (one set a device)."""
        if self.device.type != "cuda":
            return
        if self._pmk_plans:
            pmk.release_scratch(self.device)
        if self._tp_pmk_plans:
            for dev in self.mesh.distinct:
                pmk.release_scratch(dev)

    # -- weight residency ----------------------------------------------------
    def _decide_residency(self) -> None:
        """Whether the raw params stay on the card beside the megakernel
        pack ("both") or go to host memory ("pack_only"). The pack is the
        one weight set of the two kernels; the raw params only serve the
        per-op path (buckets the prefill megakernel does not take). "auto"
        drops them when the configured workload could not fit otherwise."""
        rt = self.rt
        res = EnvConfig.weight_residency() or rt.weight_residency
        if res not in ("auto", "both", "pack_only"):
            logger.warning("unknown weight_residency %r; using auto", res)
            res = "auto"
        eligible = (self.mesh is None and bool(self._pmk_plans) and
                    not rt.enable_lora)
        if res == "pack_only" and not eligible:
            raise ValueError(
                "weight_residency=pack_only needs the decode AND prefill "
                "megakernels active on a single-chip mesh without LoRA "
                f"(megakernel={self.mega_params is not None}, "
                f"prefill_buckets={sorted(self._pmk_plans)}, "
                f"mesh={self.mesh is not None}, lora={rt.enable_lora})")
        before = _resident_bytes(self.params, self.mega_params)
        if eligible and (res == "pack_only" or
                         (res == "auto" and self._auto_pack_only())):
            self._demote_raw_params()
        logger.info(
            "weight residency: %s (requested %s): %.2f GiB of weights on "
            "the device, %.2f GiB before the decision; the megakernels' "
            "params %.2f GiB", self.residency, res,
            _resident_bytes(self.params, self.mega_params) / 1024**3,
            before / 1024**3, _resident_bytes(self.mega_params) / 1024**3)

    def _device_budget(self) -> int:
        total = self.rt.hbm_bytes
        if not total and self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
        return int(total * EnvConfig.hbm_mem_ratio())

    def _auto_pack_only(self) -> bool:
        """auto residency: demote the raw params only when the
        both-resident KV pool could NOT hold the configured workload
        (typical_seq_len x max_batch) but the prompts still fit the prefill
        megakernel's bucket coverage. Host-side arithmetic only."""
        rt = self.rt
        if rt.typical_seq_len <= 0 or rt.cache.num_pages or \
                rt.kv_pool_bytes or EnvConfig.kv_pool_bytes():
            return False
        if not (0 < rt.max_prompt_len <= max(self._pmk_plans)):
            return False      # prompts not provably within the coverage
        budget = self._device_budget()
        if not budget:
            return False      # no device size to plan against (CPU)
        lpb = logical_page_bytes(self.cfg, rt.cache, self.dtype)
        w_both = _resident_bytes(self.params, self.mega_params)
        act = min(2 * 1024**3, max(512 * 1024**2, w_both // 4))
        n_both = max((budget - w_both - act) // lpb, 2 * rt.max_batch)
        per_seq = -(-min(rt.typical_seq_len, rt.max_length) //
                    rt.cache.page_size)
        if n_both >= rt.max_batch * per_seq:
            return False
        logger.warning(
            "both-resident KV pool (~%d pages) cannot hold the workload "
            "(%d slots x %d pages); auto weight_residency selects "
            "pack_only", n_both, rt.max_batch, per_seq)
        return True

    def _demote_raw_params(self) -> None:
        """Move what the pack does not alias (the loader's payloads of the
        packed leaves; under the i8 stream their u4 qparams too) to host
        memory; serving continues through the megakernel pack alone. The
        scale / zero leaves and the embedding the pack points at stay where
        they are. The host copy is kept so a later install can reload it."""
        kept = {t.data_ptr() for t in _tensors(self.mega_params)}

        def demote(tree):
            if isinstance(tree, dict):
                return {k: demote(v) for k, v in tree.items()}
            return tree if tree.data_ptr() in kept else tree.cpu()

        self._raw_params_host = demote(self.params)
        self.params = None
        self.residency = "pack_only"
        self._pack_only_buckets = sorted(self._pmk_plans)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()    # the pool is planned from free memory
        logger.warning(
            "weight residency: pack_only -- raw params demoted to host; "
            "serving through the megakernels only (prefill buckets %s). "
            "Prompts above %d tokens are rejected at start_request.",
            self._pack_only_buckets, max(self._pack_only_buckets))

    def _weights_resident(self) -> bool:
        if self.residency == "pack_only":
            return self.mega_params is not None
        return self.params is not None

    def _i8_pack_fits(self, meta) -> bool:
        """Unless the raw params may leave the card (a residency other than
        "both" with max_prompt_len set, no LoRA), the i8 pack must fit
        beside them."""
        rt = self.rt
        res = EnvConfig.weight_residency() or rt.weight_residency
        if res != "both" and not rt.enable_lora and rt.max_prompt_len > 0:
            return True
        est = _weight_bytes({"layers": {
            n: {k: v for k, v in meta["layers"][n].items() if k != "b"}
            for _, names in mk._LAYER_STREAMS for n in names},
            "lm_head": meta["lm_head"]})
        budget = self._device_budget()
        if not budget:
            return True
        raw_b = _weight_bytes(self.params)
        if raw_b + est + 512 * 1024**2 > budget:
            logger.warning(
                "i8 stream re-expansion skipped: raw params stay resident "
                "(residency=both) and raw %.2f GiB + estimated i8 pack %.2f "
                "GiB exceeds the %.2f GiB budget; keeping the u4 stream",
                raw_b / 1024**3, est / 1024**3, budget / 1024**3)
            return False
        return True

    def _log_unsupported(self, src) -> None:
        rt64 = dataclasses.replace(self.rt, max_batch=mk.MAX_BATCH)
        if self.rt.max_batch > mk.MAX_BATCH and \
                mk.supports(self.cfg, rt64, src):
            logger.warning(
                "max_batch=%d exceeds the decode megakernel's supported "
                "batch (%d); decode falls back to the per-op path",
                self.rt.max_batch, mk.MAX_BATCH)
        else:
            logger.info("megakernel: the model or its quantization is not "
                        "supported (ops.megakernel.supports); serving the "
                        "per-op path")

    # -- planning ------------------------------------------------------------
    def _plan_pool(self) -> int:
        """KV pool size in logical pages: the configured count, else the
        free device memory (the weights that stay are already resident:
        the residency decision has been taken) less an activation headroom,
        else (on the CPU) what max_batch sequences can use. On a mesh the
        plan is per device, the smallest over the mesh's devices: a device
        holds every rank that the mesh puts on it, their weights, packs and
        pool pages (a rank's logical page covers its KV heads)."""
        rt, cfg = self.rt, self.cfg
        if rt.cache.num_pages:
            return self._check_pool_vs_workload(rt.cache.num_pages)
        cap = rt.max_batch * rt.max_pages_per_seq
        kv_bytes = rt.kv_pool_bytes or EnvConfig.kv_pool_bytes()
        if self.mesh is None:
            ranks = {self.device: 1}
            lpb = logical_page_bytes(cfg, rt.cache, self.dtype)
        else:
            ranks = {d: self.mesh.devices.count(d)
                     for d in self.mesh.distinct}
            lpb = logical_page_bytes(
                dataclasses.replace(cfg, num_kv_heads=sharding.rank_kv_heads(
                    cfg, self.mesh.n)), rt.cache, self.dtype)
        if kv_bytes:
            n = max(kv_bytes // lpb, 2 * rt.max_batch)
        else:
            n = cap
            for dev, k in ranks.items():
                w = _resident_bytes(self.params, self.mega_params,
                                    device=dev if self.mesh else None)
                act = min(2 * 1024**3, max(512 * 1024**2, w // 4))
                if dev.type == "cuda":
                    free, _ = torch.cuda.mem_get_info(dev)
                    dev_bytes = int(free * EnvConfig.hbm_mem_ratio()) - act
                elif rt.hbm_bytes:
                    dev_bytes = int(rt.hbm_bytes *
                                    EnvConfig.hbm_mem_ratio()) - w - act
                else:
                    continue
                n = min(n, max(dev_bytes // (k * lpb), 2 * rt.max_batch))
        n = min(n, cap)
        logger.info("KV pool: %d logical pages (%.2f GiB)", n,
                    n * lpb / 1024**3)
        return self._check_pool_vs_workload(int(n))

    def _check_pool_vs_workload(self, n: int) -> int:
        """With typical_seq_len set, cap admission at the concurrency the
        pool can hold instead of serving through OOM-eviction churn."""
        rt = self.rt
        self.admission_cap = rt.max_batch
        if rt.typical_seq_len > 0:
            typ = min(rt.typical_seq_len, rt.max_length)
            per_seq = -(-typ // rt.cache.page_size)
            cap = max(1, min(rt.max_batch, n // per_seq))
            if cap < rt.max_batch:
                logger.warning(
                    "KV pool (%d logical pages) cannot hold %d concurrent "
                    "sequences of typical length %d; admission capped at %d",
                    n, rt.max_batch, typ, cap)
            self.admission_cap = cap
        return n

    def validate_request(self, input_ids, gen_cfg: GenerationConfig) -> None:
        """start_request-time guards (user thread)."""
        missing = _unported_request_features(gen_cfg)
        if missing:
            raise NotImplementedError(
                f"{', '.join(missing)}: not ported to the PyTorch package yet")
        if self.rt.max_prompt_len and \
                len(input_ids) > self.rt.max_prompt_len:
            raise ValueError(
                f"prompt length {len(input_ids)} exceeds max_prompt_len "
                f"{self.rt.max_prompt_len}")
        if self.residency != "pack_only":
            return
        # pack_only serves only what the megakernels cover (LoRA and
        # multimodal requests are refused above under every residency)
        cap = max(self._pack_only_buckets)
        if len(input_ids) > cap:
            raise ValueError(
                f"prompt length {len(input_ids)} exceeds the prefill "
                f"megakernel coverage ({cap} tokens) under "
                "weight_residency=pack_only")

    def _make_buckets(self) -> List[int]:
        rt = self.rt
        b, out = rt.min_prefill_bucket, []
        while b < rt.max_length:
            out.append(b)
            b *= 2
        out.append(rt.max_length)
        return out

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"length {n} exceeds max_length {self.rt.max_length}")

    def _prefill_fn(self, bucket: int, mega=False) -> Callable:
        """The prefill step of a bucket, keyed (bucket, mega): mega True
        for the prefill megakernel, "tp" for the TP prefill segments, False
        for the per-op (or per-op TP) forward, "lora" for the per-op forward
        with the prompt's adapter."""
        key = (bucket, mega)
        if key not in self._prefill_steps:
            self._prefill_steps[key] = steps_mod.build_prefill_step(
                self.cfg, self.rt, bucket,
                mega_plan=self._pmk_plans[bucket] if mega is True else None,
                devices=None if self.mesh is None else self.mesh.devices,
                tp_mega=self._tp_pmk_plans[bucket] if mega == "tp" else None,
                lora_pool=self.lora_manager.pool if mega == "lora" else None)
        return self._prefill_steps[key]

    def _decode_fn(self, with_logprobs: bool, with_guided: bool,
                   with_lora: bool = False,
                   with_banned: bool = False) -> Callable:
        """The single decode step for the batch's features: the plain step
        of its path (with or without an adapter), or a step of its own for
        each combination of logprobs, guided and on-device bans, sharing
        that step's forward (and so its CUDA graph)."""
        base = self._lora_decode_step if with_lora else self._decode_step
        if not (with_logprobs or with_guided or with_banned):
            return base
        key = ("dec", with_logprobs, with_guided, with_lora, with_banned)
        if key not in self._decode_steps:
            self._decode_steps[key] = steps_mod.build_decode_step(
                self.cfg, self.rt, with_logprobs=with_logprobs,
                with_guided=with_guided, with_banned=with_banned,
                forward=base.forward)
        return self._decode_steps[key]

    def _multi_decode_fn(self, with_banned: bool = False) -> Callable:
        """The window of decode_steps_per_launch steps around the forward
        of the runtime's decode path; one CUDA graph a key on the card."""
        key = ("multidec", self.rt.decode_steps_per_launch, with_banned)
        if key not in self._decode_steps:
            self._decode_steps[key] = steps_mod.build_multi_decode_step(
                self.cfg, self.rt, self.rt.decode_steps_per_launch,
                with_banned=with_banned, forward=self._decode_step.forward)
        return self._decode_steps[key]

    def _make_enforcer(self, req: Request):
        fmt = req.gen_cfg.response_format or {}
        if fmt.get("type") not in ("json_object", "json"):
            return None
        if self.tokenizer is None:
            logger.warning("json response_format requested but no tokenizer "
                           "installed; ignoring")
            return None
        return JsonFormatEnforcer(self.tokenizer, req.gen_cfg.eos_token_id,
                                  self.cfg.vocab_size)

    # -- request entry -------------------------------------------------------
    def register(self, req: Request, queue: ResultQueue):
        """Called on the USER thread before the enqueue message is
        submitted, so sync_request observes the request immediately."""
        self.requests[req.uuid] = req
        self.queues[req.uuid] = queue

    def enqueue(self, req: Request, queue: ResultQueue = None):
        if req.release_requested:
            return
        self.pending.append(req)
        self.stat.pendings += 1

    def free_slot_index(self) -> int:
        if sum(1 for r in self.slots if r is not None) >= self.admission_cap:
            return -1
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return -1

    # -- prefill admission ---------------------------------------------------
    def try_prefill_one(self) -> bool:
        d = self.prefill_decide()
        if d is None:
            return False
        self.prefill_execute(d)
        return True

    def prefill_decide(self) -> Optional[PrefillDecision]:
        """Which request, which slot, which pages. Host bookkeeping only.
        Returns None when nothing can be admitted."""
        if not self.pending:
            return None
        slot = self.free_slot_index()
        if slot < 0:
            self._drain_inflight()
            slot = self.free_slot_index()
            if slot < 0:
                return None
        req: Request = self.pending[0]
        need_pages = math.ceil(req.prompt_len / self.rt.cache.page_size)
        if need_pages > self.allocator.num_pages:
            # PERMANENTLY infeasible: the prompt alone wants more pages
            # than the whole pool -- fail it now instead of deadlocking
            logger.error(
                "request %s needs %d pages but the pool has %d total; "
                "failing (raise kv pool / reduce prompt or max_length)",
                req.uuid[:8], need_pages, self.allocator.num_pages)
            self.pending.popleft()
            self.stat.pendings -= 1
            req.status = GenerateRequestStatus.InternalError
            q = self.queues.get(req.uuid)
            if q is not None:
                q.set_status(GenerateRequestStatus.InternalError)
            return None
        if not self.allocator.reserve(req.uuid, need_pages):
            # a finished in-flight request may free pages; then retry
            self._drain_inflight()
            if not self.allocator.reserve(req.uuid, need_pages):
                return None  # no memory; stay pending
        try:
            pages = self.allocator.commit(req.uuid, need_pages)
        finally:
            self.allocator.release_reservation(req.uuid)
        req.logical_pages = [[p] for p in pages]
        req.slot = slot
        self.slots[slot] = req
        self.pending.popleft()
        self.stat.pendings -= 1
        self.stat.runnings += 1
        return PrefillDecision(req=req, slot=slot, pages=pages)

    def prefill_execute(self, d: PrefillDecision) -> None:
        req, slot, pages = d.req, d.slot, d.pages
        total_len = req.prompt_len
        if self.residency == "pack_only":
            # snap to the smallest prefill-megakernel bucket (every admitted
            # prompt fits one: validate_request); a smaller bucket would
            # take the per-op path, which the raw params no longer serve
            bucket = next(b for b in self._pack_only_buckets
                          if total_len <= b)
        else:
            bucket = self.bucket_for(total_len)
        # one page-row length per bucket: trailing zero pages are ignored by
        # the step's length masks
        maxPb = -(-bucket // self.rt.cache.page_size)
        page_row = np.zeros((maxPb,), np.int32)
        npg = min(len(pages), maxPb)
        page_row[:npg] = pages[:npg]
        tok_buf = np.zeros((bucket,), np.int32)
        tok_buf[:total_len] = req.input_ids

        # prefill megakernel (or on a mesh the TP prefill segments):
        # whole-bucket fresh prefill (prefix_len == 0, the only kind the
        # port has); a prompt with an adapter prefills per-op with it
        with_lora = self.lora_manager is not None and \
            req.gen_cfg.lora_name is not None
        use_mega = bucket in self._pmk_plans and not with_lora
        mega = True if use_mega else ("tp" if bucket in self._tp_pmk_plans
                                      else ("lora" if with_lora else False))
        if self.residency == "pack_only" and not use_mega:
            # defense in depth: validate_request should make this
            # unreachable; never run a per-op prefill against params=None
            logger.error("pack_only prefill fell off the megakernel path "
                         "(bucket=%d) -- failing request", bucket)
            self._fail_admitted(req)
            return
        fn = self._prefill_fn(bucket, mega=mega)
        # the per-token features act on the logits of every prefill path
        req.format_enforcer = self._make_enforcer(req)
        banned = self._banned_ids(req)
        # the full prompt ids for the slot's history (the device bans scan
        # it)
        hist = np.full((self.rt.max_length,), -1, np.int32)
        hist[:req.prompt_len] = req.input_ids
        kwargs = dict(hist=steps_mod.to_device(hist, self.device),
                      with_logprobs=bool(req.gen_cfg.logprobs))
        if banned is not None:
            kwargs["banned"] = steps_mod.to_device(
                np.asarray(banned, np.int32), self.device)
        if req.format_enforcer is not None:
            kwargs["allowed"] = steps_mod.to_device(
                req.format_enforcer.allowed_mask(), self.device)
        t0 = time.monotonic()
        try:
            tok, lp, self.cache, self.state = fn(
                self.mega_params if mega in (True, "tp") else self.params,
                self.cache, self.state,
                steps_mod.to_device(tok_buf, self.device),
                steps_mod.to_device(page_row, self.device),
                0, total_len, self._slot_init(req, slot), **kwargs)
        except Exception:
            # fail THIS request (reference converts per-rank exceptions to
            # request status, as_engine_prefill.cpp:216-232)
            logger.exception("prefill failed for %s", req.uuid[:8])
            self._fail_admitted(req)
            return
        self._cached_len[req.uuid] = total_len
        req.prefilled_len = total_len
        req.status = GenerateRequestStatus.Generating
        req.stat.time_in_queue = t0 - req.enqueue_time
        self._inflight_prefills.append((tok, lp, req, t0, mega))
        self.stat.total_prefill_tokens += total_len

    def _fail_admitted(self, req: Request) -> None:
        """Tear down an admitted-but-unserved request: clear its slot,
        release pages, mark InternalError."""
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        req.slot = -1
        self.stat.runnings -= 1
        self._release_pages(req)
        req.status = GenerateRequestStatus.InternalError
        q = self.queues.get(req.uuid)
        if q is not None:
            q.set_status(GenerateRequestStatus.InternalError)

    def _banned_ids(self, req: Request) -> Optional[List[int]]:
        """The host oracle: next tokens banned THIS step by the request's
        bad_words_ids and no_repeat_ngram_size (reference bad-words and
        n-gram filters in the process_id kernels), padded with -1 to
        max_banned_tokens; None without bans."""
        g = req.gen_cfg
        if not g.bad_words_ids and not g.no_repeat_ngram_size:
            return None
        ctx = req.input_ids + req.generated_ids
        banned = set()
        for w in g.bad_words_ids:
            w = [int(t) for t in w]
            if len(w) == 1:
                banned.add(w[0])
            elif len(w) - 1 <= len(ctx) and ctx[-(len(w) - 1):] == w[:-1]:
                banned.add(w[-1])
        n = g.no_repeat_ngram_size
        if n > 0 and len(ctx) >= n - 1:
            tail = tuple(ctx[-(n - 1):]) if n > 1 else ()
            for i in range(len(ctx) - n + 1):
                if tuple(ctx[i:i + n - 1]) == tail:
                    banned.add(ctx[i + n - 1])
        cap = self.rt.max_banned_tokens
        out = sorted(banned)[:cap]
        return (out + [-1] * cap)[:cap]

    def _device_ban_fits(self, g: GenerationConfig) -> bool:
        """True when the request's bad-words / n-gram config fits the
        state's ban arrays (bad_words [max_bad_words, max_bad_word_len],
        max_ngram): then the bans run on the device. Larger configs take
        the synchronous host channel."""
        rt = self.rt
        if g.no_repeat_ngram_size > rt.max_ngram:
            return False
        if len(g.bad_words_ids) > rt.max_bad_words:
            return False
        return all(1 <= len(w) <= rt.max_bad_word_len
                   for w in g.bad_words_ids)

    def _needs_host_banned(self, req: Request) -> bool:
        g = req.gen_cfg
        if not g.bad_words_ids and not g.no_repeat_ngram_size:
            return False
        return not self._device_ban_fits(g)

    def _slot_init(self, req: Request, slot: int) -> steps_mod.SlotInit:
        g = req.gen_cfg
        max_stop = self.rt.max_stop_token_ids
        stop_ids = []
        if g.eos_token_id >= 0 and g.early_stopping:
            stop_ids.append(g.eos_token_id)
        for w in g.stop_words_ids:
            if len(w) == 1:
                stop_ids.append(int(w[0]))
        stop_ids = (stop_ids + [-1] * max_stop)[:max_stop]
        lora_idx = -1
        if self.lora_manager is not None:
            lora_idx = self.lora_manager.index_of(g.lora_name)
        MW, WL = self.rt.max_bad_words, self.rt.max_bad_word_len
        bad_words = np.full((MW, WL), -1, np.int32)
        ngram_n = 0
        if (g.bad_words_ids or g.no_repeat_ngram_size) and \
                self._device_ban_fits(g):
            # right-aligned: the last column is the banned token, the ones
            # before it the context tail it needs (-1: a shorter word)
            for j, w in enumerate(g.bad_words_ids):
                bad_words[j, WL - len(w):] = [int(t) for t in w]
            ngram_n = int(g.no_repeat_ngram_size)
        return steps_mod.SlotInit(
            slot=slot, temperature=float(g.temperature),
            top_k=int(g.top_k if g.do_sample else 1), top_p=float(g.top_p),
            repetition_penalty=float(g.repetition_penalty),
            presence_penalty=float(g.presence_penalty),
            frequency_penalty=float(g.frequency_penalty),
            seed=int(g.seed) & 0xFFFFFFFF, min_gen_len=int(g.min_length),
            stop_token_ids=tuple(stop_ids), lora_idx=lora_idx,
            bad_words=bad_words, ngram_n=ngram_n)

    # -- decode --------------------------------------------------------------
    def active_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def decode_tick(self) -> int:
        """One batched decode launch over all active slots (a single step
        or a window of decode_steps_per_launch steps); returns the number
        of requests stepped. The launch comes before the previous one's
        tokens are drained, so the host prepares launch k+1 while the
        device runs launch k. Requests whose next logits depend on the
        previous token on the host (guided JSON, host-channel bans) force
        a synchronous tick, as does a request at its length limit (so the
        pipeline never launches a step past a finished request)."""
        d = self.decode_decide()
        if d is None:
            return 0
        return self.decode_execute(d)

    def decode_decide(self) -> Optional[DecodeDecision]:
        act = self.active_requests()
        if not act:
            self._drain_inflight()
            return None
        # bans whose config fits the state run on the device and do not
        # force synchronous ticks; guided JSON (the host's FSM) and
        # oversized ban configs (the host channel) do
        sync_mode = any(
            r.format_enforcer is not None or self._needs_host_banned(r)
            for r in act)
        near_limit = any(
            self._cached_len.get(r.uuid, 0) >=
            min(r.gen_cfg.max_length, self.rt.max_length) for r in act)
        if (sync_mode or near_limit) and (self._inflight is not None or
                                          self._inflight_prefills):
            # a sync request's enforcer must have seen every emitted token,
            # prefill first tokens in flight included, before this step's
            # allowed / banned sets are computed; and never launch a step
            # past a request that is about to finish
            self._drain_inflight()
            act = self.active_requests()
            if not act:
                return None
        B, ps = self.rt.max_batch, self.rt.cache.page_size

        # a window of N steps: only when no request needs the host between
        # tokens, none wants logprobs or an adapter, and every one has N
        # tokens of budget left (EOS or a stop word may still end one
        # mid-window: its later rows are dropped at the drain)
        N = self.rt.decode_steps_per_launch
        if N > 1 and not sync_mode and not any(
                r.gen_cfg.logprobs or r.gen_cfg.lora_name is not None
                for r in act) and all(
                r.uuid in self._cached_len and
                min(r.gen_cfg.max_length, self.rt.max_length) -
                self._cached_len[r.uuid] >= N for r in act):
            # the page crossings of all N steps, allocated ahead
            needs = [(req, i) for req in act for i in range(N)
                     if (self._cached_len[req.uuid] + i) % ps == 0]
            try:
                pages = self.allocator.alloc(len(needs)) if needs else []
            except NoFreePages:
                pages = None    # the single step below evicts
            if pages is not None:
                npi = np.full((N, B), -1, np.int32)
                for (req, i), g in zip(needs, pages):
                    req.logical_pages.append([g])
                    npi[i, req.slot] = g
                return DecodeDecision(
                    act=act, kind="multi", npi=npi,
                    with_banned=any(r.gen_cfg.bad_words_ids or
                                    r.gen_cfg.no_repeat_ngram_size
                                    for r in act))

        new_page_ids = np.full((B,), -1, np.int32)
        # allocate pages for slots whose incoming token starts a new page
        for req in list(act):
            clen = self._cached_len.get(req.uuid)
            if clen is None:  # defensive: orphaned slot
                logger.error("slot %d holds unknown request %s; clearing",
                             req.slot, req.uuid[:8])
                self._finish(req, GenerateRequestStatus.InternalError)
                continue
            if clen % ps == 0:
                g = None
                while True:
                    try:
                        g = self.allocator.alloc(1)[0]
                        break
                    except NoFreePages:
                        if not self._evict_victim(exclude=req.uuid):
                            self._interrupt(req)
                            break
                if g is None:
                    continue
                req.logical_pages.append([g])
                new_page_ids[req.slot] = g
        act = self.active_requests()
        if not act:
            return None
        return DecodeDecision(act=act, new_page_ids=new_page_ids,
                              sync_mode=sync_mode)

    def _noise_row(self, req: Request, step: int):
        """The (seed, step) of a sampling request's Gumbel row, None for a
        greedy one."""
        g = req.gen_cfg
        if g.do_sample and g.top_k != 1:
            return int(g.seed) & 0xFFFFFFFF, step
        return None

    def decode_execute(self, d: DecodeDecision) -> int:
        act, B = d.act, self.rt.max_batch
        kernel = self.mega_plan is not None or self.tp_mega_plan is not None
        if d.kind == "multi":
            N = self.rt.decode_steps_per_launch
            rows = [[None] * B for _ in range(N)]
            for r in act:
                for i in range(N):
                    rows[i][r.slot] = self._noise_row(
                        r, self._cached_len[r.uuid] + i)
            tokens, self.cache, self.state = self._multi_decode_fn(
                d.with_banned)(self.mega_params if kernel else self.params,
                               self.cache, self.state, d.npi, rows)
            self.decode_launches["multi"] += 1
            for req in act:
                self._cached_len[req.uuid] += N
            prev, self._inflight = self._inflight, (tokens, None, act,
                                                    kernel)
            if prev is not None:
                self._drain_batch(prev)
            return len(act)

        noise_rows: List = [None] * B
        for r in act:
            noise_rows[r.slot] = self._noise_row(r, self._cached_len[r.uuid])
        with_lp = any(r.gen_cfg.logprobs for r in act)
        guided = [r for r in act if r.format_enforcer is not None]
        with_lora = self.lora_manager is not None and any(
            r.gen_cfg.lora_name is not None for r in act)
        if with_lora:
            # a batch that carries an adapter: its own step and graph
            kernel = self._mega_lora_ok
        # on-device bans for the configs that fit the state's arrays; the
        # host channel serves only the oversized ones (sync_mode)
        dev_banned = any(
            (r.gen_cfg.bad_words_ids or r.gen_cfg.no_repeat_ngram_size) and
            not self._needs_host_banned(r) for r in act)
        kwargs = {}
        host_banned = [r for r in act if self._needs_host_banned(r)]
        if host_banned:
            cap = self.rt.max_banned_tokens
            bmat = np.full((B, cap), -1, np.int32)
            for r in host_banned:
                bmat[r.slot] = self._banned_ids(r)
            kwargs["banned"] = steps_mod.to_device(bmat, self.device)
        if guided:
            allowed = np.ones((B, self.cfg.vocab_size), bool)
            for r in guided:
                allowed[r.slot] = r.format_enforcer.allowed_mask()
            kwargs["allowed"] = steps_mod.to_device(allowed, self.device)
        step = self._decode_fn(with_lp, bool(guided), with_lora, dev_banned)
        tokens, lp, self.cache, self.state = step(
            self.mega_params if kernel else self.params,
            self.cache, self.state,
            steps_mod.to_device(d.new_page_ids, self.device), noise_rows,
            **kwargs)
        self.decode_launches["single"] += 1
        for req in act:
            self._cached_len[req.uuid] += 1
        prev, self._inflight = self._inflight, (tokens, lp, act, kernel)
        if d.sync_mode:
            self._drain_inflight()
        elif prev is not None:
            self._drain_batch(prev)
        return len(act)

    def _drain_inflight(self):
        """Wait for the in-flight decode launch (if any) and emit its
        tokens."""
        self._drain_prefill_tokens()
        batch, self._inflight = self._inflight, None
        if batch is not None:
            self._drain_batch(batch)

    def _drain_prefill_tokens(self):
        """Emit first tokens of launched prefills (oldest first), before any
        decode-batch drain so each request's token order is preserved."""
        lst, self._inflight_prefills = self._inflight_prefills, []
        for tok_t, lp, req, t_launch, mega in lst:
            if self.requests.get(req.uuid) is not req or req.slot < 0:
                continue   # stopped/evicted while the prefill was in flight
            try:
                tok = int(tok_t.cpu())
            except Exception:
                logger.exception("prefill drain failed for %s", req.uuid[:8])
                self._finish(req, GenerateRequestStatus.InternalError)
                continue
            # a grid barrier or a ring wait that gave up leaves its mark
            # here: raise
            if mega is True:
                pmk.check_status(self.device)
            elif mega == "tp":
                for dev in self.mesh.distinct:
                    tpk.check_prefill_status(dev)
            else:   # the per-op prefill's products
                self._check_per_op()
            t1 = time.monotonic()
            req.stat.first_token_time = t1
            req.stat.time_to_first_token = t1 - req.enqueue_time
            req.stat.context_tps = req.prefilled_len / max(t1 - t_launch,
                                                           1e-9)
            if req.format_enforcer is not None:
                req.format_enforcer.advance(tok)
            self._emit(req, [tok], _host_lp(lp), 0)
            self._maybe_finish(req, tok)

    def _drain_batch(self, batch):
        self._drain_prefill_tokens()
        tokens_t, lp, act, kernel = batch
        tokens = tokens_t.cpu().numpy()
        lp = _host_lp(lp)
        # a grid barrier or a ring wait that gave up leaves its mark here
        # (once a launch: a step or a window): raise
        if kernel and self.mega_plan is not None:
            mk.check_status(self.mega_plan, self.device)
        elif kernel:
            for dev in self.mesh.distinct:
                tpk.check_status(self.tp_mega_plan, dev)
        else:   # the per-op decode forward's products
            self._check_per_op()
        # a single step gives [B], a window [N, B]
        rows = tokens[None] if tokens.ndim == 1 else tokens
        n = 0
        for req in act:
            if self.requests.get(req.uuid) is not req or req.slot < 0:
                continue  # stopped/evicted while the step was in flight
            slot = req.slot
            for row in rows:
                tok = int(row[slot])
                if req.format_enforcer is not None:
                    req.format_enforcer.advance(tok)
                self._emit(req, [tok], lp, slot)
                self._maybe_finish(req, tok)
                n += 1
                if req.slot < 0:
                    break   # finished mid-window: its later rows go
        self.stat.total_gen_tokens += n

    def _check_per_op(self):
        """Raises if a quant_matmul launch of a per-op forward gave up at a
        wait of its copy ring, on any of the model's devices."""
        for dev in ((self.device,) if self.mesh is None
                    else self.mesh.distinct):
            qm.check_status(dev)

    # -- token emission & finish ---------------------------------------------
    def _emit(self, req: Request, toks: List[int], lp=None, row: int = 0):
        """lp: the launch's (token logprobs, top ids, top logprobs) on the
        host, read at `row`, or None."""
        req.generated_ids.extend(toks)
        q = self.queues.get(req.uuid)
        if q is None:
            return
        if lp is not None and req.gen_cfg.logprobs:
            token_lp, top_ids, top_lp = lp
            n = req.gen_cfg.top_logprobs or 1
            pairs = [list(zip(top_ids[row][:n].tolist(),
                              top_lp[row][:n].tolist()))]
            q.append(toks, logprobs=pairs,
                     token_logprobs=[float(token_lp[row])])
        else:
            q.append(toks)

    def _maybe_finish(self, req: Request, last_tok: int):
        g = req.gen_cfg
        finished = req.format_enforcer is not None and \
            req.format_enforcer.complete
        finished = finished or (g.early_stopping and g.eos_token_id >= 0 and
                                last_tok == g.eos_token_id)
        if not finished and \
                req.prompt_len + len(req.generated_ids) >= g.max_length:
            finished = True
        if not finished and g.stop_words_ids:
            gen = req.generated_ids
            finished = any(len(w) <= len(gen) and gen[-len(w):] == list(w)
                           for w in g.stop_words_ids)
        if finished:
            self._finish(req, GenerateRequestStatus.GenerateFinished)

    def _finish(self, req: Request, status: GenerateRequestStatus):
        req.status = status
        if req.slot >= 0:
            self.state = self._deactivate(self.state, [req.slot])
            self.slots[req.slot] = None
            req.slot = -1
            self.stat.runnings -= 1
        self._release_pages(req)
        gen_time = time.monotonic() - (req.stat.first_token_time or
                                       time.monotonic())
        if len(req.generated_ids) > 1 and gen_time > 0:
            req.stat.generate_tps = (len(req.generated_ids) - 1) / gen_time
        q = self.queues.get(req.uuid)
        if q is not None:
            q.set_stat(req.stat)
            q.set_status(status)

    def _release_pages(self, req: Request):
        pages = [g for grp in req.logical_pages for g in grp]
        if pages:
            self.allocator.free(pages)
        req.logical_pages = []

    # -- eviction (reference ChooseVictimRequest, as_engine_decode.cpp) ------
    def _evict_victim(self, exclude: Optional[str] = None) -> bool:
        self._drain_inflight()  # a finished in-flight request may free pages
        cands = [r for r in self.active_requests() if r.uuid != exclude]
        if not cands:
            return False
        if self.rt.eviction_strategy == EvictionStrategy.MAX_LENGTH:
            victim = max(cands, key=lambda r: self._cached_len[r.uuid])
        else:
            import random
            victim = random.choice(cands)
        logger.warning("cache OOM: interrupting request %s (len %d)",
                       victim.uuid[:8], self._cached_len[victim.uuid])
        self._interrupt(victim)
        return True

    def _interrupt(self, req: Request):
        req.interrupted = True
        self.stat.interrupted += 1
        self._finish(req, GenerateRequestStatus.GenerateInterrupted)

    def stop_request(self, uuid: str) -> bool:
        self._drain_inflight()
        req = self.requests.get(uuid)
        if req is None:
            return False
        if req in self.pending:
            self.pending.remove(req)
            self.stat.pendings -= 1
            self._finish(req, GenerateRequestStatus.GenerateInterrupted)
            return True
        if req.status in (GenerateRequestStatus.Generating,
                          GenerateRequestStatus.ContextFinished):
            self._finish(req, GenerateRequestStatus.GenerateInterrupted)
        return True

    def release_request(self, uuid: str):
        self.stop_request(uuid)
        self.requests.pop(uuid, None)
        self.queues.pop(uuid, None)
        self._cached_len.pop(uuid, None)

    # -- stats ----------------------------------------------------------------
    def update_stats(self):
        s = self.stat
        s.total_span = self.allocator.num_pages
        s.free_span = self.allocator.num_free
        s.used_span = s.total_span - s.free_span
