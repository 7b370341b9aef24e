"""Per-model runtime: device state + synchronous scheduling primitives.

Counterpart of the single-device serving subset of
`dashinfer_tpu.engine.model_runtime`: the megakernel install (weight-only
view, stream rule, plan, pack), request validation, prefill buckets,
KV-pool planning, the decide/execute split of prefill admission and of the
single-step decode tick, token drains, finishing, OOM eviction and
stop/release. The Engine's control loop (engine/engine.py) calls into this.
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

Page accounting: the allocator hands out LOGICAL pages; logical page `g`
owns physical pages `g*L + l` for each layer l.

Token drains: a step's sampled tokens stay on the device until the step
after it has been launched; the drain then reads them with a plain `.cpu()`,
which waits only for the earlier step. Prefill first tokens are read the
same way at the next drain.
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
from dashinfer_tpu_torch.engine.stats import EngineStat
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
    get."""

    act: List[Request]
    new_page_ids: np.ndarray      # [B] logical page per slot, -1 = none


def _unported_runtime_features(rt: RuntimeConfig) -> List[str]:
    return [name for name, on in (
        ("prefix cache", rt.enable_prefix_cache),
        ("LoRA", rt.enable_lora),
        ("a data-parallel mesh axis", rt.mesh_shape[0] != 1),
        ("chunked prefill (max_prefill_chunk)", rt.max_prefill_chunk > 0),
        ("multi-step decode (decode_steps_per_launch)",
         rt.decode_steps_per_launch > 1),
        ("JSON mode", rt.enable_json_mode),
    ) if on]


def _unported_request_features(g: GenerationConfig) -> List[str]:
    return [name for name, on in (
        ("logprobs", g.logprobs or g.top_logprobs > 0),
        ("response_format", bool(g.response_format)),
        ("bad_words_ids", bool(g.bad_words_ids)),
        ("no_repeat_ngram_size", g.no_repeat_ngram_size > 0),
        ("lora_name", g.lora_name is not None),
        ("multimodal inputs", g.mm_info is not None or
         g.mrope_positions is not None or g.mrope_position_delta != 0),
    ) if on]


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
                 rt: RuntimeConfig, device="cuda"):
        """params: the stacked param tree as tensors on `device` (rank 0's
        device on a mesh: loader.params_from_numpy). `device`: one device,
        or on a `(1, n)` mesh (rt.mesh_shape) the list of the ranks'
        devices; a list that names one device several times puts several
        ranks on it."""
        check_supported(cfg)
        missing = _unported_runtime_features(rt)
        if missing:
            raise NotImplementedError(
                f"{', '.join(missing)}: not ported to the PyTorch package yet")
        self.name = name
        self.cfg = cfg
        self.rt = rt
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
        self._prefill_steps: Dict = {}     # (bucket, mega) -> step
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
            gaps = pmk.cuda_kernel_gaps(plans[qual[0]])
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
        for the per-op (or per-op TP) forward."""
        key = (bucket, mega)
        if key not in self._prefill_steps:
            self._prefill_steps[key] = steps_mod.build_prefill_step(
                self.cfg, self.rt, bucket,
                mega_plan=self._pmk_plans[bucket] if mega is True else None,
                devices=None if self.mesh is None else self.mesh.devices,
                tp_mega=self._tp_pmk_plans[bucket] if mega == "tp" else None)
        return self._prefill_steps[key]

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
        # port has)
        use_mega = bucket in self._pmk_plans
        mega = True if use_mega else ("tp" if bucket in self._tp_pmk_plans
                                      else False)
        if self.residency == "pack_only" and not use_mega:
            # defense in depth: validate_request should make this
            # unreachable; never run a per-op prefill against params=None
            logger.error("pack_only prefill fell off the megakernel path "
                         "(bucket=%d) -- failing request", bucket)
            self._fail_admitted(req)
            return
        fn = self._prefill_fn(bucket, mega=mega)
        t0 = time.monotonic()
        try:
            tok, self.cache, self.state = fn(
                self.mega_params if mega else self.params,
                self.cache, self.state,
                steps_mod.to_device(tok_buf, self.device),
                steps_mod.to_device(page_row, self.device),
                0, total_len, self._slot_init(req, slot))
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
        self._inflight_prefills.append((tok, req, t0, mega))
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
        return steps_mod.SlotInit(
            slot=slot, temperature=float(g.temperature),
            top_k=int(g.top_k if g.do_sample else 1), top_p=float(g.top_p),
            repetition_penalty=float(g.repetition_penalty),
            presence_penalty=float(g.presence_penalty),
            frequency_penalty=float(g.frequency_penalty),
            seed=int(g.seed) & 0xFFFFFFFF, min_gen_len=int(g.min_length),
            stop_token_ids=tuple(stop_ids))

    # -- decode --------------------------------------------------------------
    def active_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def decode_tick(self) -> int:
        """One batched decode step over all active slots; returns the number
        of requests stepped. The step is launched before the previous
        step's tokens are drained, so the host prepares step N+1 while the
        device runs step N."""
        d = self.decode_decide()
        if d is None:
            return 0
        return self.decode_execute(d)

    def decode_decide(self) -> Optional[DecodeDecision]:
        act = self.active_requests()
        if not act:
            self._drain_inflight()
            return None
        near_limit = any(
            self._cached_len.get(r.uuid, 0) >=
            min(r.gen_cfg.max_length, self.rt.max_length) for r in act)
        if near_limit and (self._inflight is not None or
                           self._inflight_prefills):
            # never launch a step past a request that is about to finish
            self._drain_inflight()
            act = self.active_requests()
            if not act:
                return None
        B, ps = self.rt.max_batch, self.rt.cache.page_size
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
        return DecodeDecision(act=act, new_page_ids=new_page_ids)

    def decode_execute(self, d: DecodeDecision) -> int:
        act = d.act
        noise_rows: List = [None] * self.rt.max_batch
        for r in act:
            if r.gen_cfg.do_sample and r.gen_cfg.top_k != 1:
                noise_rows[r.slot] = (int(r.gen_cfg.seed) & 0xFFFFFFFF,
                                      self._cached_len[r.uuid])
        kernel = self.mega_plan is not None or self.tp_mega_plan is not None
        tokens, self.cache, self.state = self._decode_step(
            self.mega_params if kernel else self.params,
            self.cache, self.state,
            steps_mod.to_device(d.new_page_ids, self.device), noise_rows)
        for req in act:
            self._cached_len[req.uuid] += 1
        prev, self._inflight = self._inflight, (tokens, act)
        if prev is not None:
            self._drain_batch(prev)
        return len(act)

    def _drain_inflight(self):
        """Wait for the in-flight decode step (if any) and emit its tokens."""
        self._drain_prefill_tokens()
        batch, self._inflight = self._inflight, None
        if batch is not None:
            self._drain_batch(batch)

    def _drain_prefill_tokens(self):
        """Emit first tokens of launched prefills (oldest first), before any
        decode-batch drain so each request's token order is preserved."""
        lst, self._inflight_prefills = self._inflight_prefills, []
        for tok_t, req, t_launch, mega in lst:
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
            self._emit(req, [tok])
            self._maybe_finish(req, tok)

    def _drain_batch(self, batch):
        self._drain_prefill_tokens()
        tokens_t, act = batch
        tokens = tokens_t.cpu().numpy()
        # a grid barrier or a ring wait that gave up leaves its mark here:
        # raise
        if self.mega_plan is not None:
            mk.check_status(self.mega_plan, self.device)
        elif self.tp_mega_plan is not None:
            for dev in self.mesh.distinct:
                tpk.check_status(self.tp_mega_plan, dev)
        else:   # the per-op decode forward's products
            self._check_per_op()
        n = 0
        for req in act:
            if self.requests.get(req.uuid) is not req or req.slot < 0:
                continue  # stopped/evicted while the step was in flight
            tok = int(tokens[req.slot])
            self._emit(req, [tok])
            self._maybe_finish(req, tok)
            n += 1
        self.stat.total_gen_tokens += n

    def _check_per_op(self):
        """Raises if a quant_matmul launch of a per-op forward gave up at a
        wait of its copy ring, on any of the model's devices."""
        for dev in ((self.device,) if self.mesh is None
                    else self.mesh.distinct):
            qm.check_status(dev)

    # -- token emission & finish ---------------------------------------------
    def _emit(self, req: Request, toks: List[int]):
        req.generated_ids.extend(toks)
        q = self.queues.get(req.uuid)
        if q is not None:
            q.append(toks)

    def _maybe_finish(self, req: Request, last_tok: int):
        g = req.gen_cfg
        finished = (g.early_stopping and g.eos_token_id >= 0 and
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
