#!/usr/bin/env python3
"""Drive the PyTorch port (dashinfer_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--details out/chip_smoke.json] [--only a,b,...]

Phases (any failure exits non-zero; `--only` runs a subset while working
on one of them, and then prints no final result line):
  build       device name, `nvidia-smi` name + power limit, and the build of
              every CUDA kernel (one nvcc per source, all started together);
  quant_matmul, paged_attention, grouped_quant_matmul, stream_probe, probes,
  megakernel, prefill_megakernel
              each kernel's wrapper on the card at the shapes the serving
              path gives it, held against its plain PyTorch version on the
              same inputs, and timed beside the plain version and, where one
              PyTorch call computes the same function, that call.
              quant_matmul also with per-channel u4 and int8 leaves at every
              projection shape, M = 2, 9, 16, 17, f32 x and output (q|o at
              8 and 32, gate|up u4 and int8 at 32), a (1, 2)
              mesh's q / k shards per-channel and at group 128, int8 group
              128 at M = 1 and 32; one kernel launch a product under
              `torch.profiler`; two replays of one graph bit-equal. Paged
              attention also at every G 1..8, D 64 / 256, every pool kind,
              NaN garbage past lens and a one-chunk batch, and on a
              long-context state at B = 8 and 32 beside SDPA. The grouped
              GEMM: Qwen1.5-MoE's expert shapes at the bucket-32 .. 1024
              prefills, int8, without `tile_rows` and on a rank's share
              (and the ragged route against it at a decode batch). The
              megakernel: one decode step at Qwen2-7B width for INT8, UINT4
              and DEFAULT KV and for the u4 and the per-channel i8 weight
              stream, logits and pool writes against the plain version;
              two replays of one graph and an eager launch bit-equal (the
              attention merge's tickets go back to 0);
              then ms per step at B = 8 and 32 beside the byte bound and the
              per-op forward's graph replay on the same state. The prefill
              megakernel: one prefill of bucket 128 (n = 100) for the same
              KV modes and streams (and the bf16 stream at a depth of two
              layers) and of buckets 256, 512 and 1024 (a served prompt
              length and the full bucket each),
              logits and the pool against the plain version; then ms per
              launch for buckets 128 .. 1024 beside the bound and the per-op
              `prefill_forward`; two replays of one graph and an eager
              launch bit-equal at 1024 and at 128 with n = 100. The
              probes: the two design probes of
              csrc/probes.cu through their tools;
  serve       the slices end to end: Qwen2-7B width (28 layers, random a16w4
              group-128 weights made on the card from a seed), INT8 KV,
              concurrent greedy and seeded top-k requests through `Engine`
              after one warm-up request: with every flag at its default (the
              decode megakernel, and the prefill megakernel for buckets
              128 .. 1024), through the per-op path, and with
              `weight_residency="pack_only"` (the pack alone on the card);
              each kernel's launch count is zeroed just before the timed
              requests and read just after;
  decode_logits
              one per-op decode step's logits through the kernels against
              the same step through their plain versions, and its profile;
  tp_segments the tensor-parallel segment kernels (csrc/tp_segments.cu) of
              every rank of a (1, n) mesh whose ranks share the card, at
              Qwen2-7B width, B = 8: n = 2 with INT8 and UINT4 KV and n = 4
              with INT8, each segment against its plain version, the whole
              TP decode forward (CUDA-graph replay) against `tp_decode_ref`
              and against the single-device decode megakernel on the same
              weights and state; the mlp segment also at B = 32 and on the
              per-channel int8 and bf16 (two layers) weight streams (n =
              2, INT8); the attn and mlp segments' two graph replays and
              an eager launch bit-equal; then (n = 2, INT8) ms per segment
              launch beside its bound and plain version (the attn and mlp
              segments' per-phase times), and ms per TP step beside the
              single-device megakernel's;
  tp_prefill  the tensor-parallel prefill segment kernels
              (csrc/tp_prefill_segments.cu) of every rank of a (1, n) mesh
              whose ranks share the card, at Qwen2-7B width and depth:
              n = 2 with INT8 KV at buckets 128 / 256 / 512 / 1024 (a
              served prompt length and full), with UINT4 at 128 and 1024,
              n = 4 with INT8 at 128 and 1024, and the per-channel int8
              and the bf16 (two layers deep) weight streams at n = 2,
              INT8, 128 and 1024 (the segments' 8- and 16-bit products);
              each segment (layers 0 and
              27) against its plain version, the whole TP prefill against
              `tp_prefill_ref` and against the single-device prefill
              megakernel on the same weights and prompt; that the runtime's
              TP prefill install takes buckets 128 .. 1024 at n = 2 and 4;
              the mlp segment's two graph replays and an eager launch
              bit-equal at bucket 1024, the attn segment's at 1024 and at
              128 with n = 100;
              then (n = 2, INT8, full buckets) ms per segment launch beside
              its bound and plain version (their per-phase times; attn and
              mlp beside their
              product's yardstick, `torch.matmul` of the rank's q|k|v /
              gate|up on the bf16 weight), and the whole TP prefill by
              graph replay and eagerly beside the single-device prefill
              megakernel and the per-op TP prefill;
  serve_tp    Qwen2-7B served on a (1, 2) mesh with `serve`'s traffic, with
              every flag at its default (decode through the segments, the
              prefills of buckets 128 .. 1024 through the prefill segments,
              the bucket-32 prompt per-op TP), with DI_PREFILL_MEGAKERNEL=0
              (every prefill per-op TP) and per-op; launch counts checked,
              greedy tokens held to the single-device serving's, TTFT and
              ms/step printed for the first two. The ranks take distinct
              cards (NCCL) when the machine has two, else share this one
              (a sum on the card).
  lora        the decode megakernel's LoRA branch at Qwen2-7B width: a pool
              of 4 slots of rank 16 holding 3 adapters on all seven
              targets (made on the card from a seed), rows on every loaded
              slot and rows without one, against its plain version at
              B = 8 (INT8 / UINT4 KV, u4 and per-channel i8 streams) and
              B = 32 (u4, i8), the adapters' rows' pool writes by the
              LORA_POOL_RTOL rule and the others' by the dense rules; an
              all-none batch bit-equal to the launch without the pool on
              the same grid; two graph replays and an eager launch
              bit-equal; the ptxas figures of every `mk_kernel` and
              `seg_kernel`; ms a step beside the launch without the pool
              and the bound;
  serve_lora  Qwen2-7B with `enable_lora` served through `Engine` (three
              adapters, one from a PEFT `adapter_model.bin`; eight greedy
              requests on three adapters and none) with the default flags
              and per-op: the LoRA branch's launches counted, the first 8
              tokens equal across the paths, an adapter unloaded and
              another loaded into its slot mid-run, ms/step with and
              without adapters and TTFT.
  serve_multistep
              Qwen2-7B served with decode windows (decode_steps_per_launch
              4: four decode steps, their samplers and bookkeeping in one
              CUDA graph) on the default path, per-op and on a (1, 2) mesh
              sharing the card, each beside the single-step serving of the
              same path, every prefill admitted before the first decode
              step: every token of the six requests equal, the kernels'
              launches == 4 x windows + single steps, one graph capture a
              window key; the default path also with windows of 8; ms/step
              of both side by side. On the window engines: two requests
              with bad words from the single-step run's output and
              no_repeat_ngram_size 3 through windows (the on-device mask)
              and through the host channel (single steps), equal and clean
              by the host oracle; a top_logprobs = 5 request on the default
              and per-op paths (top-1 id and logprob, finite, <= 0, the
              paths within 4 x LOGITS_RTOL x max|logit| where their tokens
              agree); a seeded JSON-mode request over a 152,064-id
              JSON-ish tokenizer, a JSON prefix.
Then Qwen2-7B's weights go, and Qwen3-8B (per-head QK RMSNorm; 36 layers,
32 heads on 8 KV heads, vocab 151936, random a16w4 weights made on the
card with q_norm / k_norm not all ones) runs:
  qwen3       the QK-norm branch of the four kernels that compute attention
              against their plain versions: the decode megakernel (B = 8,
              INT8 / UINT4 / DEFAULT KV; B = 32), the prefill megakernel
              (every bucket 128 .. 1024, a served length and full), the TP
              attn, mlp and lm segments and the TP prefill segments of every
              rank of a (1, 2) mesh (INT8, UINT4; the lm segments over the
              75968-column vocab shard, 64 mod 128); two graph replays and
              an eager launch bit-equal for each of the four; their times
              beside their bounds;
  serve_qwen3 Qwen3-8B served with `serve`'s traffic with every flag at its
              default, per-op and on a (1, 2) mesh, launch counts checked,
              the greedy requests' first 8 tokens equal across the three.
Then Qwen3-8B's weights go, and Baichuan2-13B (ALiBi; 40 layers, 40 heads
on 40 KV heads, inter 13696, vocab 125696, random a16w4 weights made on the
card, zero-mean for the kernel checks and bench_stream's for the serving,
the lm_head's columns unit-normed as NormHead leaves them) runs:
  baichuan    the ALiBi branch of the four kernels that compute attention
              against their plain versions: the decode megakernel (B = 8,
              INT8 / UINT4 / DEFAULT KV; B = 32; a long-context state whose
              slots span two attention chunks, where two planted faults,
              the slopes zero and the bias origin moved by one token past
              the first chunk, must fail the logits check), the prefill
              megakernel (every bucket 128 .. 1024, a served length and
              full; zero slopes planted at 1024); at the TP check geometry
              (inter 13824, 4 layers: `supports_tp` turns the 13B away) the
              TP attn, mlp and lm segments and the TP prefill segments of
              every rank of a (1, 2) mesh (INT8, UINT4) with the whole TP
              forwards, and rank 1 with `alibi_slopes(20)` planted; two
              graph replays and an eager launch bit-equal for each of the
              four; their times beside their bounds; the default and the
              per-op path teacher-forced over 25 greedy tokens (a token
              where they choose apart must be a near-tie);
  serve_baichuan
              Baichuan2-13B served with `serve`'s traffic with every flag at
              its default and per-op (no paged_attention launch: an ALiBi
              model's per-op decode attention is the plain version), launch
              counts checked, the greedy requests' first 8 tokens equal.
Then the MoE slice runs at Qwen1.5-MoE-A2.7B width
(24 layers, 60 experts top-4 + a shared expert, random a16w4 weights made on
the card): `megakernel` and `prefill_megakernel` hold the two kernels' MoE
branches against their plain versions (KV modes, B = 8 / 32, every bucket
128 .. 1024 the serving launches; a router near-tie that routes a row
differently is counted and capped; the decode branch's two graph replays
and an eager launch bit-equal) and time them beside the routed bounds;
`serve` serves the MoE model with every flag at its default and per-op
(and, for `serve_tp_moe`, with DI_PREFILL_MEGAKERNEL=0).
The MoE decode check also runs the plain version routed as the kernel
routed (`kernel_routing`) and holds every active row to it, rows the two
route differently included. Then, on a (1, n) mesh whose ranks share the
card:
  tp_moe      the TP MoE segment (csrc/tp_segments.cu `kMoeSeg`) of every
              rank at Qwen1.5-MoE width: n = 2 with INT8 and UINT4 KV at
              B = 8 and INT8 at B = 32, n = 4 with INT8 at B = 8; each rank's
              segment at layers 0 and 23 against its plain version routed
              as the kernel routed (and unforced, with the router flip caps
              and the planted fault), the whole TP forward (CUDA-graph
              replay) against `tp_decode_ref` routed as the kernel and
              unforced and against the single-device MoE megakernel; then
              (n = 2, INT8, B = 8) ms per segment launch beside its routed
              byte bound and plain version, and ms per TP step beside the
              single-device MoE megakernel's;
  serve_tp_moe
              the MoE model served on a (1, 2) mesh with `serve`'s traffic,
              with every flag at its default (decode through the attn and
              moe segments, every prefill per-op TP) and per-op; launch
              counts checked (no TP prefill segment), the greedy requests'
              first 8 tokens held to the single-device serving's on the
              same path, TTFT and ms/step printed.
Last, at Qwen3-30B-A3B's width, cut to 4 layers (128 experts top-8 of width
768, no shared expert, norm_topk_prob, QK-norm, 32 heads on 4 KV heads):
  qwen3_moe   both megakernels' MoE branches with the QK-norm branch
              against their plain versions under the MoE rules (decode: the
              flip caps and the planted router fault; prefill: routed as
              the kernel routed, every token held), the TP moe segment of
              every rank of a (1, 2) mesh at B = 32, their times, and the
              model served with every flag at its default (launch counts
              checked).
It prints a `{"kernels": [...]}` line (each kernel's Qwen3, Qwen3-MoE and
Baichuan2-13B numbers under `qwen3` / `qwen3_moe` / `baichuan`, the TP
segments' Baichuan numbers at the check geometry under
`baichuan_tp_check`), the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. It needs the repository around it (the
`dashinfer_tpu_torch` package) and a CUDA card; without either it exits
non-zero before printing any result. It imports no JAX.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the bound
# of a kernel is the larger of bytes / bandwidth and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# Qwen2-7B (bench.py's shape): vocab 152064, hidden 3584, inter 18944,
# 28 layers, 28 heads, 4 KV heads, head_dim 128, qkv bias, rope 1e6
QWEN2_7B = dict(arch="qwen2", vocab_size=152064, hidden_size=3584,
                intermediate_size=18944, num_layers=28, num_heads=28,
                num_kv_heads=4, head_dim=128, qkv_bias=True,
                rope_theta=1000000.0)
# Qwen1.5-MoE-A2.7B (bench.py's MoE shape): vocab 151936, hidden 2048, 24
# layers, 16 heads on 16 KV heads (one query head a KV head), head_dim 128,
# qkv bias; 60 experts, top-4, expert width 1408, a shared expert of 5632
# with a sigmoid gate, norm_topk_prob False
QWEN15_MOE = dict(arch="qwen2_moe", vocab_size=151936, hidden_size=2048,
                  intermediate_size=5632, num_layers=24, num_heads=16,
                  num_kv_heads=16, head_dim=128, qkv_bias=True,
                  rope_theta=1000000.0)
QWEN15_MOE_EXPERTS = dict(num_experts=60, num_experts_per_tok=4,
                          moe_intermediate_size=1408,
                          shared_expert_intermediate_size=5632,
                          norm_topk_prob=False)
# Qwen3-8B (the published Qwen/Qwen3-8B config.json, written out): vocab
# 151936 (128 mod 256), hidden 4096, inter 12288, 36 layers, 32 heads on 8
# KV heads (G = 4), head_dim 128, no qkv bias, per-head QK RMSNorm, rope
# 1e6, rms eps 1e-6, untied
QWEN3_8B = dict(arch="qwen3", vocab_size=151936, hidden_size=4096,
                intermediate_size=12288, num_layers=36, num_heads=32,
                num_kv_heads=8, head_dim=128, qkv_bias=False, qk_norm=True,
                rope_theta=1000000.0, rms_norm_eps=1e-6)
# Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json): vocab 151936, hidden
# 2048, 48 layers (cut to QWEN3_MOE_LAYERS here), 32 heads on 4 KV heads
# (G = 8, H * D = 4096 against hidden 2048), head_dim 128, QK-norm, no qkv
# bias; 128 experts, top-8, expert width 768, no shared expert,
# norm_topk_prob True
QWEN3_MOE = dict(arch="qwen3_moe", vocab_size=151936, hidden_size=2048,
                 intermediate_size=6144, num_layers=48, num_heads=32,
                 num_kv_heads=4, head_dim=128, qkv_bias=False, qk_norm=True,
                 rope_theta=1000000.0, rms_norm_eps=1e-6)
QWEN3_MOE_EXPERTS = dict(num_experts=128, num_experts_per_tok=8,
                         moe_intermediate_size=768,
                         shared_expert_intermediate_size=0,
                         norm_topk_prob=True)
QWEN3_MOE_LAYERS = 4
# Baichuan2-13B-Chat (its published config.json, written out): ALiBi by the
# 40-layer / model_max_length rule of `models/baichuan._model_config`, 40
# heads on 40 KV heads (G = 1), head_dim 128, no qkv bias, intermediate
# 13696 (128 mod 256), vocab 125696, untied with NormHead
BAICHUAN2_13B_HF = dict(
    architectures=["BaichuanForCausalLM"], vocab_size=125696,
    hidden_size=5120, intermediate_size=13696, num_hidden_layers=40,
    num_attention_heads=40, rms_norm_eps=1e-6, model_max_length=4096,
    hidden_act="silu", tie_word_embeddings=False)
# The TP check geometry: `supports_tp` turns Baichuan2-13B away on any mesh
# (13696 / 2 = 6848 is not a multiple of 128), so the ALiBi branch of the
# TP segments is held at its attention widths with one stated change, an
# intermediate the rule admits (13824 / 2 = 6912 = 54 x 128; down's 108
# groups split in two), cut to 4 layers
BAICHUAN_TP_GEOMETRY = dict(intermediate_size=13824, num_layers=4)
GROUP = 128
DECODE_BATCH = 8          # max_batch of the served model and of the timings
PAGE = 64
SEED = 0                  # of every random weight, cache and input

# (name, K, N, launches per decode step)
PROJECTIONS = [("q_proj+o_proj", 3584, 3584, 2 * 28),
               ("k_proj+v_proj", 3584, 512, 2 * 28),
               ("gate_proj+up_proj", 3584, 18944, 2 * 28),
               ("down_proj", 18944, 3584, 28),
               ("lm_head", 3584, 152064, 1)]

# Tolerances. quant_matmul: kernel and plain version compute the same bf16
# products exactly in f32 and differ only in the order of the f32 sums:
# |d| <= 1e-3 * max|ref|. Each kernel is checked in the dtypes the serving
# path gives it (bf16 x; bf16 out for the projections, f32 for lm_head), and
# a bf16 output may land one rounding step (<= 2^-7 |ref|) the other side
# of a small f32 difference, so bf16 outputs get that step on top,
# elementwise. paged_attention: the same, online against one-pass softmax in
# f32, with bf16 q and output as served. The decode-step logits (B=8) pass
# through 28 layers whose bf16 activations may round differently after an
# f32 order change; the readings were ~1e-3 * max|ref| at B=4, so they are
# held to max|d| <= 1e-2 * max|ref|.
# The decode megakernel against its plain version: logits of the active
# rows as above (1e-2 * max|ref|) with equal argmax, where a row whose two
# best logits the plain version holds closer than twice the measured
# difference counts as a tie; the written token's payload at most one
# quantization level apart (for an unquantized pool one bf16 step on top of
# the tolerance the qparams get) and its qparams within 1e-3 of the token's range in layer 0, where both sides see
# the same input (readings ~1e-6). Deeper layers quantize activations that
# already differ between the two sides: a slot that attends hundreds of
# random cached tokens has an attention output ~1/sqrt(n) of its terms,
# and under UINT4 the affine-after-dot score cancels two large f32 terms,
# so a different summation order moves that slot's small early-layer
# activations by up to ~2e-2 of their range (INT8: 3e-4) while the logits
# stay within 5e-4 of max|ref|; those layers are held to 5e-2. Every other
# pool byte is unchanged.
KERNEL_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
LOGITS_RTOL = 1e-2
# The prefill kernels' one-row lm_head (di_prefill_layer.cuh `lm_row`)
# against its own rounding (`prefill_megakernel.lm_row_ref`) on the row the
# kernel normed (`kernel_x_last`): the same f32 products, parted only by
# the order of the f32 sums (the K split and the splits' ticket sum), so
# held to a hundredth of the logits rule. The logits rule itself holds the
# kernel against the TPU kernel's weight-side form, as before.
ORDER_RTOL = 1e-4
QPARAM_RTOL = 1e-3
DEEP_QPARAM_RTOL = 5e-2
# The prefill megakernel against its plain version run with the kernel's
# bf16 score operands: logits as above (1e-2 * max|ref|), the written rows
# and the rest of the pool as for the decode megakernel. The TPU kernel
# feeds its score product f32 q and k; against the plain version with f32
# scores the logits are held to 3e-2 * max|ref| (q and k rounded to bf16
# move a score by ~2^-9 of |q||k| in each of 28 layers). The pool: every
# element outside rows < n of the owned pages unchanged; rows of layer 0,
# where both sides quantize the same input, within one level and their
# qparams within 1e-3 of the token's range; a row of a deeper layer, in
# dequantized values, within one and a half levels plus 1e-2 of the (token,
# head)'s range (readings <= 7e-3 of the range with INT8 at n = 1000). A
# random model has the odd token whose residual nearly cancels in an early
# layer, so that its RMSNorm amplifies the last bits of the layer before: on
# one such token of 1000 the two PLAIN versions, which differ only in
# rounding q and k to bf16, differ by 11% of the range in layer 2 (and by
# < 1% in every other row and layer). A row beyond the tolerance therefore
# passes only where the two plain versions differ by at least a quarter as
# much on that same row, and only for at most 16 (row, head) pairs of a pool
# (of 112,000 at n = 1000; the readings are 0 to 8 for K and V together);
# their count and their largest difference are printed. Such a row has no
# bound of its own: on one such token at n = 1000 the plain versions differ
# by 1.1 of the range, and the kernel from them by 1.3.
F32_SCORES_RTOL = 3e-2
PREFILL_POOL_RTOL = 1e-2
ILL_ROWS_MAX = 16
# MoE: kernel and plain version route with the same bf16 router, but their
# inputs to it differ by the roundings above (an x_norm element one bf16
# step apart moves a router logit by ~2e-4 here), which can flip a near-tie
# top-k choice in some layer; from there on that row's activations
# legitimately differ. The checks compare every layer's routing of the
# two and count the rows (decode) or tokens (prefill) with a flip; a flip
# passes only where the plain version's own logits hold the two candidates
# (its k-th and k+1-th) within TIE_LOGIT at the first layer that flipped
# (router logits spread ~2.3 here), for at most MAX_FLIPPED_ROWS rows, or
# MAX_FLIPPED_SHARE of a prompt's tokens (read: 1 of 90, 5 of 200, 18 of
# 450, 36 of 1000; gaps 3e-5 .. 5e-3, first layers 0-5), or
# MAX_FLIPPED_ROW_SHARE of a decode batch's active rows, each routed in 24
# layers (read: 0-2 of 7 at B = 8, 3 of 31 at B = 32; gaps 1e-5 .. 3e-2).
# A flipped row is exempt from the logits check and from the pool check in
# every layer: such a row can drift before its first flip (B = 8 int8 read a
# row whose K qparams differ 1e-3 of their range at layer 1, growing ~1.9x a
# layer to 0.14 at layer 9, where it flipped; with the uint4 pool the same
# row does not flip and is held within the tolerances), so the flip is
# where the drift shows, not where it starts. Every other row is held to the
# tolerances above. A planted router fault shows that the caps
# lie between a sound kernel and a faulty one: the plain version's router
# logits with PLANTED_ROUTER_ERR of noise added (under 1% of their spread)
# must route enough rows differently from the plain version to fail them.
MAX_FLIPPED_ROWS = 2
MAX_FLIPPED_SHARE = 0.05
MAX_FLIPPED_ROW_SHARE = 0.1
TIE_LOGIT = 5e-2
PLANTED_ROUTER_ERR = 2e-2
# The decode megakernel's MoE pool: a deeper layer's written row is held in
# dequantized values, within one and a half of its levels plus
# DEEP_QPARAM_RTOL (the bound the dense check puts on deeper layers'
# qparams) of the largest range among that layer's written rows (of that KV
# head). Deeper layers quantize activations that already differ between the
# two sides, and a MoE row's differences pass its routed experts' gates and
# the long-context rows' small attention outputs (~1/sqrt(n)) on: a deep
# row's scale moves by up to ~1e-2 (UINT4: 6.7e-3 read), which shifts the
# far end of an INT8 row's levels by ~3 (B = 32), and one V row of the
# B = 32 state (contexts to 1,500 tokens) read 2.9e-2 of its own range and
# 2.1e-2 of its layer's while the logits held 5e-4 of their largest.
MOE_DEEP_RTOL = DEEP_QPARAM_RTOL
# The dense rule above (every written row within one level) held on
# bench_stream's weights, whose levels 0 .. 15 with zero = -8 x scale give
# every weight a mean of -0.5 x scale: at hidden 5120 that makes a
# common-mode direction of the residual which the logits, and each
# layer's K and V, follow, so the rounding differences of the two sides
# stay small in every layer (and attention barely moves the logits).
# Baichuan2-13B's weights are zero-mean (`random_baichuan_params`), and
# there the rounding differences grow with depth as a MoE row's do: its
# decode pool's rows past layer 0 are held by the MoE rule (in dequantized
# values, within one and a half levels plus MOE_DEEP_RTOL of their layer's
# range; layer 0 within one level), its logits by the dense rule.
# The decode megakernel's LoRA branch: the kernel and the plain version round
# each rank value h of a row on an adapter slot to bf16 after sums taken in
# another order, so an h at a rounding boundary goes one bf16 step (2^-8 of
# it) apart on the two sides and moves the row's delta, which a strong
# adapter makes most of the row, by up to that much. A written K / V row of
# such a row is held in dequantized values within 1.5 of its levels plus
# LORA_POOL_RTOL (one bf16 step, 2^-7) of its own range, in every layer
# (INT8: at most ~3.5 levels); its qparams are not held apart. The rows
# without an adapter keep the dense rules above, and every pool byte
# outside the written rows stays unchanged.
LORA_POOL_RTOL = BF16_STEP
# The MoE decode branch against its plain version routed as the kernel
# routed (forced_routing_check): a (row, layer) whose K or V differs by more
# than CONDITIONED_RTOL of the row's range is held to the bounds unless its
# residual entering the layer is below ILL_NORM_SHARE of the batch's median.
CONDITIONED_RTOL = 2.5e-2
ILL_NORM_SHARE = 1.0 / 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bounds(nbytes: float, ops: float) -> dict:
    """The two floors of a kernel's time on the card, in ms."""
    return dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / BF16_OPS_PER_S)


def aggregate(rows, weights) -> dict:
    """Sum a kernel's per-shape numbers over its launches in one decode
    step; bound_ms sums each launch's larger floor."""
    agg = {k: sum(r[k] * w for r, w in zip(rows, weights))
           for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    agg["bound_ms"] = sum(max(r["bytes_ms"], r["ops_ms"]) * w
                          for r, w in zip(rows, weights))
    agg["bound_by"] = ("bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms")
                       else "operations")
    return agg


def time_ms(fn, args_list, iters: int = 10) -> float:
    """Mean device ms per call. The calls are captured in one CUDA graph and
    the replay is timed with CUDA events, so the host's launch overhead is
    not counted. The calls cycle through args_list: for the weight products,
    copies of the operands together larger than the 50 MB L2, so each call
    reads its weights from HBM as the serving path does."""
    import torch
    n = max(iters, len(args_list))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def replays_bit_equal(what: str, call) -> None:
    """Two replays of one CUDA graph of `call` (its output cleared between)
    and an eager call write the same bits: what a kernel keeps between
    launches (tickets, barriers) starts each launch as the first found it.
    `call` must give the same output each time from the same inputs (a
    segment without `add`, whose x it then leaves as it is)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(first, out), f"{what}: two replays of one graph differ")
    check(torch.equal(first, call()),
          f"{what}: a graph replay and an eager launch differ")
    del graph
    print(f"{what}: two graph replays and an eager launch bit-equal",
          flush=True)


def copies_for(nbytes: int) -> int:
    return max(1, min(32, math.ceil(160e6 / nbytes)))


def held_to_plain(got, ref, what: str) -> float:
    """Checks a kernel's output against its plain version's (the
    tolerances above) and returns max|d|."""
    import torch
    d = (got.float() - ref.float()).abs()
    tol = KERNEL_RTOL * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * ref.float().abs()
    err = d.max().item()
    over = (d > tol).sum().item()
    check(math.isfinite(err) and over == 0,
          f"{what}: {over} elements over tolerance, max|d| {err:.3e}, "
          f"max|ref| {ref.float().abs().max().item():.3e}")
    return err


# -- phase 2: kernels against their plain versions --------------------------

def random_qleaf(K, N, gen, dev, bits=4, group=GROUP):
    """A random quantized leaf; `group` K rows a quant group (K: one group,
    per-channel)."""
    import torch
    G = K // group
    if bits == 4:
        w_q = torch.randint(0, 256, (K, N // 2), dtype=torch.uint8,
                            generator=gen, device=dev)
    else:
        w_q = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                            generator=gen, device=dev)
    scale = torch.rand((G, N), generator=gen, device=dev) * 0.002 + 1e-4
    zero = -scale * 8.0 if bits == 4 else torch.zeros_like(scale)
    return {"w_q": w_q, "scale": scale, "zero": zero}


# quant_matmul cases beyond the projections at M = 1, 8, 32 (u4, group 128):
# (name, K, N, M, bits, group, x and out f32). Per-channel u4 and int8 leaves
# at every projection shape; the n8-tile boundaries on k_proj and gate_proj;
# f32 x with f32 output (q|o on 16-row blocks, gate|up on one block of 32
# rows, u4 and int8); a rank's q|o and k|v shard of a (1, 2) mesh
# (N = 1792, 256) at group 128 and per-channel; int8 group 128.
QMM_CASES = (
    [(f"{name} (per-channel)", K, N, M, bits, K, False)
     for bits in (4, 8) for name, K, N, _ in PROJECTIONS for M in (1, 8, 32)]
    + [(name, 3584, N, M, 4, GROUP, False)
       for name, N in (("k_proj+v_proj", 512), ("gate_proj+up_proj", 18944))
       for M in (2, 9, 16, 17)]
    + [("q_proj+o_proj (f32 x, f32 out)", 3584, 3584, M, 4, GROUP, True)
       for M in (8, 32)]
    + [("gate_proj+up_proj (f32 x, f32 out)", 3584, 18944, 32, bits, GROUP,
        True) for bits in (4, 8)]
    + [(f"{name} (1, 2) shard{tag}", 3584, N, M, 4, group, False)
       for name, N in (("q_proj", 1792), ("k_proj", 256))
       for tag, group in (("", GROUP), (" (per-channel)", 3584))
       for M in (8, 32)]
    + [("q_proj (int8)", 3584, 3584, M, 8, GROUP, False) for M in (1, 32)])


def quant_matmul_case(name, K, N, M, bits, group, f32, n_step, gen, dev):
    """One quant_matmul shape: the kernel held to its plain version, then
    timed beside it and beside `torch.matmul` on the dequantized bf16
    weight (cold: copies of the weights larger than L2)."""
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.ops.linear import dequantize_weight
    wd = random_qleaf(K, N, gen, dev, bits, group)
    x = torch.randn((M, K), generator=gen, device=dev)
    if not f32:
        x = x.to(torch.bfloat16)
    out_dtype = (torch.float32 if f32 or name.startswith("lm_head")
                 else torch.bfloat16)
    got = qm.quant_matmul(x, wd, out_dtype)
    ref = qm.quant_matmul_plain(x, wd, out_dtype)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, f"quant_matmul {name} M={M} bits={bits}")
    scale_ref = ref.float().abs().max().item()
    w_bytes = sum(t.numel() * t.element_size() for t in wd.values())
    copies = [(x, random_qleaf(K, N, gen, dev, bits, group) if i else wd,
               out_dtype) for i in range(copies_for(w_bytes))]
    ms = time_ms(qm.quant_matmul, copies)
    plain_ms = time_ms(qm.quant_matmul_plain, copies[:1], iters=3)
    del copies
    w_lib = dequantize_weight(wd, torch.bfloat16)
    xl = x.to(torch.bfloat16)
    lib_copies = [(xl, w_lib if i == 0 else w_lib.clone())
                  for i in range(copies_for(w_lib.numel() * 2))]
    library_ms = time_ms(torch.matmul, lib_copies)
    del w_lib, lib_copies
    nbytes = (x.numel() * x.element_size() + w_bytes + M * N *
              (4 if out_dtype == torch.float32 else 2))
    row = dict(shape=name, K=K, N=N, M=M, bits=bits, G=K // group,
               max_abs_err=err, ref_max=scale_ref, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, launches_per_step=n_step,
               **bounds(nbytes, 2.0 * M * K * N))
    print(f"quant_matmul {name:38s} M={M:2d} bits={bits} G={K // group:3d} "
          f"err={err:.2e} ms={ms:.4f} bound={row['bytes_ms']:.4f} "
          f"plain={plain_ms:.3f} lib={library_ms:.4f}", flush=True)
    return row


def check_quant_matmul(gen, dev, details):
    import torch
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    per_shape = []
    cases = ([(name, K, N, M, 4, GROUP, False, n)
              for name, K, N, n in PROJECTIONS for M in (1, 8, 32)]
             + [("q_proj (int8)", 3584, 3584, 8, 8, GROUP, False, 0)]
             + [c + (0,) for c in QMM_CASES])
    for name, K, N, M, bits, group, f32, n_step in cases:
        per_shape.append(quant_matmul_case(name, K, N, M, bits, group, f32,
                                           n_step, gen, dev))
    qm.check_status(dev)
    # one kernel launch a product, split over K (k_proj at group 128 and
    # per-channel) or not (gate_proj), at one n8 tile and at four
    prods = [(random_qleaf(K, N, gen, dev, 4, group),
              torch.randn((M, K), generator=gen, device=dev).to(
                  torch.bfloat16))
             for K, N, group, M in ((3584, 512, GROUP, 8),
                                    (3584, 512, 3584, 8),
                                    (3584, 18944, GROUP, 8),
                                    (3584, 512, 3584, 32))]
    for wd, x in prods:
        qm.quant_matmul(x, wd)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for wd, x in prods:
            qm.quant_matmul(x, wd)
        torch.cuda.synchronize()
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if "CUDA" in str(getattr(ev, "device_type", None))}
    n_kernels = sum(kernels.values())
    print(f"quant_matmul under the profiler: {len(prods)} products, "
          f"{n_kernels} CUDA kernels ({kernels})", flush=True)
    check(n_kernels == len(prods) and all("qmm_kernel" in k for k in kernels),
          f"quant_matmul: {len(prods)} products ran {n_kernels} CUDA "
          f"kernels: {kernels}")
    # the split products' tickets start at zero on every replay: two
    # replays of one graph write the same bits (the output cleared between)
    wd, x = prods[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.quant_matmul(x, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.quant_matmul(x, wd)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(first, out), "quant_matmul: two replays of one graph "
          "differ")
    check(torch.equal(first, qm.quant_matmul(x, wd)),
          "quant_matmul: a graph replay and an eager launch differ")
    qm.check_status(dev)
    del graph, prods
    print("quant_matmul: two graph replays and an eager launch bit-equal",
          flush=True)
    details["quant_matmul"] = per_shape
    step = [r for r in per_shape if r["M"] == DECODE_BATCH and
            r["bits"] == 4 and r["launches_per_step"]]
    return dict(max_abs_err=max(r["max_abs_err"] for r in per_shape),
                **aggregate(step, [r["launches_per_step"] for r in step]))


# prompt rows: the per-op MoE decode batch, then the buckets the per-op MoE
# prefills reach (x 4 routed rows each)
GQM_TS = (DECODE_BATCH, 32, 128, 256, 1024)


def gqm_case(what, leaf, K, N, topk_i, E, gen, dev, rows_hint=True,
             rank_experts=None):
    """One call of the grouped GEMM at a routing `topk_i` [T, k] of E
    experts, held against its plain version and timed beside its bound, the
    plain version and one `torch._grouped_mm` on bf16 stacks dequantized
    beforehand. `rank_experts`: the leaf holds experts [0, n) of the E (a
    rank's share on a mesh, as ops/moe.py lays it out: the other experts'
    rows sort last into tiles of 0 rows). Returns the case's row."""
    import torch
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import moe as moe_ops
    T, k = topk_i.shape
    TM = gqm.default_tm()
    if rank_experts is None:
        order, stok, pos, te = gqm.build_group_layout(topk_i, E, TM)
        trows = gqm.tile_row_counts(pos, te.shape[0], TM)
        mine = torch.ones(T * k, dtype=torch.bool, device=dev)
        ids = topk_i.reshape(-1)
        n_e = E
    else:
        n_e = rank_experts
        ids = torch.where(topk_i < n_e, topk_i, n_e)
        order, stok, pos, te = gqm.build_group_layout(ids, n_e + 1, TM)
        trows = gqm.tile_row_counts(pos, te.shape[0], TM)
        trows = torch.where(te == n_e, 0, trows)
        te = te.clamp(max=n_e - 1)
        ids = ids.reshape(-1)
        mine = ids[order] < n_e
    n_tiles = te.shape[0]
    xs = torch.zeros((n_tiles * TM, K), dtype=torch.bfloat16, device=dev)
    rows_x = torch.randn((T * k, K), generator=gen,
                         device=dev).to(torch.bfloat16)
    xs[pos[mine]] = rows_x[mine]
    hint = trows if rows_hint else None
    got = gqm.grouped_quant_matmul(xs, te, leaf, tile_rows=hint)
    ref = gqm.grouped_quant_matmul_plain(xs, te, leaf)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, what)
    shape = gqm.block_shape(xs.shape[0], TM, leaf["scale"].shape[0])
    ms = time_ms(lambda: gqm.grouped_quant_matmul(xs, te, leaf,
                                                  tile_rows=hint),
                 [()], iters=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gqm.grouped_quant_matmul_plain(xs, te, leaf)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    # yardstick: one grouped product of the library on the sorted rows of
    # the leaf's experts and bf16 stacks dequantized beforehand (timed only)
    Np = leaf["scale"].shape[-1]
    w_bf = moe_ops._expert_stack(leaf, torch.bfloat16, N)
    x_sorted = xs[pos[mine].sort().values].contiguous()
    sizes = torch.bincount(ids[ids < n_e], minlength=n_e)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    library_ms, library_note = None, ""
    if not hasattr(torch, "_grouped_mm"):
        library_note = "torch._grouped_mm missing in this torch"
    else:
        for w_lib in (w_bf, w_bf.transpose(-2, -1).contiguous()
                      .transpose(-2, -1)):
            try:
                torch._grouped_mm(x_sorted, w_lib, offs=offs)
                torch.cuda.synchronize()
                library_ms = time_ms(
                    lambda: torch._grouped_mm(x_sorted, w_lib, offs=offs),
                    [()], iters=20)
                library_note = ""
                break
            except Exception as e:       # timed only: no fallback
                library_note = f"torch._grouped_mm: {e}"[:160]
    del w_bf
    used = int((sizes > 0).sum())
    n_rows = int(sizes.sum())
    bits = 8 if leaf["w_q"].dtype == torch.int8 else 4
    w_bytes = used * (K * N * bits // 8 + 2 * 4 * (K // GROUP) * N)
    nbytes = n_rows * K * 2 + w_bytes + n_rows * N * 2
    row = dict(shape=what, T=T, rows=n_rows, K=K, N=N, Np=Np, bits=bits,
               block_shape=shape,
               experts_used=used, tiles=n_tiles,
               tiles_with_rows=int((trows > 0).sum()),
               rows_hint=rows_hint, rank_experts=rank_experts,
               max_abs_err=err, ref_max=ref.float().abs().max().item(),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               library_note=library_note,
               **bounds(nbytes, 2.0 * n_rows * K * N))
    print(f"{what}: err={err:.2e} ms={ms:.4f} bound="
          f"{max(row['bytes_ms'], row['ops_ms']):.4f} plain="
          f"{plain_ms:.2f} lib="
          + (f"{library_ms:.4f}" if library_ms is not None else
             f"- ({library_note})")
          + f"; {row['tiles_with_rows']} of {n_tiles} tiles hold rows, "
          f"{used} experts, block shape {shape}", flush=True)
    return row


def check_grouped_quant_matmul(dev, details):
    """csrc/grouped_quant_matmul.cu at Qwen1.5-MoE width (60 experts, top-4;
    gate / up 2048 -> 1408, padded to 1536 columns by the install, down
    1408 -> 2048) at the shapes the per-op MoE decode (B = 8: 32 routed
    rows) and the per-op MoE prefills of buckets 32, 128, 256 and 1024 give
    it (128 .. 4,096 routed rows), u4; the int8 leaf at T = 8, 32 and 256,
    so that each of the kernel's 6 instantiations (bits x block shape) is
    held; once each a call without the `tile_rows` hint and a rank's share
    of a (1, 2) mesh (30 experts); each against its plain version, timed
    beside its bound, the plain version and `torch._grouped_mm` on
    pre-dequantized bf16 stacks where the installed torch has it. Then one
    MoE layer's
    experts at a decode batch (T = 8) through the grouped route and through
    the ragged route (`DI_MOE_GROUPED=0`): the measured reason for taking
    the grouped kernel at every T on this card."""
    import torch
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import moe as moe_ops
    cfg = moe_config(layers=1)
    moe = cfg.moe
    E, k, hid, Im = (moe.num_experts, moe.num_experts_per_tok,
                     cfg.hidden_size, moe.moe_intermediate_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)

    def qlin(kin, kout, bits=4):
        scale = torch.rand((1, E, kin // GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        if bits == 4:
            w_q = torch.randint(0, 256, (1, E, kin, kout // 2),
                                dtype=torch.uint8, generator=gen, device=dev)
            zero = -scale * 8.0
        else:
            w_q = torch.randint(-128, 128, (1, E, kin, kout),
                                dtype=torch.int8, generator=gen, device=dev)
            zero = torch.zeros_like(scale)
        return {"w_q": w_q, "scale": scale, "zero": zero}

    lp = {"router": {"w": torch.randn((1, hid, E), generator=gen,
                                      device=dev) * 0.05},
          "experts": {"gate_proj": qlin(hid, Im), "up_proj": qlin(hid, Im),
                      "down_proj": qlin(Im, hid)}}
    i8 = {"layers": {"experts": {"gate_proj": qlin(hid, Im, 8)}}}
    gqm.prepare_grouped_experts({"layers": lp}, cfg)
    gqm.prepare_grouped_experts(i8, cfg)

    def layer0(tree):
        return {k_: layer0(v) if isinstance(v, dict) else v[0]
                for k_, v in tree.items()}

    lp = layer0(lp)
    gate, down = lp["experts"]["gate_proj"], lp["experts"]["down_proj"]
    gate8 = layer0(i8)["layers"]["experts"]["gate_proj"]
    rank = E // 2
    share = {key: t[:rank].contiguous() for key, t in gate.items()}
    rows, max_err = [], 0.0
    for T in GQM_TS:
        topk_i = torch.rand((T, E), generator=gen, device=dev).topk(k).indices
        cases = [("gate", gate, hid, Im, {}), ("down", down, Im, hid, {})]
        if T in (DECODE_BATCH, 32, 256):
            cases.append(("gate (int8)", gate8, hid, Im, {}))
        if T == 32:
            cases += [("gate (no tile_rows)", gate, hid, Im,
                       dict(rows_hint=False)),
                      (f"gate (a rank's {rank} experts)", share, hid, Im,
                       dict(rank_experts=rank))]
        for name, leaf, K, N, kw in cases:
            row = gqm_case(f"grouped_quant_matmul {name} T={T} ({T * k} "
                           "rows)", leaf, K, N, topk_i, E, gen, dev, **kw)
            row["shape"] = name
            rows.append(row)
            max_err = max(max_err, row["max_abs_err"])
            torch.cuda.empty_cache()
            if T == DECODE_BATCH:    # the decode batch's narrow-item shape
                check(row["block_shape"] == 0, f"grouped_quant_matmul {name} "
                      f"T={T}: block shape {row['block_shape']}, not 0")
    held = {(r["bits"], r["block_shape"]) for r in rows}
    check(held == {(b, sh) for b in (4, 8) for sh in range(len(gqm.SHAPES))},
          f"grouped_quant_matmul: (bits, block shape) held {sorted(held)}, "
          "not every instantiation of the kernel")
    # the dispatch: one layer's experts at T = 8 through both routes
    x = torch.randn((DECODE_BATCH, hid), generator=gen,
                    device=dev).to(torch.bfloat16)
    route_ms = {}
    for route, env in (("grouped", None), ("ragged", "0")):
        old = os.environ.pop("DI_MOE_GROUPED", None)
        if env is not None:
            os.environ["DI_MOE_GROUPED"] = env
        try:
            route_ms[route] = time_ms(
                lambda: moe_ops.moe_block(cfg, x, lp), [()], iters=3)
        finally:
            os.environ.pop("DI_MOE_GROUPED", None)
            if old is not None:
                os.environ["DI_MOE_GROUPED"] = old
    print(f"one MoE layer's experts at T={DECODE_BATCH}: grouped route "
          f"{route_ms['grouped']:.3f} ms, ragged route "
          f"{route_ms['ragged']:.3f} ms", flush=True)
    details["grouped_quant_matmul"] = dict(rows=rows, route_ms=route_ms)
    torch.cuda.empty_cache()
    # one layer of a bucket-32 prefill: gate and up (one shape) and down
    b32 = [r for r in rows if r["T"] == 32 and r["shape"] in ("gate", "down")]
    agg = aggregate(
        [dict(r, library_ms=r["library_ms"] or 0.0) for r in b32],
        [2 if r["shape"] == "gate" else 1 for r in b32])
    if any(r["library_ms"] is None for r in b32):
        agg["library_ms"] = None
    return dict(max_abs_err=max_err, shape="one layer of a bucket-32 "
                "prefill (gate + up + down, 128 routed rows)",
                route_ms=route_ms, **agg)


def paged_case(mode, gen, dev, cfg=None, B=DECODE_BATCH, maxP=32,
               lens=None, pool_dtype=None, nan_garbage=False):
    """B=8, H=28, KH=4 (or `cfg`'s heads), D=128, ps=64: ragged lens (incl.
    0 and non-multiples of the page), page tables shuffled over the pool,
    garbage past lens. With `nan_garbage`, every pool element (payload of a
    float pool, qparams) that no token < lens owns is NaN and the page-table
    entries past a slot's last page are out of range: the kernel must read
    none of it."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    if lens is None:
        lens = [0, 1, 63, 64, 65, 517, 1000, 2047]
    lens = torch.tensor(lens, dtype=torch.int32)
    P = B * maxP + 16
    cfg = cfg or ModelConfig(**QWEN2_7B)
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode), P,
                            pool_dtype or torch.bfloat16, dev)
    if mode == CacheMode.DEFAULT:
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    else:
        hi = 127 if mode == CacheMode.INT8 else 255
        lo = -128 if mode == CacheMode.INT8 else 0
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(lo, hi + 1, t.shape, generator=gen,
                                  device=dev).to(t.dtype))
        for t in (cache.k_qparams, cache.v_qparams):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * maxP]
    pt = perm.reshape(B, maxP).to(torch.int32)
    if nan_garbage:
        owned = torch.zeros((P, PAGE), dtype=torch.bool, device=dev)
        for b, n in enumerate(lens.tolist()):
            for j in range(-(-n // PAGE)):
                owned[pt[b, j], :min(PAGE, n - j * PAGE)] = True
        if mode == CacheMode.DEFAULT:
            for t in (cache.k, cache.v):
                t.masked_fill_(~owned[:, :, None], float("nan"))
        else:
            for t in (cache.k_qparams, cache.v_qparams):
                t[:, :, :PAGE].masked_fill_(~owned[:, None, :], float("nan"))
                t[:, :, PAGE:] = float("nan")     # the lanes' padding
        used = (torch.arange(maxP)[None, :] * PAGE <
                lens[:, None]).to(dev)
        pt = torch.where(used, pt, torch.tensor(0x3FFFFFFF, device=dev,
                                                dtype=torch.int32))
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev)
    return cache, pt, lens.to(dev), q, cfg


# paged_attention's coverage: (G, head_dim, pool kind) at KH = 4, every KV
# mode with the served bf16 q, the f32 pool with f32 q; D = 64 / 256 once
# each kind at G = 4; the other (q, pool) pairs the wrapper admits, which
# take the CUDA-core path (f32 q on a bf16 / int8 / uint4 pool, bf16 q on an
# f32 pool), at G = 7 and D = 128 and at G = 4 and D = 64 / 256; plus a
# batch whose (slot, head) pairs fill the card so that the sequence is one
# chunk (the kernel writes the output itself)
PA_COVER_G = (1, 2, 4, 7, 8)
PA_COVER_D = (64, 256)
PA_COVER_LENS = [0, 1, 63, 64, 65, 32 * PAGE, 777, 1500]   # 32 pages: full
PA_KINDS = ("f32", "bf16", "int8", "uint4")
PA_MIXED = (("bf16", "f32"), ("int8", "f32"), ("uint4", "f32"),
            ("f32", "bf16"))                    # (pool kind, q dtype)


def pa_cover_case(kind, G, D, gen, dev, B=DECODE_BATCH, KH=4, lens=None,
                  q_dtype=None):
    """One coverage case of paged_attention against its plain version, NaN
    garbage past lens and out-of-range page-table entries; q in `q_dtype`
    ("f32" or "bf16"; by default f32 on an f32 pool, else bf16). Returns
    max|d|."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import paged_attention as pa
    mode = {"f32": CacheMode.DEFAULT, "bf16": CacheMode.DEFAULT,
            "int8": CacheMode.INT8, "uint4": CacheMode.UINT4}[kind]
    f32 = kind == "f32"
    cfg = ModelConfig(**dict(QWEN2_7B, num_heads=KH * G, num_kv_heads=KH,
                             head_dim=D, hidden_size=KH * G * D))
    cache, pt, lens_t, q, _ = paged_case(
        mode, gen, dev, cfg, B=B, lens=lens or PA_COVER_LENS,
        pool_dtype=torch.float32 if f32 else torch.bfloat16,
        nan_garbage=True)
    q_dtype = q_dtype or ("f32" if f32 else "bf16")
    q = q if q_dtype == "f32" else q.to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    got = pa.paged_attention(q, cache, mode, pt, lens_t, scale)
    ref = pa.paged_attention_plain(q, cache, mode, pt, lens_t, scale)
    torch.cuda.synchronize()
    what = f"paged_attention {kind} ({q_dtype} q) G={G} D={D} B={B} KH={KH}"
    err = held_to_plain(got, ref, what)
    zero = lens_t == 0
    check(bool((got[zero] == 0).all()), f"{what}: lens 0 not 0")
    return err


def check_paged_attention(gen, dev, details):
    import torch
    import torch.nn.functional as F
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import kv_ops
    from dashinfer_tpu_torch.ops import paged_attention as pa

    def sdpa(qs, k, v, m):
        return F.scaled_dot_product_attention(qs, k, v, attn_mask=m,
                                              enable_gqa=True)

    def sdpa_args(qb, cache, mode, pt, lens, kv_heads, copies=1):
        """SDPA's operands on contiguous bf16 K/V gathered beforehand (`copies`
        distinct copies, timed in turn: together larger than the L2)."""
        k, v = kv_ops.gather_kv_pages(cache, mode, pt, kv_heads,
                                      torch.bfloat16)      # [B, S, KH, D]
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        S = k.shape[2]
        mask = (torch.arange(S, device=dev)[None, :] <
                lens[:, None])[:, None, None, :]
        out = [(qb[:, :, None, :], k, v, mask)]
        out += [(qb[:, :, None, :], k.clone(), v.clone(), mask)
                for _ in range(copies - 1)]
        return out

    rows, max_err = [], 0.0
    for mode in (CacheMode.DEFAULT, CacheMode.INT8, CacheMode.UINT4):
        cache, pt, lens, q, cfg = paged_case(mode, gen, dev)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        qb = q.to(torch.bfloat16)          # the served path's q and output
        got = pa.paged_attention(qb, cache, mode, pt, lens, scale)
        ref = pa.paged_attention_plain(qb, cache, mode, pt, lens, scale)
        torch.cuda.synchronize()
        err = held_to_plain(got, ref, f"paged_attention {mode.value}")
        scale_ref = ref.float().abs().max().item()
        check(bool((got[0] == 0).all()), "paged_attention: lens 0 not 0")
        max_err = max(max_err, err)
        ms = time_ms(pa.paged_attention,
                     [(qb, cache, mode, pt, lens, scale)], iters=50)
        plain_ms = time_ms(pa.paged_attention_plain,
                           [(qb, cache, mode, pt, lens, scale)], iters=3)
        # yardstick: SDPA over contiguous bf16 K/V of the same lengths
        library_ms = time_ms(sdpa, sdpa_args(qb, cache, mode, pt, lens,
                                             cfg.num_kv_heads), iters=50)
        ntok = int(lens.sum().item())
        KH, D, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
        per_tok = {CacheMode.DEFAULT: 2 * D, CacheMode.INT8: D + 8,
                   CacheMode.UINT4: D // 2 + 8}[mode]
        nbytes = (2 * ntok * KH * per_tok + 2 * qb.numel() * 2 +
                  pt.numel() * 4 + lens.numel() * 4)
        row = dict(mode=mode.value, B=q.shape[0], H=H, KH=KH, D=D, ps=PAGE,
                   lens=lens.tolist(), max_abs_err=err, ref_max=scale_ref,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   **bounds(nbytes, 4.0 * ntok * H * D))
        rows.append(row)
        print(f"paged_attention {mode.value:7s} err={err:.2e} ms={ms:.4f} "
              f"bound={row['bytes_ms']:.4f} plain={plain_ms:.3f} "
              f"lib={library_ms:.4f}", flush=True)
    # one query head a KV head (Qwen1.5-MoE's 16 on 16), INT8 as served
    cache, pt, lens, q, mcfg = paged_case(CacheMode.INT8, gen, dev,
                                          moe_config())
    qb = q.to(torch.bfloat16)
    got = pa.paged_attention(qb, cache, CacheMode.INT8, pt, lens, scale)
    ref = pa.paged_attention_plain(qb, cache, CacheMode.INT8, pt, lens, scale)
    torch.cuda.synchronize()
    err = held_to_plain(got, ref, "paged_attention int8 G=1")
    max_err = max(max_err, err)
    ms = time_ms(pa.paged_attention,
                 [(qb, cache, CacheMode.INT8, pt, lens, scale)], iters=50)
    library_ms = time_ms(sdpa, sdpa_args(qb, cache, CacheMode.INT8, pt, lens,
                                         mcfg.num_kv_heads), iters=50)
    rows.append(dict(mode="int8", H=mcfg.num_heads, KH=mcfg.num_kv_heads,
                     max_abs_err=err, ms=ms, library_ms=library_ms))
    print(f"paged_attention int8 G=1 (16 heads on 16) err={err:.2e} "
          f"ms={ms:.4f} lib={library_ms:.4f}", flush=True)
    del cache
    # coverage: every G the wrapper admits at D = 128, D = 64 / 256, every
    # pool kind, lens 0 / 1 / a page boundary +-1 / a full table, NaN
    # garbage past lens, out-of-range page-table entries
    cover = []
    for kind in PA_KINDS:
        for G in PA_COVER_G:
            cover.append((kind, G, 128, DECODE_BATCH, 4, None))
        for D in PA_COVER_D:
            cover.append((kind, 4, D, DECODE_BATCH, 4, None))
    for kind, q_dtype in PA_MIXED:
        cover.append((kind, 7, 128, DECODE_BATCH, 4, q_dtype))
        for D in PA_COVER_D:
            cover.append((kind, 4, D, DECODE_BATCH, 4, q_dtype))
    cover.append(("int8", 1, 128, 40, 16, None))    # one chunk: 640 blocks
    for kind, G, D, B, KH, q_dtype in cover:
        err = pa_cover_case(kind, G, D, gen, dev, B=B, KH=KH,
                            lens=None if B == DECODE_BATCH else
                            [(0, 1, 63, 64, 65, 2048, 300, 900)[i % 8]
                             for i in range(B)], q_dtype=q_dtype)
        max_err = max(max_err, err)
    print(f"paged_attention coverage: {len(cover)} cases held (G "
          f"{PA_COVER_G} at D=128, D {PA_COVER_D}, kinds {PA_KINDS}, the "
          f"(pool, q) pairs {PA_MIXED}, one single-chunk batch), max|d| "
          f"{max_err:.2e}", flush=True)
    torch.cuda.empty_cache()
    # the long-context state (28 layers' pages of one INT8 pool, larger than
    # the 50 MB L2): one launch a layer in turn (cold) and layer 0 again and
    # again (L2-warm), at B = 8 and B = 32, beside SDPA on contiguous bf16
    # K/V gathered beforehand, cold (distinct copies, together over 50 MB)
    # and warm (one copy)
    big = []
    mode = CacheMode.INT8
    L = cfg.num_layers
    for B in (DECODE_BATCH, 32):
        long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016] * (B // 8)
        st = mk_state(cfg, mode, B, long_lens, None, gen, dev)
        qb = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                         device=dev).to(torch.bfloat16)
        per_layer = [(qb, st["cache"], mode,
                      (st["pt"] * L + l).to(torch.int32), st["lens"], scale)
                     for l in range(L)]
        got = pa.paged_attention(*per_layer[3])
        ref = pa.paged_attention_plain(*per_layer[3])
        torch.cuda.synchronize()
        err = held_to_plain(got, ref, f"paged_attention long context B={B}")
        max_err = max(max_err, err)
        cold_ms = time_ms(pa.paged_attention, per_layer, iters=L)
        warm_ms = time_ms(pa.paged_attention, per_layer[:1], iters=L)
        lib = sdpa_args(qb, st["cache"], mode, per_layer[0][3], st["lens"],
                        cfg.num_kv_heads)
        kv_mb = sum(t.numel() * t.element_size() for t in lib[0][1:3]) / 1e6
        lib_copies = lib + [(a, k.clone(), v.clone(), m) for a, k, v, m in
                            lib * (max(2, math.ceil(160 / kv_mb)) - 1)]
        lib_cold = time_ms(sdpa, lib_copies, iters=len(lib_copies))
        lib_warm = time_ms(sdpa, lib, iters=L)
        del lib, lib_copies
        nbytes = kv_bytes_read(cfg, mode, long_lens, [1] * B) // L \
            + 2 * qb.numel() * 2
        pool_mb = sum(t.numel() * t.element_size() for t in
                      (st["cache"].k, st["cache"].v, st["cache"].k_qparams,
                       st["cache"].v_qparams)) / 1e6
        row = dict(mode="int8", B=B, lens=long_lens, pool_mb=pool_mb,
                   max_abs_err=err, cold_ms=cold_ms, warm_ms=warm_ms,
                   library_cold_ms=lib_cold, library_warm_ms=lib_warm,
                   library_kv_mb=kv_mb,
                   **bounds(nbytes, 4.0 * sum(long_lens) * cfg.num_heads *
                            cfg.head_dim))
        big.append(row)
        print(f"paged_attention int8 B={B} on a {pool_mb:.0f} MB pool, "
              f"{sum(long_lens)} cached tokens: cold {cold_ms:.4f} "
              f"ms/launch, L2-warm {warm_ms:.4f}, bound "
              f"{row['bytes_ms']:.4f}; SDPA cold {lib_cold:.4f}, warm "
              f"{lib_warm:.4f} ({kv_mb:.0f} MB of bf16 K/V a copy); "
              f"err={err:.2e}", flush=True)
        del st, per_layer
        torch.cuda.empty_cache()
    details["paged_attention"] = rows
    details["paged_attention_large_pool"] = big
    # the served model's INT8 cache: one launch per layer per decode step
    int8 = next(r for r in rows if r["mode"] == "int8" and r["KH"] == 4)
    return dict(max_abs_err=max_err,
                **aggregate([int8], [QWEN2_7B["num_layers"]]))


# -- phase 3: the slice end to end ------------------------------------------

def random_qwen2_7b_params(seed: int, dev, stream: str = "u4"):
    """Random a16w4 group-128 weights (the distribution of bench.py's
    build_qwen2_7b_params(quantize_lm=True)), made on the card; with
    stream="i8", per-channel int8 leaves as the u4 -> i8 rule makes them."""
    from dashinfer_tpu_torch.config import ModelConfig
    from dashinfer_tpu_torch.tools import bench_stream
    return bench_stream.random_a16w4_params(ModelConfig(**QWEN2_7B), seed,
                                            dev, GROUP, stream)


def moe_config(layers: int = None):
    from dashinfer_tpu_torch.config import ModelConfig, MoEConfig
    kw = dict(QWEN15_MOE)
    if layers:
        kw["num_layers"] = layers
    return ModelConfig(**kw, moe=MoEConfig(**QWEN15_MOE_EXPERTS))


def random_moe_params(cfg, seed: int, dev):
    """Random a16w4 group-128 weights at a MoE model's width (the
    distribution of bench.py's build_qwen15_moe_params: u4 levels uniform,
    scale in [1e-4, 2.1e-3), zero = -8 scale; an f32 router and shared-expert
    gate of std 0.05), made on the card, with the expert stacks re-laid out
    (Qwen1.5-MoE's 1408 columns padded) as the install does
    (`prepare_grouped_experts`). A shared expert and its gate, and zero
    q|k|v biases, where the config has them; a QK-norm model's q_norm /
    k_norm (`bench_stream.qk_norm_weights`) drawn after the rest."""
    import torch
    from dashinfer_tpu_torch.ops.grouped_quant_matmul import \
        prepare_grouped_experts
    from dashinfer_tpu_torch.tools.bench_stream import qk_norm_weights
    L, D, hid, V = (cfg.num_layers, cfg.head_dim, cfg.hidden_size,
                    cfg.vocab_size)
    H, KH, moe = cfg.num_heads, cfg.num_kv_heads, cfg.moe
    E, Im, sIm = (moe.num_experts, moe.moe_intermediate_size,
                  moe.shared_expert_intermediate_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(kin, kout, lead=(L,), bias=False):
        scale = torch.rand(lead + (kin // GROUP, kout), generator=gen,
                           device=dev) * 0.002 + 1e-4
        d = {"w_q": torch.randint(0, 256, lead + (kin, kout // 2),
                                  dtype=torch.uint8, generator=gen,
                                  device=dev),
             "scale": scale, "zero": -scale * 8.0}
        if bias:
            d["b"] = torch.zeros(lead + (kout,), dtype=torch.bfloat16,
                                 device=dev)
        return d

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    bias = cfg.qkv_bias
    params = {
        "embed_tokens": {"w": randn(V, hid, std=0.02).to(torch.bfloat16)},
        "norm": ones(hid),
        "lm_head": qlin(hid, V, lead=()),
        "layers": {
            "input_layernorm": ones(L, hid),
            "post_attention_layernorm": ones(L, hid),
            "q_proj": qlin(hid, H * D, bias=bias),
            "k_proj": qlin(hid, KH * D, bias=bias),
            "v_proj": qlin(hid, KH * D, bias=bias),
            "o_proj": qlin(H * D, hid),
            "router": {"w": randn(L, hid, E, std=0.05)},
            "experts": {"gate_proj": qlin(hid, Im, (L, E)),
                        "up_proj": qlin(hid, Im, (L, E)),
                        "down_proj": qlin(Im, hid, (L, E))},
        },
    }
    if sIm:
        params["layers"].update(
            shared_expert={"gate_proj": qlin(hid, sIm),
                           "up_proj": qlin(hid, sIm),
                           "down_proj": qlin(sIm, hid)},
            shared_expert_gate={"w": randn(L, hid, 1, std=0.05)})
    if cfg.qk_norm:
        params["layers"].update(qk_norm_weights(L, D, gen, dev))
    return prepare_grouped_experts(params, cfg)


def planted_router_fault(plan, logits_plain, rows, what, budget, seed,
                         ill=None):
    """The routing of a faulty router (the plain version's logits, a list
    of [R, EP], plus PLANTED_ROUTER_ERR of noise) against the plain
    version's: it must fail the flip caps (count or gap; `ill` as
    flipped_rows'). Returns its flipped-row count."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    gen = torch.Generator(device=logits_plain[0].device)
    gen.manual_seed(seed)
    chosen = torch.stack([
        mk.route(plan, lg + PLANTED_ROUTER_ERR * torch.randn(
            lg.shape, generator=gen, device=lg.device))[0] > 0
        for lg in logits_plain])
    flips = flipped_rows(plan, chosen, logits_plain, rows, what)
    check(len(flips) > budget or any(
        g > TIE_LOGIT and not (ill is not None and bool(ill[l, r]))
        for r, l, g in flips),
          f"{what}: a planted router fault (logit noise "
          f"{PLANTED_ROUTER_ERR}) passes the flip caps ({len(flips)} rows, "
          f"at most {budget}): the caps do not tell it from the kernel")
    return len(flips)


def flipped_rows(plan, chosen_kernel, logits_plain, rows, what,
                 budget=None, chosen_ref=None, ill=None):
    """Rows (of `rows`, a bool mask) whose routed experts differ between
    the kernel (chosen_kernel [L, R, E] bool) and the plain version (its
    router products, a list of [R, EP]; or `chosen_ref`, another kernel's
    choices) in some layer, held to the MoE rules above (not held without
    a `budget`): at most `budget` rows, each a near-tie of the plain
    version where it first flips, or ill-conditioned there (`ill` [L, R]
    bool: its residual RMS entering the layer below ILL_NORM_SHARE of the
    batch's median, forced_routing_check's rule). Returns [(row, first
    layer, the plain version's logit gap there)]."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    logits = torch.stack(logits_plain)[..., :plan.E]             # [L, R, E]
    chosen_plain = chosen_ref if chosen_ref is not None else torch.stack(
        [mk.route(plan, lg)[0] > 0 for lg in logits_plain])
    diff = (chosen_kernel != chosen_plain).any(-1) & rows[None, :]   # [L, R]
    top = logits.topk(plan.k_top + 1, dim=-1).values
    gap = top[..., plan.k_top - 1] - top[..., plan.k_top]           # [L, R]
    flips = []
    for r in torch.nonzero(diff.any(0))[:, 0].tolist():
        l = int(torch.nonzero(diff[:, r])[0, 0])
        flips.append((r, l, round(float(gap[l, r]), 6)))
    check(budget is None or (len(flips) <= budget and all(
        g <= TIE_LOGIT or (ill is not None and bool(ill[l, r]))
        for r, l, g in flips)),
          f"{what}: {len(flips)} rows routed differently (at most {budget}, "
          f"each a near-tie of the plain version within {TIE_LOGIT} or "
          f"ill-conditioned there): (row, first layer, logit gap) {flips}"
          + ("" if ill is None else
             f"; ill-conditioned at that layer "
             f"{[bool(ill[l, r]) for r, l, _ in flips]}"))
    return flips


PROMPT_LENS = [20, 90, 200, 450, 700, 1000]   # buckets 32 .. 1024


def model_name(cfg) -> str:
    """The served model's name in the serving lines and details."""
    return {"qwen2": "qwen2-7b", "qwen2_moe": "qwen1.5-moe",
            "qwen3": "qwen3-8b", "qwen3_moe": "qwen3-30b-a3b",
            "baichuan": "baichuan2-13b"}[cfg.arch]


def serve(params, dev, details, path: str, new_tokens: int, cfg=None,
          devices=None, n_steps: int = 1, together: bool = False,
          tokenizer=None, extra=None):
    """Six concurrent requests through `Engine`: path "megakernel" (every
    flag at its default: decode and qualifying prefills through the two
    megakernels), "per-op" (`enable_megakernel` off) or "pack_only"
    (`weight_residency="pack_only"`; `params` is then a callable that makes
    the tree, so that the engine alone holds it) or "megakernel prefill
    per-op" (DI_PREFILL_MEGAKERNEL=0: the decode megakernel, every prefill
    per-op); on a (1, n) mesh over `devices`, "tp" (every flag at its
    default: decode through the TP segments, the prefills of buckets 128 ..
    1024 through the TP prefill segments (a MoE model's per-op TP), the
    others per-op TP), "tp prefill per-op" (DI_PREFILL_MEGAKERNEL=0: every
    prefill per-op TP, as before the TP prefill segments) or "tp per-op".
    `cfg`: Qwen2-7B unless given (the MoE model). `n_steps`:
    decode_steps_per_launch (windows of n_steps decode steps in one CUDA
    graph; their launch counts and captures are checked, and the warm-up
    request runs one window, so that its capture is set-up). `together`:
    every prefill admitted in one tick of the loop (max_prefills_per_tick
    0, the loop held while the six requests are started), before any
    decode step, so that every decode step sees the same batch whatever
    n_steps is. `tokenizer`: the engine's (guided decoding). `extra`:
    fn(eng, run, name, prompts, tokens) called after the timed requests,
    on the same engine. Returns (launch counts of the timed requests,
    generated tokens per request, memory); the details entry also holds
    the runtime's window / single-step counts and the windows'
    captures."""
    import torch
    from dashinfer_tpu_torch import (CacheMode, Engine, GenerateRequestStatus,
                                     GenerationConfig, ModelConfig,
                                     RuntimeConfigBuilder)
    from dashinfer_tpu_torch.engine.model_runtime import _resident_bytes
    from dashinfer_tpu_torch.ops import grouped_quant_matmul as gqm
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import paged_attention as pa
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    megakernel = path not in ("per-op", "tp per-op")
    counters = {"quant_matmul": qm.quant_matmul.counter,
                "paged_attention": pa.paged_attention.counter,
                "decode_megakernel": mk.decode_megakernel.counter,
                "prefill_megakernel": pmk.prefill_megakernel.counter,
                "grouped_quant_matmul": gqm.grouped_quant_matmul.counter,
                "tp_attn_segment": tpk.tp_attn_segment.counter,
                "tp_mlp_segment": tpk.tp_mlp_segment.counter,
                "tp_moe_segment": tpk.tp_moe_segment.counter,
                "tp_lm_segment": tpk.tp_lm_segment.counter,
                "tp_prefill_attn_segment":
                    tpk.tp_prefill_attn_segment.counter,
                "tp_prefill_mlp_segment": tpk.tp_prefill_mlp_segment.counter,
                "tp_prefill_lm_segment": tpk.tp_prefill_lm_segment.counter}
    cfg = cfg or ModelConfig(**QWEN2_7B)
    name = model_name(cfg)
    label = f"{name} {path}"
    b = (RuntimeConfigBuilder(name).max_length(2048)
         .max_batch(DECODE_BATCH).kv_cache_page_size(PAGE)
         .kv_cache_mode(CacheMode.INT8).dtype("bfloat16"))
    if not megakernel:
        b = b.update({"enable_megakernel": False})
    if path == "pack_only":
        b = b.update({"weight_residency": "pack_only"})
    if devices:
        b = b.mesh(1, len(devices))
    if n_steps > 1:
        b = b.update({"decode_steps_per_launch": n_steps})
    if together:
        b = b.update({"max_prefills_per_tick": 0})
    rt = b.build()
    check(rt.enable_megakernel == megakernel, "enable_megakernel default")
    if n_steps > 1:
        label += f" x{n_steps}"
    torch.cuda.synchronize()
    pmk.release_scratch(dev)    # what the kernel checks left: the install
    torch.cuda.empty_cache()    # reserves its own, before it plans the pool
    mem0 = torch.cuda.memory_allocated(dev)
    if callable(params):
        params = params()
    mem_tree = torch.cuda.memory_allocated(dev) - mem0
    prefill_off = path in ("tp prefill per-op", "megakernel prefill per-op")
    if prefill_off:
        os.environ["DI_PREFILL_MEGAKERNEL"] = "0"
    try:
        eng = Engine().install_model(name, rt, params=params,
                                     model_config=cfg, device=devices or dev,
                                     tokenizer=tokenizer)
    finally:
        os.environ.pop("DI_PREFILL_MEGAKERNEL", None)
    del params
    run = eng._models[name]
    caches = run.cache if devices else [run.cache]
    memory = dict(
        residency=run.residency, tree_bytes=mem_tree,
        installed_bytes=torch.cuda.memory_allocated(dev) - mem0,
        weights_resident_bytes=_resident_bytes(run.params, run.mega_params),
        weights_by_device={str(d): _resident_bytes(
            run.params, run.mega_params, device=d)
            for d in dict.fromkeys(devices or [dev])},
        pack_bytes=_resident_bytes(run.mega_params),
        pool_bytes=_resident_bytes(*(vars(c) for c in caches)),
        prefill_scratch_bytes=pmk.scratch_bytes(dev),
        logical_pages=run.num_logical_pages)
    # the TP prefill segments take no MoE model (their MLP is dense)
    tp_buckets = [b for b in (128, 256, 512, 1024)
                  if megakernel and not prefill_off and not cfg.moe]
    if devices:
        check((run.tp_mega_plan is not None) == megakernel and
              run.mega_plan is None and not run._pmk_plans and
              sorted(run._tp_pmk_plans) == tp_buckets,
              f"{label}: the mesh install took the wrong decode or prefill "
              f"path (TP prefill buckets {sorted(run._tp_pmk_plans)})")
    # one scratch set, sized for the largest bucket, is on the card from the
    # install on (none on the per-op paths)
    prefill_kernels = bool(tp_buckets) if devices else \
        (megakernel and not prefill_off)
    check((memory["prefill_scratch_bytes"] > 0) == prefill_kernels,
          f"{path}: prefill scratch after install: "
          f"{memory['prefill_scratch_bytes']} bytes")
    eng.start_model(name)
    g = torch.Generator().manual_seed(7)
    try:
        if path == "pack_only":
            # refused at start_request, with the reference's message
            try:
                eng.start_request(name, [1] * 1025, GenerationConfig(
                    max_length=1030, do_sample=False, top_k=1, eos_token_id=-1))
                refused = ""
            except ValueError as e:
                refused = str(e)
            check(refused == "prompt length 1025 exceeds the prefill megakernel "
                  "coverage (1024 tokens) under weight_residency=pack_only",
                  f"pack_only: a 1025-token prompt gave {refused!r}")
        # warm-up request: the process's first use of each PyTorch kernel
        # and the capture of the decode graph are set-up, not serving
        _, h, _ = eng.start_request(
            name, torch.randint(1, cfg.vocab_size, (20,),
                                generator=g).tolist(),
            GenerationConfig(max_length=20 + max(4, n_steps),
                             do_sample=False, top_k=1, eos_token_id=-1))
        eng.sync_request(name, h, timeout_s=600)
        # the kernels count their own launches on the card (CUDA graph
        # replays of the decode forward included)
        for c in counters.values():
            c.reset()
        dl0 = dict(run.decode_launches)
        t0 = time.monotonic()
        handles, prompts = [], []
        with held_loop(eng, name, together):
            for i, n in enumerate(PROMPT_LENS):
                ids = torch.randint(1, cfg.vocab_size, (n,),
                                    generator=g).tolist()
                gc = GenerationConfig(max_length=n + new_tokens,
                                      do_sample=bool(i % 2), top_k=20,
                                      temperature=0.8, seed=1000 + i,
                                      eos_token_id=-1)
                _, h, q = eng.start_request(name, ids, gc)
                handles.append((h, q, gc.do_sample))
                prompts.append(ids)
        for h, _, _ in handles:
            eng.sync_request(name, h, timeout_s=600)
        wall = time.monotonic() - t0
        launches = {k: c.read() for k, c in counters.items()}
        decode_launches = {k: v - dl0[k]
                           for k, v in run.decode_launches.items()}
        captures = {str(k): f.window.captures
                    for k, f in run._decode_steps.items()
                    if hasattr(f, "window")}
        if extra is not None:
            extra(eng, run, name, prompts,
                  [q.GetAllGeneratedTokens() for _, q, _ in handles])
    finally:
        eng.release_model(name)
    check(pmk.scratch_bytes(dev) == 0,
          f"{path}: release_model left {pmk.scratch_bytes(dev)} bytes of "
          "prefill scratch on the card")
    reqs, tokens = [], []
    for (h, q, sampled), n in zip(handles, PROMPT_LENS):
        toks = q.GetAllGeneratedTokens()
        tokens.append(list(toks))
        st = q.RequestStatInfo()
        status = q.GenerateStatus()
        reqs.append(dict(prompt_len=n, sampled=sampled, status=status.value,
                         n_tokens=len(toks),
                         ttft_ms=1e3 * st["time_to_first_token"],
                         decode_ms_per_step=(1e3 / st["generate_tps"]
                                             if st["generate_tps"] else None)))
        check(status == GenerateRequestStatus.GenerateFinished,
              f"{path}: request (prompt {n}) ended {status.value}")
        check(len(toks) == new_tokens and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"{path}: request (prompt {n}): {len(toks)} tokens")
    # a per-op prefill runs quant_matmul on its lm_head row (when the vocab
    # fills the kernel's 256-column tiles: Qwen1.5's 151936 does not, and
    # its lm_head takes the large-M formulation, as in the JAX package),
    # and on every projection when its bucket fits the kernel (M <= 32): q,
    # k, v, o and the MLP's (a MoE model's shared expert's, where it has
    # one: Qwen3-MoE has none) three; a MoE
    # layer runs the grouped kernel three times (gate, up, down) in every
    # per-op prefill and decode step; a prefill whose bucket is 128 .. 1024
    # is one prefill megakernel launch on the megakernel path, and under
    # pack_only every prefill is (the 20-token prompt snaps to bucket 128)
    # (a product takes quant_matmul where its output width, the rank's, is
    # a multiple of 256, `ops.linear.use_fused_gemv`: Baichuan2-13B's
    # gate and up, 13696 columns, take the large-M formulation)
    L = cfg.num_layers
    n_r = len(devices) if devices else 1

    def fits(n):
        return int((n // n_r) % 256 == 0)
    lm = fits(cfg.vocab_size)
    attn_products = fits(cfg.num_heads * cfg.head_dim) + \
        2 * fits(cfg.num_kv_heads * cfg.head_dim) + \
        int(cfg.hidden_size % 256 == 0)
    inter = cfg.moe.shared_expert_intermediate_size if cfg.moe else \
        cfg.intermediate_size
    mlp_products = 2 * fits(inter) + int(cfg.hidden_size % 256 == 0) \
        if inter else 0
    per_step = (attn_products + mlp_products) * L + lm
    grouped = 3 * L if cfg.moe else 0
    if path == "pack_only":
        mega_prefills, prefill = len(PROMPT_LENS), 0
    elif megakernel and not prefill_off:
        mega_prefills = sum(64 < n <= 1024 for n in PROMPT_LENS)
        prefill = sum(per_step if n <= 32 else lm for n in PROMPT_LENS
                      if not 64 < n <= 1024)
    else:
        mega_prefills = 0
        prefill = sum(per_step if n <= 32 else lm for n in PROMPT_LENS)
    per_op_prefills = len(PROMPT_LENS) - mega_prefills
    if megakernel and not devices:
        # one megakernel launch is one decode step; nothing else of a step
        # reaches the per-op kernels
        steps = launches["decode_megakernel"]
        check(steps >= new_tokens - 1 and launches["paged_attention"] == 0
              and launches["quant_matmul"] == prefill
              and launches["prefill_megakernel"] == mega_prefills
              and launches["grouped_quant_matmul"] ==
              grouped * per_op_prefills,
              f"{label} path: launch counts {launches} do not match "
              f"{steps} decode steps, {mega_prefills} prefill megakernel "
              f"launches and the other prefills' {prefill} quant_matmul "
              f"and {grouped * per_op_prefills} grouped_quant_matmul "
              "launches")
    elif not devices:
        # every decode step runs quant_matmul for the 7 projections of each
        # layer and the lm_head, and paged_attention once per layer (an
        # ALiBi model's never: its decode attention is the plain version,
        # as in the JAX package)
        alibi = cfg.position_embedding.value == "alibi"
        steps = (launches["quant_matmul"] - prefill) // per_step if alibi \
            else launches["paged_attention"] // L
        check(launches["paged_attention"] == (0 if alibi else L) * steps
              and steps >= new_tokens - 1
              and launches["quant_matmul"] == per_step * steps + prefill
              and launches["grouped_quant_matmul"] ==
              grouped * (steps + len(PROMPT_LENS))
              and launches["decode_megakernel"] == 0
              and launches["prefill_megakernel"] == 0,
              f"{label} path: launch counts {launches} do not match {steps} "
              f"decode steps and {len(PROMPT_LENS)} prefills")
    if devices:
        # a per-op TP prefill runs every rank's projections as a
        # single-device prefill does (at the rank's widths); a prefill of a
        # bucket 128 .. 1024 through the TP prefill segments runs every
        # rank's attn and mlp segments a layer and its lm segment; a decode
        # step runs every rank's two segments a layer and its lm segment,
        # or per-op every rank's kernels of a single-device step
        seg_prefills = sum(64 < n <= 1024 for n in PROMPT_LENS) \
            if tp_buckets else 0
        prefill = n_r * sum(per_step if n <= 32 else lm for n in PROMPT_LENS
                            if not (tp_buckets and 64 < n <= 1024))
        # (a MoE model: its moe segment in place of the mlp one, and every
        # rank's grouped GEMMs in each per-op TP prefill and step)
        mlp_seg = "tp_moe_segment" if cfg.moe else "tp_mlp_segment"
        op_prefills = len(PROMPT_LENS) - seg_prefills
        if megakernel:
            steps = launches["tp_lm_segment"] // n_r
            expect = {"tp_attn_segment": L * n_r * steps,
                      mlp_seg: L * n_r * steps,
                      "tp_lm_segment": n_r * steps, "quant_matmul": prefill,
                      "tp_prefill_attn_segment": L * n_r * seg_prefills,
                      "tp_prefill_mlp_segment": L * n_r * seg_prefills,
                      "tp_prefill_lm_segment": n_r * seg_prefills,
                      "grouped_quant_matmul": grouped * n_r * op_prefills}
        else:
            steps = launches["paged_attention"] // (L * n_r)
            expect = dict(paged_attention=L * n_r * steps,
                          quant_matmul=n_r * per_step * steps + prefill,
                          grouped_quant_matmul=grouped * n_r * (
                              steps + len(PROMPT_LENS)))
        # and no other kernel runs
        check(steps >= new_tokens - 1 and
              {k: v for k, v in launches.items() if v} ==
              {k: v for k, v in expect.items() if v},
              f"{label} path: launch counts {launches} do not match {steps} "
              f"decode steps over {n_r} ranks, {seg_prefills} prefills "
              f"through the TP prefill segments and "
              f"{len(PROMPT_LENS) - seg_prefills} per-op TP prefills "
              f"({expect})")
    if n_steps > 1:
        # a window launches the path's decode kernels n_steps times, in one
        # CUDA graph captured once (in the warm-up request's window)
        check(decode_launches["multi"] > 0 and
              steps == n_steps * decode_launches["multi"] +
              decode_launches["single"] and
              list(captures.values()) == [1],
              f"{label}: {steps} decode steps by the kernels' counts, "
              f"windows / single steps {decode_launches}, window graph "
              f"captures {captures}")
    else:
        check(decode_launches == {"multi": 0, "single": steps},
              f"{label}: {steps} decode steps by the kernels' counts, "
              f"windows / single steps {decode_launches}")
    key = f"serving_{name}_{path}" + (f"_x{n_steps}" if n_steps > 1
                                      else "") + \
        ("_together" if together else "")
    details[key] = dict(
        requests=reqs, launches=launches, wall_s=wall, decode_steps=steps,
        memory=memory, decode_launches=decode_launches, captures=captures)
    for r in reqs:
        print(f"{label} request prompt={r['prompt_len']:4d} "
              f"{'top-k' if r['sampled'] else 'greedy':6s} {r['status']} "
              f"tokens={r['n_tokens']} ttft_ms={r['ttft_ms']:.1f} "
              f"decode_ms/step={r['decode_ms_per_step']:.2f}", flush=True)
    print(f"{label}: served {len(reqs)} requests in {wall:.2f} s, {steps} "
          f"decode steps; launches {launches}", flush=True)
    gib = 1024 ** 3
    print(f"{label}: weight residency {memory['residency']}: weights on the "
          f"card {memory['weights_resident_bytes'] / gib:.2f} GiB (the "
          f"megakernels' {memory['pack_bytes'] / gib:.2f}), pool "
          f"{memory['pool_bytes'] / gib:.2f} GiB "
          f"({memory['logical_pages']} logical pages), prefill scratch "
          f"{memory['prefill_scratch_bytes'] / gib:.2f} GiB", flush=True)
    return launches, tokens, memory


class held_loop:
    """With `hold`, the model's scheduler loop waits (on a control message)
    while the block starts requests, so that its next tick finds them all
    pending."""

    def __init__(self, eng, name, hold: bool):
        import threading
        self.loop = eng._loops[name] if hold else None
        self.go = threading.Event()
        self.waiting = threading.Event()

    def __enter__(self):
        if self.loop is not None:
            def wait():
                self.waiting.set()
                self.go.wait(60)
            self.loop.submit(wait)
            check(self.waiting.wait(60), "the scheduler loop did not stop")
        return self

    def __exit__(self, *exc):
        self.go.set()
        return False


def agree_first(a_tokens, b_tokens, what, need=8):
    """The greedy requests' (even ones') first tokens: equal on at least
    `need`; returns how many agree, by request."""
    agree = []
    for i, (a, b) in enumerate(zip(a_tokens, b_tokens)):
        if i % 2:
            continue                # sampled
        n = min(len(a), len(b))
        same = next((j for j in range(n) if a[j] != b[j]), n)
        agree.append(same)
        print(f"greedy request prompt={PROMPT_LENS[i]}: {what} agree on the "
              f"first {same} of {n} tokens compared", flush=True)
        check(same >= need, f"greedy request (prompt {PROMPT_LENS[i]}): "
              f"{what} agree on only {same} tokens")
    return agree


def check_serving(params, dev, details):
    """The three serving paths on the same weights; the greedy requests'
    first 8 tokens must agree with the per-op path's (the paths round
    differently by design: the decode megakernel attends the new token
    unquantized, the prefill megakernel attends the prompt's exact K/V)."""
    import torch
    mk_launches, mk_tokens, mk_mem = serve(params, dev, details,
                                           "megakernel", 64)
    op_launches, op_tokens, _ = serve(params, dev, details, "per-op", 64)
    # the same weights again from the same seed, held by the engine alone,
    # so that what pack_only demotes really leaves the card
    po_launches, po_tokens, po_mem = serve(
        lambda: random_qwen2_7b_params(SEED, dev), dev, details, "pack_only",
        24)
    details["greedy_agreement"] = {
        path: agree_first(toks, op_tokens, f"{path} and per-op paths")
        for path, toks in (("megakernel", mk_tokens),
                           ("pack_only", po_tokens))}
    # pack_only: what the install left allocated on the card is the weights
    # it kept and the pool, lower than under `both` (same weights, same
    # pool) by the demoted payloads
    demoted = mk_mem["weights_resident_bytes"] - \
        po_mem["weights_resident_bytes"]
    slack = 64 * 1024 ** 2
    check(demoted > 0.4 * po_mem["tree_bytes"] and
          po_mem["pool_bytes"] == mk_mem["pool_bytes"] and
          po_mem["installed_bytes"] <= po_mem["weights_resident_bytes"] +
          po_mem["pool_bytes"] + po_mem["prefill_scratch_bytes"] + slack,
          f"pack_only did not free the raw payloads: {po_mem} vs {mk_mem}")
    print(f"pack_only: {demoted / 1024**3:.2f} GiB of raw payloads demoted "
          f"to the host; {po_mem['installed_bytes'] / 1024**3:.2f} GiB "
          "allocated on the card after install (weights kept + pool + "
          "prefill scratch), "
          f"against "
          f"{(po_mem['installed_bytes'] + demoted) / 1024**3:.2f} with both "
          "resident", flush=True)
    torch.cuda.empty_cache()
    return (mk_launches, op_launches, po_launches,
            {"megakernel": mk_tokens, "per-op": op_tokens})


def check_serving_moe(params, cfg, dev, details, prefill_per_op=False):
    """The MoE model served with every flag at its default and on the per-op
    path, on the same weights; the greedy requests' agreement is printed
    (the paths route with different sums, so a near-tie may route a token
    differently: only the launch counts and the finished requests are
    held). With `prefill_per_op`, also with DI_PREFILL_MEGAKERNEL=0 (the
    single-device serving that the MoE mesh serving is held to). Returns
    the launches of the first two and the tokens of each path."""
    import torch
    mk_launches, mk_tokens, _ = serve(params, dev, details, "megakernel",
                                      64, cfg)
    op_launches, op_tokens, _ = serve(params, dev, details, "per-op", 64,
                                      cfg)
    tokens = {"megakernel": mk_tokens, "per-op": op_tokens}
    if prefill_per_op:
        tokens["megakernel prefill per-op"] = serve(
            params, dev, details, "megakernel prefill per-op", 64, cfg)[1]
    agree = []
    for i, (a, b) in enumerate(zip(mk_tokens, op_tokens)):
        if i % 2:
            continue
        n = min(len(a), len(b))
        agree.append(next((j for j in range(n) if a[j] != b[j]), n))
        print(f"MoE greedy request prompt={PROMPT_LENS[i]}: megakernel and "
              f"per-op paths agree on the first {agree[-1]} of {n} tokens",
              flush=True)
    details["moe_greedy_agreement"] = agree
    torch.cuda.empty_cache()
    return mk_launches, op_launches, tokens


# -- the decode megakernel against its plain version -------------------------

MK_LENS = [37, 64, 150, 300, 1, 127, 256, 500]   # 64, 256: page boundaries
MK_INACTIVE = 5


def mk_state(cfg, mode, B, lens, inactive, gen, dev, max_len=2048,
             nan_fill=False, dtype="bfloat16", table_len=None):
    """A random pool (payload and qparams) with distinct logical pages per
    slot, `max_len` tokens' worth a slot, and the step's inputs. The page
    table covers `table_len` tokens a slot (the plan's max_length; by
    default max_len), its columns past max_len logical page 0, which no
    slot holds and no token < lens reads. `nan_fill`: every pool element of
    a float pool and every qparam element that no token < lens owns (rows
    past a slot's length, pages no slot holds, the qparams' lanes past the
    page) holds NaN, which the kernels must never read. `dtype`: the
    runtime's (an unquantized pool's element type)."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    maxP, L = max_len // PAGE, cfg.num_layers
    # logical pages 1 .. B*maxP; the last physical page is the per-op
    # path's sink for inactive slots
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (B * maxP + 1) * L + 1, getattr(torch, dtype),
                            dev)
    for t in (cache.k, cache.v):
        if mode == CacheMode.DEFAULT:
            t.normal_(generator=gen)
        else:
            t.view(torch.uint8).random_(0, 256, generator=gen)
    if mode != CacheMode.DEFAULT:
        lo = 0.008 if mode == CacheMode.INT8 else 0.13
        for t in (cache.k_qparams, cache.v_qparams):
            t.uniform_(0.5 * lo, lo, generator=gen)
            if mode == CacheMode.UINT4:
                t[:, 1::2] *= -7.5          # zero = min
            else:
                t[:, 1::2] -= 0.75 * lo
    pt = torch.zeros((B, (table_len or max_len) // PAGE), dtype=torch.int32,
                     device=dev)
    pt[:, :maxP] = (1 + torch.arange(B * maxP, dtype=torch.int32,
                                     device=dev)).reshape(B, maxP)
    if nan_fill:
        owned = torch.zeros(cache.k.shape[:2], dtype=torch.bool, device=dev)
        tok = torch.arange(maxP * PAGE, device=dev)
        for b, n in enumerate(lens):
            keep = tok < n
            pages = pt[b].long()[tok // PAGE][keep]
            for l in range(L):
                owned[pages * L + l, (tok % PAGE)[keep]] = True
        if mode == CacheMode.DEFAULT:
            for t in (cache.k, cache.v):
                t[~owned] = float("nan")
        else:
            for t in (cache.k_qparams, cache.v_qparams):
                t[:, :, PAGE:] = float("nan")
                t[:, :, :PAGE].masked_fill_(~owned[:, None, :], float("nan"))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if inactive is not None:
        active[inactive] = False
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=gen, device=dev)
    cos, sin = _rope_tiles(cfg, lens_t)
    return dict(cache=cache, pt=pt, lens=lens_t, active=active, tokens=tokens,
                cos=cos, sin=sin)


def mk_plan_pack(cfg, params, B, mode, dtype="bfloat16"):
    """(plan, packed) of the megakernel for a max_batch-B runtime."""
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import megakernel as mk
    rt = (RuntimeConfigBuilder("mk").max_length(2048).max_batch(B)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype(dtype)
          .build())
    check(mk.supports(cfg, rt, params), "megakernel.supports said no")
    plan = mk.make_plan(cfg, rt, params)
    return plan, mk.pack_params(cfg, plan, params)


def kv_bytes_read(cfg, mode, lens, active) -> int:
    """Bytes of cached K/V (payload + qparams) one step must read."""
    from dashinfer_tpu_torch.config import CacheMode
    per_tok = {CacheMode.DEFAULT: 2 * cfg.head_dim,
               CacheMode.INT8: cfg.head_dim + 8,
               CacheMode.UINT4: cfg.head_dim // 2 + 8}[mode]
    ntok = sum(n for n, a in zip(lens, active) if a)
    return 2 * ntok * cfg.num_kv_heads * per_tok * cfg.num_layers


def kv_levels(t, mode):
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    if mode == CacheMode.UINT4:
        return torch.cat([t & 0xF, t >> 4], dim=-1).to(torch.int32)
    return t.to(torch.int32) if mode == CacheMode.INT8 else t.float()


def check_written_pool(what, mode, got, ref_cache, before, written, L, dev,
                       exempt=None, moe=False):
    """A kernel's pool against its plain version's on clones of one pool:
    `written` [pages, ps] marks the token rows that must have changed (the
    tolerances above, except at the rows `exempt` marks: a MoE row that
    was routed differently); every other byte must be unchanged. A MoE
    model's written rows of the layers past the first are held in
    dequantized values, as the prefill pool is (MOE_DEEP_RTOL). Returns
    (payload levels apart, qparams rel. difference in layer 0, in all
    layers)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    pool_err = qp_err = qp_err0 = 0.0
    quant = mode != CacheMode.DEFAULT
    held = written if exempt is None else written & ~exempt

    def same(x, y):          # NaN garbage past lens stays NaN
        return bool(((x == y) | (x.isnan() & y.isnan())).all()) \
            if x.is_floating_point() else bool((x == y).all())

    for name in ("k", "v"):
        a, r, b0 = (getattr(c, name) for c in (got, ref_cache,
                                               before))
        check(same(a[~written], b0[~written]),
              f"{what}: {name} pool changed outside the written tokens")
        check(bool((a[written] != b0[written]).any(-1).all()),
              f"{what}: a new token's {name} row was not written")
        written_all, written = written, held
        d = (kv_levels(a[written], mode) - kv_levels(r[written], mode)).abs()
        layer = torch.arange(written.shape[0], device=dev)[:, None] \
            .expand_as(written)[written] % L
        if quant and moe:
            # layer 0 at most one level apart; deeper rows in values
            pool_err = max(pool_err, float(d[layer == 0].max().item()))
            by_layer = torch.zeros(L, device=dev).scatter_reduce_(
                0, layer, d.amax(-1).float(), "amax")
            print(f"{what}: {name} payload levels apart by layer: "
                  f"{[int(v) for v in by_layer.tolist()]}", flush=True)
            check(pool_err <= 1, f"{what}: {name} layer 0 payload "
                  f"{pool_err} levels")
            KH = getattr(got, name + "_qparams").shape[1] // 2
            val, _, _, _ = written_rows(got, name, written, mode, KH)
            rval, _, rsc, _ = written_rows(ref_cache, name, written, mode,
                                           KH)
            # [R, KH]: the difference less 1.5 of the row's levels, in
            # shares of the largest range of that layer's written rows
            rng = (rval.amax(-1) - rval.amin(-1))
            layer_rng = torch.zeros((L, KH), device=dev).scatter_reduce_(
                0, layer[:, None].expand_as(rng), rng, "amax"
            )[layer].clamp_min(1e-8)
            over = ((val - rval).abs().amax(-1) - 1.5 * rsc).clamp_min(0)
            rel_all = over / layer_rng                         # [R, KH]
            rel = rel_all[layer > 0]
            if rel.numel() and rel.max().item() > MOE_DEEP_RTOL:
                # where: the worst (row, head), and that token's rows in
                # every layer (logical page g: the request's row of pages)
                worst = int(rel_all.amax(-1).argmax())
                page, off = torch.nonzero(written)[worst].tolist()
                head = int(rel_all[worst].argmax())
                g = page // L
                same = torch.nonzero(written)
                rows_g = ((same[:, 0] // L == g) & (same[:, 1] == off))
                profile = [round(v, 4) for v in
                           rel_all[rows_g][:, head].tolist()]
                check(False, f"{what}: {name} rows past layer 0 differ by "
                      f"{rel.max().item():.3e} of their layer's range beyond "
                      f"1.5 levels; worst: logical page {g}, offset {off}, "
                      f"layer {page % L}, head {head}; by "
                      f"layer: {profile}; (row, head) pairs over: "
                      f"{int((rel > MOE_DEEP_RTOL).sum())} of {rel.numel()}")
        elif quant:     # at most one quantization level apart
            pool_err = max(pool_err, float(d.max().item()))
            by_layer = torch.zeros(L, device=dev).scatter_reduce_(
                0, layer, d.amax(-1).float(), "amax")
            check(pool_err <= 1, f"{what}: {name} payload {pool_err} levels "
                  f"(by layer: {by_layer.tolist()})")
        else:           # one bf16 step on top of the qparams' tolerances
            rv = kv_levels(r[written], mode).abs()
            layer0 = (torch.arange(written.shape[0], device=dev)[:, None]
                      .expand_as(written)[written] % L == 0)[:, None]
            tol = BF16_STEP * rv + rv.amax(-1, keepdim=True) * torch.where(
                layer0, QPARAM_RTOL, DEEP_QPARAM_RTOL)
            check(bool((d <= tol).all()), f"{what}: {name} payload differs "
                  f"by up to {d.max().item():.3e} (max|ref| "
                  f"{rv.max().item():.3e})")
        if quant:
            a, r, b0 = (getattr(c, name + "_qparams") for c in
                        (got, ref_cache, before))
            wq = torch.zeros_like(a, dtype=torch.bool)
            wq[..., :written_all.shape[1]] = written_all[:, None, :]
            check(same(a[~wq], b0[~wq]),
                  f"{what}: {name} qparams changed outside the written "
                  "tokens")
            # [pages, ps, 2*KH] at the written tokens: scale rows even,
            # zero rows odd; both relative to the token's range
            aw, rw = (t.permute(0, 2, 1)[written] for t in (a, r))
            rng_ = rw[:, 0::2] * (255.0 if mode == CacheMode.INT8 else 15.0)
            rel = torch.maximum(
                (aw[:, 0::2] - rw[:, 0::2]).abs() / rw[:, 0::2],
                (aw[:, 1::2] - rw[:, 1::2]).abs() / rng_).amax(-1)
            layer = torch.arange(written.shape[0], device=dev)[:, None] \
                .expand_as(written)[written] % L
            if bool((layer == 0).any()):
                qp_err0 = max(qp_err0, rel[layer == 0].max().item())
            qp_err = max(qp_err, rel.max().item())
            by_layer = [round(rel[layer == l].max().item(), 5)
                        for l in range(L) if bool((layer == l).any())]
            check(qp_err0 <= QPARAM_RTOL and qp_err <= DEEP_QPARAM_RTOL,
                  f"{what}: {name} qparams differ: layer 0 {qp_err0:.2e}, "
                  f"all layers {qp_err:.2e}; by layer {by_layer}")
        written = written_all
    return pool_err, qp_err0, qp_err


def check_lora_rows(what, mode, got, ref, rows, KH) -> float:
    """The written K / V rows of the rows on an adapter slot (`rows`
    [pages, ps]) by the LORA_POOL_RTOL rule; returns the largest excess
    over 1.5 levels, in shares of the row's range."""
    err, levels = 0.0, 0.0
    for name in ("k", "v"):
        val, lv, _, _ = written_rows(got, name, rows, mode, KH)
        rval, rlv, rsc, _ = written_rows(ref, name, rows, mode, KH)
        step = 0.0 if rsc is None else 1.5 * rsc[..., None]
        rng = (rval.amax(-1) - rval.amin(-1)).clamp_min(1e-8)
        over = ((val - rval).abs() - step).clamp_min(0).amax(-1) / rng
        err = max(err, over.max().item())
        if rsc is not None:
            levels = max(levels, (lv - rlv).abs().max().item())
    print(f"{what}: the adapters' rows' written K / V within {levels:g} "
          f"levels, {err:.2e} of their range beyond 1.5 levels", flush=True)
    check(err <= LORA_POOL_RTOL, f"{what}: an adapter row's written K / V "
          f"differs by {err:.3e} of its range beyond 1.5 levels")
    return err


def check_megakernel_case(cfg, params, stream, mode, gen, dev,
                          lens=None, inactive=None, nan_fill=False,
                          dtype="bfloat16", lora=None, max_len=2048,
                          faults=False, deep_values=False):
    """One step (B = 8 unless `lens` says otherwise) through the kernel and
    through the plain version, on clones of one pool: logits of the active
    rows, the written token, and every other pool byte (`nan_fill`: with
    NaN in every element no token < lens owns, `mk_state`; `dtype`
    "float32": an f32 DEFAULT pool, the attention's CUDA-core path;
    `lora`: (adapter pool, each row's slot) for the LoRA branch, whose
    plain version then also runs without the pool, to show by how much the
    adapters move the logits; `max_len`: the pool's pages a slot; `faults`:
    an ALiBi model's planted faults must fail the logits check,
    `planted_alibi_faults`; `deep_values`: the written rows past layer 0
    held by the MoE rule, in dequantized values, as zero-mean weights need:
    the note on the tolerances after MOE_DEEP_RTOL)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    if lens is None:
        lens, inactive = MK_LENS, MK_INACTIVE
    B, L = len(lens), cfg.num_layers
    plan, packed = mk_plan_pack(cfg, params, B, mode, dtype)
    st = mk_state(cfg, mode, B, lens, inactive, gen, dev, max_len=max_len,
                  nan_fill=nan_fill, dtype=dtype, table_len=2048)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    before = st["cache"]
    caches = {True: before.clone(), False: before.clone()}
    args = (plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
            st["active"])
    lkw = {}
    if lora is not None:
        lkw = dict(lora=lora[0], lora_idx=torch.tensor(
            lora[1], dtype=torch.int32, device=dev))
    out = {True: mk.decode_megakernel(*args, caches[True], **lkw)}
    mk.check_status(plan, dev)
    routing = []
    out[False] = mk.decode_megakernel_ref(*args, caches[False],
                                          routing=routing, **lkw)
    torch.cuda.synchronize()
    what = f"megakernel {stream}/{mode.value}" + (
        f" B={B}" if B != DECODE_BATCH else "") + (
        f" (cached tokens {sum(lens)})" if sum(lens) > 10000 else "") + (
        " NaN past lens" if nan_fill else "") + (
        " f32 pool" if dtype == "float32" else "") + (
        " LoRA" if lora is not None else "")
    act = st["active"].clone()
    flips, exempt, planted, budget = [], None, None, None
    if plan.E:
        # each layer's routing of the kernel against the plain version's
        chosen = torch.zeros((L, B, plan.E), dtype=torch.bool, device=dev)
        chosen.scatter_(2, mk.kernel_routing(plan, dev).long(), True)
        budget = max(MAX_FLIPPED_ROWS,
                     math.ceil(MAX_FLIPPED_ROW_SHARE * int(act.sum())))
        flips = flipped_rows(plan, chosen, routing, act, what, budget)
        planted = planted_router_fault(plan, routing, act, what, budget,
                                       SEED + B)
        exempt = torch.zeros(before.k.shape[:2], dtype=torch.bool,
                             device=dev)
        for b, *_ in flips:
            g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
            exempt[g * L:(g + 1) * L, off] = True
            act[b] = False
    got, ref = out[True][act], out[False][act]
    check(bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    check(err <= LOGITS_RTOL * ref_max,
          f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    # equal argmax, unless the plain version itself holds the two
    # candidates closer than twice the measured difference (a tie)
    pick = got.argmax(-1)
    tie = ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]
    same = int((pick == ref.argmax(-1)).sum().item())
    check(bool((tie <= 2 * err).all()), f"{what}: argmax differs")
    fault_errs = planted_alibi_faults(plan, packed, args, before, out[True],
                                      act, ref_max, what, dev) \
        if faults else None
    lora_moved = lora_pool_err = None
    if lora is not None:
        # what the adapters move: the plain version without them, on the
        # LoRA rows, against the tolerance the kernel is held to
        base = mk.decode_megakernel_ref(*args, before.clone())
        rows = act & (lkw["lora_idx"] >= 0)
        lora_moved = (out[False][rows] - base[rows]).abs().max().item()
        flipped = int((out[False][rows].argmax(-1) !=
                       base[rows].argmax(-1)).sum().item())
        print(f"{what}: the adapters move the LoRA rows' logits by up to "
              f"{lora_moved:.3e} (tolerance {LOGITS_RTOL * ref_max:.3e}), "
              f"argmax of {flipped} of {int(rows.sum())} rows", flush=True)
        check(lora_moved > 2 * LOGITS_RTOL * ref_max,
              f"{what}: the adapters move the logits by only "
              f"{lora_moved:.3e}")
        del base
    # the pool: only the new token's rows may change
    written = torch.zeros(before.k.shape[:2], dtype=torch.bool, device=dev)
    lrows = torch.zeros_like(written)
    for b in range(B):
        if b == inactive:
            continue
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        written[g * L:(g + 1) * L, off] = True
        if lora is not None and lora[1][b] >= 0:
            lrows[g * L:(g + 1) * L, off] = True
    if lora is not None:
        # the rows on an adapter slot by the LoRA rule, the others by the
        # dense rules
        lora_pool_err = check_lora_rows(what, mode, caches[True],
                                        caches[False], lrows,
                                        plan.KH)
        exempt = lrows
    pool_err, qp_err0, qp_err = check_written_pool(
        what, mode, caches[True], caches[False], before, written, L, dev,
        exempt, moe=bool(plan.E) or deep_values)
    forced = forced_routing_check(plan, args, caches[True], out[True], before,
                                  written, st, lens, flips, what, dev) \
        if plan.E else None
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}), argmax "
          f"equal {same}/{int(act.sum())}, written payload within "
          f"{pool_err:g} level, qparams rel {qp_err0:.1e} (layer 0) "
          f"{qp_err:.1e} (all layers), rest of the pool "
          "unchanged" + (f"; rows routed differently (row, first layer, "
                         f"logit gap): {flips}, by the planted router "
                         f"fault: {planted} (cap {budget})" if plan.E
                         else ""),
          flush=True)
    return dict(stream=stream, mode=mode.value, B=B, max_abs_err=err,
                ref_max=ref_max, argmax_equal=same, pool_levels=pool_err,
                qparam_rel_layer0=qp_err0, qparam_rel=qp_err,
                flipped_rows=flips, planted_fault_rows=planted,
                forced_routing=forced, lora_moved=lora_moved,
                lora_pool_err=lora_pool_err, planted_faults=fault_errs)


def forced_routing_check(plan, args, got_cache, got, before, written, st,
                         lens, flips, what, dev):
    """The MoE decode branch against its plain version routed as the kernel
    routed each row in each layer (`kernel_routing`): every active row, the
    rows the two route differently (`flips`) included, is held to the
    bounds every other row meets above (logits within LOGITS_RTOL of their
    largest, the written pool rows of every layer by check_written_pool's
    MoE rules), so that a fault in the branch's products or gates cannot
    pass as a router near-tie. One kind of (row, layer) cannot meet them
    with a sound kernel: one whose residual, entering the layer, is still
    near the scale of the row's embedding while the other rows' have grown
    (the RMS of 0.03 against a median of 20 here), so that the layer's
    RMSNorm passes the row's rounding differences (the f32 sums' order, a
    bf16 rounding on the other side of a tie) on with that much more gain.
    A (row, layer) past layer 0 whose K or V differs from the plain
    version's, beyond one and a half of its levels, by more than
    CONDITIONED_RTOL of the row's own range is held to the bounds unless
    the plain version's residual RMS entering that layer is below
    ILL_NORM_SHARE of the median over the active rows; such (row, layer)s
    are printed with the row's profile and not held, for at most
    MAX_FLIPPED_ROWS rows or MAX_FLIPPED_ROW_SHARE of the active rows.
    Returns the readings."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    cf = before.clone()
    norms = []
    ref = mk.decode_megakernel_ref(*args, cf,
                                   forced_routing=mk.kernel_routing(plan, dev),
                                   resid_norms=norms)
    torch.cuda.synchronize()
    return hold_routed_rows(plan.L, plan.KH, plan.kv_mode, got_cache, got,
                            cf, ref, norms, before, written, st, lens, flips,
                            f"{what} (the plain version routed as the "
                            "kernel)", dev)


def hold_routed_rows(L, KH, mode, got_cache, got, cf, ref, norms, before,
                     written, st, lens, flips, what, dev, skip=(),
                     after_ill=False):
    """forced_routing_check's rules for a MoE decode step (`got`,
    `got_cache`: the kernels'; `ref`, `cf`: the step they are held to,
    routed alike; `norms`: its residual RMS entering each layer; KH: the
    pool's KV heads): every active row but those of `skip` (routed
    differently) is held, but ill-conditioned (row, layer)s. `after_ill`
    (the TP MoE forward's check alone) also leaves unheld the layer right
    after an ill-conditioned one, past the rule above: the residual a row
    enters it with is mostly that layer's output, computed from the
    amplified x_norm (the note above TP_MOE_CASES says what backs it)."""
    import torch
    act = st["active"].clone()
    for b in skip:
        act[b] = False
    err = (got[act] - ref[act]).abs().max().item()
    ref_max = ref[act].abs().max().item()
    check(bool(torch.isfinite(got[act]).all()) and
          err <= LOGITS_RTOL * ref_max,
          f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    # [B, L]: the largest K or V difference of a head, dequantized, beyond
    # one and a half of the row's levels, in shares of the row's range
    rows = [b for b in range(len(lens)) if bool(act[b])]
    diff = torch.zeros((len(lens), L), device=dev)
    for b in rows:
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        m = torch.zeros_like(written)
        m[g * L:(g + 1) * L, off] = True
        for name in ("k", "v"):
            val, _, _, _ = written_rows(got_cache, name, m, mode, KH)
            rval, _, rsc, _ = written_rows(cf, name, m, mode, KH)
            lv = 0 if rsc is None else 1.5 * rsc
            d = ((val - rval).abs().amax(-1) - lv).clamp_min(0) / \
                (rval.amax(-1) - rval.amin(-1)).clamp_min(1e-8)
            diff[b] = torch.maximum(diff[b], d.amax(-1))
    norms = torch.stack(norms, 1)                          # [B, L]
    share = norms / norms[rows].median(0).values[None, :]
    low = share < ILL_NORM_SHARE
    if after_ill:
        low[:, 1:] |= low[:, :-1].clone()
    ill = (diff > CONDITIONED_RTOL) & low
    ill[:, 0] = False
    ill_rows = torch.nonzero(ill.any(1))[:, 0].tolist()
    cap = max(MAX_FLIPPED_ROWS, math.ceil(MAX_FLIPPED_ROW_SHARE * len(rows)))
    check(len(ill_rows) <= cap,
          f"{what}: {len(ill_rows)} rows ill-conditioned, at most {cap}: "
          f"{ill_rows}")
    exempt = torch.zeros_like(written)
    for b, l in torch.nonzero(ill).tolist():
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        exempt[g * L + l, off] = True
    for b in skip:
        g, off = int(st["pt"][b, lens[b] // PAGE]), lens[b] % PAGE
        exempt[g * L:(g + 1) * L, off] = True
    parted = [b for b in rows if bool((diff[b] > CONDITIONED_RTOL).any())]
    if parted:
        by_row = {b: [(round(d_, 4), round(s_, 4)) for d_, s_ in
                      zip(diff[b].tolist(), share[b].tolist())]
                  for b in parted}
        print(f"{what}: rows whose K / V part by over {CONDITIONED_RTOL} of "
              f"their range somewhere (row: by layer, the difference and the "
              f"residual RMS over the median): {by_row}", flush=True)
    pool = check_written_pool(what, mode, got_cache, cf, before, written, L,
                              dev, exempt, moe=True)
    profile = {b: dict(diff=[round(v, 4) for v in diff[b].tolist()],
                       norm_share=[round(v, 4) for v in share[b].tolist()],
                       not_held=torch.nonzero(ill[b])[:, 0].tolist())
               for b in ill_rows}
    print(f"{what}: every active row held"
          + (f" but {list(skip)} (routed differently)" if skip else "")
          + f" ({len(flips)} routed differently by the kernel and the plain "
          f"version, {[b for b, *_ in flips]}): logits max|d|={err:.3e} "
          f"(ref max {ref_max:.3e}); pool within {pool[0]:g} level in layer "
          f"0, qparams rel {pool[1]:.1e} (layer 0) {pool[2]:.1e} (all "
          f"layers); largest K / V difference of a held (row, layer) "
          f"{float(diff[rows][~ill[rows]].max()):.3e} of the row's range "
          f"beyond 1.5 levels; ill-conditioned rows by layer (difference, "
          f"residual RMS over the median, layers not held): {profile}",
          flush=True)
    return dict(max_abs_err=err, ref_max=ref_max, pool_levels=pool[0],
                qparam_rel_layer0=pool[1], qparam_rel=pool[2],
                held_max=float(diff[rows][~ill[rows]].max()),
                ill_conditioned=profile)


def time_megakernel(cfg, params, stream, B, lens, gen, dev, per_op=True,
                    max_len=2048):
    """ms per decode forward (graph replay, CUDA events) through the
    megakernel, through it without its attention phases, and through the
    per-op forward, on the same INT8 state (`max_len`: its pages a
    slot)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import megakernel as mk
    mode = CacheMode.INT8
    plan, packed = mk_plan_pack(cfg, params, B, mode)
    st = mk_state(cfg, mode, B, lens, None, gen, dev, max_len=max_len,
                  table_len=2048)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)

    def run(skip):
        return mk.decode_megakernel(plan, packed, x0, st["cos"], st["sin"],
                                    st["pt"], st["lens"], st["active"],
                                    st["cache"], skip_attention=skip)

    row = dict(stream=stream, B=B, lens_sum=sum(lens),
               geometry=mk.launch_geometry(plan, dev),
               ms=time_ms(run, [(False,)], iters=5),
               no_attention_ms=time_ms(run, [(True,)], iters=5))
    mk.check_status(plan, dev)
    # at mpad 16 the block's shared memory (the product ring, the attention
    # tiles, the norm slabs) and registers leave two blocks an SM
    geo = row["geometry"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(geo["mpad"] != 16 or geo["grid"] == 2 * sms,
          f"megakernel {stream} B={B}: grid {geo['grid']} at mpad 16, not "
          f"two blocks on each of {sms} SMs")
    # where one launch's time goes: block 0's timestamps, by phase kind
    trace = torch.zeros(mk.trace_len(plan), dtype=torch.int64, device=dev)
    mk.decode_megakernel(plan, packed, x0, st["cos"], st["sin"], st["pt"],
                         st["lens"], st["active"], st["cache"], trace=trace)
    torch.cuda.synchronize()
    row["phases"] = mk.phase_times(plan, trace)
    if per_op:
        row["per_op_ms"] = time_ms(
            lambda: transformer.decode_forward(
                cfg, params, st["tokens"], st["cache"], st["pt"], st["lens"],
                st["active"], mode=mode), [()], iters=3)
    weight_bytes = plan.weight_bytes
    n_w = sum(sp.K * sp.Ntot * (1 if sp.name == "lm" else plan.L)
              for sp in plan.streams if not sp.E)
    if plan.E:
        # what this step's data needs: the experts some row routes to in
        # each layer (the traced launch's routing), k of them a row
        used = [len(set(r.flatten().tolist()))
                for r in mk.kernel_routing(plan, dev)]
        weight_bytes = int(sum(plan.layer_bytes(u) for u in used) +
                           plan.lm.matrix_bytes)
        n_w += plan.L * plan.k_top * sum(sp.K * sp.Ntot for sp in
                                         plan.streams if sp.E)
        row.update(experts_used=used,
                   all_experts_bytes_ms=bounds(plan.weight_bytes, 0)[
                       "bytes_ms"])
    nbytes = (weight_bytes + kv_bytes_read(cfg, mode, lens, [1] * B) +
              B * plan.V * 4)
    ops = 2.0 * B * n_w
    row.update(weight_bytes=weight_bytes, **bounds(nbytes, ops))
    print(f"megakernel {stream} B={B} (cached tokens {sum(lens)}): "
          f"{row['ms']:.3f} ms/step, without attention "
          f"{row['no_attention_ms']:.3f}, byte bound {row['bytes_ms']:.3f}"
          + (f" (routed experts a layer {min(row['experts_used'])}.."
             f"{max(row['experts_used'])}; every expert: "
             f"{row['all_experts_bytes_ms']:.3f})" if plan.E else "")
          + (f", per-op graph {row['per_op_ms']:.3f}" if per_op else "")
          + f"; grid {row['geometry']['grid']}, K splits "
          f"{row['geometry']['splits']}", flush=True)
    print("  phases, ms work+wait (block 0, one traced launch): "
          + ", ".join(f"{k} {v['work']:.2f}+{v['wait']:.2f}"
                      for k, v in row["phases"].items()), flush=True)
    return row


def check_megakernel(params, dev, details):
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.tools import bench_stream
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    i8_params = random_qwen2_7b_params(SEED + 1, dev, stream="i8")
    i8_params["embed_tokens"] = params["embed_tokens"]
    cases, times = [], []
    for stream, p in (("u4", params), ("i8", i8_params)):
        for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
            cases.append(check_megakernel_case(cfg, p, stream, mode, gen,
                                               dev))
    # B = 32: the kernel's two-m-tile instantiation, several norm items a
    # block
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, lens32, 17))
    cases.append(check_megakernel_case(cfg, i8_params, "i8", CacheMode.INT8,
                                       gen, dev, lens32, 17))
    long_lens = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
    # B = 1: one live row of the weights-as-A product's first n8 tile; the
    # long-context state (16 chunks of a slot's attention); NaN in every
    # element no token < lens owns, for each KV mode
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, [700], None))
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.INT8, gen,
                                       dev, long_lens, None))
    for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
        cases.append(check_megakernel_case(cfg, params, "u4", mode, gen, dev,
                                           nan_fill=True))
    # an f32 DEFAULT pool (a float32 runtime): the attention's CUDA-core
    # path, 8-token warp tiles
    cases.append(check_megakernel_case(cfg, params, "u4", CacheMode.DEFAULT,
                                       gen, dev, nan_fill=True,
                                       dtype="float32"))
    # the plain version's time (one run, host clock around a synchronize)
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, CacheMode.INT8)
    st = mk_state(cfg, CacheMode.INT8, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(plan, packed, x0, st["cos"], st["sin"],
                             st["pt"], st["lens"], st["active"], st["cache"])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    replays_bit_equal("megakernel u4/int8", lambda: mk.decode_megakernel(
        plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
        st["active"], st["cache"]))
    mk.check_status(plan, dev)
    del st, plan, packed
    times.append(time_megakernel(cfg, params, "u4", 8, MK_LENS, gen, dev))
    times.append(time_megakernel(cfg, params, "u4", 8, long_lens, gen, dev))
    times.append(time_megakernel(cfg, params, "u4", 32, lens32, gen, dev))
    times.append(time_megakernel(cfg, i8_params, "i8", 32, lens32, gen, dev,
                                 per_op=False))
    times.append(time_megakernel(cfg, i8_params, "i8", 8, MK_LENS, gen, dev,
                                 per_op=False))
    del i8_params
    torch.cuda.empty_cache()
    replica = bench_stream.measure_replica(DECODE_BATCH, dev, num_layers=4)
    print(f"bench_stream replica (4 layers + lm_head, B={DECODE_BATCH}): "
          f"{replica['ms']:.3f} ms, {replica['gbps']:.0f} GB/s", flush=True)
    details["megakernel"] = dict(cases=cases, times=times, plain_ms=plain_ms,
                                 replica=replica)
    base = times[0]
    print(f"megakernel plain version: {plain_ms:.1f} ms/step", flush=True)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], plain_ms=plain_ms, library_ms=None,
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"))


def check_megakernel_moe(cfg, params, dev, details):
    """The decode megakernel's MoE branch at Qwen1.5-MoE width (G = 1):
    one step against the plain version for the three KV modes at B = 8 and
    at B = 32, then ms per step beside the routed byte bound."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    cases = [check_megakernel_case(cfg, params, "u4 MoE", mode, gen, dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4)]
    drawn = gen.get_state()
    cases.append(check_megakernel_case(cfg, params, "u4 MoE",
                                       CacheMode.DEFAULT, gen, dev))
    # the same DEFAULT state (the same draw) with NaN in every float pool
    # element no token < lens owns (G = 1): what the kernel reads is the
    # state above, so its routing and rows must hold as they did there
    after = gen.get_state()
    gen.set_state(drawn)
    cases.append(check_megakernel_case(cfg, params, "u4 MoE",
                                       CacheMode.DEFAULT, gen, dev,
                                       nan_fill=True))
    gen.set_state(after)
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases.append(check_megakernel_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                       gen, dev, lens32, 17))
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, CacheMode.INT8)
    st = mk_state(cfg, CacheMode.INT8, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(plan, packed, x0, st["cos"], st["sin"],
                             st["pt"], st["lens"], st["active"], st["cache"])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    replays_bit_equal("megakernel u4 MoE/int8", lambda: mk.decode_megakernel(
        plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
        st["active"], st["cache"]))
    mk.check_status(plan, dev)
    del st, plan, packed
    times = [time_megakernel(cfg, params, "u4 MoE", 8, MK_LENS, gen, dev),
             time_megakernel(cfg, params, "u4 MoE", 32, lens32, gen, dev,
                             per_op=False)]
    details["megakernel_moe"] = dict(cases=cases, times=times,
                                     plain_ms=plain_ms)
    print(f"megakernel MoE plain version: {plain_ms:.1f} ms/step", flush=True)
    base = times[0]
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], plain_ms=plain_ms, library_ms=None,
                per_op_ms=base["per_op_ms"],
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"),
                flipped_rows=sum(len(c["flipped_rows"]) for c in cases))


# -- the prefill megakernel against its plain version ------------------------

def pmk_plan_pack(cfg, params, bucket, mode):
    """(prefill plan, decode pack) as the runtime makes them."""
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    rt = (RuntimeConfigBuilder("pmk").max_length(2048).max_batch(DECODE_BATCH)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
          .build())
    check(pmk.supports_prefill(cfg, rt, params, bucket),
          "prefill_megakernel.supports_prefill said no")
    dplan = mk.make_plan(cfg, rt, params)
    plan = pmk.make_prefill_plan(cfg, rt, params, bucket, decode_plan=dplan)
    check(pmk.cuda_kernel_gaps(plan) == [], "prefill kernel gaps")
    return plan, mk.pack_params(cfg, dplan, params)


def pmk_inputs(cfg, params, plan, mode, n, gen, dev):
    """A random pool, a request's shuffled logical pages, and the launch's
    inputs for a prompt of n tokens in the plan's bucket."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    L, S = cfg.num_layers, plan.S
    n_logical = 2 * plan.maxPb
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (n_logical + 1) * L + 1, torch.bfloat16, dev)
    for t in (cache.k, cache.v):
        if mode == CacheMode.DEFAULT:
            t.normal_(generator=gen)
        else:
            t.view(torch.uint8).random_(0, 256, generator=gen)
    if mode != CacheMode.DEFAULT:
        for t in (cache.k_qparams, cache.v_qparams):
            t.uniform_(0.5, 1.0, generator=gen)
    pages = (1 + torch.randperm(n_logical, generator=gen, device=dev)
             )[:plan.maxPb].to(torch.int32)
    tokens = torch.zeros(S, dtype=torch.int64, device=dev)
    tokens[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                               device=dev)
    cos, sin = _rope_tiles(cfg, torch.arange(S, device=dev))
    return dict(cache=cache, pages=pages, page_row=pages * L, tokens=tokens,
                x0=params["embed_tokens"]["w"][tokens].to(torch.bfloat16),
                cos=cos, sin=sin,
                n=torch.tensor([n], dtype=torch.int32, device=dev))


def written_rows(cache, name, written, mode, KH):
    """The written token rows of a pool: (dequantized values [R, KH, D],
    levels [R, KH, D], scale [R, KH], zero [R, KH]); for an unquantized pool
    the values twice and no qparams."""
    from dashinfer_tpu_torch.config import CacheMode
    pay = getattr(cache, name)[written]
    lv = kv_levels(pay.reshape(pay.shape[0], KH, -1), mode).float()
    if mode == CacheMode.DEFAULT:
        return lv, lv, None, None
    qp = getattr(cache, name + "_qparams").permute(0, 2, 1)[written]
    sc, ze = qp[:, 0::2], qp[:, 1::2]
    return lv * sc[..., None] + ze[..., None], lv, sc, ze


def check_prefill_pool(what, mode, got, ref, ref32, before, written, cfg,
                       dev, exempt=None):
    """The prefill kernel's pool against its plain version's (`ref`, bf16
    score operands; `ref32`, f32 score operands) on clones of one pool, by
    the tolerances stated above. Returns (levels apart in layer 0, qparams
    rel. difference in layer 0, largest difference of a written row in
    shares of its range, rows passed as ill-conditioned, largest difference
    of such a row, largest difference of a row between the two plain
    versions)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    L, KH = cfg.num_layers, cfg.num_kv_heads
    quant = mode != CacheMode.DEFAULT
    n_levels = {CacheMode.INT8: 255.0, CacheMode.UINT4: 15.0}.get(mode)
    layer0 = (torch.arange(written.shape[0], device=dev)[:, None]
              .expand_as(written)[written] % L) == 0
    # rows of a MoE token that the kernel routed differently (rows of the
    # written mask's order): not held to the tolerances
    held = torch.ones_like(layer0) if exempt is None else \
        ~exempt[written]
    lv_err = qp_err0 = rel_max = plain_max = ill_max = 0.0
    ill = 0
    for name in ("k", "v"):
        names = [name] + ([name + "_qparams"] if quant else [])
        for nm in names:
            a, b0 = getattr(got, nm), getattr(before, nm)
            keep = ~written if nm == name else \
                ~written[:, None, :].expand_as(a)
            check(bool((a[keep] == b0[keep]).all()),
                  f"{what}: {nm} changed outside rows < n of the owned pages")
        check(bool((getattr(got, name)[written] !=
                    getattr(before, name)[written]).any(-1).all()),
              f"{what}: a row < n of {name} was not written")
        val, lv, sc, ze = written_rows(got, name, written, mode, KH)
        rval, rlv, rsc, rze = written_rows(ref, name, written, mode, KH)
        r32 = written_rows(ref32, name, written, mode, KH)[0]
        rng = (rval.amax(-1) - rval.amin(-1)).clamp_min(1e-8)
        rel = (val - rval).abs().amax(-1) / rng * held[:, None]   # [R, KH]
        rel32 = (rval - r32).abs().amax(-1) / rng
        if quant:
            # a check of writes at deeper layers only has no layer-0 rows
            if bool((layer0 & held).any()):
                d0 = (lv - rlv).abs()[layer0 & held]
                lv_err = max(lv_err, d0.max().item())
                q0 = torch.maximum((sc - rsc).abs() / rsc,
                                   (ze - rze).abs() / rng)[layer0 & held]
                qp_err0 = max(qp_err0, q0.max().item())
            check(lv_err <= 1 and qp_err0 <= QPARAM_RTOL,
                  f"{what}: {name} layer 0: payload {lv_err} levels, "
                  f"qparams {qp_err0:.2e}")
            tol = 1.5 / n_levels + PREFILL_POOL_RTOL
        else:
            tol = BF16_STEP + PREFILL_POOL_RTOL
            check(bool((rel[layer0 & held] <= BF16_STEP + QPARAM_RTOL
                        ).all()),
                  f"{what}: {name} layer 0 differs {rel[layer0].max():.2e}")
        over = rel > tol
        bad = over & (rel > 4 * rel32)
        check(not bool(bad.any()),
              f"{what}: {name} rows differ by up to "
              f"{rel[bad].max().item() if bad.any() else 0:.3e} of their "
              f"range ({int(bad.sum())} (row, head) pairs beyond {tol:.3e} "
              "where the two plain versions agree; they differ by "
              f"{rel32[bad].max().item() if bad.any() else 0:.3e} there)")
        check(int(over.sum()) <= ILL_ROWS_MAX,
              f"{what}: {int(over.sum())} (row, head) pairs of {name} beyond "
              f"{tol:.3e} of their range; at most {ILL_ROWS_MAX} may pass as "
              "ill-conditioned")
        ill += int(over.sum())
        if over.any():
            ill_max = max(ill_max, rel[over].max().item())
        rel_max = max(rel_max, rel[~over].max().item())
        plain_max = max(plain_max, rel32.max().item())
    return lv_err, qp_err0, rel_max, ill, ill_max, plain_max


def check_prefill_case(cfg, params, stream, mode, bucket, n, gen, dev,
                       forced=False, alibi_fault=False):
    """One prefill through the kernel and through the plain version (with
    the kernel's bf16 score operands), on clones of one pool: the logits,
    rows < n of the owned pages, and every other pool byte. The plain
    version with the TPU kernel's f32 score operands is read beside it.
    `forced` (a MoE case): the plain version is routed as the kernel routed
    each prompt row in each layer (`kernel_routing`), and every token, the
    ones the two route differently included, is held to those bounds (the
    rule of the MoE decode check, `forced_routing_check`); the tokens
    routed differently are counted and read, not capped, and each must be
    a near-tie of the plain version's router logits (gap <= TIE_LOGIT) or
    ill-conditioned at the layer where it first flips. `alibi_fault` (an
    ALiBi model): the plain version with every slope zero (no bias) must
    fail the logits check the kernel passed. The lm_head is also held to
    its own rounding on the row the kernel normed (`lm_row_order`)."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    L = cfg.num_layers
    plan, packed = pmk_plan_pack(cfg, params, bucket, mode)
    st = pmk_inputs(cfg, params, plan, mode, n, gen, dev)
    before = st["cache"]
    got_cache, ref_cache = before.clone(), before.clone()
    args = (plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
            st["n"])
    ref32_cache = before.clone()
    got = pmk.prefill_megakernel(*args, got_cache)
    pmk.check_status(dev)
    what = f"prefill_megakernel {stream}/{mode.value} S={bucket} n={n}"
    order = lm_row_order(plan, packed, got, dev, what)
    routes = {True: [], False: []}
    norms = []
    ref = pmk.prefill_megakernel_ref(
        *args, ref_cache, bf16_scores=True, routing=routes[True],
        forced_routing=pmk.kernel_routing(plan, n, dev) if forced else None,
        resid_norms=norms)
    ref32 = pmk.prefill_megakernel_ref(*args, ref32_cache,
                                       routing=routes[False])
    torch.cuda.synchronize()
    check(tuple(got.shape) == (cfg.vocab_size,) and
          bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    # a MoE prompt's tokens that the kernel routed differently from the
    # plain version (and the plain versions from each other) in some layer
    flips, last_flipped, last32_flipped = [], False, False
    written = prompt_written(before, st["pages"], n, L, range(L), dev)
    check(int(written.sum()) == n * L, f"{what}: written mask")
    exempt, planted, budget, ill_tok = None, None, None, None
    if plan.E:
        valid = torch.arange(plan.S, device=dev) < n
        budget = max(MAX_FLIPPED_ROWS, int(MAX_FLIPPED_SHARE * n))
        # forced: every flipped token is held where it first flips, a
        # near-tie of the plain version's router or ill-conditioned there
        # (its residual RMS entering the layer below ILL_NORM_SHARE of the
        # prompt's median, past layer 0: forced_routing_check's rule)
        share = torch.stack(norms)                               # [L, S]
        ill_tok = share / share[:, :n].median(1).values[:, None] < \
            ILL_NORM_SHARE
        ill_tok[0] = False
        flips = flipped_rows(plan, pmk.kernel_gates(plan, dev) > 0,
                             routes[True], valid, what,
                             n if forced else budget,
                             ill=ill_tok if forced else None)
        planted = planted_router_fault(plan, routes[True], valid, what,
                                       budget, SEED + n)
        # the plain version with the TPU kernel's f32 score operands
        chosen = torch.stack([mk.route(plan, lg)[0] > 0
                              for lg in routes[True]])
        flips32 = flipped_rows(plan, chosen, routes[False], valid, what)
        rows = [t for t, *_ in flips]
        last_flipped = n - 1 in rows and not forced
        last32_flipped = n - 1 in [t for t, *_ in flips32]
        exempt = torch.zeros_like(written)
        for t in ([] if forced else rows):
            g = int(st["pages"][t // PAGE])
            exempt[g * L:(g + 1) * L, t % PAGE] = True
        counts = routed_counts_check(plan, dev, routes[True], n, len(rows),
                                     what)
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    err32 = (got - ref32).abs().max().item()
    if not last_flipped:
        check(err <= LOGITS_RTOL * ref_max,
              f"{what}: logits differ {err:.3e} > {LOGITS_RTOL} * "
              f"{ref_max:.3e}")
        pick = int(got.argmax())
        check(float(ref.max() - ref[pick]) <= 2 * err,
              f"{what}: argmax differs")
    fault_err = None
    if alibi_fault:
        zero = dict(packed, slopes=torch.zeros_like(packed["slopes"]))
        bad = pmk.prefill_megakernel_ref(*((plan, zero) + args[2:]),
                                         before.clone(), bf16_scores=True)
        fault_err = (bad - got).abs().max().item()
        check(fault_err > LOGITS_RTOL * ref_max,
              f"{what}: the planted fault (slopes zero) passes the logits "
              f"check ({fault_err:.3e} <= {LOGITS_RTOL} * {ref_max:.3e})")
        print(f"{what}: the planted fault (slopes zero) fails the logits "
              f"check: {fault_err:.3e}", flush=True)
    if not (last_flipped or last32_flipped or forced):
        check(err32 <= F32_SCORES_RTOL * ref_max,
              f"{what}: logits differ from the f32-score plain version by "
              f"{err32:.3e} > {F32_SCORES_RTOL} * {ref_max:.3e}")
    pick = int(got.argmax())
    lv_err, qp_err0, rel_max, ill, ill_max, plain_max = check_prefill_pool(
        what, mode, got_cache, ref_cache, ref32_cache, before, written, cfg,
        dev, exempt)
    margin = err / (LOGITS_RTOL * ref_max)
    print(f"{what}: logits max|d|={err:.3e} (ref max {ref_max:.3e}: "
          f"{margin:.3f} of the tolerance; against f32 scores {err32:.3e}; "
          f"the lm_head against its own rounding {order[0]:.3f} of "
          f"{ORDER_RTOL}; from the f64 product of its row: the kernel "
          f"{order[1]:.4f}, the weight-side form {order[2]:.4f} of the "
          f"tolerance), argmax {pick}; layer 0 rows within "
          f"{lv_err:g} level, qparams rel {qp_err0:.1e}; all rows within "
          f"{rel_max:.1e} of their range, but for {ill} ill-conditioned "
          f"(row, head) pairs (up to {ill_max:.1e}; the two plain versions "
          f"differ by up to "
          f"{plain_max:.1e}); rest of the pool unchanged"
          + (f"; tokens routed differently (token, first layer, logit "
             f"gap): {flips}"
             + (" incl. the last: its logits not held" if last_flipped
                else "")
             + (" (the plain version routed as the kernel: every token "
                "held; each flip a near-tie or ill-conditioned where it "
                f"first flips, ill-conditioned: "
                f"{sum(bool(ill_tok[l, t]) for t, l, _ in flips)})"
                if forced else "")
             + f", by the planted router fault: {planted} (cap {budget})"
             if plan.E else ""), flush=True)
    return dict(stream=stream, mode=mode.value, bucket=bucket, n=n,
                flipped_tokens=flips, planted_fault_tokens=planted,
                routed_as_kernel=forced,
                expert_rows=counts.tolist() if plan.E else None,
                max_abs_err=err, max_abs_err_f32_scores=err32,
                ref_max=ref_max, logits_margin=margin,
                lm_row_order=order[0], lm_exact_kernel=order[1],
                lm_exact_weight_side=order[2],
                pool_levels_layer0=lv_err,
                qparam_rel_layer0=qp_err0, row_rel_max=rel_max,
                ill_conditioned_rows=ill, ill_row_rel_max=ill_max,
                plain_versions_row_rel_max=plain_max,
                planted_fault=fault_err)


def routed_counts_check(plan, dev, logits_plain, n, n_flipped, what):
    """The per-expert row counts the MoE kernel wrote (its expert products
    ran over exactly these rows): each layer's sum is n x k, they are the
    kernel's own routing's (its gates), and they differ from the plain
    router's only by the tokens routed differently (those capped as flips
    above: each moves at most k rows out of and k into other experts).
    Returns the counts [L, E]."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    counts = pmk.kernel_counts(plan, dev).long()
    chosen = (pmk.kernel_gates(plan, dev) > 0)[:, :n]            # [L, n, E]
    check(bool((counts.sum(1) == n * plan.k_top).all()),
          f"{what}: the experts' rows sum to {counts.sum(1).tolist()}, not "
          f"n x k = {n * plan.k_top} in every layer")
    check(bool((counts == chosen.sum(1)).all()),
          f"{what}: the experts' row counts are not the kernel's routing")
    plain = torch.stack([mk.route(plan, lg[:n])[0] > 0
                         for lg in logits_plain])
    moved = (counts - plain.sum(1)).abs().sum(1)                  # [L]
    differ = (chosen != plain).any(-1).sum(1)                     # [L]
    check(bool((moved <= 2 * plan.k_top * differ).all()) and
          int(differ.max()) <= n_flipped,
          f"{what}: the experts' row counts differ from the plain router's "
          f"by {moved.tolist()} rows a layer, beyond the {n_flipped} "
          "tokens routed differently")
    print(f"{what}: the experts' rows a layer sum to n x k = "
          f"{n * plan.k_top}, the plain router's counts in "
          f"{int((moved == 0).sum())} of {plan.L} layers (the rest moved by "
          f"the flipped tokens); experts without rows: "
          f"{int((counts == 0).sum())} (expert, layer) pairs; most rows an "
          f"expert: {int(counts.max())}", flush=True)
    return counts


def skewed_moe_params(params, expert: int, dev):
    """The MoE weights with every prompt row's hidden state sharing one
    direction u (the embedding table + u) and `expert`'s router column
    along u in every layer, so that this expert takes most rows (a router
    skew); the other weights are shared with `params`."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    emb = params["embed_tokens"]["w"]
    u = torch.randn(emb.shape[1], generator=gen, device=dev) * 0.05
    router = params["layers"]["router"]["w"].clone()
    router[:, :, expert] = (0.25 * u / u.norm())[None, :]
    return dict(params,
                embed_tokens={"w": (emb.float() + u).to(emb.dtype)},
                layers=dict(params["layers"], router={"w": router}))


def gate_up_yardstick(cfg, dev, buckets=(128, 1024)):
    """torch.matmul of x [S, hid] bf16 by a bf16 gate|up weight [hid, 2
    inter] (the rate the card's library reaches on the product the
    prefill's gate|up phase computes, with the weight dequantized
    beforehand; a yardstick, never called by the port): ms a call and
    TFLOP/s."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    w = (torch.randn((cfg.hidden_size, 2 * cfg.intermediate_size),
                     generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    out = {}
    for S in buckets:
        x = torch.randn((S, cfg.hidden_size), generator=gen,
                        device=dev).to(torch.bfloat16)
        ms = time_ms(torch.matmul, [(x, w)], iters=20)
        out[str(S)] = dict(ms=ms, tflops=2.0 * S * w.numel() / ms / 1e9)
    del w
    return out


def time_prefill(cfg, params, bucket, gen, dev, trace_it):
    """ms per launch of a full bucket (graph replay, CUDA events) beside its
    bound, the port's per-op `prefill_forward` on the same bucket (eager,
    as serving runs it: CUDA events around two calls after a warm-up, and
    the host's wall time) and the plain version (one run, host clock)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    mode = CacheMode.INT8
    plan, packed = pmk_plan_pack(cfg, params, bucket, mode)
    n = bucket
    st = pmk_inputs(cfg, params, plan, mode, n, gen, dev)
    args = (plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
            st["n"], st["cache"])
    row = dict(bucket=bucket, n=n, geometry=pmk.launch_geometry(plan, dev),
               ms=time_ms(pmk.prefill_megakernel, [args], iters=3))
    pmk.check_status(dev)
    if trace_it:
        trace = torch.zeros(pmk.trace_len(plan), dtype=torch.int64,
                            device=dev)
        pmk.prefill_megakernel(*args, trace=trace)
        torch.cuda.synchronize()
        row["phases"] = pmk.phase_times(plan, trace)

    def per_op():
        transformer.prefill_forward(cfg, params, st["tokens"], st["cache"],
                                    st["pages"], 0, n, mode=mode)

    per_op()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    per_op()
    per_op()
    end.record()
    torch.cuda.synchronize()
    row["per_op_wall_ms"] = 1e3 * (time.perf_counter() - t0) / 2
    row["per_op_ms"] = start.elapsed_time(end) / 2
    t0 = time.perf_counter()
    pmk.prefill_megakernel_ref(*args, bf16_scores=True)
    torch.cuda.synchronize()
    row["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    # each input read once, each output written once: the pack, x0, the
    # rope tiles, the K/V rows written (payload + qparams), the logits
    kv_row = cfg.num_kv_heads * (cfg.head_dim + 8)
    nbytes = (plan.weight_bytes + bucket * plan.hid * 2 +
              2 * bucket * plan.D * 2 + 2 * n * kv_row * plan.L + plan.V * 4)
    row.update(weight_bytes=plan.weight_bytes, operations=plan.operations(n),
               **bounds(nbytes, plan.operations(n)))
    if plan.E:      # the experts' rows: the n x k routed (row, expert)
        counts = pmk.kernel_counts(plan, dev)
        row["routed_rows_per_layer"] = counts.sum(1).tolist()
        row["experts_without_rows"] = int((counts == 0).sum())
    print(f"prefill_megakernel S={bucket} n={n}: {row['ms']:.3f} ms/launch, "
          f"bound {max(row['bytes_ms'], row['ops_ms']):.3f} (bytes "
          f"{row['bytes_ms']:.3f}, operations {row['ops_ms']:.3f}), per-op "
          f"prefill_forward {row['per_op_ms']:.3f} (eager; host wall "
          f"{row['per_op_wall_ms']:.3f}), plain {row['plain_ms']:.1f}; grid "
          f"{row['geometry']['grid']}, K splits {row['geometry']['splits']}, "
          f"scratch {row['geometry']['scratch_bytes'] / 1e6:.0f} MB"
          + (f"; the experts over their routed rows only: "
             f"{row['routed_rows_per_layer'][0]} a layer (n x k), the "
             f"routed operations bound {row['ops_ms']:.3f} ms"
             if plan.E else ""), flush=True)
    if trace_it:
        print("  phases, ms work+wait (block 0, one traced launch): "
              + ", ".join(f"{k} {v['work']:.2f}+{v['wait']:.2f}"
                          for k, v in row["phases"].items()), flush=True)
    return row


def bf16_params(params, layers: int):
    """The first `layers` layers of the u4 model with every weight
    dequantized to a bf16 leaf (the unquantized stream, depth cut: 28 layers
    of bf16 weights are 15 GB)."""
    import torch
    from dashinfer_tpu_torch.ops.linear import dequantize_weight

    def leaf(wd, l=None):
        pick = (lambda t: t) if l is None else (lambda t: t[l])
        return dequantize_weight({k: pick(wd[k])
                                  for k in ("w_q", "scale", "zero")})

    out = {"embed_tokens": params["embed_tokens"], "norm": params["norm"],
           "lm_head": {"w": leaf(params["lm_head"])}, "layers": {}}
    for name, node in params["layers"].items():
        if isinstance(node, dict):
            new = {"w": torch.stack([leaf(node, l) for l in range(layers)])}
            if "b" in node:
                new["b"] = node["b"][:layers]
            out["layers"][name] = new
        else:
            out["layers"][name] = node[:layers]
    return out


def check_prefill_megakernel(params, dev, details):
    import dataclasses
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    i8_params = random_qwen2_7b_params(SEED + 1, dev, stream="i8")
    i8_params["embed_tokens"] = params["embed_tokens"]
    cases = []
    for stream, p in (("u4", params), ("i8", i8_params)):
        for mode in (CacheMode.INT8, CacheMode.UINT4, CacheMode.DEFAULT):
            cases.append(check_prefill_case(cfg, p, stream, mode, 128, 100,
                                            gen, dev))
    del i8_params
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    cases.append(check_prefill_case(cfg2, bf16_params(params, 2),
                                    "bf16 (2 layers)", CacheMode.INT8, 128,
                                    100, gen, dev))
    torch.cuda.empty_cache()
    # every other bucket the serving launches (each has K splits and row
    # tiles of its own), at the served prompt lengths and full
    for bucket, n in ((256, 200), (256, 256), (512, 450), (512, 512),
                      (1024, 1000), (1024, 1024)):
        cases.append(check_prefill_case(cfg, params, "u4", CacheMode.INT8,
                                        bucket, n, gen, dev))
    times = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
             for b in (128, 256, 512, 1024)]
    # a launch repeats bit for bit, at a full bucket and a served length
    # (inputs of their own generator)
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    g2 = torch.Generator(device=dev)
    g2.manual_seed(SEED + 47)
    for bucket, n in ((1024, 1024), (128, 100)):
        plan, packed = pmk_plan_pack(cfg, params, bucket, CacheMode.INT8)
        st = pmk_inputs(cfg, params, plan, CacheMode.INT8, n, g2, dev)
        replays_bit_equal(
            f"prefill_megakernel u4/int8 {bucket} n={n}",
            lambda: pmk.prefill_megakernel(
                plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
                st["n"], st["cache"]))
        pmk.check_status(dev)
        del plan, packed, st
    torch.cuda.empty_cache()
    yard = gate_up_yardstick(cfg, dev)
    for t in times:
        if "phases" in t and str(t["bucket"]) in yard:
            y = yard[str(t["bucket"])]
            gu = t["phases"]["gate_up"]["work"] / cfg.num_layers
            print(f"  gate|up at S={t['bucket']}: {gu:.4f} ms a layer in the "
                  f"kernel ({2.0 * t['bucket'] * cfg.hidden_size * 2 * cfg.intermediate_size / gu / 1e9:.0f} "
                  f"TFLOP/s); torch.matmul on the bf16 weight {y['ms']:.4f} ms "
                  f"({y['tflops']:.0f} TFLOP/s, a yardstick)", flush=True)
    details["prefill_megakernel"] = dict(cases=cases, times=times,
                                         gate_up_matmul=yard)
    big = times[-1]
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="bucket 1024, n = 1024", ms=big["ms"],
                plain_ms=big["plain_ms"], library_ms=None,
                per_op_ms=big["per_op_ms"],
                ms_by_bucket={str(t["bucket"]): t["ms"] for t in times},
                gate_up_matmul_ms={k: v["ms"] for k, v in yard.items()},
                bound_ms=max(big["bytes_ms"], big["ops_ms"]),
                bound_by=("bytes" if big["bytes_ms"] >= big["ops_ms"]
                          else "operations"))


def check_prefill_megakernel_moe(cfg, params, dev, details):
    """The prefill megakernel's MoE branch at Qwen1.5-MoE width: one
    prefill of every bucket the MoE serving launches (128 .. 1024, each
    with its own expert batches and K splits) at a served prompt length
    against the plain version, INT8 KV (and UINT4 at bucket 128), a full
    bucket 1024, a prompt of 5 tokens (most experts without a row) and a
    skewed router (one expert in most rows), each with the experts' row
    counts the kernel wrote held to the plain router's; then ms per launch
    of a full bucket beside the routed-operations bound and the per-op
    `prefill_forward`, whose experts run the grouped kernel (the crossover
    that moe_prefill_mega_max_bucket is set from)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    cases = [check_prefill_case(cfg, params, "u4 MoE", mode, 128, 90, gen,
                                dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4)]
    for bucket, n in ((256, 200), (512, 450), (1024, 1000)):
        cases.append(check_prefill_case(cfg, params, "u4 MoE",
                                        CacheMode.INT8, bucket, n, gen, dev))
    # a full bucket 1024 held to the plain version routed as the kernel
    # routed: at this length this random router's near-ties flip more than
    # 5% of the tokens between any tensor-core kernel and the f32 plain
    # version (the every-expert branch too: PERF.md §6), so its tokens
    # routed otherwise are counted, not capped, and each held to be a
    # near-tie or ill-conditioned where it first flips; then a 5-token
    # prompt
    cases.append(check_prefill_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                    1024, 1024, gen, dev, forced=True))
    cases.append(check_prefill_case(cfg, params, "u4 MoE", CacheMode.INT8,
                                    128, 5, gen, dev))
    check(min(sum(r == 0 for r in layer) for layer in cases[-1]
              ["expert_rows"]) >= cfg.moe.num_experts - 5 * cfg.moe
          .num_experts_per_tok, "a 5-token prompt left fewer experts "
          "without rows than it must")
    skew_expert = 7
    skew = skewed_moe_params(params, skew_expert, dev)
    case = check_prefill_case(cfg, skew, "u4 MoE skewed router",
                              CacheMode.INT8, 512, 500, gen, dev)
    share = [layer[skew_expert] / 500 for layer in case["expert_rows"]]
    check(share[0] >= 0.5, f"the skewed router's expert {skew_expert} took "
          f"{share[0]:.2f} of the rows in layer 0, not most")
    print(f"  skewed router: expert {skew_expert} in "
          f"{', '.join(f'{s:.2f}' for s in share)} of the rows by layer",
          flush=True)
    cases.append(case)
    del skew
    times = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
             for b in (128, 256, 512, 1024)]
    details["prefill_megakernel_moe"] = dict(cases=cases, times=times)
    big = times[-1]
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="bucket 1024, n = 1024", ms=big["ms"],
                plain_ms=big["plain_ms"], library_ms=None,
                per_op_ms=big["per_op_ms"],
                ms_by_bucket={str(t["bucket"]): t["ms"] for t in times},
                per_op_ms_by_bucket={str(t["bucket"]): t["per_op_ms"]
                                     for t in times},
                bound_ms=max(big["bytes_ms"], big["ops_ms"]),
                bound_by=("bytes" if big["bytes_ms"] >= big["ops_ms"]
                          else "operations"),
                flipped_tokens=sum(len(c["flipped_tokens"]) for c in cases))


def check_stream_probe(dev, details):
    """csrc/stream_probe.cu through the tool's entry point: every format
    against its plain version, and its rate."""
    from dashinfer_tpu_torch.tools import bench_stream
    bench_stream.counter.reset()
    rows = bench_stream.measure_rates(DECODE_BATCH, dev)
    launches = bench_stream.counter.read()
    rows += bench_stream.measure_rates(32, dev,
                                       formats=("i8_pc", "u4_g128"))
    for r in rows:
        r.update(bounds(r["bytes"], 0 if r["format"] == "copy"
                        else 2.0 * r["B"] * r["K"] * r["N"]))
        print(f"stream_probe {r['format']:8s} B={r['B']:2d} "
              f"{r['bytes'] / 1e6:6.1f} MB err={r['max_abs_err']:.2e} "
              f"ms={r['ms']:.4f} ({r['gbps']:.0f} GB/s) "
              f"bound={r['bytes_ms']:.4f} plain={r['plain_ms']:.3f}"
              + (f"; loads only {r['nodot_ms']:.4f}, dot only "
                 f"{r['noload_ms']:.4f}, compute only "
                 f"{r['computeonly_ms']:.4f}, pipeline only "
                 f"{r['pipeonly_ms']:.4f}" if "nodot_ms" in r else ""),
              flush=True)
        check(r["max_abs_err"] <= KERNEL_RTOL * r["ref_max"],
              f"stream_probe {r['format']} B={r['B']}: max|d| "
              f"{r['max_abs_err']:.3e} vs max|ref| {r['ref_max']:.3e}")
    check(launches > 0, "stream_probe was not launched by measure_rates")
    details["stream_probe"] = rows
    u4 = next(r for r in rows if r["format"] == "u4_g128"
              and r["B"] == DECODE_BATCH)
    # yardstick: one torch.matmul of the same x and a bf16 matrix of the
    # leaf's shape (a dequantized leaf; only the product is timed, as for
    # quant_matmul; 271 MB, so every call reads it from HBM)
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    x = torch.randn((DECODE_BATCH, u4["K"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((u4["K"], u4["N"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    library_ms = time_ms(torch.matmul, [(x, w)], iters=10)
    del w
    print(f"stream_probe u4_g128 B={DECODE_BATCH}: library torch.matmul on "
          f"the bf16 [{u4['K']}, {u4['N']}] leaf {library_ms:.4f} ms",
          flush=True)
    return dict(launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows
                                if r["format"] != "copy"),
                ms=u4["ms"], plain_ms=u4["plain_ms"], library_ms=library_ms,
                bound_ms=max(u4["bytes_ms"], u4["ops_ms"]),
                bound_by="bytes" if u4["bytes_ms"] >= u4["ops_ms"]
                else "operations")


def check_probes(dev, details):
    """csrc/probes.cu through the two tools' entry points: each dequant
    chain's levels exactly equal to the plain version's, its dot within the
    kernels' tolerance, and its time per chunk; each re-layout variant equal
    to the plain version, and its time."""
    from dashinfer_tpu_torch.tools import probe_magic_dequant as pmd
    from dashinfer_tpu_torch.tools import probe_reshape as prs
    out = {}
    pmd.counter.reset()
    rows = pmd.measure(dev)
    launches = pmd.counter.read()
    for r in rows:
        print(f"probe_magic_dequant {r['chain']:9s} exact={r['exact']} dot "
              f"err={r['max_abs_err']:.2e} (ref max {r['ref_max']:.2e}) "
              f"{r['us_per_chunk']:.3f} us/chunk of {pmd.ROWS}x{pmd.HALF} B, "
              f"{r['gbps']:.0f} GB/s of payload; launch {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f}", flush=True)
        check(r["exact"], f"probe_magic_dequant {r['chain']}: levels differ "
              "from the plain version")
        check(r["max_abs_err"] <= KERNEL_RTOL * r["ref_max"],
              f"probe_magic_dequant {r['chain']}: dot max|d| "
              f"{r['max_abs_err']:.3e} vs max|ref| {r['ref_max']:.3e}")
    check(launches > 0, "probe_magic_dequant launched no kernel")
    details["probe_magic_dequant"] = rows
    m16 = next(r for r in rows if r["chain"] == "magic16")
    b = bounds(m16["bytes"], m16["operations"])
    out["probe_magic_dequant"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        shape=f"magic16 chain, {m16['chunks']} chunks", ms=m16["ms"],
        plain_ms=m16["plain_ms"], library_ms=None,
        library_note="no single PyTorch call: unpacking u4 nibbles takes a "
        "shift, a mask and a conversion before the dot",
        us_per_chunk={r["chain"]: r["us_per_chunk"] for r in rows},
        bound_ms=max(b.values()),
        bound_by="bytes" if b["bytes_ms"] >= b["ops_ms"] else "operations")
    prs.counter.reset()
    rows = prs.measure(dev)
    launches = prs.counter.read()
    for r in rows:
        print(f"probe_reshape {r['variant']:5s} equal={r['equal']} "
              f"{1e3 * r['ms']:.2f} us a re-layout of [{prs.B}, "
              f"{prs.H * prs.D}] f32, plain {1e3 * r['plain_ms']:.2f}",
              flush=True)
        check(r["equal"], f"probe_reshape {r['variant']}: differs from the "
              "plain version")
    check(launches > 0, "probe_reshape launched no kernel")
    details["probe_reshape"] = rows
    first = rows[0]
    # yardstick: the one PyTorch call that makes the same layout, F.pad of
    # q.view(B, KH, G, D) with 8 - G zero rows (28 calls in a graph, as the
    # tool times the kernel)
    import torch
    import torch.nn.functional as F
    q = torch.randn((prs.B, prs.H * prs.D), device=dev)
    G = prs.H // prs.KH
    want = prs.relayout_plain(q, prs.KH)
    check(torch.equal(F.pad(q.view(prs.B, prs.KH, G, prs.D),
                            (0, 0, 0, prs.G8 - G)), want),
          "probe_reshape: the F.pad yardstick differs from the plain version")
    library_ms = time_ms(lambda: F.pad(q.view(prs.B, prs.KH, G, prs.D),
                                       (0, 0, 0, prs.G8 - G)), [()], iters=28)
    print(f"probe_reshape library F.pad {1e3 * library_ms:.2f} us a "
          "re-layout", flush=True)
    # the floor of one kernel node in a graph replay (the re-layout of one
    # row, B = 1): a re-layout within twice that floor plus its byte time
    # is at its launch floor
    bound = bounds(first["bytes"], 0)["bytes_ms"]
    at_floor = first["ms"] <= 2 * (first["floor_ms"] + bound)
    print(f"probe_reshape {first['variant']}: {1e3 * first['ms']:.2f} us "
          f"against the launch floor {1e3 * first['floor_ms']:.2f} us (B = 1, "
          f"{first['floor_bytes']} bytes) + {1e3 * bound:.2f} us of bytes: "
          + ("at its launch floor" if at_floor else "above twice its floor"),
          flush=True)
    out["probe_reshape"] = dict(
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        shape=f"variant {first['variant']}", ms=first["ms"],
        plain_ms=first["plain_ms"], library_ms=library_ms,
        us_by_variant={r["variant"]: 1e3 * r["ms"] for r in rows},
        launch_floor_ms=first["floor_ms"], at_launch_floor=at_floor,
        bound_ms=bound, bound_by="bytes")
    return out


def check_decode_logits(params, dev, details):
    """One decode step over DECODE_BATCH prefilled slots through the kernels
    and through their plain versions, on clones of one INT8 cache."""
    import torch
    from dashinfer_tpu_torch.config import CacheConfig, CacheMode, ModelConfig
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    cfg = ModelConfig(**QWEN2_7B)
    mode = CacheMode.INT8
    B, maxP = DECODE_BATCH, 8
    # logical pages 1 .. B*maxP, and the last physical page as the sink
    cache = create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                            (B * maxP + 1) * cfg.num_layers + 1,
                            torch.bfloat16, dev)
    g = torch.Generator().manual_seed(11)
    lens = [37, 64, 150, 300, 1, 127, 256, 500]
    pts = torch.zeros((B, maxP), dtype=torch.int32)
    for b, n in enumerate(lens):
        pts[b] = torch.arange(1 + b * maxP, 1 + (b + 1) * maxP)
        S = 1 << max(5, math.ceil(math.log2(n)))
        toks = torch.zeros(S, dtype=torch.int64)
        toks[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=g)
        transformer.prefill_forward(cfg, params, toks.to(dev), cache,
                                    pts[b].to(dev), 0, n, mode=mode)
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=g).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    out = {}
    for use_kernel in (True, False):
        logits, _ = transformer.decode_forward(
            cfg, params, tokens, cache.clone(), pts.to(dev), lens_t, active,
            mode=mode, use_kernel=use_kernel)
        out[use_kernel] = logits
    torch.cuda.synchronize()
    ref = out[False]
    check(bool(torch.isfinite(out[True]).all()) and
          tuple(out[True].shape) == (B, cfg.vocab_size),
          "decode logits not finite / wrong shape")
    err = (out[True] - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    agree = (out[True].argmax(-1) == ref.argmax(-1)).float().mean().item()
    details["decode_logits"] = dict(max_abs_err=err, ref_max=ref_max,
                                    argmax_agreement=agree, lens=lens)
    print(f"decode logits kernels vs plain: max|d|={err:.3e} "
          f"(ref max {ref_max:.3e}), argmax agreement {agree:.2f}",
          flush=True)
    check(err <= LOGITS_RTOL * ref_max,
          f"decode logits differ: {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")

    # where one decode forward's time goes: host wall per step, and the
    # card's kernel time in it (torch.profiler), by kernel
    def step():
        transformer.decode_forward(cfg, params, tokens, cache, pts.to(dev),
                                   lens_t, active, mode=mode)

    step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3 / n
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    details["decode_step_profile"] = dict(
        batch=B, wall_ms=wall_ms, device_busy_ms=busy_ms or None,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_kernels_ms=top)
    print(f"decode forward (B={B}): wall {wall_ms:.2f} ms/step, device busy "
          + (f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%)"
             if busy_ms else "not measured (no device events)"), flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:90]}", flush=True)


# -- tensor parallelism: the segment kernels and TP serving -----------------

# (ranks n, KV mode) of the segment checks: Qwen2-7B at n = 2 (14 query
# heads on 2 KV heads a rank) and n = 4 (7 on 1; q, k, v, the MLP width and
# the vocab shard are widths of 128 mod 256, which the pack pads)
TP_CASES = ((2, "INT8"), (2, "UINT4"), (4, "INT8"))
TP_RANKS = 2            # the served mesh (1, 2)
# The segments against their plain versions: the partials and the logits of
# the active rows within LOGITS_RTOL of their largest (both sides compute
# the same bf16 products in f32 and differ in the order of the sums), the
# residual after `x += add` equal, the pool by check_written_pool's rules
# (one segment at layer 0 sees the plain version's inputs exactly; at the
# last layer the rows are held to the deeper layers' tolerance). The whole
# TP forward against tp_decode_ref, and against the single-device decode
# megakernel on the same weights and state (its pool the ranks' pools side
# by side), the same way.


def tp_setup(cfg, params, n, mode, gen, dev, B=DECODE_BATCH, lens=None,
             inactive=MK_INACTIVE):
    """The ranks' split, plan, packs and pools of a (1, n) mesh whose ranks
    all run on `dev`, and the step's inputs (mk_state's, one pool a rank
    over its KV heads)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, RuntimeConfigBuilder
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.parallel import make_mesh, shard_params
    mode = getattr(CacheMode, mode) if isinstance(mode, str) else mode
    rt = (RuntimeConfigBuilder("tp").max_length(2048).max_batch(B)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
          .mesh(1, n).build())
    mesh = make_mesh((1, n), [dev] * n)
    parts = shard_params(params, cfg, mesh)
    check(tpk.supports_tp(cfg, rt, params, n, local=parts[0]),
          f"supports_tp said no at n = {n}, {mode.value}")
    plan, packs = tpk.make_tp_plan(cfg, rt, parts)
    check(not tpk.cuda_kernel_gaps(plan), f"tp plan: "
          f"{tpk.cuda_kernel_gaps(plan)}")
    cfg_l = tpk.local_config(cfg, n)
    lens = lens or MK_LENS
    states = [mk_state(cfg_l, mode, B, lens, inactive, gen, dev)
              for _ in range(n)]
    st = states[0]
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    return dict(mode=mode, rt=rt, mesh=mesh, parts=parts, plan=plan,
                packs=packs, st=st, caches=[s["cache"] for s in states],
                x0=x0, cfg_l=cfg_l, lens=lens, inactive=inactive)


def tp_written(s, layers, dev):
    """[pages, ps] rows a step writes at `layers` (the active slots')."""
    import torch
    st, L = s["st"], s["plan"].L
    written = torch.zeros(s["caches"][0].k.shape[:2], dtype=torch.bool,
                          device=dev)
    for b, n in enumerate(s["lens"]):
        if b == s["inactive"]:
            continue
        g, off = int(st["pt"][b, n // PAGE]), n % PAGE
        for l in layers:
            written[g * L + l, off] = True
    return written


def held_rows(got, ref, act, what):
    """Rows `act` (a mask or a slice) of a kernel's output within
    LOGITS_RTOL of its plain version's largest there; returns max|d|."""
    got, ref = got[act], ref[act]
    check(bool(torch_isfinite(got)), f"{what}: not finite")
    err = (got - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    check(err <= LOGITS_RTOL * ref_max,
          f"{what}: differs {err:.3e} > {LOGITS_RTOL} * {ref_max:.3e}")
    return err


def lm_exact(packed, x, n):
    """The lm_head of the bf16 row x [hid] in f64, with no rounding but
    f64's: x . (levels x scale + zero), scale and zero rounded to bf16 as
    both the kernel and the TPU kernel apply them -> [n] f64 (K in blocks
    of 512 rows)."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops.u4pack import weight_levels
    leaf = mk.loader_view(packed["lm_head"])
    xd = x.double()
    if "w" in leaf:
        return (xd @ leaf["w"].to(torch.bfloat16).double())[:n]
    scale = leaf["scale"].to(torch.bfloat16).double()
    zero = leaf["zero"].to(torch.bfloat16).double()
    K = xd.shape[0]
    gs = K // scale.shape[0]
    out = 0
    for k0 in range(0, K, 512):
        g = torch.arange(k0, min(K, k0 + 512), device=xd.device) // gs
        w = weight_levels(leaf["w_q"][k0:k0 + 512]).double() * scale[g] + \
            zero[g]
        out = out + xd[k0:k0 + 512] @ w
    return out[:n]


def lm_row_order(plan, packed, got, dev, what):
    """The device's last lm_head launch (`got`: the logits of the prefill
    megakernel or of a TP lm segment of `plan`) against `lm_row_ref` on the
    row it normed, within ORDER_RTOL of the largest there. Read beside it,
    not held: the kernel's and the TPU kernel's weight-side form's distance
    from the f64 product of that row (`lm_exact`). Returns (max|d| over the
    ORDER tolerance, the kernel's and the weight-side form's distance from
    the f64 product over the logits tolerance)."""
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    x = pmk.kernel_x_last(plan, dev)
    ref = pmk.lm_row_ref(plan, packed, x)
    err = (got - ref).abs().max().item()
    tol = ORDER_RTOL * ref.abs().max().item()
    check(err <= tol, f"{what}: the lm_head differs from its own rounding "
          f"on its own row by {err:.3e} > {ORDER_RTOL} * max|ref|")
    ex = lm_exact(packed, x, got.numel())
    wside = pmk._wdeq_dot(x[None], packed, plan.lm, None)[0]
    ex_tol = LOGITS_RTOL * ex.abs().max().item()
    return (err / tol, (got.double() - ex).abs().max().item() / ex_tol,
            (wside.double() - ex).abs().max().item() / ex_tol)


def torch_isfinite(t):
    import torch
    return torch.isfinite(t).all()


def check_argmax(got, ref, act, err, what):
    pick = got[act].argmax(-1)
    tie = ref[act].max(-1).values - ref[act].gather(1, pick[:, None])[:, 0]
    check(bool((tie <= 2 * err).all()), f"{what}: argmax differs")
    return int((pick == ref[act].argmax(-1)).sum().item())


def check_tp_segment_case(cfg, params, n, mode, gen, dev, timing,
                          deep_values=False):
    """Each segment kernel of every rank against its plain version, the
    whole TP forward against tp_decode_ref and against the single-device
    decode megakernel; with `timing`, ms per launch and per step;
    `deep_values`: the whole forwards' pool rows past layer 0 held by the
    MoE rule (zero-mean weights: the note after MOE_DEEP_RTOL)."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = tp_setup(cfg, params, n, mode, gen, dev)
    plan, packs, st, caches = s["plan"], s["packs"], s["st"], s["caches"]
    mode, L, B = s["mode"], plan.L, plan.B
    what0 = f"tp n={n} {mode.value}"
    act = st["active"]
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 17 + n)
    errs = dict(attn=0.0, mlp=0.0, lm=0.0)
    for r in range(n):
        add = torch.randn((B, plan.hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            x = s["x0"].float()
            xs = {True: x.clone(), False: x.clone()}
            cs = {True: caches[r].clone(), False: caches[r].clone()}
            out = {True: tpk.tp_attn_segment(plan, packs[r], l, xs[True],
                                             *step, cs[True], add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.attn_segment_ref(plan, packs[r], l, xs[False],
                                              *step, cs[False], add=add)
            what = f"{what0} attn rank {r} layer {l}"
            check(bool((xs[True] == xs[False]).all()),
                  f"{what}: x + add differs")
            errs["attn"] = max(errs["attn"], held_rows(out[True], out[False],
                                                       act, what))
            check_written_pool(what, mode, cs[True], cs[False], caches[r],
                               tp_written(s, (l,), dev), L, dev)
            xs = {True: x.clone(), False: x.clone()}
            out = {True: tpk.tp_mlp_segment(plan, packs[r], l, xs[True],
                                            add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.mlp_segment_ref(plan, packs[r], l, xs[False],
                                             add=add)
            errs["mlp"] = max(errs["mlp"], held_rows(
                out[True], out[False], act, f"{what0} mlp rank {r} layer {l}"))
        xs = {True: s["x0"].float(), False: s["x0"].float()}
        out = {True: tpk.tp_lm_segment(plan, packs[r], xs[True], add=add)}
        tpk.check_status(plan, dev)
        out[False] = tpk.lm_segment_ref(plan, packs[r], xs[False], add=add)
        check(tuple(out[True].shape) == (B, cfg.vocab_size // n),
              f"{what0}: lm shard {tuple(out[True].shape)}")
        errs["lm"] = max(errs["lm"], held_rows(out[True], out[False], act,
                                               f"{what0} lm rank {r}"))
    # the whole forward: CUDA-graph replay of the kernels' forward, against
    # the plain forward and the single-device megakernel on clones of the
    # pools
    torch.cuda.synchronize()
    devices = s["mesh"].devices
    ck = [c.clone() for c in caches]
    cp = [c.clone() for c in caches]

    def fwd():
        return tpk.tp_decode(plan, packs, s["x0"], *step, ck, devices)

    fwd()                           # warm-up: the same writes
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_k = fwd()
    graph.replay()
    tpk.check_status(plan, dev)
    logits_p = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cp, devices)
    torch.cuda.synchronize()
    what = f"{what0} forward"
    f_err = held_rows(logits_k, logits_p, act, what)
    same = check_argmax(logits_k, logits_p, act, f_err, what)
    written = tp_written(s, range(L), dev)
    for r in range(n):
        check_written_pool(f"{what} rank {r}", mode, ck[r], cp[r], caches[r],
                           written, L, dev, moe=deep_values)
    # the single-device megakernel on the same weights and state: its pool
    # holds every KV head, the ranks' side by side
    plan1, pack1 = mk_plan_pack(cfg, params, B, mode)
    before1 = full_pool(caches)
    c1 = before1.clone()
    logits_1 = mk.decode_megakernel(plan1, pack1, s["x0"], *step, c1)
    mk.check_status(plan1, dev)
    what = f"{what0} forward vs the single-device megakernel"
    m_err = held_rows(logits_k, logits_1, act, what)
    m_same = check_argmax(logits_k, logits_1, act, m_err, what)
    check_written_pool(what, mode, full_pool(ck), c1, before1, written, L,
                       dev, moe=deep_values)
    row = dict(n=n, mode=mode.value, errs=errs, forward_err=f_err,
               forward_argmax_equal=same, vs_megakernel_err=m_err,
               vs_megakernel_argmax_equal=m_same,
               geometry=tpk.launch_geometry(plan, dev))
    print(f"{what0}: segments max|d| attn {errs['attn']:.3e} mlp "
          f"{errs['mlp']:.3e} lm {errs['lm']:.3e}; forward (graph replay) "
          f"vs plain {f_err:.3e} (argmax equal {same}/{int(act.sum())}), vs "
          f"the single-device megakernel {m_err:.3e} ({m_same}); pools "
          f"held; geometry {row['geometry']}", flush=True)
    if timing:
        row.update(tp_timing(cfg, s, plan1, pack1, c1, step, dev))
    del graph, ck, cp, c1, before1
    return row


# the mlp segment beyond TP_CASES: B = 32 (its two-m-tile instantiation;
# a (1, 2) mesh, INT8 KV), and the per-channel int8 and the bf16 (two
# layers) weight streams at B = 8: its 8- and 16-bit products
TP_MLP_B32_LENS = [(37 + 61 * i) % 1500 + 1 for i in range(32)]


def check_tp_mlp_cases(cfg, params, gen, dev):
    """The mlp segment of every rank at its first and last layer against its
    plain version (the partial <= LOGITS_RTOL of its largest in the active
    rows, x + add equal), at B = 32 and on the int8 and bf16 streams; at
    B = 32 also two graph replays and an eager launch bit-equal."""
    import dataclasses
    import torch
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    rows = []
    for stream, B, scfg, make in (
            ("u4", 32, cfg, lambda: params),
            ("i8", 8, cfg, lambda: dict(
                random_qwen2_7b_params(SEED + 1, dev, stream="i8"),
                embed_tokens=params["embed_tokens"])),
            ("bf16 (2 layers)", 8, dataclasses.replace(cfg, num_layers=2),
             lambda: bf16_params(params, 2))):
        p = make()
        s = tp_setup(scfg, p, 2, "INT8", gen, dev, B=B,
                     lens=TP_MLP_B32_LENS if B == 32 else None)
        plan, act = s["plan"], s["st"]["active"]
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 43 + B)
        err = 0.0
        for r in range(2):
            add = torch.randn((B, plan.hid), generator=g, device=dev) * 0.5
            for l in (0, plan.L - 1):
                x = s["x0"].float()
                xs = {True: x.clone(), False: x.clone()}
                got = tpk.tp_mlp_segment(plan, s["packs"][r], l, xs[True],
                                         add=add)
                tpk.check_status(plan, dev)
                ref = tpk.mlp_segment_ref(plan, s["packs"][r], l, xs[False],
                                          add=add)
                what = f"tp_mlp_segment n=2 {stream} B={B} rank {r} layer {l}"
                check(bool((xs[True] == xs[False]).all()),
                      f"{what}: x + add differs")
                err = max(err, held_rows(got, ref, act, what))
        if B == 32:
            x = s["x0"].float()
            replays_bit_equal(f"tp_mlp_segment n=2/int8 {stream} B={B}",
                              lambda: tpk.tp_mlp_segment(
                                  plan, s["packs"][0], 0, x))
            tpk.check_status(plan, dev)
        print(f"tp_mlp_segment n=2 {stream} B={B}: max|d| {err:.3e} (every "
              "rank, first and last layer)", flush=True)
        rows.append(dict(stream=stream, B=B, err=err))
        del s, p, plan, act
        torch.cuda.empty_cache()
    return rows


def tp_moe_bound(plan, act, dev):
    """(bytes, operations) of rank 0's last moe segment launch of layer 0:
    the global router, the rank's experts that its active rows routed to
    (its routing record), its shared slice, x, the partial."""
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    routed = tpk.kernel_routing(plan, dev, 0)[0]
    rows_of = [int(((routed == e) & act[:, None]).any(-1).sum())
               for e in range(plan.E)]          # rank 0's group: 0 .. E - 1
    shared = [sp for sp in (plan.sgu, plan.sdn) if sp is not None]
    ex = (plan.gu, plan.dn)
    nbytes = plan.rt.matrix_bytes + sum(sp.matrix_bytes for sp in shared) + \
        sum(c > 0 for c in rows_of) * sum(sp.matrix_bytes for sp in ex)
    ops = 2 * plan.B * sum(sp.K * sp.Ntot for sp in [plan.rt] + shared) + \
        2 * sum(rows_of) * sum(sp.K * sp.Ntot for sp in ex)
    return nbytes, ops, sum(c > 0 for c in rows_of)


def tp_timing(cfg, s, plan1, pack1, c1, step, dev):
    """ms per launch of each segment (rank 0, layer 0; graph replay, CUDA
    events) beside its bound and its plain version's time, and ms per step
    of the TP forward beside the single-device megakernel's, the ranks on
    one card. A MoE plan's moe segment is bound by the bytes its timed
    launches' rows route to (`tp_moe_bound`), its forward by the routed
    experts of each layer."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    plan, pk, cache = s["plan"], s["packs"][0], s["caches"][0]
    B, L, n = plan.B, plan.L, s["mesh"].n
    x = s["x0"].float()
    lens, act = s["lens"], [i != s["inactive"] for i in range(B)]
    kv = kv_bytes_read(s["cfg_l"], s["mode"], lens, act) / L
    io = 2 * B * plan.hid * 4
    segs = {
        "attn": (lambda: tpk.tp_attn_segment(plan, pk, 0, x, *step, cache),
                 lambda: tpk.attn_segment_ref(plan, pk, 0, x.clone(), *step,
                                              cache.clone()),
                 plan.qkv.matrix_bytes + plan.o.matrix_bytes + kv + io,
                 2 * B * (plan.qkv.K * plan.qkv.Ntot + plan.o.K *
                          plan.o.Ntot) +
                 4 * plan.H * plan.D * sum(n_ for n_, a in zip(lens, act)
                                           if a))}
    if plan.E:
        active = s["st"]["active"]
        segs["moe"] = (
            lambda: tpk.tp_moe_segment(plan, pk, 0, x, 0, active),
            lambda: tpk.moe_segment_ref(plan, pk, 0, x.clone(), 0), None,
            None)
    else:
        segs["mlp"] = (
            lambda: tpk.tp_mlp_segment(plan, pk, 0, x),
            lambda: tpk.mlp_segment_ref(plan, pk, 0, x.clone()),
            plan.gu.matrix_bytes + plan.dn.matrix_bytes + io,
            2 * B * (plan.gu.K * plan.gu.Ntot + plan.dn.K * plan.dn.Ntot))
    segs["lm"] = (lambda: tpk.tp_lm_segment(plan, pk, x),
                  lambda: tpk.lm_segment_ref(plan, pk, x.clone()),
                  plan.lm.matrix_bytes + B * plan.hid * 4 + B * plan.V * 4,
                  2 * B * plan.lm.K * plan.lm.Ntot)
    traced = {"attn": (tpk.ATTN_SEG_PHASES, lambda t: tpk.tp_attn_segment(
        plan, pk, 0, x, *step, cache, trace=t))}
    if plan.E:
        traced["moe"] = (tpk.MOE_SEG_PHASES, lambda t: tpk.tp_moe_segment(
            plan, pk, 0, x, 0, s["st"]["active"], trace=t))
    else:
        traced["mlp"] = (tpk.MLP_SEG_PHASES, lambda t: tpk.tp_mlp_segment(
            plan, pk, 0, x, trace=t))
    out = {}
    for name, (fn, plain, nbytes, ops) in segs.items():
        ms = time_ms(fn, [()], iters=20)
        if name == "moe":
            nbytes, ops, routed = tp_moe_bound(plan, s["st"]["active"], dev)
            nbytes += io
        tpk.check_status(plan, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        b = bounds(nbytes, ops)
        out[name] = dict(ms=ms, plain_ms=1e3 * (time.perf_counter() - t0),
                         bound_ms=max(b["bytes_ms"], b["ops_ms"]),
                         bound_by=("bytes" if b["bytes_ms"] >= b["ops_ms"]
                                   else "operations"),
                         weight_bytes=nbytes - io, **b)
        if name == "moe":
            out[name]["experts_routed"] = routed
        print(f"  tp_{name}_segment (n={n}, rank 0, ranks on one card, "
              f"B={B}): {ms:.4f} ms a launch, bound "
              f"{out[name]['bound_ms']:.4f} ({out[name]['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB" + (
                  f": the router, {routed} of the rank's {plan.E} experts, "
                  "the shared slice" if name == "moe" else "") +
              f"), plain {out[name]['plain_ms']:.1f} ms", flush=True)
        if name in traced:      # block 0's phases in one launch
            names, run = traced[name]
            trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                                device=dev)
            run(trace)
            tpk.check_status(plan, dev)
            out[name]["phases"] = mk.phase_times_of(names, trace)
            print(f"    phases, ms work+wait (block 0, one traced launch): "
                  + ", ".join(f"{k} {v['work']:.4f}+{v['wait']:.4f}"
                              for k, v in out[name]["phases"].items()),
                  flush=True)
    devices = s["mesh"].devices
    caches = s["caches"]
    tp_ms = time_ms(lambda: tpk.tp_decode(plan, s["packs"], s["x0"], *step,
                                          caches, devices), [()], iters=3)
    tpk.check_status(plan, dev)
    mk_ms = time_ms(lambda: mk.decode_megakernel(plan1, pack1, s["x0"], *step,
                                                 c1), [()], iters=3)
    mk.check_status(plan1, dev)
    if plan.E:      # the experts some active row routes to in each layer
        am = s["st"]["active"]
        used = [len(set(r_[am].flatten().tolist()))
                for r_ in tpk.kernel_routing(plan, dev, 0)]
        fwd_bytes = int(sum(plan1.layer_bytes(u) for u in used) +
                        plan1.lm.matrix_bytes)
    else:
        fwd_bytes = n * (L * plan.layer_bytes() + plan.lm.matrix_bytes)
    fwd_bytes += kv_bytes_read(cfg, s["mode"], lens, act)
    print(f"  TP forward (n={n}, the ranks on one card, B={B}): {tp_ms:.3f} "
          f"ms/step ({L * (1 + 1) * n + n} segment launches); single-device "
          f"megakernel {mk_ms:.3f} ms/step; one card's "
          f"{'routed ' if plan.E else ''}byte bound for the whole step "
          f"{1e3 * fwd_bytes / HBM_BYTES_PER_S:.3f} ms", flush=True)
    return dict(segments=out, tp_forward_ms=tp_ms, megakernel_ms=mk_ms,
                forward_bound_ms=1e3 * fwd_bytes / HBM_BYTES_PER_S)


def check_tp_segments(params, dev, details):
    import torch
    from dashinfer_tpu_torch.config import ModelConfig
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    rows = []
    for i, (n, mode) in enumerate(TP_CASES):
        rows.append(check_tp_segment_case(cfg, params, n, mode, gen, dev,
                                          timing=i == 0))
        torch.cuda.empty_cache()
    # the attn segment's epilogue and merge tickets go back to 0; the mlp
    # segment repeats bit for bit
    s = tp_setup(cfg, params, 2, "INT8", gen, dev)
    st, x = s["st"], s["x0"].float()
    replays_bit_equal("tp_attn_segment n=2/int8", lambda: tpk.tp_attn_segment(
        s["plan"], s["packs"][0], 0, x, st["cos"], st["sin"], st["pt"],
        st["lens"], st["active"], s["caches"][0]))
    replays_bit_equal("tp_mlp_segment n=2/int8", lambda: tpk.tp_mlp_segment(
        s["plan"], s["packs"][0], 0, x))
    tpk.check_status(s["plan"], dev)
    lm_library_ms = lm_matmul_yardstick(s["plan"], s["packs"][0], x)
    print(f"  tp_lm_segment's yardstick (torch.matmul of the {s['plan'].B} "
          f"normed bf16 rows by the rank's bf16 [{s['plan'].hid}, "
          f"{s['plan'].lm.Nptot}] shard, cold): {lm_library_ms:.4f} ms",
          flush=True)
    del s, st, x
    torch.cuda.empty_cache()
    mlp_rows = check_tp_mlp_cases(cfg, params, gen, dev)
    details["tp_segments"] = rows
    details["tp_mlp_segment_cases"] = mlp_rows
    t = rows[0]["segments"]
    err = {k: max(r["errs"][k] for r in rows) for k in ("attn", "mlp", "lm")}
    err["mlp"] = max([err["mlp"]] + [r["err"] for r in mlp_rows])
    return {f"tp_{k}_segment": dict(
        max_abs_err=err[k], ms=t[k]["ms"],
        plain_ms=t[k]["plain_ms"], bound_ms=t[k]["bound_ms"],
        bound_by=t[k]["bound_by"],
        library_ms=lm_library_ms if k == "lm" else None)
        for k in ("attn", "mlp", "lm")}


def tp_devices(dev):
    """The served mesh's ranks: distinct cards when the machine has as many,
    else every rank on `dev`."""
    import torch
    if torch.cuda.device_count() >= TP_RANKS:
        return [torch.device("cuda", i) for i in range(TP_RANKS)]
    return [dev] * TP_RANKS


def check_serving_tp(params, dev, details, single_tokens):
    """Qwen2-7B on a (1, 2) mesh with serve()'s traffic: every flag at its
    default (decode through the TP segments, the prefills of buckets 128 ..
    1024 through the TP prefill segments), with DI_PREFILL_MEGAKERNEL=0
    (every prefill per-op TP: the serving before the TP prefill segments,
    side by side in one run) and per-op (24 tokens a request); the greedy
    requests' first 8 tokens equal to the single-device serving's on the
    same path (the megakernels' for the first two)."""
    import torch
    from dashinfer_tpu_torch.parallel import collective_kind
    devices = tp_devices(dev)
    print(json.dumps({"tp": {"ranks": TP_RANKS,
                             "cards": torch.cuda.device_count(),
                             "collective": collective_kind(devices)}}),
          flush=True)
    out = {}
    for path, new_tokens in (("tp", 64), ("tp prefill per-op", 64),
                             ("tp per-op", 24)):
        launches, tokens, _ = serve(params, dev, details, path, new_tokens,
                                    devices=devices)
        ref = single_tokens["per-op" if path == "tp per-op"
                            else "megakernel"]
        details[f"greedy_agreement_{path}"] = agree_first(
            tokens, ref, f"{path} and single-device serving")
        out[path] = launches
    summary = {}
    for path in ("tp", "tp prefill per-op"):
        reqs = details[f"serving_qwen2-7b_{path}"]["requests"]
        steps = [r["decode_ms_per_step"] for r in reqs]
        summary[path] = dict(ttft_ms=max(r["ttft_ms"] for r in reqs),
                             ms_per_step=(min(steps), max(steps)))
        print(f"qwen2-7b {path}: TTFT (the six prompts together) "
              f"{summary[path]['ttft_ms']:.1f} ms, decode "
              f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    details["tp_serving_summary"] = summary
    torch.cuda.empty_cache()
    return out


# -- the TP prefill segments --------------------------------------------------

# (ranks, KV mode, (bucket, prompt length) cases): every bucket the serving
# launches at a served length and full for n = 2 with INT8 KV, the smallest
# and the largest bucket with UINT4 and for n = 4 (q 896, k / v 128, MLP
# 4736, vocab 38016: widths of 128 mod 256, padded in the pack)
TP_PREFILL_CASES = (
    (2, "INT8", ((128, 100), (128, 128), (256, 200), (256, 256),
                 (512, 450), (512, 512), (1024, 1000), (1024, 1024))),
    (2, "UINT4", ((128, 100), (1024, 1024))),
    (4, "INT8", ((128, 100), (1024, 1000))))
# the per-channel int8 stream (the u4 -> i8 rule's leaves) and the bf16 one
# (two layers deep) on a (1, 2) mesh with INT8 KV: the segments' 8- and
# 16-bit products at the smallest and the largest bucket
TP_PREFILL_STREAM_CASES = ((128, 100), (1024, 1024))
TP_PREFILL_BUCKETS = (128, 256, 512, 1024)
# The prefill segments against their plain versions run with the kernel's
# bf16 score operands: the o / down partials of the prompt rows and the
# local logits within LOGITS_RTOL of their largest; x + add equal in the
# prompt rows; the kernel's partial zero in the rows after the last row
# tile that holds a prompt row; the pool by check_prefill_pool's rules (the
# plain version with f32 scores beside it for the ill-conditioned rows): a
# segment at layer 0 to the layer-0 bounds, one at the last layer to the
# deeper layers'. The whole TP prefill against tp_prefill_ref, and against
# the single-device prefill megakernel on the same weights and prompt (its
# pool the ranks' pools side by side), by check_prefill_case's rules.


def tp_prefill_rt(n, mode):
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    b = (RuntimeConfigBuilder("tpp").max_length(2048).max_batch(DECODE_BATCH)
         .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16"))
    return (b.mesh(1, n) if n > 1 else b).build()


def tp_prefill_setup(cfg, params, n, dev, stream="u4"):
    """The ranks' split trees, the TP decode plan and one pack a rank of a
    (1, n) mesh whose ranks all run on `dev`; the buckets the runtime's TP
    prefill install admits for this model must be 128 .. 1024. `stream`
    names the weights' payload in the checks' messages."""
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.parallel import make_mesh, shard_params
    mesh = make_mesh((1, n), [dev] * n)
    parts = shard_params(params, cfg, mesh)
    rt = tp_prefill_rt(n, CacheMode.INT8)
    tp_plan, packs = tpk.make_tp_plan(cfg, rt, parts)
    qual = [b for b in TP_PREFILL_BUCKETS if tpk.supports_prefill_tp(
        cfg, rt, params, b, n, local=parts[0])]
    plans = tpk.make_tp_prefill_plans(cfg, rt, parts, qual, tp_plan)
    gaps = {b: tpk.prefill_cuda_kernel_gaps(p) for b, p in plans.items()}
    check(qual == list(TP_PREFILL_BUCKETS) and not any(gaps.values()),
          f"tp prefill n={n}: the install would prefill buckets {qual} "
          f"through the segments (gaps {gaps}), not 128 .. 1024")
    return dict(n=n, mesh=mesh, parts=parts, tp_plan=tp_plan, packs=packs,
                cfg_l=tpk.local_config(cfg, n), stream=stream)


def tp_prefill_inputs(cfg, params, s, plan, mode, n_tok, gen, dev):
    """pmk_inputs' prompt, pages and RoPE tiles, and one random pool a rank
    over its KV heads."""
    ranks = [pmk_inputs(s["cfg_l"], params, plan, mode, n_tok, gen, dev)
             for _ in range(s["n"])]
    st = ranks[0]
    st["caches"] = [r["cache"] for r in ranks]
    return st


def prompt_written(cache, pages, n, L, layers, dev):
    """[pages, ps] rows a prefill of n tokens writes at `layers`."""
    import torch
    written = torch.zeros(cache.k.shape[:2], dtype=torch.bool, device=dev)
    for j, g in enumerate(pages.tolist()):
        rows = min(PAGE, n - j * PAGE)
        if rows > 0:
            for l in layers:
                written[g * L + l, :rows] = True
    return written


def full_pool(caches):
    """The ranks' pools side by side: the single-device pool's layout."""
    import torch
    from dashinfer_tpu_torch.runtime.kv_cache import KVCache

    def cat(name):
        ts = [getattr(c, name) for c in caches]
        if ts[0] is None:
            return None
        return torch.cat(ts, dim=1 if name.endswith("qparams") else 2)
    return KVCache(*(cat(nm) for nm in ("k", "v", "k_qparams", "v_qparams")))


def check_tp_prefill_case(cfg, params, s, single, mode_name, bucket, n_tok,
                          gen, dev):
    """Each prefill segment kernel of every rank against its plain version
    (layers 0 and L - 1), the whole TP prefill against tp_prefill_ref and
    against the single-device prefill megakernel (`single`: its decode
    plan and pack on the same weights)."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    mode = getattr(CacheMode, mode_name)
    n, cfg_l = s["n"], s["cfg_l"]
    rt = tp_prefill_rt(n, mode)
    plan = tpk.make_tp_prefill_plans(cfg, rt, s["parts"], [bucket],
                                     s["tp_plan"])[bucket]
    st = tp_prefill_inputs(cfg, params, s, plan, mode, n_tok, gen, dev)
    S, L, hid = plan.S, plan.L, plan.hid
    rows = -(-n_tok // 128) * 128
    step = (st["cos"], st["sin"], st["page_row"], st["n"])
    what0 = (f"tp prefill n={n} {s['stream']} {mode.value} S={bucket} "
             f"n_tok={n_tok}")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31 + bucket + n)
    errs = dict(attn=0.0, mlp=0.0, lm=0.0)
    lm_margin = 0.0
    lm_order = (0.0, 0.0, 0.0)
    pool0 = {}
    for r in range(n):
        pk = s["packs"][r]
        add = torch.randn((S, hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            what = f"{what0} attn rank {r} layer {l}"
            x = st["x0"].float()
            xs = {k: x.clone() for k in ("k", "p", "p32")}
            cs = {k: st["caches"][r].clone() for k in xs}
            out = {"k": tpk.tp_prefill_attn_segment(
                plan, pk, l, xs["k"], *step, cs["k"], add=add)}
            tpk.check_prefill_status(dev)
            for k, bf in (("p", True), ("p32", False)):
                out[k] = tpk.prefill_attn_segment_ref(
                    plan, pk, l, xs[k], *step, cs[k], add=add,
                    bf16_scores=bf)
            check(bool((xs["k"][:rows] == xs["p"][:rows]).all()),
                  f"{what}: x + add differs")
            check(not bool(out["k"][rows:].any()),
                  f"{what}: rows past the prompt's last row tile not zero")
            errs["attn"] = max(errs["attn"], held_rows(
                out["k"], out["p"], slice(0, n_tok), what))
            res = check_prefill_pool(
                what, mode, cs["k"], cs["p"], cs["p32"], st["caches"][r],
                prompt_written(cs["k"], st["pages"], n_tok, L, (l,), dev),
                cfg_l, dev)
            if l == 0:
                pool0[r] = res[:2]
            xs = {k: x.clone() for k in ("k", "p")}
            out = {"k": tpk.tp_prefill_mlp_segment(plan, pk, l, xs["k"],
                                                   st["n"], add=add)}
            tpk.check_prefill_status(dev)
            out["p"] = tpk.prefill_mlp_segment_ref(plan, pk, l, xs["p"],
                                                   st["n"], add=add)
            what = f"{what0} mlp rank {r} layer {l}"
            check(bool((xs["k"][:rows] == xs["p"][:rows]).all()),
                  f"{what}: x + add differs")
            check(not bool(out["k"][rows:].any()),
                  f"{what}: rows past the prompt's last row tile not zero")
            errs["mlp"] = max(errs["mlp"], held_rows(
                out["k"], out["p"], slice(0, n_tok), what))
        xs = {k: st["x0"].float() for k in ("k", "p")}
        lg = {"k": tpk.tp_prefill_lm_segment(plan, pk, xs["k"], st["n"],
                                             add=add)}
        tpk.check_prefill_status(dev)
        what = f"{what0} lm rank {r}"
        lm_order = tuple(map(max, lm_order, lm_row_order(plan, pk, lg["k"],
                                                         dev, what)))
        lg["p"] = tpk.prefill_lm_segment_ref(plan, pk, xs["p"], st["n"],
                                             add=add)
        check(tuple(lg["k"].shape) == (cfg.vocab_size // n,),
              f"{what}: shard {tuple(lg['k'].shape)}")
        check(bool((xs["k"][n_tok - 1] == xs["p"][n_tok - 1]).all()),
              f"{what}: x + add differs in row n - 1")
        err = held_rows(lg["k"][None], lg["p"][None], slice(0, 1), what)
        errs["lm"] = max(errs["lm"], err)
        lm_margin = max(lm_margin,
                        err / (LOGITS_RTOL * lg["p"].abs().max().item()))
    # the whole prefill, on clones of the ranks' pools
    devices = s["mesh"].devices
    cs = {k: [c.clone() for c in st["caches"]] for k in ("k", "p", "p32")}
    args = (plan, s["packs"], st["x0"], *step)
    logits = {"k": tpk.tp_prefill(*args, cs["k"], devices)}
    tpk.check_prefill_status(dev)
    logits["p"] = tpk.tp_prefill_ref(*args, cs["p"], devices,
                                     bf16_scores=True)
    logits["p32"] = tpk.tp_prefill_ref(*args, cs["p32"], devices)
    torch.cuda.synchronize()
    what = f"{what0} whole prefill"
    f_err = held_rows(logits["k"][None], logits["p"][None], slice(0, 1),
                      what)
    pick = int(logits["k"].argmax())
    check(float(logits["p"].max() - logits["p"][pick]) <= 2 * f_err,
          f"{what}: argmax differs")
    written = prompt_written(cs["k"][0], st["pages"], n_tok, L, range(L),
                             dev)
    ill = 0
    for r in range(n):
        ill += check_prefill_pool(f"{what} rank {r}", mode, cs["k"][r],
                                  cs["p"][r], cs["p32"][r], st["caches"][r],
                                  written, cfg_l, dev)[3]
    # the single-device prefill megakernel on the same weights and prompt
    plan1 = pmk.make_prefill_plan(cfg, tp_prefill_rt(1, mode), params,
                                  bucket, decode_plan=single["dplan"])
    before1 = full_pool(st["caches"])
    c1 = before1.clone()
    logits1 = pmk.prefill_megakernel(plan1, single["pack"], st["x0"], *step,
                                     c1)
    pmk.check_status(dev)
    what = f"{what0} whole prefill vs the single-device prefill megakernel"
    m_err = held_rows(logits["k"][None], logits1[None], slice(0, 1), what)
    check(float(logits1.max() - logits1[pick]) <= 2 * m_err,
          f"{what}: argmax differs")
    m_pool = check_prefill_pool(what, mode, full_pool(cs["k"]), c1,
                                full_pool(cs["p32"]), before1, written, cfg,
                                dev)
    row = dict(n=n, stream=s["stream"], mode=mode.value, bucket=bucket,
               n_tokens=n_tok,
               errs=errs, lm_margin=lm_margin, lm_row_order=lm_order[0],
               lm_exact_kernel=lm_order[1],
               lm_exact_weight_side=lm_order[2],
               layer0_pool=pool0, whole_err=f_err,
               whole_ref_max=logits["p"].abs().max().item(),
               whole_ill_conditioned=ill, vs_megakernel_err=m_err,
               vs_megakernel_pool=m_pool[:4],
               geometry=tpk.prefill_launch_geometry(plan, dev))
    print(f"{what0}: segments max|d| attn {errs['attn']:.3e} mlp "
          f"{errs['mlp']:.3e} lm {errs['lm']:.3e} ({lm_margin:.3f} of the "
          f"tolerance; against its own rounding {lm_order[0]:.3f} of "
          f"{ORDER_RTOL}; from the f64 product: the kernel "
          f"{lm_order[1]:.4f}, the weight-side form {lm_order[2]:.4f} of "
          f"the tolerance); whole prefill vs plain "
          f"{f_err:.3e} (ref max {row['whole_ref_max']:.3e}), vs the "
          f"single-device prefill megakernel {m_err:.3e}; pools held "
          f"({ill} ill-conditioned (row, head) pairs); geometry "
          f"{row['geometry']}", flush=True)
    return row, (plan, plan1, st)


def tp_prefill_timing(cfg, params, s, single, case, dev):
    """ms per launch of each prefill segment (rank 0, layer 0, a full
    bucket; graph replay, CUDA events) beside its bound and its plain
    version's time; the whole TP prefill by graph replay (device) and
    eagerly (host wall: what serving pays) beside the single-device
    prefill megakernel and the per-op TP prefill on the same prompt."""
    import torch
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    plan, plan1, st = case
    n, S, L = s["n"], plan.S, plan.L
    n_tok = int(st["n"].item())
    pk, cache = s["packs"][0], st["caches"][0]
    step = (st["cos"], st["sin"], st["page_row"], st["n"])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 41)
    x = st["x0"].float()
    add = torch.randn((S, plan.hid), generator=g, device=dev) * 0.5
    io = 3 * S * plan.hid * 4      # x read and written, add read
    kv = 2 * n_tok * plan.KH * ({8: plan.D + 8, 4: plan.D // 2 + 8}.get(
        plan.kv_bits, 2 * plan.D))
    attn_ops = 2 * n_tok * (plan.qkv.K * plan.qkv.Ntot + plan.o.K *
                            plan.o.Ntot) + \
        2.0 * plan.H * plan.D * n_tok * (n_tok + 1)
    segs = {
        "attn": (lambda: tpk.tp_prefill_attn_segment(plan, pk, 0, x, *step,
                                                     cache, add=add),
                 lambda: tpk.prefill_attn_segment_ref(
                     plan, pk, 0, x.clone(), *step, cache.clone(), add=add,
                     bf16_scores=True),
                 plan.qkv.matrix_bytes + plan.o.matrix_bytes + io + kv +
                 S * plan.hid * 4 + 2 * S * plan.D * 2, attn_ops),
        "mlp": (lambda: tpk.tp_prefill_mlp_segment(plan, pk, 0, x, st["n"],
                                                   add=add),
                lambda: tpk.prefill_mlp_segment_ref(plan, pk, 0, x.clone(),
                                                    st["n"], add=add),
                plan.gu.matrix_bytes + plan.dn.matrix_bytes + io +
                S * plan.hid * 4,
                2 * n_tok * (plan.gu.K * plan.gu.Ntot + plan.dn.K *
                             plan.dn.Ntot)),
        "lm": (lambda: tpk.tp_prefill_lm_segment(plan, pk, x, st["n"],
                                                 add=add),
               lambda: tpk.prefill_lm_segment_ref(plan, pk, x.clone(),
                                                  st["n"], add=add),
               plan.lm.matrix_bytes + 3 * plan.hid * 4 + plan.V * 4,
               2 * plan.lm.K * plan.lm.Ntot),
    }
    out = {}
    for name, (fn, plain, nbytes, ops) in segs.items():
        ms = time_ms(fn, [()], iters=10)
        tpk.check_prefill_status(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        b = bounds(nbytes, ops)
        out[name] = dict(ms=ms, plain_ms=1e3 * (time.perf_counter() - t0),
                         bound_ms=max(b["bytes_ms"], b["ops_ms"]),
                         bound_by=("bytes" if b["bytes_ms"] >= b["ops_ms"]
                                   else "operations"),
                         nbytes=nbytes, operations=ops, **b)
        print(f"  tp_prefill_{name}_segment (n={n}, S={S}, n_tok={n_tok}, "
              f"rank 0, ranks on one card): {ms:.4f} ms a launch, bound "
              f"{out[name]['bound_ms']:.4f} ({out[name]['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP), plain "
              f"{out[name]['plain_ms']:.1f} ms", flush=True)
        traced = {"attn": (tpk.PREFILL_ATTN_SEG_PHASES,
                           lambda t: tpk.tp_prefill_attn_segment(
                               plan, pk, 0, x, *step, cache, add=add,
                               trace=t)),
                  "mlp": (tpk.PREFILL_MLP_SEG_PHASES,
                          lambda t: tpk.tp_prefill_mlp_segment(
                              plan, pk, 0, x, st["n"], add=add, trace=t))}
        if name in traced:      # block 0's phases in one launch
            names, run = traced[name]
            trace = torch.zeros(2 * len(names) + 1, dtype=torch.int64,
                                device=dev)
            run(trace)
            tpk.check_prefill_status(dev)
            out[name]["phases"] = mk.phase_times_of(names, trace)
            print("    phases, ms work+wait (block 0, one traced launch): "
                  + ", ".join(f"{k} {v['work']:.4f}+{v['wait']:.4f}"
                              for k, v in out[name]["phases"].items()),
                  flush=True)
    # the segments' product yardstick: torch.matmul of x [S, hid] bf16 by
    # the rank's q|k|v (attn) or gate|up (mlp) weight in bf16, dequantized
    # beforehand (the rate the card's library reaches on that product;
    # never called by the port)
    for name, n_cols in (("attn", plan.qkv.Ntot), ("mlp", plan.gu.Ntot)):
        w = (torch.randn((plan.hid, n_cols), generator=g, device=dev) *
             0.02).to(torch.bfloat16)
        xb = torch.randn((S, plan.hid), generator=g,
                         device=dev).to(torch.bfloat16)
        y_ms = time_ms(torch.matmul, [(xb, w)], iters=20)
        out[name]["product_yardstick"] = dict(
            ms=y_ms, tflops=2.0 * S * w.numel() / y_ms / 1e9)
        print(f"  tp_prefill_{name}_segment's product yardstick (torch.matmul"
              f" of [{S}, {plan.hid}] by a bf16 [{plan.hid}, {n_cols}]): "
              f"{y_ms:.4f} ms, {2.0 * S * w.numel() / y_ms / 1e9:.0f} "
              "TFLOP/s", flush=True)
        del w, xb
    devices = s["mesh"].devices
    caches = st["caches"]

    def whole():
        return tpk.tp_prefill(plan, s["packs"], st["x0"], *step, caches,
                              devices)

    tp_ms = time_ms(whole, [()], iters=3)
    tpk.check_prefill_status(dev)
    whole()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole()
    whole()
    torch.cuda.synchronize()
    tp_wall = 1e3 * (time.perf_counter() - t0) / 2
    c1 = full_pool(caches)
    mk_ms = time_ms(lambda: pmk.prefill_megakernel(
        plan1, single["pack"], st["x0"], *step, c1), [()], iters=3)
    pmk.check_status(dev)
    from dashinfer_tpu_torch.config import CacheMode

    def per_op():
        transformer.tp_prefill_forward(
            cfg, s["parts"], st["tokens"], caches, st["pages"], 0, n_tok,
            mode=CacheMode.INT8, devices=devices)

    per_op()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    per_op()
    per_op()
    end.record()
    torch.cuda.synchronize()
    op_wall = 1e3 * (time.perf_counter() - t0) / 2
    op_ms = start.elapsed_time(end) / 2
    b1 = bounds(plan1.weight_bytes, plan1.operations(n_tok))
    row = dict(bucket=S, n_tokens=n_tok, segments=out, tp_prefill_ms=tp_ms,
               tp_prefill_wall_ms=tp_wall, megakernel_ms=mk_ms,
               per_op_tp_ms=op_ms, per_op_tp_wall_ms=op_wall,
               bound_ms=max(b1["bytes_ms"], b1["ops_ms"]),
               launches=2 * L * n + n)
    print(f"  TP prefill (n={n}, the ranks on one card, S={S}): "
          f"{tp_ms:.3f} ms by graph replay, {tp_wall:.3f} ms eager (host "
          f"wall), {row['launches']} segment launches; single-device "
          f"prefill megakernel {mk_ms:.3f} ms; per-op TP prefill "
          f"{op_ms:.3f} ms (eager; host wall {op_wall:.3f}); bound of the "
          f"whole prefill on one card {row['bound_ms']:.3f} ms", flush=True)
    return row


def lm_matmul_yardstick(plan, packed, x_rows):
    """ms of one torch.matmul of the final-normed rows (bf16 [M, hid]) by
    the rank's vocab shard dequantized to bf16 [hid, Np] beforehand: the
    library call that computes an lm segment's product, cold (the shard
    is larger than the 50 MB L2). A yardstick, never called by the port."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    w = pmk.dequantized_leaf(packed["lm_head"]).to(torch.bfloat16)
    xb = mk._rms(x_rows, packed["final_norm"], plan.rms_eps).to(
        torch.bfloat16)
    ms = time_ms(torch.matmul, [(xb, w)], iters=20)
    del w
    torch.cuda.empty_cache()
    return ms


def lm_row_faults(plan, pk, st, what, dev):
    """The TP prefill lm segment's one-row product (`lm_row`) on one rank:
    with the last K split's scale rows zeroed in the kernel's copy of the
    pack it must fail the logits check the kernel passes on the pack
    (the ratio of its difference to the tolerance is printed); on zero-mean
    lm_head weights (each zero -7.5 x its scale, as Baichuan's checks take
    them: no common mode for the logits to follow) it is held to its plain
    version."""
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    x = st["x0"].float()
    ref = tpk.prefill_lm_segment_ref(plan, pk, x.clone(), st["n"])
    tol = LOGITS_RTOL * ref.abs().max().item()
    got = tpk.tp_prefill_lm_segment(plan, pk, x, st["n"])
    order = lm_row_order(plan, pk, got, dev, what)[0]
    err = held_rows(got[None], ref[None], slice(0, 1), what)
    ks, cps = tpk.prefill_launch_geometry(plan, dev)["splits"]["lm"]
    lm = pk["lm_head"]
    g0 = (ks - 1) * cps * 64 // (plan.lm.K // lm["scale"].shape[0])
    scale = lm["scale"].clone()
    scale[g0:] = 0
    bad = tpk.tp_prefill_lm_segment(plan, dict(pk, lm_head=dict(
        lm, scale=scale)), x, st["n"])
    tpk.check_prefill_status(dev)
    fault = (bad - ref).abs().max().item()
    check(fault > tol, f"{what}: the planted fault (split {ks - 1}'s scale "
          f"rows {g0}.. zero) passes the logits check ({fault:.3e} <= "
          f"{tol:.3e})")
    zm = dict(pk, lm_head=dict(lm, zero=-7.5 * lm["scale"]))
    ref_z = tpk.prefill_lm_segment_ref(plan, zm, x.clone(), st["n"])
    got_z = tpk.tp_prefill_lm_segment(plan, zm, x, st["n"])
    tpk.check_prefill_status(dev)
    order_z = lm_row_order(plan, zm, got_z, dev, f"{what} zero-mean")[0]
    err_z = held_rows(got_z[None], ref_z[None], slice(0, 1),
                      f"{what} zero-mean")
    tol_z = LOGITS_RTOL * ref_z.abs().max().item()
    print(f"{what}: K split {ks} x {cps} chunks; logits max|d| {err:.3e} "
          f"({err / tol:.3f} of the tolerance; against its own rounding "
          f"{order:.3f} of {ORDER_RTOL}); the planted fault (split "
          f"{ks - 1}'s scale rows {g0}.. zero) {fault:.3e}, "
          f"{fault / tol:.1f}x the tolerance; zero-mean lm_head max|d| "
          f"{err_z:.3e} ({err_z / tol_z:.3f} of the tolerance; against its "
          f"own rounding {order_z:.3f} of {ORDER_RTOL})", flush=True)
    return dict(split=(ks, cps), max_abs_err=err, margin=err / tol,
                lm_row_order=order, planted_fault=fault,
                planted_fault_ratio=fault / tol, zero_mean_err=err_z,
                zero_mean_margin=err_z / tol_z, zero_mean_order=order_z,
                zero_mean_ref_max=ref_z.abs().max().item())


def check_tp_prefill(params, dev, details):
    import dataclasses
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    dplan = mk.make_plan(cfg, tp_prefill_rt(1, CacheMode.INT8), params)
    single = dict(dplan=dplan, pack=mk.pack_params(cfg, dplan, params))
    rows, times, lm_cases = [], [], []
    lm_library_ms = None
    for n, mode, cases in TP_PREFILL_CASES:
        s = tp_prefill_setup(cfg, params, n, dev)
        for bucket, n_tok in cases:
            row, case = check_tp_prefill_case(cfg, params, s, single, mode,
                                              bucket, n_tok, gen, dev)
            rows.append(row)
            if n == 2 and mode == "INT8" and n_tok == bucket:
                times.append(tp_prefill_timing(cfg, params, s, single, case,
                                               dev))
            if n == 2 and mode == "INT8" and n_tok == bucket == 1024:
                plan, _, st = case
                x = st["x0"].float()
                replays_bit_equal(
                    "tp_prefill_mlp_segment n=2/int8 1024",
                    lambda: tpk.tp_prefill_mlp_segment(
                        plan, s["packs"][0], 0, x, st["n"]))
                # the attn segment repeats bit for bit too (a served length
                # at 128 on inputs of its own generator)
                g2 = torch.Generator(device=dev)
                g2.manual_seed(SEED + 47)
                for b, n_ in ((1024, 1024), (128, 100)):
                    p_ = plan if b == 1024 else tpk.make_tp_prefill_plans(
                        cfg, tp_prefill_rt(2, CacheMode.INT8), s["parts"],
                        [b], s["tp_plan"])[b]
                    st_ = st if b == 1024 else tp_prefill_inputs(
                        cfg, params, s, p_, CacheMode.INT8, n_, g2, dev)
                    x_ = st_["x0"].float()
                    replays_bit_equal(
                        f"tp_prefill_attn_segment n=2/int8 {b} n={n_}",
                        lambda: tpk.tp_prefill_attn_segment(
                            p_, s["packs"][0], 0, x_, st_["cos"], st_["sin"],
                            st_["page_row"], st_["n"], st_["caches"][0]))
                    # the lm_head's split tickets go back to 0
                    replays_bit_equal(
                        f"tp_prefill_lm_segment n=2/int8 {b} n={n_}",
                        lambda: tpk.tp_prefill_lm_segment(
                            p_, s["packs"][0], x_, st_["n"]))
                    del p_, st_, x_
                for r in range(n):
                    lm_cases.append(lm_row_faults(
                        plan, s["packs"][r], st,
                        f"tp_prefill_lm_segment n=2/int8 1024 rank {r}",
                        dev))
                lm_library_ms = lm_matmul_yardstick(
                    plan, s["packs"][0], st["x0"].float()[-1:])
                print(f"  tp_prefill_lm_segment's yardstick (torch.matmul of "
                      f"the normed bf16 row by the rank's bf16 [{plan.hid}, "
                      f"{plan.lm.Nptot}] shard, cold): {lm_library_ms:.4f} "
                      "ms", flush=True)
                tpk.check_prefill_status(dev)
                del plan, st, x
            del case
        del s
        torch.cuda.empty_cache()
    del single
    torch.cuda.empty_cache()
    for stream, scfg, make in (
            ("i8", cfg, lambda: dict(
                random_qwen2_7b_params(SEED + 1, dev, stream="i8"),
                embed_tokens=params["embed_tokens"])),
            ("bf16 (2 layers)", dataclasses.replace(cfg, num_layers=2),
             lambda: bf16_params(params, 2))):
        p = make()
        dplan = mk.make_plan(scfg, tp_prefill_rt(1, CacheMode.INT8), p)
        single = dict(dplan=dplan, pack=mk.pack_params(scfg, dplan, p))
        s = tp_prefill_setup(scfg, p, 2, dev, stream=stream)
        for bucket, n_tok in TP_PREFILL_STREAM_CASES:
            row, case = check_tp_prefill_case(scfg, p, s, single, "INT8",
                                              bucket, n_tok, gen, dev)
            rows.append(row)
            del case
        del s, single, p
        torch.cuda.empty_cache()
    # the registers and spills of the prefill kernels' instantiations
    # (pmk_kernel<ALIBI>, pseg_kernel<kind, ALIBI>)
    figs = ptxas_figures(("prefill_megakernel", "tp_prefill_segments"),
                         ("pmk_kernel", "pseg_kernel"))
    print(f"  ptxas (registers, spill stores, spill loads): {figs}",
          flush=True)
    details["tp_prefill"] = dict(cases=rows, times=times, lm_row=lm_cases,
                                 ptxas=figs)
    big = times[-1]["segments"]
    return {f"tp_prefill_{k}_segment": dict(
        max_abs_err=max([r["errs"][k] for r in rows] + (
            [c["max_abs_err"] for c in lm_cases] if k == "lm" else [])),
        shape="n = 2, rank 0, layer 0, bucket 1024, n = 1024",
        ms=big[k]["ms"], plain_ms=big[k]["plain_ms"],
        bound_ms=big[k]["bound_ms"], bound_by=big[k]["bound_by"],
        library_ms=lm_library_ms if k == "lm" else None,
        **({"lm_row": lm_cases, "ptxas": figs} if k == "lm" else {}),
        ms_by_bucket={str(t["bucket"]): t["segments"][k]["ms"]
                      for t in times},
        product_yardstick=big[k].get("product_yardstick"))
        for k in ("attn", "mlp", "lm")}


# -- the TP MoE segment (Qwen1.5-MoE on a model axis) -------------------------

# (ranks, KV mode, B): n = 2 with INT8 and UINT4 KV at B = 8 (the MoE
# megakernel check's lens, one slot inactive), INT8 at B = 32 (the kernel's
# two-m-tile instantiation), n = 4 with INT8 at B = 8 (15 experts, a shared
# slice of 1408 and a vocab shard of 37984 a rank: widths the pack pads,
# four KV heads a rank)
TP_MOE_CASES = ((2, "INT8", 8), (2, "UINT4", 8), (2, "INT8", 32),
                (4, "INT8", 8))
# The moe segment against its plain version: per rank at layers 0 and 23 on
# x0 + a random `add`, the partial of the active rows within LOGITS_RTOL of
# its largest with the plain version routed as the kernel routed (its
# routing record) and x + add equal; the rows the kernel routes otherwise
# than the unforced plain version are counted and capped as the MoE
# megakernel's (near-ties of the plain router), the others held unforced
# too. The whole TP forward (CUDA graph replay) against `tp_decode_ref`
# routed as the kernel (every active row held but ill-conditioned (row,
# layer)s: forced_routing_check's rules, and here also the layer right
# after an ill-conditioned one, `after_ill`) and unforced (flips capped,
# each a near-tie of the plain router or ill-conditioned where it first
# flips; a planted router fault must fail the caps; the rest held), and
# against the single-device MoE decode megakernel on the same weights and
# state (rows the two kernels route differently capped as flips and exempt,
# the rest held by forced_routing_check's rules); every rank records the
# same routing.
# What backs the two TP-only widenings: row 29 of the B = 32 state enters
# layers 2-6 with a residual RMS of 0.004-0.011 of the median; the kernel
# routes it otherwise at layer 6 (plain gap 0.463) and its K / V part from
# the plain version's by 0.089 / 0.660 / 0.133 of its range at layers 5 /
# 6 / 7. `python -m dashinfer_tpu_torch.tools.moe_drift --tp` on this state
# read: the plain version itself, with one element of each row of x0 one
# bf16 step up, moves row 29 by 0.189 / 1.298 / 1.357 there and routes it
# otherwise from layer 5 on (gap 0.753); the single-device plain version
# (the same function summed in another order) parts from the TP plain
# version on it at layers 5-6 (0.006 / 0.039) and nowhere else; each
# segment launched on the plain version's own inputs, layer by layer,
# gives row 29's partials within 2e-4 of their largest, as every other
# row's (up to 9e-4), and routes every row as the plain router.


def tp_moe_flips(gplan, routed, routing, act, what, seed=None, ill=None):
    """Rows a kernel's routing ([L, B, k] global ids) sends otherwise than
    the plain version's router products (`routing`), capped as the MoE
    megakernel's; with a `seed`, a planted router fault must fail the caps
    (over a whole forward's layers: one layer's few rows may not flip)."""
    import torch
    L, B = routed.shape[:2]
    chosen = torch.zeros((L, B, gplan.E), dtype=torch.bool,
                         device=routed.device)
    chosen.scatter_(2, routed.long(), True)
    budget = max(MAX_FLIPPED_ROWS,
                 math.ceil(MAX_FLIPPED_ROW_SHARE * int(act.sum())))
    flips = flipped_rows(gplan, chosen, routing, act, what, budget, ill=ill)
    planted = None if seed is None else planted_router_fault(
        gplan, routing, act, what, budget, seed, ill)
    return chosen, flips, planted, budget


def tp_moe_setup(cfg, params, n, mode, B, gen, dev):
    """tp_setup for a TP_MOE_CASES case: B = 8 with the MoE megakernel
    check's lens, B = 32 with longer ones and slot 17 inactive."""
    if B == DECODE_BATCH:
        lens, inactive = MK_LENS, MK_INACTIVE
    else:
        lens, inactive = [(37 + 61 * i) % 1500 + 1 for i in range(B)], 17
    return tp_setup(cfg, params, n, mode, gen, dev, B=B, lens=lens,
                    inactive=inactive)


def check_tp_moe_case(cfg, params, n, mode, B, gen, dev, timing):
    """The moe segment of every rank against its plain version, the whole
    TP forward against tp_decode_ref and the single-device MoE megakernel;
    with `timing`, ms per launch of the moe segment and per TP step."""
    import dataclasses
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    s = tp_moe_setup(cfg, params, n, mode, B, gen, dev)
    lens = s["lens"]
    plan, packs, st, caches = s["plan"], s["packs"], s["st"], s["caches"]
    mode, L = s["mode"], plan.L
    E_g = cfg.moe.num_experts
    check(plan.E == E_g // n and plan.E_global == E_g and
          not tpk.cuda_kernel_gaps(plan),
          f"tp MoE plan: E {plan.E}/{plan.E_global}, gaps "
          f"{tpk.cuda_kernel_gaps(plan)}")
    gplan = dataclasses.replace(plan, E=E_g)        # routes over all experts
    what0 = f"tp MoE n={n} {mode.value} B={B}"
    act = st["active"]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31 + n + B)
    err, attn_err, seg_flips = 0.0, 0.0, 0
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    for r in range(n):
        add = torch.randn((B, plan.hid), generator=g, device=dev) * 0.5
        for l in (0, L - 1):
            # the attn segment at this model's shapes (16 KV heads over the
            # ranks), as check_tp_segment_case holds it
            what = f"{what0} attn rank {r} layer {l}"
            x = s["x0"].float()
            xs = {True: x.clone(), False: x.clone()}
            cs_ = {True: caches[r].clone(), False: caches[r].clone()}
            out = {True: tpk.tp_attn_segment(plan, packs[r], l, xs[True],
                                             *step, cs_[True], add=add)}
            tpk.check_status(plan, dev)
            out[False] = tpk.attn_segment_ref(plan, packs[r], l, xs[False],
                                              *step, cs_[False], add=add)
            check(bool((xs[True] == xs[False]).all()),
                  f"{what}: x + add differs")
            attn_err = max(attn_err, held_rows(out[True], out[False], act,
                                               what))
            check_written_pool(what, mode, cs_[True], cs_[False], caches[r],
                               tp_written(s, (l,), dev), L, dev)
            del cs_
            what = f"{what0} moe rank {r} layer {l}"
            xs = {k: x.clone() for k in ("k", "p", "f")}
            out_k = tpk.tp_moe_segment(plan, packs[r], l, xs["k"], r, act,
                                       add=add)
            tpk.check_status(plan, dev)
            routed = tpk.kernel_routing(plan, dev, r)[l].clone()
            routing = []
            out_p = tpk.moe_segment_ref(plan, packs[r], l, xs["p"], r,
                                        add=add, routing=routing)
            out_f = tpk.moe_segment_ref(plan, packs[r], l, xs["f"], r,
                                        add=add, forced_routing=routed)
            torch.cuda.synchronize()
            check(bool((xs["k"] == xs["p"]).all()), f"{what}: x + add "
                  "differs")
            err = max(err, held_rows(out_k, out_f, act,
                                     f"{what} (the plain version routed as "
                                     "the kernel)"))
            _, flips, _, _ = tp_moe_flips(gplan, routed[None], routing, act,
                                          what)
            held = act.clone()
            for b, *_ in flips:
                held[b] = False
            held_rows(out_k, out_p, held, what)
            seg_flips += len(flips)
    # the whole forward: CUDA-graph replay of the kernels' forward (the
    # pools are cloned one check at a time: B = 32's are 6.4 GB a copy)
    devices = s["mesh"].devices
    ck = [c.clone() for c in caches]

    def fwd():
        return tpk.tp_decode(plan, packs, s["x0"], *step, ck, devices)

    fwd()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_k = fwd()
    graph.replay()
    tpk.check_status(plan, dev)
    logits_k = logits_k.clone()
    del graph
    routed = [tpk.kernel_routing(plan, dev, r).clone() for r in range(n)]
    check(all(bool((rt_ == routed[0]).all()) for rt_ in routed),
          f"{what0}: the ranks routed differently")
    what = f"{what0} forward"
    written = tp_written(s, range(L), dev)
    before = full_pool(caches)
    kfull = full_pool(ck)
    del ck
    # routed as the kernel: every active row held (forced_routing_check's
    # rules)
    cf = [c.clone() for c in caches]
    norms = []
    ref = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cf, devices,
                            forced_routing=routed[0], resid_norms=norms)
    torch.cuda.synchronize()
    ffull = full_pool(cf)
    del cf
    failed = []
    try:
        forced = hold_routed_rows(L, cfg.num_kv_heads, mode, kfull,
                                  logits_k, ffull, ref, norms, before,
                                  written, st, lens, [],
                                  f"{what} (the plain version routed as the "
                                  "kernel)", dev, after_ill=True)
    except SmokeFailure as e:         # reported after the checks below
        failed.append(e)
        forced = None
    del ffull
    # [L, B]: a layer past layer 0 that a row enters with its residual RMS
    # below ILL_NORM_SHARE of the median
    rows = [b for b in range(B) if bool(act[b])]
    share = torch.stack(norms)
    ill = share / share[:, rows].median(1).values[:, None] < ILL_NORM_SHARE
    ill[0] = False
    # unforced: the rows the kernel routes otherwise capped, the rest held
    cp = [c.clone() for c in caches]
    routing = []
    logits_p = tpk.tp_decode_ref(plan, packs, s["x0"], *step, cp, devices,
                                 routing=routing)
    del cp
    chosen, flips, planted, budget = tp_moe_flips(
        gplan, routed[0], routing, act, what, SEED + 43, ill)
    held = act.clone()
    for b, *_ in flips:
        held[b] = False
    f_err = held_rows(logits_k, logits_p, held, what)
    # the single-device MoE megakernel on the same weights and state
    plan1, pack1 = mk_plan_pack(cfg, params, B, mode)
    c1 = before.clone()
    logits_1 = mk.decode_megakernel(plan1, pack1, s["x0"], *step, c1)
    mk.check_status(plan1, dev)
    chosen1 = torch.zeros_like(chosen)
    chosen1.scatter_(2, mk.kernel_routing(plan1, dev).long(), True)
    what1 = f"{what0} forward vs the single-device megakernel"
    flips1 = flipped_rows(gplan, chosen, routing, act, what1, budget,
                          chosen_ref=chosen1, ill=ill)
    vs1 = hold_routed_rows(L, cfg.num_kv_heads, mode, kfull, logits_k, c1,
                           logits_1, norms, before, written, st, lens,
                           flips1, what1, dev, skip=[b for b, *_ in flips1])
    if failed:
        raise failed[0]
    kept = act.clone()
    for b, *_ in flips1:
        kept[b] = False
    m_same = check_argmax(logits_k, logits_1, kept, vs1["max_abs_err"],
                          what1)
    row = dict(n=n, mode=mode.value, B=B, segment_err=err,
               attn_segment_err=attn_err, segment_flips=seg_flips,
               forward_err=f_err, forward_flips=flips,
               forward_planted=planted, forced=forced,
               vs_megakernel=vs1, vs_megakernel_flips=flips1,
               vs_megakernel_argmax_equal=m_same,
               geometry=tpk.launch_geometry(plan, dev))
    print(f"{what0}: attn segment max|d| {attn_err:.3e}, moe segment "
          f"max|d| {err:.3e} (routed as the kernel; {seg_flips} rows routed "
          f"otherwise by the unforced plain version over the ranks and "
          f"layers); forward (graph replay) vs plain {f_err:.3e} (flips "
          f"{flips}, planted {planted}), routed as the kernel "
          f"{forced['max_abs_err']:.3e}, vs the single-device megakernel "
          f"{vs1['max_abs_err']:.3e} (rows routed otherwise {flips1}, "
          f"argmax equal {m_same}); geometry {row['geometry']}", flush=True)
    del kfull, before
    if timing:
        row.update(tp_timing(cfg, s, plan1, pack1, c1, step, dev))
    del c1, pack1
    return row


def check_tp_moe(cfg, params, dev, details):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    rows = []
    for i, (n, mode, B) in enumerate(TP_MOE_CASES):
        rows.append(check_tp_moe_case(cfg, params, n, mode, B, gen, dev,
                                      timing=i == 0))
        torch.cuda.empty_cache()
    details["tp_moe"] = rows
    t = rows[0]["segments"]["moe"]
    return dict(max_abs_err=max(r["segment_err"] for r in rows),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None,
                shape="n = 2, rank 0, layer 0, B = 8, INT8",
                tp_forward_ms=rows[0]["tp_forward_ms"],
                megakernel_ms=rows[0]["megakernel_ms"])


def check_serving_tp_moe(params, cfg, dev, details, single_tokens):
    """Qwen1.5-MoE on a (1, 2) mesh with serve()'s traffic: every flag at
    its default (decode through the attn and moe segments, every prefill
    per-op TP with the ranks' experts through the grouped kernel) and
    per-op (24 tokens a request); the greedy requests' first 8 tokens equal
    to the single-device MoE serving's on the same path in the same run
    (for the default flags the single-device serving whose prefills are
    per-op too: DI_PREFILL_MEGAKERNEL=0)."""
    import torch
    devices = tp_devices(dev)
    out = {}
    for path, new_tokens, ref in (("tp", 64, "megakernel prefill per-op"),
                                  ("tp per-op", 24, "per-op")):
        launches, tokens, _ = serve(params, dev, details, path, new_tokens,
                                    cfg, devices=devices)
        agree_first(tokens, single_tokens[ref],
                    f"MoE {path} and single-device serving ({ref})")
        out[path] = launches
    reqs = details["serving_qwen1.5-moe_tp"]["requests"]
    steps = [r["decode_ms_per_step"] for r in reqs]
    details["tp_moe_serving_summary"] = dict(
        ttft_ms=max(r["ttft_ms"] for r in reqs),
        ms_per_step=(min(steps), max(steps)))
    print(f"qwen1.5-moe tp: TTFT (the six prompts together) "
          f"{max(r['ttft_ms'] for r in reqs):.1f} ms, decode "
          f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    torch.cuda.empty_cache()
    return out

# -- Qwen3: the QK-norm branch of the four attention-bearing kernels ----------

def qwen3_config():
    from dashinfer_tpu_torch.config import ModelConfig
    return ModelConfig(**QWEN3_8B)


def random_qwen3_params(seed: int, dev):
    """Random a16w4 group-128 weights at Qwen3-8B width (bench_stream's
    distribution, no q|k|v bias, q_norm / k_norm of 1 + 0.25 N(0, 1))."""
    from dashinfer_tpu_torch.tools import bench_stream
    return bench_stream.random_a16w4_params(qwen3_config(), seed, dev, GROUP)


def qwen3_moe_config():
    from dashinfer_tpu_torch.config import ModelConfig, MoEConfig
    return ModelConfig(**dict(QWEN3_MOE, num_layers=QWEN3_MOE_LAYERS),
                       moe=MoEConfig(**QWEN3_MOE_EXPERTS))


def kernel_entry(cases, base, **extra):
    """A kernel line's numbers from its cases and its timed row."""
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], plain_ms=base["plain_ms"], library_ms=None,
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"), **extra)


def plain_decode_ms(cfg, params, mode, gen, dev, what):
    """The decode megakernel's plain version's time at B = 8 (one run, host
    clock around a synchronize), and two replays of one graph and an eager
    launch of the kernel bit-equal on that state."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, mode)
    alibi = cfg.position_embedding.value == "alibi"
    check(plan.qk_norm == cfg.qk_norm and
          (packed["qk_norms"] is not None) == cfg.qk_norm and
          plan.alibi == alibi and (packed["slopes"] is not None) == alibi,
          f"{what}: the plan or pack lacks the QK-norm weights or slopes")
    st = mk_state(cfg, mode, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    args = (plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
            st["active"], st["cache"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    replays_bit_equal(what, lambda: mk.decode_megakernel(*args))
    mk.check_status(plan, dev)
    print(f"{what} plain version: {plain_ms:.1f} ms/step", flush=True)
    return plain_ms


def prefill_replays(cfg, params, what, dev, cases=((1024, 1024), (128, 100))):
    """Two replays of one graph and an eager launch of the prefill
    megakernel bit-equal, at a full bucket and a served length."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    g2 = torch.Generator(device=dev)
    g2.manual_seed(SEED + 47)
    for bucket, n in cases:
        plan, packed = pmk_plan_pack(cfg, params, bucket, CacheMode.INT8)
        st = pmk_inputs(cfg, params, plan, CacheMode.INT8, n, g2, dev)
        replays_bit_equal(
            f"{what} {bucket} n={n}",
            lambda: pmk.prefill_megakernel(
                plan, packed, st["x0"], st["cos"], st["sin"], st["page_row"],
                st["n"], st["cache"]))
        pmk.check_status(dev)
        del plan, packed, st
    torch.cuda.empty_cache()


# the TP prefill segments of Qwen3-8B on a (1, 2) mesh: every bucket the
# serving launches, full (timed) and at a served length, INT8; UINT4 at the
# smallest and the largest
QWEN3_TP_PREFILL_CASES = (
    ("INT8", ((128, 100), (128, 128), (256, 256), (512, 512), (1024, 1000),
              (1024, 1024))),
    ("UINT4", ((128, 100), (1024, 1024))))


def check_qwen3(params, dev, details):
    """The QK-norm branch at Qwen3-8B width (36 layers, G = 4 query heads on
    each of 8 KV heads, vocab 151936) in the four kernels that compute
    attention, each against its plain version at the tolerances above: the
    decode megakernel at B = 8 for INT8 / UINT4 / DEFAULT KV and at B = 32
    (its two-m-tile instantiation); the prefill megakernel at every bucket
    128 .. 1024, a served length and full (INT8), and UINT4 / DEFAULT at
    128; the TP attn, mlp and lm segments (the lm over the 75968-column
    vocab shard, 64 mod 128) of every rank of a (1, 2) mesh for INT8 and
    UINT4 with the whole TP forward against its plain version and the
    single-device megakernel; the TP prefill segments likewise
    (QWEN3_TP_PREFILL_CASES). Two replays of one graph and an eager launch
    bit-equal for each of the four. Then their times beside their bounds."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    cfg = qwen3_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 53)
    out = {}
    # the decode megakernel
    cases = [check_megakernel_case(cfg, params, "qwen3 u4", mode, gen, dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4,
                          CacheMode.DEFAULT)]
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases.append(check_megakernel_case(cfg, params, "qwen3 u4",
                                       CacheMode.INT8, gen, dev, lens32, 17))
    plain_ms = plain_decode_ms(cfg, params, CacheMode.INT8, gen, dev,
                               "megakernel qwen3 u4/int8")
    times = [time_megakernel(cfg, params, "qwen3 u4", 8, MK_LENS, gen, dev),
             time_megakernel(cfg, params, "qwen3 u4", 32, lens32, gen, dev,
                             per_op=False)]
    out["decode_megakernel"] = kernel_entry(
        cases, dict(times[0], plain_ms=plain_ms),
        per_op_ms=times[0]["per_op_ms"], ms_b32=times[1]["ms"],
        bound_ms_b32=max(times[1]["bytes_ms"], times[1]["ops_ms"]))
    details["qwen3_megakernel"] = dict(cases=cases, times=times,
                                       plain_ms=plain_ms)
    torch.cuda.empty_cache()
    # the prefill megakernel
    pcases = [check_prefill_case(cfg, params, "qwen3 u4", mode, 128, 100,
                                 gen, dev)
              for mode in (CacheMode.UINT4, CacheMode.DEFAULT)]
    for bucket, n in ((128, 100), (128, 128), (256, 200), (256, 256),
                      (512, 450), (512, 512), (1024, 1000), (1024, 1024)):
        pcases.append(check_prefill_case(cfg, params, "qwen3 u4",
                                         CacheMode.INT8, bucket, n, gen, dev))
    ptimes = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
              for b in (128, 256, 512, 1024)]
    prefill_replays(cfg, params, "prefill_megakernel qwen3 u4/int8", dev)
    out["prefill_megakernel"] = kernel_entry(
        pcases, ptimes[-1], shape="bucket 1024, n = 1024",
        per_op_ms=ptimes[-1]["per_op_ms"],
        ms_by_bucket={str(t["bucket"]): t["ms"] for t in ptimes},
        bound_ms_by_bucket={str(t["bucket"]): max(t["bytes_ms"], t["ops_ms"])
                            for t in ptimes})
    details["qwen3_prefill_megakernel"] = dict(cases=pcases, times=ptimes)
    torch.cuda.empty_cache()
    # the TP decode segments on a (1, 2) mesh
    rows = [check_tp_segment_case(cfg, params, 2, mode, gen, dev,
                                  timing=mode == "INT8")
            for mode in ("INT8", "UINT4")]
    torch.cuda.empty_cache()
    s = tp_setup(cfg, params, 2, "INT8", gen, dev)
    check(s["plan"].qk_norm and s["plan"].V == cfg.vocab_size // 2,
          f"qwen3 TP plan: qk_norm {s['plan'].qk_norm}, vocab shard "
          f"{s['plan'].V}")
    st, x = s["st"], s["x0"].float()
    replays_bit_equal("tp_attn_segment qwen3 n=2/int8",
                      lambda: tpk.tp_attn_segment(
                          s["plan"], s["packs"][0], 0, x, st["cos"],
                          st["sin"], st["pt"], st["lens"], st["active"],
                          s["caches"][0]))
    tpk.check_status(s["plan"], dev)
    del s, st, x
    torch.cuda.empty_cache()
    seg = rows[0]["segments"]
    for k in ("attn", "lm"):
        out[f"tp_{k}_segment"] = dict(
            max_abs_err=max(r["errs"][k] for r in rows), ms=seg[k]["ms"],
            plain_ms=seg[k]["plain_ms"], bound_ms=seg[k]["bound_ms"],
            bound_by=seg[k]["bound_by"], library_ms=None,
            shape="n = 2, rank 0, layer 0, B = 8, INT8" + (
                ", vocab shard 75968" if k == "lm" else ""))
    out["tp_attn_segment"].update(tp_forward_ms=rows[0]["tp_forward_ms"],
                                  megakernel_ms=rows[0]["megakernel_ms"])
    details["qwen3_tp_segments"] = rows
    # the TP prefill segments on a (1, 2) mesh
    dplan = mk.make_plan(cfg, tp_prefill_rt(1, CacheMode.INT8), params)
    single = dict(dplan=dplan, pack=mk.pack_params(cfg, dplan, params))
    s = tp_prefill_setup(cfg, params, 2, dev, stream="qwen3 u4")
    prows, ptp = [], []
    for mode, pairs in QWEN3_TP_PREFILL_CASES:
        for bucket, n_tok in pairs:
            row, case = check_tp_prefill_case(cfg, params, s, single, mode,
                                              bucket, n_tok, gen, dev)
            prows.append(row)
            if mode == "INT8" and n_tok == bucket:
                ptp.append(tp_prefill_timing(cfg, params, s, single, case,
                                             dev))
            if mode == "INT8" and n_tok == bucket == 1024:
                plan, _, st = case
                x = st["x0"].float()
                replays_bit_equal(
                    "tp_prefill_attn_segment qwen3 n=2/int8 1024",
                    lambda: tpk.tp_prefill_attn_segment(
                        plan, s["packs"][0], 0, x, st["cos"], st["sin"],
                        st["page_row"], st["n"], st["caches"][0]))
                tpk.check_prefill_status(dev)
                del plan, st, x
            del case
    del s, single
    torch.cuda.empty_cache()
    big = ptp[-1]["segments"]
    for k in ("attn", "lm"):
        out[f"tp_prefill_{k}_segment"] = dict(
            max_abs_err=max(r["errs"][k] for r in prows), ms=big[k]["ms"],
            plain_ms=big[k]["plain_ms"], bound_ms=big[k]["bound_ms"],
            bound_by=big[k]["bound_by"], library_ms=None,
            shape="n = 2, rank 0, layer 0, bucket 1024, n = 1024" + (
                ", vocab shard 75968" if k == "lm" else ""),
            ms_by_bucket={str(t["bucket"]): t["segments"][k]["ms"]
                          for t in ptp},
            bound_ms_by_bucket={str(t["bucket"]):
                                t["segments"][k]["bound_ms"] for t in ptp})
    details["qwen3_tp_prefill"] = dict(cases=prows, times=ptp)
    print("qwen3: " + json.dumps({k: {m: v[m] for m in (
        "max_abs_err", "ms", "bound_ms", "plain_ms")} for k, v in
        out.items()}), flush=True)
    return out


def check_serving_qwen3(params, dev, details):
    """Qwen3-8B served through `Engine` with serve()'s traffic: with every
    flag at its default (the decode megakernel, the prefill megakernel for
    buckets 128 .. 1024), on the per-op path (its lm_head, 151936 columns,
    not a multiple of 256, takes the large-M formulation, as in the JAX
    package) and on a (1, 2) mesh (the TP segments and TP prefill segments);
    launch counts checked by serve(), the greedy requests' first 8 tokens
    equal across the three paths. Returns the launches of each path."""
    import torch
    cfg = qwen3_config()
    launches, tokens = {}, {}
    for path, new_tokens, devices in (("megakernel", 64, None),
                                      ("per-op", 24, None),
                                      ("tp", 64, tp_devices(dev))):
        launches[path], tokens[path], _ = serve(params, dev, details, path,
                                                new_tokens, cfg,
                                                devices=devices)
    details["qwen3_greedy_agreement"] = dict(
        per_op=agree_first(tokens["megakernel"], tokens["per-op"],
                           "qwen3-8b megakernel and per-op paths"),
        tp=agree_first(tokens["tp"], tokens["megakernel"],
                       "qwen3-8b (1, 2) mesh and megakernel paths"))
    summary = {}
    for path in ("megakernel", "tp"):
        reqs = details[f"serving_qwen3-8b_{path}"]["requests"]
        steps = [r["decode_ms_per_step"] for r in reqs]
        summary[path] = dict(ttft_ms=max(r["ttft_ms"] for r in reqs),
                             ms_per_step=(min(steps), max(steps)))
        print(f"qwen3-8b {path}: TTFT (the six prompts together) "
              f"{summary[path]['ttft_ms']:.1f} ms, decode "
              f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    details["qwen3_serving_summary"] = summary
    torch.cuda.empty_cache()
    return launches


# -- Baichuan2-13B: the ALiBi branch of the four attention-bearing kernels ---

def baichuan_config(**kw):
    """The port's `models/baichuan._model_config` of Baichuan2-13B's
    published config.json (`kw`: fields replaced, the TP check geometry)."""
    import dataclasses
    from dashinfer_tpu_torch.models.baichuan import _model_config
    return dataclasses.replace(_model_config(BAICHUAN2_13B_HF), **kw)


def unit_norm_columns(leaf, block=16384):
    """NormHead on a u4 group-wise [K, N] leaf: each output column's scale
    and zero divided by the L2 norm of its dequantized values (f32), so
    that the column, a vocab row of the HF checkpoint, has norm 1; column
    blocks of `block` (a multiple of 256, the packing's tile)."""
    import torch
    from dashinfer_tpu_torch.ops.u4pack import weight_levels
    w_q, scale, zero = leaf["w_q"], leaf["scale"], leaf["zero"]
    gs = w_q.shape[0] // scale.shape[0]
    N = scale.shape[-1]
    for c0 in range(0, N, block):
        c1 = min(N, c0 + block)
        lv = weight_levels(w_q[:, c0 // 2:c1 // 2]).float()
        w = lv * scale[:, c0:c1].repeat_interleave(gs, 0) + \
            zero[:, c0:c1].repeat_interleave(gs, 0)
        norm = torch.linalg.vector_norm(w, dim=0)
        scale[:, c0:c1] /= norm
        zero[:, c0:c1] /= norm
        del lv, w


def random_baichuan_params(cfg, seed: int, dev, zero_mean: bool = True):
    """Random a16w4 group-128 weights at `cfg`'s widths (bench_stream's
    payload and scales, no q|k|v bias); `zero_mean`: zero-mean columns,
    each zero -7.5 x its scale (the mean of the levels 0 .. 15), where
    bench_stream's -8 x scale gives every weight a mean of -0.5 x scale.
    At hidden 5120 that mean makes a common-mode direction of the residual
    that the logits follow and attention barely moves: on bench_stream's
    weights (NVIDIA H100 80GB HBM3, 700 W) the zero slopes moved the
    logits by 1.5e-2 of a 11.2 largest, under the 1e-2 check, so no
    attention fault would show; the kernel checks take the zero-mean
    weights, the serving bench_stream's own. The lm_head's columns are then unit-normed, as the NormHead
    converter leaves them."""
    from dashinfer_tpu_torch.tools import bench_stream
    params = bench_stream.random_a16w4_params(cfg, seed, dev, GROUP)

    def centre(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict) and "w_q" in leaf:
                leaf["zero"] = -7.5 * leaf["scale"]
            elif isinstance(leaf, dict):
                centre(leaf)
    if zero_mean:
        centre(params)
    unit_norm_columns(params["lm_head"])
    return params


def planted_alibi_faults(plan, packed, args, before, got, act, ref_max,
                         what, dev):
    """The decode megakernel's ALiBi check has teeth: two faulty plain
    versions, each on a clone of the pool, must fail the logits check the
    kernel passed (max|d| over the active rows > LOGITS_RTOL * max|ref|):
    all slopes zero (no bias), and the bias origin moved by one token for
    every attention chunk but the first (tokens at or past the kernel's
    chunk length `split_len`). Returns the two differences."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    ct = mk.launch_geometry(plan, dev)["split_len"]
    check(int(args[6][act].max()) > ct,
          f"{what}: no active slot spans two attention chunks of {ct} "
          "tokens")
    zero = dict(packed, slopes=torch.zeros_like(packed["slopes"]))
    bias = mk.alibi_bias

    def shifted(plan_, slopes, pos, origin):
        return bias(plan_, slopes, pos, origin) - \
            slopes.reshape(1, plan_.KH, plan_.G, 1) * (pos >= ct)

    errs = {}
    for name, pk in (("slopes zero", zero), ("origin + 1 past chunk 0",
                                              packed)):
        if pk is packed:
            mk.alibi_bias = shifted
        try:
            bad = mk.decode_megakernel_ref(*((plan, pk) + args[2:]),
                                           before.clone())
        finally:
            mk.alibi_bias = bias
        errs[name] = (bad[act] - got[act]).abs().max().item()
        check(errs[name] > LOGITS_RTOL * ref_max,
              f"{what}: the planted fault ({name}) passes the logits check "
              f"({errs[name]:.3e} <= {LOGITS_RTOL} * {ref_max:.3e})")
    print(f"{what}: planted faults fail the logits check: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) +
        f" > {LOGITS_RTOL * ref_max:.3e} (chunk length {ct})", flush=True)
    return errs


def planted_rank_slopes_fault(cfg, params, gen, dev):
    """The TP forward at the check geometry with rank 1's pack holding
    `alibi_slopes(H / 2)` in place of its slice of the global table: its
    plain version must fail the check the kernels' forward passes against
    the correct plain forward (logits within LOGITS_RTOL of their
    largest)."""
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.ops.attention import alibi_slopes
    s = tp_setup(cfg, params, 2, "INT8", gen, dev)
    plan, packs, st = s["plan"], s["packs"], s["st"]
    step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
    devices, act = s["mesh"].devices, st["active"]
    glob = alibi_slopes(cfg.num_heads)
    for r in range(2):
        check(bool((packs[r]["slopes"].cpu() ==
                    glob[r * plan.H:(r + 1) * plan.H]).all()),
              f"TP rank {r}: its slopes are not its slice of the global "
              "table")
    got = tpk.tp_decode(plan, packs, s["x0"], *step,
                        [c.clone() for c in s["caches"]], devices)
    tpk.check_status(plan, dev)
    ref = tpk.tp_decode_ref(plan, packs, s["x0"], *step,
                            [c.clone() for c in s["caches"]], devices)
    err = held_rows(got, ref, act, "tp n=2 baichuan forward (planted fault "
                    "reference)")
    bad_packs = [packs[0], dict(packs[1], slopes=alibi_slopes(plan.H).to(
        dev))]
    bad = tpk.tp_decode_ref(plan, bad_packs, s["x0"], *step,
                            [c.clone() for c in s["caches"]], devices)
    ref_max = ref[act].abs().max().item()
    bad_err = (bad[act] - got[act]).abs().max().item()
    check(bad_err > LOGITS_RTOL * ref_max,
          f"tp n=2 baichuan: rank 1 with alibi_slopes({plan.H}) passes the "
          f"forward check ({bad_err:.3e} <= {LOGITS_RTOL} * {ref_max:.3e})")
    print(f"tp n=2 baichuan forward: kernels vs plain {err:.3e}; the planted "
          f"fault (rank 1 with alibi_slopes({plan.H})) {bad_err:.3e} > "
          f"{LOGITS_RTOL * ref_max:.3e}", flush=True)
    del s
    return dict(err=err, planted_fault_err=bad_err, ref_max=ref_max)


# the long-context state of the planted faults: every slot spans the two
# attention chunks of 1024 tokens that B = 8 over 40 KV heads gets
BAICHUAN_LONG_LENS = [2040, 1990, 2000, 1800, 2047, 1920, 1700, 2016]
# B = 32 at contexts to 500 tokens (its pool fits the card beside the
# 13B's weights and their pack: 410 KB of INT8 K/V a token)
BAICHUAN_B32_LENS = [(37 + 61 * i) % 500 + 1 for i in range(32)]
# the TP prefill cases at the check geometry: the smallest and the largest
# bucket, a served length and full
BAICHUAN_TP_PREFILL_CASES = (
    ("INT8", ((128, 100), (1024, 1024))),
    ("UINT4", ((128, 100), (1024, 1024))))


def check_baichuan(params, dev, details):
    """The ALiBi branch at Baichuan2-13B's width and depth (40 layers, 40
    heads on 40 KV heads, inter 13696, vocab 125696, NormHead) in the four
    kernels that compute attention, each against its plain version at the
    tolerances above: the decode megakernel at B = 8 for INT8 / UINT4 /
    DEFAULT KV, at B = 32 and on the long-context state whose slots span
    two attention chunks, where the two planted faults (slopes zero; the
    bias origin moved past the first chunk) must fail the logits check;
    the prefill megakernel at every bucket 128 .. 1024, a served length and
    full (INT8, with zero slopes planted at 1024), UINT4 / DEFAULT at 128;
    then at the TP check geometry (BAICHUAN_TP_GEOMETRY: inter 13824, 4
    layers) the TP attn, mlp and lm segments and the TP prefill segments of
    every rank of a (1, 2) mesh (INT8, UINT4) with the whole TP forwards
    against their plain versions and the single-device megakernels, and
    rank 1 with `alibi_slopes(20)` planted. Two replays of one graph and an
    eager launch bit-equal for each of the four; their times beside their
    bounds; last the default and per-op paths teacher-forced
    (`paths_teacher_forced`). `params`: the zero-mean weights of
    `random_baichuan_params`."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    cfg = baichuan_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 71)
    out = {}
    # the decode megakernel
    cases = [check_megakernel_case(cfg, params, "baichuan u4", mode, gen,
                                   dev, max_len=512, deep_values=True)
             for mode in (CacheMode.INT8, CacheMode.UINT4,
                          CacheMode.DEFAULT)]
    cases.append(check_megakernel_case(cfg, params, "baichuan u4",
                                       CacheMode.INT8, gen, dev,
                                       BAICHUAN_B32_LENS, 17, max_len=512,
                                       deep_values=True))
    cases.append(check_megakernel_case(cfg, params, "baichuan u4",
                                       CacheMode.INT8, gen, dev,
                                       BAICHUAN_LONG_LENS, None,
                                       faults=True, deep_values=True))
    torch.cuda.empty_cache()
    plain_ms = plain_decode_ms(cfg, params, CacheMode.INT8, gen, dev,
                               "megakernel baichuan u4/int8")
    times = [time_megakernel(cfg, params, "baichuan u4", 8, MK_LENS, gen,
                             dev, max_len=512),
             time_megakernel(cfg, params, "baichuan u4", 32,
                             BAICHUAN_B32_LENS, gen, dev, per_op=False,
                             max_len=512)]
    out["decode_megakernel"] = kernel_entry(
        cases, dict(times[0], plain_ms=plain_ms),
        per_op_ms=times[0]["per_op_ms"], ms_b32=times[1]["ms"],
        bound_ms_b32=max(times[1]["bytes_ms"], times[1]["ops_ms"]),
        planted_faults=cases[-1]["planted_faults"])
    details["baichuan_megakernel"] = dict(cases=cases, times=times,
                                          plain_ms=plain_ms)
    torch.cuda.empty_cache()
    # the prefill megakernel
    pcases = [check_prefill_case(cfg, params, "baichuan u4", mode, 128, 100,
                                 gen, dev)
              for mode in (CacheMode.UINT4, CacheMode.DEFAULT)]
    for bucket, n in ((128, 100), (128, 128), (256, 200), (256, 256),
                      (512, 450), (512, 512), (1024, 1000), (1024, 1024)):
        pcases.append(check_prefill_case(cfg, params, "baichuan u4",
                                         CacheMode.INT8, bucket, n, gen,
                                         dev, alibi_fault=bucket == 1024 and
                                         n == bucket))
    ptimes = [time_prefill(cfg, params, b, gen, dev, b in (128, 1024))
              for b in (128, 256, 512, 1024)]
    prefill_replays(cfg, params, "prefill_megakernel baichuan u4/int8", dev)
    out["prefill_megakernel"] = kernel_entry(
        pcases, ptimes[-1], shape="bucket 1024, n = 1024",
        per_op_ms=ptimes[-1]["per_op_ms"],
        ms_by_bucket={str(t["bucket"]): t["ms"] for t in ptimes},
        bound_ms_by_bucket={str(t["bucket"]): max(t["bytes_ms"], t["ops_ms"])
                            for t in ptimes},
        planted_fault=pcases[-1]["planted_fault"])
    details["baichuan_prefill_megakernel"] = dict(cases=pcases, times=ptimes)
    torch.cuda.empty_cache()
    # the TP segments at the check geometry, on weights of their own
    tcfg = baichuan_config(**BAICHUAN_TP_GEOMETRY)
    tparams = random_baichuan_params(tcfg, SEED + 73, dev)
    check(not tpk.supports_tp(cfg, tp_prefill_rt(2, CacheMode.INT8),
                              params, 2),
          "supports_tp admits Baichuan2-13B (13696 / 2 = 6848)")
    rows = [check_tp_segment_case(tcfg, tparams, 2, mode, gen, dev,
                                  timing=mode == "INT8", deep_values=True)
            for mode in ("INT8", "UINT4")]
    fault = planted_rank_slopes_fault(tcfg, tparams, gen, dev)
    torch.cuda.empty_cache()
    s = tp_setup(tcfg, tparams, 2, "INT8", gen, dev)
    check(s["plan"].alibi and s["plan"].H == 20,
          f"baichuan TP plan: alibi {s['plan'].alibi}, H {s['plan'].H}")
    st, x = s["st"], s["x0"].float()
    replays_bit_equal("tp_attn_segment baichuan n=2/int8",
                      lambda: tpk.tp_attn_segment(
                          s["plan"], s["packs"][1], 0, x, st["cos"],
                          st["sin"], st["pt"], st["lens"], st["active"],
                          s["caches"][1]))
    tpk.check_status(s["plan"], dev)
    del s, st, x
    torch.cuda.empty_cache()
    seg = rows[0]["segments"]
    for k in ("attn", "mlp", "lm"):
        out[f"tp_{k}_segment"] = dict(
            max_abs_err=max(r["errs"][k] for r in rows), ms=seg[k]["ms"],
            plain_ms=seg[k]["plain_ms"], bound_ms=seg[k]["bound_ms"],
            bound_by=seg[k]["bound_by"], library_ms=None,
            shape="the TP check geometry (inter 13824, 4 layers), n = 2, "
                  "rank 0, layer 0, B = 8, INT8")
    out["tp_attn_segment"].update(tp_forward_ms=rows[0]["tp_forward_ms"],
                                  megakernel_ms=rows[0]["megakernel_ms"],
                                  planted_fault=fault)
    details["baichuan_tp_segments"] = dict(cases=rows, planted_fault=fault)
    # the TP prefill segments at the check geometry
    dplan = mk.make_plan(tcfg, tp_prefill_rt(1, CacheMode.INT8), tparams)
    single = dict(dplan=dplan, pack=mk.pack_params(tcfg, dplan, tparams))
    s = tp_prefill_setup(tcfg, tparams, 2, dev, stream="baichuan u4")
    prows, ptp = [], []
    for mode, pairs in BAICHUAN_TP_PREFILL_CASES:
        for bucket, n_tok in pairs:
            row, case = check_tp_prefill_case(tcfg, tparams, s, single, mode,
                                              bucket, n_tok, gen, dev)
            prows.append(row)
            if mode == "INT8" and n_tok == bucket:
                ptp.append(tp_prefill_timing(tcfg, tparams, s, single, case,
                                             dev))
                plan, _, st = case
                x = st["x0"].float()
                replays_bit_equal(
                    "tp_prefill_attn_segment baichuan n=2/int8 1024",
                    lambda: tpk.tp_prefill_attn_segment(
                        plan, s["packs"][1], 0, x, st["cos"], st["sin"],
                        st["page_row"], st["n"], st["caches"][1]))
                tpk.check_prefill_status(dev)
                del plan, st, x
            del case
    del s, single, tparams
    torch.cuda.empty_cache()
    big = ptp[-1]["segments"]
    for k in ("attn", "mlp", "lm"):
        out[f"tp_prefill_{k}_segment"] = dict(
            max_abs_err=max(r["errs"][k] for r in prows), ms=big[k]["ms"],
            plain_ms=big[k]["plain_ms"], bound_ms=big[k]["bound_ms"],
            bound_by=big[k]["bound_by"], library_ms=None,
            shape="the TP check geometry (inter 13824, 4 layers), n = 2, "
                  "rank 0, layer 0, bucket 1024, n = 1024")
    details["baichuan_tp_prefill"] = dict(cases=prows, times=ptp)
    # the default and the per-op path at full width, teacher-forced
    details["baichuan_teacher_forced"] = paths_teacher_forced(cfg, params,
                                                              dev)
    print("baichuan: " + json.dumps({k: {m: v[m] for m in (
        "max_abs_err", "ms", "bound_ms", "plain_ms")} for k, v in
        out.items()}), flush=True)
    return out


def paths_teacher_forced(cfg, params, dev, n=20, steps=24):
    """The default path's and the per-op path's next-token logits for one
    greedy request of n random prompt tokens, both paths fed the default
    path's tokens (teacher-forced, so that one parted token does not part
    the rest): the prompt through the prefill megakernel (bucket 128) and
    through the per-op `prefill_forward` (bucket 32), then `steps` decode
    steps through the decode megakernel (B = 1) and the per-op
    `decode_forward` (eager), each path on its own INT8 pool. The paths
    round differently by design (check_serving), so a token where they
    choose apart passes only as a near-tie: the default path's top-2 gap
    at most twice the two paths' max|d| there. Returns, per token, (max|d|
    of the two paths' logits, the default path's top-2 gap, max|logit|,
    argmax equal)."""
    import torch
    from dashinfer_tpu_torch.config import (CacheConfig, CacheMode,
                                            RuntimeConfigBuilder)
    from dashinfer_tpu_torch.engine.steps import _rope_tiles
    from dashinfer_tpu_torch.models import transformer
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.runtime.kv_cache import create_kv_cache
    mode, bf = CacheMode.INT8, torch.bfloat16
    rt = (RuntimeConfigBuilder("tf").max_length(2048).max_batch(1)
          .kv_cache_page_size(PAGE).kv_cache_mode(mode).dtype("bfloat16")
          .build())
    plan = mk.make_plan(cfg, rt, params)
    packed = mk.pack_params(cfg, plan, params)
    pplan = pmk.make_prefill_plan(cfg, rt, params, 128, decode_plan=plan)
    L, maxP = cfg.num_layers, plan.maxP
    caches = [create_kv_cache(cfg, CacheConfig(page_size=PAGE, mode=mode),
                              (maxP + 1) * L + 1, bf, dev) for _ in range(2)]
    pt = torch.arange(1, maxP + 1, dtype=torch.int32, device=dev)[None]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 83)
    toks = torch.zeros(128, dtype=torch.int64, device=dev)
    toks[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                             device=dev)
    emb = params["embed_tokens"]["w"]
    cos, sin = _rope_tiles(cfg, torch.arange(128, device=dev))
    a = pmk.prefill_megakernel(
        pplan, packed, emb[toks].to(bf), cos, sin,
        (pt[0, :pplan.maxPb] * L).contiguous(),
        torch.tensor([n], dtype=torch.int32, device=dev), caches[0])
    b, _ = transformer.prefill_forward(cfg, params, toks[:32], caches[1],
                                       pt[0, :1], 0, n, mode=mode)
    rows = []
    act = torch.ones(1, dtype=torch.bool, device=dev)
    for i in range(steps + 1):
        top = a.float().topk(2).values
        rows.append(((a - b).abs().max().item(), (top[0] - top[1]).item(),
                     a.abs().max().item(), int(a.argmax()) == int(b.argmax())))
        if i == steps:
            break
        t = a.argmax().reshape(1)
        lens = torch.tensor([n + i], dtype=torch.int32, device=dev)
        c, s = _rope_tiles(cfg, lens)
        a = mk.decode_megakernel(plan, packed, emb[t].to(bf), c, s, pt, lens,
                                 act, caches[0])[0]
        b = transformer.decode_forward(cfg, params, t.to(torch.int32),
                                       caches[1], pt, lens, act,
                                       mode=mode)[0][0]
    mk.check_status(plan, dev)
    print("default vs per-op path, teacher-forced (token: max|d|, the "
          "default path's top-2 gap, max|logit|, argmax equal): " +
          "; ".join(f"{i}: {d:.3f} {gp:.3f} {m:.2f} {int(e)}"
                    for i, (d, gp, m, e) in enumerate(rows)), flush=True)
    apart = [i for i, (d, gp, _, e) in enumerate(rows) if not e]
    check(all(rows[i][1] <= 2 * rows[i][0] for i in apart),
          f"teacher-forced paths choose apart at tokens {apart} where the "
          "default path's top-2 gap is over twice their difference")
    print(f"teacher-forced: the paths choose apart at tokens {apart}, each "
          "a near-tie", flush=True)
    del packed, caches
    torch.cuda.empty_cache()
    return rows


def check_serving_baichuan(params, dev, details):
    """Baichuan2-13B served through `Engine` with serve()'s traffic: with
    every flag at its default (the decode megakernel, the prefill
    megakernel for buckets 128 .. 1024) and per-op (decode attention by
    the plain version, as in the JAX package: no paged_attention launch);
    launch counts checked by serve(), the greedy requests' first 8 tokens
    equal across the two paths. Returns the launches of each path."""
    import torch
    cfg = baichuan_config()
    launches, tokens = {}, {}
    for path, new_tokens in (("megakernel", 64), ("per-op", 24)):
        launches[path], tokens[path], _ = serve(params, dev, details, path,
                                                new_tokens, cfg)
        check(launches[path]["paged_attention"] == 0,
              f"baichuan2-13b {path}: paged_attention launched "
              f"{launches[path]['paged_attention']} times")
    details["baichuan_greedy_agreement"] = agree_first(
        tokens["megakernel"], tokens["per-op"],
        "baichuan2-13b megakernel and per-op paths")
    summary = {}
    for path in ("megakernel", "per-op"):
        reqs = details[f"serving_baichuan2-13b_{path}"]["requests"]
        steps = [r["decode_ms_per_step"] for r in reqs]
        summary[path] = dict(ttft_ms=max(r["ttft_ms"] for r in reqs),
                             ms_per_step=(min(steps), max(steps)))
        print(f"baichuan2-13b {path}: TTFT (the six prompts together) "
              f"{summary[path]['ttft_ms']:.1f} ms, decode "
              f"{min(steps):.2f} .. {max(steps):.2f} ms/step", flush=True)
    details["baichuan_serving_summary"] = summary
    torch.cuda.empty_cache()
    return launches


def check_qwen3_moe(cfg, params, dev, details):
    """The QK-norm branch inside both megakernels' MoE variants and the TP
    moe segment at Qwen3-30B-A3B width, QWEN3_MOE_LAYERS layers deep (128
    experts top-8 of width 768, no shared expert, norm_topk_prob; G = 8,
    H * D = 4096 against hidden 2048), under the MoE rules above: the
    decode megakernel at B = 8 (INT8, UINT4) and B = 32 (INT8) with the
    flip caps and the planted router fault; the prefill megakernel at every
    bucket (a served length, INT8; UINT4 at 128) and a full bucket 1024,
    each held to the plain version routed as the kernel routed (the rule of
    Qwen1.5-MoE's full bucket 1024, `check_prefill_case(forced=True)`):
    every token held to the bounds, each flipped token a near-tie of the
    plain router or ill-conditioned where it first flips, the planted
    router fault still failing the caps. Unforced, this random router's
    near-ties flip more than MAX_FLIPPED_SHARE of a prompt's tokens (8 of
    90 at bucket 128, gaps 1e-4 .. 5.5e-3, first layers 0-3): 128 experts
    top-8 leave half Qwen1.5-MoE's gap between the k-th and k+1-th logit,
    and a token routed otherwise changes its K / V for every later token
    of the prompt. Then the TP moe segment of every rank of a (1, 2) mesh
    with the whole TP forward at B = 32 (the flip caps and the planted
    router fault: at B = 8 and 4 layers the planted fault flipped 1 of 7
    rows, under the cap of 2, too few rows and layers to tell a faulty
    router from the kernel; at B = 32 the cap is 4 of 31 rows); their
    times; then the model served with every flag at its default (launch
    counts checked by serve())."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 59)
    out = {}
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases = [check_megakernel_case(cfg, params, "qwen3 u4 MoE", mode, gen,
                                   dev)
             for mode in (CacheMode.INT8, CacheMode.UINT4)]
    cases.append(check_megakernel_case(cfg, params, "qwen3 u4 MoE",
                                       CacheMode.INT8, gen, dev, lens32, 17))
    plain_ms = plain_decode_ms(cfg, params, CacheMode.INT8, gen, dev,
                               "megakernel qwen3 u4 MoE/int8")
    times = [time_megakernel(cfg, params, "qwen3 u4 MoE", 8, MK_LENS, gen,
                             dev, per_op=False),
             time_megakernel(cfg, params, "qwen3 u4 MoE", 32, lens32, gen,
                             dev, per_op=False)]
    out["decode_megakernel"] = kernel_entry(
        cases, dict(times[0], plain_ms=plain_ms), ms_b32=times[1]["ms"],
        layers=cfg.num_layers,
        flipped_rows=sum(len(c["flipped_rows"]) for c in cases))
    torch.cuda.empty_cache()
    pcases = [check_prefill_case(cfg, params, "qwen3 u4 MoE", mode, 128, 90,
                                 gen, dev, forced=True)
              for mode in (CacheMode.INT8, CacheMode.UINT4)]
    for bucket, n in ((256, 200), (512, 450), (1024, 1000), (1024, 1024)):
        pcases.append(check_prefill_case(cfg, params, "qwen3 u4 MoE",
                                         CacheMode.INT8, bucket, n, gen, dev,
                                         forced=True))
    ptimes = [time_prefill(cfg, params, b, gen, dev, b == 1024)
              for b in (128, 256, 512, 1024)]
    prefill_replays(cfg, params, "prefill_megakernel qwen3 u4 MoE/int8", dev,
                    cases=((1024, 1024),))
    out["prefill_megakernel"] = kernel_entry(
        pcases, ptimes[-1], shape="bucket 1024, n = 1024",
        layers=cfg.num_layers,
        ms_by_bucket={str(t["bucket"]): t["ms"] for t in ptimes},
        flipped_tokens=sum(len(c["flipped_tokens"]) for c in pcases))
    torch.cuda.empty_cache()
    row = check_tp_moe_case(cfg, params, 2, "INT8", 32, gen, dev,
                            timing=True)
    t = row["segments"]["moe"]
    out["tp_moe_segment"] = dict(
        max_abs_err=row["segment_err"], ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        shape="n = 2, rank 0, layer 0, B = 32, INT8")
    details["qwen3_moe"] = dict(decode=dict(cases=cases, times=times),
                                prefill=dict(cases=pcases, times=ptimes),
                                tp_moe=row)
    torch.cuda.empty_cache()
    launches, _, _ = serve(params, dev, details, "megakernel", 24, cfg)
    for k in ("decode_megakernel", "prefill_megakernel"):
        out[k]["launches"] = launches[k]
    print("qwen3-30b-a3b (" + str(cfg.num_layers) + " layers): " + json.dumps(
        {k: {m: v[m] for m in ("max_abs_err", "ms", "bound_ms", "plain_ms")}
         for k, v in out.items()}), flush=True)
    return out


# LoRA: the served pool's geometry (`lora_max_num`, `lora_max_rank`), three
# adapters on all seven targets of every layer made on the card from a seed
# (PEFT layout: A [r, in] of std 1 / sqrt(in), so that h has the x_norm's
# scale; B [out, r] of std LORA_B_STD; alpha / r = 2). The kernel's checks
# take adapters that move the plain version's logits by more than twice
# the kernel's tolerance (B's std 0.2 moves them by ~2x their largest and
# most rows' argmax; 0.12 by 1.5x the tolerance, 0.07 by 0.6x: the
# random model turns quickly from barely moved to dominated). The served
# adapters take LORA_SERVE_B_STD on every layer, but the last one's down
# product steers: all its B columns are LORA_SERVE_STEER times one random
# vector v of the adapter, so that its delta, (sum of h) x v, outweighs the
# residual and sends the logits to v's direction (or -v's) without passing
# through any later layer or K / V. At 0.2 everywhere the served greedy
# tokens are chaotic (the per-op path, which rounds each sum to bf16, and
# the megakernel parted after 3 tokens); at 0.1, with random B of std 5 on
# the last down product, no token moved (an adapter swapped for another
# gave the same 32 tokens). The served check is that the two paths agree
# while the adapters' tokens differ.
LORA_SLOTS, LORA_RANK, LORA_ALPHA, LORA_B_STD = 4, 16, 32.0, 0.2
LORA_SERVE_B_STD, LORA_SERVE_STEER = 0.1, 1000.0
LORA_ADAPTERS = 3
# each row's slot at B = 8 (MK_LENS; row 5 is inactive) and 32: rows on
# every loaded slot and rows without an adapter
LORA_IDX8 = [0, 1, 2, -1, 0, 1, -1, 2]
LORA_IDX32 = [i % (LORA_ADAPTERS + 1) - 1 for i in range(32)]


def lora_adapter(cfg, seed: int, dev, rank=LORA_RANK, b_std=LORA_B_STD,
                 steer=None):
    """One adapter's PEFT-layout tensors {(layer, target, "A" | "B"):
    float32 numpy array}, drawn on the card; `steer`: the last layer's down
    product's B columns are `steer` times one random vector."""
    import torch
    from dashinfer_tpu_torch.lora.manager import TARGETS, _dims
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for l in range(cfg.num_layers):
        for t in TARGETS:
            i, o = _dims(cfg, t)
            out[(l, t, "A")] = (torch.randn((rank, i), generator=gen,
                                            device=dev) / math.sqrt(i)
                                ).cpu().numpy()
            b = torch.randn((o, rank), generator=gen, device=dev) * b_std
            if steer and t == "down_proj" and l == cfg.num_layers - 1:
                v = torch.randn((o, 1), generator=gen, device=dev)
                b = (steer * v).expand(o, rank).contiguous()
            out[(l, t, "B")] = b.cpu().numpy()
    return out


def lora_manager(cfg, dev, seeds, **adapter_kw):
    """A LoraManager of the served geometry on the card with one adapter a
    seed loaded (slots 0, 1, ...; `adapter_kw`: `lora_adapter`'s)."""
    import torch
    from dashinfer_tpu_torch.config import RuntimeConfigBuilder
    from dashinfer_tpu_torch.lora import LoraManager
    rt = (RuntimeConfigBuilder("lora").lora(True, max_num=LORA_SLOTS,
                                            max_rank=LORA_RANK).build())
    mgr = LoraManager(cfg, rt, torch.bfloat16, dev)
    for i, seed in enumerate(seeds):
        mgr.load(f"adapter{i}", lora_adapter(cfg, seed, dev, **adapter_kw),
                 alpha=LORA_ALPHA, rank=LORA_RANK)
    return mgr


def ptxas_figures(sources=("megakernel", "tp_segments"),
                  entries=("mk_kernel", "seg_kernel")) -> dict:
    """Registers and spill bytes of each kernel instantiation in the build
    logs: {source: {instantiation: (registers, spill stores, spill
    loads)}}, an instantiation named by its mangled name from the entry
    on (mk_kernel<1, false, true>: `mk_kernelILi1ELb0ELb1EE...`)."""
    import re
    from dashinfer_tpu_torch.ops import kernel_build
    out = {}
    for source in sources:
        lines = kernel_build.build_logs.get(source, "").splitlines()
        figs = {}
        for i, ln in enumerate(lines):
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if not m or not any(e in m.group(1) for e in entries):
                continue
            block = " ".join(lines[i:i + 5])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            name = m.group(1)
            key = name[name.index(next(e for e in entries if e in name)):]
            stores, loads = (int(x) for x in spill.groups()) if spill \
                else (None, None)
            figs[key] = (int(regs.group(1)) if regs else None, stores, loads)
        out[source] = figs
    return out


def check_lora(params, dev, details):
    """The decode megakernel's LoRA branch at Qwen2-7B width, a pool of
    LORA_SLOTS slots of rank LORA_RANK holding LORA_ADAPTERS adapters on
    all seven targets (made on the card from a seed), rows on every loaded
    slot and rows without one: against its plain version (logits and pool
    writes, the tolerances above) at B = 8 for INT8 / UINT4 KV and the u4
    stream and INT8 with the per-channel i8 stream, and at B = 32 (its
    two-m-tile instantiation) for both streams; an all-none batch bit-equal
    (logits and pool) to the launch without the pool, on the same launch
    geometry; two replays of one graph and an eager launch bit-equal; the
    ptxas registers and spills of every `mk_kernel` instantiation and of
    the TP segments' `seg_kernel`s (the attention phase is shared); then ms
    a step of the LoRA launch beside the launch without the pool on the
    same state, and its bound: the dense step's bytes plus the adapters'
    that the rows use."""
    import torch
    from dashinfer_tpu_torch.config import CacheMode, ModelConfig
    from dashinfer_tpu_torch.ops import megakernel as mk
    cfg = ModelConfig(**QWEN2_7B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 71)
    mgr = lora_manager(cfg, dev, [SEED + 73 + i
                                  for i in range(LORA_ADAPTERS)])
    pool = mgr.pool
    i8_params = random_qwen2_7b_params(SEED + 1, dev, stream="i8")
    i8_params["embed_tokens"] = params["embed_tokens"]
    lens32 = [(37 + 61 * i) % 1500 + 1 for i in range(32)]
    cases = []
    for stream, p, mode, lens, inactive, idx in (
            ("u4", params, CacheMode.INT8, None, None, LORA_IDX8),
            ("u4", params, CacheMode.UINT4, None, None, LORA_IDX8),
            ("i8", i8_params, CacheMode.INT8, None, None, LORA_IDX8),
            ("u4", params, CacheMode.INT8, lens32, 17, LORA_IDX32),
            ("i8", i8_params, CacheMode.INT8, lens32, 17, LORA_IDX32)):
        cases.append(check_megakernel_case(cfg, p, stream, mode, gen, dev,
                                           lens, inactive,
                                           lora=(pool, idx)))
    # an all-none batch: the LoRA instantiation computes the dense one's
    # bits; two graph replays and an eager launch of the LoRA launch
    timings = []
    for stream, p, B, lens, idx in (("u4", params, 8, MK_LENS, LORA_IDX8),
                                    ("u4", params, 32, lens32, LORA_IDX32),
                                    ("i8", i8_params, 8, MK_LENS, LORA_IDX8),
                                    ("i8", i8_params, 32, lens32,
                                     LORA_IDX32)):
        what = f"megakernel LoRA {stream}/int8 B={B}"
        plan, packed = mk_plan_pack(cfg, p, B, CacheMode.INT8)
        st = mk_state(cfg, CacheMode.INT8, B, lens, None, gen, dev)
        x0 = p["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
        args = (plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
                st["active"])
        lidx = torch.tensor(idx, dtype=torch.int32, device=dev)
        none = torch.full_like(lidx, -1)
        if stream == "u4":
            c0, c1 = st["cache"].clone(), st["cache"].clone()
            dense = mk.decode_megakernel(*args, c0)
            lnone = mk.decode_megakernel(*args, c1, lora=pool, lora_idx=none)
            mk.check_status(plan, dev)
            geo = (mk.launch_geometry(plan, dev),
                   mk.launch_geometry(plan, dev, lora=True))
            check(geo[0] == geo[1], f"{what}: the LoRA launch's geometry "
                  f"{geo[1]} is not the dense launch's {geo[0]}")
            check(torch.equal(dense, lnone) and all(
                torch.equal(getattr(c0, k), getattr(c1, k))
                for k in ("k", "v", "k_qparams", "v_qparams")),
                f"{what}: an all-none batch differs from the launch without "
                "the pool")
            print(f"{what}: an all-none batch bit-equal to the launch "
                  f"without the pool (logits and pool); geometry {geo[0]}",
                  flush=True)
            replays_bit_equal(what, lambda: mk.decode_megakernel(
                *args, st["cache"], lora=pool, lora_idx=lidx))
            mk.check_status(plan, dev)
            del c0, c1, dense, lnone

        def run(with_lora):
            return mk.decode_megakernel(
                *args, st["cache"], **(dict(lora=pool, lora_idx=lidx)
                                       if with_lora else {}))

        ms_lora = time_ms(run, [(True,)], iters=5)
        ms_dense = time_ms(run, [(False,)], iters=5)
        ms_lora2 = time_ms(run, [(True,)], iters=5)
        mk.check_status(plan, dev)
        # where a launch's time goes: block 0's timestamps, by phase kind,
        # with the adapters and without the pool
        phases = {}
        for with_lora in (True, False):
            trace = torch.zeros(mk.trace_len(plan), dtype=torch.int64,
                                device=dev)
            mk.decode_megakernel(*args, st["cache"], trace=trace,
                                 **(dict(lora=pool, lora_idx=lidx)
                                    if with_lora else {}))
            torch.cuda.synchronize()
            phases["lora" if with_lora else "dense"] = mk.phase_times(
                plan, trace)
        mk.check_status(plan, dev)
        used = len({i for i, a in zip(idx, st["active"].tolist())
                    if i >= 0 and a})
        n_w = sum(sp.K * sp.Ntot * (1 if sp.name == "lm" else plan.L)
                  for sp in plan.streams)
        lb = mk.lora_bytes(plan, pool, used)
        nbytes = (plan.weight_bytes + lb + B * plan.V * 4 +
                  kv_bytes_read(cfg, CacheMode.INT8, lens, [1] * B))
        # the adapters' operations: 2 (in + out) R a row on a slot, a
        # target and a layer
        rows = sum(1 for i, a in zip(idx, st["active"].tolist())
                   if i >= 0 and a)
        ops = 2.0 * B * n_w + 2.0 * rows * plan.L * LORA_RANK * sum(
            pool["A"][t].shape[2] + pool["B"][t].shape[3]
            for t in mk.LORA_TARGETS)
        row = dict(stream=stream, B=B, ms=(ms_lora + ms_lora2) / 2,
                   ms_runs=(ms_lora, ms_lora2), dense_ms=ms_dense,
                   slots_used=used, lora_bytes=lb, phases=phases,
                   **bounds(nbytes, ops))
        timings.append(row)
        print(f"{what}: {row['ms']:.3f} ms/step with the adapters "
              f"({ms_lora:.3f} / {ms_lora2:.3f}), {ms_dense:.3f} without the "
              f"pool; bound {max(row['bytes_ms'], row['ops_ms']):.3f} "
              f"({used} slots used, {lb / 1e6:.1f} MB of adapters)",
              flush=True)
        for k, ph in phases.items():
            print(f"  {k} phases, ms work+wait (block 0, one traced "
                  "launch): " + ", ".join(
                      f"{n} {v['work']:.2f}+{v['wait']:.2f}"
                      for n, v in ph.items()), flush=True)
        del st, args, packed
        torch.cuda.empty_cache()
    # the plain version's time (one run, host clock around a synchronize)
    plan, packed = mk_plan_pack(cfg, params, DECODE_BATCH, CacheMode.INT8)
    st = mk_state(cfg, CacheMode.INT8, DECODE_BATCH, MK_LENS, None, gen, dev)
    x0 = params["embed_tokens"]["w"][st["tokens"]].to(torch.bfloat16)
    lidx = torch.tensor(LORA_IDX8, dtype=torch.int32, device=dev)
    args = (plan, packed, x0, st["cos"], st["sin"], st["pt"], st["lens"],
            st["active"])
    cache = st["cache"].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.decode_megakernel_ref(*args, cache, lora=pool, lora_idx=lidx)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    # the served adapters (serve_lora's) on the same step: what they move
    served = lora_manager(cfg, dev, [SEED + 81 + i
                                     for i in range(LORA_ADAPTERS)],
                          b_std=LORA_SERVE_B_STD, steer=LORA_SERVE_STEER)
    dense = mk.decode_megakernel_ref(*args, st["cache"].clone())
    moved = mk.decode_megakernel_ref(*args, st["cache"].clone(),
                                     lora=served.pool, lora_idx=lidx)
    rows = st["active"] & (lidx >= 0)
    served_moved = (moved[rows] - dense[rows]).abs().max().item()
    served_flips = int((moved[rows].argmax(-1) !=
                        dense[rows].argmax(-1)).sum().item())
    print(f"the served adapters move the LoRA rows' logits by up to "
          f"{served_moved:.3e} (largest {dense[rows].abs().max().item():.3e}"
          f"), argmax of {served_flips} of {int(rows.sum())} rows",
          flush=True)
    del served, dense, moved, cache
    del st, packed, i8_params
    torch.cuda.empty_cache()
    figs = ptxas_figures()
    for source, f in figs.items():
        print(f"ptxas {source}: " + ", ".join(
            f"{k} {v[0]} registers, {v[1]} / {v[2]} bytes spilled"
            for k, v in sorted(f.items())), flush=True)
    check(any("Lb0ELb1E" in k for k in figs["megakernel"]),
          f"no LoRA instantiation of mk_kernel in the build log: {figs}")
    base = timings[0]
    details["lora"] = dict(cases=cases, times=timings, plain_ms=plain_ms,
                           ptxas=figs)
    print(f"megakernel LoRA plain version: {plain_ms:.1f} ms/step",
          flush=True)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=base["ms"], dense_ms=base["dense_ms"], plain_ms=plain_ms,
                library_ms=None,
                bound_ms=max(base["bytes_ms"], base["ops_ms"]),
                bound_by=("bytes" if base["bytes_ms"] >= base["ops_ms"]
                          else "operations"),
                shape="u4, INT8, B = 8, 3 adapters on 6 of 7 active rows",
                ms_b32=timings[1]["ms"], dense_ms_b32=timings[1]["dense_ms"],
                bound_ms_b32=max(timings[1]["bytes_ms"],
                                 timings[1]["ops_ms"]),
                ms_i8=(timings[2]["ms"], timings[3]["ms"]),
                dense_ms_i8=(timings[2]["dense_ms"], timings[3]["dense_ms"]))


# the served LoRA batch: (prompt length, adapter) a request, greedy; the
# prompts of 90 .. 120 tokens are bucket 128, which the prefill megakernel
# takes without an adapter and the per-op path with one
LORA_SERVE = [(20, "a0"), (100, "a1"), (30, "a2"), (100, None), (24, "a0"),
              (90, "a1"), (28, None), (120, "a2")]


def write_peft_bin(cfg, tensors, path):
    """An adapter as PEFT saves it: adapter_config.json and
    adapter_model.bin (bf16 tensors under PEFT's key names)."""
    import torch
    from dashinfer_tpu_torch.lora.manager import TARGETS
    os.makedirs(path, exist_ok=True)
    state = {}
    for (l, t, ab), arr in tensors.items():
        mod = "self_attn" if t in TARGETS[:4] else "mlp"
        state[f"base_model.model.model.layers.{l}.{mod}.{t}.lora_{ab}"
              ".weight"] = torch.from_numpy(arr).to(torch.bfloat16)
    torch.save(state, os.path.join(path, "adapter_model.bin"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": LORA_RANK,
                   "lora_alpha": LORA_ALPHA,
                   "target_modules": list(TARGETS)}, f)


def serve_lora_run(params, dev, details, path, new_tokens, adapters, swap):
    """Qwen2-7B served with `enable_lora` through `Engine`: path
    "megakernel" (every other flag at its default) or "per-op"
    (`enable_megakernel` off). Adapters a0, a2 load from tensors, a1 from
    the PEFT directory `adapters["a1_dir"]`. After a warm-up request with
    and one without an adapter, the LORA_SERVE batch (launch counts zeroed
    just before, read just after); then, with a long request without an
    adapter decoding, a1 is unloaded and `swap` loaded (into a1's slot)
    and a1's prompt served with it; with path "megakernel", the same
    prompts again without adapters (the dense step's time). Returns
    (launches, tokens of the batch, tokens of the swap request, the
    requests' stats)."""
    import torch
    from dashinfer_tpu_torch import (CacheMode, Engine, GenerateRequestStatus,
                                     GenerationConfig, ModelConfig,
                                     RuntimeConfigBuilder)
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import paged_attention as pa
    from dashinfer_tpu_torch.ops import prefill_megakernel as pmk
    from dashinfer_tpu_torch.ops import quant_matmul as qm
    cfg = ModelConfig(**QWEN2_7B)
    name = "qwen2-7b-lora"
    b = (RuntimeConfigBuilder(name).max_length(2048).max_batch(DECODE_BATCH)
         .kv_cache_page_size(PAGE).kv_cache_mode(CacheMode.INT8)
         .dtype("bfloat16").lora(True, max_num=LORA_SLOTS,
                                 max_rank=LORA_RANK))
    if path == "per-op":
        b = b.update({"enable_megakernel": False})
    counters = {"decode_megakernel": mk.decode_megakernel.counter,
                "decode_megakernel_lora": mk.decode_megakernel.lora_counter,
                "prefill_megakernel": pmk.prefill_megakernel.counter,
                "quant_matmul": qm.quant_matmul.counter,
                "paged_attention": pa.paged_attention.counter}
    torch.cuda.synchronize()
    pmk.release_scratch(dev)
    torch.cuda.empty_cache()
    eng = Engine().install_model(name, b.build(), params=params,
                                 model_config=cfg, device=dev)
    run = eng._models[name]
    check((run.mega_plan is not None) == (path == "megakernel") and
          run._mega_lora_ok == (path == "megakernel"),
          f"serve_lora {path}: the install took the wrong decode path")
    eng.load_lora(name, "a0", adapters["a0"], alpha=LORA_ALPHA,
                  rank=LORA_RANK)
    eng.start_model(name)
    g = torch.Generator().manual_seed(11)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()

    def greedy(n, new, lora):
        return GenerationConfig(max_length=n + new, do_sample=False,
                                top_k=1, eos_token_id=-1, lora_name=lora)

    def serve_all(reqs, new):
        hs = [eng.start_request(name, ids, greedy(len(ids), new, lora))[1:]
              for ids, lora in reqs]
        for h, _ in hs:
            eng.sync_request(name, h, timeout_s=600)
        out = []
        for (h, q), (ids, lora) in zip(hs, reqs):
            toks, st = q.GetAllGeneratedTokens(), q.RequestStatInfo()
            check(q.GenerateStatus() == GenerateRequestStatus.GenerateFinished
                  and len(toks) == new, f"serve_lora {path}: a request "
                  f"(prompt {len(ids)}, {lora}) ended {q.GenerateStatus()} "
                  f"with {len(toks)} tokens")
            out.append(dict(prompt_len=len(ids), lora=lora, tokens=toks,
                            ttft_ms=1e3 * st["time_to_first_token"],
                            decode_ms_per_step=1e3 / st["generate_tps"]))
            eng.release_request(name, h)
        return out

    stats = {}
    try:
        eng.load_lora(name, "a1", adapters["a1_dir"])
        eng.load_lora(name, "a2", adapters["a2"], alpha=LORA_ALPHA,
                      rank=LORA_RANK)
        check([run.lora_manager.index_of(a) for a in ("a0", "a1", "a2")] ==
              [0, 1, 2], f"serve_lora {path}: slots "
              f"{run.lora_manager.names}")
        # warm-up: the process's first use of each PyTorch kernel and the
        # two decode graphs' captures are set-up, not serving
        serve_all([(prompt(20), "a0")], 4)
        serve_all([(prompt(20), None)], 4)
        batch = [(prompt(n), lora) for n, lora in LORA_SERVE]
        for c in counters.values():
            c.reset()
        stats["lora_batch"] = serve_all(batch, new_tokens)
        launches = {k: c.read() for k, c in counters.items()}
        # unload a1 and load `swap` into its slot while a request without
        # an adapter decodes
        _, h_long, _ = eng.start_request(name, prompt(50),
                                         greedy(50, 200, None))
        eng.unload_lora(name, "a1")
        eng.load_lora(name, "a3", swap, alpha=LORA_ALPHA, rank=LORA_RANK)
        check(run.lora_manager.index_of("a3") == 1,
              f"serve_lora {path}: a3 in slot "
              f"{run.lora_manager.index_of('a3')}, not a1's")
        stats["swap"] = serve_all([(batch[1][0], "a3")], new_tokens)
        eng.sync_request(name, h_long, timeout_s=600)
        eng.release_request(name, h_long)
        if path == "megakernel":
            stats["dense_batch"] = serve_all([(ids, None) for ids, _ in batch],
                                             new_tokens)
        captures = run._lora_decode_step.forward.captures
    finally:
        eng.release_model(name)
    check(captures == 1, f"serve_lora {path}: the LoRA decode graph was "
          f"captured {captures} times")
    details[f"serving_lora_{path}"] = dict(launches=launches, **stats)
    for r in stats["lora_batch"] + stats["swap"]:
        print(f"lora {path} request prompt={r['prompt_len']:4d} "
              f"adapter={r['lora']} ttft_ms={r['ttft_ms']:.1f} "
              f"decode_ms/step={r['decode_ms_per_step']:.2f}", flush=True)
    print(f"lora {path}: launches {launches}", flush=True)
    return (launches, [r["tokens"] for r in stats["lora_batch"]],
            stats["swap"][0]["tokens"], stats)


# -- multi-step decode windows and the per-token features --------------------

MS_STEPS = 4                 # decode_steps_per_launch of the window runs
MS_TOKENS = {"megakernel": 64, "per-op": 32, "tp": 32}   # new tokens a request
MS_FEATURE_TOKENS = 32       # of the ban and logprobs requests
MS_JSON_TOKENS = 48
MS_TOP_LOGPROBS = 5
# tests/test_guided.py's token strings: even ids JSON-ish, odd ids garbage
JSONISH = ['{', '}', '[', ']', '"', ':', ',', ' ', 'a', 'b', 'key', 'val',
           '1', '2', '37', 'true', 'false', 'null', '"x"', '0.5', '-3',
           '{"', '"}', '": ', 'e8', '\\n']
GARBAGE = ['<?', 'def ', '>>>', '%%', ');', 'END', '\x01', '<<']
JSON_EOS = 1                 # a garbage string: allowed once the JSON is whole


class JsonishTokenizer:
    """A tokenizer over `n` ids for the JSON enforcer: id i decodes to
    JSONISH (even i) or GARBAGE (odd i), cycling."""

    def __init__(self, n: int):
        self.strings = [(JSONISH if i % 2 == 0 else GARBAGE)[
            (i // 2) % len(JSONISH if i % 2 == 0 else GARBAGE)]
            for i in range(n)]

    def __len__(self):
        return len(self.strings)

    def decode(self, ids, **kw):
        return "".join(self.strings[i] for i in ids)

    def batch_decode(self, batch, **kw):
        return [self.decode(ids) for ids in batch]


def oracle_banned(ctx, gen, vocab: int) -> set:
    """The runtime's host oracle (`_banned_ids`) on a context, capped at the
    vocab (so not capped): the tokens the request's bans forbid next."""
    from types import SimpleNamespace as NS
    from dashinfer_tpu_torch.engine.model_runtime import ModelRuntime
    out = ModelRuntime._banned_ids(
        NS(rt=NS(max_banned_tokens=vocab)),
        NS(gen_cfg=gen, input_ids=list(ctx), generated_ids=[]))
    return set() if out is None else {t for t in out if t >= 0}


def serve_together(eng, name, reqs):
    """Requests [(ids, GenerationConfig)] started while the loop is held
    (admitted in one tick); returns their queues, each finished."""
    from dashinfer_tpu_torch import GenerateRequestStatus
    with held_loop(eng, name, True):
        hs = [eng.start_request(name, ids, gc) for ids, gc in reqs]
    for _, h, _ in hs:
        eng.sync_request(name, h, timeout_s=600)
    for _, h, q in hs:
        check(q.GenerateStatus() == GenerateRequestStatus.GenerateFinished,
              f"{name}: a request ended {q.GenerateStatus().value}")
        eng.release_request(name, h)
    return [q for _, _, q in hs]


def logprob_request(eng, run, name, ids, what):
    """One greedy request with top_logprobs = 5: every token is its top-1
    id, its logprob is the top-1 logprob, every value finite and <= 0, the
    top-5 in descending order; it takes single steps only. Returns
    (tokens, token logprobs, top pairs)."""
    from dashinfer_tpu_torch import GenerationConfig
    dl0 = dict(run.decode_launches)
    gc = GenerationConfig(max_length=len(ids) + MS_FEATURE_TOKENS,
                          do_sample=False, top_k=1, eos_token_id=-1,
                          logprobs=True, top_logprobs=MS_TOP_LOGPROBS)
    el = serve_together(eng, name, [(ids, gc)])[0].GetNoWait()
    toks, lps, pairs = (el.ids_from_generate, el.token_logprobs_list,
                        el.log_probs_list)
    check(len(toks) == len(lps) == len(pairs) == MS_FEATURE_TOKENS,
          f"{what} logprobs: {len(toks)} tokens, {len(lps)} logprobs, "
          f"{len(pairs)} top lists")
    for i, (t, lp, pr) in enumerate(zip(toks, lps, pairs)):
        vals = [v for _, v in pr]
        check(len(pr) == MS_TOP_LOGPROBS and pr[0][0] == t and
              vals[0] == lp and all(math.isfinite(v) and v <= 0
                                    for v in vals) and
              vals == sorted(vals, reverse=True),
              f"{what} logprobs, token {i}: token {t}, logprob {lp}, top "
              f"{pr}")
    check(run.decode_launches["multi"] == dl0["multi"],
          f"{what}: a logprobs request ran in a window")
    return toks, lps, pairs


def ban_requests(eng, run, name, prompts, single):
    """Two greedy requests whose bad words come from the single-step run's
    own output (greedy request 0's 4th token; greedy request 2's 6th and
    7th) with no_repeat_ngram_size 3: through windows with the on-device
    mask, then through the host channel (`_device_ban_fits` forced false:
    single synchronous steps). The tokens are equal, the first run used
    windows, and no token is one the host oracle bans at its position."""
    from dashinfer_tpu_torch import GenerationConfig
    words = [[single[0][3]], [single[2][5], single[2][6]]]

    def reqs():
        return [(prompts[i], GenerationConfig(
            max_length=len(prompts[i]) + MS_FEATURE_TOKENS, do_sample=False,
            top_k=1, eos_token_id=-1, bad_words_ids=words,
            no_repeat_ngram_size=3)) for i in (0, 2)]
    dl0 = dict(run.decode_launches)
    dev = [q.GetAllGeneratedTokens() for q in serve_together(eng, name,
                                                             reqs())]
    dl1 = dict(run.decode_launches)
    run._device_ban_fits = lambda g: False
    try:
        host = [q.GetAllGeneratedTokens() for q in serve_together(
            eng, name, reqs())]
    finally:
        del run._device_ban_fits
    dl2 = dict(run.decode_launches)
    windows = dl1["multi"] - dl0["multi"]
    check(dev == host, f"bans: the on-device mask's tokens {dev} differ "
          f"from the host channel's {host}")
    check(windows > 0 and dl2["multi"] == dl1["multi"],
          f"bans: windows {windows} with the device mask, "
          f"{dl2['multi'] - dl1['multi']} with the host channel")
    for (ids, gc), toks in zip(reqs(), dev):
        for t, tok in enumerate(toks):
            check(tok not in oracle_banned(ids + toks[:t], gc,
                                           run.cfg.vocab_size),
                  f"bans: token {t} ({tok}) is banned by the host oracle")
    moved = [d != s[:MS_FEATURE_TOKENS] for d, s in zip(dev, (single[0],
                                                             single[2]))]
    print(f"bans (words {words}, no_repeat_ngram_size 3): {windows} "
          f"windows with the device mask, {dl2['single'] - dl1['single']} "
          f"single steps through the host channel, tokens equal, none "
          f"banned by the host oracle; the bans moved the tokens of "
          f"request(s) {[i for i, m in zip((0, 2), moved) if m]}",
          flush=True)
    return dict(words=words, windows=windows,
                host_single_steps=dl2["single"] - dl1["single"])


def json_request(eng, run, name, tok, ids):
    """One seeded json_object request (the JsonishTokenizer over the whole
    vocab, EOS a garbage id): its text is a JSON prefix by the port's
    `advance_str` (whole JSON, by `json.loads`, if the acceptor says so);
    it takes single steps only."""
    from dashinfer_tpu_torch import GenerationConfig
    from dashinfer_tpu_torch.engine.guided import (JsonState, advance_str,
                                                   is_complete)
    dl0 = dict(run.decode_launches)
    gc = GenerationConfig(max_length=len(ids) + MS_JSON_TOKENS,
                          do_sample=True, top_k=0, temperature=1.0, seed=11,
                          eos_token_id=JSON_EOS,
                          response_format={"type": "json_object"})
    out = serve_together(eng, name, [(ids, gc)])[0].GetAllGeneratedTokens()
    text = "".join(tok.strings[i] for i in out if i != JSON_EOS)
    st = JsonState()
    check(advance_str(st, text), f"JSON mode: not a JSON prefix: {text!r}")
    if is_complete(st):
        json.loads(text)
    check(run.decode_launches["multi"] == dl0["multi"],
          "JSON mode: a guided request ran in a window")
    print(f"JSON mode: {len(out)} tokens, {'whole JSON' if is_complete(st) else 'a JSON prefix'}: "
          f"{text[:160]!r}", flush=True)
    return dict(tokens=len(out), complete=is_complete(st), text=text[:400])


def check_serving_multistep(params, dev, details):
    """Qwen2-7B served with decode windows of MS_STEPS steps (one CUDA graph
    a window) on the default path, per-op and on a (1, 2) mesh whose ranks
    share the card (TP segments), each beside the single-step serving of
    the same path in this call, every prefill admitted before the first
    decode step so that both see the same batch at every step: every
    token, greedy and seeded, equal; the launch counts match the windows
    and one graph capture a window key (serve()). The default path also
    with windows of 8. On the default path's window engine: bans (device
    mask in windows against the host channel), logprobs (and on the per-op
    one, the two paths' logprobs within 4 x LOGITS_RTOL x max|logit| where
    their tokens agree) and guided JSON."""
    import torch
    from dashinfer_tpu_torch import ModelConfig
    from dashinfer_tpu_torch.engine.guided import JsonFormatEnforcer
    cfg = ModelConfig(**QWEN2_7B)
    tok = JsonishTokenizer(cfg.vocab_size)
    t0 = time.monotonic()
    JsonFormatEnforcer(tok, JSON_EOS, cfg.vocab_size).allowed_mask()
    build_s = time.monotonic() - t0
    print(f"JSON enforcer over {cfg.vocab_size} ids: trie and first mask in "
          f"{build_s:.2f} s", flush=True)
    # the logprobs tolerance: each path's logits within LOGITS_RTOL x
    # max|logit| of the reference (section 2), so the two paths within
    # twice that; a log-softmax moves by at most twice its logits' max|d|
    rows = paths_teacher_forced(cfg, params, dev, n=20, steps=8)
    max_logit = max(r[2] for r in rows)
    lp_tol = 4 * LOGITS_RTOL * max_logit
    out = dict(enforcer_build_s=build_s, logprob_tol=lp_tol,
               teacher_forced_max_d=max(r[0] for r in rows))
    devices = tp_devices(dev)
    tokens, features = {}, {}
    for path, n_steps in (("megakernel", 1), ("megakernel", MS_STEPS),
                          ("megakernel", 8), ("per-op", 1),
                          ("per-op", MS_STEPS), ("tp", 1),
                          ("tp", MS_STEPS)):
        extra = None
        if n_steps == MS_STEPS and path != "tp":
            def extra(eng, run, name, prompts, toks, path=path):
                if path == "megakernel":
                    features["bans"] = ban_requests(
                        eng, run, name, prompts, tokens[("megakernel", 1)])
                    features["json"] = json_request(eng, run, name, tok,
                                                    prompts[1])
                features[f"logprobs {path}"] = logprob_request(
                    eng, run, name, prompts[0], path)
        _, tokens[(path, n_steps)], _ = serve(
            params, dev, details, path, MS_TOKENS[path],
            devices=devices if path == "tp" else None, n_steps=n_steps,
            together=True, tokenizer=tok if extra else None, extra=extra)
        if n_steps > 1:
            a, b = tokens[(path, 1)], tokens[(path, n_steps)]
            apart = [(PROMPT_LENS[i], j) for i in range(len(a))
                     for j in range(len(a[i])) if a[i][j] != b[i][j]][:8]
            check(not apart, f"{path} x{n_steps}: tokens differ from the "
                  f"single-step serving's at (prompt, token) {apart}")
            print(f"{path} x{n_steps}: every token of the six requests "
                  "equal to the single-step serving's", flush=True)
    # the two paths' logprobs where their tokens agree
    (ta, la, pa), (tb, lb, pb) = (features["logprobs megakernel"],
                                  features["logprobs per-op"])
    same = next((j for j in range(len(ta)) if ta[j] != tb[j]), len(ta))
    d = max([abs(x - y) for x, y in zip(la[:same], lb[:same])] +
            [abs(u[1] - v[1]) for p, q in zip(pa[:same], pb[:same])
             for u, v in zip(p, q) if u[0] == v[0]] + [0.0])
    check(d <= lp_tol, f"logprobs: the default and per-op paths differ by "
          f"{d:.4g} over their first {same} common tokens (tolerance "
          f"{lp_tol:.4g})")
    print(f"logprobs (top {MS_TOP_LOGPROBS}): the default and per-op paths "
          f"agree on {same} of {len(ta)} tokens, their logprobs there within "
          f"{d:.4g} (tolerance {lp_tol:.4g} = 4 x {LOGITS_RTOL} x "
          f"max|logit| {max_logit:.2f})", flush=True)
    out.update(bans=features["bans"], json=features["json"],
               logprob_agree=same, logprob_max_d=d)
    # decode ms/step: StatInfo's generate_tps counts the tokens after the
    # first over the time from the first token's drain to the finish; the
    # first token is drained at the second decode launch, and that drain's
    # copy waits for the launch before it returns, so the interval spans
    # the steps after the first two launches (2 x n_steps), not the tokens
    # it counts: ms/step = the interval / those steps
    summary = {}
    smi = nvidia_smi_line()
    for path, n_steps in tokens:
        key = f"serving_qwen2-7b_{path}" + (f"_x{n_steps}" if n_steps > 1
                                            else "") + "_together"
        e = details[key]
        ms = [r["decode_ms_per_step"] for r in e["requests"]]
        dl = e["decode_launches"]
        steps = n_steps * dl["multi"] + dl["single"]
        per_step = [m * (r["n_tokens"] - 1) / (steps - 2 * n_steps)
                    for m, r in zip(ms, e["requests"])]
        summary[f"{path} x{n_steps}"] = dict(
            ms_per_step=(min(per_step), max(per_step)),
            stat_ms_per_token=(min(ms), max(ms)),
            wall_ms_per_step=1e3 * e["wall_s"] / steps,
            decode_launches=e["decode_launches"], captures=e["captures"])
    for path in ("megakernel", "per-op", "tp"):
        for n_steps in (MS_STEPS, 8):
            w = summary.get(f"{path} x{n_steps}")
            if w is None:
                continue
            s = summary[f"{path} x1"]
            print(f"qwen2-7b {path}: decode ms/step single step "
                  f"{s['ms_per_step'][0]:.3f} .. {s['ms_per_step'][1]:.3f} "
                  f"| windows of {n_steps} {w['ms_per_step'][0]:.3f} .. "
                  f"{w['ms_per_step'][1]:.3f} ({w['decode_launches']}; "
                  f"StatInfo ms a token {s['stat_ms_per_token'][1]:.3f} | "
                  f"{w['stat_ms_per_token'][1]:.3f}) [{smi}]", flush=True)
    out["summary"] = summary
    details["serve_multistep"] = out
    torch.cuda.empty_cache()
    return out


def check_serving_lora(params, dev, details):
    """Qwen2-7B with `enable_lora` served through `Engine` with the default
    flags and on the per-op path (serve_lora_run): the LoRA batch's decode
    steps go through the decode megakernel's LoRA branch (its launch count
    at least one a step, no per-op decode kernel, the adapters' prompts
    per-op and the prefill megakernel for the one bucket-128 prompt
    without an adapter); every request's first 8 greedy tokens equal
    the per-op path's; the adapter loaded into a1's slot mid-run is the one
    a1's prompt then follows (the per-op path's tokens, and not a1's),
    without a second capture of the LoRA graph. Returns the LoRA branch's
    launches."""
    import torch
    from dashinfer_tpu_torch.config import ModelConfig
    cfg = ModelConfig(**QWEN2_7B)
    import tempfile
    served = dict(b_std=LORA_SERVE_B_STD, steer=LORA_SERVE_STEER)
    adapters = {f"a{i}": lora_adapter(cfg, SEED + 81 + i, dev, **served)
                for i in range(3)}
    swap = lora_adapter(cfg, SEED + 91, dev, **served)
    with tempfile.TemporaryDirectory() as tmp:
        adapters["a1_dir"] = os.path.join(tmp, "a1")
        write_peft_bin(cfg, adapters.pop("a1"), adapters["a1_dir"])
        mk_l, mk_toks, mk_swap, mk_stats = serve_lora_run(
            params, dev, details, "megakernel", 32, adapters, swap)
        op_l, op_toks, op_swap, _ = serve_lora_run(
            params, dev, details, "per-op", 12, adapters, swap)
    L, new = cfg.num_layers, 32
    per_step = 7 * L + 1
    quant = sum(per_step if n <= 32 else 1 for n, lora in LORA_SERVE
                if lora is not None or n <= 64)
    mega_prefills = sum(1 for n, lora in LORA_SERVE
                        if lora is None and 64 < n <= 1024)
    check(mk_l["decode_megakernel_lora"] >= new - 1 and
          mk_l["paged_attention"] == 0 and mk_l["quant_matmul"] == quant and
          mk_l["prefill_megakernel"] == mega_prefills,
          f"serve_lora megakernel: launch counts {mk_l}; want the LoRA "
          f"branch at least {new - 1}, no paged_attention, {quant} "
          f"quant_matmul (the per-op prefills) and {mega_prefills} prefill "
          "megakernel launches")
    check(op_l["decode_megakernel_lora"] == 0 and
          op_l["decode_megakernel"] == 0 and op_l["paged_attention"] > 0,
          f"serve_lora per-op: launch counts {op_l}")
    agree = []
    for (n, lora), a, b in zip(LORA_SERVE, mk_toks, op_toks):
        same = next((j for j in range(len(b)) if a[j] != b[j]), len(b))
        agree.append(same)
        print(f"lora request prompt={n} adapter={lora}: the megakernel and "
              f"per-op paths agree on the first {same} of {len(b)} tokens",
              flush=True)
        check(same >= 8, f"lora request (prompt {n}, {lora}): the paths "
              f"agree on only {same} tokens")
    same = next((j for j in range(len(op_swap)) if mk_swap[j] != op_swap[j]),
                len(op_swap))
    print(f"a1's prompt: under a1 {mk_toks[1]}, under a3 {mk_swap} (per-op "
          f"{op_swap})", flush=True)
    check(same >= 8, f"the adapter loaded into a1's slot: the paths agree "
          f"on only {same} tokens")
    check(mk_swap != mk_toks[1], "a1's prompt gives the same tokens with "
          "the adapter loaded into a1's slot as with a1")
    print(f"lora slot reuse: a1's prompt under a3 agrees with the per-op "
          f"path on {same} of {len(op_swap)} tokens and differs from its "
          f"tokens under a1", flush=True)
    lstep = [r["decode_ms_per_step"] for r in mk_stats["lora_batch"]]
    dstep = [r["decode_ms_per_step"] for r in mk_stats["dense_batch"]]
    summary = dict(
        lora_ms_per_step=(min(lstep), max(lstep)),
        dense_ms_per_step=(min(dstep), max(dstep)),
        lora_ttft_ms=max(r["ttft_ms"] for r in mk_stats["lora_batch"]),
        dense_ttft_ms=max(r["ttft_ms"] for r in mk_stats["dense_batch"]),
        agree=agree, swap_agree=same, launches=mk_l)
    details["lora_serving_summary"] = summary
    print(f"qwen2-7b LoRA serving: decode {min(lstep):.2f} .. "
          f"{max(lstep):.2f} ms/step with the adapters' rows, "
          f"{min(dstep):.2f} .. {max(dstep):.2f} without adapters; TTFT "
          f"(the eight prompts together) {summary['lora_ttft_ms']:.1f} ms "
          f"against {summary['dense_ttft_ms']:.1f}", flush=True)
    torch.cuda.empty_cache()
    return mk_l["decode_megakernel_lora"]


PHASES = ("quant_matmul", "paged_attention", "grouped_quant_matmul",
          "stream_probe", "probes", "megakernel", "prefill_megakernel",
          "serve", "decode_logits", "tp_segments", "tp_prefill", "serve_tp",
          "lora", "serve_lora", "serve_multistep", "qwen3", "serve_qwen3",
          "baichuan",
          "serve_baichuan", "tp_moe", "serve_tp_moe", "qwen3_moe")
MOE_PHASES = ("megakernel", "prefill_megakernel", "serve", "tp_moe",
              "serve_tp_moe")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", help="write per-shape results as JSON here")
    ap.add_argument("--only", help="comma-separated subset of "
                    f"{', '.join(PHASES)} (after the build); prints no "
                    "final result line")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else PHASES
    if any(p not in PHASES for p in only):
        ap.error(f"--only takes {PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dashinfer_tpu_torch.ops import kernel_build
    except ImportError as e:
        print(f"chip_smoke: the dashinfer_tpu_torch package is missing "
              f"({e})", file=sys.stderr)
        return 3

    dev = torch.device("cuda", 0)
    details, res = {}, {}
    t_start = time.monotonic()

    def phase(name, part=""):
        if name in only:
            print(f"-- {name}{part} (t = {time.monotonic() - t_start:.0f} "
                  "s)", flush=True)
        return name in only

    try:
        with torch.no_grad():
            name = torch.cuda.get_device_name(0)
            smi = nvidia_smi_line()
            print(f"device: {name} | nvidia-smi: {smi} | torch "
                  f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
            t0 = time.monotonic()
            secs = kernel_build.build()
            print(f"kernels built in {time.monotonic() - t0:.1f} s "
                  f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})",
                  flush=True)
            details.update(device=name, nvidia_smi=smi,
                           build_s=secs, build_logs=kernel_build.build_logs)

            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            if phase("quant_matmul"):
                res["quant_matmul"] = check_quant_matmul(gen, dev, details)
            if phase("paged_attention"):
                res["paged_attention"] = check_paged_attention(gen, dev,
                                                               details)
            if phase("grouped_quant_matmul"):
                res["grouped_quant_matmul"] = check_grouped_quant_matmul(
                    dev, details)
            if phase("stream_probe"):
                res["stream_probe"] = check_stream_probe(dev, details)
            if phase("probes"):
                res.update(check_probes(dev, details))
            params = random_qwen2_7b_params(SEED, dev)
            if phase("megakernel"):
                res["decode_megakernel"] = check_megakernel(params, dev,
                                                            details)
            if phase("prefill_megakernel"):
                res["prefill_megakernel"] = check_prefill_megakernel(
                    params, dev, details)
            single_tokens = None
            if phase("serve"):
                mk_launches, op_launches, po_launches, single_tokens = \
                    check_serving(params, dev, details)
            if phase("decode_logits"):
                check_decode_logits(params, dev, details)
            if phase("tp_segments"):
                res.update(check_tp_segments(params, dev, details))
            if phase("tp_prefill"):
                res.update(check_tp_prefill(params, dev, details))
            if phase("serve_tp"):
                if single_tokens is None:     # --only without serve
                    single_tokens = {p: serve(params, dev, details, p, n)[1]
                                     for p, n in (("megakernel", 64),
                                                  ("per-op", 24))}
                tp_launches = check_serving_tp(params, dev, details,
                                               single_tokens)
            if phase("lora"):
                res["lora"] = check_lora(params, dev, details)
            if phase("serve_lora"):
                lora_launches = check_serving_lora(params, dev, details)
            if phase("serve_multistep"):
                check_serving_multistep(params, dev, details)
            # Qwen3-8B (QK-norm), on the card alone: Qwen2-7B's weights go
            # first
            del params
            torch.cuda.empty_cache()
            q3_launches = None
            if "qwen3" in only or "serve_qwen3" in only:
                q3_params = random_qwen3_params(SEED + 61, dev)
                if phase("qwen3"):
                    res["qwen3"] = check_qwen3(q3_params, dev, details)
                if phase("serve_qwen3"):
                    q3_launches = check_serving_qwen3(q3_params, dev,
                                                      details)
                del q3_params
                torch.cuda.empty_cache()
            # Baichuan2-13B (ALiBi), on the card alone
            bc_launches = None
            if phase("baichuan"):
                bc_params = random_baichuan_params(baichuan_config(),
                                                   SEED + 79, dev)
                res["baichuan"] = check_baichuan(bc_params, dev, details)
                del bc_params
                torch.cuda.empty_cache()
            if phase("serve_baichuan"):
                bc_params = random_baichuan_params(baichuan_config(),
                                                   SEED + 79, dev,
                                                   zero_mean=False)
                bc_launches = check_serving_baichuan(bc_params, dev, details)
                del bc_params
                torch.cuda.empty_cache()
            # the MoE slice
            if any(p in only for p in MOE_PHASES):
                moe_cfg = moe_config()
                moe_params = random_moe_params(moe_cfg, SEED + 13, dev)
            if phase("megakernel", " (Qwen1.5-MoE)"):
                res["decode_megakernel_moe"] = check_megakernel_moe(
                    moe_cfg, moe_params, dev, details)
            if phase("prefill_megakernel", " (Qwen1.5-MoE)"):
                res["prefill_megakernel_moe"] = check_prefill_megakernel_moe(
                    moe_cfg, moe_params, dev, details)
            moe_single = None
            if phase("serve", " (Qwen1.5-MoE)"):
                moe_launches, moe_op_launches, moe_single = \
                    check_serving_moe(moe_params, moe_cfg, dev, details,
                                      prefill_per_op="serve_tp_moe" in only)
            if phase("tp_moe"):
                res["tp_moe_segment"] = check_tp_moe(moe_cfg, moe_params,
                                                     dev, details)
            if phase("serve_tp_moe"):
                if moe_single is None:        # --only without serve
                    moe_single = {p: serve(moe_params, dev, details, p, n,
                                           moe_cfg)[1]
                                  for p, n in (("megakernel prefill per-op",
                                                64), ("per-op", 24))}
                tp_moe_launches = check_serving_tp_moe(
                    moe_params, moe_cfg, dev, details, moe_single)
            if any(p in only for p in MOE_PHASES):
                del moe_params
                torch.cuda.empty_cache()
            # Qwen3-30B-A3B's width at QWEN3_MOE_LAYERS layers
            if phase("qwen3_moe"):
                q3m_cfg = qwen3_moe_config()
                q3m_params = random_moe_params(q3m_cfg, SEED + 67, dev)
                res["qwen3_moe"] = check_qwen3_moe(q3m_cfg, q3m_params, dev,
                                                   details)
                del q3m_params
                torch.cuda.empty_cache()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if args.details:
            os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                        exist_ok=True)
            with open(args.details, "w") as f:
                json.dump(details, f, indent=1, default=str)
    print(f"-- done (t = {time.monotonic() - t_start:.0f} s)", flush=True)
    if only != PHASES:
        return 0

    # launches: each kernel's count over the timed requests of the path it
    # serves (the per-op path for the first two, the megakernel path for
    # the third and the fifth, the MoE model's default serving for the
    # grouped GEMM and the megakernels' MoE entries, the (1, 2) mesh's
    # default serving for the TP segments and the TP prefill segments, the
    # MoE model's on the (1, 2) mesh for the moe segment), and over the
    # probe tools' own
    # runs for the fourth and the two probes
    csrc = "dashinfer_tpu_torch/csrc/"
    moe_decode = dict(launches=moe_launches["decode_megakernel"],
                      **res["decode_megakernel_moe"])
    moe_prefill = dict(launches=moe_launches["prefill_megakernel"],
                       **res["prefill_megakernel_moe"])
    # Qwen3 (the QK-norm branch): its kernels' numbers with the launches of
    # its default serving (the megakernels) and of its (1, 2) mesh serving
    # (the TP segments); the MoE entries with the launches of the
    # Qwen3-MoE model's default serving
    q3, q3m = res["qwen3"], res["qwen3_moe"]

    def q3_entry(kernel, path):
        return dict(launches=q3_launches[path][kernel], **q3[kernel])
    # Baichuan2-13B (the ALiBi branch): the megakernels' numbers with the
    # launches of its default serving; the TP segments' at the TP check
    # geometry, which no serving runs (supports_tp turns Baichuan2-13B
    # away), under `baichuan_tp_check`
    bc = res["baichuan"]

    def bc_entry(kernel):
        if kernel.startswith("tp_"):
            return {"baichuan_tp_check": bc[kernel]}
        return {"baichuan": dict(
            launches=bc_launches["megakernel"][kernel], **bc[kernel])}
    kernels = [
        dict(name="quant_matmul", route="cuda",
             source=csrc + "quant_matmul.cu",
             replaces="dashinfer_tpu/ops/pallas/quant_matmul.py:80",
             launches=op_launches["quant_matmul"], **res["quant_matmul"]),
        dict(name="paged_attention", route="cuda",
             source=csrc + "paged_attention.cu",
             replaces="dashinfer_tpu/ops/pallas/paged_attention.py:148",
             launches=op_launches["paged_attention"],
             **res["paged_attention"]),
        dict(name="decode_megakernel", route="cuda",
             source=csrc + "megakernel.cu",
             replaces="dashinfer_tpu/ops/pallas/megakernel.py:1297",
             launches=mk_launches["decode_megakernel"],
             **res["decode_megakernel"], moe=moe_decode,
             qwen3=q3_entry("decode_megakernel", "megakernel"),
             qwen3_moe=q3m["decode_megakernel"],
             lora=dict(launches=lora_launches, **res["lora"]),
             **bc_entry("decode_megakernel")),
        dict(name="stream_probe", route="cuda",
             source=csrc + "stream_probe.cu",
             replaces="tools/bench_stream.py:41", **res["stream_probe"]),
        dict(name="prefill_megakernel", route="cuda",
             source=csrc + "prefill_megakernel.cu",
             replaces="dashinfer_tpu/ops/pallas/prefill_megakernel.py:480",
             launches=mk_launches["prefill_megakernel"],
             launches_pack_only=po_launches["prefill_megakernel"],
             **res["prefill_megakernel"], moe=moe_prefill,
             qwen3=q3_entry("prefill_megakernel", "megakernel"),
             qwen3_moe=q3m["prefill_megakernel"],
             **bc_entry("prefill_megakernel")),
        dict(name="grouped_quant_matmul", route="cuda",
             source=csrc + "grouped_quant_matmul.cu",
             replaces="dashinfer_tpu/ops/pallas/grouped_quant_matmul.py:206",
             launches=moe_launches["grouped_quant_matmul"],
             launches_per_op_path=moe_op_launches["grouped_quant_matmul"],
             **res["grouped_quant_matmul"]),
        dict(name="probe_magic_dequant", route="cuda",
             source=csrc + "probes.cu",
             replaces="tools/probe_magic_dequant.py:83",
             **res["probe_magic_dequant"]),
        dict(name="probe_reshape", route="cuda", source=csrc + "probes.cu",
             replaces="tools/probe_reshape.py:26", **res["probe_reshape"]),
    ] + [
        # the TP segments' launches: the (1, 2) mesh serving with the
        # default flags
        dict(name=f"tp_{k}_segment", route="cuda",
             source=csrc + "tp_segments.cu",
             replaces=f"dashinfer_tpu/ops/pallas/tp_megakernel.py:{line}",
             launches=tp_launches["tp"][f"tp_{k}_segment"],
             **res[f"tp_{k}_segment"],
             **({"qwen3": q3_entry(f"tp_{k}_segment", "tp")}
                if k != "mlp" else {}), **bc_entry(f"tp_{k}_segment"))
        for k, line in (("attn", 346), ("mlp", 849), ("lm", 1167))] + [
        dict(name=f"tp_prefill_{k}_segment", route="cuda",
             source=csrc + "tp_prefill_segments.cu",
             replaces=f"dashinfer_tpu/ops/pallas/tp_megakernel.py:{line}",
             launches=tp_launches["tp"][f"tp_prefill_{k}_segment"],
             **res[f"tp_prefill_{k}_segment"],
             **({"qwen3": q3_entry(f"tp_prefill_{k}_segment", "tp")}
                if k != "mlp" else {}),
             **bc_entry(f"tp_prefill_{k}_segment"))
        for k, line in (("attn", 1374), ("mlp", 1659), ("lm", 1749))] + [
        # the (1, 2) mesh's MoE serving with the default flags
        dict(name="tp_moe_segment", route="cuda",
             source=csrc + "tp_segments.cu",
             replaces="dashinfer_tpu/ops/pallas/tp_megakernel.py:951",
             launches=tp_moe_launches["tp"]["tp_moe_segment"],
             **res["tp_moe_segment"])]
    for k in kernels:
        check_keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")
        parts = [k] + [k[m] for m in ("moe", "qwen3", "qwen3_moe", "lora",
                                      "baichuan") if m in k]
        if any(key not in p or (key == "launches" and p[key] <= 0)
               for p in parts for key in check_keys) or \
                ("baichuan_tp_check" in k and any(
                    key not in k["baichuan_tp_check"]
                    for key in check_keys if key != "launches")):
            print(f"chip_smoke: FAIL: kernel line of {k['name']}: {k}",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": kernels}))
    # the Qwen3-MoE TP moe segment (checked and timed; not served on a mesh)
    print(json.dumps({"qwen3_moe_tp_moe_segment": q3m["tp_moe_segment"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
