"""The port stands alone: it imports and serves with JAX blocked, and no
module of it (nor chip_smoke.py) imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np
import dashinfer_tpu_torch as tp
from dashinfer_tpu_torch.config import ModelConfig

L, hid, inter, V, H, KH, D = 2, 64, 128, 256, 4, 2, 16
rng = np.random.RandomState(0)
def lin(i, o):
    return {"w": (rng.randn(L, i, o) * 0.1).astype(np.float32),
            "b": np.zeros((L, o), np.float32)}
params = {"embed_tokens": {"w": rng.randn(V, hid).astype(np.float32)},
          "norm": np.ones(hid, np.float32),
          "lm_head": {"w": (rng.randn(hid, V) * 0.1).astype(np.float32)},
          "layers": {"input_layernorm": np.ones((L, hid), np.float32),
                     "post_attention_layernorm": np.ones((L, hid), np.float32),
                     "q_proj": lin(hid, H * D), "k_proj": lin(hid, KH * D),
                     "v_proj": lin(hid, KH * D), "o_proj": lin(H * D, hid),
                     "gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                     "down_proj": lin(inter, hid)}}
cfg = ModelConfig(arch="qwen2", vocab_size=V, hidden_size=hid,
                  intermediate_size=inter, num_layers=L, num_heads=H,
                  num_kv_heads=KH, head_dim=D, qkv_bias=True)
rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(2)
      .kv_cache_page_size(16).kv_cache_mode(tp.CacheMode.INT8)
      .weight_quant("a16w4", 32).dtype("float32").build())
eng = tp.Engine().install_model("m", rt, params=params, model_config=cfg,
                                device="cpu").start_model("m")
_, h, q = eng.start_request("m", [1, 2, 3], tp.GenerationConfig(
    max_length=12, do_sample=False, top_k=1, eos_token_id=-1))
eng.sync_request("m", h, timeout_s=120)
eng.release_model("m")
assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
assert len(q.GetAllGeneratedTokens()) == 9
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "dashinfer_tpu" or m.startswith("dashinfer_tpu.")
               for m in sys.modules)
print("SERVED")
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout


def test_port_serves_on_a_mesh_with_jax_blocked():
    """The same model on a (1, 2) mesh of CPU ranks (the per-op TP path)."""
    script = _SERVE_WITHOUT_JAX.replace(
        '.dtype("float32").build())', '.dtype("float32").mesh(1, 2).build())'
    ).replace('device="cpu"', 'device=["cpu", "cpu"]')
    assert script.count("mesh(1, 2)") == 1 and '["cpu", "cpu"]' in script
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout


_PREFILL_ON_A_MESH_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np
import dashinfer_tpu_torch as tp
from dashinfer_tpu_torch.config import ModelConfig

L, hid, inter, V, H, KH, D = 2, 256, 256, 512, 4, 2, 128
rng = np.random.RandomState(0)
def lin(i, o, bias=False):
    d = {"w": (rng.randn(L, i, o) * 0.05).astype(np.float32)}
    if bias:
        d["b"] = (rng.randn(L, o) * 0.01).astype(np.float32)
    return d
params = {"embed_tokens": {"w": rng.randn(V, hid).astype(np.float32)},
          "norm": np.ones(hid, np.float32),
          "lm_head": {"w": (rng.randn(hid, V) * 0.05).astype(np.float32)},
          "layers": {"input_layernorm": np.ones((L, hid), np.float32),
                     "post_attention_layernorm": np.ones((L, hid), np.float32),
                     "q_proj": lin(hid, H * D, True),
                     "k_proj": lin(hid, KH * D, True),
                     "v_proj": lin(hid, KH * D, True),
                     "o_proj": lin(H * D, hid),
                     "gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                     "down_proj": lin(inter, hid)}}
cfg = ModelConfig(arch="qwen2", vocab_size=V, hidden_size=hid,
                  intermediate_size=inter, num_layers=L, num_heads=H,
                  num_kv_heads=KH, head_dim=D, qkv_bias=True)
rt = (tp.RuntimeConfigBuilder("m").max_length(160).max_batch(2)
      .kv_cache_page_size(16).kv_cache_num_pages(48)
      .kv_cache_mode(tp.CacheMode.INT8).weight_quant("a16w4", 128)
      .dtype("float32").mesh(1, 2).update({"min_prefill_bucket": 128})
      .build())
eng = tp.Engine().install_model("m", rt, params=params, model_config=cfg,
                                device=["cpu", "cpu"]).start_model("m")
run = eng._models["m"]
assert run.tp_mega_plan is not None and sorted(run._tp_pmk_plans) == [128]
_, h, q = eng.start_request("m", [1, 2, 3, 4, 5, 6], tp.GenerationConfig(
    max_length=14, do_sample=False, top_k=1, eos_token_id=-1))
eng.sync_request("m", h, timeout_s=120)
eng.release_model("m")
assert set(run._prefill_steps) == {(128, "tp")}
assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
assert len(q.GetAllGeneratedTokens()) == 8
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "dashinfer_tpu" or m.startswith("dashinfer_tpu.")
               for m in sys.modules)
print("SERVED")
"""


def test_port_prefills_on_a_mesh_through_the_segments_with_jax_blocked():
    """A head_dim-128 model on a (1, 2) mesh of CPU ranks: the TP prefill
    segments' and the TP decode segments' modules (their plain versions on
    the CPU) serve with JAX blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _PREFILL_ON_A_MESH_WITHOUT_JAX],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout


_SERVE_MOE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import numpy as np
import dashinfer_tpu_torch as tp
from dashinfer_tpu_torch.config import ModelConfig, MoEConfig

L, hid, Im, V, H, KH, D, E = 2, 64, 96, 256, 2, 2, 32, 4
rng = np.random.RandomState(0)
def lin(i, o, bias=False):
    d = {"w": (rng.randn(L, i, o) * 0.1).astype(np.float32)}
    if bias:
        d["b"] = np.zeros((L, o), np.float32)
    return d
def stack(i, o):
    return (rng.randn(L, E, i, o) * 0.1).astype(np.float32)
params = {"embed_tokens": {"w": rng.randn(V, hid).astype(np.float32)},
          "norm": np.ones(hid, np.float32),
          "lm_head": {"w": (rng.randn(hid, V) * 0.1).astype(np.float32)},
          "layers": {"input_layernorm": np.ones((L, hid), np.float32),
                     "post_attention_layernorm": np.ones((L, hid), np.float32),
                     "q_proj": lin(hid, H * D, True),
                     "k_proj": lin(hid, KH * D, True),
                     "v_proj": lin(hid, KH * D, True),
                     "o_proj": lin(H * D, hid),
                     "router": {"w": rng.randn(L, hid, E).astype(np.float32)},
                     "experts": {"gate_proj": stack(hid, Im),
                                 "up_proj": stack(hid, Im),
                                 "down_proj": stack(Im, hid)},
                     "shared_expert": {"gate_proj": lin(hid, Im),
                                       "up_proj": lin(hid, Im),
                                       "down_proj": lin(Im, hid)},
                     "shared_expert_gate": {
                         "w": rng.randn(L, hid, 1).astype(np.float32)}}}
cfg = ModelConfig(arch="qwen2_moe", vocab_size=V, hidden_size=hid,
                  intermediate_size=Im, num_layers=L, num_heads=H,
                  num_kv_heads=KH, head_dim=D, qkv_bias=True,
                  moe=MoEConfig(num_experts=E, num_experts_per_tok=2,
                                moe_intermediate_size=Im,
                                shared_expert_intermediate_size=Im))
rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(2)
      .kv_cache_page_size(16).kv_cache_mode(tp.CacheMode.INT8)
      .weight_quant("a16w4", 32).dtype("float32").build())
eng = tp.Engine().install_model("m", rt, params=params, model_config=cfg,
                                device="cpu").start_model("m")
_, h, q = eng.start_request("m", [1, 2, 3], tp.GenerationConfig(
    max_length=12, do_sample=False, top_k=1, eos_token_id=-1))
eng.sync_request("m", h, timeout_s=120)
eng.release_model("m")
assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
assert len(q.GetAllGeneratedTokens()) == 9
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "dashinfer_tpu" or m.startswith("dashinfer_tpu.")
               for m in sys.modules)
print("SERVED")
"""


def test_port_serves_moe_with_jax_blocked():
    """A tiny Qwen2-MoE, its expert stacks quantized a16w4 by the port's
    loader, served per-op on the CPU with JAX blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _SERVE_MOE_WITHOUT_JAX],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout


_SERVE_LORA_WITHOUT_JAX = r"""
import json, os, struct, sys, tempfile
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["safetensors"] = None    # the port reads .safetensors itself
import numpy as np
import dashinfer_tpu_torch as tp
from dashinfer_tpu_torch.config import ModelConfig

L, hid, inter, V, H, KH, D, R = 2, 64, 128, 256, 4, 2, 16, 4
rng = np.random.RandomState(0)
def lin(i, o):
    return {"w": (rng.randn(L, i, o) * 0.1).astype(np.float32)}
params = {"embed_tokens": {"w": rng.randn(V, hid).astype(np.float32)},
          "norm": np.ones(hid, np.float32),
          "lm_head": {"w": (rng.randn(hid, V) * 0.1).astype(np.float32)},
          "layers": {"input_layernorm": np.ones((L, hid), np.float32),
                     "post_attention_layernorm": np.ones((L, hid), np.float32),
                     "q_proj": lin(hid, H * D), "k_proj": lin(hid, KH * D),
                     "v_proj": lin(hid, KH * D), "o_proj": lin(H * D, hid),
                     "gate_proj": lin(hid, inter), "up_proj": lin(hid, inter),
                     "down_proj": lin(inter, hid)}}
cfg = ModelConfig(arch="qwen2", vocab_size=V, hidden_size=hid,
                  intermediate_size=inter, num_layers=L, num_heads=H,
                  num_kv_heads=KH, head_dim=D)
dims = {"q_proj": (hid, H * D), "k_proj": (hid, KH * D),
        "v_proj": (hid, KH * D), "o_proj": (H * D, hid),
        "gate_proj": (hid, inter), "up_proj": (hid, inter),
        "down_proj": (inter, hid)}
# a PEFT adapter directory, its weights in bf16 .safetensors written here
header, blobs, off = {}, [], 0
for l in range(L):
    for t, (i, o) in dims.items():
        mod = "self_attn" if t in ("q_proj", "k_proj", "v_proj", "o_proj") \
            else "mlp"
        for ab, shape in (("A", (R, i)), ("B", (o, R))):
            a = (rng.randn(*shape) * 0.5).astype(np.float32)
            raw = (a.view(np.uint32) >> 16).astype("<u2").tobytes()
            key = f"base_model.model.model.layers.{l}.{mod}.{t}.lora_{ab}.weight"
            header[key] = {"dtype": "BF16", "shape": list(shape),
                           "data_offsets": [off, off + len(raw)]}
            blobs.append(raw)
            off += len(raw)
tmp = tempfile.mkdtemp()
head = json.dumps(header).encode()
with open(os.path.join(tmp, "adapter_model.safetensors"), "wb") as f:
    f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))
with open(os.path.join(tmp, "adapter_config.json"), "w") as f:
    json.dump({"r": R, "lora_alpha": 8.0}, f)
rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(2)
      .kv_cache_page_size(16).kv_cache_mode(tp.CacheMode.INT8)
      .lora(True, max_num=2, max_rank=8)
      .weight_quant("a16w4", 32).dtype("float32").build())
eng = tp.Engine().install_model("m", rt, params=params, model_config=cfg,
                                device="cpu").start_model("m")
eng.load_lora("m", "peft", tmp)
qs = []
for lora in ("peft", None):
    _, h, q = eng.start_request("m", [1, 2, 3], tp.GenerationConfig(
        max_length=12, do_sample=False, top_k=1, eos_token_id=-1,
        lora_name=lora))
    qs.append((h, q))
for h, q in qs:
    eng.sync_request("m", h, timeout_s=120)
eng.release_model("m")
toks = [q.GetAllGeneratedTokens() for _, q in qs]
assert all(q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
           for _, q in qs)
assert [len(t) for t in toks] == [9, 9] and toks[0] != toks[1], toks
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "dashinfer_tpu" or m.startswith("dashinfer_tpu.")
               for m in sys.modules)
print("SERVED")
"""


def test_port_serves_lora_with_jax_blocked():
    """LoRA served on the CPU with JAX (and the safetensors package)
    blocked: an adapter loaded through `Engine.load_lora` from a PEFT
    directory whose bf16 .safetensors file the script writes itself, then a
    request on it and one without, concurrently; the adapter moves the
    tokens. The LoRA module is among the sources the import check walks."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _SERVE_LORA_WITHOUT_JAX],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"dashinfer_tpu_torch/lora/__init__.py",
            "dashinfer_tpu_torch/lora/manager.py"} <= rel


_SERVE_WINDOWS_WITHOUT_JAX = _SERVE_WITHOUT_JAX.split("rt = (")[0] + r"""
class Tok:                      # ids -> JSON-ish strings, EOS 0
    strings = ['{', '}', '"a"', ':', ' ', '1', ',', '[', ']', 'x'] * (V // 10)
    strings += ['?'] * (V - len(strings))
    def __len__(self):
        return V
    def decode(self, ids, **kw):
        return "".join(self.strings[i] for i in ids)
rt = (tp.RuntimeConfigBuilder("m").max_length(64).max_batch(3)
      .kv_cache_page_size(16).dtype("float32")
      .update({"decode_steps_per_launch": 3, "enable_json_mode": True})
      .build())
eng = tp.Engine().install_model("m", rt, params=params, model_config=cfg,
                                device="cpu", tokenizer=Tok())
eng.start_model("m")
run = eng._models["m"]
gens = [tp.GenerationConfig(max_length=40, do_sample=False, top_k=1,
                            eos_token_id=-1, bad_words_ids=[[5], [7, 8]],
                            no_repeat_ngram_size=2),
        tp.GenerationConfig(max_length=20, do_sample=False, top_k=1,
                            eos_token_id=-1, logprobs=True, top_logprobs=2),
        tp.GenerationConfig(max_length=20, do_sample=True, top_k=0, seed=3,
                            eos_token_id=0,
                            response_format={"type": "json_object"})]
hs = [eng.start_request("m", [1, 2, 3], g) for g in gens]
for _, h, _q in hs:
    eng.sync_request("m", h, timeout_s=120)
launches = dict(run.decode_launches)
eng.release_model("m")
(_, _, qb), (_, _, ql), (_, _, qj) = hs
for _, _, q in hs:
    assert q.GenerateStatus() == tp.GenerateRequestStatus.GenerateFinished
banned = qb.GetAllGeneratedTokens()
assert len(banned) == 37 and 5 not in banned
seq = [1, 2, 3] + banned
assert len(set(zip(seq, seq[1:]))) == len(seq) - 1
el = ql.GetNoWait()
assert len(el.token_logprobs_list) == len(el.ids_from_generate) == 17
assert all(p[0][0] == t for p, t in zip(el.log_probs_list,
                                        el.ids_from_generate))
from dashinfer_tpu_torch.engine.guided import JsonState, advance_str
text = "".join(Tok.strings[i] for i in qj.GetAllGeneratedTokens() if i)
assert advance_str(JsonState(), text), text
assert launches["multi"] > 0 and launches["single"] > 0, launches
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "dashinfer_tpu" or m.startswith("dashinfer_tpu.")
               for m in sys.modules)
print("SERVED")
"""


def test_port_serves_windows_and_token_features_with_jax_blocked():
    """decode_steps_per_launch = 3 with JAX blocked: a banned request (bad
    words and a no-repeat 2-gram), a logprobs request and a JSON request
    (a tokenizer of JSON-ish strings) served together; the bans hold, each
    token has its logprobs, the JSON text is a JSON prefix, and windows and
    single steps were both launched (windows once the banned request,
    the longest, runs alone)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _SERVE_WINDOWS_WITHOUT_JAX],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SERVED" in r.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "dashinfer_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dashinfer_tpu")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_the_new_modules_are_checked():
    """The megakernel modules, the MoE modules, the probe tools, the
    tensor-parallel modules and the JSON enforcer are among the sources
    the import check walks."""
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"dashinfer_tpu_torch/ops/megakernel.py",
            "dashinfer_tpu_torch/ops/tp_megakernel.py",
            "dashinfer_tpu_torch/parallel/__init__.py",
            "dashinfer_tpu_torch/parallel/mesh.py",
            "dashinfer_tpu_torch/parallel/collectives.py",
            "dashinfer_tpu_torch/parallel/sharding.py",
            "dashinfer_tpu_torch/ops/moe.py",
            "dashinfer_tpu_torch/ops/grouped_quant_matmul.py",
            "dashinfer_tpu_torch/ops/prefill_megakernel.py",
            "dashinfer_tpu_torch/tools/bench_stream.py",
            "dashinfer_tpu_torch/tools/probe_magic_dequant.py",
            "dashinfer_tpu_torch/tools/probe_reshape.py",
            "dashinfer_tpu_torch/tools/ab_decode.py",
            "dashinfer_tpu_torch/tools/moe_drift.py",
            "dashinfer_tpu_torch/engine/steps.py",
            "dashinfer_tpu_torch/engine/guided.py"} <= rel
