"""Where the MoE decode megakernel and its plain version part, row by row
and layer by layer, on one card.

Rebuilds chip_smoke.py's MoE decode states (Qwen1.5-MoE-A2.7B width, B = 8,
INT8 and UINT4 KV, its seeds), launches csrc/megakernel.cu once on each,
and prints, for every active row and layer, the largest K difference of a
head (dequantized, in shares of the row's range) between the kernel's pool
and the plain version's: routed by its own router, routed as the kernel
routed (`forced_routing`), routed and weighted as the kernel (its gates
too), and routed as the kernel on x0 with one element of each row one bf16
step up (a probe of how far the plain version itself moves with a change of
2^-8 of one input); the plain-to-plain differences; the rows and layers
the two route differently; and each row's residual RMS entering each
layer. Prints the card's `nvidia-smi` name and power limit.

    python -m dashinfer_tpu_torch.tools.moe_drift
"""

import os
import subprocess
import sys


def _moe_ref(plan, packed, x0, st, cache, forced=None, weights=None):
    """The plain decode step (ops/megakernel.py's pieces) -> (logits, the
    residual RMS entering each layer [L, B], each layer's router product);
    `weights` (gates [L, B, k], shared gates [L, B]) replaces the plain
    version's gates at the `forced` experts."""
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    bf = torch.bfloat16
    inp = mk.StepInputs(plan, st["cos"], st["sin"], st["pt"], st["lens"],
                        st["active"])
    resid = x0.to(bf).float()
    rms, router = [], []

    def mm(x_, sp, l_, e):
        return mk._stream_dot(x_, packed, sp, l_, e)

    for l in range(plan.L):
        rms.append(resid.pow(2).mean(-1).sqrt())
        resid = resid + mk.attention_block_ref(plan, packed, l, resid, inp,
                                               cache)
        x = mk._rms(resid, packed["norms"][l, 1], plan.rms_eps).to(bf)
        if weights is None:
            resid = resid + mk.moe_ref(plan, x, l, mm, router,
                                       None if forced is None else forced[l])
            continue
        router.append(mm(x, plan.rt, l, None))
        gates = torch.zeros((x.shape[0], plan.E), device=x.device)
        gates.scatter_(1, forced[l].long(), weights[0][l])
        acc = torch.zeros((x.shape[0], plan.hid), device=x.device)
        for e in torch.nonzero(gates.amax(0) > 0)[:, 0].tolist():
            gu = mm(x, plan.gu, l, e)
            g, u = gu[:, :plan.inter], gu[:, plan.inter:]
            act = (g * torch.sigmoid(g) * u).to(bf)
            acc = acc + gates[:, e:e + 1] * mm(act, plan.dn, l, e)
        if plan.has_shared:
            gu = mm(x, plan.sgu, l, None)
            g, u = gu[:, :plan.shared_inter], gu[:, plan.shared_inter:]
            act = (g * torch.sigmoid(g) * u).to(bf)
            acc = acc + weights[1][l][:, None] * mm(act, plan.sdn, l, None)
        resid = resid + acc
    return mk.lm_head_ref(plan, packed, resid), torch.stack(rms), router


def _k_table(cs, ca, cb, st, plan, mode, dev):
    """[L, B]: the largest K difference of a head between two pools at each
    active row's new token, dequantized, in shares of `cb`'s row range."""
    import torch
    table = torch.zeros((plan.L, plan.B))
    for b in range(plan.B):
        if not bool(st["active"][b]):
            continue
        n = cs.MK_LENS[b]
        g, off = int(st["pt"][b, n // cs.PAGE]), n % cs.PAGE
        row = torch.zeros(ca.k.shape[:2], dtype=torch.bool, device=dev)
        row[g * plan.L:(g + 1) * plan.L, off] = True
        va = cs.written_rows(ca, "k", row, mode, plan.KH)[0]
        vb = cs.written_rows(cb, "k", row, mode, plan.KH)[0]
        rng = (vb.amax(-1) - vb.amin(-1)).clamp_min(1e-8)
        table[:, b] = ((va - vb).abs().amax(-1) / rng).amax(-1).cpu()
    return table


def _show(name, table):
    rows = [b for b in range(table.shape[1]) if table[:, b].max() > 0.01]
    print(f"  {name}: rows over 1e-2 of their range: {rows}; largest "
          f"{float(table.max()):.4f}")
    for b in rows:
        print(f"    row {b}: " + " ".join(f"{v:.4f}"
                                        for v in table[:, b].tolist()))


def main() -> int:
    import torch
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from dashinfer_tpu_torch.config import CacheMode
    from dashinfer_tpu_torch.ops import megakernel as mk
    if not torch.cuda.is_available():
        print("moe_drift: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    cfg = cs.moe_config()
    params = cs.random_moe_params(cfg, cs.SEED + 13, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 7)       # chip_smoke's MoE decode cases
    with torch.no_grad():
        for mode in (CacheMode.INT8, CacheMode.UINT4):
            plan, packed = cs.mk_plan_pack(cfg, params, cs.DECODE_BATCH,
                                           mode)
            st = cs.mk_state(cfg, mode, cs.DECODE_BATCH, cs.MK_LENS,
                             cs.MK_INACTIVE, gen, dev)
            L, B, k = plan.L, plan.B, plan.k_top
            x0 = params["embed_tokens"]["w"][st["tokens"]].to(bf)
            before = st["cache"]
            ck = before.clone()
            out_k = mk.decode_megakernel(plan, packed, x0, st["cos"],
                                         st["sin"], st["pt"], st["lens"],
                                         st["active"], ck)
            mk.check_status(plan, dev)
            launch = mk._launch_state(plan, dev)
            ke = mk.kernel_routing(plan, dev).clone()
            weights = (launch.topk_w.reshape(L, B, mk.MAX_TOPK)[..., :k]
                       .clone(), launch.sgate.reshape(L, B).clone())
            x0p = x0.clone()
            x0p[:, 0] = (x0p[:, 0].float() * (1 + 2 ** -7)).to(bf)
            runs = {}
            for name, x, kw in (
                    ("own routing", x0, {}),
                    ("the kernel's routing", x0, dict(forced=ke)),
                    ("the kernel's routing and gates", x0,
                     dict(forced=ke, weights=weights)),
                    ("the kernel's routing, x0 one step up", x0p,
                     dict(forced=ke))):
                c = before.clone()
                runs[name] = (c,) + _moe_ref(plan, packed, x, st, c, **kw)
            act = st["active"]
            print(f"== {mode.value}, B = {B} (row {cs.MK_INACTIVE} "
                  "inactive)", flush=True)
            chosen_p = torch.stack([mk.route(plan, lg)[0] > 0
                                    for lg in runs["own routing"][3]])
            chosen_k = torch.zeros_like(chosen_p)
            chosen_k.scatter_(2, ke.long(), True)
            differ = (chosen_k != chosen_p).any(-1) & act[None, :]
            top = torch.stack(runs["own routing"][3])[..., :plan.E].topk(
                k + 1, dim=-1).values
            gap = top[..., k - 1] - top[..., k]
            print("  routed differently (row, layer, the plain version's "
                  "logit gap):",
                  [(b, l, round(float(gap[l, b]), 5))
                   for l, b in torch.nonzero(differ).tolist()], flush=True)
            for name, (c, logits, _, _) in runs.items():
                _show(f"kernel vs plain, {name}",
                      _k_table(cs, ck, c, st, plan, mode, dev))
                print(f"    logits max|d| "
                      f"{float((out_k[act] - logits[act]).abs().max()):.3e} "
                      f"of {float(logits[act].abs().max()):.3e}", flush=True)
            base = runs["the kernel's routing"][0]
            for name in ("the kernel's routing and gates",
                         "the kernel's routing, x0 one step up"):
                _show(f"plain, the kernel's routing, vs plain, {name}",
                      _k_table(cs, runs[name][0], base, st, plan, mode, dev))
            rms = runs["the kernel's routing"][2].cpu()
            print("  residual RMS entering each layer:")
            for b in range(B):
                print(f"    row {b}: " + " ".join(
                    f"{v:.3f}" for v in rms[:, b].tolist()), flush=True)
            del ck, runs, st, packed
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
