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

With --tp, the same for the TP MoE decode forward (csrc/tp_segments.cu's
attn and moe segments over the ranks of a (1, n) mesh on one card) on
chip_smoke.py's tp_moe states (its cases and seeds), against the TP plain
version routed as the kernel routed; beside it, for the rows that part: the
TP plain version with one element of each row of x0 one bf16 step up, the
single-device plain version (the same function summed in another order),
and each segment launched on the TP plain version's own inputs, layer by
layer (so that no earlier difference reaches it), with the rows it then
routes otherwise than the plain router.

    python -m dashinfer_tpu_torch.tools.moe_drift [--tp]
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


def _kv_rows(cs, cache, st, lens, L, mode, KH, dev):
    """{row: (K, V, scale or None)} of each active row's new token in every
    layer ([L, KH, D] dequantized; scale [L, KH])."""
    import torch
    out = {}
    for b, n in enumerate(lens):
        if not bool(st["active"][b]):
            continue
        g, off = int(st["pt"][b, n // cs.PAGE]), n % cs.PAGE
        m = torch.zeros(cache.k.shape[:2], dtype=torch.bool, device=dev)
        m[g * L:(g + 1) * L, off] = True
        k, _, ks, _ = cs.written_rows(cache, "k", m, mode, KH)
        v, _, vs, _ = cs.written_rows(cache, "v", m, mode, KH)
        out[b] = (k, v, ks, vs)
    return out


def _kv_table(a, b, L, B):
    """[B, L]: chip_smoke's MoE pool reading between two _kv_rows: the
    largest K or V difference of a head beyond one and a half of `b`'s
    levels, in shares of `b`'s row range."""
    import torch
    t = torch.zeros((B, L))
    for r, (kb, vb, ksb, vsb) in b.items():
        for va, vb_, sc in ((a[r][0], kb, ksb), (a[r][1], vb, vsb)):
            lv = 0 if sc is None else 1.5 * sc
            d = ((va - vb_).abs().amax(-1) - lv).clamp_min(0) / \
                (vb_.amax(-1) - vb_.amin(-1)).clamp_min(1e-8)
            t[r] = torch.maximum(t[r], d.amax(-1).cpu())
    return t


def _teacher_forced(cs, plan, packs, s, step, dev):
    """Each segment of each rank launched on the TP plain version's own
    inputs, layer by layer: [L, B] of the largest difference of the
    all-reduced attn and moe partials of a row, in shares of the partial's
    largest entry ("own") and of the row's largest residual entry after
    the layer ("resid"); the rows the kernel routes
    otherwise than the plain router on those inputs [(row, layer, gap)]."""
    import dataclasses
    import torch
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    from dashinfer_tpu_torch.parallel.collectives import all_reduce_
    n, L, B = len(packs), plan.L, plan.B
    act = s["st"]["active"]
    gplan = dataclasses.replace(plan, E=plan.E_global)
    caches = [c.clone() for c in s["caches"]]
    xs = [s["x0"].float() for _ in range(n)]
    add = [None] * n
    rel = {f"{h} {w}": torch.zeros((L, B)) for h in ("attn", "moe")
           for w in ("own", "resid")}
    flips = []
    for l in range(L):
        for half in ("attn", "moe"):
            outs_k, outs_p, routing, xks = [], [], [], []
            for r in range(n):
                xk = xs[r].clone()
                xks.append(xk)
                if half == "attn":
                    outs_k.append(tpk.tp_attn_segment(
                        plan, packs[r], l, xk, *step, caches[r], add=add[r]))
                    outs_p.append(tpk.attn_segment_ref(
                        plan, packs[r], l, xs[r], *step, caches[r],
                        add=add[r]))
                    continue
                outs_k.append(tpk.tp_moe_segment(plan, packs[r], l, xk, r,
                                                 act, add=add[r]))
                rk = tpk.kernel_routing(plan, dev, r)[l].clone()
                outs_p.append(tpk.moe_segment_ref(
                    plan, packs[r], l, xs[r], r, add=add[r],
                    routing=routing if r == 0 else None, forced_routing=rk))
                if r == 0:
                    chosen = torch.zeros((1, B, plan.E_global),
                                         dtype=torch.bool, device=dev)
                    chosen.scatter_(2, rk.long()[None], True)
                    flips += [(b, l, g) for b, _, g in cs.flipped_rows(
                        gplan, chosen, routing, act, "teacher-forced")]
            for r in range(n):
                cs.check(bool((xks[r] == xs[r]).all()), f"layer {l} {half} "
                         f"rank {r}: x + add differs")
            tpk.check_status(plan, dev)
            sk = all_reduce_(outs_k)[0]
            add = all_reduce_(outs_p)
            d = (sk - add[0]).abs().amax(-1)
            rel[f"{half} own"][l] = (d / add[0].abs().amax(-1).clamp_min(
                1e-30)).cpu()
            rel[f"{half} resid"][l] = (d / (xs[0] + add[0]).abs().amax(
                -1).clamp_min(1e-30)).cpu()
    del caches
    return rel, flips


def _tp_main(cs, dev) -> int:
    import dataclasses
    import torch
    from dashinfer_tpu_torch.ops import megakernel as mk
    from dashinfer_tpu_torch.ops import tp_megakernel as tpk
    bf = torch.bfloat16
    cfg = cs.moe_config()
    params = cs.random_moe_params(cfg, cs.SEED + 13, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 37)      # chip_smoke's tp_moe cases
    with torch.no_grad():
        for n, mode_name, B in cs.TP_MOE_CASES:
            s = cs.tp_moe_setup(cfg, params, n, mode_name, B, gen, dev)
            plan, packs, st, mode = s["plan"], s["packs"], s["st"], s["mode"]
            L, KH, lens, act = plan.L, cfg.num_kv_heads, s["lens"], \
                st["active"]
            devices = s["mesh"].devices
            step = (st["cos"], st["sin"], st["pt"], st["lens"], st["active"])
            x0 = s["x0"]
            x0p = x0.clone()
            x0p[:, 0] = (x0p[:, 0].float() * (1 + 2 ** -7)).to(bf)
            print(f"== TP n = {n}, {mode.value}, B = {B} (row "
                  f"{s['inactive']} inactive)", flush=True)

            def rows(run, **kw):
                c = [c_.clone() for c_ in s["caches"]]
                logits = run(c, **kw)
                full = cs.full_pool(c)
                del c
                out = _kv_rows(cs, full, st, lens, L, mode, KH, dev)
                del full
                return out, logits

            kv_k, logits_k = rows(lambda c: tpk.tp_decode(
                plan, packs, x0, *step, c, devices))
            tpk.check_status(plan, dev)
            routed = tpk.kernel_routing(plan, dev, 0).clone()
            norms = []
            kv_p, logits_p = rows(lambda c: tpk.tp_decode_ref(
                plan, packs, x0, *step, c, devices, forced_routing=routed,
                resid_norms=norms))
            kv_pp, _ = rows(lambda c: tpk.tp_decode_ref(
                plan, packs, x0p, *step, c, devices, forced_routing=routed))
            own, own_p = [], []
            rows(lambda c: tpk.tp_decode_ref(plan, packs, x0, *step, c,
                                             devices, routing=own))
            rows(lambda c: tpk.tp_decode_ref(plan, packs, x0p, *step, c,
                                             devices, routing=own_p))
            plan1, pack1 = cs.mk_plan_pack(cfg, params, B, mode)
            c1 = cs.full_pool([c.clone() for c in s["caches"]])
            mk.decode_megakernel_ref(plan1, pack1, x0, *step, c1,
                                     forced_routing=routed)
            kv_1 = _kv_rows(cs, c1, st, lens, L, mode, KH, dev)
            del c1, pack1
            torch.cuda.empty_cache()
            gplan = dataclasses.replace(plan, E=plan.E_global)
            chosen_k = torch.zeros((L, B, plan.E_global), dtype=torch.bool,
                                   device=dev)
            chosen_k.scatter_(2, routed.long(), True)
            chosen_pp = torch.stack([mk.route(gplan, lg)[0] > 0
                                     for lg in own_p])
            flips_k = cs.flipped_rows(gplan, chosen_k, own, act, "kernel")
            flips_pp = cs.flipped_rows(gplan, chosen_pp, own, act,
                                       "x0 one step up")
            tf, tf_flips = _teacher_forced(cs, plan, packs, s, step, dev)
            tables = {"kernel vs plain": _kv_table(kv_k, kv_p, L, B),
                      "plain, x0 one step up, vs plain":
                          _kv_table(kv_pp, kv_p, L, B),
                      "single-device plain vs TP plain":
                          _kv_table(kv_1, kv_p, L, B)}
            share = torch.stack(norms).cpu()                   # [L, B]
            arows = [b for b in range(B) if bool(act[b])]
            share = share / share[:, arows].median(1).values[:, None]
            parted = [b for b in arows if
                      float(tables["kernel vs plain"][b].max()) >
                      cs.CONDITIONED_RTOL or
                      float(share[1:, b].min()) < cs.ILL_NORM_SHARE]
            others = [b for b in arows if b not in parted]
            print(f"  logits max|d| kernel vs plain (routed as the kernel) "
                  f"{float((logits_k[act] - logits_p[act]).abs().max()):.3e}"
                  f" of {float(logits_p[act].abs().max()):.3e}")
            print(f"  rows routed otherwise (row, first layer, the plain "
                  f"router's gap there): by the kernel {flips_k}; by the "
                  f"plain version on x0 one step up {flips_pp}; by the "
                  f"segments on the plain version's own inputs {tf_flips}")
            print(f"  rows that part or enter a layer with their residual "
                  f"RMS below {cs.ILL_NORM_SHARE} of the median: {parted}")

            def line(name, vals):
                print(f"    {name:44s} " + " ".join(
                    f"{v:.4f}" for v in vals), flush=True)

            for b in parted:
                print(f"  row {b}, by layer:")
                line("residual RMS over the median", share[:, b].tolist())
                for name, t in tables.items():
                    line(name, t[b].tolist())
                for name, t in tf.items():
                    line(f"segments on its inputs, {name}",
                         t[:, b].tolist())
            if others:
                print(f"  the other {len(others)} active rows, the largest "
                      "by layer:")
                for name, t in tables.items():
                    line(name, t[others].amax(0).tolist())
                for name, t in tf.items():
                    line(f"segments on its inputs, {name}",
                         t[:, others].amax(1).tolist())
            del s, packs, kv_k, kv_p, kv_pp, kv_1, own, own_p
            torch.cuda.empty_cache()
    return 0


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
    if "--tp" in sys.argv[1:]:
        return _tp_main(cs, dev)
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
