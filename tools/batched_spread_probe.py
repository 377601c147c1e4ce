#!/usr/bin/env python3
"""Why the batched and serial round engines part at full width, on an
NVIDIA card.

    python3 tools/batched_spread_probe.py

Takes round 0's first rank group of task 0 under the default
``SimConfig`` with vit-base-paper at full width (12 layers, d 768, f32)
and trains it on the same pre-drawn batches three ways: the batched
trainer on the card (``run_jobs``, as the simulator calls it), the serial
trainer on the card, vehicle by vehicle, and the serial trainer on the
CPU for the first three vehicles. Prints and writes to
``chiprun_out/batched_spread_probe.json``:

- the first local step's adapter gradients, card against CPU: the largest
  difference, the largest entry, and how many entries of b have a
  gradient within that difference of 0, where the sign of Adam's first
  update (close to lr·sign(g)) rests on summation order;
- after the full step budgets, per vehicle: the largest adapter
  difference and the share of entries that differ by more than lr (an
  update of the other sign), batched against serial on the card and
  serial on the card against the CPU;
- two measures of the lane's update Δ = scale·A·B, per LoRA target:
  the largest entry difference over the largest entry (which one flipped
  update dominates) and the Frobenius difference over the Frobenius norm
  of the update (which it cannot dominate);
- the Frobenius measure under two planted faults of the batched trainer:
  the loss as a mean over all V·B rows (each lane's gradient scaled by
  1/V, which Adam's ε makes visible) and a lane past its step budget
  left live.

Needs a card; builds the kernels from the checkout.
"""
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import vit_base_paper  # noqa: E402
from repro_torch.core.aggregation import tree_get, tree_paths  # noqa: E402
from repro_torch.federated import batched_client as bc  # noqa: E402
from repro_torch.federated.client import LocalTrainer  # noqa: E402
from repro_torch.interop import tree_map  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adam import leaves  # noqa: E402
from repro_torch.sim.simulator import IoVSimulator, SimConfig  # noqa: E402

CPU_LANES = 3


def update_spread(got, want, base, scale):
    """Per LoRA target: (max |ΔP| / max |P_want − P_base|,
    ||ΔP||_F / ||P_want − P_base||_F) with P = scale·A·B per layer."""
    out = {}
    for path in tree_paths(want):
        def prod(t):
            ad = tree_get(t, path)
            return scale * torch.einsum("lir,lro->lio",
                                        ad["a"].cuda(), ad["b"].cuda())
        pw = prod(want)
        diff, upd = prod(got) - pw, pw - prod(base)
        out["/".join(map(str, path[2:]))] = (
            float(diff.abs().max() / upd.abs().max().clamp_min(1e-30)),
            float(diff.norm() / upd.norm().clamp_min(1e-30)))
    return out


def adapter_diff(got, want, lr):
    """(largest |got − want| entry, share of entries apart by > lr)."""
    big, n, far = 0.0, 0, 0
    for g, w in zip(leaves(got), leaves(want)):
        d = (g.cuda() - w.cuda()).abs()
        big = max(big, float(d.max()))
        n += d.numel()
        far += int((d > lr).sum())
    return big, far / n


def main() -> int:
    if not torch.cuda.is_available():
        print("batched_spread_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["lora_matmul", "flash_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    sim = IoVSimulator(SimConfig(method="ours", engine="batched",
                                 train_arch=vit_base_paper.vit_base_paper()),
                       device="cuda")
    sim.mobility.step()
    plan = sim._plan_task(0)
    ids = plan["active_ids"]
    rank = min(int(plan["ranks"][v]) for v in ids)
    idxs = [i for i, v in enumerate(ids) if int(plan["ranks"][v]) == rank]
    steps = [plan["steps_list"][i] for i in idxs]
    ads = [plan["adapters_list"][i] for i in idxs]
    batches = [bc.draw_batches(sim.client_data[0][ids[i]],
                               plan["steps_list"][i], sim.cfg.local_steps)
               for i in idxs]
    V, lr, scale = len(idxs), sim.cfg.lr, sim.cfg.lora.scale
    lora_r = dataclasses.replace(sim.cfg.lora, rank=rank)
    cpu_params = tree_map(lambda t: t.cpu(), sim.params)
    cpu_tr = LocalTrainer(sim.model_cfg, sim.cfg.lora, lr=lr, device="cpu")
    out = {"card": card, "task": sim.tasks[0].name, "rank": rank,
           "lanes": V, "steps": steps, "lr": lr}

    # the first step's gradients of lane 0, card against CPU
    def grads(params, ad, b, dev):
        adg = tree_map(lambda t: t.to(dev).detach().requires_grad_(), ad)
        batch = {k: torch.as_tensor(v[0], dtype=torch.int64, device=dev)
                 for k, v in b.items()}
        loss, _ = T.loss_fn(params, adg, sim.model_cfg, lora_r, batch)
        return torch.autograd.grad(loss, leaves(adg))
    g_card = grads(sim.params, ads[0], batches[0], "cuda")
    g_cpu = grads(cpu_params, ads[0], batches[0], "cpu")
    diff = max(float((a.cpu() - b).abs().max())
               for a, b in zip(g_card, g_cpu))
    b_grads = [g for g, leaf in zip(g_cpu, leaves(ads[0]))
               if leaf.shape[-2] == rank]
    out["first_step_grads_card_vs_cpu"] = {
        "max_abs_diff": diff,
        "max_abs_grad": max(float(g.abs().max()) for g in g_cpu),
        "b_entries": sum(g.numel() for g in b_grads),
        "b_entries_within_diff_of_0": sum(int((g.abs() <= diff).sum())
                                          for g in b_grads)}

    def serial(trainer, params, ad, b, n, dev):
        return trainer.finetune(params, tree_map(lambda t: t.to(dev), ad),
                                None, n, batches=[{k: a[si] for k, a in
                                                   b.items()}
                                                  for si in range(n)])[0]

    def batched():
        stacked, _ = sim.batched_trainer.run_jobs(sim.params, [{
            "adapters_list": ads, "batches_list": batches,
            "step_counts": steps}])[0]
        return bc.unstack_tree(stacked, V)
    lanes = batched()
    ser = [serial(sim.trainer, sim.params, ad, b, n, "cuda")
           for ad, b, n in zip(ads, batches, steps)]
    cpu = [serial(cpu_tr, cpu_params, ad, b, n, "cpu")
           for ad, b, n in zip(ads[:CPU_LANES], batches, steps)]
    pairs = {"batched_vs_serial_card": (lanes, ser),
             "serial_card_vs_cpu": (ser[:CPU_LANES], cpu),
             "batched_card_vs_serial_cpu": (lanes[:CPU_LANES], cpu)}
    for label, (got, want) in pairs.items():
        rows = []
        for v, (g, w) in enumerate(zip(got, want)):
            big, far = adapter_diff(g, w, lr)
            spread = update_spread(g, w, ads[v], scale)
            rows.append({"lane": v, "adapter_max_abs": big,
                         "share_apart_by_lr": far,
                         "max_entry_rel": max(s[0] for s in spread.values()),
                         "frobenius_rel": max(s[1] for s in spread.values()),
                         "frobenius_rel_by_target": {
                             k: s[1] for k, s in spread.items()}})
        out[label] = rows

    # planted faults, each against the serial trainer on the card
    loss_fn, keep = T.loss_fn, bc._keep_frozen

    def mean_over_rows(*a, lanes=None, **kw):
        loss, m = loss_fn(*a, lanes=lanes, **kw)
        return (loss / lanes if lanes else loss), m
    faults = {}
    for label, patch in (
            ("mean over all V·B rows", lambda: setattr(T, "loss_fn",
                                                       mean_over_rows)),
            ("lane past its budget left live",
             lambda: setattr(bc, "_keep_frozen",
                             lambda live, new, old: new))):
        patch()
        try:
            got = batched()
        finally:
            T.loss_fn, bc._keep_frozen = loss_fn, keep
        faults[label] = [max(s[1] for s in update_spread(
            g, w, ad, scale).values())
            for g, w, ad in zip(got, ser, ads)]
    out["planted_faults_frobenius_rel"] = faults

    print(f"card: {card}")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in pairs}, indent=1))
    for label in pairs:
        for row in out[label]:
            print(f"{label} lane {row['lane']}: adapters max "
                  f"{row['adapter_max_abs']:.3g}, apart by > lr "
                  f"{row['share_apart_by_lr']:.3g}; update max-entry rel "
                  f"{row['max_entry_rel']:.3g}, Frobenius rel "
                  f"{row['frobenius_rel']:.3g}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "batched_spread_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
