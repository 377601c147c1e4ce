"""Train step factory and the resumable training CLI, port of
``repro/launch/train.py``.

The unit of work is the paper-faithful federated local step: LoRA
fine-tuning of the adapter tree over a frozen base. Only the adapters
are differentiated; the optimizer is the reference's Adam
(:mod:`repro_torch.optim.adam`). The reference runs the step under pjit
on a production mesh; here a mesh is one device (or ``mesh=None``), and
the sharding rules of :mod:`repro_torch.launch.sharding` are checked
against where the step's arguments sit. More than one device is ROADMAP
Queue 1, item 12b.

Also the CLI of the end-to-end example, on the card unless asked for
the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

(the reduced config unless ``--full``). The kernels are dispatched by
device (``models/runmode.py``): on the card every LoRA linear and
attention call on a kernel route launches the hand-written kernel, and
on the CPU their plain versions run, so the reference's ``--pallas``
switch has no counterpart; ``--device`` replaces it.

The CLI is resumable: ``--checkpoint-every N`` writes adapters + Adam
state + the data RNG cursor to ``--checkpoint-dir`` every N steps (the
reference's npz format, keyed by a config fingerprint, the last 3 kept),
and ``--resume`` restores the latest one and continues the step loop bit
for bit:

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \\
        --checkpoint-every 50 --checkpoint-dir /tmp/lm-ckpt [--resume]

``--simulate SCENARIO`` runs an IoV scenario preset instead
(``repro_torch.sim.scenarios``), e.g. ``--simulate rsu-outage
--participation semi-sync --engine fused --rounds 24``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import LoRAConfig, ModelConfig
from repro_torch.interop import tree_map
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device
from repro_torch.optim.adam import AdamState, adam, apply_updates, leaves, \
    unflatten

METRICS = ("loss", "aux", "accuracy")
# a resumed run keeps this many step checkpoints, as the reference's CLI
KEEP_LAST = 3


def make_train_step(cfg: ModelConfig, lora: LoRAConfig, mesh=None, *,
                    lr: float = 1e-4, remat: bool = True,
                    seq_shard: bool = True, sliding_window=None,
                    donate: bool = True, scan_unroll: int = 1,
                    ce_chunk: int = 0, microbatch: int = 1):
    """Returns ``(step, placed_step)``. ``step(params, adapters,
    opt_state, batch) -> (adapters, opt_state, metrics)`` differentiates
    the adapters only and, as the reference's, leaves its arguments as
    they were. ``placed_step`` takes the same arguments, checks that each
    sits where the sharding rules put it on ``mesh`` (one device: the
    whole of every tensor on that device; ``mesh=None``: on the params'
    device), then runs ``step``.

    microbatch > 1: gradient accumulation — the global batch is split
    into ``microbatch`` equal slices run one after another, gradients
    and metrics summed and divided by ``microbatch`` (activation memory
    ∝ 1/microbatch at identical math); a batch it does not divide
    raises, as the reference's reshape does. remat, ce_chunk: as
    ``models/transformer.py::loss_fn``. Accepted and not acted on:
    sliding_window (not passed to the loss, as in the reference; ROADMAP
    Queue 3); donate (JAX buffer donation: the step returns new adapter
    and Adam tensors, a few MB at rank 8, and the caller drops the old
    ones); seq_shard and scan_unroll (a one-device mesh has no sequence
    to shard, and the layers run as a plain Python loop). A mesh over
    more than one device raises ``NotImplementedError`` (item 12b)."""
    opt = adam(lr)
    # the residual-stream constraint is the identity on one device, so the
    # loss does not take it; beyond one device this raises (item 12b)
    sh.make_constrain(mesh, seq_shard)

    def value_and_grad(params, adapters, batch):
        ads = tree_map(lambda a: a.detach().requires_grad_(True), adapters)
        total, metrics = T.loss_fn(params, ads, cfg, lora, batch,
                                   remat=remat, ce_chunk=ce_chunk)
        flat = leaves(ads)
        # an adapter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        grads = [torch.zeros_like(a) if g is None else g for a, g in zip(
            flat, torch.autograd.grad(total, flat, allow_unused=True))]
        return ({k: metrics[k].detach() for k in METRICS},
                unflatten(ads, grads))

    def step(params, adapters, opt_state, batch):
        if microbatch > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatch:
                raise ValueError(f"microbatch={microbatch} does not divide "
                                 f"the batch's {rows} rows")
            n = rows // microbatch
            grads = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), adapters)
            dev = leaves(adapters)[0].device
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in METRICS}
            for i in range(microbatch):
                sl = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                m, g = value_and_grad(params, adapters, sl)
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            grads = tree_map(lambda g: g / microbatch, grads)
            metrics = {k: v / microbatch for k, v in metrics.items()}
        else:
            metrics, grads = value_and_grad(params, adapters, batch)
        updates, opt_state = opt.update(grads, opt_state, adapters)
        return apply_updates(adapters, updates), opt_state, metrics

    # the rules read only paths and shapes: one spec tree per shape
    specs_by_shape = {}

    def shardings_for(params, adapters, opt_state, batch):
        key = (tuple(batch), tuple(tuple(t.shape) for t in leaves(
            (params, adapters, opt_state, batch))))
        if key not in specs_by_shape:
            m = mesh if mesh is not None else Mesh(("data", "model"), (1, 1))
            os_ = AdamState(
                step=(),
                mu=sh.tree_shardings(m, opt_state.mu, is_adapter=True),
                nu=sh.tree_shardings(m, opt_state.nu, is_adapter=True))
            specs_by_shape[key] = (
                sh.tree_shardings(m, params),
                sh.tree_shardings(m, adapters, is_adapter=True), os_,
                sh.batch_shardings(m, batch))
        return specs_by_shape[key]

    def placed_step(params, adapters, opt_state, batch):
        args = (params, adapters, opt_state, batch)
        device = leaves(params)[0].device
        bad = []
        for name, tree, specs in zip(("params", "adapters", "opt_state",
                                      "batch"), args, shardings_for(*args)):
            bad += [f"{name}/{e}" for e in
                    sh.placement_errors(mesh, tree, specs, device)]
        if bad:
            raise ValueError("train step arguments not where the sharding "
                             "rules place them: " + "; ".join(bad[:8]))
        return step(*args)

    return step, placed_step


def abstract_state(cfg: ModelConfig, lora: LoRAConfig, *, rank: int,
                   dtype=torch.bfloat16):
    """Params, adapters and Adam state as meta tensors (no allocation,
    no draws): the shapes and dtypes the step takes."""
    from repro_torch.launch.specs import abstract
    params = abstract(T.init_params, cfg, dtype=dtype)
    adapters = abstract(T.init_adapters, cfg, lora, rank=rank)
    return params, adapters, adam(1e-4).init(adapters)


# ---------------------------------------------------------------------------
# CLI driver (end-to-end example entry point)
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, lora: LoRAConfig, *, rank: int, device):
    """The CLI's starting point: seeded f32 params and fresh adapters."""
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device=device)
    adapters = T.init_adapters(cfg, lora, seed=0, rank=rank, device=device)
    return params, adapters


def main(argv: Optional[list] = None) -> None:
    import argparse
    import hashlib
    import json
    import time

    import numpy as np

    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="smollm-135m")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--full", action="store_true",
                        help="use the full (not reduced) config")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions); no card raises")
    parser.add_argument("--simulate", default=None, metavar="SCENARIO",
                        help="run an IoV federated fine-tuning scenario "
                             "(repro_torch.sim.scenarios preset name) "
                             "instead of the LM step loop")
    parser.add_argument("--participation", choices=("sync", "semi-sync"),
                        default="sync",
                        help="--simulate round participation policy: sync "
                             "drops uploads from vehicles that leave "
                             "coverage mid-round; semi-sync buffers them "
                             "in flight and lands them up to max_delay "
                             "rounds late at staleness-discounted weight")
    parser.add_argument("--engine", default=None,
                        help="--simulate engine override "
                             "(serial|batched|fused|fused_sharded)")
    parser.add_argument("--rounds", type=int, default=None,
                        help="--simulate horizon (default: scenario's)")
    parser.add_argument("--seed", type=int, default=0,
                        help="--simulate scenario seed")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="checkpoint adapters/optimizer every N steps "
                             "(0 = off; needs --checkpoint-dir)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="directory for round_*.npz step checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint from "
                             "--checkpoint-dir and continue the step loop")
    args = parser.parse_args(argv)
    if (args.checkpoint_every > 0 or args.resume) and not args.checkpoint_dir:
        parser.error("--checkpoint-every/--resume need --checkpoint-dir")

    if args.simulate:
        from repro_torch.sim import scenarios
        kw: Dict[str, Any] = {"participation": args.participation}
        if args.engine:
            kw["engine"] = args.engine
        sim = scenarios.build_sim(args.simulate, rounds=args.rounds,
                                  seed=args.seed, device=args.device, **kw)
        R = sim.cfg.rounds
        hist = (sim.run_scanned(R) if sim.fused is not None else sim.run())
        for rec in hist:
            print(f"round {rec['round']:3d} acc={rec['accuracy']:.4f} "
                  f"energy={rec['energy']:.1f} reward={rec['reward']:.3f}")
        print(f"done: {args.simulate} ({args.participation}), "
              f"{R} rounds, final acc={hist[-1]['accuracy']:.4f}")
        return

    device = resolve_device(args.device)
    if args.full:
        from repro_torch.config import get_arch
        cfg = get_arch(args.arch)
    else:
        import importlib
        mod = importlib.import_module(
            "repro_torch.configs."
            + args.arch.replace("-", "_").replace(".", "_"))
        cfg = mod.reduced()
    lora = LoRAConfig(rank=args.rank)

    params, adapters = init_state(cfg, lora, rank=args.rank, device=device)
    opt_state = adam(args.lr).init(adapters)
    step, _ = make_train_step(cfg, lora, lr=args.lr, remat=False)

    rng = np.random.default_rng(0)
    # the fingerprint pins everything that shapes the trajectory; a resume
    # against a different run config is rejected instead of diverging
    fp = hashlib.sha256(json.dumps(
        {"arch": args.arch, "full": args.full, "batch": args.batch,
         "seq": args.seq, "rank": args.rank, "lr": args.lr},
        sort_keys=True).encode()).hexdigest()
    start = 0
    if args.resume:
        from repro_torch.checkpoint import latest_checkpoint, restore_round
        if latest_checkpoint(args.checkpoint_dir) is not None:
            start, state = restore_round(args.checkpoint_dir)
            meta = json.loads(state["meta"].numpy().tobytes().decode())
            if meta["fingerprint"] != fp:
                raise SystemExit(
                    "checkpoint in --checkpoint-dir was written by a "
                    "different run config (arch/batch/seq/rank/lr)")
            on_dev = tree_map(lambda t: t.to(device), state)
            adapters = on_dev["adapters"]
            opt_state = AdamState(step=on_dev["opt"]["step"],
                                  mu=on_dev["opt"]["mu"],
                                  nu=on_dev["opt"]["nu"])
            rng.bit_generator.state = meta["rng"]
            print(f"resumed from step {start} ({args.checkpoint_dir})")
        else:
            print(f"no checkpoint in {args.checkpoint_dir}; "
                  "starting from step 0")

    def save_step(step_idx):
        from repro_torch.checkpoint import prune_checkpoints, save_round
        save_round(args.checkpoint_dir, step_idx, {
            "adapters": adapters,
            "opt": {"step": opt_state.step, "mu": opt_state.mu,
                    "nu": opt_state.nu},
            "meta": np.frombuffer(json.dumps(
                {"fingerprint": fp, "step": step_idx,
                 "rng": rng.bit_generator.state}).encode(),
                np.uint8).copy()})
        prune_checkpoints(args.checkpoint_dir, keep_last=KEEP_LAST)

    # tiny synthetic LM task: predict tok_{t+1} = (tok_t * 7 + 1) mod V
    V = cfg.vocab_size
    t0 = time.time()
    for i in range(start, args.steps):
        first = rng.integers(0, V, size=(args.batch, 1))
        seq = [first]
        for _ in range(args.seq):
            seq.append((seq[-1] * 7 + 1) % V)
        toks = np.concatenate(seq, 1)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
                 "labels": torch.as_tensor(toks[:, 1:], device=device)}
        if cfg.num_prefix_embeds:
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, cfg.num_prefix_embeds, cfg.d_model),
                dtype=torch.float32, device=device)
        adapters, opt_state, m = step(params, adapters, opt_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"acc={float(m['accuracy']):.3f} "
                  f"({time.time()-t0:.1f}s)")
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            save_step(i + 1)
    print("done.")


if __name__ == "__main__":
    main()
