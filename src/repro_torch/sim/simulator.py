"""IoV multi-task federated fine-tuning simulator (paper §V), port of
``repro/sim/simulator.py`` with the serial, batched and fused engines.

Per communication round:
  1. vehicle mobility (trajectory step, RSU coverage, departure prediction),
  2. inter-task energy budgets (Algorithm 1),
  3. intra-task rank selection (UCB-DUAL; or the baselines' fixed rules),
  4. distribution → local LoRA fine-tuning of the task model → upload →
     aggregation by the method's rule (ours: merged deltas and
     truncated-SVD redistribution; HomoLoRA, HetLoRA, FedRA),
  5. §III-C four-stage cost accounting over the Shannon channel,
  6. §IV-E mobility fallbacks for predicted departures.

Every method of ``METHODS`` runs: the paper's (``ours``), the baselines
of its Table I (``homolora``, ``hetlora``, ``fedra``), the ablations of
its Table III (``ours_no_energy``, ``ours_no_mobility``) and
``ours_residual``; the fused engines take the ``ours`` family that
``fused_engine.FUSED_METHODS`` names, as in the reference.

Training runs on ``device`` (``cuda`` by default; ``cpu`` when asked):
every LoRA-targeted linear of the model launches ``lora_matmul`` and
every attention ``flash_attention`` on a card. The engine
(``SimConfig.engine``, else ``$REPRO_SIM_ENGINE``, else ``"batched"``)
trains either one vehicle at a time (``"serial"``), each (task, rank)
group of vehicles as one stack of lanes (``"batched"``;
``"batched_check"`` also replays the serial trainer on the same batches
and records the largest adapter deviation in ``engine_check_dev``), or
runs the whole round as one program over the rank-padded fleet
(``"fused"``, see ``federated/fused_engine.py``: CUDA graphs captured on
the first round and replayed after on a card, the same functions eagerly
on the CPU; ``"fused_check"`` replays the serial trainer on its lanes).
:meth:`IoVSimulator.run_scanned` runs several fused rounds with the host
staging them all first. Cost accounting reads the full paper backbone's
dimensions (``cost_arch_id``), whatever model trains. The host state
(mobility, channel, data, the numpy ``rng``) is the reference's, drawn
in the reference's order, so one seed gives the reference's fleet, data
and channel bit for bit.

The round's modes run in every engine: a non-trivial ``rsu_tier``
(``ours``, its ablations and ``hetlora``) charges each handoff between
two RSUs of a task the migration penalty, aggregates into per-RSU
partials and merges them every ``sync_period`` rounds; ``semi_sync``
participation (the ``ours`` family) defers the upload of a departing
vehicle that does not migrate into the server's buffer and lands it up
to ``max_delay`` rounds late, and its history records gain
``deferred``, ``released`` and ``rel_weight`` (a ``sync`` history keeps
its schema). The other methods raise ``ValueError`` with either, as in
the reference.

An enabled ``SimConfig.checkpoint`` writes the complete state every
``interval`` completed rounds (``run``) or at every chunk boundary
(``run_scanned``), and :func:`repro_torch.checkpoint.restore_checkpoint`
resumes from it bit for bit, under any engine and on either device
(``checkpoint/carry.py``). A ``MobilitySimConfig.trace`` replays staged
trajectories (``sim/trajectories.py``; the presets of
``sim/scenarios.py``). ``"fused_sharded"`` (or a non-trivial
``SimConfig.shard`` under ``"fused"``) splits the fused round's lanes
over a fleet of devices from this one process (``fleet_devices``:
default the first N visible cards; ``["cpu"] * N`` runs it on the CPU).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import (CheckpointSpec, EnergyAllocConfig,
                                LoRAConfig, MobilityConfig, ModelConfig,
                                ParticipationSpec, RSUTierSpec, ShardSpec,
                                UCBDualConfig, get_arch)
from repro_torch.core import aggregation as agg
from repro_torch.core import cost_model as cm
from repro_torch.core import energy_alloc, mobility as mob
from repro_torch.core import ucb_dual
from repro_torch.data import (ClientDataset, DEFAULT_TASKS,
                              dirichlet_partition, make_task)
from repro_torch.federated.baselines import (METHODS, capability_ranks,
                                             is_residual, server_method)
from repro_torch.federated.batched_client import (BatchedLocalTrainer,
                                                  draw_batches, take_lanes)
from repro_torch.federated.client import LocalTrainer
from repro_torch.federated.fused_engine import (FusedRoundEngine,
                                                supports_method)
from repro_torch.federated.server import RSUServer
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device
from repro_torch.optim.adam import leaves
from repro_torch.sim.channel import ChannelConfig, ChannelModel
from repro_torch.sim.mobility_model import MobilityModel, MobilitySimConfig


@dataclass
class SimConfig:
    method: str = "ours"
    num_tasks: int = 3
    num_vehicles: int = 24
    rounds: int = 60
    local_steps: int = 3
    batch_size: int = 10
    lr: float = 5e-3
    seed: int = 0
    train_arch: Optional[ModelConfig] = None     # default: reduced ViT
    cost_arch_id: str = "vit-base-paper"         # cost-model dimensions
    lora: LoRAConfig = field(default_factory=lambda: LoRAConfig(
        rank=8, max_rank=32, candidate_ranks=(2, 4, 8, 16, 32)))
    ucb: UCBDualConfig = field(default_factory=UCBDualConfig)
    energy: EnergyAllocConfig = field(default_factory=lambda:
                                      EnergyAllocConfig(e_total=900.0))
    mobility: MobilityConfig = field(default_factory=MobilityConfig)
    mobility_sim: MobilitySimConfig = field(default_factory=MobilitySimConfig)
    rsu_tier: RSUTierSpec = field(default_factory=RSUTierSpec)
    participation: ParticipationSpec = field(
        default_factory=ParticipationSpec)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    departure_fraction: float = 0.5   # fraction of local steps done at exit
    bytes_per_param: int = 4
    # round engine (ENGINES); None: $REPRO_SIM_ENGINE, else "batched"
    engine: Optional[str] = None
    shard: ShardSpec = field(default_factory=ShardSpec)
    checkpoint: CheckpointSpec = field(default_factory=CheckpointSpec)
    scenario: Optional[str] = None


ENGINES = ("serial", "batched", "batched_check", "fused", "fused_check",
           "fused_sharded")
FUSED_ENGINES = ("fused", "fused_check", "fused_sharded")


class IoVSimulator:
    def __init__(self, cfg: SimConfig, device="cuda", *,
                 params: Optional[Dict] = None,
                 server_draws: Optional[Sequence[Callable[[], Any]]] = None,
                 draw_omega: Optional[Callable] = None,
                 mask_draws: Optional[Sequence[Callable[[], Any]]] = None,
                 fleet_devices: Optional[Sequence[Any]] = None):
        """device: where the model trains (``cuda`` unless asked; no card
        raises). params: the frozen base (any device; default: seeded
        random weights drawn on the CPU). server_draws: per task, the
        fresh-adapter draw of its RSUServer; mask_draws: per task, its
        FedRA layer-mask draw; draw_omega: the SVD sketch of every server
        (see :class:`RSUServer`). fleet_devices: the sharded fused
        engine's devices, shard i on the i-th (repeats allowed; default:
        the first N visible devices of ``device``'s type)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fleet_devices = (None if fleet_devices is None
                              else [resolve_device(d) for d in fleet_devices])
        self._check_ported(cfg)
        self.spec = METHODS[cfg.method]
        self.engine = self._resolve_engine(cfg)
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng

        # --- model (shared frozen base across tasks; adapters per task) ---
        if cfg.train_arch is None:
            from repro_torch.configs import vit_base_paper
            self.model_cfg = vit_base_paper.reduced()
        else:
            self.model_cfg = cfg.train_arch
        if params is None:
            params = T.init_params(self.model_cfg, seed=cfg.seed,
                                   dtype=torch.float32, device="cpu")
        self.params = tree_map(lambda t: torch.as_tensor(t).to(self.device),
                               params)
        self.trainer = LocalTrainer(self.model_cfg, cfg.lora, lr=cfg.lr,
                                    device=self.device)
        self.batched_trainer = BatchedLocalTrainer(
            self.model_cfg, cfg.lora, lr=cfg.lr, max_steps=cfg.local_steps,
            device=self.device)
        self.engine_check_dev = 0.0   # batched_check: max |batched − serial|

        # --- cost model (full-dimension backbone) ---
        self.cost_cfg = get_arch(cfg.cost_arch_id)
        tokens_per_sample = 200  # ViT-Base: 196 patches + cls + margin
        n_active = self.cost_cfg.param_counts()["active"]
        self.base_flops_per_sample = 4.0 * n_active * tokens_per_sample
        self.cost_dims = cm.target_dims_of(self.cost_cfg, cfg.lora)
        self.g_cache = {r: cm.g_factor(self.cost_cfg, cfg.lora, r)
                        for r in cfg.lora.candidate_ranks}
        self.dev_profiles = cm.default_device_profiles(
            rng, cfg.num_vehicles, self.base_flops_per_sample)
        # κ recalibrated for ~15–40 W vehicular compute
        self.dev_profiles = [dataclasses.replace(p, kappa=float(
            rng.uniform(2.0, 5.0) * 1e-36)) for p in self.dev_profiles]
        self.rsu_profile = cm.default_rsu_profile()
        # persistent per-vehicle log-normal shadowing (σ≈5 dB)
        self.shadow = np.exp(rng.normal(0.0, 1.2, cfg.num_vehicles))

        # --- tasks, data, partitions ---
        self.tasks = list(DEFAULT_TASKS[:cfg.num_tasks])
        while len(self.tasks) < cfg.num_tasks:   # task-scalability runs
            base = DEFAULT_TASKS[len(self.tasks) % len(DEFAULT_TASKS)]
            self.tasks.append(dataclasses.replace(
                base, name=f"{base.name}{len(self.tasks)}"))
        self.task_data = [make_task(t, seed=cfg.seed + ti)
                          for ti, t in enumerate(self.tasks)]
        self.client_data: List[List[ClientDataset]] = []
        for ti, data in enumerate(self.task_data):
            parts = dirichlet_partition(data["labels"], cfg.num_vehicles,
                                        alpha=0.5, seed=cfg.seed + ti)
            self.client_data.append([
                ClientDataset(data["tokens"][idx], data["labels"][idx],
                              cfg.batch_size, seed=cfg.seed + 31 * v)
                for v, idx in enumerate(parts)])
        self.eval_batches = [
            {"tokens": d["eval_tokens"], "labels": d["eval_labels"]}
            for d in self.task_data]
        # fixed-size local eval batches (held-out accuracy reflects the
        # truncation quality of the received rank)
        self.local_eval = []
        for d in self.task_data:
            n = min(32, len(d["eval_labels"]))
            idx = rng.choice(len(d["eval_labels"]), n, replace=False)
            self.local_eval.append({"tokens": d["eval_tokens"][idx],
                                    "labels": d["eval_labels"][idx]})

        # --- infrastructure ---
        ms = dataclasses.replace(cfg.mobility_sim,
                                 num_vehicles=cfg.num_vehicles,
                                 seed=cfg.seed)
        all_rsus = MobilityModel.place_rsus(
            cfg.num_tasks, ms.area, ms.coverage_radius, seed=cfg.seed,
            layout=ms.rsu_layout,
            num_per_task=cfg.rsu_tier.num_rsus_per_task)
        self.rsu_groups = [[r for r in all_rsus if r.task_id == t]
                           for t in range(cfg.num_tasks)]
        self.rsus = [g[0] for g in self.rsu_groups]
        self.mobility = MobilityModel(ms, all_rsus)
        self.channel = ChannelModel(cfg.channel, seed=cfg.seed + 3)
        draws = server_draws or [None] * cfg.num_tasks
        masks = mask_draws or [None] * cfg.num_tasks
        self.servers = [RSUServer(self.model_cfg, cfg.lora,
                                  server_method(cfg.method),
                                  seed=cfg.seed + 7 * t,
                                  residual=is_residual(cfg.method),
                                  tier=cfg.rsu_tier,
                                  participation=cfg.participation,
                                  device=self.device,
                                  draw_adapters=draws[t],
                                  draw_omega=draw_omega,
                                  draw_layer_mask=masks[t])
                        for t in range(cfg.num_tasks)]
        K = len(cfg.lora.candidate_ranks)
        self.ucb_states = [ucb_dual.init_state(cfg.num_vehicles, K)
                           for _ in range(cfg.num_tasks)]
        self.alloc = energy_alloc.init_alloc(cfg.energy, cfg.num_tasks)
        self.history: List[Dict[str, Any]] = []
        self._het_ranks = capability_ranks(
            cfg.lora.candidate_ranks,
            np.array([p.freq for p in self.dev_profiles]))

        # --- fused engine (the round as one program; see fused_engine) ---
        self.fused = None
        if self.engine in FUSED_ENGINES:
            self.fused = FusedRoundEngine(
                self, check=(self.engine == "fused_check"),
                sharded=(self.engine == "fused_sharded"),
                devices=self.fleet_devices)

    # ------------------------------------------------------------------
    @staticmethod
    def _resolve_engine(cfg: SimConfig) -> str:
        env = os.environ.get("REPRO_SIM_ENGINE")
        engine = cfg.engine or env or "batched"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; have {ENGINES}")
        if engine in FUSED_ENGINES and not supports_method(cfg.method):
            if cfg.engine is None:   # chosen by the environment: fall back
                return "batched"
            raise ValueError(
                f"engine={engine!r} does not support method "
                f"{cfg.method!r}; use engine='batched' or 'serial'")
        if not cfg.shard.trivial and engine not in ("fused",
                                                    "fused_sharded"):
            if cfg.engine is not None:
                # an explicit engine that cannot shard would drop an
                # explicit shard spec: refuse
                raise ValueError(
                    f"engine={engine!r} cannot shard the fleet axis; "
                    f"SimConfig.shard={cfg.shard} needs engine='fused' or "
                    "'fused_sharded' (or the trivial ShardSpec)")
            if env is None and supports_method(cfg.method):
                # nothing chose an engine: the shard spec routes to fused
                return "fused"
            # an engine from the environment leaves the spec inert
        return engine

    @staticmethod
    def _check_ported(cfg: SimConfig) -> None:
        if cfg.method not in METHODS:
            raise KeyError(f"unknown method {cfg.method!r}; have "
                           f"{sorted(METHODS)}")

    # ------------------------------------------------------------------
    def _select_ranks(self, ti: int, active: np.ndarray):
        """(ranks (V,), -1 where inactive; UCB-DUAL's arms, or None for
        the baselines' fixed ranks)."""
        cfg = self.cfg
        if self.spec.adaptive_rank:
            cand = np.asarray(cfg.lora.candidate_ranks)
            arms = ucb_dual.select_ranks(self.ucb_states[ti], cfg.ucb,
                                         torch.as_tensor(active)).numpy()
            ranks = np.where(arms >= 0, cand[np.clip(arms, 0, None)], -1)
            return ranks, arms
        if cfg.method == "hetlora":
            return np.where(active, self._het_ranks, -1), None
        # homolora / fedra: one uniform rank
        return np.where(active, cfg.lora.rank, -1), None

    # ------------------------------------------------------------------
    def run_round(self) -> Dict[str, Any]:
        """One communication round: plan (coverage, ranks, distribution,
        §IV-E step budgets) per task, train every task's vehicles, then
        finish (costs, fallbacks, aggregation, global eval, UCB-DUAL) per
        task. The channel's fading stream is drawn only in the finish
        phase, in the reference's order."""
        cfg = self.cfg
        if self.fused is not None:
            return self.fused.run_round()
        self.mobility.step()
        budgets = self.alloc.budgets.numpy()
        rec: Dict[str, Any] = {"round": len(self.history), "tasks": []}
        consumed = np.zeros(cfg.num_tasks)
        accuracies = np.zeros(cfg.num_tasks)

        plans = [self._plan_task(ti) for ti in range(cfg.num_tasks)]
        trains = self._train_plans(plans)
        for ti, (plan, tr) in enumerate(zip(plans, trains)):
            trec = self._finish_task(plan, tr, budgets[ti])
            consumed[ti] = trec["energy"]
            accuracies[ti] = trec["accuracy"]
            rec["tasks"].append(trec)

        if self.spec.energy_scheduler:
            self.alloc, _ = energy_alloc.step(
                self.alloc, cfg.energy, torch.as_tensor(consumed),
                torch.as_tensor(accuracies))
        rec["budgets"] = budgets.tolist()
        rec["reward"] = float(sum(t["reward"] for t in rec["tasks"]))
        rec["energy"] = float(consumed.sum())
        rec["latency"] = float(max((t["latency"] for t in rec["tasks"]),
                                   default=0.0))
        rec["accuracy"] = float(np.mean(accuracies))
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------
    def _plan_task(self, ti: int) -> Dict[str, Any]:
        """Phase 1: everything a task round needs before training."""
        cfg = self.cfg
        view = self.mobility.round_view_group(self.rsu_groups[ti])
        active = view["active"]
        ranks, arms = self._select_ranks(ti, active)
        active_ids = np.where(active)[0]
        departing = view["departing"]
        adapters_list = self.servers[ti].distribute(
            [int(ranks[v]) for v in active_ids])
        fedra_masks = (self.servers[ti].masks if cfg.method == "fedra"
                       else [None] * len(active_ids))
        # §IV-E: departing vehicles fine-tune a reduced number of steps
        steps_list, frac_list = [], []
        for v in active_ids:
            if bool(departing[v]):
                steps_list.append(max(1, int(round(
                    cfg.local_steps * cfg.departure_fraction))))
                frac_list.append(cfg.departure_fraction)
            else:
                steps_list.append(cfg.local_steps)
                frac_list.append(1.0)
        return {"ti": ti, "rsu": self.rsus[ti], "active_ids": active_ids,
                "ranks": ranks, "arms": arms, "departing": departing,
                "staying": view["staying"], "adapters_list": adapters_list,
                "fedra_masks": fedra_masks,
                "steps_list": steps_list, "frac_list": frac_list,
                "distances": view["distances"], "assoc": view["assoc"],
                "handoff": view["handoff"]}

    # ------------------------------------------------------------------
    def _train_serial(self, plan: Dict[str, Any]) -> Dict[str, Any]:
        """Phase 2, the serial engine: the per-vehicle trainer loop."""
        ti = plan["ti"]
        ads: List[Any] = []
        accs: List[float] = []
        for i, v in enumerate(plan["active_ids"]):
            ad, metrics = self.trainer.finetune(
                self.params, plan["adapters_list"][i],
                self.client_data[ti][v], plan["steps_list"][i],
                eval_batch=self.local_eval[ti],
                layer_mask=plan["fedra_masks"][i])
            ads.append(ad)
            accs.append(metrics.get("eval_accuracy",
                                    metrics.get("accuracy", 0.0)))
        return {"ads_list": ads, "groups": None,
                "accs": np.asarray(accs, np.float32)}

    # ------------------------------------------------------------------
    def _train_plans(self, plans: Sequence[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
        """Phase 2 for every task, by engine.

        serial: the per-vehicle loop, task by task.
        batched: every (task, rank) group is one job of the batched
            trainer; the results stay stacked for grouped aggregation.
        batched_check: batched, then the serial trainer replays every
            vehicle on the same pre-drawn batches, and the largest
            adapter deviation goes to ``engine_check_dev``.
        """
        cfg = self.cfg
        if self.engine == "serial":
            return [self._train_serial(p) for p in plans]
        results: List[Dict[str, Any]] = []
        jobs: List[Dict[str, Any]] = []
        slots: List[Tuple[int, int, List[int]]] = []
        for pi, plan in enumerate(plans):
            ti = plan["ti"]
            n = len(plan["active_ids"])
            results.append({"ads_list": None, "groups": {},
                            "accs": np.zeros(n, np.float32)})
            if n == 0:
                continue
            # every vehicle's batches, drawn in the serial engine's order
            # from its shard's own RNG stream
            plan["batches"] = [
                draw_batches(self.client_data[ti][v], plan["steps_list"][i],
                             cfg.local_steps)
                for i, v in enumerate(plan["active_ids"])]
            by_rank: Dict[int, List[int]] = {}
            for i, v in enumerate(plan["active_ids"]):
                by_rank.setdefault(int(plan["ranks"][v]), []).append(i)
            for r in sorted(by_rank):
                idxs = by_rank[r]
                jobs.append({
                    "adapters_list": [plan["adapters_list"][i]
                                      for i in idxs],
                    "batches_list": [plan["batches"][i] for i in idxs],
                    "step_counts": [plan["steps_list"][i] for i in idxs],
                    "eval_batch": self.local_eval[ti],
                    "layer_masks": [plan["fedra_masks"][i] for i in idxs]})
                slots.append((pi, r, idxs))
        outs = self.batched_trainer.run_jobs(self.params, jobs)
        for (pi, r, idxs), (stacked, marr) in zip(slots, outs):
            res = results[pi]
            res["groups"][r] = (stacked, idxs)
            res["accs"][idxs] = marr["eval_accuracy"]
        if self.engine == "batched_check":
            self._check_against_serial(plans, results)
        return results

    # ------------------------------------------------------------------
    def _check_against_serial(self, plans, results) -> None:
        """batched_check: replay the serial trainer on the same pre-drawn
        batches and record the largest |batched − serial| adapter
        entry."""
        dev = 0.0
        for plan, res in zip(plans, results):
            lanes = {i: (stacked, j)
                     for stacked, idxs in res["groups"].values()
                     for j, i in enumerate(idxs)}
            for i in range(len(plan["active_ids"])):
                steps = plan["steps_list"][i]
                per_step = [{k: arr[si] for k, arr in
                             plan["batches"][i].items()}
                            for si in range(steps)]
                ref_ad, _ = self.trainer.finetune(
                    self.params, plan["adapters_list"][i], None, steps,
                    eval_batch=self.local_eval[plan["ti"]],
                    layer_mask=plan["fedra_masks"][i], batches=per_step)
                stacked, j = lanes[i]
                for a, b in zip(leaves(stacked), leaves(ref_ad)):
                    dev = max(dev, float(torch.max(torch.abs(
                        a.select(-3, j) - b))))
        self.engine_check_dev = max(self.engine_check_dev, dev)

    # ------------------------------------------------------------------
    def _finish_task(self, plan: Dict[str, Any], tr: Dict[str, Any],
                     budget: float) -> Dict[str, Any]:
        """Phase 3: §III-C accounting, §IV-E fallbacks, aggregation,
        global eval and the UCB-DUAL dual update for one task."""
        cfg = self.cfg
        ti = plan["ti"]
        rsu = plan["rsu"]
        server = self.servers[ti]
        active_ids = plan["active_ids"]
        ranks, arms = plan["ranks"], plan["arms"]
        departing, staying = plan["departing"], plan["staying"]
        # one canonical pass over the fading RNG
        rate_down_v, rate_up_v = self.channel.round_rates(
            self.rsu_profile.tx_power,
            np.asarray([p.tx_power for p in self.dev_profiles]),
            plan["distances"], self.shadow, active_ids)

        kept_idx: List[int] = []        # positions within the active list
        kept_weights: List[float] = []
        kept_masks: List[Any] = []      # FedRA
        kept_assoc: List[int] = []      # each kept client's RSU
        # semi_sync: positions whose upload defers into the buffer (a
        # departing contributor that does not migrate leaves coverage
        # before its upload lands). With max_delay 0 the buffer holds no
        # round, so every upload lands in its own: sync, bit for bit.
        part = cfg.participation
        deferrable = not part.trivial and part.max_delay > 0
        deferred_idx: List[int] = []
        per_v_reward = np.zeros(cfg.num_vehicles, np.float32)
        per_v_energy = np.zeros(cfg.num_vehicles, np.float32)
        costs_list: List[cm.RoundCosts] = []
        comm_params = 0
        n_fallback = {0: 0, 1: 0, 2: 0}

        for i, v in enumerate(active_ids):
            rank = int(ranks[v])
            dep = bool(departing[v])
            local_acc = float(tr["accs"][i])
            # §III-C costs over the real channel (fades drawn above)
            payload = cm.adapter_payload_params(self.cost_dims, rank)
            g = self.g_cache.get(rank, cm.g_factor(self.cost_cfg, cfg.lora,
                                                   rank))
            if cfg.method == "fedra":
                # FedRA clients train (and upload) only their layer subset
                fr = server.fedra_fraction
                payload = int(payload * fr)
                g = g * (0.4 + 0.6 * fr)
            costs = cm.vehicle_round_costs(
                self.dev_profiles[v], self.rsu_profile, rank=rank,
                payload_params=payload,
                bytes_per_param=cfg.bytes_per_param,
                rate_down=float(rate_down_v[v]),
                rate_up=float(rate_up_v[v]),
                num_samples=int(cfg.batch_size * cfg.local_steps
                                * plan["frac_list"][i]),
                g=g)

            contribute = True
            migrated = False
            extra_energy = 0.0
            extra_latency = 0.0
            if not cfg.rsu_tier.trivial and bool(plan["handoff"][v]):
                # the adapter migrates between two RSUs of the task's tier
                ho_lat, ho_e = cm.handoff_costs(
                    cfg.rsu_tier.handoff_latency,
                    cfg.rsu_tier.handoff_energy, True)
                extra_energy += float(ho_e)
                extra_latency += float(ho_lat)
            if dep and self.spec.mobility_aware:
                peer = self.mobility.nearby_peer(rsu, v, staying)
                dec = mob.decide_fallback(
                    cfg.mobility, cfg.ucb, local_accuracy=local_acc,
                    energy_spent=costs.e_comp,
                    migration_available=peer is not None)
                n_fallback[dec.strategy] += 1
                if dec.strategy == mob.ABANDON:
                    contribute = False
                elif dec.strategy == mob.MIGRATE:
                    migrated = True
                    extra_energy += cfg.mobility.migration_energy
                    extra_latency += cfg.mobility.migration_latency
            elif dep:   # without §IV-E a departure loses the upload
                contribute = False

            tau = costs.latency + extra_latency
            per_v_energy[v] = costs.energy + extra_energy
            per_v_reward[v] = float(ucb_dual.reward(cfg.ucb, local_acc, tau))
            costs_list.append(costs)
            if contribute:
                comm_params += payload
                # a migrating vehicle paid §IV-E's penalty so that its
                # upload lands now; another departing one's defers
                if deferrable and dep and not migrated:
                    deferred_idx.append(i)
                    continue
                kept_idx.append(i)
                kept_weights.append(float(len(self.client_data[ti][v])))
                kept_assoc.append(int(plan["assoc"][v]))
                if plan["fedra_masks"][i] is not None:
                    kept_masks.append(plan["fedra_masks"][i])

        # the RSU processes every upload made this round, deferred too
        agg_costs = cm.rsu_agg_costs(self.rsu_profile,
                                     len(kept_idx) + len(deferred_idx))
        summary = cm.task_round_summary(costs_list, agg_costs)

        # semi_sync: the buffered uploads landing this round are released
        # before the aggregation and this round's missed ones admitted
        # after it (the fused program's age, release, drop, admit order)
        released: List[Any] = []
        if not part.trivial:
            active_mask = np.zeros(cfg.num_vehicles, bool)
            active_mask[active_ids] = True
            released = server.release_buffered(active_mask, plan["assoc"])
        self._aggregate_task(server, tr, kept_idx, kept_weights, kept_masks,
                             kept_assoc, released)
        if deferred_idx:
            server.admit_buffered([
                (int(active_ids[i]),
                 agg.aggregate_merged([self._trained_adapter(tr, i)], [1.0],
                                      cfg.lora.scale),
                 float(len(self.client_data[ti][active_ids[i]])),
                 int(plan["assoc"][active_ids[i]]))
                for i in deferred_idx])

        # global accuracy on the held-out task eval set; under a tier the
        # task has no global model before its first sync
        gad = server.eval_adapters()
        if gad is not None and (kept_idx or released):
            acc = self.trainer.evaluate(self.params, gad,
                                        self.eval_batches[ti])["accuracy"]
        else:
            acc = 0.0

        # UCB-DUAL update with the task's current budget
        if self.spec.adaptive_rank:
            self.ucb_states[ti], info = ucb_dual.update(
                self.ucb_states[ti], cfg.ucb, torch.as_tensor(arms),
                torch.as_tensor(per_v_reward), torch.as_tensor(per_v_energy),
                torch.tensor(budget, dtype=torch.float32))
            lam = float(info["lambda"])
        else:
            lam = 0.0

        tau_t = summary["latency"]
        e_t = float(per_v_energy.sum()) + agg_costs[1]
        reward_t = (cfg.ucb.gamma * acc
                    - cfg.ucb.alpha * tau_t / cfg.ucb.latency_ref)
        mean_rank = float(np.mean([int(r) for r in ranks[active_ids]])
                          ) if len(active_ids) else 0.0
        trec = {"task": self.tasks[ti].name, "accuracy": float(acc),
                "latency": float(tau_t), "energy": float(e_t),
                "reward": float(reward_t),
                "lambda": lam, "mean_rank": mean_rank,
                "active": int(len(active_ids)),
                "departing": int(departing.sum()),
                "handoffs": int((plan["handoff"][active_ids]).sum())
                if len(active_ids) else 0,
                "fallbacks": dict(n_fallback),
                "comm_params": int(comm_params),
                "budget": float(budget)}
        if not part.trivial:
            # the buffer's tallies, semi_sync only (a sync history keeps
            # its schema)
            trec["deferred"] = len(deferred_idx)
            trec["released"] = len(released)
            trec["rel_weight"] = float(sum(r[1] for r in released))
        return trec

    # ------------------------------------------------------------------
    @staticmethod
    def _trained_adapter(tr: Dict[str, Any], i: int) -> Any:
        """The trained adapter tree of active-list position ``i``: the
        serial engine's list entry, or its lane of a batched rank
        group."""
        if tr["ads_list"] is not None:
            return tr["ads_list"][i]
        for stacked, idxs in tr["groups"].values():
            if i in idxs:
                j = idxs.index(i)
                return tree_map(lambda x: x.select(-3, j), stacked)
        raise KeyError(f"active position {i} is in no rank group")

    @staticmethod
    def _aggregate_task(server, tr, kept_idx, kept_weights, kept_masks,
                        kept_assoc, released) -> None:
        """Upload and aggregation: the serial engine's per-client list,
        or the batched engine's stacked rank groups (one lane gather per
        group), with FedRA's layer masks, each client's position in the
        distributed list (residual aggregation) and RSU (a tier), and the
        releases of semi_sync's buffer."""
        if tr["groups"] is None or not kept_idx:
            server.aggregate([tr["ads_list"][i] for i in kept_idx],
                             kept_weights or [1.0],
                             masks=kept_masks or None, indices=kept_idx,
                             assoc=kept_assoc, released=released)
            return
        w_of = dict(zip(kept_idx, kept_weights))
        mask_of = dict(zip(kept_idx, kept_masks))
        a_of = dict(zip(kept_idx, kept_assoc))
        gspecs = []
        for r in sorted(tr["groups"]):
            stacked, idxs = tr["groups"][r]
            lanes = [j for j, i in enumerate(idxs) if i in w_of]
            if not lanes:
                continue
            gi = [idxs[j] for j in lanes]
            gspecs.append({
                "adapters": (stacked if len(lanes) == len(idxs)
                             else take_lanes(stacked, lanes)),
                "weights": np.asarray([w_of[i] for i in gi], np.float32),
                "masks": (np.stack([np.asarray(mask_of[i], np.float32)
                                    for i in gi]) if mask_of else None),
                "indices": gi,
                "assoc": np.asarray([a_of[i] for i in gi], np.int64)})
        server.aggregate_grouped(gspecs, released=released)

    # ------------------------------------------------------------------
    def run_scanned(self, rounds: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
        """Fused engines only: ``rounds`` communication rounds with every
        round's mobility, channel draws and data batches staged on the
        host first (the same RNG streams as per-round execution), then
        run on the device without the host between rounds (see
        :meth:`FusedRoundEngine.run_scanned`). Appends to ``history`` and
        returns the new records.

        With an enabled ``SimConfig.checkpoint`` the horizon runs in
        ``interval``-sized chunks with a full-state checkpoint at every
        boundary (the last chunk may be shorter). The staging streams are
        consumed in round order either way, so the chunked run replays
        the unchunked one."""
        if self.fused is None:
            raise ValueError("run_scanned requires engine='fused' "
                             f"(engine={self.engine!r})")
        n = rounds or self.cfg.rounds
        ck = self.cfg.checkpoint
        if not ck.enabled:
            return self.fused.run_scanned(n)
        from repro_torch.checkpoint.carry import save_checkpoint
        out: List[Dict[str, Any]] = []
        done = 0
        while done < n:
            chunk = min(ck.interval, n - done)
            out.extend(self.fused.run_scanned(chunk))
            done += chunk
            save_checkpoint(self)
        return out

    def run(self, rounds: Optional[int] = None, log_every: int = 0
            ) -> List[Dict[str, Any]]:
        """``rounds`` rounds (default ``cfg.rounds``), with a checkpoint
        after every ``interval``-th completed round of the history when
        ``SimConfig.checkpoint`` is enabled. Returns ``history``."""
        n = rounds or self.cfg.rounds
        ck = self.cfg.checkpoint
        for i in range(n):
            rec = self.run_round()
            if log_every and (i % log_every == 0):
                print(f"[{self.cfg.method}] round {i:3d} "
                      f"acc={rec['accuracy']:.3f} reward={rec['reward']:.2f} "
                      f"E={rec['energy']:.0f}J lat={rec['latency']:.1f}s")
            if ck.enabled and len(self.history) % ck.interval == 0:
                from repro_torch.checkpoint.carry import save_checkpoint
                save_checkpoint(self)
        return self.history

    # ------------------------------------------------------------------
    def summary(self, tail: int = 10) -> Dict[str, float]:
        h = self.history
        if not h:
            return {"method": self.cfg.method, "rounds": 0,
                    "cum_reward": 0.0, "best_accuracy": 0.0,
                    "avg_latency": 0.0, "avg_energy": 0.0,
                    "avg_comm_params": 0.0}
        tail_h = h[-tail:]
        return {
            "method": self.cfg.method,
            "rounds": len(h),
            "cum_reward": float(sum(r["reward"] for r in h)),
            "best_accuracy": float(max(r["accuracy"] for r in h)),
            "avg_latency": float(np.mean([r["latency"] for r in tail_h])),
            "avg_energy": float(np.mean([r["energy"] for r in tail_h])),
            "avg_comm_params": float(np.mean(
                [sum(t["comm_params"] for t in r["tasks"]) for r in tail_h])),
        }
