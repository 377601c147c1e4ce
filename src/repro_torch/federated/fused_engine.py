"""Fused round engine, port of ``repro/federated/fused_engine.py`` (one
device).

The batched engine trains each (task, rank) group as one stack of lanes
but still plans, distributes, accounts and aggregates on the host between
them. This engine runs the whole round as one program over the
rank-padded fleet:

    ucb_dual.select_ranks → SVD redistribution at per-vehicle ranks
    → local fine-tuning of the whole fleet → §III-C costs + §IV-E
    fallbacks → rank-padded merged-delta aggregation → global eval
    → ucb_dual.update + Algorithm-1 budget step

Every adapter lives in a max_rank-wide slot whose tail is zero, masked
per lane (core.lora's rank-padding invariant), so no shape depends on the
round's coverage, departures or rank mix. The host stages the round
(mobility tick, channel draws, data batches, fresh adapters, the SVD
sketches) into static input buffers, the program runs, and one small
record comes back.

On a card the program is captured once as CUDA graphs and replayed every
round after. ``torch.linalg.svd`` checks its LAPACK status on the host,
which a capture refuses, so the round is cut around the two shared SVDs
(the distribution's at seed = round, the global eval's at seed 0) into
two captured segments, and the two ``merged_svd`` calls run eagerly
between them: ``merged_svd`` (eager) → segment 1 (graph: selection,
distribution, training, local eval, costs, fallbacks, aggregation) →
``merged_svd`` (eager) → segment 2 (graph: global eval, dual update,
budget step, the record). The eager calls read and write static buffers
too; nothing is read on the host between segments. On the CPU the same
functions run eagerly, in the same order.

The reference's two ``lax.cond``\\ s (distribution from the SVD or from
the fresh draws; global eval only when uploads were kept) compute both
branches and select with ``torch.where``; the SVD of an all-zero delta
is finite, so the unselected branch is harmless.

Exactness contract (as the reference's): the host stages by consuming the
serial engine's RNG streams in its order; fresh adapters come from each
server's stream at max_rank, rank-independently, for every round of a
task that has no merged delta yet; everything else replays the serial
maths in-program. The reference's ``run_scanned`` stages one fresh draw
per task on the trivial tier, so a task whose first covered round keeps
no upload (every one deferred, say) trains from zero adapters next round
there; the port's :meth:`FusedRoundEngine.run_scanned` draws every
round's adapters, as the reference's does under a tier, and stays exact:
it draws them just before the round runs, so one round's draws are held
at a time.

The ablations are static branches of the program, as in the
reference: without ``mobility_aware`` (``ours_no_mobility``) a departing
vehicle's upload is lost and no §IV-E fallback is taken; without
``energy_scheduler`` (``ours_no_energy``) the allocator keeps its
budgets and only its round advances. Each method captures its own
graphs.

So are the round's modes. A non-trivial RSU tier charges each handoff
the migration penalty, segment-sums the uploads into per-RSU partials
(the carry's ``partials``, ``partial_w``, ``partial_age``) and merges
them into the global delta in a sync round. Whether a round syncs is
data, the staged ``sync`` input, never a Python branch: a captured round
is replayed every round, so a gate read on the host at capture would
keep round 0's answer for good. The same holds for the refresh, merge
and release masks, each a ``torch.where``. ``semi_sync`` participation
carries the in-flight buffer (``buf_delta`` per task with the fleet on
the lane axis, ``buf_w``, ``buf_age``, ``buf_dest``): each round ages it,
releases the entries of lanes back in coverage into the merge (or their
RSU's partial), drops the overdue ones and admits the deferred lanes'
merged deltas, in place and one target at a time. The first round runs
eagerly and the capture follows it: the buffer is too large to
snapshot for a warm-up that is put back.

Not ported (raises ``NotImplementedError``): the sharded fleet (ROADMAP
Queue 1, item 12) and zamba2 as ``train_arch`` (item 11, "zamba2 in the
fused round").
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import cost_model as cm
from repro_torch.core import energy_alloc
from repro_torch.core import lora as lora_lib
from repro_torch.core import mobility as mob
from repro_torch.core import ucb_dual
from repro_torch.federated.baselines import METHODS
from repro_torch.federated.batched_client import LANE_AXIS, draw_batches
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves

FUSED_METHODS = ("ours", "ours_no_energy", "ours_no_mobility")
SHARD_ITEM = "ROADMAP Queue 1, item 12"
# one record row per task, float64 (ints exact): the program's outputs in
# this order
REC = ("accuracy", "latency", "energy", "lambda", "rank_sum", "active",
       "departing", "handoffs", "fb0", "fb1", "fb2", "comm_params",
       "n_kept", "has_m", "budget")
# semi_sync's buffer tallies, recorded under it only
SEMI_REC = ("deferred", "released", "rel_weight")
# static inputs staged per round: int64 and f32 vectors of (T, V) (peer,
# fresh_use and sync are (T,))
INT_INPUTS = ("active", "departing", "handoff", "assoc", "counts", "peer",
              "fresh_use", "sync")
PER_TASK = ("peer", "fresh_use", "sync")
F32_INPUTS = ("rate_down", "rate_up")
# the carry's small leaves, fetched with the record every round
STATE = ("counts", "reward_sum", "energy_sum", "lam", "ucb_round",
         "budgets", "difficulty", "alloc_round")


def supports_method(method: str) -> bool:
    return method in FUSED_METHODS


def _where_tree(cond, a, b):
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _copy_tree(dst, src) -> None:
    """Copy ``src`` into the static tree ``dst``, leaf by key."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _scatter_lanes(fleet, lanes, stacked) -> None:
    """Write ``stacked``'s lanes into the static fleet tree at ``lanes``
    (the other lanes keep what they hold; the program masks them)."""
    idx = torch.as_tensor(np.asarray(lanes), dtype=torch.int64)
    tree_map(lambda z, d: z.index_copy_(LANE_AXIS, idx.to(z.device), d),
             fleet, stacked)


class FusedRoundEngine:
    """The round as one program over the rank-padded fleet, bound to an
    :class:`~repro_torch.sim.simulator.IoVSimulator`.

    Owns the device carry (UCB-DUAL states, merged deltas, allocator) in
    static buffers and mirrors it back onto the simulator after every
    round. ``capture`` (default: on a CUDA device) captures the round's
    two segments as CUDA graphs on the first round and replays them after;
    ``capture=False`` runs the same functions eagerly (on the CPU always).
    ``captures`` counts captures of the round (1 after the first round,
    whatever follows), ``segments`` the graphs per round.
    """

    segments = 2

    def __init__(self, sim, check: bool = False, *,
                 capture: Optional[bool] = None):
        cfg = sim.cfg
        if not supports_method(cfg.method):
            raise ValueError(
                f"engine='fused' supports methods {FUSED_METHODS}, not "
                f"{cfg.method!r}; use the batched or serial engine")
        if not cfg.shard.trivial:
            raise NotImplementedError(
                f"the sharded fleet is not ported yet ({SHARD_ITEM})")
        if sim.model_cfg.shared_attn_every:
            raise NotImplementedError(
                f"{sim.model_cfg.name} in the fused round is not ported yet "
                "(ROADMAP Queue 1, item 11: zamba2 in the fused round)")
        self.sim = sim
        self.cfg = cfg
        self.spec = METHODS[cfg.method]
        self.check = bool(check)
        self.device = sim.device
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.capture = bool(capture)
        self.captures = 0
        self.model_cfg = sim.model_cfg
        self.trainer = sim.batched_trainer
        self.V = cfg.num_vehicles
        self.T = cfg.num_tasks
        self.Rmax = cfg.lora.max_rank
        self.lora_max = dataclasses.replace(cfg.lora, rank=self.Rmax)
        self.S0 = cfg.lora.scale      # server-side merge/redistribute α/r₀
        self.alpha = cfg.lora.alpha
        self.tier, self.part = cfg.rsu_tier, cfg.participation
        self.K = self.tier.num_rsus_per_task
        self.rec_keys = REC + (() if self.part.trivial else SEMI_REC)
        self.steps_full = cfg.local_steps
        self.steps_dep = max(1, int(round(cfg.local_steps
                                          * cfg.departure_fraction)))
        ns_full = int(cfg.batch_size * cfg.local_steps)
        ns_dep = int(cfg.batch_size * cfg.local_steps
                     * cfg.departure_fraction)
        dev = self.device

        def f32(values):
            return torch.as_tensor(np.asarray(values, np.float64)
                                   .astype(np.float32)).to(dev)

        # per-arm tables: the floats the serial engine reads from g_cache
        # and adapter_payload_params
        cand = list(cfg.lora.candidate_ranks)
        payload = [cm.adapter_payload_params(sim.cost_dims, int(r))
                   for r in cand]
        self.cand = torch.as_tensor(cand, dtype=torch.int64).to(dev)
        self.payload_i = torch.as_tensor(payload, dtype=torch.int64).to(dev)
        self.payload_f = f32(payload)
        self.g_arm = f32([sim.g_cache[int(r)] for r in cand])
        # fleet device profiles; κ·f³ folded on the host in float64
        profs = sim.dev_profiles
        self.freq = f32([p.freq for p in profs])
        self.comp_power = f32([p.kappa * p.freq ** 3 for p in profs])
        self.dev_tx = f32([p.tx_power for p in profs])
        self.flops_ps = f32([p.flops_per_sample for p in profs])
        rsu = sim.rsu_profile
        self.rsu_tx = float(rsu.tx_power)
        self.agg_tau_pv = float(rsu.agg_flops_per_vehicle / rsu.freq)
        self.agg_e_pv = float(rsu.kappa * rsu.freq ** 3 * self.agg_tau_pv)
        self.ns = f32([ns_full, ns_dep])
        # data-size aggregation weights (T, V)
        self.weights = f32([[float(len(sim.client_data[t][v]))
                             for v in range(self.V)] for t in range(self.T)])

        def ints(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(dev)
        self.local_eval = [{k: ints(v) for k, v in b.items()}
                           for b in sim.local_eval]
        self.eval_batches = [{k: ints(v) for k, v in b.items()}
                             for b in sim.eval_batches]
        self._alloc_buffers()
        self._carry_ready = False
        self._has_merged_host = [False] * self.T
        self._round = 0
        self._graphs = None
        self._mid = self._graph_mid = None

    # ------------------------------------------------------------------
    # Static buffers
    # ------------------------------------------------------------------
    def _alloc_buffers(self) -> None:
        sim, dev, nt, V = self.sim, self.device, self.T, self.V
        K = len(self.cfg.lora.candidate_ranks)
        R = self.Rmax
        tmpl = T.init_adapters(self.model_cfg, self.lora_max, rank=R,
                               device="cpu")
        # merged-delta tree {"delta": (L, d_in, d_out)} and the SVD tree
        # {"u": (L, d_in, R), "s": (L, R), "vt": (L, R, d_out)} per target
        zero_merged, zero_svd = tmpl, tmpl
        for path in agg.tree_paths(tmpl):
            ad = agg.tree_get(tmpl, path)
            lead, d1, d2 = ad["a"].shape[:-2], ad["a"].shape[-2], \
                ad["b"].shape[-1]

            def z(*shape):
                return torch.zeros(lead + shape, dtype=torch.float32,
                                   device=dev)
            zero_merged = agg.tree_set(zero_merged, path,
                                       {"delta": z(d1, d2)})
            zero_svd = agg.tree_set(zero_svd, path, {
                "u": z(d1, R), "s": z(R), "vt": z(R, d2)})
        # the merged tree's structure and shapes, for the sketches
        self._merged_like = tree_map(
            lambda t: torch.empty(t.shape, device="meta"), zero_merged)
        self.omega_shapes = agg.svd_omega_shapes(zero_merged, R)
        S = sim.task_data[0]["tokens"].shape[-1]
        B = self.cfg.batch_size
        self._int_layout = ([(k, (nt,) if k in PER_TASK else (nt, V))
                             for k in INT_INPUTS]
                            + [("tokens", (nt, V, self.steps_full, B, S)),
                               ("labels", (nt, V, self.steps_full, B))])
        self._f32_layout = [(k, (nt, V)) for k in F32_INPUTS]
        n_int = sum(int(np.prod(sh)) for _, sh in self._int_layout)
        n_f32 = (sum(int(np.prod(sh)) for _, sh in self._f32_layout)
                 + sum(d2 * r for _, d2, r in self.omega_shapes))
        self.int_in = torch.zeros(n_int, dtype=torch.int64, device=dev)
        self.f32_in = torch.zeros(n_f32, dtype=torch.float32, device=dev)
        self.x = self._views(self.int_in, self.f32_in)

        def fleet(a):
            return torch.zeros(a.shape[:-2] + (V,) + a.shape[-2:],
                               dtype=torch.float32, device=dev)
        self.fresh = [tree_map(fleet, tmpl) for _ in range(nt)]
        self.omega0 = tree_map(lambda t: t.to(dev), agg.draw_omegas(
            zero_merged, R, 0, sim.servers[0].draw_omega))
        # the carry
        z = torch.zeros((nt, V, K), dtype=torch.float32, device=dev)
        self.carry = {
            "counts": z, "reward_sum": z.clone(), "energy_sum": z.clone(),
            "lam": torch.zeros(nt, dtype=torch.float32, device=dev),
            "ucb_round": torch.zeros(nt, dtype=torch.float32, device=dev),
            "budgets": torch.zeros(nt, dtype=torch.float32, device=dev),
            "difficulty": torch.zeros(nt, dtype=torch.float32, device=dev),
            "alloc_round": torch.zeros((), dtype=torch.int64, device=dev),
            "has_merged": torch.zeros(nt, dtype=torch.bool, device=dev),
            "merged": [zero_merged] + [tree_map(torch.clone, zero_merged)
                                       for _ in range(nt - 1)]}

        def lanes(n):
            return [tree_map(lambda d: torch.zeros(
                d.shape[:-2] + (n,) + d.shape[-2:], dtype=torch.float32,
                device=dev), zero_merged) for _ in range(nt)]
        if not self.tier.trivial:
            # per task: the RSU partials (segment axis on the lane axis),
            # each one's data weight and rounds since its last refresh
            self.carry["partials"] = lanes(self.K)
            self.carry["partial_w"] = torch.zeros(
                (nt, self.K), dtype=torch.float32, device=dev)
            self.carry["partial_age"] = torch.zeros(
                (nt, self.K), dtype=torch.float32, device=dev)
        if not self.part.trivial:
            # per task: each lane's buffered merged delta, its data weight
            # (0: empty), rounds waited and destination RSU
            self.carry["buf_delta"] = lanes(V)
            self.carry["buf_w"] = torch.zeros((nt, V), dtype=torch.float32,
                                              device=dev)
            self.carry["buf_age"] = torch.zeros((nt, V), dtype=torch.float32,
                                                device=dev)
            self.carry["buf_dest"] = torch.full((nt, V), -1,
                                                dtype=torch.int64, device=dev)
        # the two shared SVDs per task, written by the eager segments
        self.dist_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        self.eval_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        # the record and the small carry (STATE), one float64 vector
        self.out = torch.zeros(nt * len(self.rec_keys) + sum(
            int(np.prod(self.carry[k].shape)) for k in STATE),
            dtype=torch.float64, device=dev)

    def _views(self, ints: torch.Tensor, f32s: torch.Tensor
               ) -> Dict[str, Any]:
        """Named views of one round's staged input vectors."""
        x: Dict[str, Any] = {}
        for vec, layout in ((ints, self._int_layout),
                            (f32s, self._f32_layout)):
            o = 0
            for k, shape in layout:
                n = int(np.prod(shape))
                x[k] = vec[o:o + n].reshape(shape)
                o += n
        om = self._merged_like
        for path, d2, r in self.omega_shapes:
            om = agg.tree_set(om, path, {"omega": f32s[o:o + d2 * r]
                                         .reshape(d2, r)})
            o += d2 * r
        x["omega"] = om
        return x

    # ------------------------------------------------------------------
    # Carry
    # ------------------------------------------------------------------
    def _init_carry(self) -> None:
        """Adopt the simulator's host state into the carry buffers."""
        sim, c = self.sim, self.carry
        with torch.no_grad():
            for t, s in enumerate(sim.ucb_states):
                for k in ("counts", "reward_sum", "energy_sum"):
                    c[k][t].copy_(getattr(s, k))
                c["lam"][t].copy_(s.lam)
                c["ucb_round"][t].copy_(s.round)
            self._has_merged_host = [sim.servers[t].merged is not None
                                     for t in range(self.T)]
            for t in range(self.T):
                m = sim.servers[t].merged
                if m is None:
                    for d in leaves(c["merged"][t]):
                        d.zero_()
                else:
                    _copy_tree(c["merged"][t], m)
            c["has_merged"].copy_(torch.as_tensor(self._has_merged_host))
            for t, srv in enumerate(sim.servers):
                if not self.tier.trivial:
                    self._adopt_partials(t, srv)
                if not self.part.trivial:
                    self._adopt_buffer(t, srv)
            c["budgets"].copy_(sim.alloc.budgets)
            c["difficulty"].copy_(sim.alloc.difficulty)
            c["alloc_round"].fill_(int(sim.alloc.round))
        self._round = int(sim.servers[0].round)
        self._carry_ready = True

    def _adopt_partials(self, t: int, srv) -> None:
        """Task t's RSU partials from its host server (zeros where it has
        none)."""
        c = self.carry
        for d in leaves(c["partials"][t]):
            d.zero_()
        for k, p in enumerate(srv.partials or []):
            if p is not None:
                tree_map(lambda d, s: d.select(LANE_AXIS, k).copy_(s),
                         c["partials"][t], p)
        c["partial_w"][t].copy_(torch.as_tensor(srv.partial_w))
        c["partial_age"][t].copy_(torch.as_tensor(srv.partial_age))

    def _adopt_buffer(self, t: int, srv) -> None:
        """Task t's in-flight buffer from its host server, each entry at
        its vehicle's lane (the others empty)."""
        c = self.carry
        for d in leaves(c["buf_delta"][t]):
            d.zero_()
        w = np.zeros(self.V, np.float32)
        age = np.zeros(self.V, np.float32)
        dest = np.full(self.V, -1, np.int64)
        for v, ent in srv.buffer.items():
            tree_map(lambda d, s: d.select(LANE_AXIS, v).copy_(s),
                     c["buf_delta"][t], ent["delta"])
            w[v], age[v], dest[v] = ent["w"], ent["age"], ent["dest"]
        c["buf_w"][t].copy_(torch.from_numpy(w))
        c["buf_age"][t].copy_(torch.from_numpy(age))
        c["buf_dest"][t].copy_(torch.from_numpy(dest))

    def reset_carry(self) -> None:
        """Re-adopt the simulator's host state before the next round (after
        a restore, or an engine switch); the buffers and any captured
        graphs stay."""
        self._carry_ready = False
        self._has_merged_host = [self.sim.servers[t].merged is not None
                                 for t in range(self.T)]

    # ------------------------------------------------------------------
    # Host staging: the serial engine's RNG streams, in its order
    # ------------------------------------------------------------------
    def _stage_round(self, allow_fresh: Sequence[bool], seed: int
                     ) -> Tuple[Dict[str, np.ndarray], List[Any]]:
        """Advance mobility one tick and stage every input of the round
        program on the host. Returns (x, lanes): x holds numpy arrays
        named as :meth:`_views` names them (``omega``: the distribution's
        sketches at ``seed``); lanes[t] holds task t's active lanes where
        it takes fresh adapters this round, else None
        (:meth:`_draw_fresh` draws them)."""
        sim = self.sim
        sim.mobility.step()
        x = {k: np.zeros(shape, np.int64) for k, shape in self._int_layout}
        x.update({k: np.zeros(shape, np.float32)
                  for k, shape in self._f32_layout})
        lanes: List[Any] = []
        dev_tx = np.asarray([p.tx_power for p in sim.dev_profiles])
        for t in range(self.T):
            view = sim.mobility.round_view_group(sim.rsu_groups[t])
            act, dep = view["active"], view["departing"]
            ids = np.where(act)[0]
            x["active"][t], x["departing"][t] = act, dep
            x["handoff"][t] = view["handoff"]
            x["assoc"][t] = view["assoc"]
            x["peer"][t] = bool(view["peer_available"])
            rd, ru = sim.channel.round_rates(self.rsu_tx, dev_tx,
                                             view["distances"], sim.shadow,
                                             ids)
            x["rate_down"][t], x["rate_up"][t] = rd, ru
            cnt = np.where(act, np.where(dep, self.steps_dep,
                                         self.steps_full), 0)
            x["counts"][t] = cnt
            for v in ids:
                b = draw_batches(sim.client_data[t][v], int(cnt[v]),
                                 self.steps_full)
                x["tokens"][t, v] = b["tokens"]
                x["labels"][t, v] = b["labels"]
            if allow_fresh[t] and len(ids):
                lanes.append(ids)
                x["fresh_use"][t] = 1
            else:
                lanes.append(None)
        x["sync"][:] = (seed + 1) % self.tier.sync_period == 0
        x["omega"] = agg.draw_omegas(self._merged_like, self.Rmax, seed,
                                     sim.servers[0].draw_omega)
        return x, lanes

    def _draw_fresh(self, lanes: Sequence[Any]) -> List[Any]:
        """(lanes, draws) per task from each server's fresh-adapter
        stream, max_rank draws stacked on the lane axis, or None where
        ``lanes[t]`` is None. Each server's stream serves only these
        draws, so drawing a round's adapters just before it runs keeps
        the serial server's order."""
        return [None if ids is None else
                (ids, self.sim.servers[t].fresh_padded(len(ids)))
                for t, ids in enumerate(lanes)]

    def _pack(self, x: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """One round's staged arrays as the int64 and f32 vectors
        :meth:`_views` reads."""
        ints = np.concatenate([x[k].reshape(-1)
                               for k, _ in self._int_layout])
        om = [agg.tree_get(x["omega"], p)["omega"].reshape(-1).cpu()
              .numpy() for p, _, _ in self.omega_shapes]
        f32s = np.concatenate([x[k].reshape(-1)
                               for k, _ in self._f32_layout] + om)
        return ints, f32s

    def _upload(self, ints: np.ndarray, f32s: np.ndarray,
                fresh: Sequence[Any]) -> None:
        """Copy one round's staged inputs into the static input buffers
        (two host-to-device copies, plus the fresh draws where staged)."""
        with torch.no_grad():
            self.int_in.copy_(torch.from_numpy(ints))
            self.f32_in.copy_(torch.from_numpy(f32s))
            for t, f in enumerate(fresh):
                if f is not None:
                    _scatter_lanes(self.fresh[t], *f)

    # ------------------------------------------------------------------
    # The round program
    # ------------------------------------------------------------------
    def _dist_svd(self) -> None:
        """Eager segment: every task's distribution SVD of its carried
        merged delta, with the sketches staged at seed = round."""
        with torch.no_grad():
            for t in range(self.T):
                _copy_tree(self.dist_svd[t], agg.merged_svd(
                    self.carry["merged"][t], self.Rmax, self.x["omega"]))

    def _eval_svd(self) -> None:
        """Eager segment: every task's global-eval SVD (seed 0) of the
        merged delta segment 1 left in the carry."""
        with torch.no_grad():
            for t in range(self.T):
                _copy_tree(self.eval_svd[t], agg.merged_svd(
                    self.carry["merged"][t], self.Rmax, self.omega0))

    def _main(self) -> Dict[str, Any]:
        """Segment 1, per task: rank selection, distribution, fleet
        training and local eval, costs, fallbacks, aggregation. Writes the
        merged deltas and has_merged into the carry; returns what segment
        2 reads."""
        cfg, ucb_cfg, mcfg = self.cfg, self.cfg.ucb, self.cfg.mobility
        x, c, sim = self.x, self.carry, self.sim
        mid: Dict[str, Any] = {k: [] for k in (
            "arms", "reward", "energy", "keep", "lat", "e_t", "rank_sum",
            "n_active", "n_kept", "fb", "comm", "dep", "hoff", "has_m")
            + SEMI_REC}
        if self.check:
            mid.update(dist=[], new=[], ranks=[])
        for t in range(self.T):
            act = x["active"][t] > 0
            dep = x["departing"][t] > 0
            state = ucb_dual.UCBDualState(
                counts=c["counts"][t], reward_sum=c["reward_sum"][t],
                energy_sum=c["energy_sum"][t], lam=c["lam"][t],
                round=c["ucb_round"][t])
            # 1. rank selection (Algorithm 2) on device state
            arms = ucb_dual.select_ranks(state, ucb_cfg, act)
            arm_c = torch.clamp(arms, min=0)
            ranks = self.cand[arm_c]
            scale_v = self.alpha / torch.clamp(ranks.float(), min=1.0)
            rmask = lora_lib.rank_arange_mask(ranks, self.Rmax)
            # 2. distribution: the shared SVD at each lane's rank, or the
            #    staged fresh draws while the task has no merged delta
            svd_ads = agg.factors_for_ranks(self.dist_svd[t], rmask, self.S0)
            use = x["fresh_use"][t].float()
            fresh_ads = _mask_lanes(self.fresh[t], rmask * use)
            dist = _where_tree(c["has_merged"][t], svd_ads, fresh_ads)
            # 3. fleet megastep: train every lane, then its local eval
            scale = (scale_v, rmask)
            new_ads, _ = self.trainer.train_lanes(
                sim.params, dist, x["tokens"][t], x["labels"][t],
                x["counts"][t], self.steps_full, scale=scale)
            local_acc = self.trainer.evaluate_lanes(
                sim.params, new_ads, self.local_eval[t], self.V, scale=scale)
            # 4. §III-C costs over the staged channel
            costs = cm.vehicle_round_costs_vec(
                freq=self.freq, comp_power=self.comp_power,
                tx_power=self.dev_tx, flops_per_sample=self.flops_ps,
                rsu_tx_power=self.rsu_tx,
                payload_params=self.payload_f[arm_c],
                bytes_per_param=cfg.bytes_per_param,
                rate_down=x["rate_down"][t], rate_up=x["rate_up"][t],
                num_samples=torch.where(dep, self.ns[1], self.ns[0]),
                g=self.g_arm[arm_c])
            # 5. §IV-E fallbacks for predicted departures; without them a
            #    departure loses the upload
            if self.spec.mobility_aware:
                q_star = mcfg.accuracy_threshold
                c0 = ucb_cfg.gamma * torch.clamp(q_star - local_acc, min=0.0)
                c1 = torch.where(x["peer"][t] > 0, torch.full_like(
                    c0, ucb_cfg.alpha * mcfg.migration_latency
                    + mcfg.beta * mcfg.migration_energy),
                    torch.full_like(c0, float("inf")))
                c2 = mcfg.beta * costs["e_comp"] + ucb_cfg.gamma * q_star
                strat = torch.argmin(torch.stack([c0, c1, c2], dim=-1),
                                     dim=-1)
                migrate = dep & (strat == mob.MIGRATE)
                abandon = dep & (strat == mob.ABANDON)
                extra_e = torch.where(migrate, mcfg.migration_energy, 0.0)
                extra_tau = torch.where(migrate, mcfg.migration_latency, 0.0)
                contribute = act & ~abandon
                fb = torch.sum((act & dep)[:, None]
                               * torch.nn.functional.one_hot(strat, 3), dim=0)
            else:
                migrate = torch.zeros_like(act)
                contribute = act & ~dep
                extra_e = extra_tau = torch.zeros_like(local_acc)
                fb = torch.zeros(3, dtype=torch.int64, device=act.device)
            hoff = act & (x["handoff"][t] > 0)
            if not self.tier.trivial:
                # the adapter migrates between two RSUs of the task's tier
                ho_tau, ho_e = cm.handoff_costs(self.tier.handoff_latency,
                                                self.tier.handoff_energy,
                                                hoff.float())
                extra_e = extra_e + ho_e
                extra_tau = extra_tau + ho_tau
            e_v = costs["energy"] + extra_e
            tau_v = costs["latency"] + extra_tau
            per_v_energy = torch.where(act, e_v, 0.0)
            per_v_reward = torch.where(
                act, ucb_dual.reward(ucb_cfg, local_acc, tau_v), 0.0)
            n_active = torch.sum(act)
            n_kept = torch.sum(contribute)
            # 6. rank-padded aggregation; a round that keeps no upload
            #    (and releases none) leaves the merged delta as it was
            if self.part.trivial:
                keep = n_kept > 0
                w = torch.where(contribute, self.weights[t], 0.0)
            else:
                buf = self._buffer_step(t, act, dep, contribute, migrate)
                w = torch.where(contribute & ~buf["defer"], self.weights[t],
                                0.0)
                keep = (torch.sum(w) > 0) | buf["any_rel"]
            if self.tier.trivial:
                merged_new = agg.aggregate_merged_padded(new_ads, w, self.S0)
                if not self.part.trivial:
                    # releases fold into the live merge at raw weights; a
                    # round without any keeps the plain merge
                    rel_raw, rel_tot = agg.buffer_release_sum(
                        c["buf_delta"][t], buf["relw"])
                    merged_new = _where_tree(buf["any_rel"],
                                             agg.combine_with_released(
                                                 merged_new, torch.sum(w),
                                                 rel_raw, rel_tot),
                                             merged_new)
                merged_out = _where_tree(keep, merged_new, c["merged"][t])
                has_m = c["has_merged"][t] | keep
                eval_gate = keep
            else:
                merged_out, do_merge = self._tier_step(
                    t, new_ads, w, torch.where(contribute, x["assoc"][t], -1),
                    None if self.part.trivial else buf)
                has_m = c["has_merged"][t] | do_merge
                # before its first sync a task has no global model to eval
                eval_gate = keep & has_m
            _copy_tree(c["merged"][t], merged_out)
            c["has_merged"][t].copy_(has_m)
            if not self.part.trivial:
                self._buffer_admit(t, new_ads, buf)
                mid["deferred"].append(torch.sum(buf["defer"]))
                mid["released"].append(torch.sum(buf["release"]))
                mid["rel_weight"].append(torch.sum(buf["relw"]))

            def mmax(a):
                return torch.max(torch.where(act, a, -float("inf")))
            n_kept_f = n_kept.float()
            lat = torch.where(
                n_active > 0, mmax(costs["tau_down"]) + mmax(costs["tau_comp"])
                + mmax(costs["tau_up"]) + self.agg_tau_pv * n_kept_f, 0.0)
            mid["arms"].append(arms)
            mid["reward"].append(per_v_reward)
            mid["energy"].append(per_v_energy)
            mid["keep"].append(eval_gate)
            mid["lat"].append(lat)
            mid["e_t"].append(torch.sum(per_v_energy)
                              + self.agg_e_pv * n_kept_f)
            mid["rank_sum"].append(torch.sum(torch.where(act, ranks, 0)))
            mid["n_active"].append(n_active)
            mid["n_kept"].append(n_kept)
            mid["fb"].append(fb)
            mid["comm"].append(torch.sum(torch.where(
                contribute, self.payload_i[arm_c], 0)))
            mid["dep"].append(torch.sum(dep))
            mid["hoff"].append(torch.sum(hoff))
            mid["has_m"].append(has_m)
            if self.check:
                mid["dist"].append(dist)
                mid["new"].append(new_ads)
                mid["ranks"].append(ranks)
        return mid

    def _sync_gate(self, t: int) -> torch.Tensor:
        """Whether this round syncs task t's tier: the staged input, read
        on the device when the round runs."""
        return self.x["sync"][t] > 0

    def _tier_step(self, t: int, new_ads: Any, w: torch.Tensor,
                   assoc: torch.Tensor, buf: Optional[Dict[str, Any]]
                   ) -> Tuple[Any, torch.Tensor]:
        """Task t's uploads (and releases) into its RSU partials, the
        partials' refresh, age and weight, and in a sync round their merge
        into the global delta, which a round without live partials keeps.
        Updates the carry's partials in place; returns (the merged delta
        out, whether it merged)."""
        c, K, decay = self.carry, self.K, self.tier.staleness_decay
        part_new, seg_w = agg.aggregate_merged_padded_segmented(
            new_ads, w, assoc, K, self.S0)
        if buf is not None:
            # releases land at their destination RSU's partial; a segment
            # without releases keeps the plain segment merge
            dest = torch.where(buf["release"], buf["dest"], -1)
            rel_raw, rel_w = agg.segment_buffer_release(
                c["buf_delta"][t], buf["relw"], dest, K)
            has_rel = (rel_w > 0).reshape(K, 1, 1)
            part_new = _where_tree(has_rel, agg.combine_with_released(
                part_new, seg_w, rel_raw, rel_w), part_new)
            seg_w = seg_w + rel_w
        refreshed = seg_w > 0
        parts = _where_tree(refreshed.reshape(K, 1, 1), part_new,
                            c["partials"][t])
        pw_old, age_old = c["partial_w"][t], c["partial_age"][t]
        pw = torch.where(refreshed, seg_w, pw_old)
        age = torch.where(refreshed, 0.0, torch.where(
            pw_old > 0, age_old + 1.0, age_old))
        is_sync = self._sync_gate(t)
        merged, alive = agg.merge_partials(parts, pw, age, decay)
        # a round without live partials keeps the previous global
        do_merge = is_sync & alive
        merged = _where_tree(do_merge, merged, c["merged"][t])
        _copy_tree(c["partials"][t], parts)
        # a sync opens a new window: only new uploads count toward the next
        c["partial_w"][t].copy_(torch.where(is_sync, 0.0, pw))
        c["partial_age"][t].copy_(torch.where(is_sync, 0.0, age))
        return merged, do_merge

    def _buffer_step(self, t: int, act, dep, contribute, migrate
                     ) -> Dict[str, Any]:
        """semi_sync, before the aggregation: age task t's buffer, find
        the entries released this round (the lane back in coverage within
        max_delay) at their discounted weights, and the lanes whose upload
        defers (a departing contributor that does not migrate; none with
        max_delay 0, which is then sync bit for bit)."""
        c, part = self.carry, self.part
        bw, bage = c["buf_w"][t], c["buf_age"][t]
        occ = bw > 0.0
        age1 = torch.where(occ, bage + 1.0, 0.0)
        within = occ & (age1 <= float(part.max_delay))
        release = act & within
        relw = torch.where(release, bw * agg.staleness_weights(
            age1, part.vehicle_staleness_decay), 0.0)
        if part.max_delay > 0:
            defer = contribute & dep & ~migrate
        else:
            defer = torch.zeros_like(act)
        return {"age1": age1, "release": release, "relw": relw,
                "keep_buf": within & ~act, "defer": defer,
                "any_rel": torch.sum(relw) > 0.0,
                # a release lands at the vehicle's current RSU with
                # buffer_handoffs, else where it trained
                "dest": (self.x["assoc"][t] if part.buffer_handoffs
                         else c["buf_dest"][t])}

    def _buffer_admit(self, t: int, new_ads: Any, buf: Dict[str, Any]
                      ) -> None:
        """semi_sync, after the aggregation: the deferred lanes' merged
        deltas enter task t's buffer at age 0, in-flight entries age,
        released and overdue ones empty (weight 0: an exact no-op in every
        release sum). In place, one target at a time."""
        c, defer, keep = self.carry, buf["defer"], buf["keep_buf"]
        for path in agg.tree_paths(new_ads):
            d = agg.tree_get(c["buf_delta"][t], path)["delta"]
            new = agg.merge_delta_lanes(agg.tree_get(new_ads, path),
                                        self.S0)
            torch.where(defer.reshape(-1, 1, 1), new, d, out=d)
        c["buf_w"][t].copy_(torch.where(defer, self.weights[t], torch.where(
            keep, c["buf_w"][t], 0.0)))
        c["buf_age"][t].copy_(torch.where(defer, 0.0, torch.where(
            keep, buf["age1"], 0.0)))
        c["buf_dest"][t].copy_(torch.where(defer, self.x["assoc"][t],
                                           torch.where(keep, c["buf_dest"][t],
                                                       -1)))

    def _tail(self, mid: Dict[str, Any]) -> None:
        """Segment 2, per task: global eval from the seed-0 SVD, the dual
        update; then the budget step and the record, all into static
        buffers."""
        cfg, c = self.cfg, self.carry
        budgets = c["budgets"].clone()
        rows, accs, states = [], [], []
        for t in range(self.T):
            gad = agg.factors_full(self.eval_svd[t], self.S0)
            with torch.no_grad():
                _, met = T.loss_fn(self.sim.params, gad, self.model_cfg,
                                   self.lora_max, self.eval_batches[t])
            acc = torch.where(mid["keep"][t], met["accuracy"], 0.0)
            state = ucb_dual.UCBDualState(
                counts=c["counts"][t], reward_sum=c["reward_sum"][t],
                energy_sum=c["energy_sum"][t], lam=c["lam"][t],
                round=c["ucb_round"][t])
            new, info = ucb_dual.update(state, cfg.ucb, mid["arms"][t],
                                        mid["reward"][t], mid["energy"][t],
                                        budgets[t])
            states.append(new)
            accs.append(acc)
            fb = mid["fb"][t]
            rows.append(torch.stack([v.double().reshape(()) for v in (
                acc, mid["lat"][t], mid["e_t"][t], info["lambda"],
                mid["rank_sum"][t], mid["n_active"][t], mid["dep"][t],
                mid["hoff"][t], fb[0], fb[1], fb[2], mid["comm"][t],
                mid["n_kept"][t], mid["has_m"][t], budgets[t])
                + tuple(mid[k][t] for k in SEMI_REC if mid[k])]))
        for t, s in enumerate(states):
            for k in ("counts", "reward_sum", "energy_sum"):
                c[k][t].copy_(getattr(s, k))
            c["lam"][t].copy_(s.lam)
            c["ucb_round"][t].copy_(s.round)
        if self.spec.energy_scheduler:
            alloc = energy_alloc.step_scan(
                energy_alloc.AllocState(budgets=c["budgets"],
                                        difficulty=c["difficulty"],
                                        round=c["alloc_round"]),
                cfg.energy, torch.stack(mid["e_t"]), torch.stack(accs))
            c["budgets"].copy_(alloc.budgets)
            c["difficulty"].copy_(alloc.difficulty)
            c["alloc_round"].copy_(alloc.round)
        else:   # the budgets stay; only the allocator's round advances
            c["alloc_round"].add_(1)
        self.out.copy_(torch.cat(
            [torch.stack(rows).reshape(-1)]
            + [c[k].double().reshape(-1) for k in STATE]))

    def _phases(self) -> None:
        """The round in order, eagerly."""
        self._dist_svd()
        self._mid = self._main()
        self._eval_svd()
        self._tail(self._mid)

    def _warm_up(self) -> None:
        """The first round, eagerly on a side stream (builds the kernels,
        settles the allocator); the capture follows it, and every later
        round replays. (Putting the carry back for a replay of the first
        round would copy semi_sync's buffer, tens of GiB at full width.)"""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._phases()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _capture(self) -> None:
        """Capture both segments into graphs that share one memory pool.
        A capture records and runs nothing; a failed one raises, and
        nothing falls back to eager. Python's cycle collector runs first
        and is held off until both captures end: a finished simulator and
        its engine hold each other, so a collection could fall inside a
        capture and destroy that engine's graphs there, which invalidates
        the capture (``torch.cuda.graph`` no longer collects on entry)."""
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            g1 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g1):
                mid = self._main()
            g2 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g2, pool=g1.pool()):
                self._tail(mid)
        finally:
            if collecting:
                gc.enable()
        self._graph_mid = mid
        self._graphs = (g1, g2)
        self.captures += 1

    def _execute(self) -> None:
        """One round of the program on the staged inputs."""
        if not self.capture:
            self._phases()
            return
        if self._graphs is None:
            self._warm_up()
            self._capture()
            return
        g1, g2 = self._graphs
        self._dist_svd()
        g1.replay()
        self._eval_svd()
        g2.replay()
        self._mid = self._graph_mid

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def run_round(self) -> Dict[str, Any]:
        """One communication round: stage on the host, copy the inputs
        into the static buffers, run (replay) the program, fetch one
        record."""
        if not self._carry_ready:
            self._init_carry()
        x, lanes = self._stage_round(
            [not hm for hm in self._has_merged_host], self._round)
        self._upload(*self._pack(x), self._draw_fresh(lanes))
        self._execute()
        host = self.out.cpu().numpy()
        if self.check:
            self._run_check(x, self._mid)
        out = self._record(host)
        self._round += 1
        self._sync_sim(host)
        return out

    def run_scanned(self, rounds: int) -> List[Dict[str, Any]]:
        """``rounds`` rounds with the host out of the loop: every round is
        staged first, the staged inputs go to the device in one copy, and
        each round copies its slice (and its fresh draws) into the static
        inputs on the device and runs the program. The records come back
        in one copy at the end."""
        if self.check:
            raise ValueError("engine='fused_check' verifies round by round;"
                             " use run()/run_round(), not run_scanned()")
        if not self._carry_ready:
            self._init_carry()
        # a task without a global model at the start draws fresh adapters
        # for every round, as the serial server does until its first merge
        # (under a tier, its first sync); each round's draws are made and
        # go into the fleet just before that round runs (one round's draws
        # held at a time), and the program reads them only while the task
        # has no merged delta
        allow = [not hm for hm in self._has_merged_host]
        ints, f32s, lanes_r = [], [], []
        for r in range(rounds):
            x, lanes = self._stage_round(allow, self._round + r)
            lanes_r.append(lanes)
            i, f = self._pack(x)
            ints.append(i)
            f32s.append(f)
        with torch.no_grad():
            all_int = torch.from_numpy(np.stack(ints)).to(self.device)
            all_f32 = torch.from_numpy(np.stack(f32s)).to(self.device)
            outs = torch.empty((rounds,) + self.out.shape,
                               dtype=self.out.dtype, device=self.device)
        for r in range(rounds):
            with torch.no_grad():
                self.int_in.copy_(all_int[r])
                self.f32_in.copy_(all_f32[r])
                for t, f in enumerate(self._draw_fresh(lanes_r[r])):
                    if f is not None:
                        _scatter_lanes(self.fresh[t], *f)
            self._execute()
            with torch.no_grad():
                outs[r].copy_(self.out)
        host = outs.cpu().numpy()
        recs = []
        for r in range(rounds):
            recs.append(self._record(host[r]))
            self._round += 1
        self._sync_sim(host[-1])
        return recs

    # ------------------------------------------------------------------
    def _record(self, host: np.ndarray) -> Dict[str, Any]:
        """One round's record in the serial engine's history schema."""
        sim = self.sim
        cfg = self.cfg.ucb
        n = len(self.rec_keys)
        rows = host[:self.T * n].reshape(self.T, n)
        tasks = []
        for t in range(self.T):
            h = dict(zip(self.rec_keys, rows[t]))
            active = int(h["active"])
            acc, lat = float(h["accuracy"]), float(h["latency"])
            tasks.append({
                "task": sim.tasks[t].name, "accuracy": acc, "latency": lat,
                "energy": float(h["energy"]),
                "reward": cfg.gamma * acc - cfg.alpha * lat / cfg.latency_ref,
                "lambda": float(h["lambda"]),
                "mean_rank": (float(h["rank_sum"]) / active if active
                              else 0.0),
                "active": active, "departing": int(h["departing"]),
                "handoffs": int(h["handoffs"]),
                "fallbacks": {i: int(h[f"fb{i}"]) for i in range(3)},
                "comm_params": int(h["comm_params"]),
                "budget": float(h["budget"])})
            if not self.part.trivial:
                tasks[-1].update(deferred=int(h["deferred"]),
                                 released=int(h["released"]),
                                 rel_weight=float(h["rel_weight"]))
            if h["has_m"]:
                self._has_merged_host[t] = True
        rec = {"round": len(sim.history), "tasks": tasks,
               "budgets": [t["budget"] for t in tasks],
               "reward": float(sum(t["reward"] for t in tasks)),
               "energy": float(sum(t["energy"] for t in tasks)),
               "latency": float(max((t["latency"] for t in tasks),
                                    default=0.0)),
               "accuracy": float(np.mean([t["accuracy"] for t in tasks]))}
        sim.history.append(rec)
        return rec

    def _sync_sim(self, host: np.ndarray) -> None:
        """Mirror the carry onto the simulator: UCB-DUAL states and the
        allocator on the CPU (from the fetched vector), each server's
        merged deltas (a copy on the device) and round."""
        sim, c = self.sim, self.carry
        st, o = {}, self.T * len(self.rec_keys)
        for k in STATE:
            n = int(np.prod(c[k].shape))
            st[k] = torch.from_numpy(host[o:o + n].astype(np.float32)
                                     ).reshape(c[k].shape)
            o += n
        sim.ucb_states = [ucb_dual.UCBDualState(
            counts=st["counts"][t], reward_sum=st["reward_sum"][t],
            energy_sum=st["energy_sum"][t], lam=st["lam"][t],
            round=st["ucb_round"][t]) for t in range(self.T)]
        sim.alloc = energy_alloc.AllocState(
            budgets=st["budgets"], difficulty=st["difficulty"],
            round=int(st["alloc_round"]))
        for t in range(self.T):
            if self._has_merged_host[t]:
                sim.servers[t].load_merged(
                    tree_map(torch.clone, c["merged"][t]), self._round)
            else:
                sim.servers[t].round = self._round
            if not self.tier.trivial:
                sim.servers[t].load_partials(
                    agg.unstack_partials(c["partials"][t], self.K),
                    c["partial_w"][t].cpu().numpy(),
                    c["partial_age"][t].cpu().numpy())
            if not self.part.trivial:
                sim.servers[t].load_buffer(
                    c["buf_delta"][t], c["buf_w"][t].cpu().numpy(),
                    c["buf_age"][t].cpu().numpy(),
                    c["buf_dest"][t].cpu().numpy())

    # ------------------------------------------------------------------
    def _run_check(self, x: Dict[str, Any], mid: Dict[str, Any]) -> None:
        """fused_check: replay the serial LocalTrainer on the staged
        batches from each active lane's distributed adapters; record the
        largest adapter deviation."""
        sim = self.sim
        dev = 0.0
        for t in range(self.T):
            ranks = mid["ranks"][t].cpu().numpy()
            for v in np.where(x["active"][t])[0]:
                r = int(ranks[v])
                lane = tree_map(lambda a: a.select(LANE_AXIS, int(v)),
                                mid["dist"][t])
                n = int(x["counts"][t][v])
                per_step = [{"tokens": x["tokens"][t, v, si],
                             "labels": x["labels"][t, v, si]}
                            for si in range(n)]
                ref, _ = sim.trainer.finetune(
                    sim.params, lora_lib.truncate_adapter_tree(lane, r),
                    None, n, batches=per_step)
                got = lora_lib.truncate_adapter_tree(tree_map(
                    lambda a: a.select(LANE_AXIS, int(v)), mid["new"][t]), r)
                for a, b in zip(leaves(got), leaves(ref)):
                    dev = max(dev, float(torch.max(torch.abs(a - b))))
        sim.engine_check_dev = max(sim.engine_check_dev, dev)


def _mask_lanes(tree: Any, mask: torch.Tensor) -> Any:
    """Zero each lane's rank tail in a fleet-stacked tree (lanes on the
    lane axis): mask (V, R) multiplies a's columns and b's rows."""
    V, R = mask.shape

    def one(ad):
        return {"a": ad["a"] * mask.reshape(V, 1, R),
                "b": ad["b"] * mask.reshape(V, R, 1)}
    out = tree
    for path in agg.tree_paths(tree):
        out = agg.tree_set(out, path, one(agg.tree_get(tree, path)))
    return out
