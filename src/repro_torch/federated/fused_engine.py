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

The device-sharded fleet (``engine="fused_sharded"``, or a non-trivial
``SimConfig.shard``) runs the same round with its lanes split over a 1-D
fleet mesh (``launch.mesh.make_fleet_mesh``) from one controlling
process: :class:`ShardedRoundEngine`. The fleet is padded to ``Vp =
ceil(V/N)·N`` lanes with zero-weight lanes (exact no-ops, as absent
vehicles are) and real lanes are placed by :func:`fleet_slots`; shard i
holds slots ``[i·Vp/N, (i+1)·Vp/N)`` on ``devices[i]`` (repeats allowed:
two shards may share one card, and ``["cpu"] * N`` runs on the CPU).
Every per-lane step (selection, distribution, training, local eval,
costs, fallbacks, the per-vehicle UCB statistics, the semi_sync buffer)
runs on the shard's own device; the global state (merged deltas, the two
SVDs, the allocator, the RSU partials, λ and the UCB round) lives on the
first (home) device and is copied to the shards each round. Every
cross-lane reduction becomes a per-shard raw sum that the home device
adds in shard order, so a run repeats bit for bit; against the unsharded
engine integer facts are exact and floats agree to the tolerance of the
changed summation order. After each round the host sees vehicle order
(:meth:`ShardedRoundEngine._sync_sim`), so history, checkpoints and
engine switches see what an unsharded run gives them. On a card each
shard's lane segment is captured as a CUDA graph on its own device (its
own pool), the home device's two segments as two more, and the
cross-device copies run between the replays with the two eager SVDs.

Not ported (raises ``NotImplementedError``): zamba2 as ``train_arch``
(item 11, "zamba2 in the fused round").
"""
from __future__ import annotations

import contextlib
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
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.launch.sharding import fleet_lanes
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves

FUSED_METHODS = ("ours", "ours_no_energy", "ours_no_mobility")
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
# the sharded engine's: the per-vehicle statistics stay on the shards
HOME_STATE = STATE[3:]
# each shard's partial sums per task: exact integers, then f32 sums and
# maxima (then the (K,) segment weights and release weights of a tier)
PART_INT = ("n_active", "n_kept", "dep", "hoff", "fb0", "fb1", "fb2",
            "rank_sum", "comm", "deferred", "released")
PART_F32 = ("e_sum", "wsum", "relw", "mx_down", "mx_comp", "mx_up")


def supports_method(method: str) -> bool:
    return method in FUSED_METHODS


def fleet_slots(num_vehicles: int, num_shards: int,
                placement: str = "roundrobin") -> Tuple[np.ndarray, int]:
    """Lane → slot map for the (padded) device-sharded fleet, as the
    reference's: pads the fleet to ``Vp = ceil(V / N) · N`` lanes and
    returns ``(slot, Vp)`` where ``slot[v]`` is real lane v's position.
    The mesh splits the slots into N contiguous blocks of ``Vp / N``;
    "block" keeps lanes in order (all padding on the last shard),
    "roundrobin" deals lane v to shard ``v % N``, so real lanes (and the
    round's rank mix) balance across shards."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    vp = -(-num_vehicles // num_shards) * num_shards
    v = np.arange(num_vehicles)
    if placement == "block":
        return v, vp
    if placement != "roundrobin":
        raise ValueError(f"unknown placement {placement!r}")
    per_shard = vp // num_shards
    return (v % num_shards) * per_shard + v // num_shards, vp


def usable_devices(device, devices=None) -> List[torch.device]:
    """The devices a fleet on ``device``'s type may use: ``devices`` if
    given, else the visible cards, else one CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def shard_count(cfg, device, check: bool = False, sharded: bool = False,
                devices=None) -> int:
    """The fleet's shard count, with the reference's refusals: a check
    engine never shards (an explicit shard spec with one is refused at
    engine resolution; one from the environment leaves it inert), and
    ``fused_sharded`` resolving to fewer than 2 devices raises rather
    than run one shard under the sharded name."""
    spec = cfg.shard
    usable = usable_devices(device, devices)
    if check:
        if sharded:
            raise ValueError(
                "fused_check replays lanes in vehicle order on the host; "
                "run the check engine unsharded")
        return 1
    if not spec.trivial:
        n = spec.resolve(usable)
    elif sharded:   # engine="fused_sharded" with the default spec: all
        n = len(usable)
    else:
        n = 1
    if sharded and n < 2:
        raise ValueError(
            "engine='fused_sharded' needs >1 visible device but resolved "
            f"to {n} (visible: {[str(d) for d in usable]}); pass "
            "fleet_devices=[...] (repeats allowed, e.g. ['cpu'] * 2), or "
            "use engine='fused' (a single-device run would masquerade as "
            "sharded)")
    return n


def _on(device: torch.device):
    """The device's context for launches and captures (a CUDA device's;
    nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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

    A topology of more than one shard (``sharded``, or a non-trivial
    ``SimConfig.shard``; :func:`shard_count`) builds a
    :class:`ShardedRoundEngine` over ``devices`` (default: the first N
    visible devices of the simulator's type). ``n_shards``, ``Vp`` and
    ``slot`` give the topology (1, V and the identity here).
    """

    segments = 2

    def __new__(cls, sim, check: bool = False, sharded: bool = False, *,
                capture: Optional[bool] = None, devices=None):
        if cls is FusedRoundEngine and shard_count(
                sim.cfg, sim.device, check, sharded, devices) > 1:
            cls = ShardedRoundEngine
        return super().__new__(cls)

    def __init__(self, sim, check: bool = False, sharded: bool = False, *,
                 capture: Optional[bool] = None, devices=None):
        cfg = sim.cfg
        if not supports_method(cfg.method):
            raise ValueError(
                f"engine='fused' supports methods {FUSED_METHODS}, not "
                f"{cfg.method!r}; use the batched or serial engine")
        if sim.model_cfg.shared_attn_every:
            raise NotImplementedError(
                f"{sim.model_cfg.name} in the fused round is not ported yet "
                "(ROADMAP Queue 1, item 11: zamba2 in the fused round)")
        self.sim = sim
        self.cfg = cfg
        self.spec = METHODS[cfg.method]
        self.check = bool(check)
        self.V = cfg.num_vehicles
        self.n_shards = shard_count(cfg, sim.device, check, sharded, devices)
        self.slot, self.Vp = fleet_slots(self.V, self.n_shards,
                                         cfg.shard.placement)
        self.mesh = None
        if self.n_shards > 1:
            self.mesh = make_fleet_mesh(self.n_shards,
                                        axis_name=cfg.shard.axis_name,
                                        device=sim.device, devices=devices)
        self.device = sim.device if self.mesh is None else self.mesh.device
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.capture = bool(capture)
        self.captures = 0
        self.model_cfg = sim.model_cfg
        self.trainer = sim.batched_trainer
        self.params = sim.params
        self.n_lanes = self.V
        self.T = cfg.num_tasks
        self.Rmax = cfg.lora.max_rank
        self.lora_max = dataclasses.replace(cfg.lora, rank=self.Rmax)
        self.S0 = cfg.lora.scale      # server-side merge/redistribute α/r₀
        self.alpha = cfg.lora.alpha
        self.tier, self.part = cfg.rsu_tier, cfg.participation
        self.K = self.tier.num_rsus_per_task
        self.rec_keys = REC + (() if self.part.trivial else SEMI_REC)
        self.state_keys = STATE
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
        tmpl, zero_merged, zero_svd = self._templates()
        self._int_layout, self._f32_layout = self._lane_layout(V)
        n_int = sum(int(np.prod(sh)) for _, sh in self._int_layout)
        n_f32 = (sum(int(np.prod(sh)) for _, sh in self._f32_layout)
                 + sum(d2 * r for _, d2, r in self.omega_shapes))
        self.int_in = torch.zeros(n_int, dtype=torch.int64, device=dev)
        self.f32_in = torch.zeros(n_f32, dtype=torch.float32, device=dev)
        self.x = self._views(self.int_in, self.f32_in)
        self.fresh = self._fleet_trees(tmpl, V, dev)
        self.omega0 = tree_map(lambda t: t.to(dev), agg.draw_omegas(
            zero_merged, self.Rmax, 0, sim.servers[0].draw_omega))
        # the carry: the per-lane statistics and buffer, the global state
        lane = self._lane_carry(V, zero_merged, dev)
        glob = self._global_carry(zero_merged)
        self.carry = {k: lane[k] for k in STATE[:3]}
        self.carry.update(glob)
        self.carry.update({k: v for k, v in lane.items()
                           if k not in STATE[:3]})
        # the two shared SVDs per task, written by the eager segments
        self.dist_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        self.eval_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        self._alloc_out()

    def _alloc_out(self) -> None:
        """The record and the small carry (``state_keys``), one float64
        vector."""
        self.out = torch.zeros(self.T * len(self.rec_keys) + sum(
            int(np.prod(self.carry[k].shape)) for k in self.state_keys),
            dtype=torch.float64, device=self.device)

    def _templates(self) -> Tuple[Any, Any, Any]:
        """(a max_rank adapter tree on the CPU, the zero merged-delta tree
        and the zero SVD tree on the home device); notes the merged tree's
        structure and the sketches' shapes."""
        dev, R = self.device, self.Rmax
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
        return tmpl, zero_merged, zero_svd

    def _lane_layout(self, width: int) -> Tuple[List, List]:
        """The int64 and f32 layouts of one round's staged lane inputs
        over ``width`` lanes."""
        nt = self.T
        S = self.sim.task_data[0]["tokens"].shape[-1]
        B = self.cfg.batch_size
        int_layout = ([(k, (nt,) if k in PER_TASK else (nt, width))
                       for k in INT_INPUTS]
                      + [("tokens", (nt, width, self.steps_full, B, S)),
                         ("labels", (nt, width, self.steps_full, B))])
        return int_layout, [(k, (nt, width)) for k in F32_INPUTS]

    def _fleet_trees(self, tmpl: Any, width: int, dev) -> List[Any]:
        """Per task, a zero adapter tree with ``width`` lanes on the lane
        axis (the fresh draws' static buffer)."""
        def fleet(a):
            return torch.zeros(a.shape[:-2] + (width,) + a.shape[-2:],
                               dtype=torch.float32, device=dev)
        return [tree_map(fleet, tmpl) for _ in range(self.T)]

    def _lanes_like(self, zero_merged: Any, n: int, dev) -> List[Any]:
        """Per task, a zero merged-delta tree with ``n`` entries on the
        lane axis."""
        return [tree_map(lambda d: torch.zeros(
            d.shape[:-2] + (n,) + d.shape[-2:], dtype=torch.float32,
            device=dev), zero_merged) for _ in range(self.T)]

    def _lane_carry(self, width: int, zero_merged: Any, dev
                    ) -> Dict[str, Any]:
        """The per-lane carry over ``width`` lanes: the UCB-DUAL
        statistics, and semi_sync's buffer."""
        nt, K = self.T, len(self.cfg.lora.candidate_ranks)
        z = torch.zeros((nt, width, K), dtype=torch.float32, device=dev)
        c = {"counts": z, "reward_sum": z.clone(), "energy_sum": z.clone()}
        if not self.part.trivial:
            # per task: each lane's buffered merged delta, its data weight
            # (0: empty), rounds waited and destination RSU
            c["buf_delta"] = self._lanes_like(zero_merged, width, dev)
            c["buf_w"] = torch.zeros((nt, width), dtype=torch.float32,
                                     device=dev)
            c["buf_age"] = torch.zeros((nt, width), dtype=torch.float32,
                                       device=dev)
            c["buf_dest"] = torch.full((nt, width), -1, dtype=torch.int64,
                                       device=dev)
        return c

    def _global_carry(self, zero_merged: Any) -> Dict[str, Any]:
        """The carry's global state on the home device: λ and the UCB
        round, the allocator, the merged deltas and a tier's partials."""
        nt, dev = self.T, self.device
        c = {"lam": torch.zeros(nt, dtype=torch.float32, device=dev),
             "ucb_round": torch.zeros(nt, dtype=torch.float32, device=dev),
             "budgets": torch.zeros(nt, dtype=torch.float32, device=dev),
             "difficulty": torch.zeros(nt, dtype=torch.float32, device=dev),
             "alloc_round": torch.zeros((), dtype=torch.int64, device=dev),
             "has_merged": torch.zeros(nt, dtype=torch.bool, device=dev),
             "merged": [zero_merged] + [tree_map(torch.clone, zero_merged)
                                        for _ in range(nt - 1)]}
        if not self.tier.trivial:
            # per task: the RSU partials (segment axis on the lane axis),
            # each one's data weight and rounds since its last refresh
            c["partials"] = self._lanes_like(zero_merged, self.K, dev)
            c["partial_w"] = torch.zeros((nt, self.K), dtype=torch.float32,
                                         device=dev)
            c["partial_age"] = torch.zeros((nt, self.K),
                                           dtype=torch.float32, device=dev)
        return c

    def _views(self, ints: torch.Tensor, f32s: torch.Tensor,
               layouts: Optional[Tuple[List, List]] = None,
               omega: bool = True) -> Dict[str, Any]:
        """Named views of one round's staged input vectors (``layouts``:
        the engine's own by default; ``omega``: the sketches follow the
        f32 entries)."""
        x: Dict[str, Any] = {}
        int_layout, f32_layout = layouts or (self._int_layout,
                                             self._f32_layout)
        for vec, layout in ((ints, int_layout), (f32s, f32_layout)):
            o = 0
            for k, shape in layout:
                n = int(np.prod(shape))
                x[k] = vec[o:o + n].reshape(shape)
                o += n
        if omega:
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
            self._adopt_ucb()
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

    def _adopt_ucb(self) -> None:
        """The UCB-DUAL states of every task from the simulator."""
        c = self.carry
        for t, s in enumerate(self.sim.ucb_states):
            for k in ("counts", "reward_sum", "energy_sum"):
                c[k][t].copy_(getattr(s, k))
            c["lam"][t].copy_(s.lam)
            c["ucb_round"][t].copy_(s.round)

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
            self._put_fresh(fresh)

    def _inputs(self) -> List[torch.Tensor]:
        """The static input vectors, in the order of :meth:`_flat`."""
        return [self.int_in, self.f32_in]

    def _flat(self, packed: Tuple) -> List[np.ndarray]:
        """:meth:`_pack`'s result as one vector per :meth:`_inputs`."""
        return list(packed)

    def _put_fresh(self, fresh: Sequence[Any]) -> None:
        """Scatter :meth:`_draw_fresh`'s draws into the fleet's static
        fresh trees."""
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

    def _lanes(self, ctx: Any, t: int) -> Dict[str, Any]:
        """Task t's per-lane work over the lanes ``ctx`` holds (the engine
        itself, or one shard): rank selection, distribution, fleet
        training and local eval, costs, fallbacks, each lane's energy,
        reward and aggregation weight, and semi_sync's buffer step. Reads
        only lane inputs, the lanes' carry and the replicated global
        state; reduces over no lane but the fallback counts."""
        cfg, ucb_cfg, mcfg = self.cfg, self.cfg.ucb, self.cfg.mobility
        x, c = ctx.x, ctx.carry
        act = x["active"][t] > 0
        dep = x["departing"][t] > 0
        state = ucb_dual.UCBDualState(
            counts=c["counts"][t], reward_sum=c["reward_sum"][t],
            energy_sum=c["energy_sum"][t], lam=c["lam"][t],
            round=c["ucb_round"][t])
        # 1. rank selection (Algorithm 2) on device state
        arms = ucb_dual.select_ranks(state, ucb_cfg, act)
        arm_c = torch.clamp(arms, min=0)
        ranks = ctx.cand[arm_c]
        scale_v = self.alpha / torch.clamp(ranks.float(), min=1.0)
        rmask = lora_lib.rank_arange_mask(ranks, self.Rmax)
        # 2. distribution: the shared SVD at each lane's rank, or the
        #    staged fresh draws while the task has no merged delta
        svd_ads = agg.factors_for_ranks(ctx.dist_svd[t], rmask, self.S0)
        use = x["fresh_use"][t].float()
        fresh_ads = _mask_lanes(ctx.fresh[t], rmask * use)
        dist = _where_tree(c["has_merged"][t], svd_ads, fresh_ads)
        # 3. fleet megastep: train every lane, then its local eval
        scale = (scale_v, rmask)
        new_ads, _ = self.trainer.train_lanes(
            ctx.params, dist, x["tokens"][t], x["labels"][t],
            x["counts"][t], self.steps_full, scale=scale)
        local_acc = self.trainer.evaluate_lanes(
            ctx.params, new_ads, ctx.local_eval[t], ctx.n_lanes, scale=scale)
        # 4. §III-C costs over the staged channel
        costs = cm.vehicle_round_costs_vec(
            freq=ctx.freq, comp_power=ctx.comp_power,
            tx_power=ctx.dev_tx, flops_per_sample=ctx.flops_ps,
            rsu_tx_power=self.rsu_tx,
            payload_params=ctx.payload_f[arm_c],
            bytes_per_param=cfg.bytes_per_param,
            rate_down=x["rate_down"][t], rate_up=x["rate_up"][t],
            num_samples=torch.where(dep, ctx.ns[1], ctx.ns[0]),
            g=ctx.g_arm[arm_c])
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
        # the aggregation weights: a deferred upload (semi_sync) waits in
        # the buffer instead
        if self.part.trivial:
            buf = None
            w = torch.where(contribute, ctx.weights[t], 0.0)
        else:
            buf = self._buffer_step(ctx, t, act, dep, contribute, migrate)
            w = torch.where(contribute & ~buf["defer"], ctx.weights[t], 0.0)
        return {"act": act, "dep": dep, "state": state, "arms": arms,
                "arm_c": arm_c, "ranks": ranks, "dist": dist,
                "new_ads": new_ads, "costs": costs, "contribute": contribute,
                "fb": fb, "hoff": hoff, "energy": per_v_energy,
                "reward": per_v_reward, "w": w, "buf": buf}

    def _main(self) -> Dict[str, Any]:
        """Segment 1, per task: the lanes' work (:meth:`_lanes`), then
        the aggregation. Writes the merged deltas and has_merged into the
        carry; returns what segment 2 reads."""
        c = self.carry
        mid: Dict[str, Any] = {k: [] for k in (
            "arms", "reward", "energy", "keep", "lat", "e_t", "rank_sum",
            "n_active", "n_kept", "fb", "comm", "dep", "hoff", "has_m")
            + SEMI_REC}
        if self.check:
            mid.update(dist=[], new=[], ranks=[])
        for t in range(self.T):
            L = self._lanes(self, t)
            act, contribute, w, buf = (L["act"], L["contribute"], L["w"],
                                       L["buf"])
            new_ads, costs = L["new_ads"], L["costs"]
            n_active = torch.sum(act)
            n_kept = torch.sum(contribute)
            # 6. rank-padded aggregation; a round that keeps no upload
            #    (and releases none) leaves the merged delta as it was
            if self.part.trivial:
                keep = n_kept > 0
            else:
                keep = (torch.sum(w) > 0) | buf["any_rel"]
            if self.tier.trivial:
                rel = None
                if not self.part.trivial:
                    # releases fold into the live merge at raw weights
                    rel = agg.buffer_release_sum(c["buf_delta"][t],
                                                 buf["relw"])
                agg_in = (agg.aggregate_merged_padded(new_ads, w, self.S0),
                          torch.sum(w), rel)
            else:
                part_new, seg_w = agg.aggregate_merged_padded_segmented(
                    new_ads, w, torch.where(contribute, self.x["assoc"][t],
                                            -1), self.K, self.S0)
                rel = None
                if not self.part.trivial:
                    # releases land at their destination RSU's partial
                    rel = agg.segment_buffer_release(
                        c["buf_delta"][t], buf["relw"],
                        torch.where(buf["release"], buf["dest"], -1), self.K)
                agg_in = (part_new, seg_w, rel)
            has_m, eval_gate = self._finish(
                t, keep, agg_in, None if buf is None else buf["any_rel"])
            if not self.part.trivial:
                self._buffer_admit(self, t, new_ads, buf)
                mid["deferred"].append(torch.sum(buf["defer"]))
                mid["released"].append(torch.sum(buf["release"]))
                mid["rel_weight"].append(torch.sum(buf["relw"]))

            def mmax(a):
                return torch.max(torch.where(act, a, -float("inf")))
            n_kept_f = n_kept.float()
            lat = torch.where(
                n_active > 0, mmax(costs["tau_down"]) + mmax(costs["tau_comp"])
                + mmax(costs["tau_up"]) + self.agg_tau_pv * n_kept_f, 0.0)
            mid["arms"].append(L["arms"])
            mid["reward"].append(L["reward"])
            mid["energy"].append(L["energy"])
            mid["keep"].append(eval_gate)
            mid["lat"].append(lat)
            mid["e_t"].append(torch.sum(L["energy"])
                              + self.agg_e_pv * n_kept_f)
            mid["rank_sum"].append(torch.sum(torch.where(act, L["ranks"],
                                                         0)))
            mid["n_active"].append(n_active)
            mid["n_kept"].append(n_kept)
            mid["fb"].append(L["fb"])
            mid["comm"].append(torch.sum(torch.where(
                contribute, self.payload_i[L["arm_c"]], 0)))
            mid["dep"].append(torch.sum(L["dep"]))
            mid["hoff"].append(torch.sum(L["hoff"]))
            mid["has_m"].append(has_m)
            if self.check:
                mid["dist"].append(L["dist"])
                mid["new"].append(new_ads)
                mid["ranks"].append(L["ranks"])
        return mid

    def _finish(self, t: int, keep: torch.Tensor, agg_in: Tuple,
                any_rel: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Task t's aggregate into the carry's merged delta and has_merged.
        agg_in: on the trivial tier (the normalised merge, its total
        weight, the release sums or None), under a tier (the normalised
        segment partials, their (K,) weights, the segment release sums or
        None). Returns (has_merged, the global eval's gate)."""
        c = self.carry
        if self.tier.trivial:
            merged_new, wsum, rel = agg_in
            if rel is not None:
                # a round without releases keeps the plain merge
                merged_new = _where_tree(any_rel, agg.combine_with_released(
                    merged_new, wsum, *rel), merged_new)
            merged_out = _where_tree(keep, merged_new, c["merged"][t])
            has_m = c["has_merged"][t] | keep
            eval_gate = keep
        else:
            merged_out, do_merge = self._tier_step(t, *agg_in)
            has_m = c["has_merged"][t] | do_merge
            # before its first sync a task has no global model to eval
            eval_gate = keep & has_m
        _copy_tree(c["merged"][t], merged_out)
        c["has_merged"][t].copy_(has_m)
        return has_m, eval_gate

    def _sync_gate(self, t: int) -> torch.Tensor:
        """Whether this round syncs task t's tier: the staged input, read
        on the device when the round runs."""
        return self.x["sync"][t] > 0

    def _tier_step(self, t: int, part_new: Any, seg_w: torch.Tensor,
                   rel: Optional[Tuple[Any, torch.Tensor]]
                   ) -> Tuple[Any, torch.Tensor]:
        """Task t's segment partials of this round's uploads (and the
        segment sums of its releases) into its RSU partials, the
        partials' refresh, age and weight, and in a sync round their merge
        into the global delta, which a round without live partials keeps.
        Updates the carry's partials in place; returns (the merged delta
        out, whether it merged)."""
        c, K, decay = self.carry, self.K, self.tier.staleness_decay
        if rel is not None:
            # a segment without releases keeps the plain segment merge
            rel_raw, rel_w = rel
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

    def _buffer_step(self, ctx: Any, t: int, act, dep, contribute, migrate
                     ) -> Dict[str, Any]:
        """semi_sync, before the aggregation: age task t's buffer (the
        lanes ``ctx`` holds), find the entries released this round (the
        lane back in coverage within max_delay) at their discounted
        weights, and the lanes whose upload defers (a departing
        contributor that does not migrate; none with max_delay 0, which is
        then sync bit for bit)."""
        c, part = ctx.carry, self.part
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
                "dest": (ctx.x["assoc"][t] if part.buffer_handoffs
                         else c["buf_dest"][t])}

    def _buffer_admit(self, ctx: Any, t: int, new_ads: Any,
                      buf: Dict[str, Any]) -> None:
        """semi_sync, after the aggregation: the deferred lanes' merged
        deltas enter task t's buffer at age 0, in-flight entries age,
        released and overdue ones empty (weight 0: an exact no-op in every
        release sum). In place, one target at a time."""
        c, defer, keep = ctx.carry, buf["defer"], buf["keep_buf"]
        for path in agg.tree_paths(new_ads):
            d = agg.tree_get(c["buf_delta"][t], path)["delta"]
            new = agg.merge_delta_lanes(agg.tree_get(new_ads, path),
                                        self.S0)
            torch.where(defer.reshape(-1, 1, 1), new, d, out=d)
        c["buf_w"][t].copy_(torch.where(defer, ctx.weights[t], torch.where(
            keep, c["buf_w"][t], 0.0)))
        c["buf_age"][t].copy_(torch.where(defer, 0.0, torch.where(
            keep, buf["age1"], 0.0)))
        c["buf_dest"][t].copy_(torch.where(defer, ctx.x["assoc"][t],
                                           torch.where(keep, c["buf_dest"][t],
                                                       -1)))

    def _tail(self, mid: Dict[str, Any]) -> None:
        """Segment 2, per task: global eval from the seed-0 SVD, the dual
        update; then the budget step and the record, all into static
        buffers."""
        c = self.carry
        budgets = c["budgets"].clone()
        rows, accs, states = [], [], []
        for t in range(self.T):
            acc = self._global_acc(t, mid["keep"][t])
            new, lam = self._dual_update(t, mid, budgets[t])
            states.append(new)
            accs.append(acc)
            rows.append(self._row(t, mid, acc, lam, budgets[t]))
        self._commit_dual(states)
        self._alloc_step(mid, accs)
        self.out.copy_(torch.cat(
            [torch.stack(rows).reshape(-1)]
            + [c[k].double().reshape(-1) for k in self.state_keys]))

    def _global_acc(self, t: int, keep: torch.Tensor) -> torch.Tensor:
        """Task t's global accuracy from the seed-0 SVD (0 where no
        upload was kept)."""
        gad = agg.factors_full(self.eval_svd[t], self.S0)
        with torch.no_grad():
            _, met = T.loss_fn(self.params, gad, self.model_cfg,
                               self.lora_max, self.eval_batches[t])
        return torch.where(keep, met["accuracy"], 0.0)

    def _dual_update(self, t: int, mid: Dict[str, Any], budget
                     ) -> Tuple[Any, torch.Tensor]:
        """Task t's UCB-DUAL update from its lanes' arms, rewards and
        energies: (the new state, λ)."""
        c = self.carry
        state = ucb_dual.UCBDualState(
            counts=c["counts"][t], reward_sum=c["reward_sum"][t],
            energy_sum=c["energy_sum"][t], lam=c["lam"][t],
            round=c["ucb_round"][t])
        new, info = ucb_dual.update(state, self.cfg.ucb, mid["arms"][t],
                                    mid["reward"][t], mid["energy"][t],
                                    budget)
        return new, info["lambda"]

    def _commit_dual(self, states: Sequence[Any]) -> None:
        c = self.carry
        for t, s in enumerate(states):
            for k in ("counts", "reward_sum", "energy_sum"):
                c[k][t].copy_(getattr(s, k))
            c["lam"][t].copy_(s.lam)
            c["ucb_round"][t].copy_(s.round)

    def _row(self, t: int, mid: Dict[str, Any], acc, lam, budget
             ) -> torch.Tensor:
        """Task t's record row (float64, in ``rec_keys`` order)."""
        fb = mid["fb"][t]
        return torch.stack([v.double().reshape(()) for v in (
            acc, mid["lat"][t], mid["e_t"][t], lam,
            mid["rank_sum"][t], mid["n_active"][t], mid["dep"][t],
            mid["hoff"][t], fb[0], fb[1], fb[2], mid["comm"][t],
            mid["n_kept"][t], mid["has_m"][t], budget)
            + tuple(mid[k][t] for k in SEMI_REC if mid[k])])

    def _alloc_step(self, mid: Dict[str, Any], accs: Sequence[Any]) -> None:
        """Algorithm 1's budget step on the carry's allocator."""
        c = self.carry
        if self.spec.energy_scheduler:
            alloc = energy_alloc.step_scan(
                energy_alloc.AllocState(budgets=c["budgets"],
                                        difficulty=c["difficulty"],
                                        round=c["alloc_round"]),
                self.cfg.energy, torch.stack(mid["e_t"]), torch.stack(accs))
            c["budgets"].copy_(alloc.budgets)
            c["difficulty"].copy_(alloc.difficulty)
            c["alloc_round"].copy_(alloc.round)
        else:   # the budgets stay; only the allocator's round advances
            c["alloc_round"].add_(1)

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
        packed, lanes_r = [], []
        for r in range(rounds):
            x, lanes = self._stage_round(allow, self._round + r)
            lanes_r.append(lanes)
            packed.append(self._flat(self._pack(x)))
        inputs = self._inputs()
        with torch.no_grad():
            staged = [torch.from_numpy(np.stack([p[i] for p in packed]))
                      .to(buf.device) for i, buf in enumerate(inputs)]
            outs = torch.empty((rounds,) + self.out.shape,
                               dtype=self.out.dtype, device=self.device)
        for r in range(rounds):
            with torch.no_grad():
                for buf, all_r in zip(inputs, staged):
                    buf.copy_(all_r[r])
                self._put_fresh(self._draw_fresh(lanes_r[r]))
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
        sim = self.sim
        st = self._fetched_state(host)
        sim.ucb_states = [ucb_dual.UCBDualState(
            counts=st["counts"][t], reward_sum=st["reward_sum"][t],
            energy_sum=st["energy_sum"][t], lam=st["lam"][t],
            round=st["ucb_round"][t]) for t in range(self.T)]
        self._sync_servers(st)

    def _fetched_state(self, host: np.ndarray) -> Dict[str, torch.Tensor]:
        """The carry's ``state_keys`` from the fetched record vector, as
        f32 tensors on the CPU."""
        st, o = {}, self.T * len(self.rec_keys)
        for k in self.state_keys:
            n = int(np.prod(self.carry[k].shape))
            st[k] = torch.from_numpy(host[o:o + n].astype(np.float32)
                                     ).reshape(self.carry[k].shape)
            o += n
        return st

    def _sync_servers(self, st: Dict[str, torch.Tensor]) -> None:
        """The allocator, and each server's merged delta (a copy on the
        device), round, partials and buffer."""
        sim, c = self.sim, self.carry
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
                self._sync_buffer(t)

    def _sync_buffer(self, t: int) -> None:
        c = self.carry
        self.sim.servers[t].load_buffer(
            c["buf_delta"][t], c["buf_w"][t].cpu().numpy(),
            c["buf_age"][t].cpu().numpy(), c["buf_dest"][t].cpu().numpy())

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


class _Shard:
    """One shard of the sharded fleet: its device and lanes (slots of the
    padded fleet); after allocation its static lane inputs (``x``), the
    lanes' carry with replicas of the global state they read (``lam``,
    ``ucb_round``, ``has_merged``, ``dist_svd``), its tables, and the
    partial sums it writes each round (``part``)."""

    def __init__(self, index: int, device: torch.device, lanes: range):
        self.index, self.device, self.lanes = index, device, lanes
        self.n_lanes = len(lanes)
        self.graph = None


class ShardedRoundEngine(FusedRoundEngine):
    """The fused round over a fleet mesh of N > 1 shards, driven from one
    process (module docstring). Built by :class:`FusedRoundEngine` when
    the topology has more than one shard. ``shards`` holds each shard's
    buffers; ``segments`` counts the N lane graphs and the home device's
    two."""

    def __init__(self, sim, check: bool = False, sharded: bool = False, *,
                 capture: Optional[bool] = None, devices=None):
        super().__init__(sim, check, sharded, capture=capture,
                         devices=devices)
        self.segments = self.n_shards + 2

    # ------------------------------------------------------------------
    # Static buffers
    # ------------------------------------------------------------------
    def _alloc_buffers(self) -> None:
        sim, nt, dev = self.sim, self.T, self.device
        if len({d.type for d in self.mesh.devices}) > 1:
            raise ValueError("a fleet mesh's devices are all cards or all "
                             f"CPUs, not {list(map(str, self.mesh.devices))}")
        self.state_keys = HOME_STATE
        tmpl, zero_merged, zero_svd = self._templates()
        # the host stages at V lanes in vehicle order (_stage_round)
        self._int_layout, self._f32_layout = self._lane_layout(self.V)
        # home: the sync gates and the sketches; the global carry; both
        # SVDs; the record
        home = ([("sync", (nt,))], [])
        self.int_in = torch.zeros(nt, dtype=torch.int64, device=dev)
        self.f32_in = torch.zeros(sum(d2 * r for _, d2, r in
                                      self.omega_shapes),
                                  dtype=torch.float32, device=dev)
        self.x = self._views(self.int_in, self.f32_in, home)
        self.omega0 = tree_map(lambda t: t.to(dev), agg.draw_omegas(
            zero_merged, self.Rmax, 0, sim.servers[0].draw_omega))
        self.carry = self._global_carry(zero_merged)
        self.dist_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        self.eval_svd = [tree_map(torch.clone, zero_svd) for _ in range(nt)]
        self._alloc_out()
        self.params = tree_map(lambda p: p.to(dev), sim.params)
        # the lane tables in slot order; a padding lane copies lane 0's
        # profile (finite; no padding lane is ever active) and weighs 0
        tables = {k: self._to_slots(getattr(self, k).cpu().numpy()[None],
                                    None)[0]
                  for k in ("freq", "comp_power", "dev_tx", "flops_ps")}
        weights = self._to_slots(self.weights.cpu().numpy(), 0.0)
        params_on: Dict[str, Any] = {}
        self.shards = []
        for i, lanes in enumerate(fleet_lanes(
                self.mesh, self.Vp, axis_name=self.cfg.shard.axis_name)):
            d = self.mesh.devices[i]
            sh = _Shard(i, d, lanes)
            sl = slice(lanes.start, lanes.stop)
            for k, a in tables.items():
                setattr(sh, k, torch.from_numpy(a[sl].copy()).to(d))
            sh.weights = torch.from_numpy(weights[:, sl].copy()).to(d)
            for k in ("cand", "payload_i", "payload_f", "g_arm", "ns"):
                setattr(sh, k, getattr(self, k).to(d))
            sh.local_eval = [{k: v.to(d) for k, v in b.items()}
                             for b in self.local_eval]
            if str(d) not in params_on:
                params_on[str(d)] = tree_map(lambda p: p.to(d), sim.params)
            sh.params = params_on[str(d)]
            sh.layouts = self._lane_layout(sh.n_lanes)
            n_int = sum(int(np.prod(a)) for _, a in sh.layouts[0])
            n_f32 = sum(int(np.prod(a)) for _, a in sh.layouts[1])
            sh.int_in = torch.zeros(n_int, dtype=torch.int64, device=d)
            sh.f32_in = torch.zeros(n_f32, dtype=torch.float32, device=d)
            sh.x = self._views(sh.int_in, sh.f32_in, sh.layouts, omega=False)
            sh.fresh = self._fleet_trees(tmpl, sh.n_lanes, d)
            sh.carry = self._lane_carry(sh.n_lanes, zero_merged, d)
            sh.carry.update(
                lam=torch.zeros(nt, dtype=torch.float32, device=d),
                ucb_round=torch.zeros(nt, dtype=torch.float32, device=d),
                has_merged=torch.zeros(nt, dtype=torch.bool, device=d))
            sh.dist_svd = [tree_map(lambda z: torch.zeros_like(z, device=d),
                                    zero_svd) for _ in range(nt)]
            sh.part = self._partials_like(zero_merged, d)
            self.shards.append(sh)
        self.Vs = self.shards[0].n_lanes
        # each shard's partial sums as the home device receives them
        self.stage = [self._partials_like(zero_merged, dev)
                      for _ in self.shards]

    def _partials_like(self, zero_merged: Any, dev) -> Dict[str, Any]:
        """Static buffers of one shard's partial sums per task: the exact
        integer counts, the f32 sums and maxima (``PART_F32``, then a
        tier's (K,) segment weights and release weights), the raw
        merged-delta sum (a tier: per segment) and semi_sync's raw release
        sum."""
        nt, K = self.T, self.K
        lead = () if self.tier.trivial else (K,)

        def trees():
            return [tree_map(lambda z: torch.zeros(
                z.shape[:-2] + lead + z.shape[-2:], dtype=torch.float32,
                device=dev), zero_merged) for _ in range(nt)]
        return {"ints": torch.zeros((nt, len(PART_INT)), dtype=torch.int64,
                                    device=dev),
                "flts": torch.zeros((nt, len(PART_F32) + 2 * K),
                                    dtype=torch.float32, device=dev),
                "raw": trees(),
                "rel": None if self.part.trivial else trees()}

    def _to_slots(self, a: np.ndarray, fill) -> np.ndarray:
        """(T, V, ...) in vehicle order → (T, Vp, ...) in slot order; the
        padding lanes hold ``fill`` (None: lane 0's value)."""
        out = np.empty((a.shape[0], self.Vp) + a.shape[2:], a.dtype)
        out[...] = a[:, :1] if fill is None else fill
        out[:, self.slot] = a
        return out

    def _vehicle_order(self, a: torch.Tensor, axis: int) -> torch.Tensor:
        """Slot order → vehicle order along ``axis`` (``a[slot[v]]`` is
        vehicle v's lane)."""
        return a.index_select(axis, torch.as_tensor(self.slot,
                                                    device=a.device))

    def _shard_of(self, v: int) -> Tuple[_Shard, int]:
        """Vehicle v's shard and its lane there."""
        slot = int(self.slot[v])
        return self.shards[slot // self.Vs], slot % self.Vs

    # ------------------------------------------------------------------
    # Carry
    # ------------------------------------------------------------------
    def _adopt_ucb(self) -> None:
        c = self.carry
        for t, st in enumerate(self.sim.ucb_states):
            c["lam"][t].copy_(st.lam)
            c["ucb_round"][t].copy_(st.round)
            for k in ("counts", "reward_sum", "energy_sum"):
                full = self._to_slots(getattr(st, k).cpu().numpy()[None],
                                      0.0)[0]
                for sh in self.shards:
                    sh.carry[k][t].copy_(torch.from_numpy(
                        full[sh.lanes.start:sh.lanes.stop]))

    def _adopt_buffer(self, t: int, srv) -> None:
        for sh in self.shards:
            for d in leaves(sh.carry["buf_delta"][t]):
                d.zero_()
        w = np.zeros(self.Vp, np.float32)
        age = np.zeros(self.Vp, np.float32)
        dest = np.full(self.Vp, -1, np.int64)
        for v, ent in srv.buffer.items():
            sh, lane = self._shard_of(v)
            tree_map(lambda d, x: d.select(LANE_AXIS, lane).copy_(x),
                     sh.carry["buf_delta"][t], ent["delta"])
            slot = int(self.slot[v])
            w[slot], age[slot], dest[slot] = ent["w"], ent["age"], \
                ent["dest"]
        for sh in self.shards:
            sl = slice(sh.lanes.start, sh.lanes.stop)
            sh.carry["buf_w"][t].copy_(torch.from_numpy(w[sl]))
            sh.carry["buf_age"][t].copy_(torch.from_numpy(age[sl]))
            sh.carry["buf_dest"][t].copy_(torch.from_numpy(dest[sl]))

    # ------------------------------------------------------------------
    # Inputs: the home device's vectors, then each shard's
    # ------------------------------------------------------------------
    def _pack(self, x: Dict[str, Any]) -> Tuple[List, List]:
        """One round's staged arrays as (int64 vectors, f32 vectors): the
        home device's (the sync gates; the sketches), then each shard's
        (its lanes of every lane input, in slot order; the per-task
        inputs whole)."""
        om = [agg.tree_get(x["omega"], p)["omega"].reshape(-1).cpu()
              .numpy() for p, _, _ in self.omega_shapes]
        ints = [x["sync"].reshape(-1)]
        f32s = [np.concatenate(om).astype(np.float32)]
        int_layout, f32_layout = self.shards[0].layouts
        slotted = {k: x[k] if k in PER_TASK else
                   self._to_slots(x[k], -1 if k == "assoc" else 0)
                   for k, _ in int_layout + f32_layout}
        for sh in self.shards:
            sl = slice(sh.lanes.start, sh.lanes.stop)
            ints.append(np.concatenate([
                (slotted[k] if k in PER_TASK else slotted[k][:, sl])
                .reshape(-1) for k, _ in int_layout]))
            f32s.append(np.concatenate([slotted[k][:, sl].reshape(-1)
                                        for k, _ in f32_layout]))
        return ints, f32s

    def _inputs(self) -> List[torch.Tensor]:
        out = [self.int_in, self.f32_in]
        for sh in self.shards:
            out += [sh.int_in, sh.f32_in]
        return out

    def _flat(self, packed: Tuple[List, List]) -> List[np.ndarray]:
        return [a for pair in zip(*packed) for a in pair]

    def _upload(self, ints: List, f32s: List, fresh: Sequence[Any]
                ) -> None:
        with torch.no_grad():
            for buf, a in zip(self._inputs(), self._flat((ints, f32s))):
                buf.copy_(torch.from_numpy(a))
            self._put_fresh(fresh)

    def _put_fresh(self, fresh: Sequence[Any]) -> None:
        """Each shard's share of the fresh draws, at its lanes."""
        for t, f in enumerate(fresh):
            if f is None:
                continue
            ids, draws = f
            slots = self.slot[np.asarray(ids)]
            for sh in self.shards:
                sel = np.flatnonzero((slots >= sh.lanes.start)
                                     & (slots < sh.lanes.stop))
                if not len(sel):
                    continue
                part = tree_map(lambda d: d.index_select(
                    LANE_AXIS, torch.as_tensor(sel, device=d.device)
                ).to(sh.device), draws)
                _scatter_lanes(sh.fresh[t], slots[sel] - sh.lanes.start,
                               part)

    # ------------------------------------------------------------------
    # The round program
    # ------------------------------------------------------------------
    def _broadcast(self) -> None:
        """Copy the global state the lanes read (λ, the UCB round,
        has_merged, the distribution's SVD) from the home device to every
        shard."""
        c = self.carry
        with torch.no_grad():
            for sh in self.shards:
                for k in ("lam", "ucb_round", "has_merged"):
                    sh.carry[k].copy_(c[k])
                for t in range(self.T):
                    _copy_tree(sh.dist_svd[t], self.dist_svd[t])

    def _shard_main(self, sh: _Shard) -> None:
        """A shard's lane segment, per task: its lanes' work
        (:meth:`_lanes`), their partial sums into the shard's static
        buffers, semi_sync's release sums and admit, and the per-vehicle
        UCB-DUAL statistics (λ steps on the home device)."""
        p, K = sh.part, self.K
        zf = torch.zeros(K, dtype=torch.float32, device=sh.device)
        zi = torch.zeros((), dtype=torch.int64, device=sh.device)
        for t in range(self.T):
            L = self._lanes(sh, t)
            act, contribute, w, buf = (L["act"], L["contribute"], L["w"],
                                       L["buf"])
            costs, new_ads = L["costs"], L["new_ads"]

            def mmax(a):
                return torch.max(torch.where(act, a, -float("inf")))
            fb = L["fb"]
            ints = [torch.sum(act), torch.sum(contribute),
                    torch.sum(L["dep"]), torch.sum(L["hoff"]),
                    fb[0], fb[1], fb[2],
                    torch.sum(torch.where(act, L["ranks"], 0)),
                    torch.sum(torch.where(contribute,
                                          sh.payload_i[L["arm_c"]], 0)),
                    zi if buf is None else torch.sum(buf["defer"]),
                    zi if buf is None else torch.sum(buf["release"])]
            flts = [torch.sum(L["energy"]), torch.sum(w),
                    zi.float() if buf is None else torch.sum(buf["relw"]),
                    mmax(costs["tau_down"]), mmax(costs["tau_comp"]),
                    mmax(costs["tau_up"])]
            if self.tier.trivial:
                raw, _ = agg.merged_padded_sums(new_ads, w, self.S0)
                seg_w = zf
            else:
                raw, seg_w = agg.merged_segment_sums(
                    new_ads, w, torch.where(contribute, sh.x["assoc"][t],
                                            -1), K, self.S0)
            rel_w = zf
            if buf is not None:
                # the releases read the buffer before the admit writes it
                if self.tier.trivial:
                    rel, _ = agg.buffer_release_sum(sh.carry["buf_delta"][t],
                                                    buf["relw"])
                else:
                    rel, rel_w = agg.segment_buffer_release(
                        sh.carry["buf_delta"][t], buf["relw"],
                        torch.where(buf["release"], buf["dest"], -1), K)
                _copy_tree(p["rel"][t], rel)
                self._buffer_admit(sh, t, new_ads, buf)
            p["ints"][t].copy_(torch.stack([v.to(torch.int64).reshape(())
                                            for v in ints]))
            p["flts"][t].copy_(torch.cat([torch.stack(
                [v.float().reshape(()) for v in flts]), seg_w, rel_w]))
            _copy_tree(p["raw"][t], raw)
            counts, rsum, esum = ucb_dual.record(L["state"], L["arms"],
                                                 L["reward"], L["energy"])
            sh.carry["counts"][t].copy_(counts)
            sh.carry["reward_sum"][t].copy_(rsum)
            sh.carry["energy_sum"][t].copy_(esum)

    def _gather(self) -> None:
        """Copy every shard's partial sums to the home device."""
        with torch.no_grad():
            for sh, st in zip(self.shards, self.stage):
                _copy_tree(st, sh.part)

    def _home_main(self) -> Dict[str, Any]:
        """The home segment after the lanes, per task: the shards' partial
        sums added in shard order, the aggregation into the carry
        (:meth:`_finish`), and what segment 2 reads."""
        mid: Dict[str, Any] = {k: [] for k in (
            "keep", "lat", "e_t", "e_sum", "rank_sum", "n_active",
            "n_kept", "fb", "comm", "dep", "hoff", "has_m") + SEMI_REC}
        nf, K = len(PART_F32), self.K
        for t in range(self.T):
            n = dict(zip(PART_INT, agg.add_partials(
                [st["ints"][t] for st in self.stage])))
            flts = [st["flts"][t] for st in self.stage]
            f = agg.add_partials(flts)
            mx = torch.max(torch.stack([v[3:6] for v in flts]), dim=0).values
            e_sum, wsum, relw = f[0], f[1], f[2]
            n_active, n_kept = n["n_active"], n["n_kept"]
            if self.part.trivial:
                keep = n_kept > 0
            else:
                keep = (wsum > 0) | (relw > 0.0)
            raw = agg.add_partials([st["raw"][t] for st in self.stage])
            rel = None
            if self.tier.trivial:
                if not self.part.trivial:
                    rel = (agg.add_partials([st["rel"][t]
                                             for st in self.stage]), relw)
                agg_in = (agg.normalise(raw, wsum), wsum, rel)
            else:
                seg_w = f[nf:nf + K]
                if not self.part.trivial:
                    rel = (agg.add_partials([st["rel"][t]
                                             for st in self.stage]),
                           f[nf + K:])
                agg_in = (agg.normalise(raw, seg_w), seg_w, rel)
            has_m, eval_gate = self._finish(
                t, keep, agg_in, None if self.part.trivial else relw > 0.0)
            n_kept_f = n_kept.float()
            mid["keep"].append(eval_gate)
            mid["lat"].append(torch.where(
                n_active > 0, mx[0] + mx[1] + mx[2]
                + self.agg_tau_pv * n_kept_f, 0.0))
            mid["e_t"].append(e_sum + self.agg_e_pv * n_kept_f)
            mid["e_sum"].append(e_sum)
            for k in ("rank_sum", "n_active", "n_kept", "comm", "dep",
                      "hoff"):
                mid[k].append(n[k])
            mid["fb"].append(torch.stack([n["fb0"], n["fb1"], n["fb2"]]))
            mid["has_m"].append(has_m)
            if not self.part.trivial:
                mid["deferred"].append(n["deferred"])
                mid["released"].append(n["released"])
                mid["rel_weight"].append(relw)
        return mid

    def _dual_update(self, t: int, mid: Dict[str, Any], budget
                     ) -> Tuple[Any, torch.Tensor]:
        """λ's step from the fleet's total energy (the shards recorded
        the per-vehicle statistics)."""
        lam, _ = ucb_dual.dual_step(self.cfg.ucb, self.carry["lam"][t],
                                    mid["e_sum"][t], budget)
        return lam, lam

    def _commit_dual(self, lams: Sequence[Any]) -> None:
        c = self.carry
        for t, lam in enumerate(lams):
            c["lam"][t].copy_(lam)
            c["ucb_round"][t].add_(1.0)

    def _phases(self) -> None:
        """The round in order, eagerly."""
        with _on(self.device):
            self._dist_svd()
            self._broadcast()
        for sh in self.shards:
            with _on(sh.device):
                self._shard_main(sh)
        with _on(self.device):
            self._gather()
            self._mid = self._home_main()
            self._eval_svd()
            self._tail(self._mid)

    def _warm_up(self) -> None:
        """The first round, eagerly on a side stream of every card."""
        devs = list(dict.fromkeys(self.mesh.devices))
        sides = [torch.cuda.Stream(d) for d in devs]
        for d, side in zip(devs, sides):
            side.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            for side in sides:
                stack.enter_context(torch.cuda.stream(side))
            self._phases()
        for d, side in zip(devs, sides):
            torch.cuda.current_stream(d).wait_stream(side)

    def _capture(self) -> None:
        """Capture each shard's lane segment on its own device, each into
        its own memory pool (two shards on one card keep apart), and the
        home device's two segments into one more pool; the collector held
        off as in :meth:`FusedRoundEngine._capture`."""
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for sh in self.shards:
                with _on(sh.device):
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(
                            g, stream=torch.cuda.Stream(sh.device)):
                        self._shard_main(sh)
                    sh.graph = g
            with _on(self.device):
                side = torch.cuda.Stream(self.device)
                h1 = torch.cuda.CUDAGraph()
                with torch.cuda.graph(h1, stream=side):
                    mid = self._home_main()
                h2 = torch.cuda.CUDAGraph()
                with torch.cuda.graph(h2, pool=h1.pool(), stream=side):
                    self._tail(mid)
        finally:
            if collecting:
                gc.enable()
        self._graph_mid = mid
        self._graphs = (h1, h2)
        self.captures += 1

    def _execute(self) -> None:
        if not self.capture:
            self._phases()
            return
        if self._graphs is None:
            self._warm_up()
            self._capture()
            return
        h1, h2 = self._graphs
        with _on(self.device):
            self._dist_svd()
            self._broadcast()
        for sh in self.shards:
            with _on(sh.device):
                sh.graph.replay()
        with _on(self.device):
            self._gather()
            h1.replay()
            self._eval_svd()
            h2.replay()
        self._mid = self._graph_mid

    # ------------------------------------------------------------------
    def _sync_sim(self, host: np.ndarray) -> None:
        """Mirror the carry onto the simulator in vehicle order: the
        shards' per-vehicle statistics un-permuted from slot order, λ and
        the rounds from the fetched vector, then the servers."""
        st = self._fetched_state(host)
        lanes = {k: self._vehicle_order(torch.cat(
            [sh.carry[k].cpu() for sh in self.shards], dim=1), 1)
            for k in ("counts", "reward_sum", "energy_sum")}
        self.sim.ucb_states = [ucb_dual.UCBDualState(
            counts=lanes["counts"][t], reward_sum=lanes["reward_sum"][t],
            energy_sum=lanes["energy_sum"][t], lam=st["lam"][t],
            round=st["ucb_round"][t]) for t in range(self.T)]
        self._sync_servers(st)

    def _sync_buffer(self, t: int) -> None:
        """Task t's in-flight buffer, by vehicle, from the shards (each
        entry a copy, as ``RSUServer.load_buffer`` makes)."""
        def whole(k):
            return self._vehicle_order(torch.cat(
                [sh.carry[k][t].cpu() for sh in self.shards]), 0).numpy()
        w, age, dest = whole("buf_w"), whole("buf_age"), whole("buf_dest")
        buffer = {}
        for v in np.flatnonzero(w > 0.0):
            sh, lane = self._shard_of(int(v))
            buffer[int(v)] = {
                "delta": tree_map(lambda x: x.select(LANE_AXIS, lane)
                                  .clone(), sh.carry["buf_delta"][t]),
                "w": float(w[v]), "age": int(age[v]), "dest": int(dest[v])}
        self.sim.servers[t].buffer = buffer


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
