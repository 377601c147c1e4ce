"""Resumable runs: the complete simulator state, port of
``repro/checkpoint/carry.py``.

Every engine leaves the :class:`~repro_torch.sim.simulator.IoVSimulator`
at a round boundary with its whole state on the host objects: the fused
engine mirrors its carry back after every round or scan
(``FusedRoundEngine._sync_sim``: UCB-DUAL statistics, merged deltas, the
tier's partials and ages, the semi-sync buffer, the allocator and the
round counter). That mirror plus every host RNG cursor the staging
consumes is the resumable state, so a checkpoint taken at a round
boundary restores into a fresh simulator built from the same config (or
into a live one) and continues bit for bit:

  * tensor state (UCB, merged, partials, buffer, alloc) round-trips
    through f32 npz entries exactly;
  * the host RNG streams (mobility, channel fades, data shuffles, the
    simulator's own) ride as numpy ``bit_generator.state`` dicts, and
    each server's fresh-draw generator as its state bytes
    (:meth:`~repro_torch.federated.server.RSUServer.key_state`), so the
    staging after a restore consumes the same draws in the same order;
  * the restored state goes to ``sim.device`` and a fused engine
    re-adopts it into its static buffers by copy (``reset_carry`` →
    ``_init_carry``), so captured graphs replay it, and a checkpoint
    moves between engines and between the card and the CPU.

The file is the reference's: ``round_{N:06d}.npz`` with the same tree
and a ``meta`` blob of the same keys (version 2, fingerprint, round,
history, rng), so a checkpoint the reference wrote restores here (its
servers' ``jax.random`` keys re-seed the port's generators, see
``RSUServer.load_key``). :func:`config_fingerprint` hashes the canonical
SimConfig minus ``engine``, ``shard``, ``checkpoint`` and ``rounds``,
the knobs a resume may change, and equals the reference's digest for
equal configs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (prune_checkpoints, restore_round,
                                       save_round)
from repro_torch.core.energy_alloc import AllocState
from repro_torch.core.ucb_dual import UCBDualState
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T

# v2: the per-server semi-synchronous participation buffer. v1 files
# predate it and cannot express in-flight uploads: rejected on restore.
_VERSION = 2
# the knobs a resume may change: execution topology and the checkpoint
# policy never alter the simulated trajectory, and `rounds` is only the
# default horizon length
_FINGERPRINT_EXEMPT = ("engine", "shard", "checkpoint", "rounds")


def config_fingerprint(cfg) -> str:
    """sha256 over the canonical SimConfig dict, minus execution-topology
    fields (engine, shard, checkpoint) and the horizon length (rounds).
    Two configs with equal fingerprints stage identical RNG streams and
    run identical round programs."""
    d = dataclasses.asdict(cfg)
    for k in _FINGERPRINT_EXEMPT:
        d.pop(k, None)
    blob = json.dumps(d, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def _gen_state(rng: np.random.Generator) -> Dict[str, Any]:
    return rng.bit_generator.state


def _in_order(tree, like):
    """``tree`` with its dicts' keys in the order of ``like``'s (keys
    ``like`` lacks last). A file stores dict keys sorted; the port builds
    its trees in the model's order, which code that walks two trees'
    leaves side by side relies on."""
    if isinstance(tree, dict):
        like = like if isinstance(like, dict) else {}
        keys = [k for k in like if k in tree]
        keys += [k for k in tree if k not in like]
        return {k: _in_order(tree[k], like.get(k)) for k in keys}
    if isinstance(tree, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) and like else [None]
        return type(tree)(_in_order(v, like[min(i, len(like) - 1)])
                          for i, v in enumerate(tree))
    return tree


def _on(tree, device, like):
    """A loaded tree (numpy leaves) as f32 tensors on ``device``, in the
    key order of ``like``."""
    return None if tree is None else tree_map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device),
        _in_order(tree, like))


def _buffer_state(srv) -> Dict[str, Any]:
    """The server's semi-sync in-flight buffer: vehicle ids in sorted
    order, parallel weight / age / destination arrays and the stacked
    delta trees (stacked on the host, one lane at a time, so no second
    copy is made on a card). An empty buffer (every sync run) writes the
    empty arrays and no delta tree."""
    lanes = sorted(srv.buffer)
    out: Dict[str, Any] = {
        "lanes": np.asarray(lanes, np.int64),
        "w": np.asarray([srv.buffer[v]["w"] for v in lanes], np.float64),
        "age": np.asarray([srv.buffer[v]["age"] for v in lanes], np.int64),
        "dest": np.asarray([srv.buffer[v]["dest"] for v in lanes],
                           np.int64),
        "delta": None,
    }
    if lanes:
        def stack(*xs):
            st = np.empty((len(xs),) + tuple(xs[0].shape), np.float32)
            for i, x in enumerate(xs):
                st[i] = x.detach().cpu().float().numpy()
            return st
        out["delta"] = tree_map(stack, *[srv.buffer[v]["delta"]
                                         for v in lanes])
    return out


def _restore_buffer(srv, bd: Dict[str, Any], device, like) -> None:
    srv.buffer = {}
    for i, v in enumerate(np.asarray(bd["lanes"], np.int64)):
        srv.buffer[int(v)] = {
            "delta": _on(tree_map(lambda x: x[i], bd["delta"]), device,
                         like),
            "w": float(bd["w"][i]),
            "age": int(bd["age"][i]),
            "dest": int(bd["dest"][i]),
        }


def host_state(sim) -> Dict[str, Any]:
    """The complete resumable state of `sim` as one checkpointable tree.

    Array state rides as npz leaves (tensors on a card are read one leaf
    at a time when the file is written); JSON-only state (history, the
    numpy generators' states, the config fingerprint) rides as a
    uint8-encoded ``meta`` leaf in the same file. Call it at a round
    boundary (``run``/``run_round``/``run_scanned`` leave the simulator
    there)."""
    m = sim.mobility
    tasks = sorted(m._assoc_log)
    V = sim.cfg.num_vehicles
    meta = {
        "version": _VERSION,
        "fingerprint": config_fingerprint(sim.cfg),
        "round": len(sim.history),
        "history": sim.history,
        "rng": {
            "sim": _gen_state(sim.rng),
            "mobility": _gen_state(m._rng),
            "channel": _gen_state(sim.channel._rng),
            "data": [[_gen_state(ds._rng) for ds in task]
                     for task in sim.client_data],
        },
    }
    return {
        "ucb": [dict(s._asdict()) for s in sim.ucb_states],
        "alloc": {"budgets": sim.alloc.budgets,
                  "difficulty": sim.alloc.difficulty,
                  "round": np.int64(sim.alloc.round)},
        "servers": [{
            "key": srv.key_state(),
            "round": np.int64(srv.round),
            "merged": srv.merged,
            "global_adapters": srv.global_adapters,
            "partials": srv.partials,
            "partial_w": np.asarray(srv.partial_w),
            "partial_age": np.asarray(srv.partial_age),
            "buffer": _buffer_state(srv),
        } for srv in sim.servers],
        "mobility": {
            "tick": np.int64(m.tick),
            "pos": np.asarray(m.pos, np.float64),
            "vel": np.asarray(m.vel, np.float64),
            "present": np.asarray(m.present, bool),
            "assoc_tasks": np.asarray(tasks, np.int64),
            "assoc_tick": np.asarray(
                [m._assoc_log[t]["tick"] for t in tasks], np.int64),
            "assoc_prev": (np.stack(
                [np.asarray(m._assoc_log[t]["prev"], np.int64)
                 for t in tasks]) if tasks
                else np.zeros((0, V), np.int64)),
            "assoc_cur": (np.stack(
                [np.asarray(m._assoc_log[t]["cur"], np.int64)
                 for t in tasks]) if tasks
                else np.zeros((0, V), np.int64)),
        },
        "data": [[{"order": np.asarray(ds._order, np.int64),
                   "pos": np.int64(ds._pos)} for ds in task]
                 for task in sim.client_data],
        "meta": np.frombuffer(json.dumps(meta).encode(), np.uint8).copy(),
    }


def save_checkpoint(sim, ckpt_dir: Optional[str] = None,
                    keep_last: Optional[int] = None) -> str:
    """Write ``round_{len(history):06d}.npz`` (atomic) and prune to the
    newest ``keep_last`` files. Defaults come from ``sim.cfg.checkpoint``;
    an explicit ``ckpt_dir`` checkpoints without an enabled spec. Returns
    the written path."""
    spec = sim.cfg.checkpoint
    ckpt_dir = ckpt_dir if ckpt_dir is not None else spec.dir
    if not ckpt_dir:
        raise ValueError("save_checkpoint needs a ckpt_dir (or an enabled "
                         "SimConfig.checkpoint with one)")
    keep = spec.keep_last if keep_last is None else keep_last
    path = save_round(ckpt_dir, len(sim.history), host_state(sim))
    prune_checkpoints(ckpt_dir, keep)
    return path


def _fix_history(history: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Undo JSON's stringification of the per-task fallback-counter keys."""
    for rec in history:
        for trec in rec.get("tasks", ()):
            if "fallbacks" in trec:
                trec["fallbacks"] = {int(k): v for k, v in
                                     trec["fallbacks"].items()}
    return history


def restore_checkpoint(sim, ckpt_dir: Optional[str] = None,
                       round_idx: Optional[int] = None) -> int:
    """Load a checkpoint into `sim` (built from the same config, fresh or
    live) and leave it where the writer stood: the next round is the one
    an uninterrupted run would compute.

    round_idx=None restores the latest checkpoint in the directory. The
    version, the stored config fingerprint (engine/shard/checkpoint/rounds
    exempt) and the round against the file name are checked, in that
    order, before any state is touched. Returns the restored round."""
    spec = sim.cfg.checkpoint
    ckpt_dir = ckpt_dir if ckpt_dir is not None else spec.dir
    if not ckpt_dir:
        raise ValueError("restore_checkpoint needs a ckpt_dir (or an "
                         "enabled SimConfig.checkpoint with one)")
    round_idx, state = restore_round(ckpt_dir, round_idx, numpy=True)
    meta = json.loads(bytes(state["meta"]).decode())
    if meta.get("version") != _VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')!r} != supported "
            f"version {_VERSION} — v2 added the semi-synchronous "
            "participation buffer (ParticipationSpec); older checkpoints "
            "cannot express in-flight uploads and must be regenerated")
    want = config_fingerprint(sim.cfg)
    if meta["fingerprint"] != want:
        raise ValueError(
            "checkpoint was written by a DIFFERENT SimConfig "
            f"(fingerprint {meta['fingerprint'][:12]}… != {want[:12]}…); "
            "only engine/shard/checkpoint/rounds may change across a resume")
    if meta["round"] != round_idx:
        raise ValueError(f"checkpoint metadata claims round {meta['round']} "
                         f"but the file is round_{round_idx:06d}.npz")

    dev = sim.device
    # the model's own key order (adapters, merged deltas, partials)
    like = T.init_adapters(sim.model_cfg, sim.cfg.lora, rank=1,
                           device="cpu")
    sim.history = _fix_history(meta["history"])
    sim.ucb_states = [UCBDualState(**{
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in d.items()})
        for d in state["ucb"]]
    a = state["alloc"]
    sim.alloc = AllocState(
        budgets=torch.from_numpy(np.asarray(a["budgets"], np.float32)),
        difficulty=torch.from_numpy(np.asarray(a["difficulty"], np.float32)),
        round=int(a["round"]))
    for srv, sd in zip(sim.servers, state["servers"]):
        srv.load_key(sd["key"])
        srv.round = int(sd["round"])
        srv.merged = _on(sd["merged"], dev, like)
        srv.global_adapters = _on(sd["global_adapters"], dev, like)
        srv.partials = (None if sd["partials"] is None
                        else [_on(p, dev, like) for p in sd["partials"]])
        srv.partial_w = np.asarray(sd["partial_w"], np.float64).copy()
        srv.partial_age = np.asarray(sd["partial_age"], np.int64).copy()
        _restore_buffer(srv, sd["buffer"], dev, like)

    md = state["mobility"]
    m = sim.mobility
    m.tick = int(md["tick"])
    m.pos = np.asarray(md["pos"], np.float64)
    m.vel = np.asarray(md["vel"], np.float64)
    m.present = np.asarray(md["present"], bool)
    m._assoc_log = {
        int(t): {"tick": int(md["assoc_tick"][i]),
                 "prev": np.asarray(md["assoc_prev"][i], np.int64),
                 "cur": np.asarray(md["assoc_cur"][i], np.int64)}
        for i, t in enumerate(md["assoc_tasks"])}
    m._rng.bit_generator.state = meta["rng"]["mobility"]
    sim.channel._rng.bit_generator.state = meta["rng"]["channel"]
    sim.rng.bit_generator.state = meta["rng"]["sim"]
    for t, task in enumerate(sim.client_data):
        for v, ds in enumerate(task):
            dd = state["data"][t][v]
            ds._order = np.asarray(dd["order"], np.int64)
            ds._pos = int(dd["pos"])
            ds._rng.bit_generator.state = meta["rng"]["data"][t][v]

    if sim.fused is not None:
        # the next round copies the restored host state into the engine's
        # static buffers (_init_carry), which captured graphs read
        sim.fused.reset_carry()
    return round_idx
