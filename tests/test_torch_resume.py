"""Resumable runs in the port (``repro_torch.checkpoint.carry`` and the
simulator's checkpointing), on the CPU.

In the port: ``CheckpointSpec`` validation; the config fingerprint's
exemptions and its equality with the reference's digest; checkpoints
emitted by ``run`` and by the chunked ``run_scanned``; kill and resume
(an uninterrupted run against one stopped at a boundary and restored into
a fresh simulator, or into the live one) bit for bit — the history's
JSON and every leaf of the final checkpoint — under ``serial``,
``batched`` and ``fused`` (``run`` and chunked ``run_scanned``), on the
trivial tier and on a small map with a 3-RSU tier, semi_sync and two
outages; a mismatched config and a version-1 file raising before any
state changes; a fused checkpoint resumed under ``batched``.

Across the packages: the reference runs two rounds and writes its
checkpoint; the port restores that file (its re-save equals the file leaf
for leaf, but for each server's stream cursor ``servers/<t>/key``) and
runs round 2 with the reference's draws and SVDs injected, held to the
reference's round 2 at the one-round tolerances: ranks, active sets,
fallbacks and comm_params exact; energy and latency within 1e-5
relative; merged deltas within 1e-4 of each leaf's largest entry.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import config_fingerprint as jfingerprint
from repro.checkpoint import io as jio
from repro.config import CheckpointSpec as JCheckpointSpec
from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import vit_base_paper as jvit
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.checkpoint import (config_fingerprint, latest_checkpoint,
                                    load_pytree, restore_checkpoint,
                                    save_checkpoint, save_pytree)
from repro_torch.config import (CheckpointSpec, LoRAConfig, OutageSpec,
                                ParticipationSpec, RSUTierSpec, ShardSpec)
from repro_torch.configs import vit_base_paper
from repro_torch.core.aggregation import tree_get, tree_paths_delta
from repro_torch.sim.mobility_model import MobilitySimConfig
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_sim import (_np, _omega_ref, _recording, _server_draw,  # noqa: F401
                            one_torch_thread)
from test_torch_tier import reference_svds

TINY = dict(name="vit-test-resume", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
LORA = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
JLORA = JLoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
ROUNDS, INTERVAL = 4, 2


def _arch():
    return vit_base_paper.vit_base_paper().with_overrides(**TINY)


def _cfg(engine="fused", mode="trivial", ck=None, **over):
    kw = dict(method="ours", rounds=ROUNDS, num_vehicles=8, num_tasks=2,
              seed=3, local_steps=1, engine=engine, train_arch=_arch(),
              lora=LORA)
    if mode == "modes":
        # a 3-RSU tier syncing every 3 rounds, semi_sync, task 0's RSU dark
        # in round 1 and task 1's in round 2: at the round-2 boundary the
        # buffer holds three deferred uploads and three partials are live;
        # rounds 2-3 release them, sync and charge handoffs
        kw.update(num_vehicles=12, seed=3,
                  rsu_tier=RSUTierSpec(num_rsus_per_task=3, sync_period=3,
                                       staleness_decay=0.7,
                                       handoff_energy=6.0,
                                       handoff_latency=0.4),
                  participation=ParticipationSpec(mode="semi_sync"),
                  mobility_sim=MobilitySimConfig(outages=(
                      OutageSpec(0, 1, 2), OutageSpec(1, 2, 3))))
    if ck is not None:
        kw["checkpoint"] = ck
    kw.update(over)
    return SimConfig(**kw)


def _sim(*a, **kw):
    return IoVSimulator(_cfg(*a, **kw), device="cpu")


def _hist(sim):
    return json.dumps(sim.history, sort_keys=True)


def _ckpts(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz"))


def _leaves(tree, path="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _leaves(v, f"{path}/{i}", out)
    elif tree is not None:
        out[path] = np.asarray(tree)
    return out


def _same_checkpoints(a, b):
    la = _leaves(load_pytree(a, numpy=True))
    lb = _leaves(load_pytree(b, numpy=True))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


# ---------------------------------------------------------------------------
# Spec and fingerprint
# ---------------------------------------------------------------------------

def test_checkpoint_spec_validation(tmp_path):
    assert not CheckpointSpec().enabled
    assert CheckpointSpec(interval=5, dir=str(tmp_path), keep_last=2).enabled
    for bad in (dict(interval=-1), dict(interval=5, dir="d", keep_last=-2),
                dict(interval=5)):
        with pytest.raises(ValueError):
            CheckpointSpec(**bad)


def test_fingerprint_exempts_engine_shard_checkpoint_rounds():
    a = config_fingerprint(_cfg("fused"))
    assert a == config_fingerprint(_cfg("batched"))
    assert a == config_fingerprint(_cfg(
        "fused", ck=CheckpointSpec(interval=3, dir="x")))
    assert a == config_fingerprint(_cfg("fused", rounds=99))
    assert a == config_fingerprint(_cfg("fused", shard=ShardSpec(4)))
    assert a != config_fingerprint(_cfg("fused", lr=123.0))
    assert a != config_fingerprint(_cfg("fused", seed=4))


@pytest.mark.parametrize("arch", ["default", "vit-base-paper", "tiny"])
def test_fingerprint_equals_the_reference(arch):
    """Equal configs hash alike in both packages, a ``train_arch``
    included (the port's ModelConfig has all of the reference's fields)."""
    port = {"default": None, "vit-base-paper": vit_base_paper
            .vit_base_paper(), "tiny": _arch()}[arch]
    ref = {"default": None, "vit-base-paper": jvit.vit_base_paper(),
           "tiny": jvit.vit_base_paper().with_overrides(**TINY)}[arch]
    assert config_fingerprint(SimConfig(train_arch=port)) == \
        jfingerprint(JSimConfig(train_arch=ref))
    if arch == "default":
        assert config_fingerprint(SimConfig()).startswith("9668dce1fbb9")


@pytest.mark.parametrize("field, kw", [
    ("ssm", {}), ("shared_attn_every", 2),
    ("ssm", {"state_dim": 16, "head_dim": 32}), ("shared_attn_every", 6)])
def test_zamba2_fields_give_the_reference_config(field, kw):
    """zamba2's ``ssm`` and ``shared_attn_every`` build configs equal to
    the reference's, with equal checkpoint fingerprints."""
    from repro.config import SSMConfig as JSSMConfig
    from repro_torch.config import SSMConfig
    port, ref = ((SSMConfig(**kw), JSSMConfig(**kw)) if field == "ssm"
                 else (kw, kw))
    pc = vit_base_paper.vit_base_paper().with_overrides(**{field: port})
    jc = jvit.vit_base_paper().with_overrides(**{field: ref})
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert config_fingerprint(SimConfig(train_arch=pc)) == \
        jfingerprint(JSimConfig(train_arch=jc))


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def test_run_emits_interval_checkpoints(tmp_path):
    sim = _sim("batched", ck=CheckpointSpec(interval=2, dir=str(tmp_path)))
    sim.run(5)
    assert _ckpts(tmp_path) == ["round_000002.npz", "round_000004.npz"]


def test_run_scanned_checkpoints_every_chunk_and_prunes(tmp_path):
    ck = CheckpointSpec(interval=2, dir=str(tmp_path), keep_last=2)
    sim = _sim("fused", ck=ck)
    assert len(sim.run_scanned(5)) == 5
    # boundaries at 2, 4 and 5 (a short last chunk); round 2 pruned
    assert _ckpts(tmp_path) == ["round_000004.npz", "round_000005.npz"]


def test_chunked_scan_equals_the_unchunked_one(tmp_path):
    one = _sim("fused")
    one.run_scanned(ROUNDS)
    chunked = _sim("fused", ck=CheckpointSpec(interval=1, dir=str(tmp_path)))
    chunked.run_scanned(ROUNDS)
    assert _hist(one) == _hist(chunked)


def test_explicit_dir_without_a_spec(tmp_path):
    sim = _sim("batched")
    sim.run(2)
    path = save_checkpoint(sim, ckpt_dir=str(tmp_path))
    assert os.path.basename(path) == "round_000002.npz"
    res = _sim("batched")
    assert restore_checkpoint(res, str(tmp_path)) == 2
    assert _hist(res) == _hist(sim)
    with pytest.raises(ValueError, match="ckpt_dir"):
        save_checkpoint(res)
    with pytest.raises(ValueError, match="ckpt_dir"):
        restore_checkpoint(res)


# ---------------------------------------------------------------------------
# Kill and resume, bit for bit
# ---------------------------------------------------------------------------

def _go(sim, how, n):
    return (sim.run_scanned if how == "scanned" else sim.run)(n)


CASES = [(e, how, mode) for mode in ("trivial", "modes")
         for e, how in (("serial", "run"), ("batched", "run"),
                        ("fused", "run"), ("fused", "scanned"))]


@pytest.mark.parametrize("engine, how, mode", CASES,
                         ids=[f"{e}-{h}-{m}" for e, h, m in CASES])
def test_kill_and_resume_is_bit_identical(tmp_path, engine, how, mode):
    d_ref, d_vic = str(tmp_path / "ref"), str(tmp_path / "vic")
    ref = _sim(engine, mode, CheckpointSpec(interval=INTERVAL, dir=d_ref))
    _go(ref, how, ROUNDS)
    ck = CheckpointSpec(interval=INTERVAL, dir=d_vic)
    vic = _sim(engine, mode, ck)
    _go(vic, how, INTERVAL)          # stopped after the first boundary
    del vic
    res = _sim(engine, mode, ck)
    assert restore_checkpoint(res) == INTERVAL
    _go(res, how, ROUNDS - INTERVAL)
    assert len(res.history) == ROUNDS
    assert _hist(ref) == _hist(res)
    assert _ckpts(d_ref) == _ckpts(d_vic)
    _same_checkpoints(latest_checkpoint(d_ref), latest_checkpoint(d_vic))
    if mode == "modes":
        # what the boundary carried: a buffered upload and live partials
        st = load_pytree(os.path.join(d_vic, "round_000002.npz"),
                         numpy=True)
        assert sum(len(s["buffer"]["lanes"]) for s in st["servers"]) > 0
        assert max(int((s["partial_w"] > 0).sum())
                   for s in st["servers"]) >= 2


def test_restored_trees_keep_the_model_key_order(tmp_path):
    """A file stores dict keys sorted; a restored tree comes back in the
    model's order, as the uninterrupted run holds it (code that walks two
    trees' leaves side by side relies on it)."""
    def paths(tree, p=""):
        if isinstance(tree, dict):
            return [q for k, v in tree.items() for q in paths(v, f"{p}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [q for i, v in enumerate(tree)
                    for q in paths(v, f"{p}/{i}")]
        return [p]
    sim = _sim("batched", "modes")
    sim.run(2)
    save_checkpoint(sim, ckpt_dir=str(tmp_path))
    res = _sim("batched", "modes")
    restore_checkpoint(res, str(tmp_path))
    for a, b in zip(sim.servers, res.servers):
        assert paths(a.merged) == paths(b.merged)
        assert paths(a.partials) == paths(b.partials)
        assert [paths(e["delta"]) for e in a.buffer.values()] == \
            [paths(e["delta"]) for e in b.buffer.values()]
    assert any(s.buffer for s in res.servers)


def test_restore_into_the_live_fused_simulator(tmp_path):
    """A restore reaches the fused engine's static buffers by copy: the
    rounds after it equal an uninterrupted run's."""
    d = str(tmp_path)
    ref = _sim("fused", "modes")
    ref.run(ROUNDS)
    live = _sim("fused", "modes", CheckpointSpec(interval=INTERVAL, dir=d))
    live.run(ROUNDS)                       # runs past the checkpoint
    carry = {k: v.data_ptr() for k, v in live.fused.carry.items()
             if isinstance(v, torch.Tensor)}
    assert restore_checkpoint(live, round_idx=INTERVAL) == INTERVAL
    assert len(live.history) == INTERVAL
    live.run(ROUNDS - INTERVAL)
    assert _hist(ref) == _hist(live)
    assert carry == {k: v.data_ptr() for k, v in live.fused.carry.items()
                     if isinstance(v, torch.Tensor)}


def _state(sim):
    """What a restore would change, as plain data."""
    return {"hist": _hist(sim), "tick": sim.mobility.tick,
            "pos": sim.mobility.pos.tolist(),
            "rng": str(sim.rng.bit_generator.state),
            "ucb": [s.counts.tolist() for s in sim.ucb_states],
            "servers": [(s.round, None if s.merged is None else
                         {k: v.tolist() for k, v in
                          _leaves(interop.to_numpy(s.merged)).items()})
                        for s in sim.servers]}


@pytest.mark.parametrize("change, match", [
    ({"lr": 123.0}, "fingerprint"), ({"seed": 4}, "fingerprint"),
    ({"num_vehicles": 9}, "fingerprint")])
def test_mismatched_config_raises_before_any_state_changes(tmp_path, change,
                                                           match):
    d = str(tmp_path)
    _sim("batched", ck=CheckpointSpec(interval=2, dir=d)).run(2)
    other = _sim("batched", ck=CheckpointSpec(interval=2, dir=d), **change)
    other.run(1)
    before = _state(other)
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(other)
    assert _state(other) == before


@pytest.mark.parametrize("fault, match", [
    ("version", "version 1"), ("round", "claims round 3")])
def test_old_or_misnamed_files_raise(tmp_path, fault, match):
    d = str(tmp_path)
    sim = _sim("batched")
    sim.run(2)
    path = save_checkpoint(sim, ckpt_dir=d)
    state = load_pytree(path, numpy=True)
    meta = json.loads(bytes(state["meta"]).decode())
    if fault == "version":
        meta["version"] = 1
    else:
        meta["round"] = 3
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    save_pytree(path, state)
    res = _sim("batched")
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(res, d)
    assert res.history == [] and res.mobility.tick == 0


def test_fused_checkpoint_resumes_under_batched(tmp_path):
    """engine is exempt from the fingerprint: a fused checkpoint resumes
    under the batched engine, which then runs the uninterrupted fused
    run's rounds (counts exact, energy and latency within 1e-5)."""
    d = str(tmp_path)
    ref = _sim("fused")
    ref.run(ROUNDS)
    _sim("fused", ck=CheckpointSpec(interval=2, dir=d)).run(2)
    res = _sim("batched")
    assert restore_checkpoint(res, d) == 2
    res.run(ROUNDS - 2)
    for a, b in zip(ref.history, res.history):
        for ta, tb in zip(a["tasks"], b["tasks"]):
            for k in ("active", "departing", "fallbacks", "comm_params",
                      "mean_rank"):
                assert ta[k] == tb[k], k
            for k in ("energy", "latency"):
                assert abs(ta[k] - tb[k]) <= 1e-5 * abs(ta[k]) + 1e-9


# ---------------------------------------------------------------------------
# A checkpoint the reference wrote
# ---------------------------------------------------------------------------

XKW = dict(method="ours", num_vehicles=6, num_tasks=2, local_steps=2,
           seed=0, rounds=4)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """The reference's serial run: two rounds, its checkpoint, then its
    round 2 (record, plans, merged deltas)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jsim = JSimulator(JSimConfig(
        **XKW, engine="serial",
        train_arch=jvit.vit_base_paper().with_overrides(**TINY), lora=JLORA,
        checkpoint=JCheckpointSpec(interval=2, dir=d)))
    jsim.run(2)
    plans = []
    _recording(jsim, plans)
    rec = jsim.run_round()
    merged = [_np(s.merged) for s in jsim.servers]
    return d, jsim, rec, plans, merged, _omega_ref()


@pytest.fixture(scope="module", params=["serial", "batched", "fused"])
def from_reference(request, reference_checkpoint, tmp_path_factory):
    d, jsim, _, _, _, omega = reference_checkpoint
    draws = [_server_draw(7 * t, jsim.model_cfg, JLORA)
             for t in range(XKW["num_tasks"])]
    sim = IoVSimulator(
        SimConfig(**XKW, engine=request.param, train_arch=_arch(),
                  lora=LORA), device="cpu",
        params=interop.params_from_jax(_np(jsim.params), device="cpu"),
        server_draws=[a for a, _ in draws],
        mask_draws=[m for _, m in draws], draw_omega=omega)
    assert restore_checkpoint(sim, d) == 2
    resaved = save_checkpoint(
        sim, ckpt_dir=str(tmp_path_factory.mktemp(request.param)))
    plans = []
    _recording(sim, plans)
    # the round's SVDs are the reference's (test_torch_tier.reference_svds):
    # round 2 redistributes at rank 8 a merge of one or two rank-4 uploads,
    # whose null-space columns each package's QR picks its own way
    if sim.fused is not None:
        # the engine's round counter, which the injected SVDs' seed reads
        sim.fused._init_carry()
    with reference_svds(sim):
        rec = sim.run_round()
    return sim, rec, plans, resaved


def test_port_resave_equals_the_reference_file(reference_checkpoint,
                                               from_reference):
    d = reference_checkpoint[0]
    want = jio.load_pytree(os.path.join(d, "round_000002.npz"), numpy=True)
    got = load_pytree(from_reference[3], numpy=True)
    lw, lg = _leaves(want), _leaves(got)
    assert sorted(lw) == sorted(lg)
    keys = [k for k in lw if k.startswith("/servers/") and
            k.endswith("/key")]
    assert len(keys) == XKW["num_tasks"]
    for k in lw:
        if k in keys:
            assert lw[k].dtype == np.uint32 and lg[k].dtype == np.uint8
            continue
        assert lw[k].dtype == lg[k].dtype, k
        assert np.array_equal(lw[k], lg[k]), k


def test_round_after_a_reference_checkpoint_matches(reference_checkpoint,
                                                    from_reference):
    _, _, jrec, jplans, jmerged, _ = reference_checkpoint
    sim, rec, plans, _ = from_reference
    assert rec["round"] == jrec["round"] == 2
    assert plans == jplans
    for jt, t in zip(jrec["tasks"], rec["tasks"]):
        for k in ("active", "departing", "fallbacks", "comm_params",
                  "mean_rank", "budget"):
            assert t[k] == jt[k], k
        for k in ("energy", "latency"):
            assert abs(t[k] - jt[k]) <= 1e-5 * max(abs(jt[k]), 1e-12), k
    for s, jm in zip(sim.servers, jmerged):
        paths = tree_paths_delta(s.merged)
        assert sorted(paths) == sorted(tree_paths_delta(jm))
        for p in paths:
            got = tree_get(s.merged, p)["delta"].numpy()
            want = np.asarray(tree_get(jm, p)["delta"])
            top = float(np.max(np.abs(want)))
            assert float(np.max(np.abs(got - want))) <= 1e-4 * top
