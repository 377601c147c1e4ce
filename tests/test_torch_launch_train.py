"""The training entry point against the reference, on the CPU.

``make_train_step``'s step against the reference's under a (1, 1) mesh
(the reference's params and adapters carried through ``interop``) at
the reduced sizes of smollm-135m, paligemma-3b (prefix embeddings) and
zamba2-2.7b (the shared block under remat), with remat on: loss and metrics each step to 1e-5, the first
step's Adam ``mu`` and the adapters after 3 steps to 1e-4 of each leaf's
largest entry (smollm-135m's steps also with two microbatches and a
chunked CE). The step's options (remat, microbatch, ce_chunk) against
each other to 1e-6; the step leaves its arguments as they were, and a
microbatch count that does not divide the batch raises. The CLI in-process (``--device cpu``) with
the reference's init handed in, against the reference CLI: the loss
lines to 1e-4, the same fingerprint, checkpoints the other package's
``restore_round`` reads with the same keys and RNG state, the last 3
kept by both; kill-and-resume bit for bit; another ``--lr`` refused; a
scenario preset through ``--simulate``; ``fused_sharded`` refused on
the one device the CPU shows. And the reference notes of ROADMAP Queue 3 this slice copies.
"""
import contextlib
import io
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.checkpoint import restore_round as jrestore_round
from repro.configs import paligemma_3b as jpali
from repro.configs import smollm_135m as jsmollm
from repro.configs import zamba2_2_7b as jzamba
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch import config as pconfig
from repro_torch import interop
from repro_torch.checkpoint import restore_round
from repro_torch.config import LoRAConfig
from repro_torch.configs import paligemma_3b, smollm_135m, zamba2_2_7b
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as T
from repro_torch.optim.adam import adam, leaves

torch.set_num_threads(1)

ARCHS = {"smollm-135m": (jsmollm, smollm_135m),
         "paligemma-3b": (jpali, paligemma_3b),
         "zamba2-2.7b": (jzamba, zamba2_2_7b)}
# the step factory's default learning rate: Adam normalises each entry's
# gradient, so a rounding-level gradient difference moves an adapter entry
# by up to lr x its relative size (ROADMAP "What one round can be held to")
RANK, LR = 4, 1e-4
B, S, STEPS = 4, 16, 3
# remat on everywhere; smollm-135m also with two microbatches and a
# chunked CE (the reference's production step settings); one jit each
STEP_KW = dict(lr=LR, remat=True, ce_chunk=8, microbatch=2)
REF_KW = {"smollm-135m": STEP_KW,
          "paligemma-3b": dict(lr=LR, remat=True),
          "zamba2-2.7b": dict(lr=LR, remat=True)}
METRIC_TOL = 1e-5
STATE_TOL = 1e-4


def _ref_mesh():
    """The reference's (1, 1) mesh on the one CPU device (Auto axes, which
    its ``with_sharding_constraint`` needs)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S))
        labels = rng.integers(0, cfg.vocab_size, (B, S))
        labels[:, -2:] = -100          # masked targets
        b = {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}
        if cfg.num_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


# the reference's programs of this file compile in half the time with
# XLA's backend optimisation off; the values they compute are the same
# functions' (the step tolerances hold either way)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compiled(jitted, *args):
    """``jitted`` compiled for ``args`` with FAST_COMPILE (options of this
    one executable: no other program of the process is touched)."""
    return jitted.lower(*args).compile(FAST_COMPILE)


def _ref_init(jcfg, seed=0, rank=RANK, nudge=0.01, jit=False):
    """The reference's seeded f32 params and rank-``rank`` adapters. Eager
    dispatch compiles each op's shape once per process; ``jit`` compiles
    the whole init once instead, cheaper for shapes nothing else draws
    and on a thread of its own."""
    def run(fn, key):
        return _compiled(jax.jit(fn), key)(key) if jit else fn(key)
    jp = run(lambda k: JT.init_params(k, jcfg, dtype=jnp.float32),
             jax.random.PRNGKey(seed))
    ja = run(lambda k: JT.init_adapters(k, jcfg, jconfig.LoRAConfig(
        rank=rank), rank=rank), jax.random.PRNGKey(seed + 1))
    # b off its zero init, so A gets gradients from the first step
    ja = jax.tree_util.tree_map(lambda x: x + nudge, ja)
    return _np(jp), _np(ja)


def _to_port(np_params, np_adapters):
    return (interop.params_from_jax(np_params, device="cpu",
                                    dtype=torch.float32),
            interop.adapters_from_jax(np_adapters, "cpu"))


def _port_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


_REF = {}


@pytest.fixture(scope="module", autouse=True)
def references(tmp_path_factory):
    """Every reference computation of this file, once, in threads (XLA
    compiles one program while another thread traces): the reference CLI
    (``_reference_cli``) here, each arch's step (``_reference_of``) in a
    thread of its own. The file takes ~16-23 s alone, most of it these
    compiles."""
    from concurrent.futures import ThreadPoolExecutor
    cli_dir = str(tmp_path_factory.mktemp("ref_cli"))
    with ThreadPoolExecutor(len(ARCHS) + 1) as pool:
        steps = {a: pool.submit(_reference_of, a) for a in ARCHS}
        # the port's remat (torch.utils.checkpoint) imports torch._dynamo
        # at its first call: import it meanwhile
        pool.submit(__import__, "torch._dynamo")
        _REF["cli"] = _reference_cli(cli_dir)
        _REF.update((a, f.result()) for a, f in steps.items())
    yield
    _REF.clear()


def _reference(arch):
    """The reference step's metrics per step, mu after step 1 and the
    adapters after STEPS steps (one jit under a (1, 1) CPU mesh)."""
    return _REF[arch]


def _reference_of(arch):
    jmod, _ = ARCHS[arch]
    jcfg = jmod.reduced()
    params, adapters = _ref_init(jcfg, jit=True)
    batches = _batches(jcfg, STEPS)
    mesh = _ref_mesh()
    # smollm-135m's steps take a window of 1, which the reference drops
    window = 1 if arch == "smollm-135m" else None
    _, jit_step = jtrain.make_train_step(
        jcfg, jconfig.LoRAConfig(rank=RANK), mesh, sliding_window=window,
        **REF_KW[arch])
    # adapters and Adam state placed as the step returns them (replicated
    # over the mesh): the compiled step takes one placement
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    ja = jax.device_put(jax.tree_util.tree_map(jnp.asarray, adapters), rep)
    jo = jax.device_put(jtrain.adam(LR).init(ja), rep)
    jb = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    run = _compiled(jit_step(jp, ja, jo, jb[0]), jp, ja, jo, jb[0])
    metrics, mu1 = [], None
    for i, b in enumerate(jb):
        ja, jo, m = run(jp, ja, jo, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu1 = _np(jo.mu)
    return dict(params=params, adapters=adapters, batches=batches,
                metrics=metrics, mu1=mu1, final=_np(ja))


def _leaf_pairs(want, got):
    """(path, reference leaf, port leaf as numpy) over the reference's
    tree, by key."""
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    out = []
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf),
                    node.detach().cpu().numpy()))
    return out


def _assert_close_by_leaf(want, got, tol):
    for path, w, g in _leaf_pairs(want, got):
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max()) / scale
        assert err < tol, (path, err)


def _port_run(arch, mesh=None, **kw):
    """The port's step over the reference's state and batches: metrics
    per step, mu after step 1, final adapters."""
    _, pmod = ARCHS[arch]
    cfg = pmod.reduced()
    ref = _reference(arch)
    params, adapters = _to_port(ref["params"], ref["adapters"])
    opt_state = adam(kw.get("lr", LR)).init(adapters)
    step, placed = ptrain.make_train_step(cfg, LoRAConfig(rank=RANK), mesh,
                                          **kw)
    metrics, mu1 = [], None
    for i, b in enumerate(ref["batches"]):
        adapters, opt_state, m = placed(params, adapters, opt_state,
                                        _port_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu1 = interop.tree_map(torch.clone, opt_state.mu)
    return metrics, mu1, adapters


@pytest.mark.parametrize("arch", list(ARCHS))
def test_step_matches_reference(arch):
    ref = _reference(arch)
    mesh = pmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    metrics, mu1, final = _port_run(arch, mesh, **REF_KW[arch])
    for got, want in zip(metrics, ref["metrics"]):
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < METRIC_TOL, (k, got, want)
    assert metrics[-1]["loss"] != metrics[0]["loss"]
    _assert_close_by_leaf(ref["mu1"], mu1, STATE_TOL)
    _assert_close_by_leaf(ref["final"], final, STATE_TOL)


@pytest.mark.parametrize("option", ["remat", "microbatch", "ce_chunk"])
def test_step_options_agree(option):
    """Each option on against all off (remat off, one microbatch, the
    CE in one piece): metrics and adapters to 1e-6."""
    off = dict(lr=LR, remat=False, microbatch=1, ce_chunk=0)
    on = dict(off, **{"remat": {"remat": True},
                      "microbatch": {"microbatch": 2},
                      "ce_chunk": {"ce_chunk": 8}}[option])
    m0, _, a0 = _port_run("zamba2-2.7b", **off)
    m1, _, a1 = _port_run("zamba2-2.7b", **on)
    for x, y in zip(m0, m1):
        for k in x:
            assert abs(x[k] - y[k]) <= 1e-6, (option, k, x, y)
    for (_, x, y) in _leaf_pairs(interop.to_numpy(a0), a1):
        assert float(np.abs(x - y).max()) <= 1e-6, option


def test_step_leaves_its_arguments_as_they_were():
    """As the reference's step: new adapters and Adam state come back
    and the ones passed in keep their values (donate=True, the default,
    is accepted and not acted on)."""
    ref = _reference("smollm-135m")
    cfg = smollm_135m.reduced()
    params, adapters = _to_port(ref["params"], ref["adapters"])
    opt_state = adam(LR).init(adapters)
    before = [t.clone() for t in leaves((adapters, opt_state))]
    step, _ = ptrain.make_train_step(cfg, LoRAConfig(rank=RANK), None,
                                     donate=True, **STEP_KW)
    new_ads, new_opt, _ = step(params, adapters, opt_state,
                               _port_batch(ref["batches"][0]))
    assert int(new_opt.step) == 1
    for x, y in zip(before, leaves((adapters, opt_state))):
        assert torch.equal(x, y)
    moved = [not torch.equal(x, y) for x, y in zip(leaves(adapters),
                                                    leaves(new_ads))]
    assert any(moved)


def test_microbatch_must_divide_the_batch():
    """The reference reshapes the batch to (microbatch, B / microbatch,
    ...), which refuses a B it does not divide; the port refuses it too
    rather than leave rows out."""
    ref = _reference("smollm-135m")
    cfg = smollm_135m.reduced()
    params, adapters = _to_port(ref["params"], ref["adapters"])
    step, _ = ptrain.make_train_step(cfg, LoRAConfig(rank=RANK), None,
                                     lr=LR, microbatch=3)
    with pytest.raises(ValueError, match="does not divide"):
        step(params, adapters, adam(LR).init(adapters),
             _port_batch(ref["batches"][0]))


def test_placed_step_checks_where_arguments_sit():
    ref = _reference("smollm-135m")
    cfg = smollm_135m.reduced()
    params, adapters = _to_port(ref["params"], ref["adapters"])
    opt_state = adam(LR).init(adapters)
    elsewhere = pmesh.Mesh(("data", "model"), (1, 1), torch.device("meta"))
    _, placed = ptrain.make_train_step(cfg, LoRAConfig(rank=RANK), elsewhere)
    with pytest.raises(ValueError, match="sharding rules"):
        placed(params, adapters, opt_state, _port_batch(ref["batches"][0]))


def test_reference_drops_sliding_window():
    """ROADMAP Queue 3: the reference's make_train_step accepts
    sliding_window and never passes it to loss_fn (train.py:37, 48-51);
    the port copies that. The reference's smollm-135m steps run with a
    window of 1 (``_reference``), which would change every loss, and
    match the port's without one; the port's step gives the same bits
    with and without it."""
    ref = _reference("smollm-135m")
    cfg = smollm_135m.reduced()
    params, adapters = _to_port(ref["params"], ref["adapters"])
    batch = _port_batch(ref["batches"][0])
    lora = LoRAConfig(rank=RANK)
    with torch.no_grad():
        full = T.forward(params, adapters, cfg, lora, batch)[0]
        windowed = T.forward(params, adapters, cfg, lora, batch,
                             sliding_window=1)[0]
    assert float((full - windowed).abs().max()) > 1e-2
    losses = []
    for window in (None, 1):
        step, _ = ptrain.make_train_step(cfg, lora, sliding_window=window,
                                         **STEP_KW)
        _, _, m = step(params, adapters, adam(LR).init(adapters), batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    assert losses[0] == pytest.approx(ref["metrics"][0]["loss"],
                                      abs=METRIC_TOL)


def test_hardware_config_is_not_carried():
    """ROADMAP Queue 3: HardwareConfig / HW_V5E hold TPU v5e figures;
    the port states no TPU number and has no copy."""
    assert hasattr(jconfig, "HardwareConfig") and hasattr(jconfig, "HW_V5E")
    assert not hasattr(pconfig, "HardwareConfig")
    assert not hasattr(pconfig, "HW_V5E")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI_STEPS = 4
CLI_RANK = RANK
CLI_ARGS = ["--steps", str(CLI_STEPS), "--batch", "4", "--seq", "16",
            "--rank", str(CLI_RANK), "--checkpoint-every", "1"]


def _reference_cli(d):
    """The reference CLI (reduced smollm-135m, CLI_STEPS steps, a
    checkpoint every step into ``d``): its stdout, ``d`` and its init,
    which the port's CLI is handed. Nothing else of this file prints or
    reads ``sys.argv`` while it runs."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["train"] + CLI_ARGS + ["--checkpoint-dir", d]
    try:
        with contextlib.redirect_stdout(out):
            jtrain.main()
    finally:
        sys.argv = old
    # the reference CLI's init: params and adapters from PRNGKey(0)
    jcfg, key = jsmollm.reduced(), jax.random.PRNGKey(0)
    init = (_np(JT.init_params(key, jcfg, dtype=jnp.float32)),
            _np(JT.init_adapters(key, jcfg, jconfig.LoRAConfig(rank=CLI_RANK),
                                 rank=CLI_RANK)))
    return out.getvalue(), d, init


@pytest.fixture(scope="module")
def ref_cli():
    return _REF["cli"]


def _port_cli(argv, monkeypatch, init=None):
    """The port's CLI in-process on the CPU; stdout. With ``init``, the
    reference's params and adapters are handed to it."""
    if init is not None:
        monkeypatch.setattr(ptrain, "init_state",
                            lambda cfg, lora, rank, device: _to_port(*init))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ptrain.main(["--device", "cpu"] + argv)
    return out.getvalue()


def _losses(text):
    return [(int(i), float(x), float(a)) for i, x, a in re.findall(
        r"step\s+(\d+) loss=([0-9.]+) acc=([0-9.]+)", text)]


def _meta(state):
    m = state["meta"]
    return json.loads(bytes(np.asarray(m.numpy() if hasattr(m, "numpy")
                                       else m)).decode())


def test_cli_matches_reference_cli(ref_cli, monkeypatch, tmp_path):
    text, ref_dir, init = ref_cli
    d = str(tmp_path)
    got = _port_cli(CLI_ARGS + ["--checkpoint-dir", d], monkeypatch, init)
    want_l, got_l = _losses(text), _losses(got)
    assert [x[0] for x in got_l] == [x[0] for x in want_l] == [0, 3]
    for (_, lw, aw), (_, lg, ag) in zip(want_l, got_l):
        assert abs(lw - lg) < 1e-4 and abs(aw - ag) < 1e-3
    assert got.rstrip().endswith("done.")
    # both keep the last 3 of the 4 step checkpoints (README's --keep-last
    # is not a flag of this CLI: ROADMAP Queue 3)
    for dd in (ref_dir, d):
        assert sorted(os.listdir(dd)) == [f"round_{i:06d}.npz"
                                          for i in (2, 3, 4)]
    # each package's restore_round reads the other's file: same step, keys,
    # fingerprint and RNG state
    ri, ref_state = restore_round(ref_dir)
    pi, port_state = restore_round(d)
    ji, jport_state = jrestore_round(d)
    assert ri == pi == ji == CLI_STEPS
    assert _meta(ref_state) == _meta(port_state) == _meta(jport_state)
    flat_r = sorted(jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(
                        _np(jrestore_round(ref_dir)[1]))[0])
    flat_p = sorted(jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(
                        interop.to_numpy(port_state))[0])
    assert flat_r == flat_p
    assert re.fullmatch(r"[0-9a-f]{64}", _meta(port_state)["fingerprint"])


def test_cli_kill_and_resume_is_bit_equal(monkeypatch, tmp_path):
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    common = ["--arch", "paligemma-3b", "--batch", "2", "--seq", "16",
              "--checkpoint-every", "2"]
    _port_cli(common + ["--steps", "4", "--checkpoint-dir", whole],
              monkeypatch)
    _port_cli(common + ["--steps", "2", "--checkpoint-dir", cut],
              monkeypatch)
    text = _port_cli(common + ["--steps", "4", "--resume",
                               "--checkpoint-dir", cut], monkeypatch)
    assert "resumed from step 2" in text
    _, a = restore_round(whole)
    _, b = restore_round(cut)
    assert _meta(a) == _meta(b)
    for path, x, y in _leaf_pairs(interop.to_numpy(a), b):
        assert np.array_equal(x, y), path
    with pytest.raises(SystemExit, match="different run config"):
        _port_cli(common + ["--steps", "6", "--resume", "--lr", "2e-3",
                            "--checkpoint-dir", cut], monkeypatch)


def test_cli_needs_a_checkpoint_dir_and_has_no_keep_last(monkeypatch):
    for argv in (["--resume"], ["--checkpoint-every", "2"],
                 ["--keep-last", "2"]):
        with pytest.raises(SystemExit):
            _port_cli(argv, monkeypatch)


def test_cli_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.main(["--steps", "1"])


def test_cli_simulate_runs(monkeypatch):
    text = _port_cli(["--simulate", "sparse-rural", "--rounds", "1"],
                     monkeypatch)
    assert re.search(r"round\s+0 acc=[0-9.]+ energy=[0-9.]+ reward=", text)
    assert "done: sparse-rural (sync), 1 rounds" in text


def test_cli_fused_sharded_raises_item_12(monkeypatch):
    """``--engine fused_sharded`` on the CPU, which shows one device,
    raises naming the visible devices, as the reference's CLI refuses it
    on a host without forced devices."""
    with pytest.raises(ValueError, match="visible device"):
        _port_cli(["--simulate", "sparse-rural", "--rounds", "1",
                   "--engine", "fused_sharded"], monkeypatch)
