"""rwkv6 as the federated round's ``train_arch``: one round of the port's
simulator under ``serial``, ``batched`` and ``fused`` against the
reference's, on the CPU; and the rwkv6 ``loss_fn`` with its adapter
gradients against ``jax.value_and_grad`` of the reference's.

Config: ``SimConfig(train_arch=rwkv6_7b.reduced(), num_vehicles=6,
num_tasks=2, local_steps=1)`` in both packages. The reference runs it
once, under its serial engine (its batched engine compiles longer). The
reference's
``jax.random`` draws go to the port as ``tests/test_torch_sim.py`` hands
them over: the base weights, each server's fresh adapters and FedRA
masks (``_server_draw``) and the SVD sketch Ω. On the CPU the port's
``wkv6`` and ``lora_matmul`` take their plain versions; the backward of
``wkv6`` is autograd of its plain version.

Tolerances: active sets, ranks, departures and counts exactly; energy,
latency, accuracy and the merged deltas within 1e-4; the loss within
1e-5 relative, and the adapter gradients within 1e-5 of the largest
gradient entry (one leaf's gradient is ~1e-9 at this init, below f32's
summation noise relative to its own scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import rwkv6_7b as jrwkv
from repro.models import transformer as JT
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.config import LoRAConfig
from repro_torch.configs import rwkv6_7b
from repro_torch.core.aggregation import tree_get, tree_paths_delta
from repro_torch.models import transformer as T
from repro_torch.sim.simulator import IoVSimulator, SimConfig

from test_torch_sim import (_np, _omega_ref, _recording,  # noqa: F401
                            _server_draw, one_torch_thread)

KW = dict(method="ours", num_vehicles=6, num_tasks=2, local_steps=1)
TOL = 1e-4
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """The reference's round: (sim, record, plans, Ω draw)."""
    jsim = JSimulator(JSimConfig(train_arch=jrwkv.reduced(),
                                 engine="serial", **KW))
    plans = []
    _recording(jsim, plans)
    return jsim, jsim.run_round(), plans, _omega_ref()


@pytest.fixture(scope="module", params=["serial", "batched", "fused"])
def run(request, reference):
    """The port's round under each engine, on the reference's draws."""
    jsim, jrec, jplans, omega = reference
    draws = [_server_draw(7 * t, jrwkv.reduced(), jsim.cfg.lora)
             for t in range(KW["num_tasks"])]
    sim = IoVSimulator(
        SimConfig(train_arch=rwkv6_7b.reduced(), engine=request.param, **KW),
        device="cpu",
        params=interop.params_from_jax(_np(jsim.params), device="cpu"),
        server_draws=[d for d, _ in draws],
        mask_draws=[m for _, m in draws], draw_omega=omega)
    plans = []
    _recording(sim, plans)
    return jsim, jrec, jplans, sim, sim.run_round(), plans


def test_active_sets_ranks_and_departures_are_exact(run):
    _, _, jplans, _, _, plans = run
    assert len(plans) == KW["num_tasks"]
    assert plans == jplans
    assert any(ids for _, ids, _, _ in plans)


@pytest.mark.parametrize("key", ["active", "departing", "handoffs",
                                 "fallbacks", "comm_params", "mean_rank",
                                 "task", "budget"])
def test_round_counts_are_exact(run, key):
    _, jrec, _, _, rec, _ = run
    for jt, t in zip(jrec["tasks"], rec["tasks"]):
        assert t[key] == jt[key], (t["task"], key)
    assert rec["budgets"] == jrec["budgets"]


@pytest.mark.parametrize("key", ["energy", "latency", "accuracy"])
def test_energy_latency_and_accuracy_match(run, key):
    _, jrec, _, _, rec, _ = run
    for jt, t in zip(jrec["tasks"] + [jrec], rec["tasks"] + [rec]):
        assert abs(t[key] - jt[key]) <= TOL * max(1.0, abs(jt[key]))


def test_merged_deltas_match(run):
    jsim, _, _, sim, _, _ = run
    n = 0
    for js, s in zip(jsim.servers, sim.servers):
        paths = tree_paths_delta(s.merged)
        assert sorted(paths) == sorted(tree_paths_delta(js.merged))
        for p in paths:
            got = tree_get(s.merged, p)["delta"].numpy()
            want = np.asarray(tree_get(js.merged, p)["delta"])
            assert got.shape == want.shape
            assert float(np.max(np.abs(got - want))) < TOL
            n += 1
    assert n  # the round merged rwkv6 adapters (w_r … cv)


@pytest.fixture(scope="module")
def model():
    """Reference params and adapters of the reduced rwkv6 (f32), and the
    port's copies."""
    jp, ja = jax.jit(lambda k0, k7: (
        JT.init_params(k0, jrwkv.reduced(), jnp.float32),
        jax.tree_util.tree_map(lambda x: x + 0.01, JT.init_adapters(
            k7, jrwkv.reduced(), JLoRAConfig(rank=4), rank=4))))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(7))
    return (jp, ja, interop.params_from_jax(_np(jp), device="cpu",
                                            dtype=torch.float32),
            interop.adapters_from_jax(_np(ja), "cpu"))


@pytest.mark.parametrize("labels", ["next_token", "class"])
def test_loss_and_adapter_grads_match_reference(model, labels):
    """One train step's loss and adapter gradients: the port's loss_fn
    (the plain wkv6 route and its autograd backward) against
    jax.value_and_grad of the reference's."""
    jp, ja, pp, pa = model
    jcfg, cfg = jrwkv.reduced(), rwkv6_7b.reduced()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 24))
    if labels == "class":
        lab = rng.integers(0, 6, (3,))
    else:
        lab = np.roll(toks, -1, axis=1)
        lab[:, -1] = -100
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a: JT.loss_fn(jp, a, jcfg, JLoRAConfig(rank=4),
                             {"tokens": toks, "labels": lab}),
        has_aux=True))(ja)
    ads = interop.tree_map(lambda x: x.clone().requires_grad_(True), pa)
    loss, _ = T.loss_fn(pp, ads, cfg, LoRAConfig(rank=4),
                        {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(lab)})
    leaves, refs = [], []
    interop.tree_map(lambda x, g: (leaves.append(x), refs.append(g)), ads,
                     _np(jgrads))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= GRAD_TOL * max(
        1.0, abs(float(jloss)))
    assert len(grads) == 6 * 2    # a and b of 6 stacked linears
    scale = max(float(np.max(np.abs(r))) for r in refs)
    err = max(float(np.max(np.abs(g.numpy() - r)))
              for g, r in zip(grads, refs))
    assert err <= GRAD_TOL * scale, f"adapter grads {err} of {scale}"
    assert sum(float(g.abs().max()) > 1e-6 for g in grads) >= 11
