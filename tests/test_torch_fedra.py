"""FedRA (random layer allocation; the paper's Table I) in the port's
simulator against the reference's, on the CPU, and its exact gate: a
lane's adapter on the layers its mask leaves out comes back from local
training bit for bit as it went in.

``test_torch_sim.py``'s two rounds under ``serial``, ``batched`` and
``batched_check``, on the reference's draws (FedRA's layer masks among
them), held to the reference's serial run at ``test_torch_baselines.py``'s
tolerances, whose checks are collected here over this file's runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aggregation as agg
from repro_torch.data import ClientDataset
from repro_torch.federated.batched_client import (BatchedLocalTrainer,
                                                  draw_batches, unstack_tree)
from repro_torch.federated.client import LocalTrainer
from repro_torch.models import transformer as T
from test_torch_baselines import (  # noqa: F401  (fixtures and tests)
    port_runs, test_accuracy_reward_and_lambda_match, test_baseline_ranks,
    test_departures_lose_the_upload, test_energy_and_latency_match,
    test_engine_check_dev_is_exact, test_fedra_layer_masks,
    test_plans_match_reference, test_round_counts_are_exact,
    test_server_state_matches, test_ucb_state_matches)
from test_torch_batched import (LORA, _cfg, _data, _nontrivial,  # noqa: F401
                               one_torch_thread)

ENGINES = ("serial", "batched", "batched_check")


@pytest.fixture(scope="module", params=[("fedra", e) for e in ENGINES],
                ids=[f"fedra-{e}" for e in ENGINES])
def runs(request):
    return port_runs(request)


def _masked_layers_kept(before, after, mask) -> bool:
    """Every leaf of ``after`` equals ``before`` bit for bit on the
    layers where ``mask`` is 0."""
    off = torch.as_tensor(np.asarray(mask)) == 0
    return all(torch.equal(agg.tree_get(after, p)[k][off],
                           agg.tree_get(before, p)[k][off])
               for p in agg.tree_paths(before) for k in ("a", "b"))


@pytest.mark.parametrize("trainer", ["serial", "batched"])
def test_masked_layers_come_back_exact(trainer):
    """Masked gradients are exactly 0, so Adam's update is too: the left
    out layers are bit-identical after 3 steps, the trained ones moved.
    A mask applied to the wrong layers breaks the gate."""
    cfg = _cfg()
    L = cfg.num_layers
    masks = [np.eye(L, dtype=np.float32)[v % L] for v in range(3)]
    ad = _nontrivial(T.init_adapters(cfg, LORA, seed=3, rank=4,
                                     device="cpu"), 4)
    shards, _ = _data(3, seed=5)
    dss = [ClientDataset(t, l, 4, seed=v) for v, (t, l) in enumerate(shards)]
    batches = [draw_batches(ds, 3, 3) for ds in dss]

    def train(ms):
        if trainer == "serial":
            local = LocalTrainer(cfg, LORA, lr=5e-3, device="cpu")
            return [local.finetune(params, ad, None, 3, layer_mask=m,
                                   batches=[{k: b[k][s] for k in b}
                                            for s in range(3)])[0]
                    for m, b in zip(ms, batches)]
        stacked, _ = BatchedLocalTrainer(
            cfg, LORA, lr=5e-3, max_steps=3, device="cpu"
        ).finetune_group_stacked(params, [ad] * 3, batches, [3] * 3,
                                 layer_masks=ms)
        return unstack_tree(stacked, 3)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    got = train(masks)
    for out, m in zip(got, masks):
        assert _masked_layers_kept(ad, out, m)
        assert not _masked_layers_kept(ad, out, 1.0 - m)
    wrong = train([np.roll(m, 1) for m in masks])
    assert not any(_masked_layers_kept(ad, out, m)
                   for out, m in zip(wrong, masks))
