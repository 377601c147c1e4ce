"""Batched local fine-tuning, port of ``repro/federated/batched_client.py``.

The serial engine (:class:`~repro_torch.federated.client.LocalTrainer`)
runs one forward and one backward per vehicle per local step. This
trainer stacks a (task, rank) group of vehicles on the kernels' own lane
axes and trains the whole group with one forward and one backward per
local step:

- adapter leaves go from (L, d_in, r) to (L, V, d_in, r), the lane layout
  ``transformer.decode_step`` already takes, so every LoRA linear launches
  ``lora_matmul`` once with x as (V, B·S, d)
  (``core/lora.py::_kernel_linear``), and its closed-form backward is per
  lane;
- tokens (V, B, S) go in as (V·B, S), lane-major, so ``flash_attention``
  takes the V·B rows in its batch axis;
- ``loss_fn(lanes=V)`` reduces per lane and returns the SUM of the lanes'
  losses, whose gradient with respect to lane v's adapters is lane v's
  own.

The reference writes the lane axis with ``jax.vmap`` and the step loop
with ``lax.scan``. The port writes both out: no ``torch.func.vmap`` (its
transforms refuse the kernels' ``autograd.Function``\\ s, which have no
``setup_context``) and no ``torch.compile``.

Step budgets: every lane runs up to the group's largest budget; a lane
past its own (a departing vehicle, §IV-E) keeps its adapters and its Adam
moments, through ``torch.where`` on a per-lane live mask. Adam's step
counter stays one scalar: the lanes live at step s are exactly those with
a budget > s, and each of them has taken s steps. The loop ends at the
group's largest budget, where no lane is live any more (the reference
scans to ``max_steps`` with the extra steps masked; the result is the
same). Metrics are those of each lane's last live step.

Left out, as choices for XLA on the CPU with no counterpart here:
``MAX_GROUP = 8`` and the power-of-two lane buckets (they bound XLA's
compiles; eager PyTorch compiles nothing), and the thread pool with its
round robin over devices (one card runs the groups in order on the
current stream). One group is one stack of lanes, however wide.

Host work per group: one host-to-device copy of its stacked batches and
step budgets, and one device-to-host copy of its metrics; no sync per
step. Each task's local-eval batch is copied to the device once and kept
there (:class:`~repro_torch.core.cache.IdentityLRU`, keyed on the host
dict).

Lane axis: every leaf of an adapter tree is a matrix ('a' or 'b') behind
its layer axis, so a stacked tree carries its lanes third from the end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import LoRAConfig, ModelConfig
from repro_torch.core.cache import IdentityLRU
from repro_torch.core.lora import tree_rank
from repro_torch.data.pipeline import ClientDataset
from repro_torch.federated.client import refuse_unstacked_adapters
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device
from repro_torch.optim import adam, apply_updates
from repro_torch.optim.adam import AdamState, leaves, unflatten

LANE_AXIS = -3
# metrics of a group, in the order of the rows copied to the host
TRAIN_METRICS = ("loss", "aux", "accuracy")


def draw_batches(dataset: ClientDataset, n_steps: int, pad_to: int
                 ) -> Dict[str, np.ndarray]:
    """Draw ``n_steps`` batches from the vehicle's shard (the same RNG
    stream as the serial trainer consumes) and pad to ``pad_to`` steps by
    repeating the last batch; padded steps are never trained.

    Returns {"tokens": (pad_to, B, S), "labels": (pad_to, B)}.
    """
    if not 1 <= n_steps <= pad_to:
        raise ValueError(f"need 1 <= n_steps ({n_steps}) <= pad_to "
                         f"({pad_to})")
    bs = [dataset.next_batch() for _ in range(n_steps)]
    while len(bs) < pad_to:
        bs.append(bs[-1])
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack same-structure adapter trees on their lane axis:
    (L, d_in, r) leaves become (L, V, d_in, r)."""
    cols = zip(*(leaves(t) for t in trees))
    return unflatten(trees[0], [torch.stack(xs, dim=LANE_AXIS)
                                for xs in cols])


def unstack_tree(tree: Any, n: int) -> List[Any]:
    """Inverse of :func:`stack_trees` (first ``n`` lanes, as views)."""
    return [tree_map(lambda x, i=i: x.select(LANE_AXIS, i), tree)
            for i in range(n)]


def take_lanes(tree: Any, lanes: Sequence[int]) -> Any:
    """Gather a subset of lanes from a stacked tree (one op per leaf)."""
    idx = torch.as_tensor(list(lanes), dtype=torch.int64)
    return tree_map(lambda x: x.index_select(LANE_AXIS, idx.to(x.device)),
                    tree)


def _broadcast_lanes(tree: Any, n: int) -> Any:
    """One tree shared by ``n`` lanes, materialized per lane: a stride-0
    ``expand`` as an autograd leaf would sum the lanes' gradients."""
    return tree_map(lambda x: x.unsqueeze(LANE_AXIS).expand(
        x.shape[:-2] + (n,) + x.shape[-2:]).clone(), tree)


def _keep_frozen(live: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` on the live lanes, ``old`` on the rest."""
    m = live.reshape(-1, 1, 1)
    return unflatten(new, [torch.where(m, a, b)
                           for a, b in zip(leaves(new), leaves(old))])


def _repeat_lanes(t: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of one batch, once per lane, lane-major."""
    return t.repeat((n,) + (1,) * (t.dim() - 1))


class BatchedLocalTrainer:
    """Group counterpart of :class:`LocalTrainer`: Adam on the stacked
    adapter tree only (frozen base), one forward and backward per local
    step for the whole group."""

    def __init__(self, cfg: ModelConfig, lora: LoRAConfig, lr: float = 1e-3,
                 max_steps: int = 1, device="cuda"):
        self.cfg = cfg
        self.lora = lora
        self.lr = lr
        self.max_steps = max(int(max_steps), 1)
        self.device = resolve_device(device)
        self.opt = adam(lr)
        # one live eval batch per task is the steady state; the bound
        # evicts the batches of finished simulators instead of pinning them
        self._eval_cache = IdentityLRU(maxsize=16)

    def _lora_at(self, rank: int) -> LoRAConfig:
        return dataclasses.replace(self.lora, rank=rank)

    def _eval_batch(self, eval_batch: Dict) -> Dict[str, torch.Tensor]:
        ev = self._eval_cache.get(eval_batch)
        if ev is None:
            ev = {k: torch.as_tensor(np.asarray(v), dtype=torch.int64
                                     ).to(self.device)
                  for k, v in eval_batch.items()}
            self._eval_cache.put(eval_batch, ev)
        return ev

    # ------------------------------------------------------------------
    def train_step(self, params, adapters, opt_state, batch, layer_masks,
                   lanes: int, scale=None
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        """One local update of every lane. adapters: stacked tree;
        batch: tokens (V·B, S), labels lane-major; layer_masks: (L, V)
        multipliers or None; scale: None (α over the tree's rank, every
        lane) or the fused engine's ``(scale (V,), rank_mask (V, R))``
        for rank-padded lanes at their own ranks. Returns (adapters,
        opt_state, metrics) with (V,) metrics, all detached; the caller
        freezes lanes past their budget."""
        refuse_unstacked_adapters(self.cfg)
        lora_r = self._lora_at(tree_rank(adapters))
        ad = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
        loss, metrics = T.loss_fn(params, ad, self.cfg, lora_r, batch,
                                  lanes=lanes, scale=scale)
        grads = torch.autograd.grad(loss, leaves(ad))
        if layer_masks is not None:
            # FedRA: each lane trains only its allocated layers
            grads = [g * layer_masks.reshape(layer_masks.shape
                                             + (1,) * (g.dim() - 2))
                     for g in grads]
        updates, opt_state = self.opt.update(unflatten(adapters, grads),
                                             opt_state, adapters)
        return (apply_updates(adapters, updates), opt_state,
                {k: v.detach() for k, v in metrics.items()})

    def evaluate_lanes(self, params, adapters, eval_batch: Dict,
                       lanes: int, scale=None) -> torch.Tensor:
        """(V,) accuracy of each lane's adapters on one eval batch (a
        host dict, copied once and cached, or int64 tensors already on
        the device); scale as in :meth:`train_step`."""
        ev = eval_batch
        if not all(isinstance(v, torch.Tensor) for v in ev.values()):
            ev = self._eval_batch(eval_batch)
        batch = {k: _repeat_lanes(v, lanes) for k, v in ev.items()}
        with torch.no_grad():
            _, m = T.loss_fn(params, adapters, self.cfg,
                             self._lora_at(tree_rank(adapters)), batch,
                             lanes=lanes, scale=scale)
        return m["accuracy"]

    def train_lanes(self, params, adapters, tokens, labels, counts,
                    steps: int, layer_masks=None, scale=None
                    ) -> Tuple[Any, torch.Tensor]:
        """``steps`` local updates of every lane from fresh Adam moments;
        a lane past its budget keeps its adapters and moments. tokens (V,
        ≥ steps, B, S) and labels (V, ≥ steps, B) on the device; counts:
        (V,) step budgets on the device; layer_masks and scale as in
        :meth:`train_step`. Reads nothing back to the host (the fused
        engine captures it in a CUDA graph). Returns (adapters, metrics
        as rows TRAIN_METRICS × lanes, each lane's last live step)."""
        n = tokens.shape[0]
        opt_state = self.opt.init(adapters)
        last = None
        for si in range(steps):
            batch = {"tokens": tokens[:, si].reshape(
                         (-1,) + tuple(tokens.shape[3:])),
                     "labels": labels[:, si].reshape(
                         (-1,) + tuple(labels.shape[3:]))}
            new_ad, new_os, m = self.train_step(params, adapters, opt_state,
                                                batch, layer_masks, n,
                                                scale=scale)
            live = counts > si
            adapters = _keep_frozen(live, new_ad, adapters)
            opt_state = AdamState(step=new_os.step,
                                  mu=_keep_frozen(live, new_os.mu,
                                                  opt_state.mu),
                                  nu=_keep_frozen(live, new_os.nu,
                                                  opt_state.nu))
            # each lane reports its last live step
            row = torch.stack([m[k] for k in TRAIN_METRICS])
            last = row if last is None else torch.where(live, row, last)
        return adapters, last

    # ------------------------------------------------------------------
    def _run_group(self, params, adapters_list: Sequence[Any],
                   batches_list: Sequence[Dict[str, np.ndarray]],
                   step_counts: Sequence[int],
                   eval_batch: Optional[Dict] = None,
                   layer_masks: Optional[Sequence] = None
                   ) -> Tuple[Any, torch.Tensor]:
        """Train one group; returns (stacked adapters, metrics on the
        device as rows TRAIN_METRICS (+ eval_accuracy) × lanes)."""
        n = len(adapters_list)
        if not (n == len(batches_list) == len(step_counts) and n > 0):
            raise ValueError(
                f"a group needs as many adapters ({n}), batches "
                f"({len(batches_list)}) and step counts "
                f"({len(step_counts)}), at least one")
        steps = max(step_counts)
        if min(step_counts) < 1 or steps > self.max_steps:
            raise ValueError(f"step counts {list(step_counts)} outside "
                             f"1..{self.max_steps}")
        # one host-to-device copy: tokens, labels and budgets in one buffer
        tok = np.stack([b["tokens"][:steps] for b in batches_list])
        lab = np.stack([b["labels"][:steps] for b in batches_list])
        host = np.concatenate([tok.reshape(-1), lab.reshape(-1),
                               np.asarray(step_counts)]).astype(np.int64)
        dev = torch.from_numpy(host).to(self.device)
        tokens = dev[:tok.size].reshape(tok.shape)
        labels = dev[tok.size:tok.size + lab.size].reshape(lab.shape)
        counts = dev[tok.size + lab.size:]

        masks = None
        if layer_masks is not None and any(m is not None
                                           for m in layer_masks):
            rows = [np.ones((self.cfg.num_layers,), np.float32)
                    if m is None else np.asarray(m, np.float32)
                    for m in layer_masks]
            masks = torch.from_numpy(np.stack(rows, axis=1)).to(self.device)

        if all(ad is adapters_list[0] for ad in adapters_list):
            adapters = _broadcast_lanes(adapters_list[0], n)
        else:
            adapters = stack_trees(adapters_list)
        adapters, last = self.train_lanes(params, adapters, tokens, labels,
                                          counts, steps, layer_masks=masks)
        if eval_batch is not None:
            last = torch.cat([last, self.evaluate_lanes(
                params, adapters, eval_batch, n)[None]])
        return adapters, last

    def finetune_group_stacked(self, params, adapters_list: Sequence[Any],
                               batches_list: Sequence[Dict[str, np.ndarray]],
                               step_counts: Sequence[int],
                               eval_batch: Optional[Dict] = None,
                               layer_masks: Optional[Sequence] = None
                               ) -> Tuple[Any, Dict[str, np.ndarray]]:
        """Train one rank group; results stacked.

        adapters_list: per-vehicle adapter trees, all at the same rank
            (one shared tree object is broadcast to every lane).
        batches_list: per-vehicle step batches from :func:`draw_batches`,
            shapes (≥ max(step_counts), B, ...).
        step_counts: per-vehicle number of live local steps
            (≤ max_steps; departing vehicles train fewer).
        layer_masks: per-vehicle (L,) multipliers or None.
        Returns (stacked adapters (L, n, ...), metrics) where metrics
        values are (n,) numpy arrays: the last live step's train metrics,
        plus "eval_accuracy" when eval_batch is given.
        """
        return self.run_jobs(params, [{
            "adapters_list": adapters_list, "batches_list": batches_list,
            "step_counts": step_counts, "eval_batch": eval_batch,
            "layer_masks": layer_masks}])[0]

    def run_jobs(self, params, jobs: Sequence[Dict[str, Any]]
                 ) -> List[Tuple[Any, Dict[str, np.ndarray]]]:
        """Run independent group jobs in order on the current stream and
        return their results in job order, each as
        :meth:`finetune_group_stacked` returns it. The metrics come to
        the host after the last group is enqueued, so no group waits on
        another.

        jobs: dicts with keys adapters_list, batches_list, step_counts
        and optional eval_batch, layer_masks.
        """
        outs = [self._run_group(params, job["adapters_list"],
                                job["batches_list"], job["step_counts"],
                                eval_batch=job.get("eval_batch"),
                                layer_masks=job.get("layer_masks"))
                for job in jobs]
        keys = TRAIN_METRICS + ("eval_accuracy",)
        results = []
        for stacked, dev_metrics in outs:
            host = dev_metrics.cpu().numpy()
            results.append((stacked, {k: host[i] for i, k in
                                      enumerate(keys[:len(host)])}))
        return results
