"""Vehicle-side local fine-tuning, port of ``repro/federated/client.py``.

Adam on the LoRA adapter tree only; the base stays frozen and is never
differentiated. One train step is ``loss_fn`` on the adapters,
``torch.autograd.grad`` with respect to the adapter leaves, the FedRA
layer mask, then the reference's functional Adam. PyTorch runs eagerly,
so there is nothing to compile per rank: on a card every targeted linear
of the forward launches ``lora_matmul`` and every attention launches
``flash_attention``; the backward runs plain PyTorch (the closed-form
LoRA gradients and the attention recompute), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import LoRAConfig, ModelConfig
from repro_torch.core.lora import tree_rank
from repro_torch.data.pipeline import ClientDataset
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device
from repro_torch.optim import adam, apply_updates
from repro_torch.optim.adam import leaves, unflatten


def refuse_unstacked_adapters(cfg: ModelConfig) -> None:
    """The serial and batched trainers multiply the FedRA layer mask,
    reshaped (L, 1, ...), into every adapter gradient. zamba2's shared
    block's adapters have no layer axis, and the reference's trainers
    fail on them (ROADMAP Queue 3, fault 8); the port refuses before a
    broadcast can go wrong, or silently right where L equals a width."""
    if cfg.shared_attn_every:
        raise ValueError(
            f"{cfg.name}: the serial and batched trainers multiply the "
            "FedRA layer mask into every adapter gradient, and zamba2's "
            "shared attention adapters have no layer axis; the reference "
            "fails there too (repro/federated/client.py:44-46, "
            "batched_client.py:185; ROADMAP Queue 3, fault 8)")


class LocalTrainer:
    def __init__(self, cfg: ModelConfig, lora: LoRAConfig, lr: float = 1e-3,
                 device="cuda"):
        self.cfg = cfg
        self.lora = lora
        self.lr = lr
        self.device = resolve_device(device)
        self.opt = adam(lr)

    def _lora_at(self, rank: int) -> LoRAConfig:
        return dataclasses.replace(self.lora, rank=rank)

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """numpy int batch → int64 tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64
                                   ).to(self.device)
                for k, v in batch.items()}

    def train_step(self, params, adapters, opt_state, batch, layer_mask
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        """One local update. batch: tensors from :meth:`_batch`;
        layer_mask: (L,) multipliers of each leaf's leading layer axis.
        Returns (adapters, opt_state, metrics) with detached tensors."""
        refuse_unstacked_adapters(self.cfg)
        lora_r = self._lora_at(tree_rank(adapters))
        ad = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
        loss, metrics = T.loss_fn(params, ad, self.cfg, lora_r, batch)
        grads = torch.autograd.grad(loss, leaves(ad))
        # FedRA: only the allocated layers train this round
        grads = [g * layer_mask.reshape((-1,) + (1,) * (g.dim() - 1))
                 for g in grads]
        grads = unflatten(adapters, grads)
        updates, opt_state = self.opt.update(grads, opt_state, adapters)
        adapters = apply_updates(adapters, updates)
        return adapters, opt_state, {k: v.detach() for k, v in
                                     metrics.items()}

    def finetune(self, params, adapters, dataset: Optional[ClientDataset],
                 steps: int, eval_batch: Optional[Dict] = None,
                 layer_mask: Optional[np.ndarray] = None,
                 batches: Optional[Sequence[Dict]] = None
                 ) -> Tuple[Any, Dict[str, float]]:
        """Runs ``steps`` local updates; returns (new_adapters, metrics).
        layer_mask: (L,) multipliers (FedRA trains only its allocated
        layers). batches: optional pre-drawn per-step batches in place of
        ``dataset.next_batch()``."""
        opt_state = self.opt.init(adapters)
        if layer_mask is None:
            layer_mask = torch.ones((self.cfg.num_layers,),
                                    dtype=torch.float32, device=self.device)
        else:
            layer_mask = torch.as_tensor(np.asarray(layer_mask, np.float32)
                                         ).to(self.device)
        last: Dict[str, torch.Tensor] = {}
        for si in range(steps):
            batch = batches[si] if batches is not None else \
                dataset.next_batch()
            adapters, opt_state, last = self.train_step(
                params, adapters, opt_state, self._batch(batch), layer_mask)
        out = {k: float(v) for k, v in last.items()}
        if eval_batch is not None:
            out["eval_accuracy"] = self.evaluate(params, adapters,
                                                 eval_batch)["accuracy"]
        return adapters, out

    def warmup(self, params, ranks, example_batch: Dict,
               eval_batch: Optional[Dict] = None) -> None:
        """One train step (and eval) per rank on fresh adapters, so later
        timings hold no first-call costs (kernel loading, allocator
        growth)."""
        lm = torch.ones((self.cfg.num_layers,), dtype=torch.float32,
                        device=self.device)
        batch = self._batch(example_batch)
        for r in ranks:
            ad = tree_map(lambda t: t.to(self.device), T.init_adapters(
                self.cfg, self.lora, seed=0, rank=r, device="cpu"))
            ad, _, _ = self.train_step(params, ad, self.opt.init(ad), batch,
                                       lm)
            if eval_batch is not None:
                self.evaluate(params, ad, eval_batch)

    def evaluate(self, params, adapters, batch: Dict) -> Dict[str, float]:
        lora_r = self._lora_at(tree_rank(adapters))
        with torch.no_grad():
            _, m = T.loss_fn(params, adapters, self.cfg, lora_r,
                             self._batch(batch))
        return {k: float(v) for k, v in m.items()}
