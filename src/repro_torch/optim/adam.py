"""Functional optimizers over tensor trees, port of ``repro/optim/adam.py``.

Optax-style ``(init, update)`` pairs on trees of dicts, lists and tuples
of tensors, with the reference's state tree (``AdamState(step, mu, nu)``,
step an int32 scalar) and its operations in its order, so the same
gradients give the same updates (``torch.optim`` orders the Adam update
differently). Used for local fine-tuning on the LoRA adapter tree only.
Nothing here updates in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.interop import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Optional[Any]], Tuple[Any, Any]]


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: torch.Tensor
    vel: Any


def _tmap(f, *trees):
    if len(trees) == 1:
        return tree_map(f, trees[0])
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tmap(f, *xs) for xs in zip(*trees))
    return f(*trees)


def leaves(tree) -> list:
    """Tensor leaves of a tree, in the tree's order (dict insertion
    order, the reference's for trees built the same way)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat) -> Any:
    """A tree shaped like ``like`` with the leaves of ``flat`` (a list in
    :func:`leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _step0(tree) -> torch.Tensor:
    """The int32 step counter, on the device of the tree's leaves."""
    flat = leaves(tree)
    return torch.zeros((), dtype=torch.int32,
                       device=flat[0].device if flat else "cpu")


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = _tmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(step=_step0(params), mu=z,
                         nu=_tmap(torch.clone, z))

    def update(grads, state, params=None):
        step = state.step + 1
        mu = _tmap(lambda m, g: b1 * m + (1 - b1) * g.float(),
                   state.mu, grads)
        nu = _tmap(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                   state.nu, grads)
        stepf = step.float()
        # b ** step in f32, as the reference's; full_like fills on the
        # step's device (no host to device copy)
        bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
        bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)
        lr_t = lr_fn(step)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype if p is not None else u.dtype)

        if params is None:
            updates = _tmap(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = _tmap(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return SGDState(step=_step0(params),
                        vel=_tmap(torch.zeros_like, params))

    def update(grads, state, params=None):
        step = state.step + 1
        vel = _tmap(lambda v, g: momentum * v + g, state.vel, grads)
        updates = _tmap(lambda v: -lr_fn(step) * v, vel)
        return updates, SGDState(step=step, vel=vel)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return _tmap(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return _tmap(lambda g: g * factor, grads), n
