"""Synthetic perception-task generators, port of ``repro/data/synthetic.py``
(numpy only, the same calls in the same order, so one seed gives the
reference's data bit for bit).

The container has no Road-Traffic/Cityscapes/TSRD data (DESIGN.md §4), so the
three paper tasks (OD / SS / TC) are modelled as class-conditional token
classification problems with *controllable difficulty*: each class draws
tokens from a distinct distribution over the vocabulary; the temperature and
class count set how hard the decision problem is. What the paper's
contribution needs from the data is exactly (i) learnable accuracy dynamics
and (ii) per-task difficulty heterogeneity — both explicit knobs here.

Difficulty ordering mirrors the paper's Fig. 5 narrative: SS (easy),
OD (medium), TC (hard).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class TaskSpec:
    name: str
    num_classes: int
    seq_len: int
    vocab_size: int
    temperature: float       # lower = more separable = easier
    samples_per_class: int
    signal_tokens: int       # how many vocab slots carry class signal


DEFAULT_TASKS: Tuple[TaskSpec, ...] = (
    TaskSpec("SS", num_classes=6, seq_len=24, vocab_size=64,
             temperature=0.9, samples_per_class=120, signal_tokens=10),
    TaskSpec("OD", num_classes=10, seq_len=24, vocab_size=64,
             temperature=1.4, samples_per_class=120, signal_tokens=8),
    TaskSpec("TC", num_classes=14, seq_len=24, vocab_size=64,
             temperature=2.0, samples_per_class=120, signal_tokens=6),
)


def make_task(spec: TaskSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns {"tokens": (N, S) int32, "labels": (N,) int32} train and a
    held-out eval split (80/20)."""
    rng = np.random.default_rng(seed)
    # class-conditional token distributions: each class boosts a random
    # subset of `signal_tokens` vocab entries
    logits = np.zeros((spec.num_classes, spec.vocab_size), np.float64)
    for c in range(spec.num_classes):
        idx = rng.choice(spec.vocab_size, spec.signal_tokens, replace=False)
        logits[c, idx] = 3.0
    probs = np.exp(logits / spec.temperature)
    probs /= probs.sum(-1, keepdims=True)

    n = spec.num_classes * spec.samples_per_class
    labels = np.repeat(np.arange(spec.num_classes), spec.samples_per_class)
    rng.shuffle(labels)
    tokens = np.stack([
        rng.choice(spec.vocab_size, spec.seq_len, p=probs[c])
        for c in labels])
    n_tr = int(0.8 * n)
    return {
        "tokens": tokens[:n_tr].astype(np.int32),
        "labels": labels[:n_tr].astype(np.int32),
        "eval_tokens": tokens[n_tr:].astype(np.int32),
        "eval_labels": labels[n_tr:].astype(np.int32),
    }
