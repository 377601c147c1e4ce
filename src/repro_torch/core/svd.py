"""Truncated SVD by randomized subspace iteration, port of
``repro/core/svd.py``.

The RSU computes a rank-η_max truncated SVD of each aggregated adapter
delta Δθ ∈ R^{d1×d2} once per round (paper §III-B). Halko, Martinsson &
Tropp's randomized subspace iteration is GEMM-dominated:

    Ω ~ N(0,1)^{d2×(η+p)};  Y = (A Aᵀ)^q A Ω;  Q = qr(Y);
    B = Qᵀ A;  svd(B) (small);  U = Q·Ub.

QR and the small SVD are ``torch.linalg`` calls (the reference leaves
them to XLA as well). A leading batch axis (a layer stack) runs as one
batched call; every matrix of the batch shares the one Ω, as the
reference's vmap over a single seed does.

Ω is an argument. By default it is drawn from a CPU ``torch.Generator``
seeded with ``seed`` and moved to the matrix's device, so one seed gives
one Ω on the card and on the CPU; it is not the reference's
``jax.random`` draw, which a test passes in instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def default_omega(seed: int, d2: int, r: int) -> torch.Tensor:
    """The port's sketch: N(0, 1) of shape (d2, r) from a CPU generator
    seeded with ``seed`` (f32, on the CPU)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn((d2, r), generator=g, dtype=torch.float32)


def sketch_width(rank: int, d1: int, d2: int, oversample: int = 8) -> int:
    """Columns of Ω: rank + oversample, at most min(d1, d2)."""
    return min(rank + oversample, min(d1, d2))


def randomized_svd(a: torch.Tensor, rank: int, *, oversample: int = 8,
                   iters: int = 2, seed: int = 0,
                   omega: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD of a (..., d1, d2) matrix (stack). Returns U (..., d1,
    rank), s (..., rank), Vt (..., rank, d2), in f32. ``omega`` (d2, r)
    with r = :func:`sketch_width` overrides the seeded draw."""
    d1, d2 = a.shape[-2:]
    r = sketch_width(rank, d1, d2, oversample)
    if omega is None:
        omega = default_omega(seed, d2, r)
    if tuple(omega.shape) != (d2, r):
        raise ValueError(f"omega must be ({d2}, {r}), got "
                         f"{tuple(omega.shape)}")
    af = a.float()
    at = af.transpose(-1, -2)
    y = af @ omega.to(device=a.device, dtype=torch.float32)     # (.., d1, r)
    q, _ = torch.linalg.qr(y)
    for _ in range(iters):
        z, _ = torch.linalg.qr(at @ q)                         # (.., d2, r)
        q, _ = torch.linalg.qr(af @ z)
    b = q.transpose(-1, -2) @ af                               # (.., r, d2)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def exact_svd(a: torch.Tensor, rank: int):
    """Oracle for tests: LAPACK SVD truncated to ``rank``."""
    u, s, vt = torch.linalg.svd(a.float(), full_matrices=False)
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def truncation_energy(s: torch.Tensor, rank: int) -> torch.Tensor:
    """Fraction of squared singular mass retained at ``rank``."""
    tot = torch.sum(torch.square(s))
    return torch.sum(torch.square(s[:rank])) / torch.clamp(tot, min=1e-12)
