"""Mesh descriptions, port of ``repro/launch/mesh.py``.

A mesh here is a description: its axis names and sizes, which is all the
sharding rules (:mod:`repro_torch.launch.sharding`) read, and, for a
mesh of one device, that device. Functions, not module constants, so
importing this module touches no device state and no
``torch.distributed``.

Mesh semantics (as the reference's): ``pod`` = task/RSU federation
instance, ``data`` = vehicles' client shards (data parallel), ``model``
= tensor/expert parallel within a client group; ``fleet`` = the fused
round engine's vehicle-lane axis.

A mesh of one device runs: every spec then places the whole tensor on
that device. The fleet mesh runs over any number of devices: it records
its ``devices`` (repeats allowed, so two shards may share one card, and
``["cpu"] * N`` runs N shards in one CPU process), and the fused engine
places shard i on ``devices[i]`` from one controlling process
(``federated/fused_engine.py``). Asking for more devices than are
visible raises ``ValueError``, as the reference does; any other mesh
over more than one device (model parallelism) raises
``NotImplementedError``: it is ROADMAP Queue 1, item 12b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.runmode import resolve_device

MULTI_DEVICE = ("a model-parallel mesh over more than one device is not "
                "ported yet; the port runs one-device meshes and the "
                "fleet mesh (ROADMAP Queue 1, item 12b)")


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``device`` is the one device of a placed
    one-device mesh, or the first (home) device of a fleet mesh (None for
    a description that places nothing); ``devices`` a fleet mesh's
    devices in mesh order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def visible_devices(device) -> int:
    """Devices a mesh on ``device``'s type may use: the visible cards, or
    one CPU (as JAX's CPU backend shows one device unless forced)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _placed(device) -> torch.device:
    """``device`` resolved, a card with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` on ``device``'s type."""
    n = 1
    for s in shape:
        n *= int(s)
    have = visible_devices(device)
    if n > have:
        raise ValueError(
            f"mesh {tuple(shape)} wants {n} devices but only {have} are "
            "visible")
    if n > 1:
        raise NotImplementedError(MULTI_DEVICE)
    dev = _placed(device)
    return Mesh(tuple(axis_names), tuple(int(s) for s in shape), dev)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_fleet_mesh(num_shards: int = 0, *, axis_name: str = "fleet",
                    device="cuda", devices: Optional[Sequence] = None
                    ) -> Mesh:
    """1-D mesh over the IoV fleet axis. Without ``devices`` it takes the
    first ``num_shards`` visible devices of ``device``'s type (0: all of
    them; one CPU); asking for more than are visible raises, as the
    reference does. ``devices`` is an explicit list, repeats allowed
    (``["cpu"] * 4``, or one card twice); the mesh takes its first
    ``num_shards`` (0: all)."""
    if devices is not None:
        devs = tuple(_placed(d) for d in devices)
        n = num_shards or len(devs)
        if not devs or n > len(devs):
            raise ValueError(f"fleet mesh wants {n} devices but "
                             f"{len(devs)} were given")
        devs = devs[:n]
    else:
        have = visible_devices(device)
        n = num_shards or have
        if n > have:
            raise ValueError(
                f"fleet mesh wants {n} devices but only {have} are visible")
        dev = _placed(device)
        devs = ((dev,) * n if dev.type == "cpu" or n == 1 else
                tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((axis_name,), (n,), devs[0], devs)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
