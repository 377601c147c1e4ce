"""Partition rules, port of ``repro/launch/sharding.py``: a spec per leaf
path, as a pure function of the path, the leaf's shape and the mesh's
axis sizes.

Scheme (Megatron-style TP over ``model``, DP over ``pod`` x ``data``):
  - attention qkv / MLP up|gate: columns (out features) over ``model``
  - attention o / MLP down: rows (in features) over ``model``
  - MoE experts: expert axis over ``model`` (expert parallel)
  - embeddings / lm_head: vocab over ``model`` (sharded logits)
  - norms, scalars, small low-rank factors: replicated
  - LoRA adapters: replicated (they are tiny: η·(d1+d2)); per-expert
    adapters follow the expert sharding
  - batch: over (``pod``, ``data``); optional Megatron-SP sequence
    sharding of the residual stream over ``model`` inside the layers

A spec is the port's counterpart of a ``PartitionSpec``: a tuple with an
entry per dimension it names, each an axis name, a tuple of axis names
or None; ``()`` replicates. Entries are canonical, as a
``PartitionSpec``'s are: a tuple of one name is that name, an empty
tuple is None (:func:`spec`). A path is a tuple of dict keys and list
indices. The ``*_shardings`` functions return a tree of specs shaped
like their input. A mesh is anything with ``axis_names`` and a ``shape``
mapping of axis sizes (:class:`repro_torch.launch.mesh.Mesh`); the rules
read nothing else. The fleet rules also apply over more than one
device: on a fleet mesh (:func:`repro_torch.launch.mesh.make_fleet_mesh`)
:func:`fleet_constrainer` splits fleet-stacked trees into the lanes each
shard holds, on its device. The other constraint functions over more
than one device are ROADMAP Queue 1, item 12b: there they raise
``NotImplementedError``, and nothing silently replicates.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.launch.mesh import MULTI_DEVICE

Spec = Tuple[Any, ...]


def spec(*entries) -> Spec:
    """A spec from its entries, canonical as a ``PartitionSpec``'s."""
    def one(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(one(e) for e in entries)


def _path_str(path) -> str:
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                  path: tuple = ()) -> Any:
    """fn(path, leaf) over a tree of dicts, lists, tuples and named
    tuples (paths hold dict keys, list indices and field names)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _mesh_devices(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def _one_device(mesh) -> bool:
    return mesh is None or _mesh_devices(mesh) == 1


# ---------------------------------------------------------------------------
# path → spec rules
# ---------------------------------------------------------------------------

# (regex over path, rule). Specs are written for the UNSTACKED 2-D
# weight; leading stacked axes (layers, experts) are padded with None on
# the left, except expert weights which pin the expert axis.
_COL = "col"        # shard last axis over model
_ROW = "row"        # shard second-to-last axis over model
_EXPERT = "expert"  # shard expert axis (position -3 of w, -4 of stacked)
_VOCAB_IN = "vocab_in"   # (V, d) → shard V
_REPL = "repl"

_RULES: Tuple[Tuple[str, str], ...] = (
    (r"embed$", _VOCAB_IN),
    (r"lm_head/w$", _COL),
    # attention
    (r"attn/(q|k|v)/(w|b)$", _COL),
    (r"attn/o/w$", _ROW),
    # MLA: latent down-projections replicated (small), up/q sharded on heads
    (r"mla/(kv_down|q_down)/w$", _REPL),
    (r"mla/(kv_up|q_up|q)/w$", _COL),
    (r"mla/o/w$", _ROW),
    # dense MLP
    (r"mlp/(up|gate)/w$", _COL),
    (r"mlp/down/w$", _ROW),
    # MoE
    (r"moe/router/w$", _REPL),
    (r"moe/w_(up|gate|down)$", _EXPERT),
    (r"moe/shared/(up|gate)/w$", _COL),
    (r"moe/shared/down/w$", _ROW),
    # mamba2: shard the fused in-proj columns and out-proj rows
    (r"mamba/in_proj/w$", _COL),
    (r"mamba/out_proj/w$", _ROW),
    (r"mamba/(conv_w|conv_b|a_log|d_skip|dt_bias)$", _REPL),
    # rwkv6
    (r"rwkv/w_(r|k|v)/w$", _COL),
    (r"rwkv/w_o/w$", _ROW),
    (r"rwkv/ck/w$", _COL),
    (r"rwkv/cv/w$", _ROW),
    (r"rwkv/cr/w$", _COL),
    (r"rwkv/(gate_a|gate_b|decay_a|decay_b|mu_.*|w0|u_bonus)$", _REPL),
    # norms and everything else small
    (r".*", _REPL),
)


def _rule_for(path_s: str) -> str:
    for pat, rule in _RULES:
        if re.search(pat, path_s):
            return rule
    return _REPL


def param_spec(path, leaf, *, is_adapter: bool = False,
               model_size: int = 16) -> Spec:
    path_s = _path_str(path)
    nd = leaf.ndim
    if is_adapter:
        # per-expert adapters (L, E, d, r)/(L, E, r, d): shard expert axis
        if (nd == 4 and re.search(r"moe/w_(up|gate|down)", path_s)
                and leaf.shape[1] % model_size == 0):
            return (None, "model", None, None)
        return ()  # adapters are tiny — replicate
    rule = _rule_for(path_s)
    if rule == _REPL:
        return ()
    if rule == _VOCAB_IN:
        return tuple([None] * (nd - 2) + ["model", None])
    if rule == _COL:
        if nd == 1:   # stacked bias (d,) — can't tell; replicate
            return ()
        return tuple([None] * (nd - 1) + ["model"])
    if rule == _ROW:
        return tuple([None] * (nd - 2) + ["model", None])
    if rule == _EXPERT:
        # (L, E, d, f) or (E, d, f): E % model == 0 → expert-parallel (E
        # over model, ff over data, FSDP of the frozen experts); else
        # (grok E=8) → ff over model, d over data.
        if leaf.shape[-3] % model_size == 0:
            if re.search(r"w_down$", path_s):   # (E, f, d)
                return tuple([None] * (nd - 3) + ["model", "data", None])
            return tuple([None] * (nd - 3) + ["model", None, "data"])
        if re.search(r"w_down$", path_s):       # (E, f, d)
            return tuple([None] * (nd - 3) + [None, "model", "data"])
        return tuple([None] * (nd - 3) + [None, "data", "model"])
    raise ValueError(rule)


def tree_shardings(mesh, tree: Any, *, is_adapter: bool = False):
    """Spec tree matching ``tree`` (tensors, meta tensors included)."""
    msize = mesh.shape["model"]

    def f(path, leaf):
        s = param_spec(path, leaf, is_adapter=is_adapter, model_size=msize)
        # drop shardings that do not divide the leaf evenly (safety net for
        # small reduced configs; production dims are 128-aligned)
        dims = leaf.shape
        ok = True
        for i, ax in enumerate(s):
            if ax is None:
                continue
            sz = mesh.shape[ax] if isinstance(ax, str) else 1
            if i < len(dims) and dims[i] % sz != 0:
                ok = False
        return s if ok else ()
    return map_with_path(f, tree)


# ---------------------------------------------------------------------------
# Fleet-axis rules (fused IoV round engine)
#
# The fused engine's arrays carry the vehicle-lane axis at a known position:
# axis 0 for fleet-stacked adapter/optimizer trees and per-vehicle tables,
# axis 1 for (T, V) per-task views, deeper when a scan axis is prepended.
# Everything else (model params, merged deltas, per-task scalars) replicates.
# ---------------------------------------------------------------------------

def fleet_spec(ndim: int, *, axis_pos: int = 0,
               axis_name: str = "fleet") -> Spec:
    """Spec sharding dimension ``axis_pos`` over the fleet axis."""
    return tuple(axis_name if i == axis_pos else None for i in range(ndim))


def fleet_shardings(mesh, tree: Any, *, axis_pos: int = 0,
                    axis_name: str = "fleet",
                    fleet_size: Optional[int] = None):
    """Spec tree for fleet-stacked arrays: a leaf shards dimension
    ``axis_pos`` over ``axis_name`` when that dimension exists, divides
    the mesh axis evenly, and (if ``fleet_size`` is given) actually IS
    the fleet axis; every other leaf replicates."""
    n = mesh.shape[axis_name]

    def f(_, leaf):
        shape = getattr(leaf, "shape", ())
        if (len(shape) <= axis_pos or shape[axis_pos] % n != 0
                or (fleet_size is not None
                    and shape[axis_pos] != fleet_size)):
            return ()
        return fleet_spec(len(shape), axis_pos=axis_pos, axis_name=axis_name)
    return map_with_path(f, tree)


def fleet_lanes(mesh, fleet_size: int, *,
                axis_name: str = "fleet") -> List[range]:
    """The lanes each shard of a fleet mesh holds: N contiguous blocks of
    ``fleet_size / N`` (the reference's mesh splits the slot axis so)."""
    n = mesh.shape[axis_name]
    if fleet_size % n:
        raise ValueError(f"a fleet of {fleet_size} lanes does not split "
                         f"evenly over {n} shards")
    per = fleet_size // n
    return [range(i * per, (i + 1) * per) for i in range(n)]


def fleet_constrainer(mesh, fleet_size: int, *,
                      axis_name: str = "fleet") -> Callable[[Any], Any]:
    """Constraint fn placing fleet-stacked trees on the fleet mesh: the
    identity with ``mesh=None`` or on one device (one device holds every
    lane). On a fleet mesh over N > 1 devices it splits a tree into a
    list of N trees, shard i's holding its lanes (:func:`fleet_lanes`) of
    every leaf whose lane axis has ``fleet_size`` entries, on
    ``mesh.devices[i]``, and a copy of every other leaf there. A leaf's
    lane axis is its first for vectors and (V, K) tables, and third from
    the end for stacked trees (where the port stacks adapters' lanes).
    Any other mesh over more than one device raises."""
    if _one_device(mesh):
        return lambda tree: tree
    if (tuple(mesh.axis_names) != (axis_name,)
            or getattr(mesh, "devices", None) is None):
        raise NotImplementedError(MULTI_DEVICE)
    blocks = fleet_lanes(mesh, fleet_size, axis_name=axis_name)

    def constrain(tree):
        def shard(i):
            lanes, dev = blocks[i], mesh.devices[i]

            def leaf(_, x):
                if not hasattr(x, "narrow"):
                    return x
                ax = 0 if x.dim() < 3 else -3
                if x.dim() and x.shape[ax] == fleet_size:
                    x = x.narrow(ax, lanes.start, len(lanes))
                return x.to(dev)
            return map_with_path(leaf, tree)
        return [shard(i) for i in range(len(blocks))]
    return constrain


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _dp_for(mesh, batch_size: int):
    """Largest prefix of the dp axes that divides ``batch_size`` (long_500k
    has global_batch=1 — the batch axis cannot shard, data parallelism is
    idle and the cache seq axis is sharded instead, see cache_spec)."""
    axes = []
    n = 1
    for a in batch_axes(mesh):
        if batch_size % (n * mesh.shape[a]) == 0:
            axes.append(a)
            n *= mesh.shape[a]
    return tuple(axes) if axes else None


def batch_spec(mesh, ndim: int, batch_size: int) -> Spec:
    dp = _dp_for(mesh, batch_size)
    return spec(dp, *(None,) * (ndim - 1))


def batch_shardings(mesh, batch_tree: Any):
    return map_with_path(
        lambda _, leaf: batch_spec(mesh, leaf.ndim, leaf.shape[0]),
        batch_tree)


def cache_spec(path, leaf, mesh) -> Spec:
    """KV caches: (L, B, S, Hkv, hd) — batch over dp axes, heads over
    model when divisible (else the sequence, else head_dim, else
    replicate). SSM states: (L, B, H, P, N) — batch over dp, heads over
    model when divisible. When the batch itself is too small for the dp
    axes (long_500k B=1), the cache *sequence* axis takes the dp sharding
    instead — context-parallel cache residency."""
    path_s = _path_str(path)
    nd = leaf.ndim
    msize = mesh.shape["model"]
    dpsz = _dp_size(mesh)

    def batch_or_none(b):
        return _dp_for(mesh, b)

    if nd >= 4:
        # heads axis heuristics: axis -2 for kv caches (L,B,S,H,hd);
        # axis -3 for ssm states (L,B,H,P,N); wkv (L,B,H,K,V)
        if re.search(r"(^|/)(k|v)$", path_s):
            b, s, h, hd = leaf.shape[-4], leaf.shape[-3], leaf.shape[-2], \
                leaf.shape[-1]
            dp = batch_or_none(b)
            seq_axes = []
            seq_div = 1
            if dp is None and s % dpsz == 0:
                seq_axes += list(batch_axes(mesh))   # B too small: seq takes dp
                seq_div *= dpsz
            if h % msize == 0:          # shard kv heads
                tail = ["model", None]
            elif s % (seq_div * msize) == 0:
                # heads don't divide (GQA/MQA small-kv): context-parallel,
                # the cache SEQ over `model`
                seq_axes.append("model")
                tail = [None, None]
            elif hd % msize == 0:       # last resort: head_dim (psum)
                tail = [None, "model"]
            else:
                tail = [None, None]
            seq = tuple(seq_axes) if seq_axes else None
            out = [None, dp, seq] + tail
            return spec(*(out[-nd:] if nd == 5 else out[1:]))
        if re.search(r"(ssm|wkv)$", path_s):
            b, h = leaf.shape[-4], leaf.shape[-3]
            dp = batch_or_none(b)
            out = [None, dp, "model" if h % msize == 0 else None, None,
                   None]
            return spec(*(out[-nd:] if nd == 5 else out[1:]))
    if re.search(r"(c_kv|k_rope|pos)$", path_s):  # (L,B,S,·) / (L,B,S)
        b = leaf.shape[1] if nd >= 3 else leaf.shape[0]
        s = leaf.shape[2] if nd >= 3 else None
        dp = batch_or_none(b)
        seq = None
        if dp is None and s is not None and s % dpsz == 0:
            seq = batch_axes(mesh)
        out = [None, dp, seq] + [None] * (nd - 3)
        return spec(*out[:nd]) if nd >= 3 else (None,) * nd
    # conv tails, token-shift states: batch over dp (axis 1 when stacked)
    if nd >= 2:
        dp = batch_or_none(leaf.shape[1])
        return spec(None, dp, *[None] * (nd - 2))
    return ()


def cache_shardings(mesh, cache_tree: Any):
    return map_with_path(lambda p, leaf: cache_spec(p, leaf, mesh),
                         cache_tree)


def make_constrain(mesh, seq_shard: bool):
    """Residual-stream constraint fn for ``forward(constrain=...)``.

    seq_shard=True is Megatron-SP, (B, S, d) sharded (dp, model, None);
    False shards the batch only. With ``mesh=None`` or on one device the
    whole stream lives on that device, so the constraint is the identity;
    a mesh over more than one device raises."""
    if _one_device(mesh):
        return lambda x: x
    raise NotImplementedError(MULTI_DEVICE)


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and hasattr(
            tree, "_fields") else tree[k]
    return tree


def placement_errors(mesh, tree: Any, specs: Any, device) -> list:
    """Where the leaves of ``tree`` do not sit as their specs (a spec
    tree shaped like ``tree``) place them on a one-device mesh: a spec
    names at most the leaf's dimensions, and the whole leaf lies on the
    mesh's device (``device`` for a mesh without one, or ``mesh=None``).
    Returns one message per misplaced leaf."""
    if not _one_device(mesh):
        raise NotImplementedError(MULTI_DEVICE)
    want = getattr(mesh, "device", None) or device
    bad = []

    def check(path, leaf):
        s = _at(specs, path)
        if len(s) > leaf.ndim:
            bad.append(f"{_path_str(path)}: spec {s} for a "
                       f"{leaf.ndim}-d leaf")
        if leaf.device != want:
            bad.append(f"{_path_str(path)} on {leaf.device}, want {want}")
        return leaf
    map_with_path(check, tree)
    return bad
