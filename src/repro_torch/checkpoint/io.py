"""Pytree checkpointing on npz, port of ``repro/checkpoint/io.py``.

Flattens a tree of dicts, lists and tuples whose leaves are torch tensors
(on any device), numpy arrays or scalars into path-keyed npz entries; the
structure rides as a JSON skeleton, so load restores the exact tree. The
file layout is the reference's: the ``__skeleton__`` entry and the same
flat keys, so the reference's ``load_pytree`` reads a file written here
and this module reads the reference's.

Format notes:
  * dict keys are escaped (``%`` → ``%25``, ``/`` → ``%2F``) before joining
    with the ``/`` separator, so a key containing the separator (or a
    numeric key next to a list index) can never collide with another leaf's
    flat path; a defensive collision assertion backs the escaping.
  * writes are atomic (tmp file + ``os.replace``): a checkpoint killed
    mid-write never leaves a truncated npz behind — the previous
    checkpoint stays the latest valid one.
  * entries are stored, not compressed (the reference writes
    ``np.savez_compressed``; ``np.load`` reads either). Each leaf comes to
    the host when its entry is written and is dropped after, so a tree on
    a card is never copied whole, on the card or on the host.
  * bfloat16 leaves are stored upcast to float32 (npz has no bf16 dtype);
    the skeleton records the original dtype and load casts back to
    ``torch.bfloat16`` (bf16 ⊂ f32, exact). Load returns CPU torch
    tensors in the recorded dtypes, or with ``numpy=True`` numpy arrays
    (float64 and int64 stay 64-bit, as a bit-exact restore of the host's
    RNG and mobility state needs); a bf16 leaf comes back as a
    ``torch.bfloat16`` tensor either way.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_SKELETON_KEY = "__skeleton__"
# structure markers inside the JSON skeleton; a user dict key with one of
# these names would be misread as structure on load, so reject at save
_RESERVED_KEYS = ("__none__", "__leaf__", "__dtype__", "__list__",
                  "__tuple__")


def _esc(key: str) -> str:
    """Escape a dict key for use inside a flat `/`-joined path."""
    return key.replace("%", "%25").replace(_SEP, "%2F")


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (``bfloat16`` for torch's)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _host(leaf) -> np.ndarray:
    """One leaf as a host numpy array (bf16 upcast to f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Tuple[Dict[str, Any], Any]:
    """Returns (leaves dict, skeleton). Skeleton mirrors the tree with leaf
    positions replaced by the flat key string; the leaves stay where they
    are (a tensor on a card is read when its entry is written)."""
    if isinstance(tree, dict):
        leaves, skel = {}, {}
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(
                    f"dict keys must be str for npz checkpointing, got "
                    f"{k!r} ({type(k).__name__}) under {prefix!r}")
            if k in _RESERVED_KEYS:
                raise ValueError(
                    f"dict key {k!r} (under {prefix!r}) collides with a "
                    "reserved skeleton marker; rename it")
            ek = _esc(k)
            sub_l, sub_s = _flatten(tree[k],
                                    f"{prefix}{_SEP}{ek}" if prefix else ek)
            for fk in sub_l:
                if fk in leaves:   # escaping makes paths injective; keep a
                    raise ValueError(   # loud assertion anyway
                        f"flat key collision at {fk!r} (under {prefix!r})")
            leaves.update(sub_l)
            skel[k] = sub_s
        return leaves, skel
    if isinstance(tree, (list, tuple)):
        leaves, skel = {}, []
        for i, v in enumerate(tree):
            sub_l, sub_s = _flatten(v, f"{prefix}{_SEP}{i}" if prefix else
                                    str(i))
            for fk in sub_l:
                if fk in leaves:
                    raise ValueError(
                        f"flat key collision at {fk!r} (under {prefix!r})")
            leaves.update(sub_l)
            skel.append(sub_s)
        return leaves, {"__list__": skel,
                        "__tuple__": isinstance(tree, tuple)}
    if tree is None:
        return {}, {"__none__": True}
    if not isinstance(tree, (torch.Tensor, np.ndarray)):
        tree = np.asarray(tree)
    dtype = _dtype_name(tree)
    if not prefix:
        raise ValueError("cannot checkpoint a bare leaf; wrap it in a "
                         "dict/list/tuple")
    if prefix == _SKELETON_KEY:
        raise ValueError(
            f"flat key {prefix!r} collides with the reserved skeleton "
            "entry; rename the top-level dict key")
    return {prefix: tree}, {"__leaf__": prefix, "__dtype__": dtype}


def _unflatten(skel: Any, leaves: Dict[str, np.ndarray],
               numpy: bool = False) -> Any:
    if isinstance(skel, dict):
        if skel.get("__none__"):
            return None
        if "__leaf__" in skel:
            arr = leaves[skel["__leaf__"]]
            dtype = skel.get("__dtype__")
            if dtype == "bfloat16":
                return torch.from_numpy(
                    np.asarray(arr, np.float32)).to(torch.bfloat16)
            if dtype is not None:
                arr = arr.astype(dtype, copy=False)
            if numpy or arr.dtype.kind not in "biufc":
                return arr   # (a string leaf has no torch dtype)
            return torch.from_numpy(arr)
        if "__list__" in skel:
            items = [_unflatten(s, leaves, numpy) for s in skel["__list__"]]
            return tuple(items) if skel.get("__tuple__") else items
        return {k: _unflatten(v, leaves, numpy) for k, v in skel.items()}
    raise ValueError(f"bad skeleton node {skel!r}")


def _write_npz(f, skel: Any, leaves: Dict[str, Any]) -> None:
    """``np.savez``'s layout (one ``<key>.npy`` member per entry, stored),
    each leaf brought to the host just before its member is written."""
    with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        def put(key: str, arr: np.ndarray) -> None:
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, arr, allow_pickle=False)
        put(_SKELETON_KEY, np.asarray(json.dumps(skel)))
        for key, leaf in leaves.items():
            put(key, _host(leaf))


def save_pytree(path: str, tree: Any) -> None:
    """Atomically write `tree` to `path` (tmp file + rename): a writer
    killed mid-save never clobbers or truncates an existing checkpoint."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    leaves, skel = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            _write_npz(f, skel, leaves)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, *, numpy: bool = False) -> Any:
    """Restore the exact tree saved by :func:`save_pytree` (or by the
    reference's). numpy=False (default): CPU torch tensors in the recorded
    dtypes; numpy=True: numpy arrays in the recorded dtypes. bf16 leaves
    come back as ``torch.bfloat16`` tensors either way."""
    with np.load(path, allow_pickle=False) as z:
        skel = json.loads(str(z[_SKELETON_KEY]))
        leaves = {k: z[k] for k in z.files if k != _SKELETON_KEY}
    return _unflatten(skel, leaves, numpy=numpy)


def save_round(ckpt_dir: str, round_idx: int, state: Any) -> str:
    path = os.path.join(ckpt_dir, f"round_{round_idx:06d}.npz")
    save_pytree(path, state)
    return path


def restore_round(ckpt_dir: str, round_idx: Optional[int] = None,
                  *, numpy: bool = False) -> Tuple[int, Any]:
    if round_idx is None:
        path = latest_checkpoint(ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        round_idx = int(re.search(r"round_(\d+)", path).group(1))
    else:
        path = os.path.join(ckpt_dir, f"round_{round_idx:06d}.npz")
        if not os.path.exists(path):
            have = sorted(
                int(m.group(1)) for m in (
                    re.fullmatch(r"round_(\d+)\.npz", f)
                    for f in (os.listdir(ckpt_dir)
                              if os.path.isdir(ckpt_dir) else []))
                if m)
            raise FileNotFoundError(
                f"no checkpoint for round {round_idx} in {ckpt_dir} "
                f"(have rounds {have})")
    return round_idx, load_pytree(path, numpy=numpy)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if re.fullmatch(r"round_\d+\.npz", f))
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> int:
    """Delete all but the newest `keep_last` round checkpoints (by round
    index). keep_last <= 0 keeps everything. Returns the number removed."""
    if keep_last <= 0 or not os.path.isdir(ckpt_dir):
        return 0
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if re.fullmatch(r"round_\d+\.npz", f))
    removed = 0
    for f in cands[:-keep_last]:
        os.unlink(os.path.join(ckpt_dir, f))
        removed += 1
    return removed
