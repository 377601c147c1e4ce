"""The port's npz pytree checkpoints (``repro_torch.checkpoint.io``)
against the reference's, on the CPU: round trips, key escaping, the
rejected trees, bf16, atomic writes, pruning, and the file format shared
with the reference (each package reads the other's files leaf for leaf).
"""
import os
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro_torch.checkpoint import io


def _tree():
    """Every leaf kind a simulator checkpoint holds."""
    rng = np.random.default_rng(0)
    return {
        "f32": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
        "f64": rng.normal(size=5),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "flags": torch.tensor([True, False, True]),
        "bytes": np.frombuffer(b"meta", np.uint8).copy(),
        "scalar": np.int64(7),
        "zero_d": torch.tensor(2.5),
        "nested": [{"a": torch.ones(2), "b": None},
                   (np.float32(1.5), [torch.zeros(1, dtype=torch.int64)])],
        "none": None,
    }


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _same_structure(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return (a is None) == (b is None)


@pytest.mark.parametrize("as_numpy", [False, True], ids=["torch", "numpy"])
def test_round_trip_keeps_structure_dtypes_and_bits(tmp_path, as_numpy):
    tree = _tree()
    path = str(tmp_path / "t.npz")
    io.save_pytree(path, tree)
    got = io.load_pytree(path, numpy=as_numpy)
    assert _same_structure(tree, got)
    for want, have in zip(_leaves(tree), _leaves(got)):
        assert isinstance(have, np.ndarray if as_numpy else torch.Tensor)
        w, h = _np(want), _np(have)
        assert h.dtype == w.dtype and h.shape == w.shape
        assert np.array_equal(h, w)


def test_entries_are_stored_not_compressed(tmp_path):
    path = str(tmp_path / "t.npz")
    io.save_pytree(path, {"x": torch.zeros(1000)})
    with zipfile.ZipFile(path) as zf:
        assert {i.compress_type for i in zf.infolist()} == {
            zipfile.ZIP_STORED}
        assert sorted(zf.namelist()) == ["__skeleton__.npy", "x.npy"]


@pytest.mark.parametrize("tree, keys", [
    ({"a/b": np.ones(1), "a": {"b": np.zeros(1)}}, {"a%2Fb", "a/b"}),
    ({"x": [np.ones(1)], "x/0": np.zeros(1)}, {"x/0", "x%2F0"}),
    ({"%2F": np.ones(1), "/": np.zeros(1)}, {"%252F", "%2F"}),
], ids=["separator", "list_index", "escape_char"])
def test_keys_are_escaped_so_paths_never_collide(tmp_path, tree, keys):
    leaves, _ = io._flatten(tree)
    assert set(leaves) == keys
    path = str(tmp_path / "t.npz")
    io.save_pytree(path, tree)
    got = io.load_pytree(path, numpy=True)
    for want, have in zip(_leaves(tree), _leaves(got)):
        assert np.array_equal(want, have)


@pytest.mark.parametrize("key", ["__none__", "__leaf__", "__dtype__",
                                 "__list__", "__tuple__"])
def test_reserved_marker_keys_raise(tmp_path, key):
    with pytest.raises(ValueError, match="reserved"):
        io.save_pytree(str(tmp_path / "t.npz"), {"a": {key: np.ones(1)}})


@pytest.mark.parametrize("tree, err, match", [
    ({"__skeleton__": np.ones(1)}, ValueError, "reserved skeleton"),
    (np.ones(3), ValueError, "bare leaf"),
    ({1: np.ones(1)}, TypeError, "must be str"),
], ids=["skeleton_key", "bare_leaf", "int_key"])
def test_bad_trees_raise(tmp_path, tree, err, match):
    with pytest.raises(err, match=match):
        io.save_pytree(str(tmp_path / "t.npz"), tree)
    assert os.listdir(tmp_path) == []


def test_colliding_paths_raise(monkeypatch):
    """The collision assertion behind the escaping: with escaping off, a
    key holding the separator collides with a nested path."""
    monkeypatch.setattr(io, "_esc", lambda k: k)
    with pytest.raises(ValueError, match="collision"):
        io._flatten({"a": {"b": np.ones(1)}, "a/b": np.zeros(1)})
    with pytest.raises(ValueError, match="collision"):
        io._flatten({"a": [np.ones(1)], "a/0": np.zeros(1)})


@pytest.mark.parametrize("as_numpy", [False, True], ids=["torch", "numpy"])
def test_bfloat16_comes_back_as_torch_bfloat16(tmp_path, as_numpy):
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    path = str(tmp_path / "t.npz")
    io.save_pytree(path, {"w": x})
    with np.load(path) as z:
        assert z["w"].dtype == np.float32     # stored upcast
    got = io.load_pytree(path, numpy=as_numpy)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


def test_interrupted_save_leaves_the_previous_file(tmp_path, monkeypatch):
    path = str(tmp_path / "round_000002.npz")
    io.save_pytree(path, {"a": np.ones(3), "b": np.ones(3)})
    before = open(path, "rb").read()
    calls = []

    def dies(leaf):   # killed after the first leaf's entry is written
        calls.append(1)
        if len(calls) > 1:
            raise KeyboardInterrupt("killed mid-write")
        return np.asarray(leaf)
    monkeypatch.setattr(io, "_host", dies)
    with pytest.raises(KeyboardInterrupt):
        io.save_pytree(path, {"a": np.zeros(3), "b": np.zeros(3)})
    assert os.listdir(tmp_path) == ["round_000002.npz"]   # no tmp residue
    assert open(path, "rb").read() == before
    assert np.array_equal(io.load_pytree(path, numpy=True)["a"], np.ones(3))


def test_prune_latest_and_restore_round(tmp_path):
    d = str(tmp_path)
    assert io.latest_checkpoint(d) is None
    assert io.latest_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        io.restore_round(d)
    for r in (2, 4, 10, 6):
        io.save_round(d, r, {"r": np.int64(r)})
    open(os.path.join(d, "notes.txt"), "w").close()
    assert io.latest_checkpoint(d).endswith("round_000010.npz")
    assert io.restore_round(d, numpy=True)[0] == 10
    assert int(io.restore_round(d, 4)[1]["r"]) == 4
    with pytest.raises(FileNotFoundError,
                       match=r"have rounds \[2, 4, 6, 10\]"):
        io.restore_round(d, 3)
    assert io.prune_checkpoints(d, 0) == 0
    assert io.prune_checkpoints(d, 2) == 2
    assert sorted(os.listdir(d)) == ["notes.txt", "round_000006.npz",
                                     "round_000010.npz"]
    assert io.prune_checkpoints(str(tmp_path / "missing"), 1) == 0


def test_reference_reads_a_port_file_leaf_for_leaf(tmp_path):
    tree = dict(_tree(), bf16=torch.tensor([1.5, -2.25]).to(torch.bfloat16))
    path = str(tmp_path / "port.npz")
    io.save_pytree(path, tree)
    got = jio.load_pytree(path, numpy=True)
    assert _same_structure(tree, got)
    for want, have in zip(_leaves(tree), _leaves(got)):
        if isinstance(want, torch.Tensor) and want.dtype == torch.bfloat16:
            assert have.dtype == ml_dtypes.bfloat16
            have = np.asarray(have, np.float32)
        w = _np(want)
        assert have.dtype == w.dtype and np.array_equal(have, w)


def test_port_reads_a_reference_file_leaf_for_leaf(tmp_path):
    """The reference writes compressed entries; the port reads them, and
    its tree equals the reference's own reading."""
    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(2, 2)).astype(np.float32)
    tree = {"ucb": [{"counts": rng.normal(size=(4, 3)).astype(np.float32),
                     "lam": np.float32(0.5)}],
            "servers": [{"key": np.array([0, 7], np.uint32),
                         "merged": None, "partials": [None, {"d": f32}]}],
            "pos": rng.normal(size=(3, 2)), "tick": np.int64(4),
            "flags": np.array([True, False]),
            "bf16": np.array([1.5, 3.0], ml_dtypes.bfloat16),
            "t": (np.arange(3, dtype=np.int64),)}
    path = str(tmp_path / "ref.npz")
    jio.save_pytree(path, tree)
    want = jio.load_pytree(path, numpy=True)
    for as_numpy in (True, False):
        got = io.load_pytree(path, numpy=as_numpy)
        assert _same_structure(want, got)
        for w, g in zip(_leaves(want), _leaves(got)):
            if w.dtype == ml_dtypes.bfloat16:
                assert g.dtype == torch.bfloat16
                w = np.asarray(w, np.float32)
            g = _np(g)
            assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)
