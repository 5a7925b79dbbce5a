"""Checkpoint and resume of tensor trees.

The port's counterpart of ``mpi4jax_tpu/utils/checkpoint.py``, with the
same four names and contract:

    from mpi4jax_tpu_torch.utils import checkpoint as ckpt

    ckpt.save(path, {"state": state, "t": np.float64(t)})
    restored = ckpt.restore(path, like={"state": state, "t": np.float64(0)})

A tree is any nesting of dicts, lists, tuples and named tuples whose
leaves are tensors, numpy arrays, numpy scalars or Python scalars.  A
checkpoint is a directory holding one ``torch.save`` file of host copies
of the leaves, with each leaf's path in the tree.  ``like``
gives the structure and each leaf's type: a tensor comes back with
``like``'s dtype and device (bit for bit when the dtypes agree), a numpy
scalar as ``like``'s numpy type, a Python scalar as its Python type.
Nothing needs a process group: every process (or thread rank) writes the
tree it holds, and multi-rank programs keep one series per rank.

Saves are synchronous and committed by a rename: the payload is written
and flushed under a hidden temporary name beside the target, then
``os.replace`` moves it into place, so a step is visible to
:func:`latest_step` only once it is whole.  The format is the port's
own; orbax directories of the JAX package are not read.
"""

import os
import pathlib
import shutil
import uuid

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "Manager"]

PAYLOAD = "tree.pt"


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=""):
    """``[(path, leaf)]`` in a fixed order (dict keys sorted, as JAX's
    tree order has them)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += _flatten(tree[k], f"{path}/{k}")
        return out
    if _is_namedtuple(tree):
        out = []
        for k, v in zip(tree._fields, tree):
            out += _flatten(v, f"{path}/{k}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}/{i}")
        return out
    return [(path or "/", tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves)
                for k in sorted(like, key=str)}
        return {k: vals[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _encode(leaf):
    """One leaf as a compact host tensor (a view would otherwise save its
    whole storage)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf, copy=True))
    if isinstance(leaf, bool):
        return torch.tensor(leaf)
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int64)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float64)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _decode(path, saved, like):
    """One restored leaf of ``like``'s type from its saved host tensor."""
    if torch.is_tensor(like):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {path} has shape {tuple(saved.shape)}, "
                f"the template {tuple(like.shape)}")
        return saved.to(dtype=like.dtype, device=like.device)
    value = saved.numpy()
    if isinstance(like, np.ndarray):
        if value.shape != like.shape:
            raise ValueError(
                f"checkpoint leaf {path} has shape {value.shape}, the "
                f"template {like.shape}")
        return value.astype(like.dtype, copy=False)
    if isinstance(like, np.generic):
        return like.dtype.type(value)
    if isinstance(like, bool):
        return bool(value)
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    raise TypeError(f"cannot restore into a leaf of type "
                    f"{type(like).__name__} (at {path})")


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path, tree, force):
    """Write ``tree`` to the directory ``path`` and commit it by rename."""
    path = pathlib.Path(path).absolute()
    if path.exists() and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = _flatten(tree)
    payload = {"paths": [p for p, _ in leaves],
               "leaves": [_encode(leaf) for _, leaf in leaves]}
    tmp = path.parent / f".{path.name}.tmp-{uuid.uuid4().hex[:12]}"
    tmp.mkdir()
    try:
        with open(tmp / PAYLOAD, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(path.parent)


def _read(path, like):
    path = pathlib.Path(path).absolute()
    payload = torch.load(path / PAYLOAD, map_location="cpu",
                         weights_only=True)
    template = _flatten(like)
    paths = [p for p, _ in template]
    if paths != payload["paths"]:
        raise ValueError(
            f"checkpoint {path} holds the leaves {payload['paths']}, the "
            f"template {paths}")
    return _unflatten(like, iter(
        _decode(p, saved, leaf)
        for (p, leaf), saved in zip(template, payload["leaves"])))


def save(path, tree, *, force=True):
    """Write ``tree`` to the directory ``path``; ``force=True``
    overwrites an existing checkpoint there."""
    _write(path, tree, force)


def restore(path, *, like):
    """Read a tree written by :func:`save`.  ``like`` is a tree of the
    saved structure whose leaves give each restored leaf's type (a
    tensor's dtype and device; its values are not read)."""
    return _read(path, like)


def _steps(directory):
    """The committed step numbers under ``directory``, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and (pathlib.Path(directory) / n /
                                      PAYLOAD).is_file())


def latest_step(directory):
    """The highest committed step under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


class Manager:
    """A stepped checkpoint series with retention, for resuming a long
    solver or training run after a failure.

        with checkpoint.Manager(dir, max_to_keep=3) as mgr:
            start = mgr.latest_step() or 0
            state = mgr.restore(start, like=state) if start else state
            for step in range(start, n):
                state = advance(state)
                mgr.maybe_save(step + 1, state, every=100)

    Step ``s`` lives in ``<directory>/<s>``.  A save keeps the newest
    ``max_to_keep`` steps and deletes the older ones; saving a step that
    exists replaces it.
    """

    def __init__(self, directory, *, max_to_keep=3):
        if int(max_to_keep) < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def all_steps(self):
        return _steps(self.directory)

    def latest_step(self):
        return latest_step(self.directory)

    def save(self, step, tree):
        _write(self.directory / str(int(step)), tree, force=True)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def maybe_save(self, step, tree, *, every):
        if every and step % every == 0:
            self.save(step, tree)
            return True
        return False

    def restore(self, step, *, like):
        path = self.directory / str(int(step))
        if not (path / PAYLOAD).is_file():
            raise FileNotFoundError(
                f"no committed checkpoint for step {step} in "
                f"{self.directory} (have {self.all_steps()})")
        return _read(path, like)

    def wait_until_finished(self):
        """The durability barrier: every save is committed when it
        returns, so there is nothing to wait for."""

    def close(self):
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
