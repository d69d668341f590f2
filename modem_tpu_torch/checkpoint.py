"""Streaming-state checkpoint and resume (counterpart of
:mod:`modem_tpu.checkpoint`).

A stream's carry (``get_state()`` of the streaming classes, ``TxState`` /
``RxState`` arrays, a :class:`~modem_tpu_torch.metrics.LinkStats`) is a
complete checkpoint of an unbounded stream. :func:`save_state` writes its
leaves to one ``.npz``, in the JAX package's order: dicts by sorted key,
lists and tuples in order, dataclasses by field, ``None`` holding no leaf.
So a carry saved by the JAX package loads here and a stream goes on where
it stopped. :func:`load_state` restores into the structure of a template
(the resuming code always has one), tensors on the template's device,
checking every leaf.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch


def _leaves(state) -> list:
    if state is None:
        return []
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return [x for f in dataclasses.fields(state)
                for x in _leaves(getattr(state, f.name))]
    return [state]


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), it)
            for f in dataclasses.fields(like)})
    return next(it)


def _array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path, state) -> None:
    """Write a carry's leaves to ``path`` (.npz)."""
    arrays = {f"leaf_{i}": _array(leaf)
              for i, leaf in enumerate(_leaves(state))}
    np.savez(pathlib.Path(path), **arrays)


def load_state(path, like):
    """Restore a carry written by :func:`save_state` (here or by the JAX
    package) into the structure of ``like``. A tensor leaf must match the
    template's shape and dtype and lands on its device; a Python number
    takes a scalar of its kind. Raises ``ValueError`` on any mismatch."""
    with np.load(pathlib.Path(path)) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    leaves = _leaves(like)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has {len(leaves)}")
    restored = []
    for i, (a, leaf) in enumerate(zip(arrays, leaves)):
        if torch.is_tensor(leaf):
            want = (tuple(leaf.shape),
                    torch.empty((), dtype=leaf.dtype).numpy().dtype)
            if (a.shape, a.dtype) != want:
                raise ValueError(f"leaf {i}: checkpoint {a.shape}/{a.dtype} "
                                 f"vs template {want[0]}/{want[1]}")
            restored.append(torch.as_tensor(a, device=leaf.device).clone())
        else:
            kind = np.asarray(leaf).dtype.kind
            if a.shape != () or a.dtype.kind != kind:
                raise ValueError(f"leaf {i}: checkpoint {a.shape}/{a.dtype} "
                                 f"vs a scalar of kind {kind!r}")
            restored.append(type(leaf)(a.item()))
    return _rebuild(like, iter(restored))
