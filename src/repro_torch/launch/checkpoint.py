"""Checkpoint and restart, in the JAX package's protocol.

  * a step's checkpoint is one npz of the state's leaves (``leaf_0``,
    ``leaf_1``, ... in the reference's flatten order: a dict's keys
    sorted), written to a temporary file and moved into place with
    ``os.replace``, so that a preemption mid-save never corrupts the
    latest checkpoint;
  * saves are asynchronous: the leaves are copied to the host at once,
    and a background thread writes them; the next save, or ``wait()``,
    joins it;
  * ``MANIFEST.json`` (``latest_step``, ``n_leaves``, ``extra``: the data
    cursor and schedule metadata) names the latest complete step, and a
    restore reads it, never the newest file;
  * ``keep_last`` checkpoints are kept, older ones deleted.

numpy has no bfloat16, so a bf16 leaf is stored as its bits (``uint16``)
and each leaf's dtype is kept beside the leaves (``dtypes``): a restore is
bit-identical.  ``restore(state_like)`` places each leaf on the device of
``state_like``'s leaf, or with ``shardings=`` on a mesh.  A checkpoint that
the JAX package wrote has no ``dtypes``: each leaf then takes the dtype of
``state_like``'s leaf, and a bf16 leaf (``np.savez`` writes it as 2-byte
void, ``|V2``) is read as its bits.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from ..tree import leaves, unflatten

def _to_host(x) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a leaf; bf16 as its uint16 bits."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, f"numpy.{a.dtype}"
    t = x.detach().to("cpu", copy=True)    # a copy even of a CPU tensor
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), str(t.dtype)
    return t.numpy(), str(t.dtype)


def _recorded(a: np.ndarray, like) -> str:
    """The dtype name of a leaf that a checkpoint without ``dtypes`` holds:
    the state's leaf's."""
    if not isinstance(like, torch.Tensor):
        return f"numpy.{a.dtype}"
    return str(like.dtype)


def _from_host(a: np.ndarray, dtype: str, like, sharding=None) -> object:
    if dtype.startswith("numpy."):
        return a
    if dtype == str(torch.bfloat16):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
        if str(t.dtype) != dtype:
            raise ValueError(f"leaf stored as {t.dtype}, recorded {dtype}")
    if sharding is not None:
        from .shardings import place
        return place(t, sharding)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}.npz")

    def save(self, step: int, state_tree, *, blocking: bool = False,
             extra: dict | None = None) -> None:
        """Save ``state_tree`` as step ``step``: the leaves are copied to the
        host now and written by a background thread (at once with
        ``blocking``); ``extra`` goes into the manifest."""
        self.wait()
        host = [_to_host(x) for x in leaves(state_tree)]

        def _write():
            path = self._ckpt_path(step)
            tmp = path + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, dtypes=np.asarray([d for _, d in host]),
                         **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            os.replace(tmp, path)
            man = dict(latest_step=step, n_leaves=len(host),
                       time=time.time(), extra=extra or {})
            mtmp = self._manifest_path() + ".tmp"
            with open(mtmp, "w") as f:
                json.dump(man, f)
            os.replace(mtmp, self._manifest_path())
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the pending background save, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        ckpts = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("step_") and f.endswith(".npz")
                       and ".tmp" not in f)
        for f in ckpts[:-self.keep_last]:
            try:
                os.remove(os.path.join(self.dir, f))
            except OSError:
                pass

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        try:
            with open(self._manifest_path()) as f:
                return int(json.load(f)["latest_step"])
        except (OSError, ValueError, KeyError):
            return None

    def manifest(self) -> dict | None:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except OSError:
            return None

    def restore(self, state_like, *, step: int | None = None,
                shardings=None):
        """(state of ``state_like``'s structure, its step), each leaf on
        the device of ``state_like``'s leaf, or, with ``shardings`` (a tree
        of ``shardings.MeshPlacements`` matching the state, as
        ``tree_shardings`` gives), a DTensor on its mesh (the elastic
        re-mesh path); (None, None) when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        like = leaves(state_like)
        places = ([None] * len(like) if shardings is None
                  else leaves(shardings))
        if len(places) != len(like):
            raise ValueError(f"{len(places)} shardings for {len(like)} "
                             f"leaves")
        with np.load(self._ckpt_path(step)) as data:
            n = sum(f.startswith("leaf_") for f in data.files)
            if n != len(like):
                raise ValueError(f"checkpoint of step {step} holds {n} "
                                 f"leaves, the state {len(like)}")
            arrays = [data[f"leaf_{i}"] for i in range(n)]
            dtypes = ([str(d) for d in data["dtypes"]] if "dtypes" in
                      data.files else
                      [_recorded(a, x) for a, x in zip(arrays, like)])
        new = [_from_host(a, d, x, s) for a, d, x, s in
               zip(arrays, dtypes, like, places)]
        return unflatten(state_like, new), step
