"""Checkpoint/restart with atomic commits and async snapshots, in the JAX
package's format (``training/checkpoint.py``).

Format: one ``state.npz`` of flattened (path -> array) leaves, the path's
dict keys joined by ``"||"``, plus ``meta.json`` (step, data cursor,
config fingerprint).  Arrays are stored whole, so a checkpoint restores on
any device; and since the format is the reference's, a checkpoint written
by the JAX package's ``Trainer`` restores into the port's.  bfloat16 has no
numpy type without ``ml_dtypes``: the JAX package's ``np.savez`` writes a
bfloat16 leaf as raw 2-byte void (``|V2``), and the port writes and reads
exactly that, the bits reinterpreted through int16.

Atomicity: write to ``<dir>/tmp-<step>`` then ``os.replace`` into
``step-<n:08d>``; a crash mid-write never corrupts the latest checkpoint.
``AsyncCheckpointer`` copies the state to host memory synchronously and
serializes it on a background thread (training is not blocked on disk;
the copy is needed because the optimizer updates its tensors in place).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.training.tree import leaves_with_paths, map_tree

_SEP = "||"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on ``device``."""
    arr = arr.copy(order="C")  # (ascontiguousarray would make a 0-d leaf 1-d)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # raw bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in leaves_with_paths(tree)}


def _host_copy(tree):
    """Every leaf copied to host memory now (a CPU tensor is cloned); a
    DTensor is gathered whole first, so checkpoints stay unsharded."""
    def one(t):
        t = t.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        return t.to("cpu", copy=True)

    return map_tree(one, tree)


def save_checkpoint(
    directory: Path,
    step: int,
    state: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp-{step}"
    final = directory / f"step-{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "state.npz", **_flatten(state))
    (tmp / "meta.json").write_text(json.dumps({"step": step, **(meta or {})}, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_checkpoint(directory: Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(p for p in directory.iterdir() if p.name.startswith("step-"))
    return steps[-1] if steps else None


def restore_checkpoint(
    path: Path, state_template, device: DeviceLike = None, *, mesh=None, specs=None
) -> Tuple[int, Any, Dict[str, Any]]:
    """The stored state in ``state_template``'s tree and dtypes, on
    ``device`` (default: each template leaf's own device).  With ``mesh``
    and ``specs`` (a spec tree beside the template, ``sharding/rules.py``)
    each leaf comes back as a DTensor of those placements: the stored state
    is unsharded, so it restores onto any mesh."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "state.npz") as z:
        flat = {k: z[k] for k in z.files}
    state = {}
    for keys, like in leaves_with_paths(state_template):
        node = state
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        dev = device if device is not None else (
            like.to_local().device if hasattr(like, "to_local") else like.device)
        node[keys[-1]] = _from_numpy(flat[_SEP.join(keys)], like, dev)
    state = map_tree(lambda t, s: s, state_template, state)
    if mesh is not None:
        from repro_torch.sharding.rules import distribute

        state = map_tree(lambda sp, t: distribute(t, sp, mesh), specs, state)
    return meta["step"], state, meta


class AsyncCheckpointer:
    """Snapshot-to-host now, serialize on a background thread."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, directory: Path, step: int, state, meta=None) -> None:
        host_state = _host_copy(state)  # synchronous snapshot

        def work():
            try:
                save_checkpoint(directory, step, host_state, meta)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self.wait()
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
