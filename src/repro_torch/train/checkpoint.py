"""Fault-tolerant checkpointing: step-numbered files, atomic rename,
retention, async save.

The reference's ``repro/train/checkpoint.py``, ported with its behaviour:
host copies are taken before the hand-off to the writer, a file is written
under ``.tmp`` and published by ``os.replace``, the newest ``keep`` are
kept, and a restore checks the leaf count against ``like``.

The file format differs: one ``np.savez`` (uncompressed) of the leaves in
the order of their sorted key paths, bfloat16 leaves as ``uint16`` bits
(as ``core/persistence.py`` stores them), their dtypes in a JSON entry.
The reference writes msgpack + zstd; the port needs only numpy, and the
float32 masters and moments compress little.

Elastic, as the reference's: a leaf that is a ``launch.mesh.MeshArray`` is
saved as its gathered global array (the file holds what a one-device save
of the same values holds), and ``restore(..., shardings=)`` cuts each leaf
into the pieces of the restoring mesh, which may differ from the saving one.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import MeshArray, distribute, gather

_PREFIX, _SUFFIX = "ckpt_", ".npz"


def _leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a nested mapping, in the order of their sorted key paths
    (``jax.tree_util``'s order for dicts)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(like, Mapping):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return next(leaves)


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype's name (bf16 as uint16 bits)."""
    if isinstance(x, MeshArray):
        x = gather(x, "cpu")            # a new host tensor
    elif isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.dtype).removeprefix("torch.")
    arr = np.array(x)
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if not arr.flags.writeable:     # read from the archive into a read-only buffer
        arr = arr.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def serialize(f, host: List[Tuple[np.ndarray, str]]) -> None:
    """Write host leaves (``_to_host`` pairs) to the open binary file ``f``."""
    arrays = {f"leaf_{i:06d}": arr for i, (arr, _) in enumerate(host)}
    np.savez(f, dtypes=np.array(json.dumps([dt for _, dt in host])), **arrays)


def _shape(x: Any) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def deserialize(path: str, like: Any, device="cpu", shardings: Any = None) -> Any:
    """The checkpoint at ``path`` in ``like``'s structure, as tensors on
    ``device``, or, with ``shardings`` (``like``'s structure with a ``(mesh,
    spec)`` at each leaf), as ``MeshArray`` s laid out by them.  Raises
    ``ValueError`` if its leaf count or a leaf's shape differs from
    ``like``'s."""
    want = list(_leaves(like))
    places = list(_leaves(shardings)) if shardings is not None else [None] * len(want)
    with np.load(path) as data:
        dtypes = json.loads(str(data["dtypes"]))
        if len(dtypes) != len(want):
            raise ValueError(f"checkpoint has {len(dtypes)} leaves, expected {len(want)} "
                             "(architecture mismatch?)")
        out = []
        for i, (dtype, ref, place) in enumerate(zip(dtypes, want, places)):
            arr = data[f"leaf_{i:06d}"]
            if tuple(arr.shape) != _shape(ref):
                raise ValueError(f"checkpoint leaf {i} has shape {arr.shape}, expected "
                                 f"{_shape(ref)}")
            if place is None:
                out.append(_from_host(arr, dtype, device))
            else:
                out.append(distribute(_from_host(arr, dtype, "cpu"), place))
    return _unflatten(like, iter(out))


class CheckpointManager:
    """Step-numbered checkpoints with retention and an optional async writer."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}{_SUFFIX}")

    def save(self, step: int, state: Any) -> None:
        # Host copies before the hand-off: the caller may update the device
        # tensors in place (or free them) while the writer runs.
        host = [_to_host(x) for x in _leaves(state)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._write_async, args=(step, host),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host) -> None:
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:
            serialize(f, host)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))  # atomic publish
        self._gc()

    def _write_async(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except Exception as exc:  # raised to the caller by wait()
            self._error = exc

    def wait(self) -> None:
        """Join the writer; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def all_steps(self) -> List[int]:
        """Published steps, oldest first (a ``.tmp`` left by a crash is not one)."""
        return sorted(int(f[len(_PREFIX):-len(_SUFFIX)]) for f in os.listdir(self.directory)
                      if f.startswith(_PREFIX) and f.endswith(_SUFFIX))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, device="cpu",
                shardings: Any = None) -> Tuple[int, Any]:
        """(step, state) of checkpoint ``step`` (the latest by default), in
        ``like``'s structure as tensors on ``device``; re-sharded onto
        ``shardings`` if given (elastic: the restoring job's mesh may differ
        from the saving job's), each leaf a ``MeshArray``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, deserialize(self._path(step), like, device, shardings)
