"""Device meshes: a named grid of ``torch.device`` positions in one process.

The reference builds ``jax.sharding.Mesh`` objects: a grid of devices under
one controller.  :class:`DeviceMesh` is the port's counterpart: an object
array of ``torch.device`` with named axes.  One device may stand at several
positions, so a mesh that names ``cuda:0`` eight times is a 2 replica x 4
shard serving mesh on one card (the reference's own test topology) and
``[torch.device("cpu")] * 8`` the same mesh on the CPU.  Code that pins
state on a mesh keys it by position, never by device, so two positions on
one card keep apart.

:class:`MeshArray` is a global array over a mesh: one piece per position,
each a tensor on that position's device (``jax.Array``'s sharded form).
``distribute`` cuts a tensor into the blocks a sharding ``(mesh, spec)``
gives each position (``piece_slices``; a spec as ``sharding.rules`` writes
it), and ``gather`` puts the global array back together.

Functions, not module-level constants, so importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``cuda`` becomes
    ``cuda:<current>``, as ``TopKSpMVConfig.resolve_device`` does.  ``meta``
    names a placeholder position (the dry run's: every piece placed there
    is a ``meta`` tensor, and nothing is allocated)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device!r} needs a CUDA device; none is "
                               "available")
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"mesh devices must be cuda, cpu or meta, got {device!r}")
    return dev


class DeviceMesh:
    """A grid of ``torch.device`` positions with named axes.

    ``devices`` is an object ndarray of ``torch.device`` (one per position),
    ``axis_names`` names its axes, ``shape`` maps each name to its size in
    axis order, ``empty`` is true for a mesh of no position.  Every position
    is normalised (``cuda`` -> ``cuda:<current>``); a mesh that mixes device
    types (CPU and CUDA, or ``meta`` placeholders and real devices) is
    refused.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {grid.ndim} needs {grid.ndim} axis names, got "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must be distinct, got {axis_names}")
        norm = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            norm[pos] = normalize_device(grid[pos])
        types = {d.type for d in norm.flat}
        if "meta" in types and len(types) > 1:
            raise ValueError("a mesh may not mix meta placeholders and real devices")
        if len(types) > 1:
            raise ValueError("a mesh may not mix CPU and CUDA positions")
        self.devices = norm
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in self.devices.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.devices.size == 0

    @property
    def device_type(self) -> Optional[str]:
        """``"cuda"``, ``"cpu"`` or ``"meta"`` (None for an empty mesh)."""
        return None if self.empty else self.devices.flat[0].type

    def positions(self) -> Tuple[tuple, ...]:
        """Every position (an index tuple), in row-major order."""
        return tuple(np.ndindex(self.devices.shape))

    def device(self, pos: tuple) -> torch.device:
        return self.devices[pos]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


@dataclasses.dataclass(frozen=True)
class MeshArray:
    """A global array of ``shape`` over a mesh: ``pieces`` maps each position
    to its block, a tensor on that position's device.  ``dtype`` is the
    element type as its maker names it (numpy's, or torch's for
    ``distribute``); ``sharding`` is the ``(mesh, spec)`` that laid out the
    pieces, where one did."""

    shape: tuple
    dtype: np.dtype
    pieces: dict
    sharding: Optional[tuple] = None


def piece_slices(shape: Sequence[int], spec: tuple, mesh: DeviceMesh, pos: tuple) -> tuple:
    """The block of a global array of ``shape`` that position ``pos`` holds
    under ``spec``: a dim split over several mesh axes takes them major to
    minor, as ``PartitionSpec`` does."""
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        index, parts = 0, 1
        for name in ((entry,) if isinstance(entry, str) else entry):
            a = mesh.axis_names.index(name)
            index = index * mesh.devices.shape[a] + pos[a]
            parts *= mesh.devices.shape[a]
        if size % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {parts} ways "
                             f"under {spec}")
        step = size // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def unique_blocks(shape: Sequence[int], sharding: tuple) -> list:
    """``(position, slices)`` for each distinct block, at the first position
    (in row-major order) that holds it."""
    mesh, spec = sharding
    seen, out = set(), []
    for pos in mesh.positions():
        sl = piece_slices(shape, spec, mesh, pos)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in seen:
            seen.add(key)
            out.append((pos, sl))
    return out


def distribute(t: torch.Tensor, sharding: tuple) -> MeshArray:
    """``t`` cut into the blocks ``sharding`` gives each position: every
    position gets its own copy on its device, also where a block is
    replicated, so no two positions alias one tensor."""
    mesh, spec = sharding
    pieces = {pos: t[piece_slices(t.shape, spec, mesh, pos)].to(mesh.device(pos), copy=True)
              for pos in mesh.positions()}
    return MeshArray(tuple(t.shape), t.dtype, pieces, sharding)


def gather(arr: MeshArray, device) -> torch.Tensor:
    """The global array of ``arr`` on ``device``, each block copied once."""
    first = next(iter(arr.pieces.values()))
    out = torch.empty(arr.shape, dtype=first.dtype, device=device)
    for pos, sl in unique_blocks(arr.shape, arr.sharding):
        out[sl].copy_(arr.pieces[pos])
    return out


def _visible_devices(devices) -> list:
    if devices is not None:
        return list(devices)
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devs: list, shape: tuple, what: str):
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(f"{what} needs {need} devices, have {len(devs)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> DeviceMesh:
    """The reference's production mesh: ("data", "model") 16 x 16, or
    ("pod", "data", "model") 2 x 16 x 16, over ``devices`` (the visible
    CUDA devices unless given); raises when there are fewer.  256 (or 512)
    ``meta`` positions give the dry run's placeholder mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(_grid(_visible_devices(devices), shape, "the production mesh"), axes)


def make_host_mesh(model: int = 1, devices=None) -> DeviceMesh:
    """("data", "model") over ``devices`` (every visible CUDA device unless
    given): (n // model, model)."""
    devs = _visible_devices(devices)
    n = len(devs)
    if n == 0 or n % model:
        raise ValueError(f"the host mesh needs a positive multiple of model={model} "
                         f"devices, have {n}")
    return DeviceMesh(_grid(devs, (n // model, model), "the host mesh"), ("data", "model"))


def make_serving_mesh(n_shards: int = 1, n_replicas: int = 1, devices=None) -> DeviceMesh:
    """A ("replica", "shard") mesh for the sharded top-k serving plane.

    Rows (the index) shard across the "shard" axis; queries fan out across
    the "replica" axis, each replica group holding a full copy of every
    shard.  Uses the first ``n_replicas * n_shards`` visible CUDA devices
    unless ``devices`` pins an explicit ordering, which may name a device
    more than once (``[torch.device("cuda", 0)] * 8`` is a 2 x 4 mesh on
    one card).  Never falls back to the CPU.
    """
    devs = _visible_devices(devices)
    need = n_shards * n_replicas
    if len(devs) < need:
        raise ValueError(
            f"serving mesh needs {need} devices "
            f"({n_replicas} replicas x {n_shards} shards), "
            f"have {len(devs)}"
        )
    grid = np.empty((n_replicas, n_shards), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i // n_shards, i % n_shards] = d
    return DeviceMesh(grid, ("replica", "shard"))
