"""Durable checkpoints + mutation WAL for the serving plane.

The mutable index accumulates state a crash would lose: delta
segments, tombstones, slot maps, per-partition ``ValueFormat`` vectors and
the churn-stable signature caps.  This module makes that state durable with
the classic two-piece recipe every production store uses:

* **Atomic checkpoints** — :meth:`DurableIndexStore.checkpoint` writes the
  index's full :meth:`~repro_torch.core.topk_spmv.MutableTopKSpMVIndex.
  export_state` into a fresh ``ckpt-N/`` directory (``arrays.npz`` +
  ``manifest.json``, each fsync-ed), renames it into place, then swaps the
  ``CURRENT`` pointer file via tmp+fsync+rename.  A crash at ANY point
  leaves either the old or the new checkpoint fully valid — never a torn
  mix (fault points ``checkpoint.write`` / ``checkpoint.rename``).
* **Write-ahead log** — mutations between checkpoints append length+CRC
  framed ``upsert`` / ``delete`` / ``compact`` records to ``wal-N.log``
  *before* they apply.  Recovery = load ``CURRENT`` + replay the WAL tail;
  a torn tail record (crash mid-append, fault point ``wal.append``) is
  detected by the frame CRC and truncated.

Replay drives the SAME mutation code paths (``add_rows`` /
``replace_rows`` / ``delete_rows`` / ``compact``) the original process
ran, and the greedy placement is deterministic, so a recovered index
answers queries **bit-identically** and carries the same executor
signature — a resume re-pins device snapshots but retraces zero compiled
fns (tests/test_torch_serving.py asserts both).

This is the reference's ``repro/core/persistence.py`` with the same on-disk
format, ported.  The port keeps bf16 values as ``uint16`` bit patterns, so
its own checkpoints carry no dtype tag; a ``bfloat16`` tag in a store that
the reference wrote is read as ``uint16`` bits, and such a store's state goes
through ``convert.state_from_reference`` on load.  ``device`` chooses where a
recovered index serves.
"""
from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.convert import state_from_reference
from repro_torch.core import faults as faults_lib
from repro_torch.core.topk_spmv import MutableTopKSpMVIndex

_WAL_MAGIC = 0x57414C31  # "WAL1"
_WAL_HEADER = struct.Struct("<IBII")  # magic, kind, payload_len, crc32
_KINDS = {"add": 1, "replace": 2, "delete": 3, "compact": 4}
_KIND_NAMES = {v: k for k, v in _KINDS.items()}

# numpy dtypes .npz can carry without pickling; anything else round-trips as
# a same-width uint view plus a dtype tag in the manifest.  The reference
# tags its bf16 streams "bfloat16"; this package holds bf16 as uint16 bits.
_NATIVE_DTYPES = {
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
}


def _resolve_dtype(name: str) -> np.dtype:
    if name in _NATIVE_DTYPES:
        return np.dtype(name)
    if name == "bfloat16":
        return np.dtype(np.uint16)
    raise ValueError(f"checkpoint array dtype {name!r} has no host form in this package")


def _npz_safe(arrays: dict) -> Tuple[dict, dict]:
    """(npz-storable arrays, {name: original dtype} for the exotic ones)."""
    out, tags = {}, {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name not in _NATIVE_DTYPES:
            tags[name] = arr.dtype.name
            arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
        out[name] = arr
    return out, tags


def _npz_restore(arrays: dict, tags: dict) -> dict:
    return {
        name: (arr.view(_resolve_dtype(tags[name])) if name in tags else arr)
        for name, arr in arrays.items()
    }


def _fsync_write(path: Path, data: bytes) -> None:
    """Write + fsync via a tmp file, then atomically rename into place."""
    tmp = path.parent / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pack_rows(rows: Sequence[Tuple[np.ndarray, np.ndarray]]) -> dict:
    lens = np.asarray([len(c) for c, _ in rows], np.int64)
    if rows:
        cols = np.concatenate([np.asarray(c, np.int32) for c, _ in rows])
        vals = np.concatenate([np.asarray(v, np.float32) for _, v in rows])
    else:
        cols = np.zeros(0, np.int32)
        vals = np.zeros(0, np.float32)
    return {"lens": lens, "cols": cols, "vals": vals}


def _unpack_rows(payload: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    lens = payload["lens"]
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return [
        (payload["cols"][starts[i]: starts[i + 1]],
         payload["vals"][starts[i]: starts[i + 1]])
        for i in range(len(lens))
    ]


class WriteAheadLog:
    """Length+CRC framed mutation records, fsync-ed per append.

    Frame: ``<magic u32, kind u8, payload_len u32, crc32 u32>`` followed by
    an ``.npz`` payload of named arrays.  :meth:`records` stops at the
    first torn frame (short header, bad magic, short payload or CRC
    mismatch) — exactly what a crash mid-append leaves behind — and
    :meth:`append` then truncates the torn tail before writing.
    """

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.touch(exist_ok=True)
        self._valid_bytes, self._count = self._scan()

    def _scan(self) -> Tuple[int, int]:
        data = self.path.read_bytes()
        off, count = 0, 0
        while True:
            if off + _WAL_HEADER.size > len(data):
                break
            magic, kind, plen, crc = _WAL_HEADER.unpack_from(data, off)
            if magic != _WAL_MAGIC or kind not in _KIND_NAMES:
                break
            body = data[off + _WAL_HEADER.size: off + _WAL_HEADER.size + plen]
            if len(body) != plen or zlib.crc32(body) != crc:
                break
            off += _WAL_HEADER.size + plen
            count += 1
        return off, count

    def __len__(self) -> int:
        return self._count

    def append(self, kind: str, arrays: Optional[dict] = None) -> None:
        """Durably append one record (write-ahead: call BEFORE applying)."""
        buf = io.BytesIO()
        np.savez(buf, **(arrays or {}))
        payload = buf.getvalue()
        header = _WAL_HEADER.pack(
            _WAL_MAGIC, _KINDS[kind], len(payload), zlib.crc32(payload)
        )
        size = self.path.stat().st_size
        with open(self.path, "r+b") as f:
            if size != self._valid_bytes:  # drop a torn tail from a crash
                f.truncate(self._valid_bytes)
            f.seek(self._valid_bytes)
            f.write(header)
            f.write(payload[: len(payload) // 2])
            # A crash here leaves a torn record the next scan truncates.
            faults_lib.fault_point("wal.append")
            f.write(payload[len(payload) // 2:])
            f.flush()
            os.fsync(f.fileno())
        self._valid_bytes += len(header) + len(payload)
        self._count += 1

    def records(self):
        """Yield (kind, payload arrays) for every intact record, in order."""
        data = self.path.read_bytes()[: self._valid_bytes]
        off = 0
        while off < len(data):
            magic, kind, plen, crc = _WAL_HEADER.unpack_from(data, off)
            body = data[off + _WAL_HEADER.size: off + _WAL_HEADER.size + plen]
            with np.load(io.BytesIO(body)) as z:
                payload = {k: z[k] for k in z.files}
            yield _KIND_NAMES[kind], payload
            off += _WAL_HEADER.size + plen


class DurableIndexStore:
    """Checkpoint directory + WAL pair making one mutable index crash-safe.

    Layout under ``root``::

        CURRENT        -> "ckpt-00000003"   (atomic pointer file)
        ckpt-00000003/ -> manifest.json + arrays.npz
        wal-00000003.log

    Each checkpoint rotates the WAL (the log's name carries the checkpoint
    id it extends); superseded checkpoints and logs are garbage-collected
    only after the pointer swap, so recovery always finds a complete pair.
    A recovered index serves on ``device`` (the card unless the caller asks
    for ``"cpu"``).  ``last_checkpoint`` and ``last_recovery`` hold the host
    seconds (and bytes, records) of the latest checkpoint and recovery.
    """

    def __init__(self, root, device: str = "cuda") -> None:
        self.root = Path(root)
        self.device = device
        self.root.mkdir(parents=True, exist_ok=True)
        self.checkpoints_written = 0
        self.last_checkpoint: dict = {}   # bytes, export_s, write_s
        self.last_recovery: dict = {}     # read_s, from_state_s, replay_s, records
        self._ckpt_id = self._current_id()
        self._wal = (
            WriteAheadLog(self._wal_path(self._ckpt_id))
            if self._ckpt_id is not None else None
        )

    # -- paths ---------------------------------------------------------------

    def _ckpt_name(self, n: int) -> str:
        return f"ckpt-{n:08d}"

    def _wal_path(self, n: int) -> Path:
        return self.root / f"wal-{n:08d}.log"

    def _current_id(self) -> Optional[int]:
        cur = self.root / "CURRENT"
        if cur.exists():
            name = cur.read_text().strip()
            path = self.root / name
            if (path / "manifest.json").exists():
                return int(name.split("-")[1])
        # Pointer missing or torn: fall back to the newest complete dir.
        best = None
        for p in self.root.glob("ckpt-*"):
            if (p / "manifest.json").exists():
                n = int(p.name.split("-")[1])
                best = n if best is None else max(best, n)
        return best

    @property
    def wal_records(self) -> int:
        """Replay-tail length (records logged since the last checkpoint)."""
        return len(self._wal) if self._wal is not None else 0

    @property
    def has_checkpoint(self) -> bool:
        return self._ckpt_id is not None

    # -- checkpoint ----------------------------------------------------------

    def checkpoint(self, index: MutableTopKSpMVIndex) -> Path:
        """Atomically persist the index's full state; rotates the WAL."""
        new_id = 0 if self._ckpt_id is None else self._ckpt_id + 1
        final = self.root / self._ckpt_name(new_id)
        tmp = self.root / f".tmp-{self._ckpt_name(new_id)}"
        if tmp.exists():  # stray partial from an earlier crash
            for p in tmp.iterdir():
                p.unlink()
            tmp.rmdir()
        tmp.mkdir()
        t0 = time.perf_counter()
        meta, arrays = index.export_state()
        t1 = time.perf_counter()
        safe, tags = _npz_safe(arrays)
        buf = io.BytesIO()
        np.savez(buf, **safe)
        blob = buf.getvalue()
        with open(tmp / "arrays.npz", "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        # Arrays on disk, manifest not yet: the checkpoint is invisible to
        # recovery (no manifest.json), CURRENT still names the previous one.
        faults_lib.fault_point("checkpoint.write")
        manifest = {
            "meta": meta,
            "dtype_tags": tags,
            "arrays_crc32": zlib.crc32(blob),
        }
        manifest_bytes = json.dumps(manifest, indent=1).encode()
        with open(tmp / "manifest.json", "wb") as f:
            f.write(manifest_bytes)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, final)
        _fsync_dir(self.root)
        # Directory complete and named, pointer still on the old checkpoint:
        # recovery here uses the OLD pair (old ckpt + its full WAL).
        faults_lib.fault_point("checkpoint.rename")
        _fsync_write(self.root / "CURRENT", self._ckpt_name(new_id).encode())
        old_id = self._ckpt_id
        self._ckpt_id = new_id
        self._wal = WriteAheadLog(self._wal_path(new_id))
        self.checkpoints_written += 1
        self.last_checkpoint = {"bytes": len(blob) + len(manifest_bytes),
                                "export_s": t1 - t0, "write_s": time.perf_counter() - t1}
        if old_id is not None:  # GC strictly after the pointer swap
            self._gc(old_id)
        return final

    def _gc(self, old_id: int) -> None:
        old = self.root / self._ckpt_name(old_id)
        try:
            for p in old.iterdir():
                p.unlink()
            old.rmdir()
            wal = self._wal_path(old_id)
            if wal.exists():
                wal.unlink()
        except OSError:  # pragma: no cover - GC failure is never fatal
            pass

    # -- WAL -----------------------------------------------------------------

    def _require_wal(self) -> WriteAheadLog:
        if self._wal is None:
            raise RuntimeError(
                "no checkpoint yet — call checkpoint(index) before logging "
                "mutations"
            )
        return self._wal

    def log_add(self, rows: Sequence[tuple]) -> None:
        """Write-ahead an ``add_rows`` batch (fresh ids assigned on replay)."""
        self._require_wal().append("add", _pack_rows(rows))

    def log_replace(self, ids: Sequence[int], rows: Sequence[tuple]) -> None:
        arrays = _pack_rows(rows)
        arrays["ids"] = np.asarray(list(ids), np.int64)
        self._require_wal().append("replace", arrays)

    def log_delete(self, ids: Sequence[int]) -> None:
        self._require_wal().append(
            "delete", {"ids": np.asarray(list(ids), np.int64)}
        )

    def log_compact(self) -> None:
        self._require_wal().append("compact")

    # -- recovery ------------------------------------------------------------

    def load_checkpoint(self) -> MutableTopKSpMVIndex:
        """The last durable checkpoint, WITHOUT the WAL tail."""
        if self._ckpt_id is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        ckpt = self.root / self._ckpt_name(self._ckpt_id)
        t0 = time.perf_counter()
        manifest = json.loads((ckpt / "manifest.json").read_text())
        blob = (ckpt / "arrays.npz").read_bytes()
        if zlib.crc32(blob) != manifest["arrays_crc32"]:
            raise ValueError(f"checkpoint {ckpt} arrays are corrupt (CRC)")
        with np.load(io.BytesIO(blob)) as z:
            arrays = {k: z[k] for k in z.files}
        arrays = _npz_restore(arrays, manifest["dtype_tags"])
        meta = manifest["meta"]
        if "interpret" in meta["config"]:  # written by the reference package
            meta, arrays = state_from_reference(meta, arrays, device=self.device)
        t1 = time.perf_counter()
        index = MutableTopKSpMVIndex.from_state(meta, arrays, device=self.device)
        self.last_recovery = {"read_s": t1 - t0, "from_state_s": time.perf_counter() - t1}
        return index

    def recover(self) -> Tuple[MutableTopKSpMVIndex, int]:
        """Last checkpoint + WAL-tail replay -> (index, records replayed).

        Replay drives the index's own mutation methods, so the recovered
        state — streams, slots, sentinels, format promotions, churn-stable
        buckets — is bit-identical to the pre-crash process's.
        """
        index = self.load_checkpoint()
        t0 = time.perf_counter()
        replayed = 0
        for kind, payload in self._require_wal().records():
            if kind == "add":
                index.add_rows(_unpack_rows(payload))
            elif kind == "replace":
                index.replace_rows(
                    [int(g) for g in payload["ids"]], _unpack_rows(payload)
                )
            elif kind == "delete":
                index.delete_rows([int(g) for g in payload["ids"]])
            elif kind == "compact":
                index.compact()
            replayed += 1
        self.last_recovery.update(replay_s=time.perf_counter() - t0, records=replayed)
        return index, replayed
