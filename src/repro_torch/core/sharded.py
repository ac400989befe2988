"""Row-sharded top-k serving plane: per-shard dispatch and one merge of the pools.

The paper scales out with one FPGA per HBM stack, each streaming its slice
of the BS-CSR matrix.  A :class:`ShardedTopKSpMVIndex` cuts the collection
the same way:

* **Row sharding at partition granularity.**  The global partition plan is
  cut into ``S`` contiguous runs of ``C/S`` partitions; each run's rows back
  one shard-local :class:`~repro_torch.core.topk_spmv.MutableTopKSpMVIndex`.
  The plan slices exactly (the +1-sized partitions of ``C = q*S + r`` form
  a prefix), so every shard's base encode equals the matching slice of the
  single-device encode.
* **Global ids through per-shard row maps.**  Each shard finalizes under the
  collection's ids: a local-to-global map pinned beside the shard's
  snapshot (``finalize_candidates(..., row_map=)``) and the collection's
  row-id sentinel, so tie-breaks and sentinels are those of the
  single-device merge.
* **One top-k merge.**  The per-shard ``big_k`` pools concatenate into one
  ``merge_topk``: on one device that is one sort where the reference's
  pairwise tree (``partition.tree_merge_topk``, kept for a merge across
  devices) takes S - 1, and every merge order gives the same bits, equal to
  the single-device index's.
* **Mutations** route through a global least-loaded-core simulation that
  replays the single-device placement, so per-core slot structure, delta
  packets and sentinels match the single-device index batch for batch.
  ``compact()`` re-slices the live rows across the shards at partition
  bounds.

Mixed-precision (``recall_target``) indexes regroup their width classes
shard-locally: each shard calibrates and groups its own partitions.
``native_groups=False`` serves the exactly dequantized f32 twins instead
(one F32 word stream per shard, bit for bit the native scores).

Dispatch paths (the reference's table):

==============================  ==========================================
configuration                   path
==============================  ==========================================
``mesh=None`` (``n_shards=S``)  per-shard executor dispatch on the
                                config's device, one flat merge
mesh + uniform format           SPMD dispatch (``_SpmdDispatcher``): every
                                mesh position pins its shard's streams,
                                tree merge over the shard axis
mesh + mixed, native groups     per-shard executor dispatch, one column
                                device per shard, tree merge on the
                                merge device
mesh + mixed, f32 twins         SPMD dispatch over the twin streams
``use_kernel=False``            per-shard torch oracle (same plane)
==============================  ==========================================

A mesh (``launch.mesh.make_serving_mesh``) is a grid of ``torch.device``
positions in this one process, and a device may stand at several
positions: ``[torch.device("cuda", 0)] * 8`` is a 2 replica x 4 shard mesh
on one card.  Everything pinned on a mesh is keyed by position, so two
positions on one card never share a pin; the copies between positions
are ``Tensor.to`` calls, which are no-ops on one card.
"""
from __future__ import annotations

import dataclasses
import threading
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core.precision_model import expected_precision
from repro_torch.core.topk_spmv import MutableTopKSpMVIndex, TopKSpMVConfig
from repro_torch.kernels import executor as executor_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.bscsr_topk_spmv import bscsr_spmv, spmv_splits
from repro_torch.sharding import rules as rules_lib

_INVALID = int(bscsr_lib.INVALID_ROW)


class ShardedTopKSpMVIndex:
    """A row-sharded, serve-while-ingest top-k index.

    Duck-types the mutation and query surface of
    :class:`~repro_torch.core.topk_spmv.MutableTopKSpMVIndex` (global row
    ids, ``add_rows`` / ``replace_rows`` / ``delete_rows`` / ``compact`` /
    ``live_csr``) over ``n_shards`` shard-local mutable indexes.  Queries
    return the answers of the single-device index built from the same
    collection with the same (frozen) partition count, bit for bit.

    The partition count is resolved once and FROZEN: it must divide by the
    shard count, and ``compact()`` keeps it.
    """

    def __init__(
        self,
        csr: bscsr_lib.CSRMatrix,
        config: Optional[TopKSpMVConfig] = None,
        *,
        mesh=None,
        n_shards: Optional[int] = None,
        native_groups: bool = True,
    ):
        config = config or TopKSpMVConfig()
        self.config = config
        self.mesh = mesh
        self.native_groups = native_groups
        if mesh is not None:
            if "shard" not in mesh.axis_names:
                raise ValueError(
                    "serving mesh needs a 'shard' axis — build it with "
                    "launch.mesh.make_serving_mesh(n_shards, n_replicas)"
                )
            s = int(mesh.shape["shard"])
            r = int(mesh.shape["replica"]) if "replica" in mesh.axis_names else 1
            if n_shards is not None and int(n_shards) != s:
                raise ValueError(
                    f"n_shards={n_shards} contradicts the mesh's shard axis ({s})"
                )
            if mesh.device_type != torch.device(config.device).type:
                raise ValueError(
                    f"the mesh's positions are {mesh.device_type} devices but "
                    f"config.device is {config.device!r}: a mesh runs where its "
                    "positions are"
                )
        else:
            s = int(n_shards) if n_shards is not None else 1
            r = 1
        if s < 1:
            raise ValueError(f"n_shards must be >= 1, got {s}")
        self.n_shards = s
        self.n_replicas = r
        c_total = config.resolve_partitions(csr.shape[0])
        if c_total % s:
            raise ValueError(
                f"num_partitions ({c_total}) must divide by the shard count ({s}) so "
                "every shard owns whole partitions"
            )
        self._c_total = c_total
        self._cps = c_total // s
        self._local_config = dataclasses.replace(config, num_partitions=self._cps)
        self._hetero = config.recall_target is not None
        self._device = config.resolve_device()

        bounds = self._shard_bounds(csr.shape[0])
        self._shards = []
        self._l2g: list = []     # per shard: local id -> global id, append-only
        self._live: dict = {}    # global id -> (shard, local id)
        for i in range(s):
            self._shards.append(MutableTopKSpMVIndex(
                csr.row_slice(bounds[i], bounds[i + 1]), self._local_config))
            ids = list(range(bounds[i], bounds[i + 1]))
            self._l2g.append(ids)
            for lid, gid in enumerate(ids):
                self._live[gid] = (i, lid)
        self._next_gid = csr.shape[0]
        self._deleted: set = set()
        self._dead_shards: set = set()   # failed dispatch -> degraded serving
        self.shard_errors: dict = {}     # shard -> traceback of its last failure
        self.failovers = 0               # shards ever marked dead
        self.last_query_degraded = False
        self._version = 0
        self._generation = 0     # bumped by compact(): shard versions restart
        self._row_maps: dict = {}        # shard -> ((generation, version), map)
        # Pinned per shard on its device (None: the merge device), so two
        # shards on one card never share one.
        self._gsent: dict = {}           # shard -> (next_gid, 0-d tensor)
        self._unit: dict = {}            # shard -> (1.0, 0.0)
        self._zeros: dict = {}           # (shard, n_out) -> zero vector
        self._live_csr_cache = None
        # The SPMD dispatch needs one uniform stream format across the mesh:
        # uniform configs ship their native words, mixed ones the exactly
        # dequantized f32 twins unless native width-class groups were asked
        # for (those take the per-shard path on the column devices).
        self._spmd = None
        if mesh is not None and (not self._hetero or not native_groups):
            self._spmd = _SpmdDispatcher(self)

    def _shard_bounds(self, n_rows: int) -> list:
        """Global row bounds of each shard's run of ``C/S`` partitions."""
        plan = partition_lib.PartitionPlan.build(n_rows, self._c_total)
        bounds = [0]
        for i in range(self.n_shards):
            bounds.append(bounds[-1] + int(sum(
                plan.rows_per_partition[i * self._cps:(i + 1) * self._cps])))
        return bounds

    # -- bookkeeping ---------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_rows(self) -> int:
        """Live (queryable) rows across all shards."""
        return len(self._live)

    @property
    def n_rows_total(self) -> int:
        """Size of the global row-id space (live + deleted ids)."""
        return self._next_gid

    @property
    def num_cores(self) -> int:
        return self._c_total

    @property
    def deleted_rows(self) -> int:
        return len(self._deleted)

    @property
    def expected_precision(self) -> float:
        return expected_precision(max(self.n_rows, 1), self._c_total, self.config.k,
                                  self.config.big_k)

    @property
    def predicted_recall(self) -> Optional[float]:
        """Worst shard-local calibration estimate (None when homogeneous)."""
        vals = [sh.predicted_recall for sh in self._shards]
        if any(v is None for v in vals):
            return None
        return min(vals)

    @property
    def partition_formats(self) -> Optional[Tuple[str, ...]]:
        """Global-partition-order format names (None when homogeneous)."""
        if not self._hetero:
            return None
        return tuple(f for sh in self._shards for f in sh.partition_formats)

    @property
    def n_cols(self) -> int:
        """Feature dimension (embedding width) of the collection."""
        return self._shards[0].n_cols

    @property
    def live_shard_fraction(self) -> float:
        """Fraction of shards currently serving (1.0 = full coverage)."""
        return (self.n_shards - len(self._dead_shards)) / self.n_shards

    @property
    def dead_shards(self) -> tuple:
        return tuple(sorted(self._dead_shards))

    @property
    def snapshot_buffers(self) -> int:
        return sum(sh.snapshot_buffers for sh in self._shards)

    @property
    def last_refresh_repadded(self) -> int:
        return sum(sh.last_refresh_repadded for sh in self._shards)

    @property
    def last_refresh_copied(self) -> int:
        return sum(sh.last_refresh_copied for sh in self._shards)

    @property
    def last_refresh_group_copied(self) -> int:
        return sum(sh.last_refresh_group_copied for sh in self._shards)

    @property
    def shards(self) -> tuple:
        """The shard-local mutable indexes (read-only introspection)."""
        return tuple(self._shards)

    def aggregate_stats(self) -> dict:
        """Collection-wide stream statistics summed over the shards' snapshots."""
        packs = [sh.packed for sh in self._shards]
        nnz = sum(p.nnz for p in packs)
        stream_bytes = sum(p.stream_bytes for p in packs)
        hist: dict = {}
        for p in packs:
            for name, count in p.format_histogram().items():
                hist[name] = hist.get(name, 0) + count
        return {
            "n_cols": packs[0].n_cols,
            "nnz": nnz,
            "stream_bytes": stream_bytes,
            "bytes_per_nnz": stream_bytes / max(nnz, 1),
            "value_bytes_per_nnz": sum(p.value_stream_bytes for p in packs) / max(nnz, 1),
            "delta_fraction": sum(p.delta_nnz for p in packs) / max(nnz, 1),
            "tombstone_count": sum(p.tombstone_count for p in packs),
            "stream_layout": self.config.stream_layout,
            "format_histogram": hist,
        }

    # -- mutation routing ----------------------------------------------------
    #
    # The single-device index places each appended row on the globally
    # least-loaded core (lowest index wins ties), counting each core's slots
    # once per batch and simulating the increments.  Routing replays that
    # over the shard-major core list, and each shard takes its items as ONE
    # local append batch in their relative order, so per-core groups (delta
    # packets, sentinels, slot structure) match the single-device index.

    def _route(self, count: int) -> list:
        sizes = np.asarray([len(slots) for sh in self._shards for slots in sh._slots],
                           np.int64)
        dest = []
        for _ in range(count):
            ci = int(np.argmin(sizes))
            sizes[ci] += 1
            dest.append(ci // self._cps)
        return dest

    def _append_routed(self, items: Sequence[tuple]) -> None:
        """Append (gid, normalized row) items, one local batch per shard."""
        per_shard: dict = {}
        for (gid, row), s in zip(items, self._route(len(items))):
            per_shard.setdefault(s, []).append((gid, row))
        for s in sorted(per_shard):
            batch = per_shard[s]
            base = len(self._l2g[s])
            lids = self._shards[s].add_rows([row for _, row in batch])
            if lids[0] != base:
                raise RuntimeError(f"shard {s}'s local id space is out of step with its map")
            for (gid, _), lid in zip(batch, lids):
                self._l2g[s].append(gid)
                self._live[gid] = (s, lid)

    def add_rows(self, rows: Sequence[tuple]) -> list:
        """Append new rows; returns their freshly assigned global row ids."""
        if not rows:
            return []
        normalized = [MutableTopKSpMVIndex._normalize_row(c, v) for c, v in rows]
        gids = list(range(self._next_gid, self._next_gid + len(rows)))
        self._next_gid += len(rows)
        self._append_routed(list(zip(gids, normalized)))
        self._bump()
        return gids

    def replace_rows(self, row_ids: Sequence[int], rows: Sequence[tuple]) -> None:
        """Replace rows in place of their global ids (resurrects deleted ids).

        The old copy's slot is tombstoned on its shard; the new copy goes
        wherever the global placement sends it, so a replace may move a row
        between shards (the merges run on global ids).
        """
        if len(row_ids) != len(rows):
            raise ValueError("row_ids and rows must be the same length")
        ids = self._validate_ids(row_ids)
        normalized = [MutableTopKSpMVIndex._normalize_row(c, v) for c, v in rows]
        per_del: dict = {}
        for gid in ids:
            cur = self._live.pop(gid, None)
            if cur is not None:
                per_del.setdefault(cur[0], []).append(cur[1])
            self._deleted.discard(gid)
        for s in sorted(per_del):
            self._shards[s].delete_rows(per_del[s])
        self._append_routed(list(zip(ids, normalized)))
        self._bump()

    def delete_rows(self, row_ids: Sequence[int]) -> None:
        """Tombstone rows: never returned again, reclaimed at ``compact()``."""
        ids = self._validate_ids(row_ids, allow_duplicates=True)
        per: dict = {}
        for gid in ids:
            cur = self._live.pop(gid, None)
            if cur is not None:
                per.setdefault(cur[0], []).append(cur[1])
            self._deleted.add(gid)
        for s in sorted(per):
            self._shards[s].delete_rows(per[s])
        self._bump()

    def _validate_ids(self, row_ids, allow_duplicates=False) -> list:
        out = [int(g) for g in row_ids]
        for gid in out:
            if gid < 0 or gid >= self._next_gid:
                raise KeyError(f"row id {gid} was never assigned")
        if not allow_duplicates and len(set(out)) != len(out):
            raise ValueError("duplicate row ids in one replace batch")
        return out

    def _bump(self) -> None:
        self._version += 1
        self._live_csr_cache = None

    def live_csr(self) -> Tuple[bscsr_lib.CSRMatrix, np.ndarray]:
        """Live rows (gid-ascending) as one host CSR plus their global ids."""
        if self._live_csr_cache is not None and self._live_csr_cache[0] == self._version:
            return self._live_csr_cache[1]
        gids = np.asarray(sorted(self._live), dtype=np.int64)
        rows = [self._shards[s]._rows[lid] for s, lid in (self._live[int(g)] for g in gids)]
        lens = np.asarray([len(c) for c, _ in rows], dtype=np.int64)
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        if rows:
            indices = np.concatenate([c for c, _ in rows])
            data = np.concatenate([v for _, v in rows])
        else:
            indices = np.zeros(0, np.int32)
            data = np.zeros(0, np.float32)
        csr = bscsr_lib.CSRMatrix(indptr=indptr, indices=indices, data=data,
                                  shape=(int(gids.size), self.n_cols))
        self._live_csr_cache = (self._version, (csr, gids))
        return csr, gids

    def compact(self) -> None:
        """Re-slice the live collection across shards at partition bounds.

        Each shard re-encodes its fresh contiguous run of the (gid-sorted)
        live rows under the frozen partition count.  Global ids survive;
        shard-local id spaces restart, and the generation counter keeps the
        pinned row maps from aliasing the restarted shard versions.
        """
        csr, gids = self.live_csr()
        bounds = self._shard_bounds(csr.shape[0])
        self._live = {}
        for i in range(self.n_shards):
            self._shards[i] = MutableTopKSpMVIndex(
                csr.row_slice(bounds[i], bounds[i + 1]), self._local_config)
            ids = [int(g) for g in gids[bounds[i]:bounds[i + 1]]]
            self._l2g[i] = ids
            for lid, gid in enumerate(ids):
                self._live[gid] = (i, lid)
        self._generation += 1
        self._row_maps = {}
        self._bump()

    # -- query dispatch ------------------------------------------------------

    def _row_map(self, s: int) -> np.ndarray:
        """Shard ``s``'s local-to-global id map, padded to its churn bucket.

        Entries past the shard's local id space are INVALID_ROW, which the
        finalize mask turns into the global sentinel.  Under
        ``churn_stable`` the length is a power of two, like the tombstone
        bitmap's, so local growth keeps the signature.
        """
        sh = self._shards[s]
        key = (self._generation, sh.version)
        cached = self._row_maps.get(s)
        if cached is not None and cached[0] == key:
            return cached[1]
        n = sh.n_rows_total
        if len(self._l2g[s]) != n:
            raise RuntimeError(f"shard {s}'s map holds {len(self._l2g[s])} ids for "
                               f"{n} local rows")
        length = kernel_ops.pow2_bucket(max(n, 1)) if self.config.churn_stable else max(n, 1)
        m = np.full(length, _INVALID, np.int32)
        m[:n] = np.asarray(self._l2g[s], np.int32)
        self._row_maps[s] = (key, m)
        return m

    # -- placement -----------------------------------------------------------

    def _shard_device(self, s: int) -> torch.device:
        """Replica-0 device of shard ``s``'s mesh column (the config's
        device off-mesh)."""
        if self.mesh is None:
            return self._device
        ax = self.mesh.axis_names.index("shard")
        return np.take(self.mesh.devices, s, axis=ax).flat[0]

    def _merge_device(self) -> torch.device:
        return self._device if self.mesh is None else self.mesh.devices.flat[0]

    def _executor(self, s: int):
        """The executor of shard ``s``'s device (its column's, on a mesh)."""
        cfg = self._local_config
        return executor_lib.get_executor(
            big_k=cfg.big_k, k=cfg.k, packets_per_step=cfg.packets_per_step,
            gather_mode=cfg.gather_mode, inner_loop=cfg.inner_loop,
            device=self._shard_device(s))

    def _gsent_scalar(self, s: Optional[int] = None) -> torch.Tensor:
        """The current global row-id sentinel, pinned on shard ``s``'s device
        (the merge device for None)."""
        cur = self._gsent.get(s)
        if cur is None or cur[0] != self._next_gid:
            dev = self._merge_device() if s is None else self._shard_device(s)
            cur = self._gsent[s] = (self._next_gid, torch.tensor(
                self._next_gid, dtype=torch.int32, device=dev))
        return cur[1]

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self._merge_device()).contiguous()

    def _layout(self, use_kernel: bool) -> Optional[str]:
        """``"split"`` (the f32 twins) for a mixed index without native groups."""
        return "split" if use_kernel and self._hetero and not self.native_groups else None

    # -- query dispatch ------------------------------------------------------

    def _checked_query(self, x, batched: bool) -> torch.Tensor:
        x = self._on_device(x)              # uploaded once for all shards
        want = "(Q, M) batch" if batched else "(M,) query"
        if x.dim() != (2 if batched else 1) or x.shape[-1] != self.n_cols or not x.numel():
            # A malformed query is the caller's error: it must not kill shards.
            raise ValueError(f"x must be a non-empty {want} with M = {self.n_cols}, "
                             f"got {tuple(x.shape)}")
        return x

    def query(self, x, use_kernel: bool = True):
        """Top-``big_k`` (values, global row ids) for one (M,) query."""
        if self._spmd is not None and use_kernel:
            return self._spmd.query(self._checked_query(x, batched=False))
        return self._per_shard_query(x, use_kernel, batched=False)

    def query_batched(self, xs, use_kernel: bool = True):
        """(Q, big_k) answers for a (Q, M) batch."""
        if self._spmd is not None and use_kernel:
            return self._spmd.query_batched(self._checked_query(xs, batched=True))
        return self._per_shard_query(xs, use_kernel, batched=True)

    def _per_shard_query(self, x, use_kernel: bool, batched: bool):
        """One executor dispatch per shard, then one merge of the pools.

        Every shard's snapshot, row map and the global sentinel are pinned,
        so a steady-state query is S dispatches and one merge, with no
        upload but the query's own.  Off a mesh the pools merge flat; on a
        mesh (a mixed index's native groups, one shard per column device)
        they move to the merge device and tree-merge there.

        **Failover:** a shard whose dispatch raises is marked dead and its
        pool dropped from the merge; the sentinel normalisation makes an
        absent pool merge-safe, so the survivors' answer is exactly the full
        answer restricted to their rows.  Queries serve degraded
        (``last_query_degraded``, ``live_shard_fraction``) until
        :meth:`recover_shard` re-pins the shard from its intact host copy.
        """
        x = self._checked_query(x, batched)
        path = "kernel" if use_kernel else "reference"
        merge_dev = self._merge_device()
        pools_v, pools_r = [], []
        last_error = None
        for s, sh in enumerate(self._shards):
            if s in self._dead_shards:
                continue
            kw = dict(path=path, stream_layout=self._layout(use_kernel),
                      row_map=self._row_map(s), row_map_key=("l2g", self._generation),
                      n_rows=self._gsent_scalar(s))
            try:
                faults_lib.fault_point("dispatch.shard")
                ex = self._executor(s)
                if batched:
                    v, r = ex.query_batched(x, sh.packed, **kw)
                else:
                    v, r = ex.query(x, sh.packed, **kw)
            except Exception as err:  # the failover boundary: the shard is marked dead
                last_error = err
                self._dead_shards.add(s)
                self.shard_errors[s] = traceback.format_exc()
                self.failovers += 1
                continue
            pools_v.append(v.to(merge_dev))     # device to device, big_k per shard
            pools_r.append(r.to(merge_dev))
        self.last_query_degraded = bool(self._dead_shards)
        if not pools_v:
            raise RuntimeError(
                "all shards failed dispatch: no pools to merge (recover with "
                "recover_shard() or rebuild from a checkpoint)"
            ) from last_error
        gsent = self._gsent_scalar()
        if self.mesh is not None:
            merge = (partition_lib.tree_merge_topk_batched if batched
                     else partition_lib.tree_merge_topk)
            return merge(pools_v, pools_r, self.config.big_k, gsent)
        merge = partition_lib.merge_rows_topk if batched else partition_lib.merge_topk
        return merge(torch.cat(pools_v, -1), torch.cat(pools_r, -1), self.config.big_k,
                     gsent)

    def spmv(self, x, alpha, beta, y, use_kernel: bool = True, resident: bool = False):
        """``alpha * A @ x + beta * y`` over the sharded collection.

        Each shard computes its rows' partial product in the *global* row
        space (``y``'s length fixes it) with unit scalars and a zero ``y``,
        and the partials add: every global row lives on exactly one shard,
        so the other shards' lanes are literal zeros and the sum equals the
        single-device scatter bit for bit.  ``resident`` is the executor's
        guard: x, alpha, beta and y must already be on the (merge) device.
        """
        n_out = int(y.shape[0])
        if n_out < self._next_gid:
            raise ValueError(
                f"y has {n_out} rows but the global id space holds {self._next_gid}: "
                "the accumulate output must cover every id"
            )
        if self._dead_shards:
            raise RuntimeError(
                "accumulate-mode SpMV needs every shard (a degraded partial product is "
                f"silently wrong); recover shards {sorted(self._dead_shards)} first"
            )
        if resident:
            _check_resident({"x": x, "alpha": alpha, "beta": beta, "y": y},
                            self._merge_device())
        else:
            x, y = self._on_device(x), self._on_device(y)
        if self._spmd is not None and use_kernel:
            return self._spmd.spmv(x, alpha, beta, y)
        return self._per_shard_spmv(x, alpha, beta, y, use_kernel)

    def _per_shard_spmv(self, x, alpha, beta, y, use_kernel: bool):
        """One accumulate dispatch per shard, then ``alpha * sum + beta * y``."""
        path = "accumulate" if use_kernel else "accumulate_ref"
        n_out = int(y.shape[0])
        merge_dev = self._merge_device()
        acc = None
        for s, sh in enumerate(self._shards):
            dev = self._shard_device(s)
            if s not in self._unit:
                self._unit[s] = tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                                      for v in (1.0, 0.0))
            one, zero = self._unit[s]
            zeros = self._zeros.get((s, n_out))
            if zeros is None:
                zeros = self._zeros[s, n_out] = torch.zeros(n_out, dtype=torch.float32,
                                                            device=dev)
            part = self._executor(s).spmv(
                x.to(dev), sh.packed, alpha=one, beta=zero, y=zeros, path=path,
                resident=True, stream_layout=self._layout(use_kernel),
                row_map=self._row_map(s), row_map_key=("l2g", self._generation))
            part = part.to(merge_dev)            # device to device
            acc = part if acc is None else acc + part
        return alpha * acc + beta * y

    def recover_shard(self, s: int) -> None:
        """Return a dead shard to serving, re-pinned from its host copy.

        The shard-local index (host arrays) survives a dispatch failure, and
        mutations keep applying to it while the shard is dead.  Recovery
        evicts the shard's device pins, so the next dispatch pins fresh
        copies of its current snapshot, and clears the dead mark.
        """
        if not 0 <= s < self.n_shards:
            raise ValueError(f"shard {s} out of range (0..{self.n_shards - 1})")
        self._executor(s).evict_snapshot(self._shards[s].packed.uid)
        self._dead_shards.discard(s)
        self.last_query_degraded = bool(self._dead_shards)

    def dispatch_info(self) -> dict:
        """Topology, health and per-shard signatures, with the executor's
        counters, or the mesh dispatch's and its bundle's."""
        info = {
            "path": "spmd" if self._spmd is not None else "per_shard",
            "topology": {
                "n_shards": self.n_shards,
                "n_replicas": self.n_replicas,
                "partitions_per_shard": self._cps,
                "mesh_axes": None if self.mesh is None else dict(self.mesh.shape),
            },
            "churn_stable": self.config.churn_stable,
            "health": {
                "dead_shards": list(self.dead_shards),
                "live_shard_fraction": self.live_shard_fraction,
                "failovers": self.failovers,
                "last_query_degraded": self.last_query_degraded,
            },
            "per_shard": [
                {
                    "version": sh.version,
                    "row_map_bucket": int(self._row_map(s).shape[0]),
                    "signature": sh.packed.signature_info(),
                }
                for s, sh in enumerate(self._shards)
            ],
        }
        if self._spmd is not None:
            info.update(self._spmd.info())
        else:
            info.update(self._executor(0).cache_info())
        return info


def _check_resident(operands: dict, device: torch.device) -> None:
    """Raise unless every operand is a tensor on ``device`` (a guarded loop
    uploads nothing)."""
    for name, t in operands.items():
        if not (isinstance(t, torch.Tensor) and t.device == device):
            where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
            raise RuntimeError(f"spmv operand {name} is not resident on {device} (got "
                               f"{where}); a guarded loop uploads nothing")


def _pad_dim(a: np.ndarray, axis: int, width: int, fill=0) -> np.ndarray:
    """``a`` padded along ``axis`` to ``width`` with ``fill`` (``a`` itself
    when it is that wide already)."""
    if a.shape[axis] == width:
        return a
    shape = list(a.shape)
    shape[axis] = width
    out = np.full(shape, fill, a.dtype)
    out[(slice(None),) * axis + (slice(0, a.shape[axis]),)] = a
    return out


def _word_width(packed) -> int:
    """Words per packet row of ``kernel_words(packed)``: the split arrays'
    bytes a row, fused into int32 words (``bscsr.fuse_words``)."""
    return sum(a.shape[2] * a.dtype.itemsize for a in (packed.flags, packed.cols,
                                                        packed.vals)) // 4


class _SpmdDispatcher:
    """The mesh dispatch, the reference's ``shard_map`` program: at every
    mesh position the kernel walks that position's pinned shard, finalizes
    under global ids, and the pools tree-merge over the shard axis.

    The bundle (``kernels.executor.ShardedDeviceBundle``) pins each shard's
    blocks at every position of its column, padded to buckets common to all
    shards, and ships only what changed.  One function per (Q bucket,
    signature) drives the positions (``fn_builds``, ``retraces``).  A batch
    fans out over the replica axis: replica row r answers rows
    ``[r * b / R, (r + 1) * b / R)`` of the padded batch.  A single query and
    ``spmv`` run on replica row 0: the reference's replicated outputs are
    equal on every row, so the other rows would compute the same bits.
    """

    def __init__(self, owner: ShardedTopKSpMVIndex):
        self.owner = owner
        self.mesh = owner.mesh
        self.s_count = owner.n_shards
        self.bundle = executor_lib.ShardedDeviceBundle(self.mesh, "shard")
        self.layout = "split" if owner._hetero else owner.config.stream_layout
        self._gather = kernel_ops.resolve_gather_mode(owner.config.gather_mode)
        # Queries fan out over the replica axis when the mesh has one (the
        # logical axes live in sharding.rules, shared with the model plane).
        self._rep_axis = rules_lib._present(
            self.mesh, rules_lib.DEFAULT_RULES.lookup("topk_queries"))
        self.r_count = int(self.mesh.shape[self._rep_axis]) if self._rep_axis else 1
        # The positions of shards 0..S-1 in each replica row (other axes at 0;
        # their positions hold the same pins and would compute the same bits).
        names = self.mesh.axis_names
        self._rows = [[None] * self.s_count for _ in range(self.r_count)]
        for pos in self.mesh.positions():
            rep = pos[names.index(self._rep_axis)] if self._rep_axis else 0
            if all(i == 0 for n, i in zip(names, pos) if n not in ("shard", self._rep_axis)):
                self._rows[rep][pos[names.index("shard")]] = pos
        self._lock = threading.Lock()   # bundle, function cache, counters
        self._fns: dict = {}       # (q bucket | None | ("spmv", n), signature) -> fn
        self._last_sig: dict = {}  # key -> signature it last built
        self._tables: dict = {}    # position -> (words piece, {S: split table})
        self._row_starts: dict = {}  # position -> zero (C/S,) row starts
        self.fn_builds = 0
        self.retraces = 0
        self.dispatches = 0
        self.q_bucket_hits = 0
        self.q_exact_hits = 0

    # -- device sync ---------------------------------------------------------

    def _sync(self):
        """The families at every position, shipping only changed bytes.

        Per-shard blocks pad to COMMON buckets (max over shards per dim) so
        one function serves every shard: words with 0 (flag-free packets
        past a shard's last step, which no split walks), slot maps and
        ``l2g`` with INVALID_ROW, tombstones with False.  The word family
        ships at partition granularity via the COW mutation stamps.
        """
        o = self.owner
        packs = [sh.packed for sh in o._shards]
        versions = [(o._generation, sh.version) for sh in o._shards]
        cps = o._cps
        # Offset stamps by the generation: compact() rebuilds shard-local
        # indexes whose stamp counters RESTART, and a coincidental stamp
        # match must not suppress shipping the re-encoded partitions.
        gen_off = np.int64(o._generation) << np.int64(33)
        stamps = [sh._part_stamps + gen_off for sh in o._shards]
        p_common = max(p.vals.shape[1] for p in packs)
        words = self.bundle.sync(
            "words", (cps, p_common, _word_width(packs[0])), np.int32,
            lambda s: _pad_dim(kernel_ops.kernel_words(packs[s]), 1, p_common),
            versions, stamps=stamps)
        l_common = max(p.slot_to_row.shape[1] for p in packs)
        slot = self.bundle.sync(
            "slot", (cps, l_common), np.int32,
            lambda s: _pad_dim(packs[s].slot_to_row, 1, l_common, _INVALID), versions)
        nslots = self.bundle.sync(
            "nslots", (cps,), np.int32,
            lambda s: np.asarray(packs[s].candidate_slots, np.int32), versions)
        tl_common = max(p.tombstones.shape[0] for p in packs)
        tombs = self.bundle.sync(
            "tombs", (tl_common,), bool,
            lambda s: _pad_dim(packs[s].tombstones, 0, tl_common, False), versions)
        maps = [o._row_map(s) for s in range(self.s_count)]
        lg_common = max(m.shape[0] for m in maps)
        l2g = self.bundle.sync(
            "l2g", (lg_common,), np.int32,
            lambda s: _pad_dim(maps[s], 0, lg_common, _INVALID), versions)
        gsent = self.bundle.sync_replicated(
            "gsent", np.asarray(o._next_gid, np.int32), o._next_gid)
        args = (words, slot, nslots, tombs, l2g, gsent)
        sig = (self.layout, tuple((a.shape, str(a.dtype)) for a in args))
        return args, sig

    # -- functions -----------------------------------------------------------

    def _table(self, pos, words: torch.Tensor, splits: int):
        """The split table of the words at ``pos``, rebuilt whenever the
        bundle ships into them (a shipped piece is a new tensor)."""
        return executor_lib.position_split_table(
            self._tables, pos, words, splits,
            packets_per_step=self.owner.config.packets_per_step,
            block_size=self.owner._shards[0].packed.block_size)

    def _starts(self, pos, device) -> torch.Tensor:
        t = self._row_starts.get(pos)
        if t is None:
            t = self._row_starts[pos] = torch.zeros(self.owner._cps, dtype=torch.int64,
                                                    device=device)
        return t

    def _kernel_kw(self, args) -> dict:
        cfg = self.owner.config
        pack0 = self.owner._shards[0].packed
        return dict(n_rows=int(args[1].shape[2]),    # the common slot bucket
                    packets_per_step=cfg.packets_per_step, fmt_name=pack0.value_format.name,
                    block_size=pack0.block_size, inner_loop=cfg.inner_loop)

    def _tree_merge(self, row, pools, gsent, batched: bool):
        """Merge the shard pools of one replica row -> the answer at its
        first position: the pools move to that position's device and tree-
        merge there (``partition.tree_merge_topk``).  Any merge order gives
        the same bits; in one process the reference's rounds of XOR partners
        would only repeat every merge at each position of the row."""
        dev = pools[0][0].device
        merge = (partition_lib.tree_merge_topk_batched if batched
                 else partition_lib.tree_merge_topk)
        return merge([v.to(dev) for v, _ in pools], [r.to(dev) for _, r in pools],
                     self.owner.config.big_k, gsent.pieces[row[0]])

    def _build(self, q, args):
        if isinstance(q, tuple) and q[0] == "spmv":
            return self._build_spmv(q[1], args)
        cfg = self.owner.config
        big_k = cfg.big_k
        kw = dict(self._kernel_kw(args), k=cfg.k, gather_mode=self._gather)
        batched = q is not None
        finalize = (kernel_ops.finalize_candidates_batched if batched
                    else kernel_ops.finalize_candidates)

        def local(pos, x, args):
            words, slot, nslots, tombs, l2g, gsent = (a.pieces[pos] for a in args)
            lv, lr = executor_lib.local_topk(x.to(words.device), words, self._tables, pos,
                                             **kw)
            return finalize(lv, lr, self._starts(pos, words.device), nslots, big_k, gsent,
                            slot_to_row=slot, tombstones=tombs, row_map=l2g)

        def answer(row, x, args):
            return self._tree_merge(row, [local(pos, x, args) for pos in row], args[5],
                                    batched)

        if not batched:
            return lambda x, args: answer(self._rows[0], x, args)

        def run(xs, args):
            per = xs.shape[0] // self.r_count
            out = [answer(row, xs[i * per:(i + 1) * per], args)
                   for i, row in enumerate(self._rows)]
            dev = xs.device
            return (torch.cat([v.to(dev) for v, _ in out]),
                    torch.cat([r.to(dev) for _, r in out]))

        return run

    def _build_spmv(self, n_out: int, args):
        """The accumulate function: per-shard kernel + global-row scatter at
        each position of replica row 0, the partials summed in shard order
        on the merge device (the reference's ``psum``: off-owner lanes are
        literal zeros, so the sum is the single-device scatter bit for bit),
        then ``alpha * Ax + beta * y``."""
        o = self.owner
        kw = self._kernel_kw(args)
        kw.pop("inner_loop")
        t, block = kw["packets_per_step"], kw["block_size"]
        cfg = o.config

        def run(x, alpha, beta, y, args):
            acc = None
            for pos in self._rows[0]:
                words, slot, nslots, tombs, l2g, _ = (a.pieces[pos] for a in args)
                xs = x.to(words.device)
                splits = spmv_splits(words.device, o._cps, packets_per_step=t,
                                     block_size=block, m=xs.shape[0])
                sums = bscsr_spmv(xs, words, table=self._table(pos, words, splits),
                                  gather_mode=self._gather, inner_loop=cfg.inner_loop, **kw)
                part = kernel_ops.scatter_slot_sums(
                    sums, self._starts(pos, words.device), nslots, n_out,
                    slot_to_row=slot, tombstones=tombs, row_map=l2g).to(y.device)
                acc = part if acc is None else acc + part
            return alpha * acc + beta * y

        return run

    def _fn(self, q, args, sig):
        key = (q, sig)
        fn = self._fns.get(key)
        if fn is None:
            # A signature change means a common bucket moved: every cached
            # function of the old signature is stale, drop them all.
            self._fns = {kk: f for kk, f in self._fns.items() if kk[1] == sig}
            fn = self._build(q, args)
            self._fns[key] = fn
            self.fn_builds += 1
            prev = self._last_sig.get(q)
            if prev is not None and prev != sig:
                self.retraces += 1
            self._last_sig[q] = sig
        return fn

    # -- dispatch ------------------------------------------------------------

    def query(self, x: torch.Tensor):
        """One (M,) query through the single-query kernel, on replica row 0."""
        with self._lock:
            args, sig = self._sync()
            fn = self._fn(None, args, sig)
            self.dispatches += 1
        return fn(x, args)

    def spmv(self, x, alpha, beta, y):
        with self._lock:
            args, sig = self._sync()
            fn = self._fn(("spmv", int(y.shape[0])), args, sig)
            self.dispatches += 1
        return fn(x, alpha, beta, y, args)

    def query_batched(self, xs: torch.Tensor):
        """A (Q, M) batch through the multi-query kernel on every replica
        row: padded to ``R * _q_bucket(ceil(Q / R))`` rows (zeros), the
        padding dropped from the answer.  A row carries at least two
        queries when Q does, so every row takes the walk one device takes
        for the pass (``multiquery_walk``) and gives its bits."""
        q = int(xs.shape[0])
        if q == 0:
            raise ValueError("xs must be a non-empty (Q, M) batch")
        r = self.r_count
        per_row = -(-q // r) if q == 1 else max(-(-q // r), 2)
        bucket = r * executor_lib._q_bucket(per_row)
        if bucket != q:
            xs = torch.cat([xs, xs.new_zeros((bucket - q, xs.shape[1]))])
        with self._lock:
            args, sig = self._sync()
            builds_before = self.fn_builds
            fn = self._fn(bucket, args, sig)
            if self.fn_builds == builds_before:   # reused a function
                if bucket != q:
                    self.q_bucket_hits += 1       # padded into a shared bucket
                else:
                    self.q_exact_hits += 1
            self.dispatches += 1
        vals, rows = fn(xs, args)
        return vals[:q], rows[:q]

    def info(self) -> dict:
        with self._lock:
            return {
                "compiled_fns": len(self._fns),
                "fn_builds": self.fn_builds,
                "retraces": self.retraces,
                "dispatches": self.dispatches,
                "q_bucket_hits": self.q_bucket_hits,
                "q_exact_hits": self.q_exact_hits,
                "bundle": self.bundle.counters(),
            }
