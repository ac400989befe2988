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

This is the reference's per-shard path (``mesh=None, n_shards=S``): every
shard dispatches on the config's device, one after another.  The mesh
dispatch (shards pinned per device, replica fan-out) is ROADMAP Queue 1
item 3's next step and raises here.
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core.precision_model import expected_precision
from repro_torch.core.topk_spmv import MutableTopKSpMVIndex, TopKSpMVConfig, query_executor
from repro_torch.kernels import ops as kernel_ops

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
        if mesh is not None:
            raise NotImplementedError(
                "mesh dispatch is not ported yet: ROADMAP Queue 1 item 3 (the mesh "
                "dispatch over torch devices); pass n_shards= for the per-shard path"
            )
        config = config or TopKSpMVConfig()
        self.config = config
        self.native_groups = native_groups
        s = int(n_shards) if n_shards is not None else 1
        if s < 1:
            raise ValueError(f"n_shards must be >= 1, got {s}")
        self.n_shards = s
        self.n_replicas = 1
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
        self._gsent = None               # (next_gid, pinned 0-d tensor)
        self._unit = None                # pinned (1.0, 0.0) for partial products
        self._zeros: dict = {}           # n_out -> pinned zero vector
        self._live_csr_cache = None

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

    def _gsent_scalar(self) -> torch.Tensor:
        """The current global row-id sentinel, pinned on the device."""
        if self._gsent is None or self._gsent[0] != self._next_gid:
            self._gsent = (self._next_gid, torch.tensor(self._next_gid, dtype=torch.int32,
                                                        device=self._device))
        return self._gsent[1]

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self._device).contiguous()

    def _layout(self, use_kernel: bool) -> Optional[str]:
        """``"split"`` (the f32 twins) for a mixed index without native groups."""
        return "split" if use_kernel and self._hetero and not self.native_groups else None

    def query(self, x, use_kernel: bool = True):
        """Top-``big_k`` (values, global row ids) for one (M,) query."""
        return self._per_shard_query(x, use_kernel, batched=False)

    def query_batched(self, xs, use_kernel: bool = True):
        """(Q, big_k) answers for a (Q, M) batch."""
        return self._per_shard_query(xs, use_kernel, batched=True)

    def _per_shard_query(self, x, use_kernel: bool, batched: bool):
        """One executor dispatch per shard, then one merge of the pools.

        Every shard's snapshot, row map and the global sentinel are pinned,
        so a steady-state query is S dispatches and one merge, with no
        upload but the query's own.

        **Failover:** a shard whose dispatch raises is marked dead and its
        pool dropped from the merge; the sentinel normalisation makes an
        absent pool merge-safe, so the survivors' answer is exactly the full
        answer restricted to their rows.  Queries serve degraded
        (``last_query_degraded``, ``live_shard_fraction``) until
        :meth:`recover_shard` re-pins the shard from its intact host copy.
        """
        ex = query_executor(self._local_config)
        x = self._on_device(x)              # uploaded once for all shards
        want = "(Q, M) batch" if batched else "(M,) query"
        if x.dim() != (2 if batched else 1) or x.shape[-1] != self.n_cols or not x.numel():
            # A malformed query is the caller's error: it must not kill shards.
            raise ValueError(f"x must be a non-empty {want} with M = {self.n_cols}, "
                             f"got {tuple(x.shape)}")
        path = "kernel" if use_kernel else "reference"
        gsent = self._gsent_scalar()
        pools_v, pools_r = [], []
        last_error = None
        for s, sh in enumerate(self._shards):
            if s in self._dead_shards:
                continue
            kw = dict(path=path, stream_layout=self._layout(use_kernel),
                      row_map=self._row_map(s), row_map_key=("l2g", self._generation),
                      n_rows=gsent)
            try:
                faults_lib.fault_point("dispatch.shard")
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
            pools_v.append(v)
            pools_r.append(r)
        self.last_query_degraded = bool(self._dead_shards)
        if not pools_v:
            raise RuntimeError(
                "all shards failed dispatch: no pools to merge (recover with "
                "recover_shard() or rebuild from a checkpoint)"
            ) from last_error
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
        guard: x, alpha, beta and y must already be on the device.
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
        return self._per_shard_spmv(x, alpha, beta, y, use_kernel, resident)

    def _per_shard_spmv(self, x, alpha, beta, y, use_kernel: bool, resident: bool):
        """One accumulate dispatch per shard, then ``alpha * sum + beta * y``."""
        ex = query_executor(self._local_config)
        path = "accumulate" if use_kernel else "accumulate_ref"
        n_out = int(y.shape[0])
        if not resident:
            x, y = self._on_device(x), self._on_device(y)
        if self._unit is None:
            self._unit = tuple(torch.tensor(v, dtype=torch.float32, device=self._device)
                               for v in (1.0, 0.0))
        one, zero = self._unit
        zeros = self._zeros.get(n_out)
        if zeros is None:
            zeros = self._zeros[n_out] = torch.zeros(n_out, dtype=torch.float32,
                                                     device=self._device)
        acc = None
        for s, sh in enumerate(self._shards):
            part = ex.spmv(x, sh.packed, alpha=one, beta=zero, y=zeros, path=path,
                           resident=True, stream_layout=self._layout(use_kernel),
                           row_map=self._row_map(s), row_map_key=("l2g", self._generation))
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
        query_executor(self._local_config).evict_snapshot(self._shards[s].packed.uid)
        self._dead_shards.discard(s)
        self.last_query_degraded = bool(self._dead_shards)

    def dispatch_info(self) -> dict:
        """Topology, health and per-shard signatures, with the executor's
        counters (the reference's per-shard fields)."""
        info = {
            "path": "per_shard",
            "topology": {
                "n_shards": self.n_shards,
                "n_replicas": self.n_replicas,
                "partitions_per_shard": self._cps,
                "mesh_axes": None,
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
        info.update(query_executor(self._local_config).cache_info())
        return info
