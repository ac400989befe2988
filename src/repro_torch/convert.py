"""Carry a packed snapshot or a durable state across from the reference package.

The state of this system is its packed snapshot (there are no weights): the
per-core streams plus the slot bookkeeping.  ``packed_from_arrays`` builds
the port's ``PackedPartitions`` from plain numpy fields, so both packages can
answer over the identical snapshot.  A 16-bit value stream may arrive in any
2-byte dtype (the reference keeps bf16 as ``ml_dtypes.bfloat16``); its bytes
are kept and viewed as ``uint16``.  ``state_from_reference`` does the same
for a mutable index's ``export_state`` output, so a store the reference's
``DurableIndexStore`` wrote recovers in this package.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from repro_torch.core.partition import PartitionPlan
from repro_torch.core.quantization import FORMATS
from repro_torch.kernels.ops import PackedPartitions

_OPTIONAL_ARRAYS = ("words", "slot_to_row", "num_slots", "tombstones")
_OPTIONAL_COUNTS = ("n_rows_total", "base_packets", "delta_nnz", "dead_nnz",
                    "tombstone_count")


def packed_from_arrays(fields: Mapping) -> PackedPartitions:
    """A ``PackedPartitions`` from plain fields.

    Required: ``vals``, ``cols``, ``flags`` (numpy), ``plan`` (a mapping with
    ``n_rows`` and ``num_partitions``, and optionally ``row_starts`` /
    ``rows_per_partition``, which must then match the even split),
    ``n_cols``, ``nnz``, ``block_size`` and ``value_format`` (a format
    name).  Optional: ``stream_layout``, ``words``, and the segmented fields
    ``slot_to_row``, ``num_slots``, ``n_rows_total``, ``tombstones``,
    ``base_packets``, ``delta_nnz``, ``dead_nnz`` and ``tombstone_count``
    (the churn counters ``stats()`` reports).
    """
    fmt = FORMATS[str(fields["value_format"])]
    vals = np.asarray(fields["vals"])
    if vals.dtype.itemsize != fmt.np_dtype.itemsize:
        raise ValueError(f"vals dtype {vals.dtype} does not store {fmt.name}")
    vals = np.ascontiguousarray(vals).view(fmt.np_dtype)
    p = fields["plan"]
    plan = PartitionPlan.build(int(p["n_rows"]), int(p["num_partitions"]))
    for name in ("row_starts", "rows_per_partition"):
        if name in p and tuple(int(v) for v in p[name]) != getattr(plan, name):
            raise ValueError(f"plan {name} differs from the even row split")
    if vals.shape[0] != plan.num_partitions:
        raise ValueError(f"{vals.shape[0]} streams for {plan.num_partitions} partitions")
    kw = {name: np.asarray(fields[name]) for name in _OPTIONAL_ARRAYS
          if fields.get(name) is not None}
    for name in _OPTIONAL_COUNTS:
        if fields.get(name) is not None:
            kw[name] = int(fields[name])
    return PackedPartitions(
        vals=vals,
        cols=np.asarray(fields["cols"]),
        flags=np.asarray(fields["flags"]),
        plan=plan,
        n_cols=int(fields["n_cols"]),
        nnz=int(fields["nnz"]),
        block_size=int(fields["block_size"]),
        value_format=fmt,
        stream_layout=str(fields.get("stream_layout", "split")),
        **kw,
    )


def state_from_reference(meta: Mapping, arrays: Mapping, device: str = "cuda"
                         ) -> Tuple[dict, dict]:
    """A reference ``(meta, arrays)`` state as this package's.

    The config loses ``interpret`` and gains ``device``; bf16 arrays are
    viewed as ``uint16`` bits.  Everything else (schema 1, array names,
    caps) is shared.
    """
    config = {k: v for k, v in meta["config"].items() if k != "interpret"}
    config["device"] = device
    out = {k: (np.asarray(a).view(np.uint16) if np.asarray(a).dtype.name == "bfloat16"
               else np.asarray(a)) for k, a in arrays.items()}
    return dict(meta, config=config), out
