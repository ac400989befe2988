"""Carry a packed snapshot or a durable state across from the reference package.

The state of this system is its packed snapshot (there are no weights): the
per-core streams plus the slot bookkeeping.  ``packed_from_arrays`` builds
the port's ``PackedPartitions`` from plain numpy fields, so both packages can
answer over the identical snapshot.  A 16-bit value stream may arrive in any
2-byte dtype (the reference keeps bf16 as ``ml_dtypes.bfloat16``); its bytes
are kept and viewed as ``uint16``.  ``state_from_reference`` does the same
for a mutable index's ``export_state`` output, so a store the reference's
``DurableIndexStore`` wrote recovers in this package.

``params_from_reference`` carries an LM's weights across: the reference's
param tree (numpy arrays, leading layer axes on its stacked subtrees)
becomes the family's model, whose state dict holds the same values per
layer, each in the dtype its op reads.  For training, ``named_from_reference``
gives the same tree as named float32 tensors (the trainer's masters),
``opt_state_from_reference`` the reference's AdamW state as the port's, and
``tree_to_reference`` takes named tensors (masters, gradients, moments)
back to the reference's stacked tree as numpy.

Nothing else needs carrying: a ``ShardedTopKSpMVIndex`` and an
``ApproxTopKHead`` hold no state beyond what they build from the same CSR
collection (or, for the head, the same dense embedding) that the reference
is given.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.partition import PartitionPlan
from repro_torch.core.quantization import FORMATS
from repro_torch.kernels.ops import PackedPartitions
from repro_torch.models.layers import LanguageModel
from repro_torch.models.model_zoo import STACKED, get_model

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


def named_from_reference(tree: Mapping, device: str = "cpu") -> Dict[str, torch.Tensor]:
    """The reference's param-shaped tree as ``{state-dict name: float32
    tensor}`` on ``device``: a stacked subtree's slices become
    ``<subtree>.<i>[.<j>].<path>`` (``blocks``; Zamba's ``mamba`` (g, e) and
    ``mamba_tail``; xLSTM's ``mlstm`` (g, m) and ``slstm``; Whisper's
    ``enc_blocks`` and ``dec_blocks``)."""
    state = {}

    def walk(tree: Mapping, prefix: str, axes: int) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.", axes if prefix else STACKED.get(name, 0))
                continue
            arr = np.array(value, np.float32)        # a writable copy
            if not axes:
                state[prefix + name] = torch.from_numpy(arr).to(device)
                continue
            top, inner = prefix.split(".", 1)
            for idx in np.ndindex(*arr.shape[:axes]):
                key = ".".join([top, *map(str, idx), inner + name])
                state[key] = torch.from_numpy(np.ascontiguousarray(arr[idx])).to(device)

    walk(tree, "", 0)
    return state


def tree_to_reference(named: Mapping[str, torch.Tensor]) -> dict:
    """Named tensors (any dtype, any device) back in the reference's nested,
    layer-stacked tree, as float32 numpy: the inverse of
    ``named_from_reference``."""
    tree: dict = {}
    stacked: dict = {}
    for name, value in named.items():
        parts = name.split(".")
        arr = value.detach().float().cpu().numpy()
        axes = STACKED.get(parts[0], 0)
        if axes:
            idx = tuple(int(i) for i in parts[1:1 + axes])
            stacked.setdefault((parts[0], *parts[1 + axes:]), {})[idx] = arr
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    for (top, *path), slices in stacked.items():
        shape = tuple(int(n) + 1 for n in np.max(list(slices), axis=0))
        leaf = np.stack([slices[i] for i in np.ndindex(*shape)])
        node = tree.setdefault(top, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf.reshape(*shape, *leaf.shape[1:])
    return tree


def opt_state_from_reference(opt: Mapping, device: str = "cpu") -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` as the port's:
    both moments as named float32 tensors, ``step`` a 0-d int32 tensor."""
    return {"mu": named_from_reference(opt["mu"], device),
            "nu": named_from_reference(opt["nu"], device),
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                 device=device)}


def params_from_reference(params: Mapping, cfg, device: str = "cuda") -> LanguageModel:
    """The family's model on ``device`` holding the reference's params.

    ``params`` is the reference's tree for ``cfg`` (arrays of any kind that
    ``np.asarray`` reads).  A stacked subtree's slices become
    ``<subtree>.<i>[.<j>].<path>`` (``blocks``; Zamba's ``mamba`` (g, e) and
    ``mamba_tail``; xLSTM's ``mlstm`` (g, m) and ``slstm``; Whisper's
    ``enc_blocks`` and ``dec_blocks``); every name of the model's state dict
    must be given once.  Whisper's model takes ``dec_pos``'s rows as its
    ``max_seq``.  The reference's float32 ``embed.tok`` rows are kept as the
    model's ``head_source``.
    """
    state = named_from_reference(params)
    max_seq = np.shape(params["dec_pos"])[0] if "dec_pos" in params else 0
    model = get_model(cfg).build(device, max_seq)
    model.load_state_dict(state, strict=True)
    model.keep_head_source(state["embed.tok"])
    return model
