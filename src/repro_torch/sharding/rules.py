"""Logical axis -> mesh axis mapping with divisibility fallback (MaxText-style).

Every parameter / activation dimension is named with a *logical* axis; the
rules table maps logical axes to mesh axes.  If a dimension is not divisible
by the mapped mesh-axis size the mapping is dropped for that tensor (the
fallback keeps e.g. smollm's 15 heads on a 16-way model axis by replicating
attention weights while the MLP stays sharded).

The reference's ``repro/sharding/rules.py``, ported over
:class:`~repro_torch.launch.mesh.DeviceMesh`.  A spec is a tuple with one
entry per leading dimension (a mesh axis name, a tuple of names, or None),
trailing Nones dropped: the contents of the reference's ``PartitionSpec``.
A sharding is ``(mesh, spec)``.  The models' ``*_specs`` write their
logical specs with :func:`P` in the same form.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

LogicalAxis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]


def P(*entries: LogicalAxis) -> tuple:
    """A spec in the port's form: the reference's ``PartitionSpec(*entries)``
    as a tuple, trailing Nones dropped."""
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axis names."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def lookup(self, logical: LogicalAxis) -> MeshAxes:
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return target
        return None

    def replace(self, **overrides: MeshAxes) -> "ShardingRules":
        new = dict(self.rules)
        new.update(overrides)
        return ShardingRules(tuple(new.items()))


# Production defaults: batch is pure DP over (pod, data); weights are
# FSDP-sharded over "data" on their input/embed dim and tensor-sharded over
# "model" on heads/mlp/vocab/experts dims; optimizer state follows params.
DEFAULT_RULES = ShardingRules(
    rules=(
        ("batch", ("pod", "data")),
        # serving plane (launch.mesh.make_serving_mesh): the top-k index's
        # leading shard dim and the query batch's replica fan-out.  Both drop
        # harmlessly on model meshes without these axes (_present filters).
        ("topk_shards", "shard"),
        ("topk_queries", "replica"),
        ("seq", None),
        # decode caches: kv_heads (earlier dim) takes "model" when divisible;
        # otherwise the seq dim picks the axis up (greedy per-tensor dedup),
        # so the cache is never replicated on the model axis
        ("cache_seq", "model"),
        ("embed", None),           # activations: d_model replicated
        ("embed_fsdp", "data"),    # weights: d_model dim sharded (ZeRO-3/FSDP)
        ("heads", "model"),
        ("kv_heads", "model"),
        ("mlp", "model"),
        ("vocab", "model"),
        # experts take the model axis when divisible (EP); otherwise the
        # greedy per-tensor dedup lets expert_mlp pick the axis up instead
        # (TP inside each expert)
        ("experts", "model"),
        ("expert_mlp", "model"),
        # capacity-dim sharding is arch-dependent: archs whose expert count
        # cannot take the model axis override this to ("pod", "data")
        ("expert_cap", None),
        ("layers", None),
        ("ssm_state", None),
        ("ssm_heads", "model"),
        ("conv_dim", "model"),
    )
)


def _axis_size(mesh, target: MeshAxes) -> int:
    if target is None:
        return 1
    if isinstance(target, str):
        return mesh.shape.get(target, 1)
    size = 1
    for t in target:
        size *= mesh.shape.get(t, 1)
    return size


def _present(mesh, target: MeshAxes) -> MeshAxes:
    """Drop mesh axes that don't exist in this mesh (e.g. 'pod' single-pod)."""
    if target is None:
        return None
    if isinstance(target, str):
        return target if target in mesh.shape else None
    kept = tuple(t for t in target if t in mesh.shape)
    if not kept:
        return None
    # unwrap 1-tuples: ("data",) and "data" shard identically
    return kept[0] if len(kept) == 1 else kept


def logical_to_spec(
    logical_dims: Sequence[LogicalAxis],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> tuple:
    """Build a spec tuple, dropping non-divisible / absent mappings."""
    out = []
    used: set = set()
    for dim, logical in zip(shape, logical_dims):
        target = _present(mesh, rules.lookup(logical))
        if target is not None:
            flat = (target,) if isinstance(target, str) else target
            if any(t in used for t in flat):
                target = None  # a mesh axis may shard only one dim
        if target is not None and dim % _axis_size(mesh, target) != 0:
            target = None  # divisibility fallback
        if target is not None:
            flat = (target,) if isinstance(target, str) else target
            used.update(flat)
        out.append(target)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_sharding(
    logical_dims: Sequence[LogicalAxis],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> tuple:
    """``(mesh, spec)``: the port's ``NamedSharding``."""
    return mesh, logical_to_spec(logical_dims, shape, mesh, rules)


def shard_params(params: Any, specs: Any, mesh, rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Tree of ``(mesh, spec)`` shardings for a (params, logical-specs) pair.

    ``params`` is a tree of dicts, lists and tuples whose leaves have a
    ``shape``; ``specs`` has the same structure with a tuple of *logical*
    names at each leaf, e.g. ``("layers", "embed_fsdp", "mlp")``, resolved
    per tensor against the mesh with divisibility fallback.
    """
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh, rules) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(p, s, mesh, rules) for p, s in zip(params, specs))
    return logical_sharding(tuple(specs), tuple(params.shape), mesh, rules)


_ACTIVE_RULES = [DEFAULT_RULES]


class use_rules:
    """Context manager scoping the rules consulted by in-model constrain()
    calls: how per-arch sharding overrides reach them."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()
        return False


def active_rules() -> ShardingRules:
    return _ACTIVE_RULES[-1]


def constrain(x, logical_dims: Sequence[LogicalAxis], mesh=None,
              rules: Optional[ShardingRules] = None):
    """The reference's ``with_sharding_constraint`` by logical dims.

    On a grid of devices in one process there is no compiler to hint: the
    tensor's placement is whatever the code that made it chose.  So this
    checks that ``logical_dims`` names every dimension of ``x`` and returns
    ``x`` unchanged.
    """
    if len(logical_dims) != len(x.shape):
        raise ValueError(f"{len(logical_dims)} logical dims for a tensor of rank "
                         f"{len(x.shape)}")
    return x
