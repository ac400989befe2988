"""Roofline terms from counted costs: ``launch/analysis.py``'s counterpart.

The reference reads cost, memory and collective numbers out of a compiled
XLA executable and prices them at TPU v5e peaks.  The port's costs come
from ``op_costs.OpCounter`` (the aten ops a step dispatches, the kernel
wrappers' own records) and its memory and collectives from ``dryrun`` (the
pieces the port's placement holds and moves), priced here at one NVIDIA
H100 SXM's published peaks:

  bf16 tensor-core products     989e12 FLOP/s   (``PEAK_FLOPS_BF16``)
  f32 products, outside them     67e12 FLOP/s   (``PEAK_FLOPS_F32``)
  HBM3                          3.35e12 bytes/s (``HBM_BW``)
  NVLink                         450e9 bytes/s each way (``NVLINK_BW``)

NVLink takes the place of the reference's ``ICI_BW``: one link rate, as the
reference models one ICI rate.  Links between hosts are not modelled.
``chip_smoke.py`` prices its bounds with these same constants.

There is no HLO to parse, so the reference's ``parse_collectives`` and
``collective_bytes_total`` have no counterpart here: ``dryrun`` computes the
collective breakdown from the port's placement.  There is no compiler cost
analysis either, so ``analyze_counted`` returns no ``cost_xla_raw``.

Imports nothing (not even torch), so a script can read the constants before
it imports torch.
"""
from __future__ import annotations

import dataclasses

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# NVIDIA H100 SXM (80 GB HBM3) published peaks, per card.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core peak
PEAK_FLOPS_F32 = 67e12            # f32 outside the tensor cores (TF32 off)
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s each way (NVLink 4, 18 links)


@dataclasses.dataclass
class RooflineTerms:
    """The three per-step roofline terms (seconds) on the target card.

    ``flops`` counts every product, ``flops_f32`` the float32 ones among
    them, priced at ``PEAK_FLOPS_F32``; the rest run at ``PEAK_FLOPS_BF16``.
    """

    flops: float              # per-device counted flops
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device NVLink bytes
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0  # 6*N*D (or 6*N_active*D) global
    useful_ratio: float = 0.0  # model_flops / the FLOPs executed on all chips
    flops_f32: float = 0.0

    @staticmethod
    def build(flops, hbm_bytes, coll_bytes, chips, model_flops=0.0, flops_f32=0.0,
              executed_flops=None):
        """``executed_flops`` is the step's FLOPs over every chip; by
        default ``flops * chips``, the reference's reading of an SPMD step
        in which each chip does the same work.  The port's mesh step does
        not: position 0 computes it, and ``dryrun`` passes the total."""
        compute_s = (flops - flops_f32) / PEAK_FLOPS_BF16 + flops_f32 / PEAK_FLOPS_F32
        memory_s = hbm_bytes / HBM_BW
        collective_s = coll_bytes / NVLINK_BW
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        bn = max(terms, key=terms.get)
        executed = flops * chips if executed_flops is None else executed_flops
        useful = model_flops / executed if executed else 0.0
        return RooflineTerms(
            flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
            chips=chips, compute_s=compute_s, memory_s=memory_s,
            collective_s=collective_s, bottleneck=bn,
            model_flops=model_flops, useful_ratio=useful, flops_f32=flops_f32,
        )

    @property
    def bound_s(self) -> float:
        """The step's least time on one card: the larger of compute and memory."""
        return max(self.compute_s, self.memory_s)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze_counted(costs: dict, memory: dict, chips: int, model_flops: float = 0.0,
                    executed_flops=None) -> dict:
    """The reference's ``analyze_compiled`` dict from counted costs.

    ``costs`` is ``op_costs``'s (``flops``, ``flops_f32``, ``hbm_bytes``,
    ``coll_bytes``, ``convert_bytes``, ``coll_breakdown``), per device;
    ``memory`` the per-device byte sizes ``dryrun`` computes;
    ``executed_flops`` as in :meth:`RooflineTerms.build`.  Returns
    ``memory``, ``collectives`` and ``roofline`` (with ``convert_bytes``,
    ``memory_s_excl_converts`` and ``bound_s``).
    """
    terms = RooflineTerms.build(costs["flops"], costs["hbm_bytes"], costs["coll_bytes"],
                                chips, model_flops, costs.get("flops_f32", 0.0),
                                executed_flops)
    convert_s = costs.get("convert_bytes", 0.0) / HBM_BW
    out = terms.as_dict()
    out["convert_bytes"] = costs.get("convert_bytes", 0.0)
    out["memory_s_excl_converts"] = max(out["memory_s"] - convert_s, 0.0)
    out["bound_s"] = terms.bound_s
    return {"memory": dict(memory), "collectives": costs["coll_breakdown"], "roofline": out}
