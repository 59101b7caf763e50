"""Roofline terms of a dry-run's counts on the H100 (port of
``repro.launch.roofline``).

    compute    = Σ_types FLOPs of the type / PEAK_OPS[type]    [s]
    memory     = bytes accessed / HBM_BW                       [s]
    collective = Σ_axes collective bytes / link rate of the axis [s]

The counts are one rank's (``launch/dryrun.py``: the aten ops' flops and
bytes plus each kernel's ``kernels/cost.py`` count), so the per-card rates
divide directly.  The flops come by the peak they run at (``flops_by_rate``:
16-bit operands on the tensor cores, fp32 outside them, as
``kernels/cost.rate_of`` and :func:`bound` charge one kernel); a count
without that split is charged at ``PEAK_FLOPS``.  Collective bytes are each collective's operand bytes under
the reference's rule (``sharding/collectives.operand_bytes``), counted by
the dry-run's counting groups in place of parsing HLO.

The card's figures (NVIDIA H100 data sheets, SXM part, dense rates without
sparsity, at the full 700 W power limit):

  * ``PEAK_OPS``: 989 TFLOP/s bf16 on the tensor cores (``PEAK_FLOPS``),
    67 TFLOP/s fp32 outside them;
  * ``MEMORY_RATE``: 3.35 TB/s of HBM3 on the SXM part (``HBM_BW``), and
    the other parts' by name for a card that reports one of them;
  * ``NVLINK_BW``: 450 GB/s per direction between the 8 GPUs of one NVLink
    node (fourth-generation NVLink, 900 GB/s both ways);
  * ``NIC_BW``: 50 GB/s per direction between nodes (one 400 Gb/s NIC per
    GPU).

A collective's group runs at ``NVLINK_BW`` when its ranks lie in one node
of ``GPUS_PER_NODE`` consecutive ranks (ranks laid row-major over the mesh
axes, as ``launch/mesh`` lays them), else at ``NIC_BW``: the production
mesh's 16-wide axes cross nodes.  Nothing overlaps a collective with
compute in this model, and each group moves its operand bytes once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.sharding.collectives import KINDS

# peak operation rates (dense), by the type the operations run in
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_FLOPS = PEAK_OPS["bfloat16"]
# device-memory rate by card name, matched in this order
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
HBM_BW = MEMORY_RATE["H100"]
NVLINK_BW = 450e9
NIC_BW = 50e9
GPUS_PER_NODE = 8


def memory_rate(name: str) -> float:
    """The device-memory rate of a card by its name (``torch.cuda.
    get_device_name``); raises for a card not on record."""
    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def bound(work, rate: float = HBM_BW) -> Tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: the least time the card
    takes for ``work`` (a ``kernels.cost.Work``), the larger of its bytes
    over the memory rate ``rate`` and its operations over the peak of
    their type, and which of the two it is."""
    t_bytes, t_ops = work.bytes / rate, work.operations / PEAK_OPS[work.rate]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def link_bandwidth(mesh_shape: Mapping[str, int], axes: Sequence[str]) -> float:
    """The rate of a group over ``axes`` of a mesh of ``mesh_shape``:
    NVLink when rank 0's group lies in its node, else the NIC's."""
    names = list(mesh_shape)
    stride, last = 1, 0
    for name in reversed(names):
        if name in axes:
            last += (mesh_shape[name] - 1) * stride
        stride *= mesh_shape[name]
    return NVLINK_BW if last < GPUS_PER_NODE else NIC_BW


def collective_bytes(tally) -> Dict[str, int]:
    """Per-kind operand bytes of a dry-run's collectives (a
    ``sharding.collectives.CollectiveTally``), with the reference's keys:
    the five kinds, ``count`` and ``total``."""
    out: Dict[str, int] = {k: int(tally.by_kind[k]) if tally else 0 for k in KINDS}
    out["count"] = int(tally.count) if tally else 0
    out["total"] = sum(out[k] for k in KINDS)
    return out


def collective_seconds(tally, mesh_shape: Mapping[str, int]) -> float:
    """Σ over the groups' axes of their operand bytes over the axes' link
    rate (:func:`link_bandwidth`)."""
    return sum(entry["bytes"] / link_bandwidth(mesh_shape, axes.split(","))
               for axes, entry in tally.by_axis.items())


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_fraction: float
    collectives: Dict[str, int]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(cost: Mapping[str, float], tally=None, *, model_flops_per_device: float,
            mesh_shape: Optional[Mapping[str, int]] = None) -> Roofline:
    """The three terms of one rank's ``cost`` (``flops``, ``bytes
    accessed``, optionally ``flops_by_rate``) and collectives ``tally``;
    the compute term at each type's peak, the collective term at each
    group's link rate on ``mesh_shape`` (without one, all at ``NIC_BW``)."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    colls = collective_bytes(tally)
    cb = float(colls["total"])
    by_rate = cost.get("flops_by_rate")
    if by_rate is None:
        compute_s = flops / PEAK_FLOPS
    else:
        compute_s = sum(float(n) / PEAK_OPS[r] for r, n in by_rate.items())
    memory_s = hbm / HBM_BW
    if tally is not None and mesh_shape is not None:
        coll_s = collective_seconds(tally, mesh_shape)
    else:
        coll_s = cb / NIC_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=cb,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=dominant,
        model_flops=model_flops_per_device,
        useful_fraction=(model_flops_per_device / flops) if flops else 0.0,
        collectives=colls,
    )


def model_flops(kind: str, n_active_params: int, tokens: int) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D for inference fwd."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
