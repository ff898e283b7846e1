"""Roofline terms of a traced cell on a model of the NVIDIA H100.

The port's counterpart of ``repro.launch.roofline``, rewritten for the
card.  :class:`Hardware` holds NVIDIA's published figures for the H100
SXM5 80 GB (the NVIDIA H100 Tensor Core GPU datasheet): a model built from
the specifications, not a measurement.

* compute    = FLOPs_total / (chips · peak of the cell's compute dtype)
* memory     = bytes_total / (chips · HBM bandwidth)
* collective = NVLink bytes / NVLink rate + InfiniBand bytes / its rate

The FLOPs and bytes are the cost walker's (:mod:`repro_torch.launch.flops`),
global; per device is global / chips.  The collective bytes are per device,
from the records of the port's merge sites
(:func:`repro_torch.obs.cost.record_collective`): a collective whose mesh
axes all lie inside ``("model",)`` — one node's 8 GPUs on NVLink — runs at
NVLink's rate, any other crosses nodes on InfiniBand.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.obs.cost import COLLECTIVE_KINDS

__all__ = ["HW", "Hardware", "NVLINK_AXES", "collective_stats", "roofline_terms",
           "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-GPU rates of the H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
    datasheet).

    * ``peak_flops`` — 989.4 TFLOP/s dense BF16 on the tensor cores (the
      datasheet's 1,979 is with 2:4 sparsity);
    * ``tf32_flops`` — 494.7 TFLOP/s dense TF32 (989 with sparsity);
    * ``fp32_flops`` — 66.9 TFLOP/s FP32 outside the tensor cores;
    * ``hbm_bw`` — 3.35 TB/s HBM3;
    * ``nvlink_bw`` — NVLink 4: 900 GB/s per GPU in total, 450 GB/s in
      each direction, between the 8 GPUs of a node;
    * ``ib_bw`` — one ConnectX-7 NDR InfiniBand port per GPU at 400 Gb/s,
      50 GB/s, between nodes (DGX H100).
    """

    peak_flops: float = 989.4e12
    tf32_flops: float = 494.7e12
    fp32_flops: float = 66.9e12
    hbm_bw: float = 3.35e12
    nvlink_bw: float = 450e9
    ib_bw: float = 50e9

    def peak_for(self, dtype) -> float:
        """The peak a step computing in ``dtype`` is held to: BF16/FP16 on
        the tensor cores, FP32 (and any other type, the triangle cells'
        scalar compares among them) outside them.  TF32 is not assumed:
        PyTorch's matmuls leave it off unless asked."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops
        return self.fp32_flops


HW = Hardware()

#: mesh axes inside one NVLink domain
NVLINK_AXES = ("model",)


def _link(axes) -> str:
    return "nvlink" if axes and set(axes) <= set(NVLINK_AXES) else "infiniband"


def collective_stats(records) -> dict:
    """Per-kind operand-byte totals and op counts of the collective records
    (``{"kind", "bytes", "axes", "count"}``, bytes per device), the largest
    single op, and the bytes on each link."""
    totals = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    by_link = {"nvlink": 0.0, "infiniband": 0.0}
    largest = 0.0
    for r in records:
        n = r.get("count", 1)
        totals[r["kind"]] += r["bytes"] * n
        counts[r["kind"]] += n
        by_link[_link(r["axes"])] += r["bytes"] * n
        largest = max(largest, r["bytes"])
    return {
        "bytes_by_kind": totals,
        "count_by_kind": counts,
        "total_bytes": sum(totals.values()),
        "largest_op_bytes": largest,
        "bytes_by_link": by_link,
    }


@dataclasses.dataclass
class RooflineReport:
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    collectives: dict | None
    hw: Hardware = HW
    # the reference's compiler cost analysis (loop bodies once); the port
    # compiles nothing, so these stay 0.0
    xla_flops_per_device: float = 0.0
    xla_bytes_per_device: float = 0.0
    by_prim: dict = dataclasses.field(default_factory=dict)
    compute_dtype: torch.dtype = torch.bfloat16
    # per device, the part of collective_bytes_per_device on NVLink (the
    # rest crosses nodes)
    nvlink_bytes_per_device: float = 0.0

    @property
    def peak_flops(self) -> float:
        return self.hw.peak_for(self.compute_dtype)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        ib = self.collective_bytes_per_device - self.nvlink_bytes_per_device
        return self.nvlink_bytes_per_device / self.hw.nvlink_bw + ib / self.hw.ib_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline estimate: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPs-based MFU at the roofline step time (the score)."""
        denom = self.step_time_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
            "xla_flops_per_device": self.xla_flops_per_device,
            "xla_bytes_per_device": self.xla_bytes_per_device,
            "by_prim": self.by_prim,
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "peak_flops": self.peak_flops,
            "hardware": dataclasses.asdict(self.hw),
        }


def roofline_terms(
    lowered, chips: int, model_flops: float, walker_cost: dict | None = None
) -> RooflineReport:
    """Build the report from :meth:`repro_torch.configs.base.DryRunSpec.lower`'s
    result: the walker's global FLOPs and bytes over ``chips``, the
    recorded collectives (None for a single-device trace: no collective
    term), the cell's compute dtype.  ``walker_cost`` replaces the
    lowered cost, as in the reference."""
    cost = walker_cost if walker_cost is not None else lowered.cost
    stats = None if lowered.collectives is None else collective_stats(lowered.collectives)
    return RooflineReport(
        chips=chips,
        flops_per_device=cost["flops"] / chips,
        bytes_per_device=cost["bytes"] / chips,
        collective_bytes_per_device=0.0 if stats is None else float(stats["total_bytes"]),
        model_flops=model_flops,
        collectives=stats,
        by_prim=cost.get("by_prim", {}),
        compute_dtype=lowered.compute_dtype,
        nvlink_bytes_per_device=0.0 if stats is None else stats["bytes_by_link"]["nvlink"],
    )
