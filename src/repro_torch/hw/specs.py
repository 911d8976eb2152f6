"""Hardware device profiles (port of ``repro/hw/specs.py``).

The paper's Table 1 compares mobile/edge/desktop devices by TFLOPS; its cost
model for choosing a pipeline split point is implicit (hand-tuned).  Here the
profiles are explicit inputs to the heterogeneous partitioner
(:mod:`repro_torch.core.partition`) and to the decode-split planner
(:func:`repro_torch.serving.pipeline_decode.plan_decode_split`).

``flops`` is the dense-matmul peak for the relevant dtype (fp32 for the
paper's devices, bf16 for the H100), ``mem_bw`` is HBM/DRAM bandwidth,
``link_bw`` is the inter-device link bandwidth *per direction* for the
transport that device uses (USB for phones in the paper; for the H100 the
host round trip a boundary frame takes through the wire codec).

The reference's accelerator-fleet profile and its link-efficiency factor
are not copied.  The port's roofline (:mod:`repro_torch.analysis.roofline`)
rates its production meshes with :data:`H100_MESH` and
:data:`LINK_EFFICIENCY` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True, kw_only=True)
class DeviceProfile:
    name: str
    year: int
    flops: float           # peak FLOP/s (dtype noted in ``dtype``)
    mem_bytes: float       # usable memory per device, bytes
    mem_bw: float          # bytes/s
    link_bw: float         # bytes/s per direction on the inter-device link
    dtype: str = "fp32"
    # Thermal model (paper §4.2): sustained fraction of peak after throttling
    # and the time constant (seconds of saturated compute) to reach it.
    thermal_sustained: float = 1.0
    thermal_tau_s: float = float("inf")
    # Serving-rate model: sustained rates at thermal MINIMAL (cold), used to
    # pace each worker's engine in simulated time.  ``decode_steps_per_s`` is
    # batched decode steps (one token for every active lane) per second;
    # ``prefill_tokens_per_s`` is prompt tokens prefillable per second.
    # Every profile states both: the reference's flops-scaled fallback was
    # calibrated on phones and is not kept.
    decode_steps_per_s: float
    prefill_tokens_per_s: float

    def decode_rate(self) -> float:
        """Batched decode steps/s."""
        return self.decode_steps_per_s

    def prefill_rate(self) -> float:
        """Prefill tokens/s."""
        return self.prefill_tokens_per_s

    def derate(self, slowdown: float) -> "DeviceProfile":
        """This profile at an observed thermal ``slowdown`` (>= 1): compute
        and serving rates divided by it, memory/link untouched.  Feeding
        derated profiles back into the partition searches is how online
        rebalance (§5.2) re-cuts a split as a stage throttles."""
        s = max(slowdown, 1e-9)
        return dataclasses.replace(
            self, flops=self.flops / s,
            decode_steps_per_s=self.decode_steps_per_s / s,
            prefill_tokens_per_s=self.prefill_tokens_per_s / s)


# --- the card the port runs on ----------------------------------------------
# flops, mem_bytes and mem_bw: NVIDIA's H100 SXM5 datasheet (bf16 dense
# tensor-core peak, 80 GB HBM3, 3.35 TB/s).  The serving rates and the link
# are the card's own readings, printed by ``chip_smoke.py``'s
# ``serve_stages`` phase on an H100 80GB HBM3 at a 700.00 W power limit:
# granite-8b (36 layers, bf16) decode steps per second at batch 8 over 1024
# positions, its prefill tokens per second at B=1 and 600 tokens, and the
# bytes per second of a (8, 1, 4096) bf16 boundary frame's host round trip
# (codec encode from the card, decode, copy back).  All three are bound by
# the host, and they swing by up to 40% from one host to the next: two runs
# on two hosts read 63.42 and 38.26 decode steps/s, 28962.5 and 20357.1
# prefill tokens/s, and 3.3656e8 and 4.1770e8 B/s.  The profile holds the
# lower reading of each, so a plan made from it does not count on a fast
# host.
H100 = DeviceProfile(
    name="h100-sxm",
    year=2023,
    flops=989e12,
    mem_bytes=80e9,
    mem_bw=3.35e12,
    link_bw=3.3656e8,
    dtype="bf16",
    decode_steps_per_s=38.26,
    prefill_tokens_per_s=20357.1,
)

# --- one H100 of a production mesh (the roofline's device) -----------------
# NVIDIA's H100 SXM5 datasheet: 989 TFLOP/s dense bf16, 80 GB HBM3 at 3.35
# TB/s.  A 16-wide mesh axis spans two 8-GPU NVLink nodes, so the slowest hop
# of a collective over it is the inter-node one: NDR InfiniBand, 400 Gb/s =
# 50 GB/s a GPU each way, the single link rate of the roofline's formula.
# Datasheet figures, not readings; the serving rates are H100's (the
# roofline reads none of them).  Kept out of PROFILES: the planners never
# place a stage on it.
H100_MESH = DeviceProfile(
    name="h100-sxm-mesh",
    year=2023,
    flops=989e12,
    mem_bytes=80e9,
    mem_bw=3.35e12,
    link_bw=50e9,
    dtype="bf16",
    decode_steps_per_s=H100.decode_steps_per_s,
    prefill_tokens_per_s=H100.prefill_tokens_per_s,
)
# The share of the link rate a collective moves as payload (protocol and
# scheduling overhead): an assumption of this port, not a measurement.
LINK_EFFICIENCY = 0.8

# --- Paper Table 1 devices --------------------------------------------------
XEON_E3_1225V3 = DeviceProfile(
    name="xeon-e3-1225v3", year=2013, flops=0.061e12, mem_bytes=32e9,
    mem_bw=25.6e9, link_bw=60e6,   # paired with Lightning-era USB2 in the paper
    decode_steps_per_s=6.0, prefill_tokens_per_s=1500.0,
)
IPHONE_11_PRO = DeviceProfile(
    name="iphone-11-pro", year=2019, flops=0.63e12, mem_bytes=2.0e9,
    mem_bw=34e9, link_bw=60e6,     # Lightning: USB 2.0, ~60 MB/s (paper §4.1.2)
    thermal_sustained=0.80, thermal_tau_s=180.0,  # paper Fig. 6: Serious ~batch 17
    decode_steps_per_s=30.0, prefill_tokens_per_s=8000.0,
)
IPHONE_16 = DeviceProfile(
    name="iphone-16", year=2024, flops=1.907e12, mem_bytes=8e9,
    mem_bw=60e9, link_bw=1.25e9,   # USB-C 3.2 Gen 2: 10 Gb/s (paper §4.1.2)
    thermal_sustained=0.85, thermal_tau_s=300.0,
    decode_steps_per_s=70.0, prefill_tokens_per_s=25000.0,
)
M2_MAX_CPU = DeviceProfile(
    name="m2-max-cpu", year=2023, flops=0.9e12, mem_bytes=32e9,
    mem_bw=400e9, link_bw=1.25e9,
    decode_steps_per_s=45.0, prefill_tokens_per_s=12000.0,
)
A18_PRO = DeviceProfile(
    name="a18-pro", year=2024, flops=2.289e12, mem_bytes=8e9,
    mem_bw=60e9, link_bw=1.25e9, thermal_sustained=0.85, thermal_tau_s=300.0,
    decode_steps_per_s=80.0, prefill_tokens_per_s=30000.0,
)

PROFILES: Dict[str, DeviceProfile] = {
    p.name: p
    for p in (H100, XEON_E3_1225V3, IPHONE_11_PRO, IPHONE_16, M2_MAX_CPU, A18_PRO)
}


def get_profile(name: str) -> DeviceProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; known: {sorted(PROFILES)}")
