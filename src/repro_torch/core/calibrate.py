"""Calibrate effective device rates from the paper's OWN measurements (port
of ``repro/core/calibrate.py``).

Finding (recorded in EXPERIMENTS.md): the paper's Table-1 TFLOPS ratings are
inconsistent with its own timings — the 2013 Xeon is rated 0.061 TFLOPS yet
sustains ResNet-34 training at ~13.1 s/batch-128 ≈ 0.21 TFLOP/s of model
FLOPs.  So the heterogeneous cost model is calibrated against the paper's
measured baselines (appendix A.1), and the *held-out* pairs validate it:

    calibrated on:  desktop_alone, mac_alone, desktop+iPhone11, desktop+iPhone16
    held out:       mac+iPhone16 (train), desktop+iPhone11 (inference)

Plain Python over floats but for :func:`resnet_costs`, which builds the
port's ResNet-34 on the CPU only for the shapes :func:`block_costs` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.resnet34 import CONFIG
from repro_torch.core.partition import (pipeline_batch_seconds, single_device_seconds,
                                        split_blocks)
from repro_torch.hw.specs import (DeviceProfile, IPHONE_11_PRO, IPHONE_16, M2_MAX_CPU,
                                  XEON_E3_1225V3)
from repro_torch.models.resnet import block_costs, init_resnet

# Paper appendix A.1 mean per-batch times (ms), batch 128, microbatch 16 (M=8)
PAPER_MS = {
    "desktop_alone": 13104.75,
    "desktop_iph11": 10162.54,
    "desktop_iph16": 7308.26,
    "mac_alone": 9008.52,
    "mac_iph16": 6719.06,
    # inference (10 batches of 128)
    "desktop_alone_infer": 4399.81,
    "desktop_iph11_infer": 2810.50,
}
N_MICRO = 8
MB = 16                                     # microbatch size


def resnet_costs(batch: int = MB):
    meta, params = init_resnet(CONFIG, torch.Generator(device="cpu").manual_seed(0))
    return block_costs(CONFIG, meta, params, batch)


def _effective(profile: DeviceProfile, rate: float) -> DeviceProfile:
    return dataclasses.replace(profile, flops=rate)


def calibrate_host(costs, measured_ms: float) -> float:
    """Single-device rate from the alone baseline (train: 3x fwd flops)."""
    flops = 3.0 * sum(f for f, _ in costs) * N_MICRO
    return flops / (measured_ms / 1e3)


def calibrate_phone(costs, host: DeviceProfile, phone: DeviceProfile,
                    measured_ms: float) -> float:
    """1-D search for the phone's effective rate that reproduces the
    measured 2-stage pipeline batch time."""
    target = measured_ms / 1e3

    def predict(rate: float) -> float:
        plan = split_blocks(costs, [host, _effective(phone, rate)],
                            efficiency=1.0)
        return pipeline_batch_seconds(plan, N_MICRO)

    rates = np.geomspace(1e9, 5e12, 400)
    errs = [abs(predict(r) - target) for r in rates]
    return float(rates[int(np.argmin(errs))])


def calibrated_profiles() -> Dict[str, DeviceProfile]:
    costs = resnet_costs()
    xeon_rate = calibrate_host(costs, PAPER_MS["desktop_alone"])
    mac_rate = calibrate_host(costs, PAPER_MS["mac_alone"])
    xeon = _effective(XEON_E3_1225V3, xeon_rate)
    mac = _effective(M2_MAX_CPU, mac_rate)
    iph11 = _effective(IPHONE_11_PRO,
                       calibrate_phone(costs, xeon, IPHONE_11_PRO,
                                       PAPER_MS["desktop_iph11"]))
    iph16 = _effective(IPHONE_16,
                       calibrate_phone(costs, xeon, IPHONE_16,
                                       PAPER_MS["desktop_iph16"]))
    return {"xeon": xeon, "mac": mac, "iphone11": iph11, "iphone16": iph16}


def reproduction_table() -> List[dict]:
    """Predicted vs paper-measured times for every §4.1 setup.  Held-out
    rows are marked (they were NOT used for calibration)."""
    costs = resnet_costs()
    profs = calibrated_profiles()
    rows = []

    def add(name, predicted_s, held_out):
        measured = PAPER_MS[name] / 1e3
        rows.append(dict(setup=name, predicted_s=round(predicted_s, 3),
                         paper_s=round(measured, 3),
                         rel_err=round(abs(predicted_s - measured) / measured, 3),
                         held_out=held_out))

    add("desktop_alone",
        single_device_seconds(costs, profs["xeon"], N_MICRO, 1.0), False)
    add("mac_alone",
        single_device_seconds(costs, profs["mac"], N_MICRO, 1.0), False)
    for name, host, phone in [("desktop_iph11", "xeon", "iphone11"),
                              ("desktop_iph16", "xeon", "iphone16")]:
        plan = split_blocks(costs, [profs[host], profs[phone]], efficiency=1.0)
        add(name, pipeline_batch_seconds(plan, N_MICRO), False)
    # HELD OUT: mac + iPhone16 (train)
    plan = split_blocks(costs, [profs["mac"], profs["iphone16"]], efficiency=1.0)
    add("mac_iph16", pipeline_batch_seconds(plan, N_MICRO), True)
    # HELD OUT: desktop + iPhone11 (inference; fwd-only costs)
    add("desktop_alone_infer",
        single_device_seconds(costs, profs["xeon"], N_MICRO, 1.0, train=False),
        True)
    plan = split_blocks(costs, [profs["xeon"], profs["iphone11"]],
                        efficiency=1.0, train=False)
    add("desktop_iph11_infer",
        pipeline_batch_seconds(plan, N_MICRO), True)
    return rows
