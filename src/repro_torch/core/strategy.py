"""Strategy selection per (arch x shape): which distribution path runs a cell
(port of ``repro/core/strategy.py``).

* ``pp_shardmap`` -- the paper's pipeline (:mod:`repro_torch.core.pipeline`),
  for training shapes of uniform-block small/mid archs.
* ``gspmd_tp``    -- TP("model") x DP/FSDP("data", "pod")
  (:mod:`repro_torch.launch.steps`); all serving shapes, enc-dec, and
  big-vocab archs.
* ``gspmd_pp``    -- the stacked-stage pipeline (PP on "data" x TP on
  "model", :mod:`repro_torch.core.pipeline_gspmd`); training shapes of the
  MoE giants.

``auto`` resolves per the table; configs/CLI can override.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig

# archs whose TRAIN cells run the paper's pipeline by default
PP_TRAIN_ARCHS = {
    "granite-8b", "mistral-nemo-12b", "rwkv6-1.6b", "internvl2-1b", "zamba2-7b",
}
# MoE giants: PP x TP stacked pipeline for training
PP_STACKED_TRAIN_ARCHS = {"grok-1-314b", "llama4-scout-17b-a16e"}


def resolve(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig) -> str:
    if rcfg.strategy != "auto":
        return rcfg.strategy
    if shape.kind == "train":
        if cfg.arch_id in PP_TRAIN_ARCHS:
            return "pp_shardmap"
        if cfg.arch_id in PP_STACKED_TRAIN_ARCHS:
            return "gspmd_pp"
        return "gspmd_tp"
    return "gspmd_tp"


def wants_fsdp(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """FSDP over "data" for params only when the TP-sharded weights exceed
    ~6 GB/device: with grad accumulation FSDP gathers the weights every
    microbatch, so ZeRO-1 moments (always on) give the memory win without
    that gather, and the FSDP threshold is high."""
    if shape.kind != "train":
        return False
    return cfg.total_params() * 2 / 16 > 6e9
