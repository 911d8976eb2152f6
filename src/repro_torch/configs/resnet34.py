"""ResNet-34 — the PAPER'S OWN model (§4.1 parallel training experiment),
a copy of ``repro/configs/resnet34.py``.

[arXiv:1512.03385].  Stage counts (3,4,6,3), channels (64,128,256,512).
Kept out of the LM registry: :mod:`repro_torch.models.resnet` and
:mod:`repro_torch.core.calibrate` read it directly.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    arch_id: str = "resnet34"
    stages: Tuple[int, ...] = (3, 4, 6, 3)
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    n_classes: int = 1000
    img_size: int = 224
    source: str = "[arXiv:1512.03385; paper's own model]"


CONFIG = ResNetConfig()

# Reduced config for CPU tests
MINI = ResNetConfig(arch_id="resnet34-mini", stages=(1, 1, 1, 1),
                    channels=(8, 16, 32, 64), n_classes=10, img_size=32)
