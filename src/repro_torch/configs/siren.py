"""The port's own copy of ``repro.configs.siren`` (the port imports nothing of the
JAX package); keep the two in step.

SIREN INR (the paper's own benchmark model) + INSP-Net editing head.

Matches Xu et al. [12] / Sitzmann et al. [3] as evaluated by INR-Arch:
a sinusoidal MLP f: R^2 -> R^out, batch 64 coordinate samples, whose
1st/2nd-order input gradients feed a small trainable MLP (INSP-Net).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class SirenConfig:
    name: str = "siren"
    in_features: int = 2          # (x, y) image coordinates
    out_features: int = 1         # grayscale channel (paper uses SIREN [3])
    hidden_features: int = 256
    hidden_layers: int = 3        # 3 hidden layers as in SIREN image fits
    w0: float = 30.0              # SIREN frequency scale
    batch: int = 64               # paper evaluation batch size
    grad_order: int = 2           # INSP-Net uses up to 2nd-order gradients


@dataclass(frozen=True)
class InspConfig:
    """INSP-Net head: MLP over [y, grads...] features."""
    hidden: int = 64
    layers: int = 3
    grad_order: int = 2


CONFIG = SirenConfig()
INSP = InspConfig()
