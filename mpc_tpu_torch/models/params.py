"""Vehicle parameters (port of mpc_tpu/models/params.py).

Fields are Python floats shared by every lane; ``to_kernel_vec`` packs them
for the fused fan kernel in the order ``mpc_tpu/ops/fused_psi.py`` uses.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Canonical flat ordering of the 22 physical parameters
# (mpc_tpu/models/params.py:28-33).
PARAM_FIELDS = (
    "length", "axis_front", "axis_rear", "front", "rear", "width", "height",
    "mass", "inertia", "max_steer", "max_drive",
    "bf", "cf", "df", "br", "cr", "dr",
    "cm1", "cm2", "cr0", "cr1", "cr2",
)

#: the kernel's parameter vector: the 22 canonical fields plus the
#: kinematic-model extras (mpc_tpu/ops/fused_psi.py:_KERNEL_PARAM_FIELDS)
KERNEL_PARAM_FIELDS = PARAM_FIELDS + ("friction", "acceleration")


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Physical constants of the 1:43-scale RC car; defaults as in the
    reference (mpc_tpu/models/params.py:36-73)."""

    length: Any = 9.7e-2
    axis_front: Any = 4.7e-2
    axis_rear: Any = 5e-2
    front: Any = 0.09
    rear: Any = 0.07
    width: Any = 8e-2
    height: Any = 5.5e-2
    mass: Any = 0.1735
    inertia: Any = 18.3e-5

    max_steer: Any = 0.32
    max_drive: Any = 1.0

    bf: Any = 0.268
    cf: Any = 2.165
    df: Any = 3.47
    br: Any = 0.242
    cr: Any = 2.38
    dr: Any = 2.84

    friction: Any = 1.0
    acceleration: Any = 2.0

    cm1: Any = 0.266
    cm2: Any = 0.1
    cr0: Any = 0.1025
    cr1: Any = 0.1629             # declared but unused by the ODE
    cr2: Any = 0.0011

    def to_vector(self, device=None) -> torch.Tensor:
        """The canonical 22-vector (float32)."""
        return torch.tensor([float(getattr(self, f)) for f in PARAM_FIELDS],
                            dtype=torch.float32, device=device)

    def to_kernel_vec(self, device=None) -> torch.Tensor:
        """The 24 floats the fan kernel reads, in ``KERNEL_PARAM_FIELDS``
        order (float32, shape (24,))."""
        return torch.tensor([float(getattr(self, f))
                             for f in KERNEL_PARAM_FIELDS],
                            dtype=torch.float32, device=device)
