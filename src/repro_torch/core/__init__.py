"""The paper's primary contribution: the messaging-based programmable
fabric — its message format and ISA (:mod:`.isa`), the cycle-level and bus
simulator (:mod:`.fabric`), the Fig. 3 / Fig. 4 schedules
(:mod:`.schedule`) and the analytical model (:mod:`.timing`).
:mod:`.convert` carries a JAX message or fabric state across as numpy
arrays."""
from repro_torch.core import convert, fabric, isa, schedule, timing

__all__ = ["convert", "fabric", "isa", "schedule", "timing"]
