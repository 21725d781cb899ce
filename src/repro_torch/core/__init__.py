"""The paper's analytical model of its fabric (:mod:`.timing`).  The
fabric simulator, its ISA and schedule are not ported yet."""
from repro_torch.core import timing

__all__ = ["timing"]
