"""The paper's trusted VTA: its cycle model and Table 1's workloads (a
copy of ``repro.accel``)."""
from .vta_sim import VTAConfig, simulate, Protection  # noqa: F401
from . import workloads  # noqa: F401
