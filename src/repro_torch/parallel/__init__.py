"""Parallelism of the port: the sealed cross-pod gradient exchange (int8
compression, sealed all-reduce), logical sharding on DTensor and the
sealed pipeline, on ``torch.distributed``."""
from . import collectives, compress, sharding  # noqa: F401
from . import pipeline  # noqa: F401
