from .adamw import AdamW, TrainState, clip_by_global_norm  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
