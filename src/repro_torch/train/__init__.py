from .trainer import (make_eval_step, make_refresh_fn,  # noqa: F401
                      make_train_step, refresh_sealed_state, seal_state,
                      unseal_state_host)
from . import checkpoint, fault  # noqa: F401
