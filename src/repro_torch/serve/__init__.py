"""Sealed multi-tenant serving (torch port): gateway, scheduler, sessions,
prefix cache, paged KV pool and the two engines."""
from .engine import PagedEngine, ServeEngine, TOKEN_POISON  # noqa: F401
from .gateway import SecureGateway  # noqa: F401
from .kv_pager import PagedKVPool, PoolExhausted  # noqa: F401
from .prefix_cache import (PREFIX_TENANT, PrefixEntry,  # noqa: F401
                           PrefixRegistry)
from .scheduler import (Request, Scheduler, TenantQuarantined,  # noqa: F401
                        swap_object_id)
from .sessions import SessionManager  # noqa: F401
