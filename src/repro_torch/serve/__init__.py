"""Sealed multi-tenant serving (torch port): paged KV pool, engine, runner."""
from .engine import TOKEN_POISON, PagedEngine  # noqa: F401
from .kv_pager import PagedKVPool, PoolExhausted  # noqa: F401
