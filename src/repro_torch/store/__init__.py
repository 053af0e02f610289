from .eviction import (EvictionPolicy, LargestFirstEviction,  # noqa: F401
                       LRUEviction, choose_victim)
from .sealed_store import SealedStore, StoreError, StoreFull  # noqa: F401
