from .pipeline import SyntheticLM, sealed_host_batches  # noqa: F401
