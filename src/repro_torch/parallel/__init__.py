"""Cross-pod gradient exchange of the port: int8 block compression and the
sealed all-reduce on ``torch.distributed``."""
