"""Data and sequence parallelism over ``torch.distributed``."""
