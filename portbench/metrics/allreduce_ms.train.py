"""Device ms a step in NCCL kernels on rank 0 (with its waits)."""
from portbench.readers import allreduce_ms as read  # noqa: F401
