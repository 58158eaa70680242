"""The whole step's model FLOPs as a share of the FP32 peak."""
from portbench.readers import mfu as read  # noqa: F401
