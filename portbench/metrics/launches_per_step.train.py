"""Device kernels a step in the traced stretch."""
from portbench.readers import launches as read  # noqa: F401
