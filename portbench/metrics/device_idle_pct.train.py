"""Share of the traced window the device was idle."""
from portbench.readers import idle_pct as read  # noqa: F401
