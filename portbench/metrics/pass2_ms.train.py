"""Device ms a step of the work launched inside the streaming pass 2
(the forward; its recompute runs in the backward)."""
from portbench.spans import device_ms

read = device_ms("scfgp.stream.pass2")
