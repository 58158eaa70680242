"""Device ms a step of the work launched inside the streaming pass 1."""
from portbench.spans import device_ms

read = device_ms("scfgp.stream.pass1")
