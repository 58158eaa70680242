"""Device ms a draw of the work launched inside the sampler's gradient."""
from portbench.spans import device_ms

read = device_ms("scfgp.sgld.gradient")
