"""Device ms a draw of the trial-axis copies of X's blocks."""
from portbench.spans import device_ms

read = device_ms("scfgp.stream.trial_copy")
