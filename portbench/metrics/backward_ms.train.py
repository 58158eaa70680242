"""Device ms a step of the work launched inside the gradient's backward,
the autograd thread's included."""
from portbench.spans import device_ms

read = device_ms("scfgp.grad.backward")
