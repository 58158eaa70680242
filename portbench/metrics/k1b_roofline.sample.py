"""K1b's share of its roofline over its launches in the traced stretch."""
from portbench.readers import roofline

read = roofline("K1b")
