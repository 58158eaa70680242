"""GB a draw written by the trial-axis copies of X's blocks: the bytes
the program records on its copy spans over its sampler gradients."""
from portbench.spans import store_gb_per

read = store_gb_per("scfgp.stream.trial_copy", "scfgp.sgld.gradient")
