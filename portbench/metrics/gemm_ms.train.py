"""Device ms a step in cuBLAS GEMM kernels (the objective's products)."""
from portbench.readers import gemm_ms as read  # noqa: F401
