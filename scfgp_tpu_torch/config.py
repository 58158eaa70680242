"""Typed configuration dataclasses.

Port of ``scfgp_tpu/config.py:1-88``: the same four dataclasses with the
same fields and defaults, which reproduce the reference's ctor kwargs
(``reference: SCFGP/SCFGP.py:33-35``) and ``optimize`` defaulting
(``SCFGP.py:185-202``).  ``make_model`` also takes the torch device the
model lives on.  ``MeshConfig`` is data only, as in the JAX package: a
mesh is built by ``parallel/mesh.py`` (``make_mesh``, ``make_mesh2d``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class OptimizerConfig:
    """Mirrors the reference's algo dict (SCFGP.py:193-202)."""

    algo: str = "adam"
    learning_rate: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    rho: float = 0.9
    nesterov_momentum: Optional[float] = 0.9

    def algo_params(self) -> dict:
        return {"learning_rate": self.learning_rate, "beta1": self.beta1,
                "beta2": self.beta2, "epsilon": self.epsilon,
                "rho": self.rho}

    def as_optimize_arg(self) -> dict:
        return {"algo": self.algo, "algo_params": self.algo_params()}


@dataclass
class ModelConfig:
    """Mirrors SCFGP.__init__ (SCFGP.py:33-35)."""

    sparsity: int = 20
    nfeats: int = 18
    X_scaling_method: str = "auto-inv-normal"
    y_scaling_method: str = "auto-normal"
    verbose: bool = False
    seed: Optional[int] = None


@dataclass
class TrainConfig:
    """Mirrors optimize() defaulting (SCFGP.py:185-202)."""

    obj: str = "COST"
    nbatches: int = 1
    batchsize: int = 150
    cvrg_tol: float = 1e-4
    max_cvrg: int = 18
    max_iter: int = 500
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    fused: bool = False

    def as_optimize_kwargs(self) -> dict:
        return {"obj": self.obj, "nbatches": self.nbatches,
                "batchsize": self.batchsize, "cvrg_tol": self.cvrg_tol,
                "max_cvrg": self.max_cvrg, "max_iter": self.max_iter,
                "algo": self.optimizer.as_optimize_arg()}


@dataclass
class MeshConfig:
    """Data-parallel mesh layout (no reference counterpart)."""

    axis_name: str = "data"
    num_devices: Optional[int] = None  # None = all
    dp_mode: str = "gspmd"             # or "shard_map"


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def make_model(cfg: ModelConfig, device="cuda"):
    """The ``SCFGP`` that ``cfg`` describes, on ``device``."""
    from .models.model import SCFGP
    return SCFGP(sparsity=cfg.sparsity, nfeats=cfg.nfeats,
                 X_scaling_method=cfg.X_scaling_method,
                 y_scaling_method=cfg.y_scaling_method,
                 verbose=cfg.verbose, seed=cfg.seed, device=device)
