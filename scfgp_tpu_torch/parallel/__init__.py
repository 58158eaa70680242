"""Data, tensor, trial and chain parallelism over ``torch.distributed``:
the port of ``scfgp_tpu/parallel/`` (one process a rank; ``launch.run``
spawns them)."""

from .mesh import (DATA_AXIS, FEATURE_AXIS, Mesh, make_mesh, make_mesh2d,
                   pad_rows, shard_rows, replicated)
from .dp import (make_dp_train_step, make_dp_eval, shardmap_loss, gspmd_loss)
from .tp import tp_loss, tp_loss_and_grad, make_tp_train_step, shard_rows_2d
from .multihost import init_distributed, is_coordinator
from .chains import shard_chains, gather_chains
