"""The port's ``Visualizer`` (``utils/visualizer.py``) driven by the host
loop on the CPU, mirroring ``tests/test_utils.py:95`` (the eval plot of a
multi-dimensional model) and ``:137`` (the training GIF), plus the 1-D
posterior band plot that reads ``SCFGP._predict_on_scaled``."""

import numpy as np
import torch

from scfgp_tpu_torch import SCFGP, Visualizer
from scfgp_tpu_torch.data.datasets import load_co2, synthetic_gp_rff

torch.set_num_threads(1)


def test_visualizer_eval_plot_for_multidim_model(tmp_path):
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=8, seed=0)
    viz = Visualizer(eval="NMSE")
    m = SCFGP(sparsity=4, nfeats=8, seed=0, device="cpu")
    m.set_data(X[:120], y[:120])
    m.optimize(X[120:], y[120:], visualizer=viz, max_iter=35)
    assert viz.model is m
    out = tmp_path / "evals.png"
    viz.save(str(out))
    assert out.stat().st_size > 10_000


def test_visualizer_training_gif_and_bands(tmp_path):
    Xt, yt, Xv, yv, _ = load_co2(seed=0)
    viz = Visualizer(eval="NMSE", record_every=10)
    m = SCFGP(sparsity=4, nfeats=6, seed=0, device="cpu")
    m.set_data(Xt[:120], yt[:120])
    m.optimize(Xv[:40], yv[:40], visualizer=viz, max_iter=30)
    assert len(viz.frames) >= 2
    out = tmp_path / "training.gif"
    viz.save_animation(str(out))
    data = out.read_bytes()
    assert data[:6] in (b"GIF87a", b"GIF89a") and len(data) > 5_000
    mu, std = m._predict_on_scaled(np.linspace(-0.1, 1.1, 5)[:, None])
    assert mu.shape == std.shape == (5,) and (std > 0).all()
    bands = tmp_path / "bands.png"
    viz.save(str(bands))
    assert bands.stat().st_size > 10_000
