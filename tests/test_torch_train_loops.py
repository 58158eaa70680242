"""The port's optimizer zoo and fused training loop: N-step trajectories
against ``scfgp_tpu.opt.optimizers`` from the same params and gradients,
the fused loop against the port's own host loop, bitwise segmented runs,
and the refusal of a fused state written by the JAX package.

Optimizer tolerance: the formulas are the JAX package's, ``a_t`` in float32
in both, but XLA's CPU backend rewrites ``x / sqrt(y)`` into
``x * rsqrt(y)`` and may fuse a multiply and an add into one FMA, each one
rounding off torch's.  So trajectories are held to about 8 float64 ulps
(rtol 1e-15) and 4 float32 ulps (rtol 5e-7) of each value per step; a wrong
formula, epsilon placement or step count moves them by 1e-3 or more.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scfgp_tpu import SCFGP as JaxSCFGP
from scfgp_tpu.data.datasets import synthetic_gp_rff
from scfgp_tpu.models.objective import SCFGPParams as JaxParams
from scfgp_tpu.models.params import init_params
from scfgp_tpu.opt import optimizers as jopt
from scfgp_tpu_torch import SCFGP
from scfgp_tpu_torch.models.objective import loss_and_grad
from scfgp_tpu_torch.models.params import (opt_state_from_numpy,
                                           opt_state_to_numpy,
                                           params_from_numpy)
from scfgp_tpu_torch.opt import optimizers as topt
from scfgp_tpu_torch.opt.fused_loop import fused_optimize

torch.set_num_threads(1)

D, S, M = 3, 3, 6
STEPS = 6
RTOL_PER_STEP = {"float64": 1e-15, "float32": 5e-7}


def _theta(seed=0):
    return [np.asarray(a) for a in
            init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)]


@pytest.mark.parametrize("nesterov", [0.9, None])
@pytest.mark.parametrize("algo", sorted(topt.algos))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_optimizer_trajectory_matches_jax(algo, nesterov, dtype):
    theta = _theta()
    params_j = JaxParams(*[jnp.asarray(a, dtype) for a in theta])
    params_t = params_from_numpy(theta, dtype=getattr(torch, dtype))
    hp = {"learning_rate": 0.05}
    tx_j = jopt.make_optimizer(algo, hp, nesterov_momentum=nesterov)
    tx_t = topt.make_optimizer(algo, hp, nesterov_momentum=nesterov)
    st_j, st_t = tx_j.init(params_j), tx_t.init(params_t)
    rng = np.random.RandomState(1)
    rtol = STEPS * RTOL_PER_STEP[dtype]
    for _ in range(STEPS):
        g = [rng.randn(*np.shape(a)) for a in theta]
        d_j, st_j = tx_j.update(JaxParams(*[jnp.asarray(a, dtype) for a in g]),
                                st_j, params_j)
        params_j = jopt.tree_add(params_j, d_j)
        d_t, st_t = tx_t.update(params_from_numpy(g, dtype=params_t.a.dtype),
                                st_t, params_t)
        params_t = topt.tree_add(params_t, d_t)
    leaves_j = jax.tree.leaves((params_j, st_j))
    leaves_t = topt.tree_leaves((params_t, st_t))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        a = np.asarray(a)
        assert b.dtype == getattr(torch, str(a.dtype))  # AdamState.t: f32
        np.testing.assert_allclose(b.numpy(), a, rtol=rtol,
                                   atol=rtol * np.abs(a).max())


def test_adam_default_beta2_and_unknown_algo():
    """adam's default beta2 is 0.99 here, as in the JAX package."""
    p = params_from_numpy(_theta(), dtype=torch.float64)
    g = params_from_numpy([np.ones_like(a) for a in _theta()],
                          dtype=torch.float64)
    d_default, _ = topt.adam().update(g, topt.adam().init(p), p)
    d_099, _ = topt.adam(beta2=0.99).update(g, topt.adam().init(p), p)
    assert all(torch.equal(a, b) for a, b in zip(d_default, d_099))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.make_optimizer("lbfgs")


def test_opt_state_round_trips_with_dtypes():
    p = params_from_numpy(_theta(), dtype=torch.float64)
    tx = topt.make_optimizer("adam")
    state = tx.init(p)
    back = opt_state_from_numpy(opt_state_to_numpy(state))
    assert type(back) is topt.MomentumState
    assert back.inner.t.dtype == torch.float32
    assert back.inner.m.l_F.dtype == torch.float64
    for a, b in zip(topt.tree_leaves(state), topt.tree_leaves(back)):
        assert torch.equal(a, b)


def _small_problem(seed=0, dtype=torch.float32):
    X, y = synthetic_gp_rff(n=150, d=D, s=S, m=M, seed=seed,
                            dtype=np.float64)
    theta = _theta(seed)
    return (params_from_numpy(theta, dtype=dtype),
            torch.as_tensor(X, dtype=dtype), torch.as_tensor(y, dtype=dtype))


def _vg(X, y):
    def vg(q):
        (cost, aux), grads = loss_and_grad(q, X, y)
        return (cost, aux.post), grads
    return vg


def test_fused_matches_host_loop_without_annealing():
    """Mirrors tests/test_fused_loop.py::test_fused_matches_host_loop_without_annealing:
    with annealing disabled by a huge max_cvrg, the fused loop runs the
    same adam + Nesterov steps as a plain host loop, bitwise."""
    params, X, y = _small_problem()
    tx = topt.make_optimizer("adam", {"learning_rate": 0.01})
    vg = _vg(X, y)
    res = fused_optimize(vg, tx, params, torch.Generator().manual_seed(1),
                         max_iter=25, cvrg_tol=1e-9, max_cvrg=10 ** 6)
    p_ref, st = params, tx.init(params)
    costs = []
    for _ in range(25):
        (cost, _), g = vg(p_ref)
        delta, st = tx.update(g, st, p_ref)
        p_ref = topt.tree_add(p_ref, delta)
        costs.append(float(cost))
    np.testing.assert_array_equal(res.cost_history.numpy(), costs)
    assert res.num_iters == 25 and res.done
    for a, b in zip(res.state.params, p_ref):
        assert torch.equal(a, b)


def test_fused_early_stopping_triggers():
    params, X, y = _small_problem(seed=3)
    tx = topt.make_optimizer("adam", {"learning_rate": 0.01})
    res = fused_optimize(_vg(X, y), tx, params,
                         torch.Generator().manual_seed(3), max_iter=500,
                         cvrg_tol=10.0, max_cvrg=3)
    # cvrg_tol=10 counts every improvement as negligible: stop right after
    # the iteration-30 gate opens.
    assert res.num_iters < 40 and res.done
    assert torch.isnan(res.cost_history[res.num_iters:]).all()


def test_fused_upto_segments_replay_one_shot_bitwise():
    params, X, y = _small_problem(seed=4)
    tx = topt.make_optimizer("adam", {"learning_rate": 0.05})
    kw = dict(max_iter=60, cvrg_tol=1e-3, max_cvrg=4)
    one = fused_optimize(_vg(X, y), tx, params,
                         torch.Generator().manual_seed(7), **kw)
    gen = torch.Generator().manual_seed(7)
    seg = fused_optimize(_vg(X, y), tx, params, gen, upto=13, **kw)
    assert seg.num_iters == 13 and not seg.done
    state = opt_state_from_numpy(opt_state_to_numpy(seg.state))
    seg = fused_optimize(_vg(X, y), tx, params, torch.Generator(),
                         state=state, **kw)
    assert seg.num_iters == one.num_iters
    np.testing.assert_array_equal(seg.cost_history.numpy(),
                                  one.cost_history.numpy())
    for a, b in zip(topt.tree_leaves(seg.state), topt.tree_leaves(one.state)):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()


def _data():
    X, y = synthetic_gp_rff(n=240, d=3, s=4, m=8, noise_std=0.1, seed=0)
    return X[:200], y[:200], X[200:], y[200:]


def test_fit_fast_segmented_and_crash_resume_equal_one_shot(tmp_path,
                                                            monkeypatch):
    """Mirrors tests/test_fused_resume.py: checkpoint segments change no bit,
    and a fresh model that loads the first checkpoint and resumes lands on
    the uninterrupted run."""
    Xt, yt, Xv, yv = _data()
    kw = dict(max_iter=45, obj="score", cvrg_tol=1e-5, max_cvrg=6)
    mA = SCFGP(sparsity=4, nfeats=8, seed=3, device="cpu")
    mA.fit_fast(Xt, yt, Xv, yv, **kw)

    path = os.path.join(tmp_path, "fused.ckpt")
    mB = SCFGP(sparsity=4, nfeats=8, seed=3, device="cpu")
    mB.fit_fast(Xt, yt, Xv, yv, checkpoint_path=path, checkpoint_every=17,
                **kw)
    for a, b in zip(mA.params, mB.params):
        assert torch.equal(a, b)
    assert mA.evals["COST"][1] == mB.evals["COST"][1]
    assert mA.evals["NMSE"][1] == mB.evals["NMSE"][1]

    orig_save = SCFGP.save

    def crash_after_first_save(self, p):
        orig_save(self, p)
        raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(SCFGP, "save", crash_after_first_save)
    with pytest.raises(KeyboardInterrupt):
        SCFGP(sparsity=4, nfeats=8, seed=3, device="cpu").fit_fast(
            Xt, yt, Xv, yv, checkpoint_path=path, checkpoint_every=17, **kw)
    monkeypatch.setattr(SCFGP, "save", orig_save)
    mC = SCFGP(seed=99, device="cpu").load(path)
    assert not mC._fused_train_state["done"]
    mC.set_data(Xt, yt)
    mC.optimize_fused(Xv, yv, resume=True)
    for a, b in zip(mA.params, mC.params):
        assert torch.equal(a, b)
    assert mA.evals["COST"][1] == mC.evals["COST"][1]


def test_jax_fused_state_is_refused(tmp_path):
    """A fused checkpoint of the JAX package carries a threefry key that no
    torch generator can replay: resuming it raises, never re-seeds."""
    Xt, yt, Xv, yv = _data()
    path = os.path.join(tmp_path, "jax_fused.ckpt")
    mj = JaxSCFGP(sparsity=4, nfeats=8, seed=1, dtype=jnp.float32)
    mj.fit_fast(Xt, yt, max_iter=12, checkpoint_path=path,
                checkpoint_every=5)
    m = SCFGP(device="cpu").load(path)
    m.set_data(Xt, yt)
    with pytest.raises(ValueError, match="JAX package"):
        m.optimize_fused(resume=True)


def test_fused_resume_requires_state():
    Xt, yt, _, _ = _data()
    m = SCFGP(sparsity=4, nfeats=8, seed=0, device="cpu")
    m.set_data(Xt, yt)
    with pytest.raises(ValueError, match="resume"):
        m.optimize_fused(resume=True)
