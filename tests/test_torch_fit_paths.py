"""Parity of the port's ``fit_distributed`` on every path with JAX's
``fit_distributed`` on a one-device mesh: L-BFGS with the full line
search, OWL-QN and TRON, over every ``sparse_grad`` mode of the port (on
the CPU ``"csc_kernel"`` takes the kernel's plain version), each held
against JAX's ``"csc"`` fit (``tests/test_torch_fit.py`` holds the kernel
path against JAX's Pallas kernel). Also the margin against the full line
search, ``precomputed_csc`` reuse and the error cases.

Data: n=320 rows, d=48 columns, k=6 explicit values per row with column 0
an intercept of ones, weighted rows (some weight 0) and offsets; l2=1,
l1=2 for OWL-QN with the intercept unpenalized; 8 iterations at tolerance
0, f64. Tolerance on the final ``w``: rtol 1e-6 (the packages sum in
different orders, compounded over the iterations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.parallel.data_parallel import fit_distributed as j_fit
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import LabeledBatch as JBatch
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu_torch.interop import batch_from_numpy
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.data_parallel import (
    build_csc, fit_distributed,
)
from photon_ml_tpu_torch.types import make_batch

RTOL = 1e-6
ITERS = 8
L2, L1 = 1.0, 2.0
OPTIMIZERS = ["lbfgs", "owlqn", "tron"]
MODES = ["scatter", "csc", "csc_kernel", "csc_precise", "csc_segment"]


def _data(seed=7, n=320, dim=48, k=6):
    r = np.random.default_rng(seed)
    idx = r.integers(1, dim, (n, k)).astype(np.int32)
    idx[:, 0] = 0
    vals = r.normal(size=(n, k))
    vals[:, 0] = 1.0
    w_true = np.where(r.random(dim) < 0.6, 0.0, r.normal(size=dim))
    logits = (w_true[idx] * vals).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    offsets = r.normal(scale=0.1, size=n)
    weights = r.random(n) + 0.5
    weights[::23] = 0.0
    return idx, vals, y, offsets, weights, dim


@pytest.fixture(scope="module")
def problem():
    """The data in both packages, and JAX's csc fit for each optimizer."""
    idx, vals, y, offsets, weights, dim = _data()
    jb = JBatch(JSparse(jnp.asarray(idx), jnp.asarray(vals), dim=dim),
                jnp.asarray(y), jnp.asarray(offsets), jnp.asarray(weights))
    mesh = make_mesh(devices=jax.devices()[:1])
    jobj = j_make_objective("logistic", intercept_index=0)
    cfg = JConfig(max_iters=ITERS, tolerance=0.0)
    want = {opt: j_fit(jobj, jb, mesh, jnp.zeros(dim), l2=L2, l1=L1,
                       optimizer=opt, config=cfg, sparse_grad="csc",
                       line_search="full")
            for opt in OPTIMIZERS}
    tb = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                          dtype=torch.float64, device="cpu")
    return tb, want


def _fit(tb, optimizer, mode, line_search="full", iters=ITERS, tol=0.0,
         **kw):
    return fit_distributed(
        make_objective("logistic", intercept_index=0), tb,
        torch.zeros(tb.dim, dtype=torch.float64), l2=L2, l1=L1,
        optimizer=optimizer,
        config=OptimizerConfig(max_iters=iters, tolerance=tol),
        sparse_grad=mode, line_search=line_search, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_fit_matches_jax(problem, optimizer, mode):
    tb, want = problem
    got = _fit(tb, optimizer, mode)
    ref = want[optimizer]
    assert got.iterations == int(ref.iterations) == ITERS
    w = np.asarray(ref.w)
    np.testing.assert_allclose(got.w.numpy(), w, rtol=RTOL,
                               atol=RTOL * np.abs(w).max())
    np.testing.assert_allclose(float(got.value), float(ref.value), rtol=RTOL)
    np.testing.assert_allclose(got.loss_history.numpy(),
                               np.asarray(ref.loss_history), rtol=RTOL)
    if optimizer == "owlqn":
        assert (got.w.numpy()[1:] == 0).any() and got.w[0] != 0
    assert got.host_syncs >= 2 * got.iterations


def test_margin_and_full_line_search_agree(problem):
    """Both L-BFGS paths reach the same optimum (tolerance 1e-10): their
    iterates differ, since the margin path searches in delta space."""
    tb, _ = problem
    fits = [_fit(tb, "lbfgs", "csc_kernel", line_search=ls, iters=200,
                 tol=1e-10) for ls in ("margin", "full")]
    assert all(f.converged for f in fits)
    np.testing.assert_allclose(fits[0].w.numpy(), fits[1].w.numpy(),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_precomputed_csc_reuse(problem, optimizer):
    """A view built once serves every column-sorted mode, bit for bit the
    same fit as the view built inside the fit."""
    tb, _ = problem
    csc = build_csc(tb)
    for mode in MODES[1:]:
        inner = _fit(tb, optimizer, mode)
        reused = _fit(tb, optimizer, mode, precomputed_csc=csc)
        assert torch.equal(inner.w, reused.w)


def test_fit_rejects_invalid_arguments(problem):
    tb, _ = problem
    with pytest.raises(ValueError, match="precomputed_csc"):
        _fit(tb, "owlqn", "scatter", precomputed_csc=build_csc(tb))
    with pytest.raises(ValueError, match="unknown optimizer"):
        _fit(tb, "sgd", "csc")
    with pytest.raises(ValueError, match="line_search"):
        _fit(tb, "lbfgs", "csc", line_search="exact")
    with pytest.raises(ValueError, match="sparse_grad"):
        _fit(tb, "tron", "csc_pallas")
    dense = make_batch(np.eye(4), np.ones(4), dtype=torch.float64,
                       device="cpu")
    with pytest.raises(ValueError, match="SparseFeatures"):
        fit_distributed(make_objective("logistic"), dense,
                        torch.zeros(4, dtype=torch.float64),
                        optimizer="tron", sparse_grad="csc")


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_dense_features_take_the_full_path(optimizer):
    """Dense features resolve ``"auto"`` to the matmul path; the fit
    matches JAX's."""
    r = np.random.default_rng(9)
    X = r.normal(size=(120, 6))
    y = (r.random(120) < 0.5).astype(float)
    cfg = dict(max_iters=ITERS, tolerance=0.0)
    want = j_fit(j_make_objective("logistic"),
                 JBatch(jnp.asarray(X), jnp.asarray(y), jnp.zeros(120),
                        jnp.ones(120)),
                 make_mesh(devices=jax.devices()[:1]), jnp.zeros(6), l2=L2,
                 l1=0.5, optimizer=optimizer, config=JConfig(**cfg),
                 line_search="full")
    got = fit_distributed(make_objective("logistic"),
                          make_batch(X, y, dtype=torch.float64, device="cpu"),
                          torch.zeros(6, dtype=torch.float64), l2=L2, l1=0.5,
                          optimizer=optimizer, config=OptimizerConfig(**cfg),
                          line_search="full")
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want.w)).max())
