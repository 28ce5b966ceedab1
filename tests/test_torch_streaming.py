"""Parity of the port's streamed fixed-effect training
(``photon_ml_tpu_torch/parallel/streaming.py``) with the JAX package's
``parallel/streaming.py`` on one device, on the CPU in float64.

Data: n=600 rows in chunks of 256 (the last padded with zero-weight rows),
d=40 columns, k=6 explicit values per row with column 0 an intercept of
ones (unpenalized), weighted rows (some weight 0) and offsets; l2=1, l1=2
for OWL-QN. On the CPU each chunk's ``"csc_kernel"`` gradient takes the
kernel's plain version.

Tolerances: chunks equal byte for byte; one streamed gradient,
Hessian-vector, diagonal or variance pass rtol 1e-12; the fits (tolerance
0, a fixed number of iterations) w within 1e-8 relative L2 with equal
iteration counts; the port's own runs that the reference promises are
identical (prefetch depth 0 vs 2) bit equal; the streamed fit against the
in-memory ``fit_distributed`` at convergence as the reference's own test
holds it (rtol 1e-4, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.data import HostSparse as JHostSparse
from photon_ml_tpu.ops import normalization as jn
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.ops.statistics import (
    summarize_features_streamed as j_summarize_streamed,
)
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.parallel import streaming as js
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.interop import batch_from_numpy
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.statistics import summarize_features_streamed
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel import streaming as ts
from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed

F64 = torch.float64
CHUNK = 256
L2, L1 = 1.0, 2.0
ITERS = 6
OPTIMIZERS = ["lbfgs", "lbfgs_blackbox", "tron", "owlqn"]


def _data(seed=3, n=600, dim=40, k=6):
    r = np.random.default_rng(seed)
    idx = r.integers(1, dim, (n, k)).astype(np.int32)
    idx[:, 0] = 0
    vals = r.normal(size=(n, k))
    vals[:, 0] = 1.0
    w_true = np.where(r.random(dim) < 0.5, 0.0, r.normal(size=dim))
    logits = (w_true[idx] * vals).sum(1)
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
    offsets = r.normal(scale=0.1, size=n)
    weights = r.random(n) + 0.5
    weights[::17] = 0.0
    return idx, vals, y, offsets, weights, dim


@pytest.fixture(scope="module")
def problem():
    """The chunks in both packages, a point, a direction, and JAX's passes
    and fits on them."""
    idx, vals, y, offsets, weights, dim = _data()
    jchunks, jdim = js.make_host_chunks(JHostSparse(idx, vals, dim), y,
                                        offsets, weights, chunk_rows=CHUNK)
    tchunks, tdim = ts.make_host_chunks(HostSparse(idx, vals, dim), y,
                                        offsets, weights, chunk_rows=CHUNK)
    assert jdim == tdim == dim and len(tchunks) == 3
    r = np.random.default_rng(11)
    w, v = r.normal(size=dim) * 0.3, r.normal(size=dim)
    jobj = j_make_objective("logistic", intercept_index=0)
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    passes = {
        "fg": js.streaming_value_and_grad(jobj, jchunks, dim,
                                          dtype=jnp.float64)(jw, L2),
        "hvp": js.streaming_hvp(jobj, jchunks, dim,
                                dtype=jnp.float64)(jw, jv, L2),
        "diag": js.streaming_hessian_diagonal(jobj, jchunks, dim, jw, L2,
                                              dtype=jnp.float64),
        "var": js.streaming_coefficient_variances(jobj, jchunks, dim, jw, L2,
                                                  dtype=jnp.float64),
    }
    cfg = JConfig(max_iters=ITERS, tolerance=0.0)
    fits = {opt: js.fit_streaming(jobj, jchunks, dim, l2=L2, config=cfg,
                                  dtype=jnp.float64, optimizer=opt,
                                  l1=L1 if opt == "owlqn" else 0.0)
            for opt in OPTIMIZERS}
    return dict(data=(idx, vals, y, offsets, weights, dim), jchunks=jchunks,
                tchunks=tchunks, w=w, v=v, passes=passes, fits=fits)


def _obj(normalization=None):
    return make_objective("logistic", normalization=normalization,
                          intercept_index=0)


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_host_chunks_equal_reference(problem):
    for jc, tc in zip(problem["jchunks"], problem["tchunks"]):
        for field in ("indices", "values", "labels", "offsets", "weights"):
            a, b = getattr(jc, field), getattr(tc, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("implicit", [False, True])
def test_host_chunks_dense_and_padding_equal_reference(implicit):
    r = np.random.default_rng(5)
    X = r.normal(size=(10, 3))
    y = r.integers(0, 2, 10).astype(float)
    if implicit:
        ind = r.integers(0, 7, (10, 2)).astype(np.int32)
        jf, tf, kw = JHostSparse(ind, None, 7), HostSparse(ind, None, 7), {}
    else:
        jf, tf, kw = X, X, {"pad_nnz": 5}
    jc, jd = js.make_host_chunks(jf, y, chunk_rows=4, **kw)
    tc, td = ts.make_host_chunks(tf, y, chunk_rows=4, **kw)
    assert jd == td and len(jc) == len(tc) == 3
    for a, b in zip(jc, tc):
        for field in ("indices", "values", "labels", "offsets", "weights"):
            x, z = getattr(a, field), getattr(b, field)
            assert (x is None) == (z is None)
            if x is not None:
                assert x.tobytes() == z.tobytes(), field
    with pytest.raises(ValueError, match="implicit-ones"):
        ts.make_host_chunks(HostSparse(np.zeros((4, 2), np.int32), None, 3),
                            y[:4], chunk_rows=4, pad_nnz=3)


@pytest.mark.parametrize("mode", ["auto", "csc", "scatter"])
def test_streamed_passes_match_reference(problem, mode):
    """One gradient, Hessian-vector, diagonal and variance pass."""
    chunks, dim = problem["tchunks"], problem["data"][-1]
    w = torch.tensor(problem["w"])
    v = torch.tensor(problem["v"])
    kw = dict(dtype=F64, sparse_grad=mode, device="cpu")
    obj = _obj()
    f, g = ts.streaming_value_and_grad(obj, chunks, dim, **kw)(w, L2)
    hv = ts.streaming_hvp(obj, chunks, dim, **kw)(w, v, L2)
    diag = ts.streaming_hessian_diagonal(obj, chunks, dim, w, L2, **kw)
    var = ts.streaming_coefficient_variances(obj, chunks, dim, w, L2, **kw)
    want = problem["passes"]
    np.testing.assert_allclose(float(f), float(want["fg"][0]), rtol=1e-12)
    for got, ref in ((g, want["fg"][1]), (hv, want["hvp"]),
                     (diag, want["diag"]), (var, want["var"])):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-12,
                                   atol=1e-12)


def test_streamed_pass_with_normalization_matches_reference(problem):
    chunks, dim = problem["tchunks"], problem["data"][-1]
    r = np.random.default_rng(2)
    factors = r.uniform(0.5, 2.0, dim)
    shifts = r.normal(scale=0.1, size=dim)
    factors[0], shifts[0] = 1.0, 0.0
    jctx = jn.NormalizationContext(jnp.asarray(factors), jnp.asarray(shifts),
                                   intercept_index=0)
    tctx = NormalizationContext(torch.tensor(factors), torch.tensor(shifts),
                                intercept_index=0)
    jobj = j_make_objective("logistic", normalization=jctx,
                            intercept_index=0)
    jf, jg = js.streaming_value_and_grad(
        jobj, problem["jchunks"], dim, dtype=jnp.float64)(
            jnp.asarray(problem["w"]), L2)
    f, g = ts.streaming_value_and_grad(
        _obj(tctx), chunks, dim, dtype=F64, device="cpu")(
            torch.tensor(problem["w"]), L2)
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-12)
    np.testing.assert_allclose(_np(g), _np(jg), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_fit_streaming_matches_reference(problem, optimizer):
    res = ts.fit_streaming(
        _obj(), problem["tchunks"], problem["data"][-1], l2=L2,
        config=OptimizerConfig(max_iters=ITERS, tolerance=0.0), dtype=F64,
        optimizer=optimizer, l1=L1 if optimizer == "owlqn" else 0.0,
        device="cpu")
    want = problem["fits"][optimizer]
    assert res.iterations == int(want.iterations)
    assert res.converged == bool(want.converged)
    assert _rel(res.w, want.w) <= 1e-8
    np.testing.assert_allclose(float(res.value), float(want.value),
                               rtol=1e-10)
    n = res.iterations
    np.testing.assert_allclose(_np(res.loss_history)[:n],
                               _np(want.loss_history)[:n], rtol=1e-10)
    assert res.stream_stats["kernel_passes"] >= 1
    assert res.stream_stats["chunks"] >= 3 * res.stream_stats["passes"] - 3


@pytest.mark.parametrize("optimizer", ["lbfgs", "tron"])
def test_prefetch_depth_does_not_change_the_fit(problem, optimizer):
    """The ring only overlaps transfer with compute: depth 0 (synchronous)
    and depth 2 give bit-identical fits."""
    fits = [ts.fit_streaming(
        _obj(), problem["tchunks"], problem["data"][-1], l2=L2,
        config=OptimizerConfig(max_iters=4, tolerance=0.0), dtype=F64,
        optimizer=optimizer, prefetch_depth=depth, device="cpu")
        for depth in (0, 2)]
    assert torch.equal(fits[0].w, fits[1].w)
    assert float(fits[0].value) == float(fits[1].value)


def test_fit_streaming_matches_in_memory_fit(problem):
    """At convergence, as the reference's own test holds its streamed fit
    against ``fit_distributed`` (rtol 1e-4, atol 1e-6)."""
    idx, vals, y, offsets, weights, dim = problem["data"]
    cfg = OptimizerConfig(max_iters=200, tolerance=1e-12)
    res = ts.fit_streaming(_obj(), problem["tchunks"], dim, l2=L2,
                           config=cfg, dtype=F64, device="cpu")
    batch = batch_from_numpy(idx, vals, y, offsets, weights, dim=dim,
                             dtype=F64, device="cpu")
    mem = fit_distributed(_obj(), batch, torch.zeros(dim, dtype=F64), l2=L2,
                          config=cfg)
    assert res.converged
    np.testing.assert_allclose(float(res.value), float(mem.value), rtol=1e-8)
    np.testing.assert_allclose(_np(res.w), _np(mem.w), rtol=1e-4, atol=1e-6)


def test_fit_streaming_warm_start_and_callback(problem):
    dim = problem["data"][-1]
    seen = []
    w0 = torch.full((dim,), 0.01, dtype=F64)
    res = ts.fit_streaming(_obj(), problem["tchunks"], dim, w0=w0, l2=L2,
                           config=OptimizerConfig(max_iters=3,
                                                  tolerance=0.0),
                           dtype=F64, progress_callback=lambda i, w:
                           seen.append(i))
    assert res.w.device.type == "cpu" and seen == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown streaming optimizer"):
        ts.fit_streaming(_obj(), problem["tchunks"], dim, w0=w0,
                         optimizer="newton")


def test_stream_stats_count_the_passes(problem):
    """Each TRON gradient, Hessian-vector and diagonal pass is a kernel
    pass over every chunk; the host reads nothing inside a pass."""
    res = ts.fit_streaming(_obj(), problem["tchunks"], problem["data"][-1],
                           l2=L2, config=OptimizerConfig(max_iters=2,
                                                         tolerance=0.0),
                           dtype=F64, optimizer="tron", device="cpu")
    st = res.stream_stats
    assert st["kernel_passes"] == st["passes"] >= 3
    assert st["chunks"] == 3 * st["passes"]
    assert st["h2d_bytes"] > 0 and res.host_syncs == st["host_reads"] > 0
    assert set(js.StreamStats().as_dict()) <= set(st)


def test_kahan_add_survives_magnitude_gap():
    acc = comp = torch.zeros((), dtype=torch.float32)
    for x in [1e8] + [1.0] * 1000:
        acc, comp = ts._kahan_add(acc, comp,
                                  torch.tensor(x, dtype=torch.float32))
    assert float(acc - comp) == 1e8 + 1000


def test_resolve_prefetch_depth(monkeypatch):
    monkeypatch.delenv("PHOTON_PREFETCH_DEPTH", raising=False)
    assert ts.resolve_prefetch_depth() == ts.DEFAULT_PREFETCH_DEPTH == 2
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "5")
    assert ts.resolve_prefetch_depth() == 5
    assert ts.resolve_prefetch_depth(-3) == 0


def test_transfer_thread_death_fails_within_the_poll(monkeypatch):
    """A transfer thread that dies without its end-of-pass sentinel fails
    the pass at the consumer's bounded poll, never by an unbounded wait."""
    monkeypatch.setattr(ts, "_RING_POLL_S", 0.05)
    monkeypatch.setattr(ts, "_ring_put", lambda q, stop, item: False)
    with pytest.raises(RuntimeError, match="without delivering"):
        list(ts.iter_device_chunks([object(), object()],
                                   to_device=lambda c: c))


@pytest.mark.parametrize("depth", [0, 2])
def test_source_error_surfaces_in_the_consumer(depth):
    def source():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(ts.iter_device_chunks(source(), lambda c: c, depth))


def test_transfer_budget_charges_every_chunk(problem, monkeypatch):
    from photon_ml_tpu_torch.utils import transfer_budget

    charged = []
    monkeypatch.setattr(transfer_budget, "charge",
                        lambda n, what="": charged.append((n, what)))
    fg = ts.streaming_value_and_grad(_obj(), problem["tchunks"],
                                     problem["data"][-1], dtype=F64,
                                     device="cpu")
    fg(torch.zeros(problem["data"][-1], dtype=F64))
    # int32 indices plus float64 values, labels, offsets and weights
    assert charged == [(CHUNK * 6 * (4 + 8) + 3 * CHUNK * 8,
                        "stream chunk")] * 3


def test_summarize_features_streamed_matches_reference(problem):
    idx, vals, y, offsets, weights, dim = problem["data"]
    want = j_summarize_streamed(problem["jchunks"], dim, len(y))
    got = summarize_features_streamed(problem["tchunks"], dim, len(y))
    for field in ("mean", "variance", "std", "min", "max", "num_nonzeros"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=1e-15)
    assert got.count == want.count == len(y)
    # implicit ones
    jc, _ = js.make_host_chunks(JHostSparse(idx, None, dim), y,
                                chunk_rows=CHUNK)
    tc, _ = ts.make_host_chunks(HostSparse(idx, None, dim), y,
                                chunk_rows=CHUNK)
    want = j_summarize_streamed(jc, dim, len(y))
    got = summarize_features_streamed(tc, dim, len(y))
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.max, want.max)
