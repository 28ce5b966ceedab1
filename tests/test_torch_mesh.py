"""The port's mesh (``parallel/mesh.py``), multi-process runtime
(``parallel/multihost.py``) and sharded fixed-effect fits
(``parallel/data_parallel.py``'s mesh arms) over ``torch.distributed``.

World size 1 runs in this process (a gloo group joined through
``initialize_multihost``). World sizes 2 and 3 run as spawned gloo groups,
one per world size for the module (``tests/torch_multiprocess_worker.py``),
held against the JAX package's own mesh arms on ``{"data": 2}`` and
``{"data": 3}`` of the conftest's CPU devices, at float64 on the same numpy
inputs (n = 301 rows, so every shard of 2 and 3 pads with weight-0 rows):

* value, gradient, Hessian-vector product, Hessian diagonal, the
  column-sorted path through the kernel's wrapper (its plain version on
  the CPU) and the margin path's trial scalars: relative 1e-12;
* fits (L-BFGS with the margin line search, TRON and OWL-QN through
  ``csc_kernel``, L-BFGS with the full line search through ``scatter``),
  8 iterations at tolerance 0: ``w`` at rtol 1e-6, atol 1e-9 and the value
  at 1e-9 (``tests/test_parallel.py:236-239``);
* the histogram AUC and the device AUC evaluator over the mesh: 1e-12.

Every rank's results are equal bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from photon_ml_tpu.evaluation import device as jdevice
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.parallel import data_parallel as jdp
from photon_ml_tpu.parallel.mesh import make_mesh as j_make_mesh
from photon_ml_tpu.parallel.mesh import shard_batch as j_shard_batch
from photon_ml_tpu.types import LabeledBatch as JBatch
from photon_ml_tpu.types import SparseFeatures as JSparse
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
from photon_ml_tpu_torch.types import LabeledBatch, SparseFeatures

sys.path.insert(0, os.path.dirname(__file__))
import torch_multiprocess_worker as mpw  # noqa: E402

REL = 1e-12
RTOL, ATOL, VTOL = 1e-6, 1e-9, 1e-9
WORLDS = (2, 3)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# -- world size 1, in this process ------------------------------------------
@pytest.fixture(scope="module")
def world1():
    """A one-process gloo group through ``initialize_multihost``, left
    when the module's tests are done."""
    assert multihost.initialize_multihost(
        f"127.0.0.1:{mpw.free_port()}", 1, 0, device="cpu", timeout_s=60)
    yield tmesh.make_mesh(device_type="cpu")
    dist.destroy_process_group()


def test_initialize_noop_and_flag_pairing():
    assert multihost.initialize_multihost() is False
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize_multihost("host:1", num_processes=2)
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize_multihost(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="out of range"):
        multihost.initialize_multihost("host:1", 2, 2, device="cpu")


def test_rendezvous_retries_then_raises(monkeypatch):
    calls = []

    def flaky(*a, **kw):
        calls.append(kw["rank"])
        if len(calls) < 3:
            raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", flaky)
    assert multihost.initialize_multihost("h:1", 1, 0, backoff_s=0.0,
                                          device="cpu")
    assert len(calls) == 3
    calls.clear()
    monkeypatch.setenv("PHOTON_ML_TPU_INIT_ATTEMPTS", "2")
    with pytest.raises(RuntimeError, match="refused"):
        multihost.initialize_multihost("h:1", 1, 0, backoff_s=0.0,
                                       device="cpu")
    assert len(calls) == 2


def test_make_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_mesh({"data": 1}, device_type="cpu")


@pytest.mark.parametrize("total,p", [(10, 3), (0, 4), (7, 8), (64, 8),
                                     (101, 7)])
def test_span_partition_math(total, p):
    s = [multihost.span_of(total, i, p) for i in range(p)]
    assert s[0][0] == 0 and s[-1][1] == total
    assert all(s[i][1] == s[i + 1][0] for i in range(p - 1))
    sizes = [b - a for a, b in s]
    assert max(sizes) - min(sizes) <= 1


def test_world1_runtime(world1):
    mesh = world1
    assert tmesh.axis_size(mesh, "data") == 1
    assert tmesh.axis_size(mesh, "entity") == 1  # absent axis
    assert tmesh.mesh_device(mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="need 2 ranks"):
        tmesh.make_mesh({"data": 2}, device_type="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh({"data": 0}, device_type="cpu")
    two = tmesh.make_mesh({"data": 1, "entity": 1}, device_type="cpu")
    assert two.mesh_dim_names == ("data", "entity")
    info = multihost.runtime_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert info["backend"] == "gloo"
    assert multihost.process_span(100) == (0, 100)
    assert multihost.is_lead()
    x = np.arange(7.0)
    np.testing.assert_array_equal(multihost.allgather_spans(x, 7), x)
    moments = tuple(np.arange(3.0) + i for i in range(5))
    assert multihost.allreduce_summary_moments(*moments) == moments
    w = torch.arange(4.0)
    rep = tmesh.replicate(w, mesh)
    assert torch.equal(rep, w) and rep.data_ptr() != w.data_ptr()


def _batch(implicit=False, n=10):
    r = np.random.default_rng(0)
    idx = torch.as_tensor(r.integers(0, 6, (n, 3)), dtype=torch.int32)
    vals = None if implicit else torch.as_tensor(r.normal(size=(n, 3)))
    return LabeledBatch(SparseFeatures(idx, vals, 6),
                        torch.as_tensor(r.random(n)),
                        torch.as_tensor(r.normal(size=n)),
                        torch.ones(n, dtype=torch.float64))


@pytest.mark.parametrize("implicit", [False, True])
def test_pad_batch_rows_are_inert(implicit):
    b = tmesh.pad_batch(_batch(implicit), 4)
    assert b.num_examples == 12
    assert torch.equal(b.labels[10:], torch.ones(2, dtype=torch.float64))
    assert not b.weights[10:].any() and not b.offsets[10:].any()
    assert not b.features.indices[10:].any()
    assert (b.features.values is None) == implicit
    if not implicit:
        assert not b.features.values[10:].any()
    assert tmesh.pad_batch(b, 4) is b


def test_shard_batch_world1_is_the_whole_batch(world1):
    b = _batch()
    s = tmesh.shard_batch(b, world1)
    for x, y in ((s.labels, b.labels), (s.offsets, b.offsets),
                 (s.weights, b.weights), (s.features.indices,
                                          b.features.indices),
                 (s.features.values, b.features.values)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("optimizer,line_search",
                         [("lbfgs", "margin"), ("tron", "full"),
                          ("owlqn", "full")])
def test_world1_fit_equals_no_mesh(world1, optimizer, line_search):
    """A one-rank mesh fits bit for bit as ``mesh=None`` does, with the
    same host reads."""
    batch = mpw.port_batch()
    obj = make_objective("logistic", intercept_index=batch.dim - 1)
    fits = [fit_distributed(
        obj, batch, torch.zeros(batch.dim, dtype=torch.float64), l2=mpw.L2,
        l1=mpw.L1, optimizer=optimizer,
        config=OptimizerConfig(max_iters=mpw.ITERS, tolerance=0.0),
        sparse_grad="csc_kernel", line_search=line_search, mesh=m)
        for m in (None, world1)]
    assert torch.equal(fits[0].w, fits[1].w)
    assert float(fits[0].value) == float(fits[1].value)
    assert fits[0].host_syncs == fits[1].host_syncs


# -- world sizes 2 and 3, spawned --------------------------------------------
def _jax_refs(world):
    """The JAX package's mesh arms on ``world`` CPU devices, same inputs."""
    idx, vals, y, offsets, weights, dim = mpw.glm_problem()
    jb = JBatch(JSparse(jnp.asarray(idx), jnp.asarray(vals), dim=dim),
                jnp.asarray(y), jnp.asarray(offsets), jnp.asarray(weights))
    jobj = j_make_objective("logistic", intercept_index=dim - 1)
    mesh = j_make_mesh({"data": world}, devices=jax.devices()[:world])

    def terms(w, v, sb):
        r = {}
        r["f"], r["g"] = jdp.distributed_value_and_grad(jobj, mesh)(
            w, sb, mpw.L2)
        r["value"] = r["f"]
        r["hv"] = jdp.distributed_hvp(jobj, mesh)(w, v, sb, mpw.L2)
        r["diag"] = r["diag_csc"] = jdp.distributed_diagonal_hessian(
            jobj, mesh)(w, sb, mpw.L2)
        build, fg, hvp = jdp.make_csc_path(jobj, mesh)
        csc = build(sb)
        r["f_csc"], r["g_csc"] = fg(w, sb, csc, mpw.L2)
        r["hv_csc"] = hvp(w, v, sb, csc, mpw.L2)
        init_m, dir_m, loss_dir, data_grad, delta_dir = \
            jdp.make_margin_path(jobj, mesh, transpose="csc")
        m, mp = init_m(w, sb), dir_m(sb)(v)
        r["loss_dir"] = jnp.stack(loss_dir(sb)(m, mp))
        r["delta_dir"] = jnp.stack(delta_dir(sb)(m, mp, 0.25))
        r["grad_m"] = data_grad(sb, csc)(m)
        return r

    w, v = (jnp.asarray(a) for a in mpw.point(dim))
    r = jax.jit(terms)(w, v, j_shard_batch(jb, mesh))
    cfg = JConfig(max_iters=mpw.ITERS, tolerance=0.0)
    for name, opt, mode, ls in mpw.FITS:
        res = jdp.fit_distributed(
            jobj, jb, mesh, jnp.zeros(dim), l2=mpw.L2, l1=mpw.L1,
            optimizer=opt, config=cfg,
            sparse_grad="csc" if mode == "csc_kernel" else mode,
            line_search=ls)
        r[f"{name}_w"], r[f"{name}_value"] = res.w, res.value
        r[f"{name}_iters"] = res.iterations
    s, lab, wt = (jnp.asarray(a) for a in mpw.auc_problem())
    r["hist"] = jdevice.histogram_auc(s, lab, wt, n_bins=64, mesh=mesh,
                                      axis="data")
    r["eval"] = jdevice.make_device_evaluator("auc", mesh)(s, lab, wt)
    return {k: np.asarray(a) for k, a in r.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Per world size: every rank's results and the JAX references, built
    here while the ranks run."""
    waits = {w: mpw.start(w, ["grads", "fits", "auc"],
                          str(tmp_path_factory.mktemp(f"mesh{w}")))
             for w in WORLDS}
    refs = {w: _jax_refs(w) for w in WORLDS}
    return {w: (waits[w](), refs[w]) for w in WORLDS}


def _rank_equal(results, key):
    """Every rank's ``key`` equal bit for bit; rank 0's value."""
    first = results[0][key]
    for res in results[1:]:
        np.testing.assert_array_equal(res[key], first, err_msg=key)
    return first


GRAD_KEYS = ["f", "g", "value", "hv", "diag", "f_csc", "g_csc", "hv_csc",
             "diag_csc", "loss_dir", "delta_dir", "grad_m"]


@pytest.mark.parametrize("key", GRAD_KEYS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_terms_match_jax_mesh(spawned, world, key):
    ranks, want = spawned[world]
    assert _rel(_rank_equal(ranks, f"grads/{key}"), want[key]) <= REL, key


@pytest.mark.parametrize("name", [f[0] for f in mpw.FITS])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_jax_mesh(spawned, world, name):
    ranks, want = spawned[world]
    got = {k: _rank_equal(ranks, f"fits/{name}_{k}")
           for k in ("w", "value", "iters", "reads")}
    assert int(got["iters"]) == int(want[f"{name}_iters"]) == mpw.ITERS
    np.testing.assert_allclose(got["w"], want[f"{name}_w"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["value"], want[f"{name}_value"],
                               rtol=VTOL)
    if name == "owlqn":
        assert (got["w"][:-1] == 0).any() and got["w"][-1] != 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_host_reads_as_on_one_device(spawned, world):
    """The collectives add no host read: each fit reads the host as often
    as the same fit on one process."""
    batch = mpw.port_batch()
    obj = make_objective("logistic", intercept_index=batch.dim - 1)
    for name, opt, mode, ls in mpw.FITS:
        one = fit_distributed(
            obj, batch, torch.zeros(batch.dim, dtype=torch.float64),
            l2=mpw.L2, l1=mpw.L1, optimizer=opt,
            config=OptimizerConfig(max_iters=mpw.ITERS, tolerance=0.0),
            sparse_grad=mode, line_search=ls)
        assert int(_rank_equal(spawned[world][0], f"fits/{name}_reads")) \
            == one.host_syncs, name


@pytest.mark.parametrize("key", ["hist", "eval"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_histogram_auc_matches_jax_mesh(spawned, world, key):
    ranks, want = spawned[world]
    assert abs(float(_rank_equal(ranks, f"auc/{key}"))
               - float(want[key])) <= REL
