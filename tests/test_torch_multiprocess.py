"""The port's multi-process paths over a real two-process gloo group
(``tests/torch_multiprocess_worker.py``), float64 on the CPU; every fit's
``w`` is equal across the ranks bit for bit.

* The streamed fit over each process's ``process_span`` (L-BFGS to
  convergence, TRON for 8 iterations) against the JAX package's
  single-process ``fit_streaming`` over all rows: rtol 2e-5, atol 1e-7
  (``tests/test_multiprocess.py:97-99``).
* ``AvroChunkSource(process_part=)`` on one Avro file of 301 rows in
  blocks of 16: every part's span equal to the JAX package's; the
  streamed summary reduced across the processes
  (``summarize_features_streamed(total_rows=, part_reduce=)``) against
  the JAX package's summary of the whole file at relative 1e-12; the
  out-of-core fit against the JAX package's as above.
* GAME CD with ``{"data": 2}`` (the fixed coordinate's rows sharded) and
  with ``{"data": 1, "entity": 2}`` (the random coordinate's entities
  sharded, the fixed coordinate streamed over each process's span)
  against the port's one-rank CD (which ``tests/test_torch_game.py`` holds
  against the JAX package): the fixed coefficients at rtol 1e-6,
  atol 1e-9; the random coefficients at rtol 1e-6, atol 1e-9 behind a
  sharded fixed coordinate, and at 1e-10 when only the entities shard.
* ``train_random_effect`` and ``score_random_effect`` with the entities
  sharded, a full solve and an active-set re-solve with incremental
  rescoring, against one rank: 1e-10.
* The screened path sharded by rows against the port's one-rank path:
  rtol 1e-6, atol 1e-9.
* The GLM driver as two processes (``--num-processes 2``) against one
  process: the models at rtol 1e-6, atol 1e-9.
* The resilience layer over the real gloo world (its own pair of
  processes, FAULT_LEG_TIMEOUT_S from spawn to exit): a raise at
  ``cd.step`` on rank 1 is a ``PeerFailure`` on both ranks; a stall
  longer than a 3 s barrier timeout is a ``WatchdogTimeout`` on rank 0
  within the timeout plus 1.5 s; a rollback recovery of an entity-sharded
  CD is bit-equal to the uninterrupted two-process run, which is bit-equal
  to the one-process run.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.io.stream_source import AvroChunkSource as JSource
from photon_ml_tpu.ops.objective import make_objective as j_make_objective
from photon_ml_tpu.ops.statistics import (
    summarize_features_streamed as j_summarize,
)
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.parallel.streaming import fit_streaming as j_fit_streaming
from photon_ml_tpu.parallel.streaming import (
    make_host_chunks as j_make_host_chunks,
)
from photon_ml_tpu.game.data import HostSparse as JHostSparse
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.io.data_reader import write_training_examples
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.stream_source import AvroChunkSource

sys.path.insert(0, os.path.dirname(__file__))
import torch_multiprocess_worker as mpw  # noqa: E402

STREAM_RTOL, STREAM_ATOL = 2e-5, 1e-7
RTOL, ATOL = 1e-6, 1e-9
ENTITY_TOL = 1e-10
WORLD = 2


def _write_avro(path):
    idx, vals, y, offsets, weights, _ = mpw.glm_problem()
    rows = [[(f"f{j}", "", float(v)) for j, v in zip(ri, rv)]
            for ri, rv in zip(idx, vals)]
    write_training_examples(path, rows, y, offsets=offsets, weights=weights,
                            block_size=16)


def _write_libsvm(path):
    idx, vals, y = mpw.glm_problem()[:3]
    with open(path, "w") as f:
        for ri, rv, label in zip(idx, vals, y):
            row = {}
            for j, v in zip(ri, rv):
                row[int(j)] = row.get(int(j), 0.0) + float(v)
            f.write(f"{int(label)} " + " ".join(
                f"{j + 1}:{row[j]!r}" for j in sorted(row)) + "\n")


DRIVER_ARGS = ["--input-format", "libsvm", "--reg-weights", "1", "0.1",
               "--dtype", "float64", "--tolerance", "0", "--max-iters", "8",
               "--device", "cpu", "--no-validate-data",
               "--compute-variances"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawned scenarios, the two-process driver run and every
    reference, the references built here while the processes run."""
    root = tmp_path_factory.mktemp("mp")
    avro = str(root / "train.avro")
    _write_avro(avro)
    svm = str(root / "train.svm")
    _write_libsvm(svm)
    wait = mpw.start(WORLD, ["stream", "ooc", "cd", "path", "re"],
                     str(root / "ranks"), data=avro)
    port = mpw.free_port()
    drv = str(root / "driver2")
    wait_driver = mpw.launch(
        [[sys.executable, "-m", "photon_ml_tpu_torch.cli.glm_driver",
          "--train-data", svm, "--output-dir", drv, *DRIVER_ARGS,
          "--coordinator-address", f"127.0.0.1:{port}",
          "--num-processes", str(WORLD), "--process-id", str(r)]
         for r in range(WORLD)], str(root))
    refs = {"jax": _jax_refs(avro),
            "cd_data": mpw.run_cd(None), "cd_entity": mpw.run_cd(None, True),
            "path": mpw.run_path(None), "re": mpw.run_re(None)}
    one = str(root / "driver1")
    assert glm_driver.main(["--train-data", svm, "--output-dir", one,
                            *DRIVER_ARGS]) == 0
    ranks = wait()
    wait_driver()
    return {"ranks": ranks, "refs": refs, "driver": (drv, one),
            "avro": avro}


def _jax_refs(avro):
    idx, vals, y, offsets, weights, dim = mpw.glm_problem()
    jobj = j_make_objective("logistic", intercept_index=dim - 1)
    chunks, _ = j_make_host_chunks(JHostSparse(idx, vals, dim), y, offsets,
                                   weights, chunk_rows=64)
    out = {}
    for name, opt, cfg in (
            ("lbfgs", "lbfgs", JConfig(max_iters=60, tolerance=1e-12)),
            ("tron", "tron", JConfig(max_iters=mpw.ITERS, tolerance=0.0))):
        res = j_fit_streaming(jobj, chunks, dim, l2=mpw.L2, config=cfg,
                              dtype=jnp.float64, optimizer=opt)
        out[f"{name}_w"] = np.asarray(res.w)
        out[f"{name}_value"] = float(res.value)
    imap = JIndexMap({f"f{j}": j for j in range(dim)}, add_intercept=False)
    src = JSource(avro, imap, chunk_rows=32, dtype=np.float64)
    out["summary"] = j_summarize(src, src.dim, src.rows)
    out["ooc_w"] = np.asarray(j_fit_streaming(
        j_make_objective("logistic"), src, dim, l2=mpw.L2,
        config=JConfig(max_iters=60, tolerance=1e-12),
        dtype=jnp.float64).w)
    out["spans"] = JSource(avro, imap, chunk_rows=32, dtype=np.float64,
                           process_part=(0, WORLD)).part_spans
    return out


def _rank_equal(ranks, key):
    first = ranks[0][key]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[key], first, err_msg=key)
    return first


@pytest.mark.parametrize("name", ["lbfgs", "tron"])
def test_streamed_fit_over_process_spans_matches_jax(runs, name):
    ranks, want = runs["ranks"], runs["refs"]["jax"]
    w = _rank_equal(ranks, f"stream/{name}_w")
    np.testing.assert_allclose(w, want[f"{name}_w"], rtol=STREAM_RTOL,
                               atol=STREAM_ATOL)
    np.testing.assert_allclose(_rank_equal(ranks, f"stream/{name}_value"),
                               want[f"{name}_value"], rtol=STREAM_RTOL)
    for r in ranks:  # each pass's partials crossed the processes
        assert float(r[f"stream/{name}_comm_s"]) > 0


@pytest.mark.parametrize("n_parts", [2, 3, 5])
def test_process_part_spans_match_jax(runs, n_parts):
    dim = mpw.glm_problem()[5]
    port_map = IndexMap({f"f{j}": j for j in range(dim)}, add_intercept=False)
    jax_map = JIndexMap({f"f{j}": j for j in range(dim)},
                        add_intercept=False)
    for part in range(n_parts):
        got = AvroChunkSource(runs["avro"], port_map, chunk_rows=32,
                              process_part=(part, n_parts))
        want = JSource(runs["avro"], jax_map, chunk_rows=32,
                       process_part=(part, n_parts))
        assert got.part_spans == want.part_spans
        assert got.row_span == want.row_span and got.rows == want.rows
        assert [c.labels.tolist() for c in got] == \
            [c.labels.tolist() for c in want]
    with pytest.raises(ValueError, match="owns no container blocks"):
        AvroChunkSource(runs["avro"], port_map, chunk_rows=32,
                        process_part=(0, 64))
    with pytest.raises(ValueError, match="out of range"):
        AvroChunkSource(runs["avro"], port_map, chunk_rows=32,
                        process_part=(2, 2))


def test_out_of_core_parts_summary_and_fit(runs):
    ranks, want = runs["ranks"], runs["refs"]["jax"]
    spans = _rank_equal(ranks, "ooc/part_spans")
    assert [tuple(s) for s in spans] == list(want["spans"])
    for r, res in enumerate(ranks):
        assert tuple(res["ooc/row_span"]) == tuple(spans[r])
        assert int(res["ooc/rows"]) == spans[r][1] - spans[r][0]
    summ = want["summary"]
    for key, ref in (("mean", summ.mean), ("variance", summ.variance),
                     ("min", summ.min), ("max", summ.max),
                     ("nnz", summ.num_nonzeros)):
        got = _rank_equal(ranks, f"ooc/{key}")
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15,
                                   err_msg=key)
    assert int(_rank_equal(ranks, "ooc/count")) == summ.count
    np.testing.assert_allclose(_rank_equal(ranks, "ooc/w"), want["ooc_w"],
                               rtol=STREAM_RTOL, atol=STREAM_ATOL)


@pytest.mark.parametrize("tag", ["data", "entity"])
def test_cd_sharded_matches_one_rank(runs, tag):
    ranks, one = runs["ranks"], runs["refs"][f"cd_{tag}"]
    np.testing.assert_allclose(_rank_equal(ranks, f"cd/{tag}_w_fixed"),
                               one["w_fixed"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_rank_equal(ranks, f"cd/{tag}_v_fixed"),
                               one["v_fixed"], rtol=RTOL, atol=ATOL)
    buckets = [k for k in one if k.startswith("re")]
    assert buckets
    for k in buckets:
        got = _rank_equal(ranks, f"cd/{tag}_{k}")
        if tag == "entity":
            np.testing.assert_allclose(got, one[k], rtol=0,
                                       atol=ENTITY_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got, one[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    auc = _rank_equal(ranks, f"cd/{tag}_auc")
    # the last record is the host evaluator's; with a data mesh the
    # per-step device AUC is the histogram AUC, within a bin of it
    np.testing.assert_allclose(auc[-1], one["auc"][-1], atol=1e-6)
    if tag == "entity":
        np.testing.assert_allclose(auc, one["auc"], atol=1e-6)


def test_entity_sharded_solve_and_scores_match_one_rank(runs):
    """Every entity's solve is the same arithmetic on one rank or on its
    block: coefficients, variances and convergence flags of a full solve
    and of an active-set re-solve, and the scores (each row written by
    one rank, the rest summed as zeros), within 1e-10; the convergence
    flags equal."""
    ranks, one = runs["ranks"], runs["refs"]["re"]
    for key in one:
        got = _rank_equal(ranks, f"re/{key}")
        if "conv" in key:
            np.testing.assert_array_equal(got, one[key], err_msg=key)
        else:
            np.testing.assert_allclose(got, one[key], rtol=0,
                                       atol=ENTITY_TOL, err_msg=key)


def test_path_sharded_matches_one_rank(runs):
    ranks, one = runs["ranks"], runs["refs"]["path"]
    np.testing.assert_allclose(_rank_equal(ranks, "path/lam_max"),
                               one["lam_max"], rtol=1e-12)
    for i in range(2):
        np.testing.assert_allclose(_rank_equal(ranks, f"path/w{i}"),
                                   one[f"w{i}"], rtol=RTOL, atol=ATOL)
        assert int(_rank_equal(ranks, f"path/screened{i}")) == \
            int(one[f"screened{i}"])


def test_glm_driver_two_processes_match_one(runs):
    two, one = runs["driver"]
    for sub in ("best", os.path.join("all", "lambda-1"),
                os.path.join("all", "lambda-0.1")):
        got, want = (load_game_model(os.path.join(d, sub), device="cpu")
                     for d in (two, one))
        for field in ("means", "variances"):
            np.testing.assert_allclose(
                getattr(got.coordinates["global"].model.coefficients,
                        field).numpy(),
                getattr(want.coordinates["global"].model.coefficients,
                        field).numpy(),
                rtol=RTOL, atol=ATOL, err_msg=f"{sub} {field}")
    assert os.path.exists(os.path.join(two, "photon.log.rank-1.jsonl"))
    with open(os.path.join(two, "photon.log.jsonl")) as f:
        start = json.loads(f.readline())
    assert start["distributed"] is True
    assert (start["process_index"], start["process_count"]) == (0, WORLD)


# -- the resilience layer over the real gloo world --------------------------
FAULT_LEG_TIMEOUT_S = 60  # spawn to exit; a hang fails the leg, not the run


@pytest.fixture(scope="module")
def fault_ranks(tmp_path_factory):
    """The ``faults`` scenario on two processes (its own group), and the
    port's one-process sharded-CD reference built while they run."""
    root = tmp_path_factory.mktemp("mp_faults")
    wait = mpw.start(WORLD, ["faults"], str(root))
    one = mpw.run_sharded_cd(0, 1)
    return wait(FAULT_LEG_TIMEOUT_S), one


def test_real_process_raise_is_a_peer_failure_on_both_ranks(fault_ranks):
    ranks, _ = fault_ranks
    for res in ranks:
        assert str(res["faults/raise_outcome"]) == "PeerFailure"
        # both learn who failed and how: rank 1, a generic error (1)
        assert res["faults/raise_failed"].tolist() == [[1, 1]]


def test_real_process_watchdog_fires_within_its_timeout(fault_ranks):
    ranks, _ = fault_ranks
    assert str(ranks[0]["faults/watchdog_outcome"]) == "WatchdogTimeout"
    # rank 0 waits out WATCHDOG_S at its barrier, not rank 1's stall
    assert float(ranks[0]["faults/watchdog_s"]) < mpw.WATCHDOG_S + 1.5
    assert float(ranks[0]["faults/watchdog_s"]) < mpw.WATCHDOG_DELAY_S


def test_real_process_rollback_is_bit_equal_to_uninterrupted(fault_ranks):
    ranks, one = fault_ranks
    for key in ("w_fixed", "auc", "re_ids", "re_coef"):
        clean = _rank_equal(ranks, f"faults/clean_{key}")
        np.testing.assert_array_equal(
            _rank_equal(ranks, f"faults/rollback_{key}"), clean, key)
        # the sharded run is the one-process run bit for bit
        np.testing.assert_array_equal(clean, one[key], key)
    for res in ranks:
        rollbacks, recoveries, snapshots = res["faults/rollback_stats"]
        assert (rollbacks, recoveries) == (1, 1)
        # sweeps 0, 1, 2 and the re-commit of sweep 1 after the rollback
        assert snapshots == mpw.FAULT_SWEEPS + 1
