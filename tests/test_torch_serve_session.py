"""The port's scoring session (``photon_ml_tpu_torch/serve/session.py``)
against the JAX package's, on the CPU.

Both sessions load the same saved model directory, written by the port
(:func:`save_small_game_model`: a fixed coordinate and a per-user random
effect, seeded random coefficients in the shapes of ``tests/conftest.py``'s
``saved_game_model``, which trains its model with JAX at a cost of seconds
per test worker), and score the same request rows (``serving_rows``),
with unknown entities and offsets, in float64. Tolerance 1e-9 absolute, as the JAX package's own
session tests hold its session to ``score_game_model``: the two packages
sum a row's products in their own orders. On the CPU the port's rungs run
their bodies eagerly, so the counters are checked here and the captured
CUDA graphs in ``tests/test_torch_cuda.py``."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.game.scoring import score_game_model as jax_score_game
from photon_ml_tpu.io.model_io import load_game_model as jax_load_game_model
from photon_ml_tpu.serve.batcher import ScoreContext as JaxContext
from photon_ml_tpu.serve.session import (
    ScoringSession as JaxSession,
    bucket_ladder as jax_bucket_ladder,
    bucketize as jax_bucketize,
)
from photon_ml_tpu_torch.serve import ScoreContext, ScoringSession
from photon_ml_tpu_torch.serve.session import bucket_ladder, bucketize
from photon_ml_tpu_torch.utils import transfer_budget
from tests.conftest import serving_rows

TOL = 1e-9
IDX = list(range(24))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The session's CPU tensors are tiny; torch's thread pool only adds
    waits. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def save_small_game_model(root):
    """Save, with the port's ``save_game_model``, a GAME model of the
    shapes of ``tests/conftest.py``'s ``saved_game_model`` with seeded
    random coefficients: fixed over shard ``g`` (6 features), ``per-user``
    over shard ``u`` (4 features) for users "0".."8". Returns (model_dir,
    bundle) as that fixture does: 160 rows of both shards, their users,
    and the model as the JAX package loads it."""
    from photon_ml_tpu_torch import models as m
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.model_io import save_game_model

    r = np.random.default_rng(11)
    n, d_fix, d_re, n_entities = 160, 6, 4, 9
    Xg, Xu = r.normal(size=(n, d_fix)), r.normal(size=(n, d_re))
    uid = r.integers(0, n_entities, n)
    model = m.GameModel({
        "fixed": m.FixedEffectModel(m.GeneralizedLinearModel(
            m.Coefficients(torch.from_numpy(r.normal(size=d_fix)))),
            feature_shard="g"),
        "per-user": m.RandomEffectModel(
            "per-user", [m.RandomEffectBucket(
                [str(e) for e in range(n_entities)],
                r.normal(size=(n_entities, d_re)),
                np.tile(np.arange(d_re, dtype=np.int32), (n_entities, 1)))],
            "logistic", feature_shard="u", entity_column="userId")},
        task="logistic")
    model_dir = os.path.join(str(root), "model")
    save_game_model(model, model_dir, {
        "g": IndexMap({f"g{j}": j for j in range(d_fix)}),
        "u": IndexMap({f"u{j}": j for j in range(d_re)})})
    return model_dir, {
        "Xg": Xg, "Xu": Xu, "uid": uid, "d_fix": d_fix, "d_re": d_re,
        "n_entities": n_entities, "loaded": jax_load_game_model(model_dir)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The request rows (two unknown users, offsets) and the JAX
    references for them: ``score_game_model`` and the JAX session, each
    with its per-coordinate parts, built once for the module."""
    model_dir, bundle = save_small_game_model(
        tmp_path_factory.mktemp("session"))
    uid = bundle["uid"].astype(str).copy()
    uid[IDX[3]] = "never-seen-entity"
    uid[IDX[17]] = "another-unknown"
    offsets = np.linspace(-0.5, 0.5, len(IDX))
    rows = serving_rows(bundle, IDX, entity_ids=uid, offsets=offsets)
    total, parts = jax_score_game(
        bundle["loaded"],
        {"g": bundle["Xg"][IDX], "u": bundle["Xu"][IDX]},
        {"userId": np.asarray([uid[i] for i in IDX])},
        offsets=offsets, dtype=jnp.float64, per_coordinate=True)
    batch = (np.asarray(total), {k: np.asarray(v) for k, v in parts.items()})
    sessions = {}
    for paged in (True, False):
        s = JaxSession(model_dir, dtype="float64", max_batch=32,
                       paged_table=paged, warmup=False)
        sessions[paged] = s.score_rows(rows, per_coordinate=True)
        s.close()
    return dict(model_dir=model_dir, bundle=bundle, rows=rows, batch=batch,
                jax_session=sessions)


def _session(model_dir, **kw):
    kw.setdefault("dtype", "float64")
    kw.setdefault("max_batch", 32)
    return ScoringSession(model_dir, device="cpu", **kw)


def _close(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) <= TOL


@pytest.mark.parametrize("paged", [True, False])
def test_session_matches_jax_session_and_batch_scorer(case, paged):
    """Totals and per-coordinate parts within 1e-9 of the JAX session and
    of the JAX ``score_game_model``, with two unknown users (scored by
    the fixed effect alone) and offsets, through the fused paged rung and
    through the per-coordinate path."""
    session = _session(case["model_dir"], paged_table=paged, warmup=False)
    try:
        assert session.paged_active == paged
        got, parts = session.score_rows(case["rows"], per_coordinate=True)
        assert session.score_rows(case["rows"]).tolist() == got.tolist()
    finally:
        session.close()
    for ref_total, ref_parts in (case["batch"], case["jax_session"][paged]):
        assert got.shape == (len(IDX),) and _close(got, ref_total)
        assert set(parts) == set(ref_parts) == {"fixed", "per-user"}
        for name in parts:
            assert _close(parts[name], ref_parts[name])
    # the unknown users' random-effect part is exactly 0
    assert parts["per-user"][3] == 0 and parts["per-user"][17] == 0


@pytest.mark.parametrize("top,start", [(1, 1), (16, 1), (48, 1), (64, 1),
                                       (100, 4), (5, 8)])
def test_bucket_ladder_and_bucketize_match_jax(top, start):
    ladder = bucket_ladder(top, start)
    assert ladder == jax_bucket_ladder(top, start)
    for n in (1, 2, 3, top - 1, top, top + 1, 2 * top + 3, 1000):
        if n >= 1:
            assert bucketize(n, ladder) == jax_bucketize(n, ladder)


@pytest.mark.parametrize("paged", [True, False])
def test_no_capture_in_steady_state_swap_or_rollback(case, paged):
    """Warmup captures one rung per ladder step; 100 batches of varying
    sizes inside the ladder capture nothing; an identical swap scores bit
    for bit as before and captures nothing; so does the rollback."""
    model_dir, bundle = case["model_dir"], case["bundle"]
    session = _session(model_dir, paged_table=paged)
    try:
        assert session.compile_count == len(session.row_ladder) == 6
        probe = serving_rows(bundle, list(range(20)))
        before = session.score_rows(probe)
        rng = np.random.default_rng(3)
        hits = session.metrics.compile_cache_hits
        for _ in range(100):
            n = int(rng.integers(1, 33))
            idx = rng.integers(0, len(bundle["uid"]), n)
            assert session.score_rows(serving_rows(bundle, idx)).shape == (n,)
        assert session.compile_count == len(session.row_ladder)
        assert session.metrics.compile_cache_hits >= hits + 100
        assert session.fixed_eager_batches == 0
        assert session.fused_fallback_batches == 0
        first = session.active_version
        session.swap(model_dir, version="again")
        assert session.drain_installs(10.0)
        assert session.active_version == "again"
        assert session.score_rows(probe).tolist() == before.tolist()
        assert session.rollback() == first
        assert session.score_rows(probe).tolist() == before.tolist()
        assert session.compile_count == len(session.row_ladder)
        assert session.metrics.swaps_total == 2
    finally:
        session.close()


def test_batches_whose_installs_evict_their_own_entities(case):
    """With 2 pages of 2 rows for 9 users, an install often evicts a page
    holding users its own batch found resident: those rows go round again
    (each round one more rung hit); a batch whose users cannot all land
    in the table within the rounds scores the rest by host math, as the
    JAX session scores its overflow rows. Every score stays within 1e-9
    of the JAX ``score_game_model``."""
    model_dir, bundle = case["model_dir"], case["bundle"]
    n_rows = len(bundle["uid"])
    ref = np.asarray(jax_score_game(
        bundle["loaded"], {"g": bundle["Xg"], "u": bundle["Xu"]},
        {"userId": bundle["uid"].astype(str)}, dtype=jnp.float64))
    session = _session(model_dir, re_pages=2, re_page_rows=2)
    try:
        rng = np.random.default_rng(8)
        hits = session.metrics.compile_cache_hits
        batches = [rng.integers(0, n_rows, int(rng.integers(2, 5)))
                   for _ in range(30)]
        for idx in batches:
            got = session.score_rows(serving_rows(bundle, idx))
            assert _close(got, ref[idx])
        assert session.metrics.compile_cache_hits - hits > len(batches)
        assert session.overflow_rows == 0
        assert session.compile_count == len(session.row_ladder)
    finally:
        session.close()
    # one page of 2 rows: 9 users cannot all land in 4 rounds
    session = _session(model_dir, re_pages=1, re_page_rows=2, warmup=False)
    try:
        wide = [int(np.flatnonzero(bundle["uid"] == u)[0]) for u in range(9)]
        assert _close(session.score_rows(serving_rows(bundle, wide)),
                      ref[wide])
        assert session.overflow_rows > 0
        assert session.metrics.compile_cache_hits == session._max_rounds - 1
    finally:
        session.close()


def test_lazy_capture_counts_one_miss_per_rung(case):
    session = _session(case["model_dir"], warmup=False)
    try:
        rows = case["rows"]
        assert session.compile_count == 0
        session.score_rows(rows[:3])  # rung 4
        assert session.compile_count == 1
        session.score_rows(rows[3:5])  # rung 2: a new shape
        assert session.compile_count == 2
        session.score_rows(rows[5:8])  # rung 4 again
        assert session.compile_count == 2
    finally:
        session.close()


def test_oversized_batch_raises_and_wide_rows_go_eager(case):
    """A batch above ``max_batch`` raises; rows with more features than
    ``pad_nnz`` leave the fused rung for the per-coordinate path and the
    fixed coordinate's eager margins, each counted, and still score as
    ``score_game_model``."""
    session = _session(case["model_dir"], max_batch=4, warmup=False)
    try:
        with pytest.raises(ValueError, match="max_batch"):
            session.score_rows(case["rows"][:5])
        assert session.score_rows([]).shape == (0,)
    finally:
        session.close()
    session = _session(case["model_dir"], pad_nnz=3, warmup=False)
    try:
        got = session.score_rows(case["rows"])
        assert session.fused_fallback_batches == 1
        assert session.fixed_eager_batches == 1
        assert session.compile_count == 0
        assert _close(got, case["batch"][0])
    finally:
        session.close()


@pytest.mark.parametrize("paged", [True, False])
def test_every_upload_goes_through_transfer_budget(case, paged):
    """The resident fixed vector at load and each batch's padded arrays
    are charged to ``utils.transfer_budget``."""
    charges = []
    transfer_budget.set_activity_hook(lambda: charges.append(1))
    try:
        session = _session(case["model_dir"], paged_table=paged,
                           warmup=False)
        try:
            after_init = len(charges)
            assert after_init >= 1
            session.score_rows(case["rows"][:3])
            assert len(charges) > after_init
        finally:
            session.close()
    finally:
        transfer_budget.set_activity_hook(None)


@pytest.mark.parametrize("level", [1, 2])
def test_degraded_levels_match_jax(case, level):
    """A brownout floor of 1 (resident coefficients only) or 2 (fixed
    effects only) on a cold session scores as the JAX session at the same
    level and reports the level served."""
    model_dir, rows = case["model_dir"], case["rows"]
    jax_session = JaxSession(model_dir, dtype="float64", max_batch=32,
                             warmup=False)
    session = _session(model_dir, warmup=False)
    try:
        jctx, ctx = JaxContext(level=level), ScoreContext(level=level)
        want = jax_session.score_rows(rows, ctx=jctx)
        got = session.score_rows(rows, ctx=ctx)
    finally:
        session.close()
        jax_session.close()
    assert _close(got, want) and ctx.degraded == jctx.degraded == level
    assert _close(got, case["batch"][1]["fixed"] + np.linspace(-0.5, 0.5, 24))


def test_close_joins_the_installer(case):
    session = _session(case["model_dir"], warmup=False)
    session._install_poll_s = 0.01
    session.close(timeout_s=5.0)
    assert not session._installer.is_alive()
    assert session.join_timeouts == 0
    session.close()  # idempotent
