"""The port's device tier of serving (``photon_ml_tpu_torch/serve/{paged_table,
coeff_cache,membership,metrics}.py`` and ``ops.kernels.paged_gather_score``)
against the JAX package's, on the CPU.

Inputs are numpy arrays made from seeds and handed to both packages.
Tolerances: the scores within 1e-12 absolute in float64 and 1e-5 in
float32 (the two sum a row's k products in their own orders); the tables'
slots, missing lists, counters and whole device buffers exactly equal (an
install writes the same coefficients into the same rows); the coefficient
stores' entries exactly equal (both decode the same Avro records); the
metrics' expositions byte for byte. The card's kernel is held against the
plain version in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.io.model_io import load_model_index_map as jax_imap
from photon_ml_tpu.obs.metrics import ServingMetrics as JaxMetrics
from photon_ml_tpu.ops.pallas_kernels import (
    paged_gather_score as jax_paged_gather_score,
)
from photon_ml_tpu.serve.coeff_cache import (
    CoeffEntry as JaxEntry, EntityCoefficientLRU as JaxLRU,
    LayeredCoefficientStore as JaxLayered,
    ModelDirCoefficientStore as JaxStore,
)
from photon_ml_tpu.serve.membership import (
    MembershipManager as JaxManager, MembershipView as JaxView,
)
from photon_ml_tpu.serve.paged_table import (
    PagedCoefficientTable as JaxTable,
)
from photon_ml_tpu_torch.io.model_io import load_model_index_map
from photon_ml_tpu_torch.ops.kernels import (
    paged_gather_score, paged_gather_score_ordered_plain,
    paged_gather_score_plain,
)
from photon_ml_tpu_torch.parallel import fault_injection
from photon_ml_tpu_torch.serve import (
    CoeffEntry, EntityCoefficientLRU, LayeredCoefficientStore,
    MembershipManager, MembershipView, ModelDirCoefficientStore,
    PagedCoefficientTable, ServingMetrics,
)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}
DIM = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tensors are tiny: torch's thread pool only adds waits
    (a walk here took 6-45 s at 8 threads, 0.6 s at 1). Restored after
    the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, slots_n, b, k, dtype):
    r = np.random.default_rng(seed)
    table = r.normal(size=(slots_n, DIM)).astype(NP[dtype])
    slots = r.integers(-1, slots_n, b).astype(np.int32)
    idx = r.integers(0, DIM, (b, k)).astype(np.int32)
    val = r.normal(size=(b, k)).astype(NP[dtype])
    return table, slots, idx, val


# the ordered twin at widths that are (8, 64) and are not (1, 9, 39, 65,
# 130) multiples of the kernel's lanes per row
_ORDERED = [(1, 1), (37, 9), (200, 39), (24, 8), (40, 64), (30, 65),
            (20, 130)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b,k,twin", [
    pytest.param(b, k, False, id=f"{b}-{k}")
    for b, k in ((1, 1), (37, 9), (200, 39))] + [
    pytest.param(b, k, True, id=f"ordered-{b}-{k}") for b, k in _ORDERED])
def test_paged_gather_score_plain_matches_jax(dtype, b, k, twin):
    """The plain version, and the kernel's ordered twin, against the JAX
    function within ``TOL``; the twin also within 4 eps * sum |terms| per
    row of the plain version (two orders of the same k terms)."""
    table, slots, idx, val = _batch(b * 7 + k, 16, b, k, dtype)
    want = np.asarray(jax_paged_gather_score(table, slots, idx, val))
    args = [torch.from_numpy(a) for a in (table, slots, idx, val)]
    fn = paged_gather_score_ordered_plain if twin else \
        paged_gather_score_plain
    got = fn(*args)
    assert got.dtype == dtype and got.shape == (b,)
    assert np.abs(got.numpy() - want).max() <= TOL[dtype]
    assert bool((got[args[1] < 0] == 0).all())
    if twin:
        plain = paged_gather_score_plain(*args)
        terms = paged_gather_score_plain(args[0].abs(), args[1], args[2],
                                         args[3].abs())
        gate = 4 * torch.finfo(dtype).eps * terms
        assert bool(((got - plain).abs() <= gate).all())
        return
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch
    launches = paged_gather_score.launches
    assert torch.equal(paged_gather_score(*args), got)
    assert paged_gather_score.launches == launches


def test_paged_gather_score_zero_by_selection_and_checks():
    table = np.full((4, DIM), np.nan)
    table[2] = 1.0
    slots = np.asarray([-1, 2, -1], np.int32)
    idx = np.zeros((3, 5), np.int32)
    val = np.ones((3, 5))
    got = paged_gather_score(*[torch.from_numpy(a)
                               for a in (table, slots, idx, val)])
    assert got.tolist() == [0.0, 5.0, 0.0]
    with pytest.raises(ValueError, match="slots"):
        paged_gather_score(torch.from_numpy(table),
                           torch.from_numpy(slots.astype(np.int64)),
                           torch.from_numpy(idx), torch.from_numpy(val))
    with pytest.raises(ValueError, match="values"):
        paged_gather_score(torch.from_numpy(table), torch.from_numpy(slots),
                           torch.from_numpy(idx),
                           torch.from_numpy(val.astype(np.float32)))


def _entities(seed, n, nnz=6):
    r = np.random.default_rng(seed)
    out = {}
    for e in range(n):
        gids = r.choice(DIM + 4, nnz, replace=False)  # a few beyond DIM
        out[f"u{e}"] = ({int(g): s for s, g in enumerate(gids)},
                        r.normal(size=nnz))
    return out


def _tables(dtype, pages=3, page_rows=8):
    jm, pm = JaxMetrics(), ServingMetrics()
    return ((JaxTable(DIM, pages=pages, page_rows=page_rows,
                      dtype=NP[dtype], name="u", metrics=jm), jm),
            (PagedCoefficientTable(DIM, pages=pages, page_rows=page_rows,
                                   dtype=dtype, name="u", metrics=pm,
                                   device="cpu"), pm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_paged_table_matches_jax_over_an_install_and_evict_stream(dtype):
    """The same lookups, installs (known and unknown ids) and evictions fed
    to both tables: the same slots and missing lists, counters, whole
    device buffers and scores; then a membership compaction. Entities
    arrive one at a time, each install followed by a lookup of its id
    (the two tables choose other victims when one install writes a page
    and then evicts: see the next test)."""
    ents = _entities(1, 60)
    (jt, jm), (pt, pm) = _tables(dtype)
    r = np.random.default_rng(2)
    for _ in range(20):
        ids = [f"u{int(x)}" for x in r.integers(0, 66, 5)]
        for eid in ids:
            _, js, jmiss = jt.lookup([eid])
            _, ps, pmiss = pt.lookup([eid])
            assert np.array_equal(js, ps) and jmiss == pmiss
            assert jt.install({e: JaxEntry(*ents[e]) if e in ents else None
                               for e in jmiss}) == \
                pt.install({e: CoeffEntry(*ents[e]) if e in ents else None
                            for e in pmiss})
            assert np.array_equal(jt.lookup([eid])[1], pt.lookup([eid])[1])
        jb, js, _ = jt.lookup(ids)
        pb, ps, _ = pt.lookup(ids)
        assert np.array_equal(js, ps)
        assert np.array_equal(np.asarray(jb), pb.numpy())
        idx = r.integers(0, DIM, (len(ids), 7)).astype(np.int32)
        val = r.normal(size=(len(ids), 7)).astype(NP[dtype])
        want = np.asarray(jax_paged_gather_score(jb, js, idx, val))
        got = paged_gather_score(pb, torch.from_numpy(ps),
                                 torch.from_numpy(idx), torch.from_numpy(val))
        assert np.abs(got.numpy() - want).max() <= TOL[dtype]
    assert jt.stats() == pt.stats()
    assert jt.stats()["page_evictions"] > 0 and jt.stats()["absent"] > 0
    assert (jt.installs, jt.page_evictions, jt.absent_marks) == \
        (pt.installs, pt.page_evictions, pt.absent_marks)
    assert sorted(jt.resident_ids()) == sorted(pt.resident_ids())
    keep = lambda e: int(e[1:]) % 3 != 0  # noqa: E731
    assert jt.retain_only(keep) == pt.retain_only(keep) > 0
    assert np.array_equal(np.asarray(jt.device_buffer),
                          pt.device_buffer.numpy())
    assert jt.stats() == pt.stats()
    assert jm.snapshot() == pm.snapshot()
    assert jm.render() == pm.render()
    assert np.array_equal(jt.dense_row(JaxEntry(*ents["u0"])),
                          pt.dense_row(CoeffEntry(*ents["u0"])))


def test_an_install_larger_than_a_page_stays_resident():
    """Into a full table, one install of more new entities than a page
    holds: the port counts the pages it writes as used and keeps every
    entity; the JAX table counts lookups only, so it evicts the page it
    has just filled again and keeps the last page's entities alone
    (ROADMAP Queue 3)."""
    ents = _entities(5, 24)
    (jt, _), (pt, _) = _tables(torch.float64, pages=2, page_rows=4)
    old = {f"u{e}": ents[f"u{e}"] for e in range(8)}
    jt.install({e: JaxEntry(*v) for e, v in old.items()})
    pt.install({e: CoeffEntry(*v) for e, v in old.items()})
    new = [f"u{e}" for e in range(8, 16)]  # two pages' worth
    jt.install({e: JaxEntry(*ents[e]) for e in new})
    pt.install({e: CoeffEntry(*ents[e]) for e in new})
    assert (pt.lookup(new)[1] >= 0).all()
    assert (jt.lookup(new)[1] >= 0).sum() == 4


def test_snapshot_scores_bit_equal_after_an_evicting_install():
    """A batch's (buffer, slots) taken before an install keeps scoring
    its rows bit for bit: a non-evicting install writes fresh rows in
    place, an evicting one copies the buffer first."""
    ents = _entities(3, 30)
    pt = PagedCoefficientTable(DIM, pages=2, page_rows=4,
                               dtype=torch.float64, device="cpu")
    first = [f"u{e}" for e in range(6)]
    pt.install({e: CoeffEntry(*ents[e]) for e in first})
    buf, slots, missing = pt.lookup(first)
    assert missing == [] and (slots >= 0).all()
    r = np.random.default_rng(4)
    idx = torch.from_numpy(r.integers(0, DIM, (6, 9)).astype(np.int32))
    val = torch.from_numpy(r.normal(size=(6, 9)))
    slots_t = torch.from_numpy(slots)
    before = paged_gather_score(buf, slots_t, idx, val)
    pt.install({e: CoeffEntry(*ents[e]) for e in ("u6", "u7")})  # fills
    assert pt.device_buffer is buf and pt.snapshot_copies == 0
    assert torch.equal(paged_gather_score(buf, slots_t, idx, val), before)
    pt.install({e: CoeffEntry(*ents[e]) for e in ("u8", "u9")})  # evicts
    assert pt.page_evictions == 1 and pt.snapshot_copies == 1
    assert pt.device_buffer is not buf
    assert torch.equal(paged_gather_score(buf, slots_t, idx, val), before)
    # the live table no longer holds the evicted page's entities
    _, now, _ = pt.lookup(first)
    assert (now < 0).sum() == 4


def test_paged_install_fault_site_and_sketch_refusal():
    pt = PagedCoefficientTable(DIM, pages=1, page_rows=2, device="cpu")
    fault_injection.install([{"site": "paged.install", "kind": "raise"}])
    try:
        with pytest.raises(Exception, match="paged.install"):
            pt.install({"a": CoeffEntry({0: 0}, np.ones(1))})
    finally:
        fault_injection.clear()
    with pytest.raises(ValueError, match="sketch"):
        pt.install({"a": CoeffEntry(object(), np.ones(1))})
    assert pt.stats()["installs"] == 0
    pt.warm_device_path()  # the plain version on the CPU; no state change
    assert pt.stats()["resident"] == 0


def _same_entry(a, b):
    assert a.local_map == b.local_map or (
        type(a.local_map).__name__ == type(b.local_map).__name__
        == "SketchProjection")
    assert np.array_equal(a.coefficients, b.coefficients)


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """One random-effect coordinate and one sketched one, saved by the
    port (the layout both packages read)."""
    from photon_ml_tpu_torch import models as m
    from photon_ml_tpu_torch.game.data import SketchProjection
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.model_io import save_game_model

    r = np.random.default_rng(6)
    plain = [m.RandomEffectBucket(
        [f"u{e}" for e in range(e0, e0 + n)], r.normal(size=(n, w)),
        np.stack([np.sort(r.choice(DIM, w, replace=False))
                  for _ in range(n)]).astype(np.int32), None)
        for e0, n, w in ((0, 12, 3), (12, 8, 5))]
    sketch = SketchProjection(8, seed=3)
    sketched = [m.RandomEffectBucket(
        [f"s{e}" for e in range(6)], r.normal(size=(6, 8)),
        np.full((6, 8), -1, np.int32), None, sketch=sketch)]
    model = m.GameModel({
        "per_user": m.RandomEffectModel("per_user", plain, "logistic",
                                        entity_column="userId"),
        "per_s": m.RandomEffectModel("per_s", sketched, "logistic",
                                     entity_column="sId")},
        task="logistic")
    out = str(tmp_path_factory.mktemp("serve") / "model")
    save_game_model(model, out, IndexMap({f"f{i}": i for i in range(DIM)}))
    return out


def test_coefficient_stores_and_lru_match_jax(saved_models):
    """Both packages' stores over one saved model give equal entries,
    known ids and absences (a sketched coordinate too); the LRUs over them
    keep the same residents and counters for the same access stream; a
    delta chain resolves from the first layer that knows an id."""
    model_dir = saved_models
    shard = "global"
    jstore = JaxStore(model_dir, "per_user", jax_imap(model_dir, shard))
    pstore = ModelDirCoefficientStore(
        model_dir, "per_user", load_model_index_map(model_dir, shard))
    assert jstore.known_ids() == pstore.known_ids() != frozenset()
    ids = sorted(pstore.known_ids()) + ["absent-1"]
    jmany, pmany = jstore.load_many(ids), pstore.load_many(ids)
    assert jmany.keys() == pmany.keys() and pmany["absent-1"] is None
    for eid in ids[:-1]:
        _same_entry(jmany[eid], pmany[eid])
        _same_entry(jstore.load(eid), pstore.load(eid))
    meta = {"type": "random", "dim": 8, "seed": 3}
    js = JaxStore(model_dir, "per_s", None, projection_meta=meta)
    ps = ModelDirCoefficientStore(model_dir, "per_s", None,
                                  projection_meta=meta)
    _same_entry(js.load("s2"), ps.load("s2"))
    jm, pm = JaxMetrics(), ServingMetrics()
    jl = JaxLRU(jstore.load, 3, metrics=jm, batch_loader=jstore.load_many)
    pl = EntityCoefficientLRU(pstore.load, 3, metrics=pm,
                              batch_loader=pstore.load_many)
    r = np.random.default_rng(5)
    for _ in range(8):
        batch = [ids[int(i)] for i in r.integers(0, len(ids), 3)]
        assert jl.get_many(batch).keys() == pl.get_many(batch).keys()
        assert (jl.get(batch[0]) is None) == (pl.get(batch[0]) is None)
    assert jl.warm_entries(ids[:2]).keys() == pl.warm_entries(ids[:2]).keys()
    assert jl.prefetch(ids[5:7]) == pl.prefetch(ids[5:7])
    assert list(jl.cached_ids()) == list(pl.cached_ids())
    assert jl.resident_many(ids).keys() == pl.resident_many(ids).keys()
    assert (jl.hits, jl.misses, jl.evictions, jl.hit_rate) == \
        (pl.hits, pl.misses, pl.evictions, pl.hit_rate)
    assert jm.snapshot() == pm.snapshot()
    layered = LayeredCoefficientStore([ps, pstore])
    jlayered = JaxLayered([js, jstore])
    assert layered.known_ids() == jlayered.known_ids()
    assert layered.load_many(ids).keys() == jlayered.load_many(ids).keys()
    _same_entry(layered.load(ids[0]), jlayered.load(ids[0]))
    assert layered.load("absent-1") is None


def test_first_load_many_learns_known_ids_in_its_pass(saved_models):
    """A fresh store's first ``load_many`` (which builds the known ids in
    the pass that parses its records) gives the JAX store's entries and
    absences, and leaves the JAX store's known ids behind."""
    model_dir = saved_models
    jstore = JaxStore(model_dir, "per_user", jax_imap(model_dir, "global"))
    pstore = ModelDirCoefficientStore(
        model_dir, "per_user", load_model_index_map(model_dir, "global"))
    ids = ["absent-1"] + sorted(jstore.known_ids())[::2] + ["absent-2"]
    jmany, pmany = jstore.load_many(ids), pstore.load_many(ids)
    assert set(jmany) == set(pmany) == set(ids)
    assert pmany["absent-1"] is None and pmany["absent-2"] is None
    for eid in ids[1:-1]:
        _same_entry(jmany[eid], pmany[eid])
    assert pstore.known_ids() == jstore.known_ids()


def test_membership_epochs_match_jax():
    ids = [str(i) for i in range(200)] + [f"user-{i}" for i in range(50)]
    for id_kind in ("auto", "str"):
        jm = JaxManager(["b:2", "a:1"], id_kind=id_kind, hot_track=64)
        pm = MembershipManager(["b:2", "a:1"], id_kind=id_kind,
                               hot_track=64)
        for eid in ids:
            jm.note_routed(eid)
            pm.note_routed(eid)
        assert jm.hot_ids() == pm.hot_ids()
        assert pm.propose(["a:1", "b:2"]) is None
        new_j, new_p = jm.propose(["a:1", "b:2", "c:3"]), \
            pm.propose(["a:1", "b:2", "c:3"])
        assert (new_j.epoch, new_j.replicas) == (new_p.epoch, new_p.replicas)
        assert jm.moved_ids(new_j) == pm.moved_ids(new_p)
        assert np.array_equal(new_j.owner_of(ids), new_p.owner_of(ids))
        assert new_j.payload(1, ["7"]) == new_p.payload(1, ["7"])
        assert jm.commit(new_j) and pm.commit(new_p)
        assert not pm.commit(new_p)
        jv, pv = JaxView(), MembershipView()
        assert pv.owned_many(ids) == [True] * len(ids)
        assert jv.apply(3, 3, 1, id_kind) and pv.apply(3, 3, 1, id_kind)
        assert not pv.apply(2, 3, 0, id_kind)
        assert jv.owned_many(ids) == pv.owned_many(ids)
        assert jv.describe() == pv.describe() and pv.active
