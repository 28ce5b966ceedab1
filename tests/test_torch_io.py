"""Parity of the port's data input (``photon_ml_tpu_torch/io``) with
``photon_ml_tpu/io``: the Avro writer (byte-identical files), the native and
Python Avro readers against the JAX reader on a 500-row fixture with two
entity columns and the intercept, LIBSVM, index maps and hashing, the
native feature index store across the packages, and the validators' errors.
Every comparison is exact: these modules are host-side numpy and the
port's are copies."""

import numpy as np
import pytest

from photon_ml_tpu.game.data import HostSparse as JHostSparse
from photon_ml_tpu.io import data_reader as jreader
from photon_ml_tpu.io import hashing as jhashing
from photon_ml_tpu.io import index_map as jindex
from photon_ml_tpu.io import libsvm as jlibsvm
from photon_ml_tpu.io import paldb as jpaldb
from photon_ml_tpu.io import validators as jvalid
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.io import data_reader, hashing, index_map, libsvm
from photon_ml_tpu_torch.io import paldb, validators
from photon_ml_tpu_torch.io.avro import iter_avro_records, read_avro_file
from photon_ml_tpu_torch.io.schemas import feature_key, split_feature_key

N_ROWS = 500
ENTITY_COLUMNS = ("userId", "itemId")


def _rows(r, n):
    """Per-row (name, term, value) lists over a small vocabulary, some terms
    empty, some rows empty."""
    rows = []
    for _ in range(n):
        row = []
        for _ in range(int(r.integers(0, 7))):
            term = f"t{int(r.integers(0, 3))}" if r.random() < 0.5 else ""
            row.append((f"f{int(r.integers(0, 30))}", term,
                        float(r.normal())))
        rows.append(row)
    return rows


def _columns(r, n):
    return dict(
        labels=(r.random(n) < 0.4).astype(float),
        offsets=r.normal(size=n) * 0.1,
        weights=r.random(n) + 0.5,
        entity_ids={"userId": r.integers(0, 40, n),
                    "itemId": r.integers(0, 12, n)},
        uids=[f"u{i}" for i in range(n)],
    )


@pytest.fixture(scope="module")
def avro_fixture(tmp_path_factory):
    """The 500-row training file, written by the port's writer, and the
    index map both packages build from it."""
    r = np.random.default_rng(21)
    rows = _rows(r, N_ROWS)
    path = str(tmp_path_factory.mktemp("io") / "train.avro")
    data_reader.write_training_examples(path, rows, **_columns(r, N_ROWS))
    keys = sorted({feature_key(n, t) for row in rows
                   for n, t, _ in row})
    return path, keys


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_files_are_byte_identical_across_packages(tmp_path, codec):
    r = np.random.default_rng(3)
    rows = _rows(r, 300)
    cols = _columns(r, 300)
    for mod, name in ((data_reader, "port.avro"), (jreader, "jax.avro")):
        mod.write_training_examples(str(tmp_path / name), rows, codec=codec,
                                    block_size=64, **cols)
    port = (tmp_path / "port.avro").read_bytes()
    assert port == (tmp_path / "jax.avro").read_bytes()
    back, _ = read_avro_file(str(tmp_path / "port.avro"))
    assert len(back) == 300
    assert [f["name"] for f in back[7]["features"]] == [n for n, _, _ in rows[7]]


def _index_maps(kind, keys):
    if kind == "hash":
        return (hashing.HashingIndexMap(64, add_intercept=True),
                jhashing.HashingIndexMap(64, add_intercept=True))
    forward = {k: i for i, k in enumerate(keys)}
    return (index_map.IndexMap(dict(forward), add_intercept=True),
            jindex.IndexMap(dict(forward), add_intercept=True))


@pytest.mark.parametrize("imap_kind", ["index_map", "hash"])
@pytest.mark.parametrize("decoder", ["native", "python"])
def test_avro_readers_match_jax_reader(avro_fixture, monkeypatch, decoder,
                                       imap_kind):
    path, keys = avro_fixture
    port_map, jax_map = _index_maps(imap_kind, keys)
    want = jreader.read_training_examples(path, jax_map, ENTITY_COLUMNS)
    if decoder == "python":
        monkeypatch.setenv("PHOTON_ML_TPU_NO_NATIVE", "1")
    got, ran = data_reader.decode_training_examples(path, port_map,
                                                    ENTITY_COLUMNS)
    assert ran == decoder
    gf, wf = got[0]["global"], want[0]["global"]
    assert gf.dim == wf.dim == port_map.size
    np.testing.assert_array_equal(gf.indices, wf.indices)
    np.testing.assert_array_equal(gf.values, wf.values)
    assert (gf.indices == port_map.intercept_index).any(axis=1).all()
    for g, w in zip(got[1:4], want[1:4]):  # labels, offsets, weights
        np.testing.assert_array_equal(g, w)
    assert set(got[4]) == set(ENTITY_COLUMNS)
    for c in ENTITY_COLUMNS:
        np.testing.assert_array_equal(got[4][c], want[4][c])
    assert got[5] == want[5]


@pytest.mark.parametrize("add_intercept", [False, True])
def test_libsvm_matches(tmp_path, add_intercept):
    r = np.random.default_rng(8)
    path = tmp_path / "data.svm"
    with open(path, "w") as f:
        f.write("# a comment line\n")
        for i in range(60):
            cols = sorted(r.choice(25, size=int(r.integers(0, 6)),
                                   replace=False) + 1)
            toks = [str(int(2 * (r.random() < 0.5) - 1))]
            toks += [f"{c}:{r.normal():.6f}" for c in cols]
            f.write(" ".join(toks) + "\n")
    gsp, glab, gint = libsvm.read_libsvm(str(path),
                                         add_intercept=add_intercept)
    wsp, wlab, wint = jlibsvm.read_libsvm(str(path),
                                          add_intercept=add_intercept)
    assert isinstance(gsp, HostSparse)
    assert gsp.dim == wsp.dim and gint == wint
    np.testing.assert_array_equal(gsp.indices, wsp.indices)
    np.testing.assert_array_equal(gsp.values, wsp.values)
    np.testing.assert_array_equal(glab, wlab)
    assert set(np.unique(glab)) <= {0.0, 1.0}  # -1/+1 mapped to 0/1


def test_index_maps_and_hashing_match(avro_fixture):
    path, keys = avro_fixture
    from photon_ml_tpu.io.avro import iter_avro_records as jiter

    for min_count in (1, 3):
        got = index_map.build_index_map(iter_avro_records(path),
                                        min_count=min_count)
        want = jindex.build_index_map(jiter(path), min_count=min_count)
        assert got.forward == want.forward
        assert got.intercept_index == want.intercept_index
        assert got.digest() == want.digest()
        for prefixes in (["f1"], ["f2", "f0"], [""]):
            assert (index_map.filter_index_map(got, prefixes).forward
                    == jindex.filter_index_map(want, prefixes).forward)
    hkeys = keys + ["", "(INTERCEPT)", "é\x01ü", "(HASH 5)"]
    for k in hkeys:
        assert hashing.fnv1a_64(k.encode()) == jhashing.fnv1a_64(k.encode())
    ph = hashing.HashingIndexMap(1 << 10)
    jh = jhashing.HashingIndexMap(1 << 10)
    assert ph.inverse() == jh.inverse() and ph.digest() == jh.digest()
    for k in hkeys:
        name, term = split_feature_key(k)
        assert ph.index_of(name, term) == jh.index_of(name, term)
        assert ph.model_index_of(name, term) == jh.model_index_of(name, term)


@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_paldb_store_crosses_packages(tmp_path, built_by):
    forward = {f"feat{i}\x01t{i % 3}": i for i in range(200)}
    forward["(INTERCEPT)"] = 200
    path = str(tmp_path / "store.fis")
    build, load = ((paldb.build_store, jpaldb.load_index_map)
                   if built_by == "port"
                   else (jpaldb.build_store, paldb.load_index_map))
    build(forward, path)
    store = load(path)
    try:
        assert store.size == 201 and store.intercept_index == 200
        assert dict(store.items()) == forward
        keys = list(forward) + ["absent"]
        np.testing.assert_array_equal(
            store.lookup_batch(keys),
            [forward.get(k, -1) for k in keys])
    finally:
        store.close()


def _validator_case(case):
    """(features, labels, offsets, weights, task) for one validator case;
    features as (indices, values, dim)."""
    idx = np.array([[0, 1], [2, 0], [1, 2]], np.int32)
    vals = np.array([[1.0, 0.5], [2.0, 0.0], [-1.0, 3.0]])
    labels = np.array([0.0, 1.0, 1.0])
    offsets = np.zeros(3)
    weights = np.ones(3)
    task = "logistic"
    if case == "nonfinite_labels":
        labels = np.array([0.0, np.nan, np.inf])
    elif case == "nonbinary_labels":
        labels = np.array([0.0, 2.0, -1.0])
    elif case == "negative_poisson":
        labels, task = np.array([0.0, -2.0, 3.0]), "poisson"
    elif case == "nonfinite_values":
        vals = vals.copy()
        vals[1, 0] = np.nan
    elif case == "nonfinite_offsets":
        offsets = np.array([0.0, np.inf, 0.0])
    elif case == "bad_weights":
        weights = np.array([1.0, 0.0, -2.0])
    elif case == "all_at_once":
        labels = np.array([0.5, np.nan, 1.0])
        offsets = np.array([np.nan, 0.0, 0.0])
        weights = np.array([np.inf, -1.0, 1.0])
    return (idx, vals, 3), labels, offsets, weights, task


@pytest.mark.parametrize("case", [
    "valid", "nonfinite_labels", "nonbinary_labels", "negative_poisson",
    "nonfinite_values", "nonfinite_offsets", "bad_weights", "all_at_once"])
def test_validators_raise_the_same_errors(case):
    feats, labels, offsets, weights, task = _validator_case(case)
    outcomes = []
    for mod, hs in ((validators, HostSparse), (jvalid, JHostSparse)):
        try:
            mod.validate_training_data(hs(*feats), labels, offsets, weights,
                                       task=task)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "valid")
