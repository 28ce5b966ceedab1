"""Parity of the port's out-of-core inputs with the JAX package's: the
Avro chunk source (``io/stream_source.py``, native and Python decode), the
decode-once chunk cache (``io/chunk_cache.py``), the chunked scoring reader
(``io/data_reader.read_training_examples_chunked``) and the transfer budget
(``utils/transfer_budget.py``).

Data: 300 rows of 1-6 named features with values (vocabulary 40, plus the
intercept), labels, weights and offsets, written by the port's writer in
blocks of 16 records. Tolerances: chunks, windows and cache files equal
byte for byte; fits over the source, the in-RAM chunks, the cold and the
warm cache equal bit for bit (float64 on the CPU). No test waits without a
bound: a dead producer or a corrupt file fails within the consumer's poll
interval."""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.io import chunk_cache as j_cache
from photon_ml_tpu.io import stream_source as j_src
from photon_ml_tpu.io.data_reader import (
    read_training_examples_chunked as j_read_chunked,
)
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.ops.statistics import (
    summarize_features_streamed as j_summarize_streamed,
)
from photon_ml_tpu_torch.game.data import HostSparse
from photon_ml_tpu_torch.io.chunk_cache import (
    ChunkCacheSource, source_fingerprint,
)
from photon_ml_tpu_torch.io.data_reader import (
    read_training_examples, read_training_examples_chunked,
    write_training_examples,
)
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.stream_source import (
    AvroChunkSource, ScalarOverlaySource, scan_blocks,
)
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.statistics import summarize_features_streamed
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.streaming import (
    fit_streaming, make_host_chunks,
)
from photon_ml_tpu_torch.utils import transfer_budget

FIELDS = ("indices", "values", "labels", "offsets", "weights")
VOCAB = 40


def _write(path, rng, n=300, max_k=6, block_size=16):
    rows = []
    for _ in range(n):
        k = int(rng.integers(1, max_k + 1))
        cols = rng.choice(VOCAB, size=k, replace=False)
        rows.append([(f"f{c}", "", float(rng.normal())) for c in cols])
    write_training_examples(str(path), rows, rng.integers(0, 2, n) * 1.0,
                            offsets=rng.normal(0, 0.1, n),
                            weights=rng.uniform(0.5, 2.0, n),
                            block_size=block_size)
    return str(path)


def _maps():
    entries = {f"f{c}": c for c in range(VOCAB)}
    return (IndexMap(entries, add_intercept=True),
            JIndexMap(entries, add_intercept=True))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_source")
    path = _write(root / "train.avro", np.random.default_rng(7))
    return root, path


def _equal_chunks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                assert u.dtype == v.dtype and u.shape == v.shape, f
                assert np.asarray(u).tobytes() == np.asarray(v).tobytes(), f


@pytest.mark.parametrize("native", [True, False])
def test_source_chunks_equal_reference(dataset, native, monkeypatch):
    if not native:
        monkeypatch.setenv("PHOTON_ML_TPU_NO_NATIVE", "1")
    _, path = dataset
    tmap, jmap = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=64)
    ref = j_src.AvroChunkSource(path, jmap, chunk_rows=64)
    assert src.decoder == ("native" if native else "python")
    assert (len(src), src.rows, src.pad_nnz, src.dim) == (
        len(ref), ref.rows, ref.pad_nnz, ref.dim)
    _equal_chunks(list(src), list(ref))
    assert src.passes == 1


def test_native_and_python_chunks_identical(dataset, monkeypatch):
    _, path = dataset
    tmap, _ = _maps()
    native = list(AvroChunkSource(path, tmap, chunk_rows=48,
                                  dtype=np.float64))
    monkeypatch.setenv("PHOTON_ML_TPU_NO_NATIVE", "1")
    python = list(AvroChunkSource(path, tmap, chunk_rows=48,
                                  dtype=np.float64))
    _equal_chunks(native, python)


def test_source_is_reiterable_and_matches_in_ram_chunks(dataset):
    _, path = dataset
    tmap, _ = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=64, dtype=np.float64)
    first, second = list(src), list(src)
    _equal_chunks(first, second)
    assert src.passes == 2
    feats, labels, offsets, weights, _, _ = read_training_examples(
        path, {"global": tmap})
    hs = feats["global"]
    ram, dim = make_host_chunks(HostSparse(hs.indices, hs.values, hs.dim),
                                labels, offsets, weights, chunk_rows=64,
                                pad_nnz=src.pad_nnz)
    _equal_chunks(first, ram)
    # the fit over the disk-backed source equals the in-RAM fit bit for bit
    cfg = OptimizerConfig(max_iters=4, tolerance=0.0)
    fits = [fit_streaming(make_objective("logistic",
                                         intercept_index=tmap.intercept_index),
                          chunks, dim, l2=1.0, config=cfg,
                          dtype=torch.float64, device="cpu")
            for chunks in (src, ram)]
    assert torch.equal(fits[0].w, fits[1].w)


def test_scan_blocks_and_summary_match_reference(dataset):
    _, path = dataset
    blocks, schema = scan_blocks(path)
    jblocks, jschema = j_src.scan_blocks(path)
    assert [tuple(vars(b).values()) for b in blocks] == \
        [tuple(vars(b).values()) for b in jblocks]
    assert schema == jschema and sum(b.count for b in blocks) == 300
    tmap, jmap = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=64, dtype=np.float64)
    ref = j_src.AvroChunkSource(path, jmap, chunk_rows=64, dtype=np.float64)
    got = summarize_features_streamed(src, src.dim, src.rows)
    want = j_summarize_streamed(ref, ref.dim, ref.rows)
    for f in ("mean", "variance", "min", "max", "num_nonzeros"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=1e-15)


def test_chunked_reader_windows_equal_reference(dataset, monkeypatch):
    _, path = dataset
    tmap, jmap = _maps()
    for native in (True, False):
        if not native:
            monkeypatch.setenv("PHOTON_ML_TPU_NO_NATIVE", "1")
        got = list(read_training_examples_chunked(path, tmap,
                                                  chunk_rows=100))
        want = list(j_read_chunked(path, jmap, chunk_rows=100))
        assert len(got) == len(want) == 3  # 7 blocks of 16 >= 100
        for g, w in zip(got, want):
            gf, wf = g[0]["global"], w[0]["global"]
            assert gf.indices.tobytes() == wf.indices.tobytes()
            assert np.asarray(gf.values).tobytes() == \
                np.asarray(wf.values).tobytes()
            for a, b in zip(g[1:4], w[1:4]):
                np.testing.assert_array_equal(a, b)
            assert list(g[5]) == list(w[5])


def test_producer_is_bounded_by_prefetch(dataset):
    _, path = dataset
    tmap, _ = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=16, prefetch=2)
    it = iter(src)
    next(it)
    time.sleep(0.3)
    # 1 consumed + queue capacity (2) + 1 in-flight put
    assert src.chunks_produced <= 4
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "avro-chunk-producer" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "avro-chunk-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_contract_errors(tmp_path, dataset):
    _, path = dataset
    tmap, _ = _maps()
    with pytest.raises(ValueError, match="pad_nnz"):
        list(AvroChunkSource(path, tmap, chunk_rows=32, pad_nnz=2))
    with pytest.raises(ValueError, match="implicit_ones"):
        list(AvroChunkSource(path, tmap, chunk_rows=60, implicit_ones=True))
    ones = str(tmp_path / "ones.avro")
    rng = np.random.default_rng(1)
    write_training_examples(
        ones, [[(f"f{c}", "", 1.0) for c in rng.choice(VOCAB, 3, False)]
               for _ in range(96)], rng.integers(0, 2, 96) * 1.0)
    chunks = list(AvroChunkSource(ones, tmap, chunk_rows=48,
                                  implicit_ones=True))
    assert len(chunks) == 2 and all(c.values is None for c in chunks)
    nolabel = str(tmp_path / "nolabel.avro")
    write_training_examples(nolabel, [[("f0", "", 1.0)], [("f1", "", 2.0)]],
                            labels=None)
    with pytest.raises(ValueError, match="label"):
        list(AvroChunkSource(nolabel, tmap, chunk_rows=2, pad_nnz=2))


def test_corrupt_file_fails_cleanly_not_hangs(tmp_path, dataset):
    _, path = dataset
    tmap, _ = _maps()
    raw = open(path, "rb").read()
    trunc = tmp_path / "trunc.avro"
    trunc.write_bytes(raw[: len(raw) - 37])
    with pytest.raises(ValueError):
        AvroChunkSource(str(trunc), tmap, chunk_rows=32, pad_nnz=8)
    blocks, _ = scan_blocks(path)
    corrupt = bytearray(raw)
    corrupt[blocks[1].payload_offset + blocks[1].payload_size // 2] ^= 0xFF
    bad = tmp_path / "bad.avro"
    bad.write_bytes(bytes(corrupt))
    src = AvroChunkSource(str(bad), tmap, chunk_rows=32, pad_nnz=8)
    with pytest.raises(Exception):
        list(src)


def test_producer_death_without_sentinel_fails_stop(dataset, monkeypatch):
    _, path = dataset
    tmap, _ = _maps()
    monkeypatch.setattr(AvroChunkSource, "_consumer_poll_s", 0.05)
    monkeypatch.setattr(AvroChunkSource, "_put_or_stop",
                        staticmethod(lambda q, stop, item: True))
    with pytest.raises(RuntimeError, match="without delivering"):
        list(AvroChunkSource(path, tmap, chunk_rows=64, pad_nnz=8))


def test_scalar_overlay_replaces_scalars(dataset):
    _, path = dataset
    tmap, _ = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=128)
    offs = np.arange(300, dtype=np.float64)
    chunks = list(ScalarOverlaySource(src, offsets=offs))
    assert len(chunks) == 3
    np.testing.assert_array_equal(chunks[1].offsets, offs[128:256])
    assert np.all(chunks[2].offsets[300 - 256:] == 0)
    np.testing.assert_array_equal(chunks[0].labels, next(iter(src)).labels)


def test_cache_files_and_warm_chunks_equal_reference(tmp_path, dataset):
    """Cold pass, warm pass and the packed files, against the JAX package's
    cache over the same source."""
    _, path = dataset
    tmap, jmap = _maps()
    src = AvroChunkSource(path, tmap, chunk_rows=64)
    cache = ChunkCacheSource(src, str(tmp_path / "t"))
    ref = j_cache.ChunkCacheSource(
        j_src.AvroChunkSource(path, jmap, chunk_rows=64), str(tmp_path / "j"))
    cold, warm = list(cache), list(cache)
    _equal_chunks(cold, list(src))
    _equal_chunks(warm, cold)
    assert (cache.cold_passes, cache.warm_passes) == (1, 1)
    list(ref)
    for name in FIELDS[:1] + FIELDS[2:] + ("values",):
        a = open(os.path.join(cache.cache_path, name + ".bin"), "rb").read()
        b = open(os.path.join(ref.cache_path, name + ".bin"), "rb").read()
        assert a == b, name
    assert source_fingerprint(src)["files"] == \
        j_cache.source_fingerprint(ref._src)["files"]


def test_cached_fit_equals_uncached_and_survives_reconstruction(tmp_path,
                                                                dataset):
    _, path = dataset
    tmap, _ = _maps()
    obj = make_objective("logistic", intercept_index=tmap.intercept_index)
    cfg = OptimizerConfig(max_iters=4, tolerance=0.0)

    def fit(chunks):
        return fit_streaming(obj, chunks, tmap.size, l2=1.0, config=cfg,
                             dtype=torch.float64, device="cpu").w

    src = AvroChunkSource(path, tmap, chunk_rows=64, dtype=np.float64)
    cache = ChunkCacheSource(src, str(tmp_path))
    w_cached = fit(cache)
    assert cache.cold_passes == 1 and cache.warm_passes > 1
    again = ChunkCacheSource(
        AvroChunkSource(path, tmap, chunk_rows=64, dtype=np.float64),
        str(tmp_path))
    w_again = fit(again)
    assert again.cold_passes == 0 and again.warm_passes > 1
    w_plain = fit(src)
    assert torch.equal(w_cached, w_plain) and torch.equal(w_again, w_plain)
    # the overlay sees the per-pass scalars over the warm cache
    offs = np.full(300, 0.5)
    over = list(ScalarOverlaySource(again, offsets=offs))
    assert np.all(over[0].offsets == np.float64(0.5))


def test_stale_budget_and_corrupt_caches(tmp_path, dataset):
    root, _ = dataset
    tmap, _ = _maps()
    path = _write(tmp_path / "own.avro", np.random.default_rng(3), n=100)

    def cache(**kw):
        return ChunkCacheSource(AvroChunkSource(path, tmap, chunk_rows=32),
                                str(tmp_path / "c"), **kw)

    first = cache()
    list(first)
    old = first.cache_path
    # a touched source file changes the fingerprint: the stale cache is
    # swept and the data decoded again
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
    fresh = cache()
    assert fresh.cache_path != old and not os.path.exists(old)
    list(fresh)
    assert fresh.cold_passes == 1
    # a corrupt committed cache is removed and decoded again
    with open(os.path.join(fresh.cache_path, "labels.bin"), "r+b") as f:
        f.truncate(5)
    again = cache()
    list(again)
    assert again.cold_passes == 1 and again.warm_passes == 0
    # over the disk budget: every pass falls through to the source
    small = ChunkCacheSource(AvroChunkSource(path, tmap, chunk_rows=32),
                             str(tmp_path / "small"), max_bytes=10)
    list(small)
    list(small)
    assert not small.enabled and small.fallthrough_passes == 1
    assert not any(n.startswith("chunks-")
                   for n in os.listdir(tmp_path / "small"))
    with pytest.raises(ValueError, match="fingerprint"):
        ChunkCacheSource([object()], str(tmp_path / "x"))


def test_transfer_budget(monkeypatch):
    monkeypatch.delenv("PHOTON_TRANSFER_BUDGET_MB", raising=False)
    try:
        transfer_budget.set_budget(None)
        transfer_budget.charge(10 ** 12)  # no budget: no-op
        transfer_budget.set_budget(1.0, single_mb=0.5, label="test")
        with pytest.raises(transfer_budget.TransferBudgetExceeded,
                           match="per-transfer cap"):
            transfer_budget.charge(600_000, "big")
        t = transfer_budget.device_put(np.zeros(50_000), "cpu",
                                       dtype=torch.float32)
        assert t.dtype == torch.float32 and t.shape == (50_000,)
        assert transfer_budget.get_budget().spent == 200_000
        assert transfer_budget.device_put(t, "cpu") is t  # nothing moves
        with pytest.raises(transfer_budget.TransferBudgetExceeded,
                           match="over the"):
            for _ in range(5):
                transfer_budget.charge(200_000)
        transfer_budget.waive(1.0, reason="test moves more")
        transfer_budget.charge(400_000)
        hits = []
        transfer_budget.set_activity_hook(lambda: hits.append(1))
        transfer_budget.charge(0)
        assert hits == [1]
    finally:
        transfer_budget.set_activity_hook(None)
        transfer_budget.set_budget(None)
