"""The port's coordinated failure handling (``photon_ml_tpu_torch/parallel/
{fault_injection,resilience,recovery}.py``, ``utils/config.is_device_loss``
and the simulated-process harness of ``photon_ml_tpu_torch/testing.py``),
mirroring ``tests/test_resilience.py`` and the unit half of
``tests/test_recovery.py``.

Parity: the same fault plan, installed in both packages' simulated
harnesses, gives the same outcome vector (which simulated processes
return, which raise ``PeerFailure`` or ``WatchdogTimeout``, the same
``failed`` codes and device-loss flags). The rest holds the port to the
reference's own contract: guards and barriers, ``Backoff`` and
``retry_transient`` schedules (exact), failure classification, the
``ResumeManager`` lifecycle, the streamed-pass guards and the I/O fault
sites. ``is_device_loss`` is held on constructed sticky and non-sticky
``torch.AcceleratorError``s, and the kernel wrapper's launch errors
(a stubbed return code of 700, an illegal address, against 1, an invalid
value) are classified the same way."""

import contextlib
import os
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu.parallel import fault_injection as jfi
from photon_ml_tpu.testing import Dropped as JDropped
from photon_ml_tpu.testing import run_simulated_processes as jax_run
from photon_ml_tpu_torch.parallel import fault_injection as fi
from photon_ml_tpu_torch.parallel import resilience
from photon_ml_tpu_torch.parallel.recovery import (
    FATAL, RANK_LOSS, ROLLBACK, classify_failure, recovery_supported,
)
from photon_ml_tpu_torch.parallel.resilience import (
    CODE_DATA, CODE_DEVICE_LOSS, CODE_ERROR, Backoff, CollectiveGuard,
    PeerFailure, ResumeManager, ResumeMismatch, WatchdogTimeout,
    retry_transient,
)
from photon_ml_tpu_torch.testing import Dropped, run_simulated_processes
from photon_ml_tpu_torch.utils import is_device_loss


@pytest.fixture(autouse=True)
def _clear_faults():
    fi.clear()
    jfi.clear()
    yield
    fi.clear()
    jfi.clear()


# -- single-process passthrough --------------------------------------------
def test_single_process_guard_is_passthrough():
    with CollectiveGuard("noop"):
        pass
    with pytest.raises(KeyError):  # the local exception type is kept
        with CollectiveGuard("noop"):
            raise KeyError("local")
    resilience.health_barrier("noop")  # no collective
    err = ValueError("boom")
    with pytest.raises(ValueError) as ei:
        resilience.health_barrier("t", failure=err)
    assert ei.value is err


# -- the same fault plan in both harnesses ---------------------------------
def _phased(check, guard, n_phases=3, site="work.step"):
    def work(rank):
        for phase in range(n_phases):
            with guard(f"phase{phase}", timeout=10):
                check(site)
        return "ok"

    return work


def _data_error(guard):
    def work(rank):
        with guard("p", timeout=10):
            if rank == 1:
                raise ValueError("bad input block")
        return "ok"

    return work


def _summary(outcomes, dropped, watchdog, peer_failure):
    """The outcome vector in package-neutral terms."""
    out = []
    for o in outcomes:
        if isinstance(o, dropped):
            out.append(("dropped",))
        elif isinstance(o, watchdog):
            out.append(("watchdog", sorted(o.failed)))
        elif isinstance(o, peer_failure):
            out.append(("peer_failure", dict(o.failed), o.device_loss,
                        type(o.__cause__).__name__
                        if o.__cause__ is not None else None))
        elif isinstance(o, BaseException):
            out.append(("raised", type(o).__name__))
        else:
            out.append(("returned", o))
    return out


PLANS = {
    "healthy": (4, [], "phased"),
    "raise": (4, [dict(site="work.step", process=2, at=1)], "phased"),
    "drop": (3, [dict(site="work.step", process=1, at=1, kind="drop")],
             "phased"),
    "device_loss": (3, [dict(site="work.step", process=0, at=0,
                             kind="device_loss")], "phased"),
    "data_error": (2, [], "data"),
}


def _run_plan(name, pkg):
    n, plan, body = PLANS[name]
    if pkg == "jax":
        from photon_ml_tpu.parallel import resilience as jres

        jfi.install([jfi.Fault(**f) for f in plan])
        work = (_phased(jfi.check, jres.CollectiveGuard) if body == "phased"
                else _data_error(jres.CollectiveGuard))
        out = jax_run(n, work, join_timeout=30)
        jfi.clear()
        return _summary(out, JDropped, jres.WatchdogTimeout,
                        jres.PeerFailure), out
    fi.install([fi.Fault(**f) for f in plan])
    work = (_phased(fi.check, CollectiveGuard) if body == "phased"
            else _data_error(CollectiveGuard))
    t0 = time.monotonic()
    out = run_simulated_processes(n, work, join_timeout=30)
    assert time.monotonic() - t0 < 30  # nobody waited out the join
    fi.clear()
    return _summary(out, Dropped, WatchdogTimeout, PeerFailure), out


@pytest.mark.parametrize("plan", list(PLANS))
def test_fault_plan_outcomes_match_the_jax_harness(plan):
    want, _ = _run_plan(plan, "jax")
    got, out = _run_plan(plan, "port")
    # the injected device loss is a different exception in each package
    # (a JaxRuntimeError there, a torch.AcceleratorError here); the cause
    # is compared through is_device_loss below
    if plan == "device_loss":
        want = [w[:3] for w in want]
        got = [g[:3] for g in got]
        assert all(is_device_loss(o) for o in out)
        assert isinstance(out[0].__cause__, torch.AcceleratorError)
    assert got == want
    if plan == "raise":
        assert isinstance(out[2].__cause__, fi.InjectedFault)
        assert out[0].failed == {2: CODE_ERROR} and not out[0].device_loss
    if plan == "drop":
        assert isinstance(out[1], Dropped)
        assert all(isinstance(out[r], WatchdogTimeout) for r in (0, 2))
    if plan == "data_error":
        assert out[0].failed == {1: CODE_DATA}
    if plan == "healthy":
        assert out == ["ok"] * 4


# -- is_device_loss ---------------------------------------------------------
def _accel(text):
    return torch.AcceleratorError(f"CUDA error: {text}\nCUDA kernel errors "
                                  "might be asynchronously reported")


def test_is_device_loss_on_sticky_and_non_sticky_cuda_errors():
    for sticky in ("an illegal memory access was encountered",
                   "device-side assert triggered",
                   "unspecified launch failure",
                   "uncorrectable ECC error encountered"):
        assert is_device_loss(_accel(sticky)), sticky
    # an invalid argument leaves the context usable; so does OOM
    assert not is_device_loss(_accel("invalid argument"))
    assert not is_device_loss(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not is_device_loss(ValueError("an illegal memory access"))
    # a coordinated abort counts when any process lost its device, or when
    # its cause is a device loss
    assert is_device_loss(PeerFailure("x", failed={1: CODE_DEVICE_LOSS}))
    assert not is_device_loss(PeerFailure("x", failed={1: CODE_ERROR}))
    wrapped = PeerFailure("x", failed={0: CODE_ERROR})
    wrapped.__cause__ = _accel("misaligned address")
    assert is_device_loss(wrapped)


def test_injected_device_loss_has_the_real_errors_type_and_form():
    fi.install([fi.Fault(site="s", kind="device_loss")])
    with pytest.raises(torch.AcceleratorError) as ei:
        fi.check("s")
    assert str(ei.value).startswith(
        "CUDA error: an illegal memory access was encountered")
    assert is_device_loss(ei.value)
    assert resilience.code_for(ei.value) == CODE_DEVICE_LOSS


def test_async_check_awaits_delays_and_fires_like_check():
    import asyncio

    fi.install([fi.Fault(site="a", kind="delay", delay_s=0.2, at=0),
                fi.Fault(site="a", kind="raise", at=1),
                fi.Fault(site="a", kind="device_loss", at=2)])

    async def drive():
        ticks = []

        async def ticker():
            for _ in range(5):
                ticks.append(time.monotonic())
                await asyncio.sleep(0.02)

        t = asyncio.ensure_future(ticker())
        await fi.async_check("a")  # the delay: the loop keeps running
        await t
        with pytest.raises(fi.InjectedFault):
            await fi.async_check("a")
        with pytest.raises(torch.AcceleratorError) as ei:
            await fi.async_check("a")
        await fi.async_check("a")  # no fault at the fourth visit
        await fi.async_check("other")
        return ticks, ei.value

    t0 = time.monotonic()
    ticks, lost = asyncio.run(drive())
    assert len(ticks) == 5 and ticks[-1] - t0 < 0.2
    assert is_device_loss(lost)


def test_collective_site_labels_nest_per_thread():
    assert resilience.current_collective_site() == ""
    seen = []
    with resilience.collective_site("outer"):
        seen.append(resilience.current_collective_site())
        with resilience.collective_site("inner"):
            seen.append(resilience.current_collective_site())
            outs = run_simulated_processes(
                2, lambda r: resilience.current_collective_site())
        seen.append(resilience.current_collective_site())
    seen.append(resilience.current_collective_site())
    assert seen == ["outer", "inner", "outer", ""]
    assert outs == ["", ""]  # another thread carries no label


class _FakeKernelLib:
    """The kernel library's C interface with a launch that returns a
    chosen CUDA status (the runtime's names and descriptions)."""

    NAMES = {700: (b"cudaErrorIllegalAddress",
                   b"an illegal memory access was encountered"),
             1: (b"cudaErrorInvalidValue", b"invalid argument")}

    def __init__(self, status):
        self.status = status

    def photon_mps_tile(self):
        return 32768

    def photon_mps_f32(self, *args):
        return self.status

    photon_mps_f64 = photon_mps_f32

    def photon_cuda_error_name(self, err):
        return self.NAMES[err][0]

    def photon_cuda_error_string(self, err):
        return self.NAMES[err][1]


@pytest.mark.parametrize("status, lost", [(700, True), (1, False)])
def test_kernel_launch_failure_is_classified(monkeypatch, status, lost):
    from photon_ml_tpu_torch.ops import kernel_build, kernels

    monkeypatch.setattr(kernel_build, "load_library",
                        lambda: _FakeKernelLib(status))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    before = kernels.multiply_prefix_sum.launches
    with pytest.raises(torch.AcceleratorError) as ei:
        kernels._launch(None, torch.zeros(64), kernels.TILE)
    msg = str(ei.value)
    assert msg.startswith("CUDA error: ")
    assert _FakeKernelLib.NAMES[status][0].decode() in msg
    assert f"cudaError {status}" in msg
    assert is_device_loss(ei.value) is lost
    assert kernels.multiply_prefix_sum.launches == before  # not counted


# -- streamed passes and I/O sites under injected faults --------------------
def _tiny_chunks():
    from photon_ml_tpu_torch.parallel.streaming import make_host_chunks
    from photon_ml_tpu_torch.testing import synthetic_glm_data

    data = synthetic_glm_data(n=96, d=5, seed=0)
    return make_host_chunks(data.X, data.y, chunk_rows=32)


def test_streamed_fit_coordinated_abort_on_chunk_fault():
    """fit_streaming in simulated processes: a raise at chunk N in ONE
    process aborts every process at the pass's guard, none hang."""
    from photon_ml_tpu_torch.ops.objective import make_objective
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.parallel.streaming import fit_streaming

    chunks, dim = _tiny_chunks()
    obj = make_objective("logistic")
    cfg = OptimizerConfig(max_iters=3, tolerance=0.0)

    class FaultyChunks:
        def __len__(self):
            return len(chunks)

        def __iter__(self):
            for c in chunks:
                fi.check("stream.chunk")
                yield c

    def work(rank):
        return float(fit_streaming(obj, FaultyChunks(), dim, l2=0.5,
                                   config=cfg, device="cpu").value)

    out = run_simulated_processes(3, work)
    assert all(isinstance(v, float) for v in out) and len(set(out)) == 1
    fi.install([fi.Fault(site="stream.chunk", process=1, at=2)])
    out = run_simulated_processes(3, work, join_timeout=60)
    assert all(isinstance(o, PeerFailure) for o in out)
    assert isinstance(out[1].__cause__, fi.InjectedFault)


def _avro(tmp_path, rows_n, block_size, seed):
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.index_map import IndexMap

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows_n, 4))
    rows = [[(f"f{j}", "", float(v)) for j, v in enumerate(r)] for r in X]
    path = str(tmp_path / "t.avro")
    write_training_examples(path, rows,
                            rng.integers(0, 2, rows_n).astype(float),
                            block_size=block_size)
    return path, IndexMap({f"f{j}": j for j in range(4)})


def test_stream_source_fault_sites(tmp_path):
    """``stream.chunk`` fires in the consumer; a ``truncate`` at
    ``stream.block_payload`` drives the real truncated-block error."""
    from photon_ml_tpu_torch.io.stream_source import AvroChunkSource

    path, imap = _avro(tmp_path, 64, 512, 3)
    src = AvroChunkSource(path, imap, chunk_rows=16)
    assert len(list(src)) == len(src)
    fi.install([fi.Fault(site="stream.chunk", at=1)])
    with pytest.raises(fi.InjectedFault):
        list(src)
    fi.install([fi.Fault(site="stream.block_payload", at=0,
                         kind="truncate")])
    with pytest.raises(ValueError, match="truncated block"):
        list(src)


def test_durable_commit_crash_window_leaves_destination(tmp_path):
    from photon_ml_tpu_torch.io.durable import durable_replace

    dst = tmp_path / "marker"
    dst.write_text("old")
    tmp = tmp_path / "marker.tmp"
    tmp.write_text("new")
    fi.install([fi.Fault(site="durable.commit")])
    with pytest.raises(fi.InjectedFault):
        durable_replace(str(tmp), str(dst))
    assert dst.read_text() == "old" and tmp.exists()
    fi.clear()
    durable_replace(str(tmp), str(dst))
    assert dst.read_text() == "new"


# -- bounded retry ----------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _MaxJitterRng:
    def uniform(self, lo, hi):
        return hi


def test_backoff_schedule_jitter_and_deadline():
    clock = _Clock()
    b = Backoff(base_s=1.0, factor=2.0, max_s=5.0, jitter=0.0, clock=clock)
    assert [b.next_delay() for _ in range(5)] == [1.0, 2.0, 4.0, 5.0, 5.0]
    b.reset()
    assert b.attempts == 0 and b.next_delay() == 1.0
    b = Backoff(base_s=2.0, factor=2.0, max_s=60.0, jitter=0.25,
                deadline_s=10.0, rng=_MaxJitterRng(), clock=clock)
    assert b.next_delay() == pytest.approx(2.5)
    assert not b.expired() and b.remaining() == pytest.approx(10.0)
    clock.t = 10.0
    assert b.expired() and b.remaining() == 0.0
    with pytest.raises(ValueError):
        Backoff(factor=0.5)


def test_retry_transient_schedules():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient rendezvous")
        return "up"

    assert retry_transient(flaky, attempts=3, backoff_s=0.5,
                           sleep=sleeps.append) == "up"
    assert sleeps == [0.5, 1.0]
    sleeps.clear()
    calls.clear()
    assert retry_transient(flaky, attempts=3, backoff_s=1.0, jitter=0.5,
                           rng=_MaxJitterRng(), sleep=sleeps.append) == "up"
    assert sleeps == [pytest.approx(1.5), pytest.approx(3.0)]
    with pytest.raises(KeyError):  # not retriable: propagates at once
        retry_transient(lambda: (_ for _ in ()).throw(KeyError("x")),
                        attempts=5, sleep=lambda s: None)
    calls.clear()
    with pytest.raises(RuntimeError, match="still down"):
        retry_transient(lambda: (_ for _ in ()).throw(
            RuntimeError("still down")), attempts=5, backoff_s=2.0,
            deadline_s=1.0, clock=_Clock(), sleep=sleeps.append)


def test_initialize_multihost_retries_transient_rendezvous(monkeypatch):
    import torch.distributed as dist

    from photon_ml_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(kw["init_method"]))
    fi.install([fi.Fault(site="multihost.init", at=i,
                         message="coordinator not up") for i in (0, 1)])
    assert multihost.initialize_multihost("127.0.0.1:1", 1, 0, backoff_s=0.0,
                                          device="cpu") is True
    assert calls == ["tcp://127.0.0.1:1"]
    fi.install([fi.Fault(site="multihost.init", at=i) for i in range(5)])
    with pytest.raises(fi.InjectedFault):
        multihost.initialize_multihost("127.0.0.1:1", 1, 0, max_attempts=2,
                                       backoff_s=0.0, device="cpu")


# -- classification ---------------------------------------------------------
def test_classify_failure_and_recovery_support():
    assert classify_failure(
        WatchdogTimeout("gone", tag="t", failed={2: CODE_ERROR})) == RANK_LOSS
    assert classify_failure(
        PeerFailure("x", tag="t", failed={1: CODE_ERROR})) == ROLLBACK
    assert classify_failure(
        PeerFailure("x", tag="t", failed={1: CODE_DEVICE_LOSS})) == FATAL
    assert classify_failure(
        PeerFailure("x", tag="t", failed={1: CODE_DATA})) == FATAL
    assert classify_failure(ValueError("bad rows")) == FATAL

    class NoRecover:
        def process_count(self):
            return 4

    class CanRecover(NoRecover):
        def recover(self, payload, timeout):  # pragma: no cover - probe
            raise NotImplementedError

    assert recovery_supported() is True  # one process: trivially
    assert recovery_supported(NoRecover()) is False
    assert recovery_supported(CanRecover()) is True
    # the production transport cannot shrink
    assert not hasattr(resilience.TorchTransport(), "recover")


# -- ResumeManager ----------------------------------------------------------
def test_resume_manager_lifecycle(tmp_path):
    path = str(tmp_path / "RESUME.json")
    fp = {"train": ["a.avro"], "rows": 100}
    rm = ResumeManager(path, fingerprint=fp)
    assert not rm.exists() and rm.load() is None
    rm.save({"checkpoint": "ckpt-3"})
    assert os.listdir(tmp_path) == ["RESUME.json"]  # no temp file left
    assert ResumeManager(path, fingerprint=fp).load()["checkpoint"] == "ckpt-3"
    rm.consume()
    assert not rm.exists()
    rm.consume()  # idempotent
    # a non-lead process never writes nor consumes
    ResumeManager(path, is_lead=False).save({"checkpoint": "c"})
    assert not os.path.exists(path)
    ResumeManager(path).save({"checkpoint": "c"})
    ResumeManager(path, is_lead=False).consume()
    assert os.path.exists(path)


def test_resume_manager_refuses_fingerprint_mismatch(tmp_path):
    path = str(tmp_path / "RESUME.json")
    ResumeManager(path, fingerprint={"val": "a.avro", "rows": 10}).save(
        {"checkpoint": "c"})
    with pytest.raises(ResumeMismatch, match="rows"):
        ResumeManager(path, fingerprint={"val": "a.avro", "rows": 11}).load()
    ResumeManager(path).save({"checkpoint": "c"})  # unfingerprinted marker
    assert ResumeManager(path, fingerprint={"rows": 1}).load() is not None
    npz = str(tmp_path / "RESUME_GLM.npz")
    w = np.arange(5.0)
    ResumeManager(npz, fingerprint={"rows": 7}).save(
        {"entries": [{"lam": 0.5, "w": w}], "last_w": w})
    back = ResumeManager(npz, fingerprint={"rows": 7}).load()
    np.testing.assert_array_equal(back["last_w"], w)
    assert back["entries"][0]["lam"] == 0.5
    with pytest.raises(ResumeMismatch):
        ResumeManager(npz, fingerprint={"rows": 8}).load()
