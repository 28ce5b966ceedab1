"""The hand-written CUDA kernels on the card, against their plain versions,
and the fits and metrics that run through them against the same on the
CPU.

Skipped without a CUDA device. This file imports neither JAX nor the JAX
package, so on a GPU machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.evaluation.device import device_auc
from photon_ml_tpu_torch.evaluation.evaluators import auc
from photon_ml_tpu_torch.interop import batch_from_numpy

from photon_ml_tpu_torch.ops.kernels import (
    TILE, csc_column_sums, csc_column_sums_plain, csc_transpose_apply_kernel,
    multiply_prefix_sum, multiply_prefix_sum_plain, paged_gather_score,
    paged_gather_score_at, paged_gather_score_ordered_plain,
    paged_gather_score_plain, paged_gather_score_previous,
)
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optimize.common import OptimizerConfig
from photon_ml_tpu_torch.parallel.data_parallel import fit_distributed
from photon_ml_tpu_torch.types import (
    CSCTranspose, build_csc_transpose, csc_transpose_apply,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nnz", [0, 1, 100, TILE, 3 * TILE + 17])
def test_kernel_matches_plain(cuda, nnz, dtype, with_values):
    """Per element, |kernel - plain| <= tol * cumsum(|x|) within the tile:
    the two scan in different orders; tol is a few dozen ulps."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(nnz)
    d = torch.randn(nnz, generator=gen, device=cuda, dtype=dtype)
    values = (torch.randn(nnz, generator=gen, device=cuda, dtype=dtype)
              if with_values else None)
    launches = multiply_prefix_sum.launches
    local, totals, tile = multiply_prefix_sum(values, d)
    assert multiply_prefix_sum.launches == launches + 1
    torch.cuda.synchronize()
    want, want_totals, _ = multiply_prefix_sum_plain(values, d, TILE)
    x = d if values is None else values * d
    scale = multiply_prefix_sum_plain(None, x.abs(), TILE)[0]
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert tile == TILE and local.shape == want.shape
    assert bool(((local - want).abs() <= tol * scale).all())
    n_tiles = totals.shape[0]
    assert torch.equal(totals, local.view(n_tiles, TILE)[:, -1])
    again = multiply_prefix_sum(values, d)
    assert torch.equal(local, again[0]) and torch.equal(totals, again[1])


def test_csc_transpose_apply_kernel_accuracy(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    n, k, dim = 1 << 15, 39, 1 << 12
    idx = torch.randint(0, dim, (n, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    csc = build_csc_transpose(idx, None, dim)
    d = torch.rand(n, generator=gen, device=cuda) + 0.5
    got = csc_transpose_apply_kernel(csc, d).double()
    ref = csc_transpose_apply(csc, d.double())
    assert float(((got - ref).abs() / ref.clamp(min=1e-30)).max()) < 1e-4


RANGE = 2048  # nonzeros per block of csc_column_sums (photon_csc_range)


def _column_view(case, device, gen):
    """A column-sorted view of each case's shape: "spread" (a ragged last
    range), "whole ranges", "nnz 0", "one column" (2^20 nonzeros, 512
    ranges), "many empty" (24 nonempty columns among 100,000)."""
    dim, nnz = 1000, 5 * RANGE + 17
    lengths = torch.zeros(dim, dtype=torch.int64)
    if case == "one column":
        lengths[17] = 1 << 20
    elif case == "many empty":
        dim = 100_000
        lengths = torch.zeros(dim, dtype=torch.int64)
        cols = torch.randperm(dim, generator=gen)[:24]
        lengths[cols] = torch.randint(1, 2 * RANGE, (24,), generator=gen)
    elif case != "nnz 0":
        total = 5 * RANGE if case == "whole ranges" else nnz
        cols = torch.randint(0, dim, (total,), generator=gen)
        lengths = torch.bincount(cols, minlength=dim)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(lengths, 0)]).to(torch.int32)
    rows = torch.randint(0, 4096, (int(starts[-1]),), generator=gen,
                         dtype=torch.int32)
    return starts.to(device), rows.to(device)


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["spread", "whole ranges", "nnz 0",
                                  "one column", "many empty"])
def test_csc_column_sums_matches_plain(cuda, case, dtype, with_values):
    """The kernel against its plain version and the float64 column sum
    ``ref``: float32 within one float32 ulp of ``|ref|`` plus ``1e-12 *
    sum_j |x|``, float64 within ``1e-12 * sum_j |x|``; equal bit for bit
    to the plain version run on the CPU (it sums in the kernel's order);
    empty columns exactly 0; two runs bit-identical; one count per
    call."""
    gen = torch.Generator()
    gen.manual_seed(len(case))
    starts, rows = _column_view(case, cuda, gen)
    nnz = rows.shape[0]
    d = torch.randn(4096, generator=gen, dtype=dtype).to(cuda)
    values = (torch.randn(nnz, generator=gen, dtype=dtype).to(cuda)
              if with_values else None)
    csc = CSCTranspose(values, rows, starts)
    launches = csc_column_sums.launches
    got = csc_column_sums(csc, d)
    again = csc_column_sums(csc, d)
    assert csc_column_sums.launches == launches + 2
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    host = csc_column_sums_plain(CSCTranspose(
        None if values is None else values.cpu(), rows.cpu(), starts.cpu()),
        d.cpu())
    assert torch.equal(got.cpu(), host)
    x = d.double()[rows]
    if values is not None:
        x = x * values.double()
    lengths = torch.diff(starts.long())
    ref = torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)
    scale = torch.segment_reduce(x.abs(), "sum", lengths=lengths,
                                 unsafe=True)
    tol = 1e-12 * scale
    if dtype == torch.float32:
        _, e = torch.frexp(ref.abs())
        tol = tol + torch.where(ref == 0, 0.0, torch.ldexp(
            torch.ones_like(ref), e - 24))
    for out in (got, csc_column_sums_plain(csc, d)):
        assert bool(((out.double() - ref).abs() <= tol).all())
    assert bool((got[lengths == 0] == 0).all())


def test_kernel_rejects_other_tiles(cuda):
    with pytest.raises(ValueError):
        multiply_prefix_sum(None, torch.ones(10, device=cuda), tile=1024)


def _fit_inputs(seed=1, n=4096, dim=1024, k=39):
    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    w_true = r.normal(size=dim) * 0.5
    y = (r.random(n) < 1 / (1 + np.exp(-w_true[idx].sum(1)))).astype(float)
    return idx, y, dim


def _paged_inputs(gen, dev, slots_n, dim, b, k, dtype):
    table = torch.randn(slots_n, dim, generator=gen, device=dev, dtype=dtype)
    slots = torch.randint(-1, slots_n, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(0, dim, (b, k), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.randn(b, k, generator=gen, device=dev, dtype=dtype)
    return table, slots, idx, val


def _paged_gate(table, slots, idx, val):
    """4 eps * sum_j |table[slot, idx_j] * val_j| per row: the kernel sums
    a row in lanes and a tree over them (the order of
    ``paged_gather_score_ordered_plain``), torch's row sum in its own
    order, and two orders of the same k terms differ by a few ulps of
    sum |terms|."""
    terms = paged_gather_score_plain(table.abs(), slots, idx, val.abs())
    return 4 * torch.finfo(table.dtype).eps * terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 39, 40, 63, 64, 65, 130])
@pytest.mark.parametrize("b", [0, 1, 7, 64, 4099])
def test_paged_gather_score_matches_plain(cuda, dtype, b, k):
    """The kernel against its plain version on the card: within the
    per-row gate, exactly 0 where the slot is -1, one launch per call (none
    for an empty batch), two runs bit-identical, and both entries bit for
    bit the ordered plain twin (k on both sides of every lane count's
    edge, B not a multiple of a block's rows)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b * 131 + k)
    table, slots, idx, val = _paged_inputs(gen, cuda, 64, 1024, b, k, dtype)
    launches = paged_gather_score.launches
    got = paged_gather_score(table, slots, idx, val)
    assert paged_gather_score.launches == launches + (1 if b else 0)
    torch.cuda.synchronize()
    want = paged_gather_score_plain(table, slots, idx, val)
    assert got.shape == (b,) and got.dtype == dtype
    assert bool(((got - want).abs() <= _paged_gate(table, slots, idx,
                                                   val)).all())
    assert bool((got[slots < 0] == 0).all())
    assert torch.equal(got, paged_gather_score(table, slots, idx, val))
    twin = paged_gather_score_ordered_plain(table, slots, idx, val)
    assert torch.equal(got, twin)
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=cuda)
    assert torch.equal(paged_gather_score_at(table_at, table, slots, idx,
                                             val), twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 64, 130])
def test_paged_gather_score_rows_off_16_bytes(cuda, dtype, k):
    """Index and value rows that start one element past a 16-byte
    boundary (a contiguous view at an odd offset of a longer buffer): the
    kernel takes its scalar loads there and still gives the twin's bits,
    through both entries."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    b = 67
    table, slots, idx, val = _paged_inputs(gen, cuda, 64, 1024, b * k + 1,
                                           1, dtype)
    idx, val = idx.view(-1)[1:].view(b, k), val.view(-1)[1:].view(b, k)
    slots = slots[:b]
    assert idx.data_ptr() % 16 and val.data_ptr() % 16
    twin = paged_gather_score_ordered_plain(table, slots, idx, val)
    assert torch.equal(paged_gather_score(table, slots, idx, val), twin)
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=cuda)
    assert torch.equal(paged_gather_score_at(table_at, table, slots, idx,
                                             val), twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_paged_gather_score_previous_design_agrees_counted_apart(cuda,
                                                                 dtype):
    """The previous design (a timing yardstick, on no path), through both
    of its entries, within the gate of the kernel; its launches counted in
    its own count and not in ``paged_gather_score.launches``."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(29)
    table, slots, idx, val = _paged_inputs(gen, cuda, 64, 1024, 300, 40,
                                           dtype)
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=cuda)
    got = paged_gather_score(table, slots, idx, val)
    launches = paged_gather_score.launches
    previous = paged_gather_score_previous.launches
    gate = _paged_gate(table, slots, idx, val)
    for prev in (paged_gather_score_previous(table, slots, idx, val),
                 paged_gather_score_previous(table, slots, idx, val,
                                             table_at=table_at)):
        assert bool(((prev - got).abs() <= gate).all())
        assert bool((prev[slots < 0] == 0).all())
    assert paged_gather_score.launches == launches
    assert paged_gather_score_previous.launches == previous + 2


def test_load_library_refuses_another_paged_order(cuda):
    """The built library's lanes and chunks are the twin's; a library
    that reported others for one width is refused."""
    from photon_ml_tpu_torch.ops import kernel_build
    from photon_ml_tpu_torch.ops.kernels import paged_chunk

    lib = kernel_build.load_library()
    kernel_build.check_paged_order(lib)

    class Other:
        photon_paged_lanes = staticmethod(lib.photon_paged_lanes)

        @staticmethod
        def photon_paged_chunk(k):
            return paged_chunk(k) + (k == 40)

    with pytest.raises(RuntimeError, match="k = 40"):
        kernel_build.check_paged_order(Other())


def test_paged_gather_score_selects_zero_and_64_bit_offsets(cuda):
    """A slot of -1 scores exactly 0 even over a table of NaN; a table of
    more than 2^31 elements is addressed past 2^31 (the offsets are formed
    in 64 bits) and agrees with the plain version's int64 index."""
    dim, slots_n = 1 << 16, (1 << 15) + 2  # S * D > 2^31
    table = torch.full((slots_n, dim), float("nan"), device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    table[-2:] = torch.randn(2, dim, generator=gen, device=cuda)
    slots = torch.tensor([-1, slots_n - 1, slots_n - 2, -1], device=cuda,
                         dtype=torch.int32)
    idx = torch.randint(0, dim, (4, 39), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.randn(4, 39, generator=gen, device=cuda)
    got = paged_gather_score(table, slots, idx, val)
    want = paged_gather_score_plain(table, slots, idx, val)
    assert bool(torch.isfinite(got).all())
    assert got[0] == 0 and got[3] == 0
    assert bool(((got - want).abs() <= _paged_gate(table, slots, idx,
                                                   val)).all())
    del table
    torch.cuda.empty_cache()


def test_paged_gather_score_rejects_bad_inputs(cuda):
    table = torch.zeros(4, 8, device=cuda)
    idx = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    val = torch.zeros(2, 3, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        paged_gather_score(table, torch.zeros(2, dtype=torch.int64,
                                              device=cuda), idx, val)
    with pytest.raises(ValueError, match="values"):
        paged_gather_score(table, torch.zeros(2, dtype=torch.int32,
                                              device=cuda), idx, val.double())


@pytest.mark.parametrize("optimizer", ["owlqn", "tron"])
def test_fit_on_card_matches_cpu(cuda, optimizer):
    """The same f64 fit through the kernel on the card and through its
    plain version on the CPU: rel L2 of w within 1e-9 (the two scan in
    different orders); two card runs bit-identical; OWL-QN launches the
    kernel once per iteration plus once at the start."""
    idx, y, dim = _fit_inputs()
    fits = {}
    for dev in ("cpu", "cuda", "cuda"):
        batch = batch_from_numpy(idx, None, y, dim=dim, dtype=torch.float64,
                                 device=dev)
        launches = csc_column_sums.launches
        res = fit_distributed(
            make_objective("logistic"), batch,
            torch.zeros(dim, dtype=torch.float64, device=dev), l2=1.0,
            l1=2.0, optimizer=optimizer,
            config=OptimizerConfig(max_iters=8, tolerance=0.0),
            sparse_grad="csc_kernel")
        launched = csc_column_sums.launches - launches
        fits.setdefault(dev, []).append((res, launched))
    cpu, (card, launched), (again, _) = fits["cpu"][0][0], *fits["cuda"]
    assert card.iterations == cpu.iterations == 8
    rel = float((card.w.cpu() - cpu.w).norm() / cpu.w.norm())
    assert rel < 1e-9
    assert torch.equal(card.w, again.w)
    if optimizer == "owlqn":
        assert launched == card.iterations + 1
    else:
        assert launched >= 2 * card.iterations + 1


def test_device_auc_on_card(cuda):
    r = np.random.default_rng(2)
    labels = (r.random(1 << 16) < 0.3).astype(float)
    scores = np.round(r.normal(size=labels.size) + labels, 2)  # ties
    weights = r.random(labels.size) + 0.5
    got = float(device_auc(scores, labels, weights, device=cuda))
    assert abs(got - auc(scores, labels, weights)) <= 1e-12


def test_glm_driver_on_card_matches_cpu(cuda, tmp_path):
    """The GLM driver on an Avro file (explicit values, hashed features):
    on the card by default, and with ``--device cpu``, both in float64 at
    tolerance 0. Each lambda's saved coefficients agree to 1e-9 relative
    L2 (the kernel and its plain version scan in different orders); every
    lambda's fit launches the kernel iterations + 1 times; the card's
    models load on the CPU."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.model_io import load_game_model

    r = np.random.default_rng(5)
    n, k = 3000, 8
    ids = r.integers(0, 50, (n, k))
    w_true = r.normal(size=(k, 50))
    y = (r.random(n) < 1 / (1 + np.exp(-w_true[np.arange(k), ids].sum(1))))
    rows = [[(f"c{j}", str(t), float(r.random() + 0.5))
             for j, t in enumerate(row)] for row in ids.tolist()]
    write_training_examples(str(tmp_path / "train.avro"), rows,
                            y.astype(float))
    argv = ["--train-data", str(tmp_path / "train.avro"), "--hash-dim",
            "1024", "--reg-weights", "10", "1", "--dtype", "float64",
            "--tolerance", "0", "--max-iters", "10"]
    launches = csc_column_sums.launches
    assert glm_driver.main(argv + ["--output-dir", str(tmp_path / "card")]) == 0
    assert csc_column_sums.launches - launches == 2 * 11
    assert glm_driver.main(argv + ["--output-dir", str(tmp_path / "cpu"),
                                   "--device", "cpu"]) == 0
    for lam in ("10", "1"):
        sub = f"all/lambda-{lam}"
        card = load_game_model(str(tmp_path / "card" / sub), device="cpu")
        cpu = load_game_model(str(tmp_path / "cpu" / sub), device="cpu")
        w_card = card["global"].model.coefficients.means
        w_cpu = cpu["global"].model.coefficients.means
        assert float((w_card - w_cpu).norm() / w_cpu.norm()) < 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_path_walk_on_card_matches_cpu(cuda):
    """A screened elastic-net path walk (6 lambdas from lambda_max, f64,
    at most 25 OWL-QN iterations per solve at tolerance 1e-6) on the card
    and on the CPU: per lambda the same candidates, rounds, iterations and
    support, and ``w`` within 1e-10 relative L2; the certification passes
    and restricted solves launch the kernel. The tolerance stops every
    solve while ``f`` still falls: run to tolerance 0, a solve ends where
    its line search can no longer tell ``f`` values apart, and there the
    two devices' reduction orders pick other last steps (2.640e-8 at this
    seed). ``scripts/torch_card_cpu_floor.py --path 25:1e-6`` gave at most
    4.380e-12 over seeds 0-7 on an H100."""
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import PathConfig
    from photon_ml_tpu_torch.optimize.path import PathSolver

    idx, y, dim = _fit_inputs(seed=3)
    walks = {}
    for dev in ("cpu", "cuda"):
        batch = batch_from_numpy(idx, None, y, dim=dim, dtype=torch.float64,
                                 device=dev)
        solver = PathSolver(
            make_objective("logistic"),
            RegularizationContext("elastic_net", alpha=0.9), batch=batch,
            config=OptimizerConfig(max_iters=25, tolerance=1e-6),
            path_config=PathConfig(screen="strong"))
        grid = np.geomspace(solver.lambda_max(), 0.05 * solver.lambda_max(),
                            6)
        launches = csc_column_sums.launches
        walks[dev] = ([solver.solve(float(lam)) for lam in grid],
                      csc_column_sums.launches - launches)
    (cpu, _), (card, launched) = walks["cpu"], walks["cuda"]
    assert launched > 0
    for (rc, sc), (rg, sg) in zip(cpu, card):
        assert sg.certified and sc.certified
        assert (sg.candidate_size, sg.kkt_rounds, sg.screened_dim,
                sg.solver_iterations) == \
            (sc.candidate_size, sc.kkt_rounds, sc.screened_dim,
             sc.solver_iterations)
        assert torch.equal(rg.w.cpu() != 0, rc.w != 0)
        assert _rel(rg.w.cpu(), rc.w) < 1e-10


def test_path_walk_f32_on_card(cuda):
    """The same walk in float32, with the GLM driver's default solver
    settings (100 iterations, tolerance 1e-7), on the card: every lambda
    certified; where the solve was restricted, a fresh full gradient meets
    the KKT condition within the certification slack at the coordinates
    the strong rule froze; at every solution the kernel's certification
    gradient equals the CPU's plain one within 1e-5 relative L2 (the card
    and the CPU may round a float32 margin differently)."""
    from photon_ml_tpu_torch.ops.objective import kkt_residuals
    from photon_ml_tpu_torch.ops.regularization import (
        RegularizationContext, kkt_slack, screening_threshold,
    )
    from photon_ml_tpu_torch.optimize import PathConfig
    from photon_ml_tpu_torch.optimize.path import PathSolver

    idx, y, dim = _fit_inputs(seed=3)
    reg = RegularizationContext("elastic_net", alpha=0.9)
    solvers = {dev: PathSolver(
        make_objective("logistic"), reg,
        batch=batch_from_numpy(idx, None, y, dim=dim, dtype=torch.float32,
                               device=dev),
        config=OptimizerConfig(max_iters=100, tolerance=1e-7),
        path_config=PathConfig(screen="strong")) for dev in ("cpu", "cuda")}
    solver = solvers["cuda"]
    grid = np.geomspace(solver.lambda_max(), 0.05 * solver.lambda_max(), 6)
    launches = csc_column_sums.launches
    walk = [solver.solve(float(lam)) for lam in grid]
    assert csc_column_sums.launches > launches
    w_prev, g_prev, l1_prev = solver._probe()
    restricted = 0
    for lam, (res, st) in zip(grid, walk):
        assert st.certified and bool(torch.isfinite(res.w).all())
        g = solver._full_grad(res.w)
        assert _rel(g.cpu(), solvers["cpu"]._full_grad(res.w.cpu())) < 1e-5
        l1 = reg.l1_weight(float(lam))
        if st.screened_dim < dim:
            restricted += 1
            thr = screening_threshold("strong", l1, max(l1_prev, l1))
            frozen = (g_prev.abs() < thr) & (w_prev == 0) & (res.w == 0)
            r = kkt_residuals(res.w, g, l1)[frozen]
            assert float(r.max()) <= kkt_slack(l1, PathConfig().kkt_tol)
        w_prev, g_prev, l1_prev = res.w, g, l1
    assert restricted > 0


def test_game_cd_on_card_matches_cpu(cuda):
    """Three sweeps of GAME coordinate descent (a sparse fixed effect, a
    per-user random effect by Newton, a per-item one by L-BFGS; at most
    10, 5 and 5 iterations at tolerance 1e-6) on the card and on the CPU at
    f64: every coefficient within 1e-12 relative L2 and the final
    validation AUC within 1e-9; the fixed coordinate's fits launch the
    kernel; two card runs are bit-identical. The tolerance stops the
    solves before the float64 floor, where tolerance 0 left them (up to
    1.085e-9 over seeds 0-7); ``scripts/torch_card_cpu_floor.py --game
    10,5,5:1e-6`` gave at most 6.959e-16 over seeds 0-7 on an H100."""
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.game.descent import (
        CoordinateConfig, CoordinateDescent, make_game_dataset,
    )

    r = np.random.default_rng(7)
    n, dim, k = 3000, 256, 12
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    y = (r.random(n) < 1 / (1 + np.exp(-r.normal(size=dim)[idx].sum(1))))
    users, items = r.integers(0, 120, n), r.integers(0, 30, n)

    def part(rows):
        return make_game_dataset(
            {"global": HostSparse(idx[rows], None, dim)},
            y[rows].astype(float),
            entity_ids={"user": users[rows], "item": items[rows]})

    train, val = part(slice(0, 2400)), part(slice(2400, n))
    configs = [
        CoordinateConfig("fixed", reg_type="l2", reg_weight=1.0,
                         max_iters=10, tolerance=1e-6),
        CoordinateConfig("per_user", coordinate_type="random",
                         entity_column="user", optimizer="newton",
                         max_iters=5, tolerance=1e-6, reg_type="l2",
                         reg_weight=1.0),
        CoordinateConfig("per_item", coordinate_type="random",
                         entity_column="item", optimizer="lbfgs",
                         max_iters=5, tolerance=1e-6, reg_type="l2",
                         reg_weight=1.0),
    ]
    runs = {}
    for dev in ("cpu", "cuda", "cuda"):
        launches = csc_column_sums.launches
        model, hist = CoordinateDescent(
            configs, n_iterations=3, evaluators=["auc"],
            dtype=torch.float64, device=dev).run(train, val)
        runs.setdefault(dev, []).append(
            (model, hist, csc_column_sums.launches - launches))
    (cpu, h_cpu, _), = runs["cpu"]
    (card, h_card, launched), (again, _, _) = runs["cuda"]
    assert launched > 0
    assert abs(h_card[-1]["auc"] - h_cpu[-1]["auc"]) <= 1e-9
    assert _rel(card["fixed"].model.coefficients.means.cpu(),
                cpu["fixed"].model.coefficients.means) < 1e-12
    assert torch.equal(card["fixed"].model.coefficients.means,
                       again["fixed"].model.coefficients.means)
    for name in ("per_user", "per_item"):
        for bg, bc, ba in zip(card[name].buckets, cpu[name].buckets,
                              again[name].buckets):
            assert _rel(bg.coefficients, bc.coefficients) < 1e-12
            assert np.array_equal(bg.coefficients, ba.coefficients)


def test_game_drivers_on_card_match_cpu(cuda, tmp_path):
    """The GAME training driver (a fixed coordinate, a per-user random one
    by TRON, one Bayesian tuning round; tolerance 0 pins every solver's
    iteration count) and the scoring driver on its best model, on the card
    and on the CPU at f64: the tuned reg weights equal, every saved
    coefficient within 1e-9 relative L2, the scores within 1e-9; the fixed
    coordinate's fits launch the kernel."""
    import json

    from photon_ml_tpu_torch.cli import (
        game_scoring_driver, game_training_driver,
    )
    from photon_ml_tpu_torch.io.avro import iter_avro_records
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.model_io import load_game_model

    r = np.random.default_rng(3)
    n, dim = 1200, 64
    x = (r.random((n, dim)) < 0.1) * r.normal(size=(n, dim))
    users = r.integers(0, 40, n)
    y = (r.random(n) < 1 / (1 + np.exp(-x @ r.normal(size=dim)))).astype(
        float)
    for name, rows in (("train", slice(0, 1000)), ("val", slice(1000, n))):
        write_training_examples(
            str(tmp_path / f"{name}.avro"),
            ([(f"f{j}", "", float(x[i, j])) for j in np.nonzero(x[i])[0]]
             for i in range(n)[rows]), y[rows],
            entity_ids={"user": users[rows]})
    coords = json.dumps([
        {"name": "fixed", "reg_type": "l2", "reg_weight": 1.0,
         "max_iters": 10, "tolerance": 0.0},
        {"name": "per_user", "coordinate_type": "random",
         "entity_column": "user", "optimizer": "tron", "reg_type": "l2",
         "reg_weight": 1.0, "max_iters": 5, "tolerance": 0.0}])
    out, scores, launched = {}, {}, {}
    for dev in ("cpu", "cuda"):
        before = csc_column_sums.launches
        assert game_training_driver.main([
            "--train-data", str(tmp_path / "train.avro"),
            "--validation-data", str(tmp_path / "val.avro"),
            "--coordinates", coords, "--n-iterations", "2",
            "--tuning-mode", "bayesian", "--tuning-iters", "1",
            "--tuning-coordinates", "fixed", "--dtype", "float64",
            "--output-dir", str(tmp_path / f"t-{dev}"),
            "--device", dev]) == 0
        launched[dev] = csc_column_sums.launches - before
        out[dev] = tmp_path / f"t-{dev}"
        assert game_scoring_driver.main([
            "--data", str(tmp_path / "val.avro"), "--model-dir",
            str(out[dev] / "best"), "--output-dir", str(tmp_path / f"s-{dev}"),
            "--dtype", "float64", "--device", dev]) == 0
        scores[dev] = np.array([
            rec["predictionScore"] for rec in iter_avro_records(
                str(tmp_path / f"s-{dev}" / "scores.avro"))])
    assert launched["cuda"] > 0
    tuned = {}
    for dev in out:
        with open(out[dev] / "photon.log.jsonl") as f:
            tuned[dev] = [json.loads(line)["reg_weights"] for line in f
                          if '"tuning_round"' in line]
    assert tuned["cuda"] == tuned["cpu"] and len(tuned["cpu"]) == 1
    card = load_game_model(str(out["cuda"] / "best"), device="cpu")
    cpu = load_game_model(str(out["cpu"] / "best"), device="cpu")
    assert _rel(card["fixed"].model.coefficients.means,
                cpu["fixed"].model.coefficients.means) < 1e-9
    for bg, bc in zip(card["per_user"].buckets, cpu["per_user"].buckets):
        assert _rel(bg.coefficients, bc.coefficients) < 1e-9
    assert np.max(np.abs(scores["cuda"] - scores["cpu"])) <= 1e-9


def _stream_chunks(n=3000, dim=300, k=7, chunk_rows=512, seed=3):
    from photon_ml_tpu_torch.game.data import HostSparse
    from photon_ml_tpu_torch.parallel.streaming import make_host_chunks

    r = np.random.default_rng(seed)
    idx = r.integers(0, dim, (n, k)).astype(np.int32)
    vals = r.normal(size=(n, k))
    y = (r.random(n) < 0.4).astype(float)
    chunks, _ = make_host_chunks(HostSparse(idx, vals, dim), y,
                                 r.normal(scale=0.1, size=n),
                                 r.random(n) + 0.5, chunk_rows=chunk_rows)
    return chunks, dim


def test_streamed_kernel_fg_matches_plain_on_card(cuda):
    """One streamed gradient pass through the kernel (one launch per
    chunk) against the plain column-sorted pass, both on the card, and
    against the same pass in float64 on the CPU. The two card routes round
    each chunk's column sums apart (the kernel sums each column in float64,
    ``"csc"`` differences float64 tile prefixes), so per column they agree
    within ``1e-6 * (X^T |d1|)_j``, about eight float32 ulps of the
    column's absolute sum; ``f`` takes no column sum and is equal."""
    from photon_ml_tpu_torch.parallel.streaming import (
        streaming_value_and_grad,
    )

    chunks, dim = _stream_chunks()
    obj = make_objective("logistic")
    w = torch.linspace(-0.5, 0.5, dim)
    out = {}
    for mode in ("csc_kernel", "csc"):
        launches = csc_column_sums.launches
        fg = streaming_value_and_grad(obj, chunks, dim, torch.float32,
                                      sparse_grad=mode, device=cuda)
        out[mode] = fg(w.to(cuda), 0.5)
        used = csc_column_sums.launches - launches
        assert used == (len(chunks) if mode == "csc_kernel" else 0)
    f64 = streaming_value_and_grad(obj, chunks, dim, torch.float64,
                                   device="cpu")(w.double(), 0.5)
    scale = np.zeros(dim)
    w64 = w.double().numpy()
    for c in chunks:
        m = (c.values * w64[c.indices]).sum(1) + c.offsets
        d1 = c.weights * np.abs(1 / (1 + np.exp(-m)) - c.labels)
        np.add.at(scale, c.indices.reshape(-1),
                  (np.abs(c.values) * d1[:, None]).reshape(-1))
    diff = (out["csc_kernel"][1] - out["csc"][1]).double().abs().cpu()
    assert bool((diff.numpy() <= 1e-6 * scale).all())
    assert float(out["csc_kernel"][0]) == float(out["csc"][0])
    g = out["csc_kernel"][1].double().cpu()
    assert float((g - f64[1]).norm() / f64[1].norm()) < 1e-5


@pytest.mark.parametrize("optimizer", ["lbfgs", "tron"])
def test_streamed_fit_depth_invariant_on_card(cuda, optimizer):
    """Prefetch depth 0 and 2 give bit-identical fits on the card."""
    from photon_ml_tpu_torch.parallel.streaming import fit_streaming

    chunks, dim = _stream_chunks()
    fits = [fit_streaming(make_objective("logistic"), chunks, dim, l2=1.0,
                          config=OptimizerConfig(max_iters=5, tolerance=0.0),
                          optimizer=optimizer, prefetch_depth=depth,
                          device=cuda)
            for depth in (0, 2)]
    assert torch.equal(fits[0].w, fits[1].w)
    assert fits[0].stream_stats["kernel_passes"] \
        == fits[1].stream_stats["kernel_passes"]


def test_slow_consumer_over_the_ring_sees_every_chunk_intact(cuda):
    """A consumer slower than the transfer thread over a ring of depth 2:
    the pinned buffers are refilled only after their copies completed, so
    every chunk lands intact and the pass equals the synchronous one."""
    import time

    from photon_ml_tpu_torch.parallel import streaming

    chunks, dim = _stream_chunks(chunk_rows=256)
    ring = streaming.PinnedRing(cuda, 4)
    seen = []
    for hc, t in streaming.iter_device_chunks(
            chunks, lambda c: streaming._chunk_to_device(c, torch.float32,
                                                         ring), depth=2):
        torch.cuda._sleep(2_000_000)  # keep the compute stream busy
        time.sleep(0.01)
        seen.append((hc, t["indices"].clone(), t["offsets"].clone()))
    torch.cuda.synchronize()
    assert len(seen) == len(chunks)
    for hc, idx, offs in seen:
        assert np.array_equal(idx.cpu().numpy(), hc.indices)
        assert np.array_equal(offs.cpu().numpy(),
                              hc.offsets.astype(np.float32))
    obj = make_objective("logistic")
    w = torch.full((dim,), 0.01, device=cuda)
    slow = streaming.streaming_value_and_grad(obj, chunks, dim, device=cuda,
                                              prefetch_depth=2)
    sync = streaming.streaming_value_and_grad(obj, chunks, dim, device=cuda,
                                              prefetch_depth=0)
    real = streaming._kahan_add

    def slowed(acc, comp, x):
        torch.cuda._sleep(1_000_000)
        return real(acc, comp, x)

    streaming._kahan_add = slowed
    try:
        got = slow(w, 1.0)
    finally:
        streaming._kahan_add = real
    want = sync(w, 1.0)
    assert torch.equal(got[1], want[1]) and float(got[0]) == float(want[0])


def test_world1_nccl_fit_equals_no_mesh(cuda):
    """A one-rank mesh over NCCL (``initialize_multihost`` on CUDA: backend
    ``cpu:gloo,cuda:nccl``) fits bit for bit as ``mesh=None`` does, with
    the kernel launched as often and the same host reads."""
    import socket

    import torch.distributed as dist

    from photon_ml_tpu_torch.parallel.mesh import make_mesh
    from photon_ml_tpu_torch.parallel.multihost import initialize_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize_multihost(f"127.0.0.1:{port}", 1, 0, timeout_s=60)
    try:
        assert dist.get_backend() == "cpu:gloo,cuda:nccl"
        mesh = make_mesh({"data": 1})
        idx, y, dim = _fit_inputs()
        batch = batch_from_numpy(idx, None, y, dim=dim, dtype=torch.float32,
                                 device=cuda)
        for optimizer in ("lbfgs", "tron"):
            fits = []
            for m in (None, mesh):
                launches = csc_column_sums.launches
                res = fit_distributed(
                    make_objective("logistic"), batch,
                    torch.zeros(dim, device=cuda), l2=1.0,
                    optimizer=optimizer,
                    config=OptimizerConfig(max_iters=8, tolerance=0.0),
                    sparse_grad="csc_kernel", mesh=m)
                fits.append((res, csc_column_sums.launches - launches))
            (one, n_one), (meshed, n_meshed) = fits
            assert torch.equal(one.w, meshed.w), optimizer
            assert n_one == n_meshed > 0
            assert one.host_syncs == meshed.host_syncs
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_paged_gather_score_at_reads_the_address_when_it_runs(cuda, dtype):
    """The pointer entry scores bit for bit as the direct entry on the
    table whose address it reads, and reads the address when it runs:
    captured once in a CUDA graph, a replay after the address changed
    scores the other table, and a launch is counted per replay."""
    from photon_ml_tpu_torch.ops.kernels import paged_gather_score_at

    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    table, slots, idx, val = _paged_inputs(gen, cuda, 64, 512, 48, 40, dtype)
    other = torch.randn(table.shape, generator=gen, device=cuda, dtype=dtype)
    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=cuda)
    want = paged_gather_score(table, slots, idx, val)
    assert torch.equal(paged_gather_score_at(table_at, table, slots, idx,
                                             val), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_gather_score_at(table_at, table, slots, idx, val)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_gather_score_at(table_at, table, slots, idx, val)
    graph.replay()
    assert torch.equal(out, want)
    table_at.copy_(torch.tensor([other.data_ptr()], dtype=torch.int64))
    graph.replay()
    assert torch.equal(out, paged_gather_score(other, slots, idx, val))
    with pytest.raises(ValueError, match="table_at"):
        paged_gather_score_at(table_at.int(), table, slots, idx, val)


@pytest.fixture(scope="module")
def served_model(tmp_path_factory):
    """A GAME model saved by the port: a fixed coordinate and two random
    ones (20 users, 8 items, 3-6 local features each) over one shard of 64
    features and the intercept; and request rows for it, some of unknown
    users, with offsets."""
    from photon_ml_tpu_torch import models as m
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.model_io import save_game_model

    r = np.random.default_rng(23)
    dim = 65  # 64 features and the intercept

    def effect(name, prefix, n, column):
        widths = r.integers(3, 7, n)
        width = int(widths.max())
        proj = np.full((n, width), -1, np.int32)
        coef = np.zeros((n, width))
        for e, w in enumerate(widths):
            proj[e, :w] = np.sort(r.choice(dim, w, replace=False))
            coef[e, :w] = r.normal(size=w)
        return m.RandomEffectModel(
            name, [m.RandomEffectBucket([f"{prefix}{e}" for e in range(n)],
                                        coef, proj)],
            "logistic", entity_column=column)

    model = m.GameModel({
        "fixed": m.FixedEffectModel(m.GeneralizedLinearModel(
            m.Coefficients(torch.from_numpy(r.normal(size=dim))))),
        "per_user": effect("per_user", "u", 20, "userId"),
        "per_item": effect("per_item", "i", 8, "itemId")}, task="logistic")
    out = str(tmp_path_factory.mktemp("served") / "model")
    save_game_model(model, out, IndexMap({f"f{j}": j for j in range(64)},
                                         add_intercept=True))
    rows = []
    for i in range(40):
        feats = [{"name": f"f{int(j)}", "value": float(r.normal())}
                 for j in r.choice(64, int(r.integers(1, 12)), replace=False)]
        user = f"u{int(r.integers(0, 24))}"  # u20..u23 are unknown
        rows.append({"features": feats, "offset": float(r.normal()),
                     "entityIds": {"userId": user,
                                   "itemId": f"i{int(r.integers(0, 8))}"}})
    return out, rows


def _serving_session(model_dir, dtype, **kw):
    """A session on the card whose tables (4 pages of 8 rows) hold every
    user and item of ``served_model``: every batch takes one round."""
    from photon_ml_tpu_torch.serve import ScoringSession

    return ScoringSession(model_dir, dtype=dtype, max_batch=16, re_pages=4,
                          re_page_rows=8, device="cuda", **kw)


def _eager_scores(session, rung, n):
    """The last batch a rung replayed, scored again eagerly on the card
    from its buffers: the fixed margins through ``types.margins`` and each
    random coordinate through the direct ``paged_gather_score`` entry on
    the table it holds now, summed in the rung's order."""
    from photon_ml_tpu_torch.types import SparseFeatures, margins

    st, b = session._state, rung.buffers
    total, ri = b["offsets"], 0
    for kind, name, si in st.plan:
        dim = st.index_maps[st.shard_order[si]].size
        if kind == "fixed":
            m = margins(SparseFeatures(b["idx"][si], b["val"][si], dim=dim),
                        st.resident[name])
        else:
            m = paged_gather_score(st.paged[name].device_buffer,
                                   b["slots"][ri], b["idx"][si],
                                   b["val"][si])
            ri += 1
        total = total + m
    return total[:n].cpu().numpy()


def _rung(session, n):
    from photon_ml_tpu_torch.serve.session import bucketize

    st = session._state
    return session._compiled[("fused", bucketize(n, session.row_ladder),
                              st.fused_sig)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_session_graph_replay_equals_eager_scoring(cuda, served_model, dtype):
    """Warmup captures one graph per rung; each replay scores bit for bit
    as the same batch scored eagerly on the card, unknown users by the
    fixed effect and the item alone; no batch captures again."""
    model_dir, rows = served_model
    session = _serving_session(model_dir, dtype)
    try:
        assert session.paged_active
        assert session.compile_count == len(session.row_ladder) == 5
        for lo, n in ((0, 1), (1, 5), (6, 16), (22, 9), (31, 9)):
            got = session.score_rows(rows[lo:lo + n])
            assert np.array_equal(got, _eager_scores(session,
                                                     _rung(session, n), n))
        got, parts = session.score_rows(rows[:16], per_coordinate=True)
        unknown = [i for i, r in enumerate(rows[:16])
                   if int(r["entityIds"]["userId"][1:]) >= 20]
        assert unknown and all(parts["per_user"][i] == 0 for i in unknown)
        assert session.compile_count == len(session.row_ladder)
        assert session.fixed_eager_batches == 0
        assert session.fused_fallback_batches == 0
    finally:
        session.close()


def test_session_replays_read_a_copied_table(cuda, served_model):
    """A copy-on-write install gives the table a new buffer: the next
    replay scores from it (the re-installed user's new coefficients), and
    a snapshot taken before the install still scores bit for bit as it
    did."""
    from photon_ml_tpu_torch.serve import CoeffEntry

    model_dir, rows = served_model
    session = _serving_session(model_dir, "float32")
    try:
        old = session._state.coeff_caches["per_user"].get("u3")
        u3 = {"features": [{"name": f"f{g}", "value": 1.0}
                           for g in old.local_map if g < 64],
              "entityIds": {"userId": "u3", "itemId": "i0"}}
        batch = [u3] + [r for r in rows
                        if r["entityIds"]["userId"] != "u3"][:7]
        before = session.score_rows(batch)
        table = session._state.paged["per_user"]
        rung = _rung(session, len(batch))
        buf, slots, _ = table.lookup(["u3"])
        sl = torch.from_numpy(slots).to(cuda)
        idx, val = rung.buffers["idx"][0][:1], rung.buffers["val"][0][:1]
        snap = paged_gather_score(buf, sl, idx, val)
        copies = table.snapshot_copies
        table.install({"u3": CoeffEntry(old.local_map,
                                        2 * old.coefficients)})
        assert table.snapshot_copies == copies + 1
        assert table.device_buffer is not buf
        after = session.score_rows(batch)
        assert after[0] != before[0]
        assert np.array_equal(after[1:], before[1:])
        assert np.array_equal(after, _eager_scores(session, rung,
                                                   len(batch)))
        assert int(rung.buffers["table_at"][0]) == \
            table.device_buffer.data_ptr()
        assert torch.equal(paged_gather_score(buf, sl, idx, val), snap)
    finally:
        session.close()


def test_session_identical_swap_captures_nothing(cuda, served_model):
    model_dir, rows = served_model
    session = _serving_session(model_dir, "float32")
    try:
        before = session.score_rows(rows[:13])
        captured = session.compile_count
        first = session.active_version
        session.swap(model_dir, version="again")
        assert session.drain_installs(30.0)
        assert np.array_equal(session.score_rows(rows[:13]), before)
        assert session.rollback() == first
        assert np.array_equal(session.score_rows(rows[:13]), before)
        assert session.compile_count == captured
    finally:
        session.close()


def test_session_launch_count_equals_the_profiled_kernels(cuda,
                                                          served_model):
    """Each replay adds its captured kernels to
    ``paged_gather_score.launches``: over a run of batches the count
    moves by the ``paged_gather_score`` kernels the profiler saw, one per
    random coordinate per batch."""
    from torch.profiler import ProfilerActivity, profile

    model_dir, rows = served_model
    session = _serving_session(model_dir, "float32")
    try:
        session.score_rows(rows[:16])  # every entity resident
        launches = paged_gather_score.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for n in (1, 3, 8, 16, 5):
                session.score_rows(rows[:n])
            torch.cuda.synchronize()
        counted = paged_gather_score.launches - launches
        seen = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "paged_gather_score" in e.name)
        assert counted == 2 * 5 == seen
    finally:
        session.close()


def test_async_server_on_the_card_scores_as_the_threaded_server(
        cuda, served_model, tmp_path):
    """Two sessions on the card serving a registry's v1, one behind the
    threaded server and one behind the asyncio server: the same requests
    score bit for bit alike; a delta of the same shape (two users'
    coefficients halved) promoted and reloaded through ``/admin/reload``
    captures nothing on either, and both then score bit for bit alike
    again: the two users' parts exactly halved, every other part as it
    was."""
    import asyncio
    import json
    import os
    import shutil
    import threading
    import urllib.request

    from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
    from photon_ml_tpu_torch.registry import ModelRegistry, publish_delta
    from photon_ml_tpu_torch.serve import (
        AsyncScoringServer, MicroBatcher, ScoringServer, ScoringService,
    )

    model_dir, rows = served_model
    delta_dir = str(tmp_path / "delta")
    shutil.copytree(model_dir, delta_dir)
    path = os.path.join(delta_dir, "random-effect", "per_user",
                        "coefficients.avro")
    records, schema = read_avro_file(path)
    for rec in records:
        if rec["modelId"] in ("u3", "u5"):
            for coef in rec["means"]:
                coef["value"] *= 0.5
    write_avro_file(path, records, schema)
    registry = ModelRegistry(str(tmp_path / "registry"))
    v1 = registry.publish(model_dir, set_latest=True)

    def service():
        session = _serving_session(registry.open_version(v1), "float32")
        batcher = MicroBatcher(session.score_rows, max_batch=16,
                               max_delay_ms=1.0, metrics=session.metrics)
        return ScoringService(session, batcher, registry=registry)

    def post(port, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    threaded = ScoringServer(service(), port=0).start()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    run = lambda coro: asyncio.run_coroutine_threadsafe(coro, loop).result(60)
    aserver = run(AsyncScoringServer(service()).start())
    ports = {"thread": threaded.port, "async": aserver.port}
    sessions = [threaded.service.session, aserver.service.session]
    try:
        captured = [s.compile_count for s in sessions]
        body = lambda lo: {"rows": rows[lo:lo + 16], "perCoordinate": True}
        before = {k: [post(p, "/score", body(lo))[1] for lo in (0, 16, 32)]
                  for k, p in ports.items()}
        assert before["async"] == before["thread"]
        v2 = publish_delta(registry, delta_dir, set_latest=True)
        for p in ports.values():
            assert post(p, "/admin/reload", {}) == (
                200, {"activeVersion": v2, "swapped": True})
        for s in sessions:
            assert s.drain_installs(30.0)
        after = {k: [post(p, "/score", body(lo))[1] for lo in (0, 16, 32)]
                 for k, p in ports.items()}
        assert after["async"] == after["thread"]
        assert [s.compile_count for s in sessions] == captured
        def part(out, key):
            return np.concatenate([b["scoreComponents"][key]
                                   for b in out["async"]])

        moved = np.array([r["entityIds"]["userId"] in ("u3", "u5")
                          for r in rows])
        was, now = part(before, "per_user"), part(after, "per_user")
        # halving every coefficient halves each product and sum exactly
        assert moved.any() and (was[moved] != 0).any()
        assert np.array_equal(now[moved], 0.5 * was[moved])
        assert np.array_equal(now[~moved], was[~moved])
        assert np.array_equal(part(after, "per_item"),
                              part(before, "per_item"))
    finally:
        threaded.close(drain_timeout_s=30.0)
        run(aserver.aclose(drain_timeout_s=30.0))
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30.0)
