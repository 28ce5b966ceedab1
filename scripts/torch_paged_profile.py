#!/usr/bin/env python3
"""``paged_gather_score`` alone on the card, at ``chip_smoke.py`` phase 19
(c)'s shapes, on a table drawn from a seed instead of a trained model.

A float32 table of 4,096 rows (16 pages of 256) by 2^16 + 1 columns
(phase 19's, 1.07 GB) and a float64 copy; rows of 39 columns drawn
uniformly over 2^16 and the intercept's column, values 1; slots drawn
uniformly over the table's rows, -1 (no resident entity) for about 27% of
the rows as in phase 12's validation rows. Shapes: B = 32 and 4,096 (k =
40, the direct entry), the served rung B = 64 (k = 64: 40 entries and 24
padding entries of index 0 and value 0, the pointer entry), and B = 2^15
(k = 40) with every slot resident. Each shape goes through
``chip_smoke.time_paged``: bit for bit the ordered plain twin, then the
new and the previous design in turns, the plain version, ``embedding_bag``
and an empty kernel, beside the bound. Then what the phase cannot show,
each on the device's own clock, the previous design and the new in turns:

- cold batches: B = 32, 64 (k = 64, the pointer entry) and 4,096, each
  call on the next of the 2^15 rows' disjoint batches (slots drawn over
  the whole table), so the L2 (50 MB) does not hold the last call's
  sectors as it does when one batch repeats;
- where B = 2^15's time goes: every gather on one element (slot 0,
  column 0: the index, value and score streams alone) and the table cut
  to its first 128 rows (33.6 MB, which the L2 holds).

Run from the repository root on a machine with one GPU:

    python3 scripts/torch_paged_profile.py

The last line is a JSON object with every shape's numbers.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROWS, DIM = 4096, (1 << 16) + 1
FEATURES, UNKNOWN = 39, 0.27


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        SEED, SERVE_MAX_BATCH, SERVE_PAD_NNZ, _ms, card_peaks, time_paged,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    peaks = card_peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn(ROWS, DIM, generator=gen, device=dev)
    n = 1 << 15
    cols = np.concatenate([rng.integers(0, DIM - 1, (n, FEATURES)),
                           np.full((n, 1), DIM - 1)], axis=1)
    idx = torch.from_numpy(cols.astype(np.int32)).to(dev)
    val = torch.ones(idx.shape, device=dev)
    slots = rng.integers(0, ROWS, n)
    unknown = np.where(rng.random(n) < UNKNOWN, -1, slots)

    def as_slots(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    b, pad = SERVE_MAX_BATCH, SERVE_PAD_NNZ - idx.shape[1]
    cases = [("b32", as_slots(unknown[:32]), idx[:32], val[:32], False),
             ("b4096", as_slots(unknown[:4096]), idx[:4096], val[:4096],
              False),
             (f"at_b{b}_k{SERVE_PAD_NNZ}", as_slots(unknown[:b]),
              torch.nn.functional.pad(idx[:b], (0, pad)),
              torch.nn.functional.pad(val[:b], (0, pad)), True),
             (f"b{n}", as_slots(slots), idx, val, False)]
    out = {}
    for name, sl, bi, bv, at in cases:
        for dtype in (torch.float32, torch.float64):
            out[f"{str(dtype).split('.')[1]}_{name}"] = time_paged(
                table.to(dtype), sl, bi, bv.to(dtype), peaks, smi, at=at)

    resident = as_slots(slots)
    padded = (torch.nn.functional.pad(idx, (0, pad)),
              torch.nn.functional.pad(val, (0, pad)))
    diagnostics = {}
    for rows, at in ((32, False), (b, True), (4096, False)):
        bi, bv = padded if at else (idx, val)
        diagnostics[f"cold_{'at_' if at else ''}b{rows}"] = in_turns(
            table, [(resident[s:s + rows], bi[s:s + rows], bv[s:s + rows])
                    for s in range(0, n, rows)], at)
    diagnostics[f"b{n}_one_element"] = in_turns(
        table, [(torch.zeros_like(resident), torch.zeros_like(idx), val)],
        False)
    small = table[:128].contiguous()
    diagnostics[f"b{n}_table_of_128_rows"] = in_turns(
        small, [(resident % small.shape[0], idx, val)], False)
    for name, d in diagnostics.items():
        print(f"{name}: device time per call, previous / new / new / "
              f"previous: {' / '.join(map(_ms, d))} on {smi}")
    result = {"device": smi, "shapes": out,
              "diagnostics_device_ms_previous_new_new_previous": diagnostics}
    print(json.dumps(result))
    return 0


def in_turns(table, batches, at):
    """Device ms per call of the previous design and the new in turns
    (previous, new, new, previous), each call on the next of ``batches``
    ((slots, idx, val) of the float32 ``table``)."""
    from chip_smoke import device_ms
    from photon_ml_tpu_torch.ops.kernels import (
        paged_gather_score, paged_gather_score_at,
        paged_gather_score_previous,
    )

    table_at = torch.tensor([table.data_ptr()], dtype=torch.int64,
                            device=table.device)
    turn = [0]

    def cycle(fn):
        def call():
            sl, bi, bv = batches[turn[0] % len(batches)]
            turn[0] += 1
            return fn(sl, bi, bv)
        return call

    def new(sl, bi, bv):
        if at:
            return paged_gather_score_at(table_at, table, sl, bi, bv)
        return paged_gather_score(table, sl, bi, bv)

    def previous(sl, bi, bv):
        return paged_gather_score_previous(
            table, sl, bi, bv, table_at=table_at if at else None)

    launches = paged_gather_score.launches
    times = [device_ms(cycle(fn), 50)
             for fn in (previous, new, new, previous)]
    paged_gather_score.launches = launches  # by name: not a path
    return times


if __name__ == "__main__":
    sys.exit(main())
