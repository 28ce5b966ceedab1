"""Feature indexing driver: build a feature index map from Avro data
(counterpart of ``photon_ml_tpu/cli/feature_indexing_driver.py``; host
only, no device).

Equivalent of the reference's ``index.FeatureIndexingDriver`` (the dedicated
Spark job that builds PalDB index maps — SURVEY.md §3.3). Output is a JSON
index map, or with ``--store-format paldb`` the native store of
``io/paldb.py``, loadable by the training and scoring drivers of either
package.

Usage:
    python -m photon_ml_tpu_torch.cli.feature_indexing_driver \\
        --data data/train.avro --output index-map.json
"""

from __future__ import annotations

import argparse
from typing import Sequence

from photon_ml_tpu_torch.io.avro import iter_avro_records
from photon_ml_tpu_torch.io.index_map import build_index_map
from photon_ml_tpu_torch.utils import PhotonLogger


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Feature indexing driver "
                                            "(PyTorch port)")
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--output", required=True, help="index map output path")
    p.add_argument("--store-format", default="json", choices=["json", "paldb"],
                   help="json: human-readable; paldb: native mmap store "
                        "(the reference's PalDB role, zero load time)")
    p.add_argument("--min-feature-count", type=int, default=1)
    p.add_argument("--add-intercept", action="store_true", default=True)
    p.add_argument("--no-intercept", dest="add_intercept", action="store_false")
    return p


def main(argv: Sequence[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    logger = PhotonLogger(None)
    imap = build_index_map(
        iter_avro_records(args.data),
        add_intercept=args.add_intercept,
        min_count=args.min_feature_count,
    )
    if args.store_format == "paldb":
        from photon_ml_tpu_torch.io.paldb import build_store

        build_store(imap.forward, args.output)
    else:
        imap.save(args.output)
    logger.log("index_map_built", num_features=imap.size, output=args.output,
               store_format=args.store_format)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
