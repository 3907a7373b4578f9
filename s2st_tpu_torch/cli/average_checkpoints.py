"""Stage 6: average checkpoints.

Counterpart of ``s2st_tpu/cli/average_checkpoints.py`` (:19-58), with the
same flags: the files of ``--inputs``, or the ``--num-epoch-checkpoints``
highest-numbered ``checkpoint{N}.npz`` of the one directory given (at most
``--checkpoint-upper-bound``), averaged by
``train/checkpoint.py::average_checkpoints`` and written atomically to
``--output``. Host only: numpy on files, no device.

    python -m s2st_tpu_torch.cli.average_checkpoints --inputs ckpt \\
        --num-epoch-checkpoints 15 --output ckpt/checkpoint_last_avg15.npz
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
from pathlib import Path
from typing import List, Optional

from ..train.checkpoint import average_checkpoints, write_npz

logger = logging.getLogger("s2st_tpu_torch.average_checkpoints")


def last_n_checkpoints(paths: List[str], n: int,
                       upper_bound: Optional[int] = None) -> List[str]:
    """The n highest-numbered checkpoint{N}.npz files of one directory,
    highest first."""
    if len(paths) != 1:
        raise ValueError("--num-epoch-checkpoints takes one directory")
    found = []
    for p in Path(paths[0]).iterdir():
        mt = re.fullmatch(r"checkpoint(\d+)\.npz", p.name)
        if mt and (upper_bound is None or int(mt.group(1)) <= upper_bound):
            found.append((int(mt.group(1)), str(p)))
    if len(found) < n:
        raise ValueError(f"Found {len(found)} checkpoint files, need {n}")
    return [p for _, p in sorted(found, reverse=True)[:n]]


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inputs", nargs="+", required=True,
                        help="checkpoint files, or one dir with "
                             "--num-epoch-checkpoints")
    parser.add_argument("--output", required=True)
    parser.add_argument("--num-epoch-checkpoints", type=int, default=None)
    parser.add_argument("--checkpoint-upper-bound", type=int, default=None)
    args = parser.parse_args(argv)
    inputs = args.inputs
    if args.num_epoch_checkpoints is not None:
        inputs = last_n_checkpoints(inputs, args.num_epoch_checkpoints,
                                    args.checkpoint_upper_bound)
    logger.info(f"averaging {len(inputs)} checkpoints")
    write_npz(args.output, average_checkpoints(inputs))
    logger.info(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
