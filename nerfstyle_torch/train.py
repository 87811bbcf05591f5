"""Train entry point of the port (the counterpart of the repository's
``train.py``, stage 1: reconstruction)::

    python -m nerfstyle_torch.train --log-dir logs/synthetic \\
        --data-cfg cfgs/dataset/synthetic.yaml [--device cuda|cpu] [flags]

Any (nested) config field is a flag (``--num_iterations 300``,
``--intervals.print 50``); flags chain through the dataset, train, network
and renderer configs and must all be consumed.  Runs on ``cuda`` unless
``--device cpu`` is given, and raises without a CUDA device.  The style
stage (``--style-image``) is not ported yet.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import utils
from .config import BaseConfig, ConfigError
from .training.trainer import Trainer

logger = utils.create_logger("train")


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, return the trainer."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, rest = parser.parse_known_args(argv)
    cfg, nargs = BaseConfig.read_nargs(rest)
    try:
        trainer = Trainer(cfg, nargs, args.device)
    except ConfigError as e:
        logger.error("%s", e)
        raise SystemExit(1) from e
    try:
        trainer.run()
    except KeyboardInterrupt:
        pass
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
