"""Train entry point of the port (the counterpart of the repository's
``train.py``).  Stage 1, reconstruction::

    python -m nerfstyle_torch.train --log-dir logs/synthetic \\
        --data-cfg cfgs/dataset/synthetic.yaml [--device cuda|cpu] [flags]

Stage 2, stylization of a stage-1 checkpoint (only the color hash table is
optimized; ``cfgs/training/style.yaml`` is applied; the style image is an
8-bit PNG or a ``.npy`` array)::

    python -m nerfstyle_torch.train --ckpt <recon.ckpt> --log-dir logs/style \\
        --style-image style.png --style_seg_path style_seg.npz --max_steps 512

Any (nested) config field is a flag (``--num_iterations 300``,
``--intervals.print 50``); flags chain through the dataset, train, network
and renderer configs and must all be consumed.  Runs on ``cuda`` unless
``--device cpu`` is given, and raises without a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import utils
from .config import BaseConfig, ConfigError
from .training.trainer import Trainer, get_trainer

logger = utils.create_logger("train")


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, return the trainer."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, rest = parser.parse_known_args(argv)
    cfg, nargs = BaseConfig.read_nargs(rest)
    try:
        trainer = get_trainer(cfg, nargs, args.device)
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
