"""Train entry point of the port (the counterpart of the repository's
``train.py``).  Stage 1, reconstruction::

    python -m nerfstyle_torch.train --log-dir logs/synthetic \\
        --data-cfg cfgs/dataset/synthetic.yaml [--device cuda|cpu] [flags]

Stage 2, stylization of a stage-1 checkpoint (only the color hash table is
optimized; ``cfgs/training/style.yaml`` is applied; the style image is an
8-bit PNG, a sequential or progressive JPEG or a ``.npy`` array)::

    python -m nerfstyle_torch.train --ckpt <recon.ckpt> --log-dir logs/style \\
        --style-image style.jpg --style_seg_path style_seg.npz --max_steps 512

Any (nested) config field is a flag (``--num_iterations 300``,
``--intervals.print 50``); flags chain through the dataset, train, network
and renderer configs and must all be consumed.  Runs on ``cuda`` unless
``--device cpu`` is given, and raises without a CUDA device.

Data-parallel over rays on several ranks (:mod:`nerfstyle_torch.parallel`),
one process a rank under torchrun::

    torchrun --nproc_per_node 8 -m nerfstyle_torch.train --log-dir logs/synthetic \
        --data-cfg cfgs/dataset/synthetic.yaml [--dist-backend nccl|gloo]

Each rank runs on ``cuda:LOCAL_RANK`` (NCCL, one rank a card, by default;
``--dist-backend gloo`` lets ranks share a card) or, with ``--device cpu``,
on the CPU over gloo.  Without torchrun's variables nothing changes.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import utils
from .config import BaseConfig, ConfigError
from .parallel.mesh import BACKENDS, init_from_env
from .training.trainer import Trainer, get_trainer

# A config error is logged, then raised as SystemExit(1) here.
logger = utils.create_logger("train", exit_on_error=False)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, return the trainer."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--dist-backend", default=None, choices=BACKENDS)
    args, rest = parser.parse_known_args(argv)
    cfg, nargs = BaseConfig.read_nargs(rest)
    mesh = init_from_env(args.device, args.dist_backend)
    try:
        try:
            trainer = get_trainer(cfg, nargs, args.device if mesh is None else mesh.device, mesh)
        except ConfigError as e:
            logger.error("%s", e)
            raise SystemExit(1) from e
        try:
            trainer.run()
        except KeyboardInterrupt:
            pass
        finally:
            trainer.close()
    finally:
        if mesh is not None:
            mesh.close()
    return trainer


if __name__ == "__main__":
    main()
