"""``python -m nerfstyle_torch.render <ckpt> [--out-dims W H] [--max-count N]
[--device cuda|cpu] [--yes]`` (see :mod:`nerfstyle_torch.render.cli`)."""

from .cli import main

if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        pass
