"""Style images (counterpart of ``nerfstyle_tpu/data/style.py``).

``SingleImage`` is the one style image of a run, resized to the train
frames' longer edge and cycled forever.  The Wikiart corpus, dormant in the
reference, is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from .. import utils


class SingleImage:
    def __init__(self, image_path: Path, longer_edge: Optional[int] = None):
        self.image_name = Path(image_path).name
        self.style_image = utils.parse_rgb(image_path, size=longer_edge)  # [C, H, W]

    def __getitem__(self, _):
        return self.style_image

    def __len__(self):
        return 1

    def __str__(self) -> str:
        return f'single style image "{self.image_name}"'
