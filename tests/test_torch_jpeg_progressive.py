"""Progressive and CMYK JPEGs through the port's decoder
(``nerfstyle_torch/imageio/jpeg.py``) against PIL's decode on the CPU.

* Progressive JPEGs written here by PIL (libjpeg's simple progression: DC
  first and refinement scans, AC first scans with end-of-band runs, AC
  refinement scans with correction bits): gray, 4:4:4, 4:2:2 and 4:2:0, at
  37x23 and 201x133 (no multiple of 8 or 16), quality 50 and 95, with
  ``optimize=True``, with restart intervals: bit-equal to
  ``np.asarray(Image.open(f))``, and both packages' ``parse_rgb`` equal.
* CMYK JPEGs (4 components, Adobe transform 0), sequential and
  progressive: PIL's ``[H, W, 4]`` array (PIL inverts the stored samples).
* The committed files ``chip_smoke.py`` reads on the card machine, which
  has no PIL: the progressive room frame against its PIL SHA256, the small
  CMYK JPEG against its PIL array.
* A progressive file cut before its last scan (coefficients left
  incomplete, where libjpeg would block-smooth) raises ``ValueError``.
"""

import hashlib
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerfstyle_torch import utils as tu
from nerfstyle_torch.imageio import jpeg
from nerfstyle_tpu import utils as ju

DATA = Path(__file__).resolve().parent / "data"


def _picture(w: int, h: int, channels: int, seed: int = 0) -> np.ndarray:
    """A smooth gradient with noise: [h, w, channels] uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([yy, xx, 1 - yy * xx, 0.5 + 0.5 * np.sin(6 * xx)], -1)[..., :channels]
    return (np.clip(base + rng.normal(0, 0.12, base.shape), 0, 1) * 255).astype(np.uint8)


def _write(path: Path, sampling: str, size, **kw) -> None:
    channels = {"gray": 1, "cmyk": 4}.get(sampling, 3)
    arr = _picture(*size, channels)
    mode = {1: "L", 3: "RGB", 4: "CMYK"}[channels]
    if channels == 3:
        kw["subsampling"] = sampling
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path, "JPEG", **kw)


def _pil(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        arr = np.asarray(im)
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("coding", [{"quality": 50}, {"quality": 95},
                                    {"quality": 95, "optimize": True}],
                         ids=["q50", "q95", "q95-optimize"])
@pytest.mark.parametrize("size", [(37, 23), (201, 133)])
@pytest.mark.parametrize("sampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
def test_torch_progressive_jpeg_matches_pil(tmp_path, sampling, size, coding):
    path = tmp_path / "p.jpg"
    _write(path, sampling, size, progressive=True, **coding)
    with Image.open(path) as im:
        assert im.info.get("progressive")
    want = _pil(path)
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    np.testing.assert_array_equal(tu.parse_rgb(path), ju.parse_rgb(path))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 3}, {"restart_marker_rows": 1}],
                         ids=["blocks3", "rows1"])
@pytest.mark.parametrize("sampling", ["gray", "4:2:0"])
def test_torch_progressive_jpeg_restart_intervals_match_pil(tmp_path, sampling, restart):
    """Restart intervals in every scan (the DC scans' MCUs, the AC scans'
    blocks of one component): bit-equal, also resized as the style stage
    resizes (the port's bicubic, within 1/255 of PIL's)."""
    path = tmp_path / "r.jpg"
    _write(path, sampling, (201, 133), progressive=True, quality=85, **restart)
    blob = path.read_bytes()
    assert b"\xff\xdd" in blob and b"\xff\xd0" in blob
    np.testing.assert_array_equal(jpeg.read_jpeg(path), _pil(path))
    np.testing.assert_allclose(tu.parse_rgb(path, 64), ju.parse_rgb(path, 64), rtol=0,
                               atol=1.0001 / 255)


@pytest.mark.parametrize("progressive", [False, True])
def test_torch_cmyk_jpeg_matches_pil(tmp_path, progressive):
    path = tmp_path / "c.jpg"
    _write(path, "cmyk", (37, 23), quality=90, progressive=progressive)
    assert b"Adobe" in path.read_bytes()
    want = _pil(path)
    assert want.shape == (23, 37, 4)
    np.testing.assert_array_equal(jpeg.read_jpeg(path), want)
    np.testing.assert_array_equal(tu.parse_rgb(path), ju.parse_rgb(path))


def test_torch_committed_progressive_room_and_cmyk_match_pil():
    """The committed files: PIL's decode of the progressive room frame has
    the SHA256 beside it, and so has the port's; the CMYK file's PIL array
    is the committed ``.npy``, and so is the port's decode."""
    want = (DATA / "room_1008x756_progressive_pil.sha256").read_text().split()[0]
    with Image.open(DATA / "room_1008x756_progressive.jpg") as im:
        assert im.size == (1008, 756) and im.info.get("progressive")
        assert hashlib.sha256(np.asarray(im).tobytes()).hexdigest() == want
    got = jpeg.read_jpeg(DATA / "room_1008x756_progressive.jpg")
    assert got.shape == (756, 1008, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    cmyk = np.load(DATA / "cmyk_48x40_pil.npy")
    assert cmyk.shape == (40, 48, 4)
    np.testing.assert_array_equal(_pil(DATA / "cmyk_48x40.jpg"), cmyk)
    np.testing.assert_array_equal(jpeg.read_jpeg(DATA / "cmyk_48x40.jpg"), cmyk)


def test_torch_progressive_jpeg_with_incomplete_scans_raises(tmp_path):
    """The file's last scan (the luma AC refinement) cut off: its
    coefficients' last bit never arrives, where libjpeg would block-smooth
    the output; the port raises instead."""
    buf = io.BytesIO()
    Image.fromarray(_picture(37, 23, 3)).save(buf, "JPEG", quality=75, progressive=True)
    blob = buf.getvalue()
    cut = blob[:blob.rindex(b"\xff\xda")] + b"\xff\xd9"
    with pytest.raises(ValueError, match="successive approximation incomplete"):
        jpeg.decode_jpeg(cut)
