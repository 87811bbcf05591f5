"""Port parity of the image codecs (``nerfstyle_torch/imageio``) behind
``parse_rgb`` and ``save_gif`` against the JAX package's PIL-backed ones on
the CPU.

* Baseline JPEGs written here by PIL (gray, 4:4:4, 4:2:2, 4:2:0; quality 75
  and 95; 37x29 and 64x48; restart markers), read by both packages'
  ``parse_rgb``: bit-equal (the port decodes as libjpeg does under PIL's
  defaults: islow IDCT, fancy upsampling, jdcolor's tables).
* Adam7-interlaced PNGs (PIL writes none: this file's encoder writes them,
  with every row filter; PIL reads them as the reference) and gray + alpha
  PNGs, plain and interlaced: bit-equal.
* A progressive JPEG, a 16-bit PNG and a palette PNG raise, naming why.
* ``save_gif`` of the same frames by both packages, each read back through
  PIL: frame count, size, duration (int(1000 / 3.75) = 266 ms, which GIF
  stores as 26 hundredths: 260 read back) and loop 0 equal; each frame
  within the palette's error of its source (the port: a median-cut palette
  a frame; PIL: its adaptive palette): mean error at most 10/255 and every
  value within 80/255 (on these noisy frames of ~4,700 colours, measured
  8.8/255 and 37/255 for the port, 8.6/255 and 71/255 for PIL), and the
  port's frame of three colours exact.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nerfstyle_torch import utils as tu
from nerfstyle_torch.imageio import gif, jpeg, png
from nerfstyle_tpu import utils as ju


def _picture(w: int, h: int, channels: int, seed: int = 0) -> np.ndarray:
    """A smooth gradient with noise: [h, w, channels] uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([yy, xx, 1 - yy * xx, 0.5 + 0.5 * np.sin(6 * xx)], -1)[..., :channels]
    return (np.clip(base + rng.normal(0, 0.12, base.shape), 0, 1) * 255).astype(np.uint8)


def _pil_jpeg(path, w, h, sampling, quality, **kw):
    gray = sampling == "gray"
    arr = _picture(w, h, 1 if gray else 3)
    im = Image.fromarray(arr[..., 0] if gray else arr, "L" if gray else "RGB")
    im.save(path, "JPEG", quality=quality, **({} if gray else {"subsampling": sampling}), **kw)


@pytest.mark.parametrize("size", [(37, 29), (64, 48)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
def test_torch_jpeg_matches_pil(tmp_path, sampling, quality, size):
    path = tmp_path / "a.jpg"
    _pil_jpeg(path, *size, sampling, quality)
    want, got = ju.parse_rgb(path), tu.parse_rgb(path)
    assert got.shape == want.shape == ((1 if sampling == "gray" else 3), size[1], size[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", ["gray", "4:2:0"])
def test_torch_jpeg_restart_markers_match_pil(tmp_path, sampling):
    """Restart intervals (DRI, RSTn) of 2 blocks' rows, 64x48: bit-equal,
    also resized (the port's bicubic, within 1/255 of PIL's)."""
    path = tmp_path / "a.jpeg"
    _pil_jpeg(path, 64, 48, sampling, 90, restart_marker_blocks=2)
    blob = path.read_bytes()
    assert b"\xff\xdd" in blob and b"\xff\xd0" in blob
    np.testing.assert_array_equal(tu.parse_rgb(path), ju.parse_rgb(path))
    np.testing.assert_allclose(tu.parse_rgb(path, 40), ju.parse_rgb(path, 40), rtol=0,
                               atol=1.0001 / 255)


def test_torch_jpeg_read_by_content_not_suffix(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as what they hold, as PIL
    reads them."""
    _pil_jpeg(tmp_path / "a.png", 37, 29, "4:2:0", 75)
    Image.fromarray(_picture(20, 10, 3)).save(tmp_path / "b.jpg", "PNG")
    for name in ("a.png", "b.jpg"):
        np.testing.assert_array_equal(tu.parse_rgb(tmp_path / name), ju.parse_rgb(tmp_path / name))


def _filter_rows(img: np.ndarray) -> bytes:
    """PNG-filter each row of [h, w, c] uint8, filter type y % 5 (None, Sub,
    Up, Average, Paeth in turn)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        ft = y % 5
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _write_png(path, img: np.ndarray, interlace: bool, depth: int = 8, color_type=None):
    """An 8-bit PNG of [h, w, c] uint8, Adam7-interlaced or not."""
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c] if color_type is None else color_type
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
            sub = img[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(sub)
    else:
        raw = _filter_rows(img)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(png.PNG_SIGNATURE
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                                  int(interlace)))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("size", [(37, 29), (1, 1), (5, 3), (9, 2)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_torch_png_adam7_matches_pil(tmp_path, channels, size):
    """Adam7 PNGs of every 8-bit colour type (gray, gray + alpha, RGB, RGBA),
    including sizes with empty passes: bit-equal to PIL's reading."""
    path = tmp_path / "a.png"
    img = _picture(*size, channels)
    _write_png(path, img, interlace=True)
    with Image.open(path) as im:
        assert im.info.get("interlace") == 1
    np.testing.assert_array_equal(tu.read_png(path), img)
    np.testing.assert_array_equal(tu.parse_rgb(path), ju.parse_rgb(path))


def test_torch_png_gray_alpha_matches_pil(tmp_path):
    """A gray + alpha PNG written by PIL (mode LA, its filters): [2, H, W]
    from both packages, bit-equal."""
    path = tmp_path / "la.png"
    Image.fromarray(_picture(47, 33, 2), "LA").save(path, optimize=True)
    got, want = tu.parse_rgb(path), ju.parse_rgb(path)
    assert got.shape == want.shape == (2, 33, 47)
    np.testing.assert_array_equal(got, want)


def test_torch_unsupported_images_raise(tmp_path):
    """An arithmetic-coded JPEG (a baseline file's SOF0 patched to SOF9), a
    YCCK JPEG (a CMYK file's Adobe transform patched to 2), a 16-bit gray
    PNG and a palette PNG (which PIL reads as I;16 values and palette
    indices) raise ``ValueError`` naming the format."""
    base = tmp_path / "p.jpg"
    _pil_jpeg(base, 37, 29, "4:2:0", 75)
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(base.read_bytes().replace(b"\xff\xc0", b"\xff\xc9", 1))
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        tu.parse_rgb(arith)
    buf = io.BytesIO()
    Image.fromarray(_picture(20, 12, 4), "CMYK").save(buf, "JPEG", quality=90)
    blob = bytearray(buf.getvalue())
    at = blob.index(b"Adobe") - 4  # the APP14 marker, then its length
    assert blob[at + 4 + 11] == 0  # transform 0: CMYK as stored
    blob[at + 4 + 11] = 2
    with pytest.raises(ValueError, match="YCCK JPEG"):
        jpeg.decode_jpeg(bytes(blob))
    sixteen = tmp_path / "s.png"
    Image.fromarray(_picture(20, 10, 1)[..., 0].astype(np.uint16) * 257).save(sixteen)
    with pytest.raises(ValueError, match="bit depth 16"):
        tu.parse_rgb(sixteen)
    pal = tmp_path / "pal.png"
    Image.fromarray(_picture(20, 10, 3)).convert("P", palette=Image.Palette.ADAPTIVE).save(pal)
    with pytest.raises(ValueError, match="palette"):
        tu.parse_rgb(pal)
    blob = bytearray((tmp_path / "p.jpg").read_bytes())
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(bytes(blob[2:]))


def test_torch_jpeg_h1v2_upsampling_is_h2v1_transposed():
    """The vertical triangle filter (4:4:0 chroma, ``jdsample.c``
    h1v2_fancy_upsample, which PIL cannot write) is the horizontal one
    (4:2:2, held against PIL above) on the transposed plane, edges
    included."""
    plane = np.random.default_rng(2).integers(0, 256, size=(7, 5)).astype(np.uint8)
    np.testing.assert_array_equal(jpeg.upsample(plane, 1, 2), jpeg.upsample(plane.T, 2, 1).T)
    assert jpeg.upsample(plane, 1, 2).shape == (14, 5)


def _gif_frames():
    frames = [np.concatenate([_picture(60, 40, 3, seed=k), _picture(60, 40, 3, seed=9)], 1)
              for k in range(3)]
    few = np.zeros_like(frames[0])
    few[5:15, 10:50] = (255, 0, 0)
    few[20:30] = (10, 200, 30)
    return frames + [few]


def test_torch_save_gif_matches_jax_gif(tmp_path):
    frames = _gif_frames()
    tu.save_gif(frames, tmp_path / "port.gif", fps=3.75)
    ju.save_gif(frames, tmp_path / "jax.gif", fps=3.75)
    assert (tmp_path / "port.gif").read_bytes()[:6] == b"GIF89a"
    read = {}
    for name in ("port", "jax"):
        with Image.open(tmp_path / f"{name}.gif") as im:
            info = (im.n_frames, im.size, im.info.get("duration"), im.info.get("loop"))
            got = []
            for k in range(im.n_frames):
                im.seek(k)
                got.append(np.asarray(im.convert("RGB")).astype(np.int64))
        read[name] = info
        for src, g in zip(frames, got):
            err = np.abs(g - src)
            assert err.mean() <= 10 and err.max() <= 80, (name, err.mean(), err.max())
        if name == "port":
            np.testing.assert_array_equal(got[-1], frames[-1])
    assert read["port"] == read["jax"] == (4, (120, 40), 260, 0)


def test_torch_gif_lzw_round_trip():
    """The LZW coder through the 12-bit table's clear: a 300x300 frame of
    random colours from a 256-entry palette decodes (PIL) to its indices."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 256, size=(300, 300)).astype(np.uint8)
    data = gif.lzw_encode(idx)
    blob = (b"GIF89a" + struct.pack("<HHBBB", 300, 300, 0x70, 0, 0)
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, 300, 300, 0x87)
            + bytes(range(256)) * 3 + b"\x08"
            + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                       for i in range(0, len(data), 255)) + b"\x00\x3b")
    with Image.open(io.BytesIO(blob)) as im:
        np.testing.assert_array_equal(np.asarray(im), idx)


def test_torch_committed_style_jpeg_matches_its_pil_array():
    """The style image of ``chip_smoke.py``'s style path
    (tests/data/style.jpg, a 256x192 4:2:0 JPEG written by PIL) and the
    array beside it: PIL's decode equals the array, and so does the port's
    (the card machine, which has no PIL, checks the second)."""
    from pathlib import Path

    data = Path(__file__).resolve().parent / "data"
    want = np.load(data / "style_jpg_pil.npy")
    with Image.open(data / "style.jpg") as im:
        assert im.format == "JPEG" and im.size == (256, 192)
        np.testing.assert_array_equal(np.asarray(im), want)
    np.testing.assert_array_equal(jpeg.read_jpeg(data / "style.jpg"), want)


def test_torch_committed_room_jpeg_matches_pil():
    """The 1008x756 4:2:0 JPEG of the synthetic room (tests/data, written
    by PIL at quality 90) whose decode ``chip_smoke.py`` times on the card
    machine: PIL's decode has the committed SHA256, and so has the
    port's."""
    import hashlib
    from pathlib import Path

    data = Path(__file__).resolve().parent / "data"
    want = (data / "room_1008x756_pil.sha256").read_text().split()[0]
    with Image.open(data / "room_1008x756.jpg") as im:
        assert im.size == (1008, 756)
        assert hashlib.sha256(np.asarray(im).tobytes()).hexdigest() == want
    got = jpeg.read_jpeg(data / "room_1008x756.jpg")
    assert got.shape == (756, 1008, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
