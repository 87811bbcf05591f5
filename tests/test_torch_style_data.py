"""Port parity of the style stage's data path: ``parse_rgb`` (the port's
PNG reader and PIL-equivalent resize) against the JAX package's (PIL),
``SingleImage``, ``collage_h`` and the shuffled pose order."""

import itertools

import numpy as np
import pytest
import torch
from PIL import Image

from nerfstyle_torch import utils as tu
from nerfstyle_torch.config import DatasetConfig
from nerfstyle_torch.core.types import DatasetSplit
from nerfstyle_torch.data import get_dataset
from nerfstyle_torch.data.style import SingleImage
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_tpu import utils as ju
from nerfstyle_tpu.config import DatasetConfig as JDatasetConfig
from nerfstyle_tpu.core.types import DatasetSplit as JDatasetSplit
from nerfstyle_tpu.data import get_dataset as jget_dataset


def _gradient(h=40, w=56):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    return np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32)


@pytest.mark.parametrize("size", [None, 37, 120, (30, 20)])
def test_torch_parse_rgb_matches_jax(tmp_path, size):
    """A PNG the port wrote, read by both packages, as is (equal) and resized
    by the longer edge or to (w, h): torch's antialiased bicubic on the
    8-bit values against PIL's, within 1/255."""
    path = tmp_path / "style.png"
    noisy = np.clip(_gradient() + np.random.default_rng(0).normal(0, 0.05, (40, 56, 3)), 0, 1)
    tu.save_image(noisy.astype(np.float32), path)
    want, got = ju.parse_rgb(path, size), tu.parse_rgb(path, size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=(0 if size is None else 1.0001) / 255)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_torch_read_png_undoes_every_filter(tmp_path, mode):
    """PNGs written by PIL with its filter choice (Sub, Up, Average, Paeth
    rows) read back to the same 8-bit values; .npy reads too; another
    suffix raises naming both formats."""
    rng = np.random.default_rng(1)
    smooth = (np.concatenate([_gradient(33, 47), _gradient(33, 47)[..., :1] * 0.5], -1) * 255)
    for arr in (rng.integers(0, 256, (33, 47, 4)), smooth):
        arr = arr.astype(np.uint8)[..., :{"L": 1, "RGB": 3, "RGBA": 4}[mode]]
        Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(tmp_path / "a.png",
                                                                         optimize=True)
        np.testing.assert_array_equal(tu.read_png(tmp_path / "a.png"), arr)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(tu.parse_rgb(tmp_path / "a.npy"),
                                  np.moveaxis(arr, -1, 0).astype(np.float32) / 255)
    with pytest.raises(ValueError, match=r"\.png.*\.npy"):
        tu.parse_rgb(tmp_path / "a.jpg")


def test_torch_single_image_and_collage_match_jax(tmp_path):
    """SingleImage resizes to the frames' longer edge and cycles; collage_h
    pads the shorter image as the JAX package does."""
    from nerfstyle_tpu.data.style import SingleImage as JSingleImage

    path = tmp_path / "style.png"
    tu.save_image(_gradient(), path)
    ti, ji = SingleImage(path, 64), JSingleImage(path, 64)
    assert len(ti) == 1 and str(ti) == str(ji)
    np.testing.assert_allclose(ti[0], ji[0], rtol=0, atol=1.0001 / 255)
    np.testing.assert_array_equal(ti[5], ti[0])
    a, b = np.random.default_rng(2).random((3, 10, 7)), np.random.default_rng(3).random((3, 6, 4))
    np.testing.assert_array_equal(tu.collage_h(a, b), ju.collage_h(a, b))
    np.testing.assert_array_equal(tu.collage_h(b[None], a), ju.collage_h(b[None], a))


def test_torch_shuffled_pose_order_matches_jax(tmp_path):
    """iter_shuffled_indexed walks the poses in the JAX package's order, pass
    after pass, with the same items."""
    generate_scene(tmp_path / "scene", num_train=5, num_test=1, h=12, w=16)
    cfg = dict(root_path=tmp_path / "scene", type="Synthetic", bound=2.0)
    ts = get_dataset(DatasetConfig(**cfg), DatasetSplit.TRAIN)
    js = jget_dataset(JDatasetConfig(**cfg), JDatasetSplit.TRAIN)
    got = list(itertools.islice(ts.iter_shuffled_indexed(seed=69420), 17))
    want = list(itertools.islice(js.iter_shuffled_indexed(seed=69420), 17))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, (ti, tp)), (_, (ji, jp)) in zip(got, want):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tp, jp)
    assert sorted(i for i, _ in got[:5]) == list(range(5))
    assert isinstance(torch.from_numpy(got[0][1][0]), torch.Tensor)
