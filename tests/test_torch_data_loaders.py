"""Port parity of the dataset layer: the LLFF and Replica loaders of
``nerfstyle_torch.data`` against the JAX package's on the same on-disk
layouts, written with the port's own PNG writer and ``np.savez``.

Both packages divide the same 8-bit bytes by 255, so every array must be
equal bit for bit: frames, poses, segment maps, file names, class count,
intrinsics, bounding box and length.  Only the colour transfer (float64 SVD
and products, numpy in both) is compared within 1e-6.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerfstyle_tpu.config import DatasetConfig as JDatasetConfig, ReplicaConfig as JReplicaConfig
from nerfstyle_tpu.core.types import DatasetSplit as JSplit
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_torch import utils
from nerfstyle_torch.config import DatasetConfig, ReplicaConfig
from nerfstyle_torch.core.types import DatasetSplit
from nerfstyle_torch.data import get_dataset

H, W = 12, 16


def _frame(path: Path, seed: int, channels: int = 3, black: bool = False) -> None:
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=(H, W, channels)).astype(np.float32)
    if black:
        img[:, : W // 2, :3] = 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    utils.save_image(img, path)


def _pose(i: int) -> np.ndarray:
    rng = np.random.default_rng(100 + i)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4)
    pose[:3, :3] = q * np.sign(np.linalg.det(q))
    pose[:3, 3] = rng.uniform(-2, 2, size=3)
    return pose


def write_llff(root: Path, files, channels: int = 3, seg: bool = True,
               ext: str = ".png", **jpeg_kw) -> Path:
    """An LLFF layout: ``files`` (paths under root, no suffix) as train
    frames with seg maps (ids -1..2), three test poses; frames of another
    suffix than .png are JPEGs written by PIL with ``jpeg_kw``."""
    frames = []
    for i, name in enumerate(files):
        rel = name + ext
        if ext == ".png":
            _frame(root / rel, i, channels)
        else:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            rng = np.random.default_rng(i)
            Image.fromarray(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)).save(
                root / rel, "JPEG", **jpeg_kw)
        frames.append({"file_path": rel, "transform_matrix": _pose(i).tolist()})
        if seg:
            rng = np.random.default_rng(50 + i)
            seg_map = rng.integers(-1, 3, size=(H, W))
            seg_map[0, :3] = [0, 1, 2]  # every id present
            (root / "seg").mkdir(parents=True, exist_ok=True)
            np.savez(root / "seg" / f"{Path(name).stem}_seg.npz", seg_map=seg_map)
    meta = {"h": H, "w": W, "fl_x": 14.5, "fl_y": 14.0, "cx": 8.0, "cy": 6.25, "frames": frames}
    (root / "transforms_train.json").write_text(json.dumps(meta))
    test = [{"transform_matrix": _pose(10 + i).tolist()} for i in range(3)]
    (root / "transforms_test.json").write_text(json.dumps({**meta, "frames": test}))
    return root


def write_replica(root: Path, trajs=(1,), n: int = 10, black=()) -> Path:
    for t in trajs:
        seq = root / "office_0" / f"Sequence_{t}"
        mats = []
        for i in range(n):
            _frame(seq / "rgb" / f"rgb_{i}.png", 10 * t + i, black=(t, i) in black)
            mats.append(_pose(10 * t + i).reshape(-1))
        np.savetxt(seq / "traj_w_c.txt", np.stack(mats))
    return root


def _cfgs(root: Path, kind: str, **kw):
    replica = kw.pop("replica", None)
    common = dict(type=kind, root_path=root, bound=1.5, scale=0.33, seg_name="seg", **kw)
    j = JDatasetConfig(**common, replica_cfg=JReplicaConfig(**replica) if replica else None)
    t = DatasetConfig(**common, replica_cfg=ReplicaConfig(**replica) if replica else None)
    return j, t


def assert_same_dataset(jd, td):
    assert type(td).__name__ == type(jd).__name__
    assert len(td) == len(jd)
    assert td.fns == jd.fns
    assert td.has_gt == jd.has_gt and td.num_classes == jd.num_classes
    assert td.intr.asdict() == jd.intr.asdict()
    for a, b in zip(td.bbox, jd.bbox):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in ("poses", "images", "seg_groups"):
        got, want = getattr(td, name), getattr(jd, name)
        assert (got is None) == (want is None), name
        if want is not None:
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    for i in range(len(jd)):
        (ti, tp), (ji, jp) = td[i], jd[i]
        np.testing.assert_array_equal(tp, jp)
        assert (ti is None) == (ji is None)
        if ji is not None:
            np.testing.assert_array_equal(ti, ji)


def _load(jcfg, tcfg, split, max_count=None):
    jd = jget_dataset(jcfg, split=JSplit[split], max_count=max_count)
    td = get_dataset(tcfg, split=DatasetSplit[split], max_count=max_count)
    return jd, td


LLFF_FILES = [f"images_8/image{i:03d}" for i in range(5)]


@pytest.mark.parametrize("split, max_count", [
    ("TRAIN", None), ("TEST", None), ("TRAIN", 3), ("TEST", 2), ("TRAIN", 5)])
def test_torch_llff_matches_jax(tmp_path, split, max_count):
    root = write_llff(tmp_path / "room", LLFF_FILES)
    jd, td = _load(*_cfgs(root, "LLFF"), split, max_count)
    assert_same_dataset(jd, td)
    if split == "TRAIN":
        assert td.num_classes == 3 and td.seg_groups.min() == -1  # the -1 pixels stay
        assert td[0][0].shape == (4, H, W)
        assert len(td) == (max_count or 5)
    else:
        assert not td.has_gt and td.fns[0].startswith("frame_")


def test_torch_llff_duplicate_stems_take_the_parent(tmp_path):
    root = write_llff(tmp_path / "room", ["a/img", "b/img", "c/other"], seg=False)
    jd, td = _load(*_cfgs(root, "LLFF"), "TRAIN")
    assert_same_dataset(jd, td)
    assert td.fns == ["a_img", "b_img", "c_other"] and td.num_classes == 0


def test_torch_llff_rgba_frames_go_on_white(tmp_path):
    root = write_llff(tmp_path / "room", LLFF_FILES[:3], channels=4)
    jd, td = _load(*_cfgs(root, "LLFF"), "TRAIN")
    assert_same_dataset(jd, td)
    assert td.images.shape[1] == 3


def test_torch_llff_without_every_seg_map_has_no_classes(tmp_path):
    root = write_llff(tmp_path / "room", LLFF_FILES[:3])
    (root / "seg" / "image001_seg.npz").unlink()
    jd, td = _load(*_cfgs(root, "LLFF"), "TRAIN")
    assert_same_dataset(jd, td)
    assert td.seg_groups is None and td.num_classes == 0


def test_torch_llff_colour_transfer_matches_jax(tmp_path):
    root = write_llff(tmp_path / "room", LLFF_FILES[:3])
    style = tmp_path / "style.png"
    yy, xx = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 11), indexing="ij")
    utils.save_image(np.stack([yy, 0.5 * xx, 1 - yy], -1), style)
    jcfg, tcfg = _cfgs(root, "LLFF", ct_image=style)
    jd, td = _load(jcfg, tcfg, "TRAIN")
    assert td.images.dtype == np.float32
    np.testing.assert_allclose(td.images, np.asarray(jd.images), rtol=0, atol=1e-6)
    jd.images = td.images.copy()  # the rest bit for bit
    assert_same_dataset(jd, td)


def test_torch_colour_transfer_matches_jax():
    from nerfstyle_tpu import utils as jutils

    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, size=(2, 5, 7, 3)).astype(np.float32)
    style = rng.uniform(0, 1, size=(6, 4, 3)).astype(np.float32) ** 2
    got, got_tf = utils.match_colors_for_image_set(images, style)
    want, want_tf = jutils.match_colors_for_image_set(images, style)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_tf, want_tf)


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_torch_llff_jpeg_frames_raise(tmp_path, sampling):
    """JPEG frames: baseline and progressive ones load bit-equal to the JAX
    loader's (PIL's decode); an arithmetic-coded one (a progressive frame's
    SOF2 marker patched to SOF10: no Pillow writes them) raises naming the
    format."""
    root = write_llff(tmp_path / "room", LLFF_FILES[:3], ext=".jpg", quality=80,
                      subsampling=sampling)
    for split in ("TRAIN", "TEST"):
        assert_same_dataset(*_load(*_cfgs(root, "LLFF"), split))
    root = write_llff(tmp_path / "prog", LLFF_FILES[:2], ext=".jpg", progressive=True,
                      subsampling=sampling)
    assert_same_dataset(*_load(*_cfgs(root, "LLFF"), "TRAIN"))
    frame = root / (LLFF_FILES[1] + ".jpg")
    frame.write_bytes(frame.read_bytes().replace(b"\xff\xc2", b"\xff\xca", 1))
    _, tcfg = _cfgs(root, "LLFF")
    with pytest.raises(ValueError, match="arithmetic-coded progressive JPEG"):
        get_dataset(tcfg, split=DatasetSplit.TRAIN)


def _wikiart(root: Path) -> Path:
    """A Wikiart train split of JPEGs (three colour, one gray, sizes that
    are not square), as JAX's own test writes them."""
    d = root / "train"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 50), (33, 61), (64, 48)]):
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(
            d / f"img{i}.jpg", quality=85)
    Image.fromarray(rng.integers(0, 256, size=(30, 44), dtype=np.uint8), "L").save(
        d / "img3.jpg")
    (d / "notes.png").write_bytes(b"not listed")
    return root


@pytest.mark.parametrize("kw", [dict(crop_size=32), dict(crop_size=24, seed=3, max_images=3),
                                dict(crop_size=16, fix_id=1)])
def test_torch_wikiart_matches_jax(tmp_path, kw):
    """WikiartDataset against JAX's class on the same JPEGs: the listing,
    length and name equal; two passes of seeded crops (the same draws in
    the same order: crop corners and sides equal), each within 1/255 (the
    port's bicubic resize against PIL's; the decode is bit-equal)."""
    from nerfstyle_torch.data.style import WikiartDataset
    from nerfstyle_tpu.data.style import WikiartDataset as JWikiartDataset

    root = _wikiart(tmp_path / "wikiart")
    td = WikiartDataset(root, DatasetSplit.TRAIN, **kw)
    jd = JWikiartDataset(root, JSplit.TRAIN, **kw)
    assert [p.name for p in td.paths] == [p.name for p in jd.paths]
    assert len(td) == len(jd) and str(td) == str(jd)
    for i in list(range(len(td))) * 2:
        got, want = td[i], jd[i]
        assert got.shape == want.shape == (3, kw["crop_size"], kw["crop_size"])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0001 / 255)


REPLICA = dict(name="office_0", focal_ratio=0.75, traj_ids=[1])


@pytest.mark.parametrize("split, max_count", [("TRAIN", None), ("TEST", None), ("TRAIN", 4)])
def test_torch_replica_matches_jax(tmp_path, split, max_count):
    root = write_replica(tmp_path / "replica", n=17)
    jd, td = _load(*_cfgs(root, "Replica", replica=REPLICA), split, max_count)
    assert_same_dataset(jd, td)
    assert td.intr.fx == td.intr.fy == W * 0.75 and (td.intr.w, td.intr.h) == (W, H)
    if split == "TEST":
        assert len(td) == 3  # frames 0, 8, 16


@pytest.mark.parametrize("split", ["TRAIN", "TEST"])
def test_torch_replica_two_trajectories_keep_jax_file_names(tmp_path, split):
    """Every frame's parent directory is ``rgb``, so the prefixed names of
    two trajectories still collide, in both packages."""
    root = write_replica(tmp_path / "replica", trajs=(1, 2), n=9)
    cfgs = _cfgs(root, "Replica", replica={**REPLICA, "traj_ids": [2, 1]})
    jd, td = _load(*cfgs, split)
    assert_same_dataset(jd, td)
    if split == "TRAIN":  # the test split (frames 0, 8, 16) has distinct stems
        assert len(td) == 15 and len(set(td.fns)) == 9
    else:
        assert td.fns == ["rgb_0", "rgb_8", "rgb_7"]


def test_torch_replica_black2white_and_seg_maps(tmp_path):
    root = write_replica(tmp_path / "replica", n=9, black={(1, 1), (1, 8)})
    (root / "seg").mkdir()
    rng = np.random.default_rng(0)
    train_fns = [f"rgb_{i}" for i in range(1, 8)]
    for fn in train_fns:
        np.savez(root / "seg" / f"{fn}_seg.npz", seg_map=rng.integers(0, 2, size=(H, W)))
    replica = {**REPLICA, "black2white": True}
    for split in ("TRAIN", "TEST"):
        jd, td = _load(*_cfgs(root, "Replica", replica=replica), split)
        assert_same_dataset(jd, td)
    assert td.images[1, :, :, : W // 2].min() == 1.0  # frame 8, the second test frame
    jd, td = _load(*_cfgs(root, "Replica", replica=replica), "TRAIN")
    assert td.num_classes == 2 and td.images[0, :, :, : W // 2].min() == 1.0


@pytest.mark.parametrize("shape, channels", [((7, 5), 3), ((1, 300), 4), ((40, 2), 1)])
def test_torch_png_size_reads_the_header(tmp_path, shape, channels):
    path = tmp_path / "x.png"
    utils.save_image(np.zeros((*shape, channels), np.float32), path)
    with Image.open(path) as im:
        assert utils.png_size(path) == im.size == shape[::-1]
