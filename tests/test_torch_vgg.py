"""Port parity of the VGG16 relu3 extractor (``nerfstyle_torch/models/vgg.py``)
against ``nerfstyle_tpu/models/vgg.py`` on the CPU: the JAX extractor's
filters carried over with ``vgg_params_from_numpy``, weight files found and
checked against the manifest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.models import vgg as tv
from nerfstyle_tpu.models import vgg as jv


@pytest.fixture(scope="module")
def jax_fx():
    return jv.VGG16FeatureExtractor(["relu3"])


def _torchvision_layout(params):
    """{features.N.weight/bias} in torchvision's OIHW layout from HWIO params."""
    idxs = [i for block in tv.VGG16_LAYERS[:3] for i in block]
    raw = {}
    for i, (w, b) in zip(idxs, params):
        raw[f"features.{i}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))
        raw[f"features.{i}.bias"] = np.asarray(b)
    return raw


def test_torch_vgg_relu3_and_input_vjp_match_jax(jax_fx):
    """relu3 features of a 32x24 image and their VJP into the image: fp32
    convolutions summed in another order, atol 1e-5 of the largest value
    (rtol 1e-4)."""
    rng = np.random.default_rng(0)
    img = rng.random((3, 24, 32)).astype(np.float32)
    cot = rng.normal(size=(1, 768, 6, 8)).astype(np.float32)
    feats_j, vjp = jax.vjp(lambda x: jax_fx(x)["relu3"], jnp.asarray(img))
    (g_j,) = vjp(jnp.asarray(cot))
    fx = tv.VGG16FeatureExtractor(["relu3"], params=tv.vgg_params_from_numpy(jax_fx.params))
    x = torch.from_numpy(img).requires_grad_(True)
    feats = fx(x)["relu3"]
    (feats * torch.from_numpy(cot)).sum().backward()
    assert tuple(feats.shape) == (1, 768, 6, 8)
    for got, want in ((feats.detach(), feats_j), (x.grad, g_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_torch_vgg_key_grammar(jax_fx):
    """conv/relu keys of a layer or a whole block, as the JAX extractor's;
    an invalid key raises."""
    params = tv.vgg_params_from_numpy(jax_fx.params)
    keys = ["conv1_2", "relu2", "conv3"]
    jfx = jv.VGG16FeatureExtractor(keys)
    fx = tv.VGG16FeatureExtractor(keys, params=params)
    img = np.random.default_rng(1).random((1, 3, 16, 20)).astype(np.float32)
    want, got = jfx(jnp.asarray(img)), fx(torch.from_numpy(img))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(want[k])).max())
    with pytest.raises(ValueError, match="invalid identifier"):
        tv.VGG16FeatureExtractor(["relu6"], params=params)


def test_torch_vgg_weight_files_and_manifest(jax_fx, tmp_path, monkeypatch):
    """The NERFSTYLE_VGG16_WEIGHTS file (.npz, and .pth read with
    torch.load(weights_only=True)) is found, checked against the manifest and
    used; a file with a wrong shape is rejected; with no file anywhere the
    extractor falls back to its fixed-seed filters."""
    raw = _torchvision_layout(jax_fx.params)
    npz = tmp_path / "vgg16.npz"
    np.savez(npz, **raw)
    pth = tmp_path / "vgg16.pth"
    torch.save({k: torch.tensor(v) for k, v in raw.items()}, pth)
    img = torch.from_numpy(np.random.default_rng(2).random((3, 16, 16)).astype(np.float32))
    ref = tv.VGG16FeatureExtractor("relu3", params=tv.vgg_params_from_numpy(jax_fx.params))(img)
    for path in (npz, pth):
        monkeypatch.setenv("NERFSTYLE_VGG16_WEIGHTS", str(path))
        fx = tv.VGG16FeatureExtractor("relu3")
        assert fx.pretrained
        torch.testing.assert_close(fx(img)["relu3"], ref["relu3"], rtol=0, atol=0)
    bad = dict(raw)
    bad["features.12.weight"] = bad["features.12.weight"][:, :64]
    np.savez(tmp_path / "bad.npz", **bad)
    monkeypatch.setenv("NERFSTYLE_VGG16_WEIGHTS", str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="features.12.weight"):
        tv.VGG16FeatureExtractor("relu3")
    monkeypatch.delenv("NERFSTYLE_VGG16_WEIGHTS")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    fx = tv.VGG16FeatureExtractor("relu3")
    assert not fx.pretrained and len(fx.params) == 7
