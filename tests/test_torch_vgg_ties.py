"""The VGG16 extractor's input gradient at ties, layer by layer, against
the JAX package's extractor on the CPU (``nerfstyle_torch/models/vgg.py``,
the JAX filters carried over with ``vgg_params_from_numpy``).

The planted-tie frame (32x24): a white background, whose features are
equal across it (every 2x2 window of a pool is a tie); a band of the
ImageNet mean, which normalizes to exactly 0, so that with the fallback
filters' zero biases conv1_1 and the layers below it have exactly-zero
pre-activations; and a noisy patch whose 2x2 windows repeat one pixel.
JAX's ReLU, ``jnp.maximum(x, 0)``, passes half the gradient at an exact 0
and XLA routes a pool tie's gradient to the window's first element; the
port's extractor does both (``_Relu``; ``max_pool2d`` picks the first
largest), so every layer's VJP into the frame agrees to fp32 sum order
(1e-5 of its largest entry).  With ``torch.relu`` (gradient 0 at 0) the
gradient departs at relu1_1 already.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.models import vgg as tv
from nerfstyle_tpu.models import vgg as jv

H, W = 24, 32
KEYS = [f"{op}{b + 1}_{i + 1}" for b, blk in enumerate(tv.VGG16_LAYERS[:3])
        for i in range(len(blk)) for op in ("conv", "relu")]


def planted_tie_frame() -> np.ndarray:
    """[3, H, W] float32 (see the module docstring)."""
    rng = np.random.default_rng(0)
    img = np.ones((3, H, W), np.float32)
    img[:, :, :10] = np.asarray(tv._IMAGENET_MEAN, np.float32)[:, None, None]
    patch = rng.random((3, 6, 8)).astype(np.float32)
    img[:, 8:20, 12:28] = np.repeat(np.repeat(patch, 2, axis=1), 2, axis=2)
    return img


@pytest.fixture(scope="module")
def extractors():
    jfx = jv.VGG16FeatureExtractor(KEYS)
    return jfx, tv.VGG16FeatureExtractor(KEYS, params=tv.vgg_params_from_numpy(jfx.params))


def _cotangents(feats) -> dict:
    rng = np.random.default_rng(1)
    return {k: rng.normal(size=np.asarray(feats[k]).shape).astype(np.float32) for k in KEYS}


@pytest.fixture(scope="module")
def jax_grads(extractors):
    """JAX's VJP into the planted-tie frame of each layer's features for a
    seeded cotangent (one linearization, every layer's cotangent in turn)."""
    jfx, _ = extractors
    feats, vjp = jax.vjp(jfx, jnp.asarray(planted_tie_frame()))
    cots = _cotangents(feats)
    zeros = {k: np.zeros_like(v) for k, v in cots.items()}
    return {key: np.asarray(vjp({**zeros, key: cots[key]})[0]) for key in KEYS}


def _port_grads(fx, keys):
    """The port's VJPs as in :func:`jax_grads`, for ``keys``."""
    x = torch.from_numpy(planted_tie_frame()).requires_grad_(True)
    feats = fx(x)
    cots = _cotangents({k: v.detach() for k, v in feats.items()})
    return {key: torch.autograd.grad((feats[key] * torch.from_numpy(cots[key])).sum(), x,
                                     retain_graph=True)[0].numpy() for key in keys}


def test_torch_vgg_planted_frame_has_ties(extractors):
    """The frame plants what it says: exact-zero pre-activations at conv1_1
    to conv2_2 (in both packages alike), and pool windows of equal values
    (relu1_2's white background and repeated patch)."""
    jfx, fx = extractors
    img = planted_tie_frame()
    feats = fx(torch.from_numpy(img))
    for key in ("conv1_1", "conv1_2", "conv2_1", "conv2_2"):
        pre = feats[key].numpy()
        assert (pre == 0).sum() > 1000, key
        np.testing.assert_array_equal(pre == 0, np.asarray(jfx(jnp.asarray(img))[key]) == 0)
    r = feats["relu1_2"][0].numpy()
    win = r.reshape(64, H // 2, 2, W // 2, 2).transpose(0, 1, 3, 2, 4).reshape(64, -1, 4)
    tie = (win == win.max(-1, keepdims=True)).sum(-1) > 1
    assert (tie & (win.max(-1) > 0)).sum() > 1000


@pytest.fixture(scope="module")
def port_grads(extractors):
    return _port_grads(extractors[1], KEYS)


@pytest.mark.parametrize("key", KEYS)
def test_torch_vgg_tie_gradients_match_jax(jax_grads, port_grads, key):
    """The VJP into the planted-tie frame of each layer's features (a
    seeded cotangent) against JAX's, atol 1e-5 of the largest entry."""
    want = jax_grads[key]
    np.testing.assert_allclose(port_grads[key], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_torch_vgg_relu_gradient_at_zero_is_jax(extractors, jax_grads, monkeypatch):
    """The fault the ReLU repairs: with ``torch.relu`` (gradient 0 at an
    exact 0) relu1_1's VJP departs from JAX's by more than a tenth of its
    largest entry on this frame; ``vgg.relu`` passes half the gradient at 0
    and exactly all of it (or none) elsewhere."""
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    tv.relu(x).backward(torch.ones(3))
    assert x.grad.tolist() == [0.0, 0.5, 1.0]
    monkeypatch.setattr(tv, "relu", torch.relu)
    got, want = _port_grads(extractors[1], ["relu1_1"])["relu1_1"], jax_grads["relu1_1"]
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()
