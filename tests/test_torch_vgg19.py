"""Port parity of ``VGG19FeatureExtractor`` against the JAX package's on the
CPU, with JAX's fallback filters carried over (``vgg_params_from_numpy``):
the convolutions are summed in another order, so every key is held within
1e-5 of its largest value (rtol 1e-4), as ``tests/test_torch_vgg.py`` holds
VGG16."""

import jax.numpy as jnp
import numpy as np
import torch

from nerfstyle_torch.models import vgg as tv
from nerfstyle_tpu.models import vgg as jv


def test_torch_vgg19_fallback_filters_match_jax_every_key():
    """VGG19 without weights: JAX's fallback filters carried over, every
    ``convN_M`` key (and the block keys) of a 32x32 image within 1e-5 of
    each key's largest value; the port's own fallback loads and runs; the
    manifest's vgg19 entry lists every conv layer of VGG19_LAYERS."""
    keys = [f"conv{b + 1}_{i + 1}" for b, blk in enumerate(tv.VGG19_LAYERS)
            for i in range(len(blk))]
    jfx = jv.VGG19FeatureExtractor(keys + ["relu5"])
    assert not jfx.pretrained
    fx = tv.VGG19FeatureExtractor(keys + ["relu5"], params=tv.vgg_params_from_numpy(jfx.params))
    img = np.random.default_rng(8).random((1, 3, 32, 32)).astype(np.float32)
    want, got = jfx(jnp.asarray(img)), fx(torch.from_numpy(img))
    assert len(keys) == 16 and set(got) == set(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    own = tv.VGG19FeatureExtractor(["conv3_4"])
    assert not own.pretrained and own(torch.from_numpy(img))["conv3_4"].shape == (1, 256, 8, 8)
    arrays = tv.load_manifest("vgg19")["arrays"]
    assert {f"features.{i}.weight" for blk in tv.VGG19_LAYERS for i in blk} <= set(arrays)
