"""Port parity of the style losses (``nerfstyle_torch/losses``) against
``nerfstyle_tpu/losses`` on the CPU, inputs drawn in numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.losses import assignment as tasg
from nerfstyle_torch.losses import style as tsl
from nerfstyle_tpu.losses import assignment as jasg
from nerfstyle_tpu.losses import style as jsl

SIZES = np.arange(4, 257)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_torch_cosine_dists_and_centroid_match_jax():
    """cosine_dists rtol 1e-5; compute_centroid exact, NaN for an empty mask."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(37, 12)).astype(np.float32), rng.normal(size=(29, 12)).astype(np.float32)
    np.testing.assert_allclose(tsl.cosine_dists(_t(a), _t(b)).numpy(),
                               np.asarray(jsl.cosine_dists(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    mask = rng.random((13, 17)) < 0.3
    np.testing.assert_allclose(tsl.compute_centroid(_t(mask)).numpy(),
                               np.asarray(jsl.compute_centroid(jnp.asarray(mask))), rtol=1e-6)
    empty = np.zeros((5, 6), bool)
    assert np.isnan(tsl.compute_centroid(_t(empty)).numpy()).all()
    assert np.isnan(np.asarray(jsl.compute_centroid(jnp.asarray(empty)))).all()


@pytest.mark.parametrize("part", range(4))
def test_torch_label_index_laws_match_jax_for_every_size(part):
    """labels_downscale's truncated float32 linspace and _interpolate_nearest's
    floor law give JAX's indices for every (source, target) pair of sizes from
    4 to 256 (target sizes split in four parts).  JAX's linspace runs as the
    package runs it, with a scalar stop (inside lax.map, one compile for a
    part); the floor law with the scale factors as a vector.  The package
    functions themselves on a sample of pairs."""
    ns = [int(n) for n in SIZES[part::4]]
    scales = [(SIZES / n).astype(np.float32) for n in ns]

    @jax.jit
    def laws(stops, scales):
        lin = [jax.lax.map(lambda s, n=n: jnp.linspace(0, s, n).astype(jnp.int32), stops)
               for n in ns]
        near = [jnp.floor(jnp.arange(n)[:, None] * sc[None, :]).astype(jnp.int32)
                for n, sc in zip(ns, scales)]
        return lin, near

    want_lin, want_near = laws(jnp.asarray(SIZES - 1), [jnp.asarray(sc) for sc in scales])
    for n, sc, wl, wn in zip(ns, scales, want_lin, want_near):
        got_lin = np.stack([tsl._linspace_index(int(h), n).numpy() for h in SIZES])
        np.testing.assert_array_equal(got_lin, np.asarray(wl), err_msg=f"linspace, n={n}")
        got_near = torch.floor(torch.arange(n, dtype=torch.float32)[:, None]
                               * torch.from_numpy(sc)[None, :]).to(torch.int64)
        np.testing.assert_array_equal(got_near.numpy(), np.asarray(wn), err_msg=f"nearest, n={n}")
    rng = np.random.default_rng(part)
    for _ in range(2):
        h, w, nh, nw = (int(v) for v in rng.integers(4, 257, size=4))
        labels = rng.integers(0, 1000, size=(h, w)).astype(np.int32)
        np.testing.assert_array_equal(
            tsl.labels_downscale(_t(labels), (nh, nw)).numpy(),
            np.asarray(jsl.labels_downscale(jnp.asarray(labels), (nh, nw))))
        np.testing.assert_array_equal(
            tsl._interpolate_nearest(_t(labels.astype(np.float32)), (nh, nw)).numpy(),
            np.asarray(jsl._interpolate_nearest(jnp.asarray(labels.astype(np.float32)),
                                                (nh, nw))))


def _sem_case(tmp_path, seg):
    rng = np.random.default_rng(3)
    c = 12
    img = rng.normal(size=(1, c, 6, 8)).astype(np.float32)
    sty = rng.normal(size=(1, c, 9, 11)).astype(np.float32)
    preds = rng.integers(0, 3, size=(24, 32)).astype(np.int32)
    path = tmp_path / "seg.npz"
    np.savez(path, seg_map=seg)
    return img, sty, preds, path


@pytest.mark.parametrize("matching", ["none", "hungarian", "given"])
def test_torch_semantic_style_loss_matches_jax(tmp_path, matching):
    """SemanticStyleLoss value (rtol 1e-5) and its gradient in the image
    features (atol 1e-5 of the largest; the masked minimum's gradient splits
    evenly among ties in both), with no segment map, with the Hungarian
    matching, and with a given matching."""
    seg = (np.arange(18)[:, None] // 6 + np.zeros((1, 22), np.int64)).astype(np.int64)  # 3 bands
    img, sty, preds, path = _sem_case(tmp_path, seg)
    kw = {} if matching == "none" else {"clusters_path": path}
    if matching == "given":
        kw["matching"] = [2, 0, 1]
    jl = jsl.get_style_loss("SemanticStyleLoss", "relu3", **kw)
    tl = tsl.get_style_loss("SemanticStyleLoss", "relu3", **kw)
    jl.init_feats({"relu3": jnp.asarray(sty)}, num_classes=3)
    tl.init_feats({"relu3": _t(sty)}, num_classes=3)
    if matching == "hungarian":  # on the host before the step, as both trainers do
        jl.update_matching(jnp.asarray(img[0]), jnp.asarray(preds))
        tl.update_matching(_t(img[0]), _t(preds))
    val_j, g_j = jax.value_and_grad(lambda f: jl({"relu3": f}, None, jnp.asarray(preds)))(
        jnp.asarray(img))
    ft = _t(img).requires_grad_(True)
    val_t = tl({"relu3": ft}, None, _t(preds))
    val_t.backward()
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(g_j)).max())
    if matching != "none":
        np.testing.assert_array_equal(np.asarray(tl.matching), np.asarray(jl.matching))


def test_torch_update_matching_masks_an_absent_cluster(tmp_path):
    """A cluster erased by the nearest downscale (a one-row band) is never
    assigned: both packages remap its class to the cheapest present
    cluster, the same one."""
    seg = np.zeros((40, 22), np.int64)
    seg[20:] = 1
    seg[14] = 2  # one row: the nearest downscale to 9 rows reads rows 0, 4, 8, 13, 17, ...
    img, sty, preds, path = _sem_case(tmp_path, seg)
    jl = jsl.SemanticStyleLoss(["relu3"], clusters_path=path)
    tl = tsl.SemanticStyleLoss(["relu3"], clusters_path=path)
    jl.init_feats({"relu3": jnp.asarray(sty)}, num_classes=3)
    tl.init_feats({"relu3": _t(sty)}, num_classes=3)
    assert not bool((tl.clusters == 2).any())
    jl.update_matching(jnp.asarray(img[0]), jnp.asarray(preds))
    tl.update_matching(_t(img[0]), _t(preds))
    np.testing.assert_array_equal(tl.matching, np.asarray(jl.matching))
    assert 2 not in set(tl.matching.tolist())


def test_torch_gram_adain_nnfm_matting_match_jax():
    """Gram, AdaIN, NNFM and MattingLaplacian values: rtol 1e-4 (fp32 sums in
    another order; the Laplacian inverts 3x3 window covariances)."""
    rng = np.random.default_rng(4)
    f1 = {"relu3": rng.normal(size=(1, 8, 7, 9)).astype(np.float32)}
    f2 = {"relu3": rng.normal(size=(1, 8, 5, 6)).astype(np.float32)}
    jf = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in (("a", f1), ("b", f2))}
    tf = {k: {kk: _t(v) for kk, v in d.items()} for k, d in (("a", f1), ("b", f2))}
    for name in ("GramStyleLoss", "AdaINStyleLoss", "NNFMStyleLoss"):
        want = float(jsl.get_style_loss(name, "relu3")(jf["a"], jf["b"]))
        got = float(tsl.get_style_loss(name, "relu3")(tf["a"], tf["b"]))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
    guide = rng.random((3, 10, 12)).astype(np.float32)
    stylized = rng.random((3, 10, 12)).astype(np.float32)
    want = float(jsl.MattingLaplacian()(jnp.asarray(guide), jnp.asarray(stylized)))
    got = float(tsl.MattingLaplacian()(_t(guide), _t(stylized)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 4), (3, 5), (6, 2), (1, 4), (7, 7)])
def test_torch_hungarian_matches_jax_solver(shape):
    """The port's numpy solver against the JAX package's (native, or scipy)
    on random costs, which have a unique optimum: the same assignment."""
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    for _ in range(20):
        cost = rng.normal(size=shape)
        got, want = tasg.linear_sum_assignment(cost), jasg.linear_sum_assignment(cost)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
