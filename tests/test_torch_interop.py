"""Port parity of the reference-checkpoint interop: Morton codes and their
inverse (plain K8b), bit packing (plain K8a) and the occupancy layout
conversion against the JAX package, bit for bit; then the importer, ``python
-m nerfstyle_torch.import_reference``, against the JAX package's
``tools/import_reference_ckpt.py`` on the same synthetic reference ``.pth``
(built as tests/test_import_reference_ckpt.py builds it), leaf for leaf, and
a frame rendered from its output.  Kernels K8a and K8b are held against the
plain versions in tests/test_torch_kernels.py.
"""

import sys
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu import interop as jinterop
from nerfstyle_tpu.data.synthetic import generate_scene
from nerfstyle_tpu.models.fields import field_init, make_grid_spec, style_field_spec
from nerfstyle_tpu.ops import morton as jmorton
from nerfstyle_tpu.ops import occupancy as jocc
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_torch import import_reference, interop, kernels
from nerfstyle_torch.ops import morton as tmorton
from nerfstyle_torch.ops import occupancy as tocc
from nerfstyle_torch.render import cli as render_cli

REPO = Path(__file__).resolve().parent.parent
GRID, CASCADE = 16, 2
_FAKE_MOD = "reference_cfg_module_for_port_import"


def test_torch_morton_matches_jax():
    rng = np.random.default_rng(0)
    coords = np.concatenate([rng.integers(0, 1024, size=(5000, 3)),
                             np.asarray(tocc.all_cell_coords(GRID))]).astype(np.int32)
    want = np.asarray(jmorton.morton3d(jnp.asarray(coords)))
    got = tmorton.morton3d(torch.from_numpy(coords))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    codes = np.concatenate([rng.integers(0, 2**30, size=5000),
                            np.arange(GRID**3)]).astype(np.int32)
    want_c = np.asarray(jmorton.morton3d_invert(jnp.asarray(codes)))
    got_c = tmorton.morton3d_invert(torch.from_numpy(codes))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(tmorton.morton3d_invert(got).numpy(), coords)


def test_torch_packbits_matches_jax():
    bits = np.random.default_rng(1).random(CASCADE * GRID**3) < 0.3
    want = np.asarray(jocc.packbits(jnp.asarray(bits)))
    got = tocc.packbits(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tocc.unpackbits(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jocc.unpackbits(jnp.asarray(want))))
    assert torch.equal(back, torch.from_numpy(bits))


def _k8a_unpack(packed: np.ndarray) -> np.ndarray:
    """K8a unpack's word layout (csrc/interop.cu) in numpy: a 16-cell unit
    from a little-endian 2-byte word, 4 bits a multiply-and-mask into 4
    bytes; an odd last byte an 8-cell unit."""
    def spread(x):
        return (x * np.uint32(0x00204081)) & np.uint32(0x01010101)
    nu = packed.size // 2
    words = packed[:2 * nu].copy().view("<u2").astype(np.uint32)
    quads = spread((words[:, None] >> (np.uint32(4) * np.arange(4, dtype=np.uint32))) & 0xF)
    cells = [quads.astype("<u4").view(np.uint8).reshape(-1)]
    if packed.size % 2:
        last = np.uint32(packed[-1])
        cells.append(spread(np.array([last & 0xF, last >> 4], np.uint32)).astype("<u4")
                     .view(np.uint8))
    return np.concatenate(cells).astype(bool)


def _k8a_pack(bits: np.ndarray) -> np.ndarray:
    """K8a pack's word layout: 16 bool bytes as 4 little-endian words, each
    masked and folded to 4 bits by one multiply, the unit's 16 bits a
    little-endian 2-byte word; an 8-cell tail one byte."""
    def nibble(x):
        return (((x & np.uint32(0x01010101)) * np.uint32(0x01020408)) >> np.uint32(24)) & 0xF
    b = bits.astype(np.uint8)
    nu = b.size // 16
    quads = nibble(b[:16 * nu].copy().view("<u4").astype(np.uint32).reshape(nu, 4))
    words = np.bitwise_or.reduce(quads << (np.uint32(4) * np.arange(4, dtype=np.uint32)), axis=1)
    out = [words.astype("<u2").view(np.uint8)]
    if b.size % 16:
        q = nibble(b[16 * nu:].copy().view("<u4").astype(np.uint32))
        out.append(np.array([q[0] | q[1] << 4], np.uint8))
    return np.concatenate(out)


@pytest.mark.parametrize("k", [8, 24, 16 * 1001 + 8, CASCADE * GRID**3])
def test_torch_packbits_kernel_word_layout_matches_jax(k):
    """The kernel's unit layout, emulated, equals JAX's LSB-first packing
    both ways, at K of one byte, an odd byte count (an 8-cell tail) and
    the grid's size."""
    bits = np.random.default_rng(k).random(k) < 0.4
    want = np.asarray(jocc.packbits(jnp.asarray(bits)))
    np.testing.assert_array_equal(_k8a_pack(bits), want)
    np.testing.assert_array_equal(_k8a_unpack(want), bits)


def test_torch_occupancy_layout_conversion_matches_jax():
    rng = np.random.default_rng(2)
    grid = rng.normal(size=(CASCADE, GRID**3)).astype(np.float32)
    bits = grid.reshape(-1) > 0.5
    kernels.reset_launch_counts()
    mor = interop.linear_grid_to_morton(torch.from_numpy(grid), GRID)
    np.testing.assert_array_equal(
        mor.numpy(), np.asarray(jinterop.linear_grid_to_morton(jnp.asarray(grid), GRID)))
    packed = interop.linear_bitfield_to_reference(torch.from_numpy(bits), GRID)
    want_g, want_b = jinterop.import_reference_grid_state(mor.numpy(), packed.numpy(), GRID)
    got_g, got_b = interop.import_reference_grid_state(mor.numpy(), packed.numpy(), GRID)
    assert not any(kernels.launch_counts.values())
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_g.numpy(), grid)
    np.testing.assert_array_equal(got_b.numpy(), bits)
    with pytest.raises(ValueError):
        interop.morton_grid_to_linear(torch.zeros(24**3), 24)


def _stub_cfg(**fields):
    """An object whose class lives in a module absent at unpickle time."""
    mod = sys.modules.get(_FAKE_MOD)
    if mod is None:
        mod = types.ModuleType(_FAKE_MOD)
        sys.modules[_FAKE_MOD] = mod
    cls = getattr(mod, "FakeCfg", None)
    if cls is None:
        cls = type("FakeCfg", (), {"__module__": _FAKE_MOD})
        mod.FakeCfg = cls
    obj = cls()
    obj.__dict__.update(fields)
    return obj


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A synthetic reference checkpoint: config objects of an unimportable
    module, a JAX field's tables, Morton-ordered packed occupancy, and the
    heads exported layer-wise."""
    tmp = tmp_path_factory.mktemp("port_import")
    scene = tmp / "scene"
    generate_scene(scene, num_train=3, num_test=1, h=24, w=32)
    bound, n_lvls, hashmap_size = 2.0, 4, 11
    grid_spec = make_grid_spec(n_lvls=n_lvls, n_feats_per_lvl=2, hashmap_size=hashmap_size,
                               min_res=16, max_res_coeff=8, max_bound=2 * bound)
    spec = style_field_spec(grid_spec, class_dim=4, use_dir=False, sh_degree=4,
                            density_hidden_dims=64, density_hidden_layers=1,
                            rgb_hidden_dims=64, rgb_hidden_layers=2)
    params = field_init(jax.random.PRNGKey(3), spec)
    rng = np.random.default_rng(7)
    lin_grid = np.abs(rng.normal(size=(CASCADE, GRID**3))).astype(np.float32)
    lin_bits = lin_grid.reshape(-1) > 0.8
    mor_grid = np.asarray(jinterop.linear_grid_to_morton(jnp.asarray(lin_grid), GRID))
    mor_bits = np.asarray(jinterop.linear_grid_to_morton(
        jnp.asarray(lin_bits.reshape(CASCADE, -1)), GRID)).reshape(-1)
    packed = np.asarray(jocc.packbits(jnp.asarray(mor_bits)))
    pos_enc = _stub_cfg(n_lvls=n_lvls, n_feats_per_lvl=2, hashmap_size=hashmap_size, min_res=16,
                        max_res_coeff=8)
    state = {
        "version": "ref-fixture", "log_dir": str(tmp / "logs"), "iter_ctr": 60,
        "cfg": _stub_cfg(style_image=None),
        "dataset_cfg": _stub_cfg(root_path=str(scene), type="Synthetic", bound=bound, scale=1.0),
        "train_cfg": _stub_cfg(num_iterations=100, num_rays_per_batch=128),
        "net_cfg": _stub_cfg(pos_enc=pos_enc, dir_enc_sh_deg=4, density_hidden_dims=64,
                             density_hidden_layers=1, rgb_hidden_dims=64, rgb_hidden_layers=2,
                             network_seed=3),
        "render_cfg": _stub_cfg(grid_size=GRID, max_steps=64, update_thres=16, min_near=0.2),
        "renderer": {
            "model": {
                "x_density_embedder.embeddings":
                    torch.from_numpy(np.array(params["x_density_embedder"])),
                "x_color_embedder.embeddings":
                    torch.from_numpy(np.array(params["x_color_embedder"])),
                **{f"{net}.params": torch.zeros(16) for net in import_reference.HEADS},
            },
            "intr": None, "precrop_frac": 1.0, "raymarch_channels": 3 + 4, "bound": bound,
            "density_grid": torch.from_numpy(np.array(mor_grid)),
            "density_bitfield": torch.from_numpy(packed.astype(np.uint8)),
            "step_counter": torch.zeros(1, dtype=torch.int32),
            "local_step": 37, "mean_count": 4211, "mean_density": 0.125,
        },
        "optim": {"state": {}},
    }
    pth = tmp / "iter_060.pth"
    torch.save(state, pth)
    del sys.modules[_FAKE_MOD]  # the config classes cannot be imported, as a real run's
    npz = tmp / "heads.npz"
    np.savez(npz, **{f"{net}.{i}": np.asarray(w) for net in import_reference.HEADS
                     for i, w in enumerate(params[net])})
    return dict(tmp=tmp, pth=pth, npz=npz, scene=scene, lin_grid=lin_grid, lin_bits=lin_bits,
                params=params)


def test_torch_importer_matches_jax_tool(reference_pth, monkeypatch):
    """The port's importer and the JAX tool on the same .pth: equal meta and
    equal params, occ and ema leaves; the occupancy is the source's, linear."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import import_reference_ckpt as jtool
    finally:
        sys.path.remove(str(REPO / "tools"))
    r = reference_pth
    common = [str(r["pth"]), "--mlp-npz", str(r["npz"]), "--root-path", str(r["scene"])]
    j_out, t_out = r["tmp"] / "jax.ckpt", r["tmp"] / "port.ckpt"
    monkeypatch.setattr(sys, "argv", ["import_reference_ckpt.py", *common, "--out", str(j_out)])
    assert jtool.main() == 0
    kernels.reset_launch_counts()
    assert import_reference.main([*common, "--out", str(t_out), "--device", "cpu"]) == t_out
    assert not any(kernels.launch_counts.values())
    j_meta, j_groups = jckpt.load_checkpoint(j_out)
    t_meta, t_groups = jckpt.load_checkpoint(t_out)
    for k in ("iter_ctr", "dataset_cfg", "train_cfg", "net_cfg", "render_cfg", "cfg",
              "imported_mlp_heads", "version"):
        assert t_meta[k] == j_meta[k], k
    assert t_meta["imported_mlp_heads"] == list(import_reference.HEADS)
    assert set(t_groups) == set(j_groups) == {"params", "occ", "ema"}
    for group in t_groups:
        assert len(t_groups[group]) == len(j_groups[group]), group
        for a, b in zip(t_groups[group], j_groups[group]):
            assert a.dtype == b.dtype and a.shape == b.shape, group
            np.testing.assert_array_equal(a, b, err_msg=group)
    occ = t_groups["occ"]
    assert len(occ) == 5
    np.testing.assert_array_equal(occ[0], r["lin_grid"])
    np.testing.assert_array_equal(occ[1], r["lin_bits"])
    assert (int(occ[3]), int(occ[4])) == (4211, 37)
    for a, b in zip(t_groups["params"], jax.tree_util.tree_leaves(r["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_torch_renders_from_imported_checkpoint(reference_pth, tmp_path):
    """The imported checkpoint renders through ``python -m
    nerfstyle_torch.render`` (finite frame of the test view's size)."""
    r = reference_pth
    out = tmp_path / "imported.ckpt"
    import_reference.main([str(r["pth"]), "--out", str(out), "--root-path", str(r["scene"]),
                           "--device", "cpu"])
    summary = render_cli.main([str(out), "--device", "cpu", "--max-count", "1", "--yes",
                               "--out-dir", str(tmp_path / "render")])
    frame = summary["last"]
    assert summary["frames"] == 1 and frame["rgb_map"].shape == (24 * 32, 3)
    assert bool(torch.isfinite(frame["rgb_map"]).all()) and frame["num_marched"] > 0


def test_torch_importer_runs_on_cuda_unless_cpu_is_asked(reference_pth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        import_reference.main([str(reference_pth["pth"]), "--out", str(tmp_path / "x.ckpt")])
