"""The Replica path in both packages: one trajectory written from the
synthetic room (``write_replica_layout``: RDF cameras in an RFU world, so
``convert_poses`` is the identity; every 8th frame held out) trained one
step in each package from the same state, on the same frame and pixels
(``tests/test_torch_train_step.py``'s third step).

On this layout the JAX step marches one sample more than the port (15,828
against 15,827 on the 8 virtual CPU devices of ``tests/conftest.py``; also
unsharded), while JAX's own march of the step's rays outside the step
(``ops.marching.march_rays``) equals the port's ray by ray: the compiled step
(rays, sample positions and march fused into one program) puts one sample
on the other side of an occupancy cell's face.  So the step is held to
equal per-ray marches against JAX's march, the same significant-sample
count, a marched count within one, and loss terms within 1e-3 relative
(one sample moves the MSE by ~1.5e-4 of itself); the train-step tolerances
of the LLFF and synthetic tests do not apply to two different sample
sets."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import make_rays as jmake_rays
from nerfstyle_tpu.ops.aabb import near_far_from_aabb as jnear_far
from nerfstyle_tpu.ops.marching import march_rays as jmarch_rays
from nerfstyle_torch.data.synthetic import generate_scene, write_replica_layout
from nerfstyle_torch.ops.aabb import near_far_from_aabb
from nerfstyle_torch.ops.marching import march_rays
from nerfstyle_torch.training.checkpoint import tree_flatten
from nerfstyle_torch.training.trainer import Trainer
from test_torch_train_step import RAYS, _third_step


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica_path")
    generate_scene(root / "scene", num_train=9, num_test=1, h=48, w=64, room=True)
    focal_ratio = write_replica_layout(root / "scene", root / "replica", name="room", traj=3)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(
        f"root_path: {root / 'replica'}\ntype: Replica\nbound: 2.0\nscale: 1.0\n"
        f"replica_cfg:\n  name: room\n  focal_ratio: {focal_ratio!r}\n  traj_ids: [3]\n")
    return root, data_cfg


def test_torch_replica_split_trains_one_step_in_each_package(replica, tmp_path, monkeypatch):
    rays = {}
    ray_batch = Trainer.ray_batch

    def keep_rays(self, frame, idx):
        rays["o"], rays["d"], target = ray_batch(self, frame, idx)
        return rays["o"], rays["d"], target

    monkeypatch.setattr(Trainer, "ray_batch", keep_rays)
    jt, (losses, grads, num_points, num_sig), tt, (t_losses, t_grads, counts) = _third_step(
        replica, tmp_path, False)
    assert len(tt.train_set) == len(jt.train_set) == 7  # frames 0 and 8 held out
    assert len(tt.test_set) == 1 and tt.test_set.has_gt
    assert tt.train_set.intr.asdict() == jt.train_set.intr.asdict()
    assert tt.train_set.intr.fx == 0.9 * 64
    assert tt.train_set.num_classes == jt.train_set.num_classes == 4
    assert tt.settings.flip_camera == jt.renderer.settings.flip_camera == 0

    # The step's rays marched by JAX outside its step (its dense sweep over
    # the bitfield, which the JAX tests hold equal to its two-stage march)
    # and by the port (the two-stage march).
    o, d = rays["o"], rays["d"]
    bbox = tt.renderer.bbox
    plan = jt.renderer.make_plan(RAYS, budget=RAYS * tt.settings.max_steps)  # max_steps a ray
    j_rays = jmake_rays(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    j_bbox = jt.renderer.bbox
    want = jmarch_rays(plan, jt.renderer.occ_state.bitfield, j_rays,
                       *jnear_far(j_rays.origins, j_rays.dirs,
                                  jnp.concatenate([j_bbox.min_pt, j_bbox.max_pt]), plan.min_near))
    got = march_rays(tt.renderer.plan, tt.renderer.occ_field, o, d,
                     *near_far_from_aabb(o, d, torch.cat([bbox.min_pt, bbox.max_pt]),
                                         tt.renderer.plan.min_near))
    valid = np.asarray(want.valid)
    per_ray = np.bincount(np.asarray(want.ray_id)[valid], minlength=RAYS + 1)[:RAYS]
    np.testing.assert_array_equal(np.diff(got.offsets.numpy()), per_ray)
    assert got.num_kept == counts["num_points"]

    assert abs(counts["num_points"] - num_points) <= 1 and counts["num_sig"] == num_sig
    assert set(t_losses) == set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(t_losses[k]), float(v), rtol=1e-3, err_msg=k)
    assert all(bool(torch.isfinite(g).all()) for g in tree_flatten(t_grads))
    assert tt.opt_state.inner_state.inner_state[0].count.item() == 3
