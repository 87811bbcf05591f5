"""``dir_enc_sh_deg`` reaches the field spec: the JAX trainer passes the
network config's degree into its field spec (``sh_degree``), and so do the
port's trainer, its render CLI's loader and its reference importer.  At a
degree other than the default 4 (3 here) both trainers' specs carry it, and
the render CLI rebuilds it from the port's checkpoint.  No step is taken.
"""

import shutil

import pytest
import torch

from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.render import cli
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.training.trainer import Trainer as JTrainer

NARGS = [
    "--dir_enc_sh_deg", "3",
    "--pos_enc.n_lvls", "4",
    "--pos_enc.hashmap_size", "12",
    "--pos_enc.max_res_coeff", "16",
    "--grid_size", "32",
    "--max_steps", "128",
    "--max_eval_count", "1",
    "--intervals.print", "0",
    "--intervals.log", "0",
    "--intervals.test", "0",
    "--intervals.ckpt", "0",
]


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("sh_degree_scene")
    generate_scene(root / "scene", num_train=2, num_test=1, h=24, w=32)
    cfg = root / "data.yaml"
    cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    yield cfg
    shutil.rmtree(root, ignore_errors=True)


def test_torch_dir_enc_sh_deg_reaches_both_trainers_and_the_cli(data_cfg, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jt = JTrainer(JBaseConfig(log_dir=tmp_path / "jax", data_cfg=data_cfg, yes=True),
                      list(NARGS))
        pt = Trainer(BaseConfig(log_dir=tmp_path / "port", data_cfg=data_cfg, yes=True),
                     list(NARGS), "cpu")
        assert pt.net_cfg.dir_enc_sh_deg == 3
        assert jt.field_spec.sh_degree == pt.field_spec.sh_degree == 3
        renderer, _, _, _ = cli.load_renderer(pt.save_ckpt(), "cpu", max_count=1)
        assert renderer.field_spec.sh_degree == 3
    finally:
        torch.set_num_threads(threads)
