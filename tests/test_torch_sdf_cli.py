"""`tngp_torch.cli.main_sdf sphere` end to end on the CPU, in the process on
one torch thread, with the SDF grid narrowed to 4 levels of 2^12 rows
(`small_models`, tests/torch_cli_helpers.py): training with a checkpoint
per epoch, resume, `--test`, and the bf16 MLP of `--fp16`."""

import numpy as np
import torch

from torch_cli_helpers import small_models  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SDF_FLAGS = ["--num_samples", "2048", "--epoch_size", "2", "--mesh_resolution", "24",
             "--lr", "1e-3"]


def test_main_sdf_sphere_trains_resumes_and_meshes(small_models, tmp_path):
    """2 epochs of 2 steps: a checkpoint and an eval line per epoch and the
    mesh; `--epochs 3` resumes at epoch 2, step 4 with run 1's weights,
    EMA and Adam state bit for bit; `--test` meshes the latest checkpoint;
    `--fp16` trains a bf16 MLP."""
    from tngp_torch.cli import main_sdf
    from tngp_torch.native import load_obj
    from tngp_torch.train.sdf_trainer import SDFTrainer

    ws = str(tmp_path / "ws")
    tr1 = main_sdf.main(["sphere", "--epochs", "2", "--workspace", ws, *SDF_FLAGS])
    assert (tr1.epoch, tr1.global_step) == (2, 4)
    assert tr1.model.encoder.spec.num_levels == 4 and tr1.model.backbone.dense_0.shape == (8, 64)
    assert len(tr1.stats["loss"]) == 2 and np.isfinite(tr1.stats["loss"]).all()
    log = (tmp_path / "ws" / "log_ngp.txt").read_text()
    assert log.count("[sdf eval epoch") == 2 and "[save_mesh]" in log
    ck = tmp_path / "ws" / "checkpoints"
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0001.npz", "ngp_ep0002.npz"]
    assert (tmp_path / "ws" / "results" / "mesh.ply").exists()
    end1 = [p.detach().clone() for p in tr1.params] + [e.clone() for e in tr1.ema_params]
    adam1 = [tr1.optimizer.state[p]["exp_avg_sq"].clone() for p in tr1.params]

    seen = {}
    real_train = SDFTrainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step)
        seen["state"] = [p.detach().clone() for p in self.params] + [
            e.clone() for e in self.ema_params]
        seen["adam"] = [self.optimizer.state[p]["exp_avg_sq"].clone() for p in self.params]
        return real_train(self, max_epochs)

    try:
        SDFTrainer.train = train_seen
        tr2 = main_sdf.main(["sphere", "--epochs", "3", "--workspace", ws, *SDF_FLAGS])
    finally:
        SDFTrainer.train = real_train
    assert seen["at"] == (2, 4) and (tr2.epoch, tr2.global_step) == (3, 6)
    assert all(torch.equal(a, b) for a, b in zip(seen["state"], end1))
    assert all(torch.equal(a, b) for a, b in zip(seen["adam"], adam1))

    path = tmp_path / "ws" / "results" / "mesh.ply"
    path.unlink()
    tr3 = main_sdf.main(["sphere", "--test", "--workspace", ws, *SDF_FLAGS])
    assert tr3.global_step == 6 and path.exists()
    obj = str(tmp_path / "m.obj")
    tr3.save_mesh(obj, resolution=24)
    v, f = load_obj(obj)
    assert v.shape[1] == 3 and f.shape[1] == 3 and np.abs(v).max() <= 1.0

    tr4 = main_sdf.main(["sphere", "--epochs", "1", "--fp16",
                         "--workspace", str(tmp_path / "fp16"), *SDF_FLAGS])
    assert tr4.model.backbone.compute_dtype == torch.bfloat16
    assert np.isfinite(tr4.stats["loss"]).all()
