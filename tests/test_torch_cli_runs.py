"""The port's entry points end to end on the CPU, in the process on one
torch thread: `tngp_torch.cli.main_nerf synthetic` at its full model width
with `TNGP_PLATFORM=cpu` and tests/test_cli.py:41-46's flags and a second
run that resumes from its checkpoint; `main_nerf` on the golden tiled grid
with the background model, and `tngp_torch.cli.main_dnerf` on the tiny
dynamic blob scene (its default model, and `--hyper`), with resume and
`--test`, at small width (`small_models`, tests/torch_cli_helpers.py)."""

import numpy as np
import torch

from torch_cli_helpers import DNERF_FLAGS, FLAGS, small_models  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_main_nerf_synthetic_trains_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """`main_nerf synthetic` at its full model width with tests/test_cli.py:41-46's
    flags, in the process on the CPU (`TNGP_PLATFORM=cpu`, the 4-frame
    32x32 blob scene): 8 iterations (2 epochs of the 4 frames), a
    checkpoint per epoch, an `[eval` line, a `[save_mesh]` line and
    validation PNGs; then `--ckpt latest` with 12 iterations loads epoch 2
    at step 8 and trains epoch 3 from there."""
    from tngp_torch.cli import main_nerf

    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    monkeypatch.setenv("TNGP_SYNTH", "4,32,32")
    monkeypatch.chdir(tmp_path)
    main_nerf.main(["synthetic", "--iters", "8", *FLAGS])
    out = capsys.readouterr().out
    assert "[epoch 2]" in out and "[eval" in out and "[save_mesh]" in out
    ck = tmp_path / "ws" / "checkpoints"
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0001.npz", "ngp_ep0002.npz"]
    assert len(list((tmp_path / "ws" / "validation").glob("*.png"))) == 4
    assert (tmp_path / "ws" / "log_ngp.txt").read_text().count("[epoch") == 2

    main_nerf.main(["synthetic", "--iters", "12", "--ckpt", "latest", *FLAGS])
    out2 = capsys.readouterr().out
    assert "ngp_ep0002.npz (epoch 2, step 8)" in out2
    assert "[epoch 3]" in out2 and "[epoch 1]" not in out2
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0002.npz", "ngp_ep0003.npz"]


def test_main_nerf_tiledgrid_with_background_trains(small_models, tmp_path):
    """`--encoding tiledgrid --bg_radius 2`: the golden tiled grid and the
    background model train for 4 iterations (their weights move), checkpoint
    the background's weights and export a mesh."""
    from tngp_torch.cli import main_nerf
    from tngp_torch.models import NGPNetwork
    from tngp_torch.utils import msgpack_codec

    ref = NGPNetwork(encoding="tiledgrid", bg_radius=2.0, device="cpu", seed=0)
    tr = main_nerf.main(["synthetic", "--iters", "4", "--encoding", "tiledgrid", "--bg_radius",
                         "2", *FLAGS[:-2], "--workspace", str(tmp_path / "ws")])
    assert tr.global_step == 4 and tr.model.encoder.spec.gridtype == "tiled"
    assert np.isfinite(tr.stats["loss"]).all() and tr.stats["loss"][0] > 0
    for name in ("encoder.embeddings", "encoder_bg.embeddings", "bg_net.dense_0"):
        assert not torch.equal(dict(tr.model.named_parameters())[name].detach(),
                               dict(ref.named_parameters())[name].detach()), name
    ck = tmp_path / "ws" / "checkpoints" / "ngp_ep0001.npz"
    params = msgpack_codec.unpackb(ck.read_bytes())["params"]["params"]
    assert params["encoder"]["embeddings"].shape == tuple(ref.encoder.embeddings.shape)
    assert params["encoder_bg"]["embeddings"].shape == (697_776, 2)
    assert set(params["bg_net"]) == {"dense_0", "dense_1"}
    assert list((tmp_path / "ws" / "meshes").glob("*.ply"))


def test_main_dnerf_trains_resumes_and_tests(small_models, tmp_path, monkeypatch):
    """The default model (tiledgrid): 8 iterations (2 epochs of the 4 frames),
    a checkpoint per epoch and a validation PSNR at the frames' times; then
    `--ckpt latest` loads epoch 2 at step 8 with run 1's weights, EMA and
    time grid bit for bit and trains epoch 3; `--test` writes PNG frames."""
    from tngp_torch.cli import main_dnerf
    from tngp_torch.models import DNeRFNetwork
    from tngp_torch.train import DNeRFTrainer

    ws = str(tmp_path / "ws")
    tr1 = main_dnerf.main(["synthetic", "--iters", "8", "--workspace", ws, *DNERF_FLAGS])
    assert isinstance(tr1.model, DNeRFNetwork.func) and tr1.model.encoder.spec.gridtype == "tiled"
    assert (tr1.epoch, tr1.global_step) == (2, 8) and tr1.time_size == 4
    assert tr1.grid.bitfield.shape == (4, 32**3 // 8)
    losses = tr1.stats["loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    log = (tmp_path / "ws" / "log_ngp.txt").read_text()
    psnr = float(log.split("[dnerf eval epoch 2]")[1].split("PSNR = ")[1].split()[0])
    assert np.isfinite(psnr)
    ck = tmp_path / "ws" / "checkpoints"
    assert sorted(p.name for p in ck.glob("*.npz")) == ["ngp_ep0001.npz", "ngp_ep0002.npz"]
    end1 = [p.detach().clone() for p in tr1.params] + [e.clone() for e in tr1.ema_params]
    grid1 = tr1.grid.density_grid.clone()

    seen = {}
    real_train = DNeRFTrainer.train

    def train_seen(self, max_epochs):
        seen["at"] = (self.epoch, self.global_step)
        seen["state"] = [p.detach().clone() for p in self.params] + [
            e.clone() for e in self.ema_params]
        seen["grid"] = self.grid.density_grid.clone()
        return real_train(self, max_epochs)

    monkeypatch.setattr(DNeRFTrainer, "train", train_seen)
    tr2 = main_dnerf.main(["synthetic", "--iters", "12", "--ckpt", "latest", "--workspace", ws,
                           *DNERF_FLAGS])
    assert seen["at"] == (2, 8) and tr2.global_step == 12
    assert all(torch.equal(a, b) for a, b in zip(seen["state"], end1))
    assert torch.equal(seen["grid"], grid1)

    main_dnerf.main(["synthetic", "--test", "--workspace", ws, *DNERF_FLAGS])
    assert len(list((tmp_path / "ws" / "results").glob("*.png"))) == 4


def test_main_dnerf_hyper_trains(small_models, tmp_path):
    """`--hyper`: the 5-D tiled grid and the ambient net train (its weights
    move: the encoder's position gradient reaches them)."""
    from tngp_torch.cli import main_dnerf
    from tngp_torch.models import DNeRFHyperNetwork

    ws = str(tmp_path / "ws")
    torch.manual_seed(0)
    ref = DNeRFHyperNetwork(device="cpu", seed=0).ambient_net.dense_0.detach().clone()
    tr = main_dnerf.main(["synthetic", "--hyper", "--iters", "4", "--workspace", ws,
                          *DNERF_FLAGS])
    assert tr.model.encoder.spec.input_dim == 5 and tr.global_step == 4
    assert np.isfinite(tr.stats["loss"]).all()
    assert not torch.equal(tr.model.ambient_net.dense_0.detach(), ref)
