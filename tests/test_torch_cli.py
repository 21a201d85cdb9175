"""The port's entry points' options on the CPU: CLIP guidance with the stub
embedder runs, `--basis` with `--hyper` is a usage error, `main_nerf
--error_map`, `--no_grid` and `--profile` run in the process at small
width (`small_models`,
tests/torch_cli_helpers.py), and `--gui` of both NeRF entry points serves
PNG frames over HTTP.  The runs themselves are in
`test_torch_cli_runs.py`."""

import pytest

from torch_cli_helpers import FLAGS, small_models  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: the in-process runs)


def test_main_dnerf_options_that_raise(monkeypatch):
    """`--basis` with `--hyper` is a usage error."""
    from tngp_torch.cli import main_dnerf

    monkeypatch.setenv("TNGP_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        main_dnerf.main(["synthetic", "--basis", "--hyper"])


def test_clip_guidance_runs(small_models, tmp_path):
    """`--rand_pose 3 --clip_text ... --clip_model_path stub`: every third
    step is a CLIP step (stub embedder) and the run trains on."""
    import math

    from tngp_torch.cli import main_nerf
    from tngp_torch.train.clip_guidance import StubEmbedder

    tr = main_nerf.main(["synthetic", "--iters", "8", "--rand_pose", "3", "--clip_text",
                         "a red sphere", "--clip_model_path", "stub", *FLAGS[:-2],
                         "--workspace", str(tmp_path / "clip")])
    assert isinstance(tr.clip_embedder, StubEmbedder) and tr.global_step == 8
    assert all(math.isfinite(x) for x in tr.stats["loss"])


def test_main_nerf_error_map_no_grid_and_profile(small_models, tmp_path):
    """`--error_map`: 8 iterations move the map off its ones, the checkpoint
    holds it, and a resume restores it bit for bit.  `--no_grid`: the
    grid-free path trains (no grid update) and exports a mesh.
    `--profile`: the first epoch's trace is a non-empty Chrome trace."""
    import json

    import numpy as np
    import torch

    from tngp_torch.cli import main_nerf
    from tngp_torch.train import Trainer
    from tngp_torch.utils import msgpack_codec

    ws = str(tmp_path / "em")
    tr = main_nerf.main(["synthetic", "--iters", "8", "--error_map", *FLAGS[:-2],
                         "--workspace", ws])
    em = tr.error_map.clone()
    assert em.shape == (4, 128 * 128) and (em != 1).any() and torch.isfinite(em).all()
    saved = msgpack_codec.unpackb((tmp_path / "em" / "checkpoints" / "ngp_ep0002.npz")
                                  .read_bytes())["error_map"]
    np.testing.assert_array_equal(saved, em.numpy())
    seen = {}
    real_train = Trainer.train

    def train_seen(self, max_epochs):
        seen["map"] = self.error_map.clone()
        return real_train(self, max_epochs)

    try:
        Trainer.train = train_seen
        main_nerf.main(["synthetic", "--iters", "12", "--error_map", *FLAGS[:-2],
                        "--workspace", ws])
    finally:
        Trainer.train = real_train
    assert torch.equal(seen["map"], em)

    tr = main_nerf.main(["synthetic", "--iters", "4", "--no_grid", "--num_steps", "16",
                         "--upsample_steps", "16", *FLAGS[:-2],
                         "--workspace", str(tmp_path / "nogrid")])
    assert not tr.use_grid and tr._grid_updates == 0 and tr.global_step == 4
    assert np.isfinite(tr.stats["loss"]).all()
    assert list((tmp_path / "nogrid" / "meshes").glob("*.ply"))

    prof = tmp_path / "prof"
    main_nerf.main(["synthetic", "--iters", "4", "--profile", str(prof), *FLAGS[:-2],
                    "--workspace", str(tmp_path / "pws")])
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("hash_grid" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)


def _serve(main, argv):
    """Run `main(argv)` (a `--gui` run) in a thread; return (thread, the
    port, post(body) -> (PNG decoded, stats))."""
    import json
    import socket
    import threading
    import time
    import urllib.request

    from tngp_torch.utils.image_io import decode_png

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "trainer", main([*argv, "--gui", "--gui_port", str(port)])), daemon=True)
    t.start()
    deadline = time.time() + 120
    page = None
    while time.time() < deadline and t.is_alive():
        try:
            page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.2)
    assert page and b"tngp viewer" in page and b"image/png" in page

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                     data=json.dumps(body).encode(), method="POST")
        resp = urllib.request.urlopen(req, timeout=300)
        assert resp.headers["Content-Type"] == "image/png"
        stats = json.loads(resp.headers["X-Stats"])
        return decode_png(resp.read()), stats

    return t, out, post


def test_gui_of_main_nerf_and_main_dnerf_serves_png_frames(small_models, tmp_path):
    """`--gui` serves the viewer instead of training: rgb and depth frames
    decode to the reported size, a train request advances the step, and
    D-NeRF's viewer reports its time axis and renders at a time."""
    from tngp_torch.cli import main_dnerf, main_nerf
    from tngp_torch.cli.viewer import stop_viewers

    from torch_cli_helpers import DNERF_FLAGS

    t, out, post = _serve(main_nerf.main, ["synthetic", "--iters", "8", *FLAGS[:-2],
                                           "--workspace", str(tmp_path / "ngp")])
    try:
        img, st = post({"theta": 1.2, "phi": 0.6, "radius": 2.5, "mode": "rgb"})
        assert img.shape == (st["H"], st["W"], 3) and st["render_ms"] > 0
        assert not st["has_time"]
        dep, st = post({"mode": "depth", "dynres": False})
        assert dep.shape == (st["H"], st["W"], 3) and (dep[..., 0] == dep[..., 1]).all()
        _, st = post({"mode": "rgb", "train": True})
        assert st["global_step"] >= 1 and st["train_steps"] >= 1 and "loss" in st
    finally:
        stop_viewers()
        t.join(timeout=60)
    assert out["trainer"].global_step == st["global_step"]

    t, out, post = _serve(main_dnerf.main, ["synthetic", "--workspace", str(tmp_path / "dn"),
                                            *DNERF_FLAGS])
    try:
        img, st = post({"mode": "rgb", "time": 0.5})
        assert st["has_time"] and img.shape == (st["H"], st["W"], 3)
    finally:
        stop_viewers()
        t.join(timeout=60)
    assert not t.is_alive()
