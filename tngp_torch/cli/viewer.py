"""The web viewer — the port of `tngp/cli/viewer.py`: an HTTP server that
renders frames of a (training) `Trainer` on request, and a self-contained
page that orbits the camera and shows them.

- `GET /` serves the page; `POST /render` takes JSON {theta, phi, radius,
  mode: "rgb" | "depth", train, dynres, time, dt_gamma, max_steps} and
  answers a PNG frame (`Content-Type: image/png`) with its stats as JSON
  in the `X-Stats` header.
- `"train": true` first trains `train_steps` steps (adaptively held near
  500 ms a frame, 4 to 16 steps); `dynres` scales the frame to hold about
  200 ms a render (down to a quarter of each side); `dt_gamma` and
  `max_steps` replace the trainer's render config (`Trainer.set_cfg`, so
  the next frame renders with the new one); a D-NeRF trainer renders at
  `time`.
- Frames are PNGs from `utils/image_io.py`, where the JAX viewer serves
  JPEGs through cv2.

    python -m tngp_torch.cli.main_nerf <data> --gui [--gui_port 7860]
    curl -X POST localhost:7860/render -d '{"mode": "rgb"}' -o f.png
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.image_io import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>tngp viewer</title><style>
body { margin:0; background:#111; color:#eee; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px;
       border-radius:6px; }
#hud label { display:block; margin-top:4px; font-size:12px; }
#stats { position:fixed; bottom:8px; left:8px; font-size:12px; color:#9f9; }
img { width:100vw; height:100vh; object-fit:contain; }
input[type=range] { width:140px; vertical-align:middle; }
</style></head><body>
<div id="hud">
  drag: orbit / wheel: zoom
  <label><input type="checkbox" id="train"> train (adaptive steps)</label>
  <label><input type="checkbox" id="depth"> depth mode</label>
  <label><input type="checkbox" id="dynres" checked> dynamic resolution</label>
  <label id="timerow" style="display:none">time
    <input type="range" id="time" min="0" max="1" step="0.01" value="0"></label>
  <label>dt_gamma <input type="range" id="dtg" min="0" max="0.04"
    step="0.002" value="0"> <span id="dtgv">0</span></label>
  <label>max_steps <input type="range" id="msteps" min="128" max="1024"
    step="128" value="512"> <span id="mstepsv">512</span></label>
</div>
<div id="stats"></div>
<img id="view">
<script>
let theta=1.2, phi=0.6, radius=2.5, busy=false, dirty=true;
const img = document.getElementById('view');
const el = id => document.getElementById(id);
for (const id of ['train','depth','dynres','time','dtg','msteps'])
  el(id).addEventListener('input', ()=>{ dirty=true;
    el('dtgv').textContent = el('dtg').value;
    el('mstepsv').textContent = el('msteps').value; });
async function frame() {
  if (busy) return;
  if (!dirty && !el('train').checked) return;
  busy = true; dirty = false;
  const r = await fetch('/render', {method:'POST', body: JSON.stringify({
    theta, phi, radius,
    mode: el('depth').checked ? 'depth' : 'rgb',
    train: el('train').checked,
    dynres: el('dynres').checked,
    time: parseFloat(el('time').value),
    dt_gamma: parseFloat(el('dtg').value),
    max_steps: parseInt(el('msteps').value)})});
  const st = JSON.parse(r.headers.get('X-Stats') || '{}');
  el('stats').textContent =
    `render ${st.render_ms|0}ms @ ${st.W}x${st.H}` +
    (st.train_ms ? ` | train ${st.train_ms|0}ms (+${st.train_steps} steps,` +
      ` step ${st.global_step}, loss ${(+st.loss).toFixed(4)})` : '');
  if (st.has_time) el('timerow').style.display='block';
  const png = new Blob([await r.arrayBuffer()], {type: 'image/png'});
  if (img.src) URL.revokeObjectURL(img.src);
  img.src = URL.createObjectURL(png);
  busy = false;
}
let drag=false, lx=0, ly=0;
window.addEventListener('mousedown', e=>{drag=true; lx=e.x; ly=e.y;});
window.addEventListener('mouseup', ()=>drag=false);
window.addEventListener('mousemove', e=>{
  if(!drag) return;
  theta += (e.x-lx)*0.005; phi += (e.y-ly)*0.005;
  phi = Math.min(Math.max(phi, 0.05), Math.PI-0.05);
  lx=e.x; ly=e.y; dirty=true; frame();
});
window.addEventListener('wheel', e=>{radius *= (1 + e.deltaY*0.001);
  dirty=true; frame();});
window.addEventListener('keydown', e=>{
  if (e.key==='t') { el('train').checked = !el('train').checked; dirty=true; }
  if (e.key==='d') { el('depth').checked = !el('depth').checked; dirty=true; }
});
setInterval(frame, 100); frame();
</script></body></html>"""


def _orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """The camera on the sphere of `radius` at polar angle `phi` and azimuth
    `theta`, looking at the origin (ngp convention, y down).  [4, 4] f32."""
    c = radius * np.array(
        [np.sin(phi) * np.sin(theta), np.cos(phi), np.sin(phi) * np.cos(theta)]
    )
    forward = -c / np.linalg.norm(c)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-9
    up2 = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up2, forward], axis=-1)
    pose[:3, 3] = c
    return pose


class ViewerState:
    """Server-side state: the dynamic-resolution scale and the adaptive
    train steps per frame."""

    def __init__(self, trainer, train_steps: int = 16):
        self.trainer = trainer
        self.downscale = 1.0  # in (0, 1]; multiplies W/H
        self.train_steps = train_steps
        self.supports_time = "time" in inspect.signature(trainer.render_image).parameters

    def update_downscale(self, render_ms: float, enabled: bool):
        """Hold a render near 200 ms: the scale whose frame would take that
        long, in [0.25, 1], taken when it moves by more than 20%."""
        if not enabled:
            self.downscale = 1.0
            return
        full_t = render_ms / (self.downscale**2)
        ds = min(1.0, max(0.25, float(np.sqrt(200.0 / max(full_t, 1e-3)))))
        if ds > self.downscale * 1.2 or ds < self.downscale * 0.8:
            self.downscale = ds

    def update_train_steps(self, train_ms: float):
        """Hold a train request near 500 ms: 4 to 16 steps, changed when it
        moves by more than 20%."""
        full_t = train_ms / self.train_steps * 16
        ts = min(16, max(4, int(16 * 500 / max(full_t, 1e-3))))
        if ts > self.train_steps * 1.2 or ts < self.train_steps * 0.8:
            self.train_steps = ts

    def apply_render_overrides(self, req):
        """The dt_gamma / max_steps controls: a changed value replaces the
        trainer's render config through `set_cfg`, which rebuilds what
        depends on it (frame renderers are cached per cfg)."""
        cfg = self.trainer.cfg
        new = {}
        if "dt_gamma" in req and req["dt_gamma"] != cfg.dt_gamma:
            new["dt_gamma"] = float(req["dt_gamma"])
        if "max_steps" in req and int(req["max_steps"]) != cfg.max_steps:
            new["max_steps"] = int(req["max_steps"])
        if new:
            self.trainer.set_cfg(dataclasses.replace(cfg, **new))


def render_frame(trainer, state: ViewerState, req: dict) -> tuple[bytes, dict]:
    """One `POST /render`: train if asked, apply the overrides, render at the
    throttled size.  Returns (PNG bytes, stats)."""
    stats = {"has_time": state.supports_time}
    if req.get("train"):
        t0 = _time.time()
        trainer.train_one_epoch(state.train_steps)
        train_ms = (_time.time() - t0) * 1e3
        state.update_train_steps(train_ms)
        stats.update(train_ms=train_ms, train_steps=state.train_steps,
                     global_step=trainer.global_step,
                     loss=float(trainer.stats["loss"][-1]) if trainer.stats["loss"] else 0.0)
    state.apply_render_overrides(req)
    pose = _orbit_pose(req.get("theta", 1.2), req.get("phi", 0.6), req.get("radius", 2.5))
    W = max(64, int(trainer.W * state.downscale) // 16 * 16)
    H = max(64, int(trainer.H * state.downscale) // 16 * 16)
    kw = {"W": W, "H": H}
    if state.supports_time:
        kw["time"] = float(req.get("time", 0.0))
    t0 = _time.time()
    img, dep = trainer.render_image(pose, use_ema=False, **kw)
    render_ms = (_time.time() - t0) * 1e3
    state.update_downscale(render_ms, req.get("dynres", True))
    stats.update(render_ms=render_ms, W=W, H=H)
    if req.get("mode") == "depth":
        d = (dep - dep.min()) / max(dep.max() - dep.min(), 1e-6)
        frame = (np.stack([d] * 3, -1) * 255).astype(np.uint8)
    else:
        frame = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return encode_png(frame, level=1), stats


_SERVERS: list = []  # the viewers serving in this process
_SERVERS_LOCK = threading.Lock()


def run_viewer(trainer, port: int = 7860, train_steps_per_frame: int = 16):
    """Serve the viewer for `trainer` until interrupted or `stop_viewers()`."""
    lock = threading.Lock()
    state = ViewerState(trainer, train_steps_per_frame)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            with lock:
                png, stats = render_frame(trainer, state, req)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("X-Stats", json.dumps(stats))
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    with _SERVERS_LOCK:
        _SERVERS.append(server)
    print(f"[viewer] http://localhost:{port} (ctrl-c to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        with _SERVERS_LOCK:
            _SERVERS.remove(server)
        server.server_close()


def stop_viewers():
    """Stop every viewer serving in this process (from another thread)."""
    with _SERVERS_LOCK:
        servers = list(_SERVERS)
    for s in servers:
        s.shutdown()
