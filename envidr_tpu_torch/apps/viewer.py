"""Interactive web viewer (counterpart of ``envidr_tpu/apps/viewer.py``, the
reference's dearpygui GUI, ``nerf/gui.py:55-345``): an orbit camera (drag
and wheel), the render mode (rgb, depth, normal, diffuse, specular,
roughness), the env net and its rotation, the resolution, and training
while viewing (a budget of train steps per frame, ``gui.py:109-113``).

A single page served over HTTP by the standard library's ``http.server``
(open a tunnel to a headless machine and point a browser at it); each
``GET /render`` renders one frame on the trainer's device, one request at a
time, and answers with a PNG:

    python -m envidr_tpu_torch.apps.viewer --config configs/synth_spheres_cp.ini \\
        --ckpt assets/neus_cp_long_best.ckpt [--port 8008] \\
        [--train-data data/synth_spheres] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
import urllib.parse
from typing import Optional

import numpy as np

from envidr_tpu_torch.data.env_dataset import CAMERA_ANGLE_X
from envidr_tpu_torch.data.png import encode


_PAGE = """<!doctype html>
<html><head><title>envidr_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;display:flex}
#side{width:230px;padding:12px}#main{flex:1;display:flex;align-items:center;justify-content:center}
img{image-rendering:pixelated;cursor:grab;max-width:90vmin;max-height:90vmin;width:90vmin}
label{display:block;margin:8px 0 2px}input,select,button{width:100%}
#stats{margin-top:12px;white-space:pre;color:#8c8}
</style></head><body>
<div id=side>
  <h3>envidr_tpu_torch</h3>
  <label>mode</label>
  <select id=mode><option>image</option><option>depth</option>
    <option>normal_image</option><option>diffuse_image</option>
    <option>specular_image</option><option>roughness_image</option></select>
  <label>resolution (auto = 200ms frame budget)</label>
  <select id=res><option selected>auto</option><option>128</option><option>256</option><option>400</option></select>
  <label>env index</label><input id=env type=number value=0 min=0 max=10>
  <label>env rotation (deg)</label><input id=rot type=range value=0 min=0 max=360>
  <label>train steps / frame (-1 = auto, 500ms budget)</label><input id=train type=number value=0 min=-1 max=64>
  <button id=go style="margin-top:10px">refresh</button>
  <div id=stats></div>
</div>
<div id=main><img id=im width=512 height=512></div>
<script>
let az=35, el=-25, r=3.2, busy=false, queued=false;
const $=id=>document.getElementById(id);
async function refresh(){
  if(busy){queued=true;return} busy=true;
  const q=new URLSearchParams({az,el,r,mode:$('mode').value,size:$('res').value,
    env:$('env').value,rot:$('rot').value,train:$('train').value});
  const t0=performance.now();
  const resp=await fetch('/render?'+q); const blob=await resp.blob();
  $('im').src=URL.createObjectURL(blob);
  $('stats').textContent=`az ${az.toFixed(0)} el ${el.toFixed(0)} r ${r.toFixed(2)}\n`+
    `${(performance.now()-t0).toFixed(0)} ms`+
    (resp.headers.get('X-Train-Info')?'\n'+resp.headers.get('X-Train-Info'):'');
  busy=false; if(queued){queued=false;refresh()}
}
let drag=null;
$('im').onpointerdown=e=>{drag=[e.clientX,e.clientY];e.preventDefault()};
window.onpointerup=()=>drag=null;
window.onpointermove=e=>{if(!drag)return;
  az-=(e.clientX-drag[0])*0.5; el=Math.max(-89,Math.min(89,el+(e.clientY-drag[1])*0.5));
  drag=[e.clientX,e.clientY];refresh()};
$('im').onwheel=e=>{e.preventDefault();r=Math.max(1.2,Math.min(8,r*(1+e.deltaY*1e-3)));refresh()};
for(const id of['mode','res','env','rot','train'])$(id).onchange=refresh;
$('go').onclick=refresh; refresh();
</script></body></html>"""


class ViewerState:
    """Owns the trainer; renders frames and, when asked, trains between them."""

    def __init__(self, trainer, opt, mode: str, dataset=None):
        self.trainer = trainer
        self.opt = opt
        self.mode = mode
        self.dataset = dataset
        self.lock = threading.Lock()
        # a sphere render needs a material: the dataset's first or a glossy one
        self.material = None
        if mode == "sphere":
            self.material = (dataset.material(0) if hasattr(dataset, "material") and len(dataset)
                             else dict(roughness=0.3, metallic=0.9, color=(0.7, 0.7, 0.7)))
        # the frame budgets (gui.py:109-161): the render's downscale aims at
        # 200 ms, the train steps a frame at 500 ms, each with 20% hysteresis
        self.auto_base = 400
        self.downscale = 0.5
        self.auto_train_steps = 16

    def frame(self, az, el, radius, size, render_mode, env_index, rot_deg,
              train_steps) -> tuple:
        """(PNG bytes, info line) of one frame, after ``train_steps`` train
        steps (-1: the automatic budget) when the viewer has a dataset;
        ``size`` is a pixel count or ``"auto"`` (the 200 ms budget)."""
        from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp, pose_spherical
        info = ""
        with self.lock:
            if train_steps and self.dataset is not None:
                steps = self.auto_train_steps if train_steps < 0 else train_steps
                t0 = time.perf_counter()
                stats = self.trainer.train_one_epoch_steps(self.dataset, steps)
                t_ms = (time.perf_counter() - t0) * 1e3
                if train_steps < 0:      # dynamic train steps (gui.py:109-113)
                    full_t = t_ms / steps * 16
                    new = min(16, max(4, int(16 * 500 / max(full_t, 1e-3))))
                    if not 0.8 * steps <= new <= 1.2 * steps:
                        self.auto_train_steps = new
                info = f"step {self.trainer.global_step} (+{steps}) loss {stats['loss']:.4f}"
            if str(size) == "auto":
                H = W = max(16, int(self.auto_base * self.downscale) // 8 * 8)
            else:
                H = W = int(size)
            pose = nerf_matrix_to_ngp(np.asarray(pose_spherical(az, el, radius), np.float32),
                                      scale=self.opt.scale)
            focal = W / (2 * np.tan(CAMERA_ANGLE_X / 2))
            t0 = time.perf_counter()
            # the live weights: what a train-per-frame step changed shows at once
            res = self.trainer.render_image(
                pose, (focal, focal, W / 2, H / 2), H, W,
                env_rot_radian=np.deg2rad(rot_deg) if rot_deg else None,
                env_index=int(env_index), material=self.material, use_ema=False)
            render_ms = (time.perf_counter() - t0) * 1e3
            if str(size) == "auto":      # dynamic resolution (gui.py:141-147)
                full_t = render_ms / (self.downscale ** 2)
                new = min(1.0, max(0.25, float(np.sqrt(200 / max(full_t, 1e-3)))))
                if not 0.8 * self.downscale <= new <= 1.2 * self.downscale:
                    self.downscale = new
                info = (info + " | " if info else "") + f"{W}x{H} {render_ms:.0f} ms (auto)"
        return encode(self._to_rgb(res, render_mode)), info

    def _to_rgb(self, res, render_mode) -> np.ndarray:
        if render_mode == "depth" or render_mode not in res:
            d = res.get("depth")
            if render_mode != "depth" or d is None:
                render_mode = "image"
            else:
                d = np.asarray(d)
                lo, hi = np.percentile(d[d > 0], 2) if (d > 0).any() else 0, d.max()
                v = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
                return (np.stack([v] * 3, -1) * 255).astype(np.uint8)
        v = np.asarray(res[render_mode])
        if render_mode == "normal_image":
            v = v * 0.5 + 0.5
        if v.ndim == 2 or v.shape[-1] == 1:
            v = np.broadcast_to(v.reshape(v.shape[:2] + (1,)), v.shape[:2] + (3,))
        return (np.clip(v[..., :3], 0, 1) * 255).astype(np.uint8)


def make_handler(state: ViewerState):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, kind: Optional[str] = None, info: str = ""):
            self.send_response(code)
            if kind:
                self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            if info:
                self.send_header("X-Train-Info", info)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                return self._send(200, _PAGE.encode(), "text/html")
            if url.path != "/render":
                return self._send(404, b"")
            q = urllib.parse.parse_qs(url.query)

            def g(k, d):
                return float(q.get(k, [d])[0])

            size = q.get("size", ["auto"])[0]
            try:
                png, info = state.frame(
                    g("az", 35), g("el", -25), g("r", 3.2),
                    size if size == "auto" else int(float(size)),
                    q.get("mode", ["image"])[0], int(g("env", 0)), g("rot", 0),
                    int(g("train", 0)))
            except Exception as e:       # the page shows a failed render
                return self._send(500, f"render failed: {e}".encode())
            self._send(200, png, "image/png", info)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default="latest")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--train-data", default="",
                   help="dataset root: enables train steps per frame")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from envidr_tpu_torch import resolve_device
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(args.config)
    trainer = Trainer(opt, network_config(opt), device=resolve_device(args.device))
    trainer.load_checkpoint(args.ckpt)
    trainer.update_extra_state()
    mode = "sphere" if (opt.env_sph_mode or opt.render_env_on_sphere) else "scene"
    dataset = None
    if args.train_data:
        from envidr_tpu_torch.apps.cli import load_split
        dataset = load_split(dataclasses.replace(opt, path=args.train_data), "train",
                             device=trainer.device)
        trainer.mark_untrained_grid(dataset.poses, dataset.intrinsics)

    state = ViewerState(trainer, opt, mode, dataset)
    from http.server import HTTPServer
    srv = HTTPServer((args.host, args.port), make_handler(state))
    print(f"[viewer] http://{args.host}:{args.port}  (mode={mode})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
