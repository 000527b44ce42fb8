"""Web viewer: orbit or free-fly a Gaussian scene from the browser.

A localhost HTTP server that renders frames on demand: ``/`` is the page
(drag to orbit, wheel to zoom, mode and scale selectors, a fly toggle),
``/render`` returns a PNG and ``/info`` the scene size as JSON.

Usage:
  python -m gaussiansplattingviewer_tpu_torch.apps.serve \
      [--gs-model scene_dir | --random-scene N] \
      [--width 960 --height 540] [--port 8008] [--device cuda] \
      [--backend {kernel,tile,oracle}]

``--gs-model`` takes a scene dir or a .ply, loaded by the viewer's
``load_scene`` (apps/viewer.py); without it the 4-splat test scene.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from gaussiansplattingviewer_tpu_torch.apps.viewer import MODE_NAMES, load_scene
from gaussiansplattingviewer_tpu_torch.config import RenderConfig, RenderMode
from gaussiansplattingviewer_tpu_torch.models import random_scene
from gaussiansplattingviewer_tpu_torch.ops.render import (
    BACKENDS,
    render,
    resolve_device,
)
from gaussiansplattingviewer_tpu_torch.utils import transforms as tf
from gaussiansplattingviewer_tpu_torch.utils.camera import Camera
from gaussiansplattingviewer_tpu_torch.utils.image_io import encode_rgb8

_PAGE = """<!doctype html>
<html><head><title>gaussiansplattingviewer (PyTorch)</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
img{border:1px solid #333;cursor:grab}
select,input{background:#222;color:#ddd;border:1px solid #444;margin:2px}
</style></head><body>
<div>
 mode <select id=mode>%OPTS%</select>
 scale <input id=scale type=range min=0.05 max=2 step=0.05 value=1>
 <label><input id=fly type=checkbox> fly (WASD + R/F, drag to look)</label>
 <span id=stat></span>
</div>
<img id=v width=%W% height=%H% draggable=false tabindex=0>
<script>
let yaw=0, pitch=0.3, radius=%R%, busy=false, queued=false, pos=null;
const img=document.getElementById('v'), flyBox=document.getElementById('fly');
function front(){return [Math.cos(pitch)*Math.sin(yaw), Math.sin(pitch),
                         Math.cos(pitch)*Math.cos(yaw)];}
function refresh(){
  if(busy){queued=true;return;} busy=true;
  const m=document.getElementById('mode').value;
  const s=document.getElementById('scale').value;
  const t0=performance.now();
  let u=`/render?yaw=${yaw}&pitch=${pitch}&mode=${m}&scale=${s}&_=${Math.random()}`;
  if(flyBox.checked && pos) u+=`&fly=1&px=${pos[0]}&py=${pos[1]}&pz=${pos[2]}`;
  else u+=`&radius=${radius}`;
  const i=new Image();
  i.onload=()=>{img.src=i.src; busy=false;
    document.getElementById('stat').textContent=`${(performance.now()-t0).toFixed(0)} ms`;
    if(queued){queued=false;refresh();}};
  i.src=u;
}
flyBox.onchange=()=>{
  if(flyBox.checked && !pos){const f=front();
    pos=[radius*f[0], radius*f[1], radius*f[2]]; yaw+=Math.PI; pitch=-pitch;}
  img.focus(); refresh();
};
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;img.focus()};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const sgn=flyBox.checked?-1:1;
  yaw+=sgn*(e.clientX-lx)*0.01; pitch+=sgn*(e.clientY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX;ly=e.clientY; refresh();};
img.onwheel=e=>{e.preventDefault();
  if(flyBox.checked){const f=front(),d=-e.deltaY*0.003;
    pos=[pos[0]+f[0]*d,pos[1]+f[1]*d,pos[2]+f[2]*d];}
  else radius*=Math.exp(e.deltaY*0.001);
  refresh();};
window.onkeydown=e=>{
  if(!flyBox.checked||!pos)return;
  const f=front(), up=[0,-1,0];
  let r=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
  const rn=Math.hypot(...r)||1; r=r.map(v=>v/rn);
  const st=0.12*Math.max(radius,1)*0.25;
  const mv={w:f.map(v=>v*st), s:f.map(v=>-v*st), a:r.map(v=>-v*st),
            d:r.map(v=>v*st), r:[0,-st,0], f:[0,st,0]}[e.key.toLowerCase()];
  if(!mv)return;
  e.preventDefault(); pos=[pos[0]+mv[0],pos[1]+mv[1],pos[2]+mv[2]]; refresh();
};
document.getElementById('mode').onchange=refresh;
document.getElementById('scale').oninput=refresh;
refresh();
</script></body></html>"""


class ViewerState:
    """Scene, orbit centre/radius, base config, device and render backend
    of a server.  Renders are serialized by a lock (one frame at a time on
    the card)."""

    def __init__(self, scene, center, radius, cfg: RenderConfig, device=None,
                 backend="kernel"):
        self.device = resolve_device(device)
        self.backend = backend
        self.scene = scene.to(self.device)
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.cfg = cfg
        self.lock = threading.Lock()

    def render_frame(self, yaw, pitch, radius, mode, scale, fly_pos=None):
        """PNG bytes of one frame: orbit (yaw, pitch, radius) around the
        centre, or free-fly from ``fly_pos`` along (yaw, pitch)."""
        cfg = self.cfg.with_(
            mode=MODE_NAMES.get(mode, RenderMode.SH3),
            scale_modifier=float(scale),
        )
        front = np.array([
            np.cos(pitch) * np.sin(yaw),
            np.sin(pitch),
            np.cos(pitch) * np.cos(yaw),
        ])
        if fly_pos is not None:
            eye = np.asarray(fly_pos, np.float64)
            view = tf.look_at(eye, eye + front, [0, -1, 0])
        else:
            eye = self.center + radius * front
            view = tf.look_at(eye, self.center, [0, -1, 0])
        cam = Camera(h=cfg.height, w=cfg.width)
        with self.lock:
            img = render(
                self.scene, view, cam.get_project_matrix(),
                eye.astype(np.float32), cfg, backend=self.backend,
                device=self.device,
            ).cpu().numpy()
        return encode_rgb8(img)


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, ctype, body, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                opts = "".join(
                    f'<option value="{m}"{" selected" if m == "sh3" else ""}>'
                    f"{m}</option>"
                    for m in sorted(MODE_NAMES)
                )
                page = (
                    _PAGE.replace("%OPTS%", opts)
                    .replace("%W%", str(state.cfg.width))
                    .replace("%H%", str(state.cfg.height))
                    .replace("%R%", str(state.radius))
                )
                self._send("text/html", page.encode())
            elif url.path == "/render":
                q = parse_qs(url.query)

                def f(k, d):
                    return float(q.get(k, [d])[0])

                fly_pos = None
                if q.get("fly", ["0"])[0] == "1":
                    fly_pos = (f("px", 0.0), f("py", 0.0), f("pz", 0.0))
                png = state.render_frame(
                    f("yaw", 0.0), f("pitch", 0.3), f("radius", state.radius),
                    q.get("mode", ["sh3"])[0], f("scale", 1.0),
                    fly_pos=fly_pos,
                )
                self._send("image/png", png, [("Cache-Control", "no-store")])
            elif url.path == "/info":
                body = json.dumps({
                    "n_gaussians": int(len(state.scene)),
                    "sh_dim": int(state.scene.sh_dim),
                    "device": str(state.device),
                }).encode()
                self._send("application/json", body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def build_state(args) -> ViewerState:
    """The server state for parsed ``main`` arguments."""
    if args.random_scene:
        # the bench scene's distribution (1M splats of SH degree 3 in a
        # [-4, 4]^3 box, mean scale 0.015)
        scene = random_scene(args.random_scene, sh_degree=3, seed=args.seed,
                             extent=4.0, mean_scale=0.015)
        bbox, center = scene.aabb()
    else:
        scene, bbox, center = load_scene(args.gs_model)
    scene = scene.pad_to_multiple(256)
    extent = float(np.linalg.norm(np.asarray(bbox[1]) - np.asarray(bbox[0])))
    cfg = RenderConfig(width=args.width, height=args.height)
    return ViewerState(scene, center, max(extent, 1.0), cfg, args.device,
                       args.backend)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gs-model", default=None)
    ap.add_argument("--random-scene", type=int, default=0, metavar="N",
                    help="serve N random splats instead of a scene file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "executors)")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="render() backend: the tile kernels, the tile "
                         "executor (plain PyTorch) or the exact oracle")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    state = build_state(args)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(state))
    print(
        f"serving {len(state.scene)} gaussians at http://127.0.0.1:{args.port}"
        f" on {state.device} (backend={state.backend})",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
