"""Live visualization: in-process HTTP point-cloud viewer.

The reference runs PCL/VTK visualizer threads fed by a viz queue with
windowed eviction of per-keyframe clouds and pose frusta
(/root/reference/run/pipeline.cpp:826-985, run/viz_lidar_udp.cpp:38-110).
PCL/VTK need a local display; this equivalent serves the same state —
a sliding window of downsampled world-frame keyframe clouds plus the
trajectory — over a localhost HTTP endpoint to a self-contained HTML5
canvas renderer (no external assets), so it works over any SSH port forward.

Usage (apps wire this behind ``--viz``):

    viewer = LiveViewer(port=8433)
    ...
    viewer.push_cloud(points_world, frame_id)   # per keyframe
    viewer.push_pose(xyz)                       # trajectory point
    print(viewer.url)

Transport: the browser polls ``/data?seq=N``; the server answers 304-style
(empty, same seq) when nothing changed, else one little-endian binary blob:

    uint32 seq | uint32 n_traj | uint32 n_ins | uint32 n_pts
    | f32 traj[n_traj*3] | f32 ins[n_ins*3]
    | f32 pts[n_pts*4]                      (x, y, z, intensity)

Two trajectories ride the blob because the reference's live drift
diagnostic is the optimized-vs-raw-INS overlay (red vs green polylines,
run/pipeline.cpp:862-864); points carry the intensity channel and the
client colors by it when present (pipeline.cpp:919), falling back to
height coloring for intensity-less clouds.

Everything is float32 NED; the client flips to screen coordinates.
"""
from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>slamtpu live</title><style>
html,body{margin:0;height:100%;background:#10141a;color:#cfd8e3;
font:12px/1.4 system-ui,sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:10px;user-select:none}
#hud b{color:#8ecbff}
canvas{display:block;width:100vw;height:100vh;cursor:grab}
</style></head><body>
<div id="hud"><b>slamtpu</b> live viewer &mdash; drag: orbit, wheel: zoom,
shift-drag: pan &mdash; <span id="st">connecting&hellip;</span></div>
<canvas id="cv"></canvas>
<script>
"use strict";
const cv = document.getElementById("cv"), st = document.getElementById("st");
const ctx = cv.getContext("2d");
let pts = new Float32Array(0), traj = new Float32Array(0),
    ins = new Float32Array(0), seq = 0;
let yaw = -0.7, pitch = 0.9, dist = 80, cx = 0, cy = 0, cz = 0;
let drag = null;
cv.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey}; cv.style.cursor = "grabbing";});
window.addEventListener("mouseup", () => {drag = null; cv.style.cursor = "grab";});
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.pan) {
    const s = dist / 500;
    cx -= (Math.cos(yaw) * dx - Math.sin(yaw) * dy) * s;
    cy -= (-Math.sin(yaw) * dx - Math.cos(yaw) * dy) * s;
  } else { yaw -= dx * 0.008; pitch = Math.min(1.55, Math.max(-1.55, pitch + dy * 0.008)); }
  drag = {x: e.clientX, y: e.clientY, pan: drag.pan}; draw();});
cv.addEventListener("wheel", e => {
  e.preventDefault(); dist *= Math.exp(e.deltaY * 0.001); draw();}, {passive: false});
function resize() {cv.width = innerWidth; cv.height = innerHeight; draw();}
window.addEventListener("resize", resize);
function draw() {
  const W = cv.width, H = cv.height;
  const img = ctx.createImageData(W, H), d = img.data;
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 0.9 * Math.min(W, H);
  // NED world -> view: yaw about z(down), pitch; z up on screen
  function proj(x, y, z, out) {
    x -= cx; y -= cy; z -= cz;
    const vx = cyaw * x + syaw * y, vy = -syaw * x + cyaw * y;
    const vz = cp * (-z) + sp * vx, depth = dist + cp * vx - sp * (-z);
    if (depth < 1) return false;
    out[0] = (W >> 1) + f * vy / depth; out[1] = (H >> 1) - f * vz / depth;
    out[2] = depth; return true;
  }
  const o = [0, 0, 0];
  // reference parity: color by intensity when the clouds carry one
  // (pipeline.cpp:919's intensity handler); height ramp otherwise
  let hasInt = false;
  for (let i = 3; i < pts.length; i += 4)
    if (pts[i] > 0) { hasInt = true; break; }
  for (let i = 0; i < pts.length; i += 4) {
    if (!proj(pts[i], pts[i + 1], pts[i + 2], o)) continue;
    const px = o[0] | 0, py = o[1] | 0;
    if (px < 0 || px >= W || py < 0 || py >= H) continue;
    const dim = Math.min(1, 30 / o[2] + 0.55);
    const k = (py * W + px) * 4;
    if (hasInt) {
      // intensity ramp: dark steel -> bright warm (reflectivity 0..255)
      const t = Math.min(1, pts[i + 3] / 255);
      d[k] = (50 + 205 * t) * dim; d[k + 1] = (60 + 170 * t) * dim;
      d[k + 2] = (80 + 95 * t) * dim; d[k + 3] = 255;
    } else {
      // color by height (-z in NED): blue floor -> warm high
      const h = Math.min(1, Math.max(0, (-pts[i + 2] - cz0) * 0.12 + 0.35));
      d[k] = 40 + 215 * h * dim; d[k + 1] = (90 + 120 * (1 - Math.abs(h - .5) * 2)) * dim;
      d[k + 2] = 70 + 185 * (1 - h) * dim; d[k + 3] = 255;
    }
  }
  ctx.putImageData(img, 0, 0);
  // dual trajectory overlay, reference colors (pipeline.cpp:862-864):
  // optimized = red, raw INS = green — the live drift diagnostic
  function polyline(arr, color) {
    if (arr.length < 6) return;
    ctx.strokeStyle = color; ctx.lineWidth = 1.6; ctx.beginPath();
    let first = true;
    for (let i = 0; i < arr.length; i += 3) {
      if (!proj(arr[i], arr[i + 1], arr[i + 2], o)) continue;
      if (first) {ctx.moveTo(o[0], o[1]); first = false;} else ctx.lineTo(o[0], o[1]);
    }
    ctx.stroke();
    if (proj(arr[arr.length - 3], arr[arr.length - 2], arr[arr.length - 1], o)) {
      ctx.fillStyle = color; ctx.beginPath();
      ctx.arc(o[0], o[1], 4, 0, 6.284); ctx.fill();
    }
  }
  polyline(ins, "#58d68d");
  polyline(traj, "#ff5b5b");
}
let cz0 = 0;
async function poll() {
  try {
    const r = await fetch("/data?seq=" + seq);
    const buf = await r.arrayBuffer();
    if (buf.byteLength >= 16) {
      const hd = new Uint32Array(buf, 0, 4);
      if (hd[0] !== seq) {
        seq = hd[0];
        traj = new Float32Array(buf, 16, hd[1] * 3);
        ins = new Float32Array(buf, 16 + hd[1] * 12, hd[2] * 3);
        pts = new Float32Array(buf, 16 + (hd[1] + hd[2]) * 12, hd[3] * 4);
        if (traj.length >= 3) {
          cx = traj[traj.length - 3]; cy = traj[traj.length - 2];
          cz = traj[traj.length - 1]; cz0 = cz;
        }
        st.textContent = "seq " + seq + " | " + hd[3] + " pts | " +
          hd[1] + " poses (red=optimized, green=INS)";
        draw();
      }
    }
  } catch (e) { st.textContent = "disconnected"; }
  setTimeout(poll, 250);
}
resize(); poll();
</script></body></html>"""


class LiveViewer:
    """Thread-backed HTTP viewer of a sliding window of keyframe clouds.

    ``max_clouds`` mirrors the reference's windowed eviction of viz clouds
    (pipeline.cpp:854,894-901); ``max_points_per_cloud`` bounds the memory
    and render cost per keyframe (host-side stride downsample — callers may
    pre-downsample further).
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        max_clouds: int = 40,
        max_points_per_cloud: int = 20000,
    ):
        self.max_clouds = max_clouds
        self.max_points = max_points_per_cloud
        self._lock = threading.Lock()
        self._clouds: Deque[Tuple[int, np.ndarray]] = deque(maxlen=max_clouds)
        self._traj: List[np.ndarray] = []
        self._ins: List[np.ndarray] = []  # raw INS overlay (pipeline.cpp:862-864)
        self._seq = 0
        self._blob: Optional[bytes] = None

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/data":
                    q = parse_qs(u.query)
                    have = int(q.get("seq", ["-1"])[0])
                    blob = viewer._snapshot(have)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="slamtpu-viewer", daemon=True
        )
        self._thread.start()

    # -- producer side -------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def push_cloud(
        self,
        points: np.ndarray,
        frame_id: int = 0,
        intensity: Optional[np.ndarray] = None,
    ) -> None:
        """Add a world-frame cloud to the sliding window: (M, 3) xyz, or
        (M, 4) with the intensity channel packed as the last column."""
        pts = np.asarray(points, np.float32)
        if pts.ndim == 2 and pts.shape[1] == 4:
            if intensity is None:
                intensity = pts[:, 3]
            pts = pts[:, :3]
        pts = pts.reshape(-1, 3)
        if pts.shape[0] > self.max_points:
            stride = -(-pts.shape[0] // self.max_points)  # ceil div
            pts = pts[::stride]
            if intensity is not None:
                intensity = np.asarray(intensity)[::stride]
        inten = (
            np.asarray(intensity, np.float32).reshape(-1, 1)
            if intensity is not None
            else np.zeros((pts.shape[0], 1), np.float32)
        )
        packed = np.concatenate([pts, inten[: pts.shape[0]]], axis=1)
        with self._lock:
            self._clouds.append((int(frame_id), packed))
            self._seq += 1
            self._blob = None

    def push_pose(self, xyz, ins_xyz=None) -> None:
        """Append a trajectory vertex (world xyz); optionally the raw INS
        position at the same keyframe for the drift-diagnostic overlay (the
        reference draws both, optimized red vs INS green,
        run/pipeline.cpp:862-864)."""
        with self._lock:
            self._traj.append(np.asarray(xyz, np.float32).reshape(3))
            if ins_xyz is not None:
                self._ins.append(np.asarray(ins_xyz, np.float32).reshape(3))
            self._seq += 1
            self._blob = None

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- consumer side ---------------------------------------------------
    def _snapshot(self, client_seq: int) -> bytes:
        with self._lock:
            if client_seq == self._seq:
                return struct.pack("<IIII", self._seq, 0, 0, 0)
            if self._blob is None:
                traj = (
                    np.stack(self._traj)
                    if self._traj
                    else np.zeros((0, 3), np.float32)
                )
                ins = (
                    np.stack(self._ins)
                    if self._ins
                    else np.zeros((0, 3), np.float32)
                )
                pts = (
                    np.concatenate([c for _, c in self._clouds])
                    if self._clouds
                    else np.zeros((0, 4), np.float32)
                )
                self._blob = (
                    struct.pack(
                        "<IIII", self._seq, traj.shape[0], ins.shape[0],
                        pts.shape[0],
                    )
                    + traj.astype("<f4").tobytes()
                    + ins.astype("<f4").tobytes()
                    + pts.astype("<f4").tobytes()
                )
            return self._blob

    def wait_forever(self):  # pragma: no cover - interactive use
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.close()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
