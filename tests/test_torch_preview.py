"""The port's live preview (``utils/preview.py``) and ``interactive --serve``
against the JAX package's, on the CPU, over loopback.

The two ``PreviewServer``s serve identical bytes for the same pushed
frame, through PIL's JPEG and, with PIL's import taken away, through the
PNG encoder.  The camera endpoint accumulates relative keys, overwrites
absolute ones and ignores the rest.  ``interactive --serve`` serves a
frame equal to one it emitted (rounded to 8 bits with + 0.5), takes the
viewer's camera input, and its one-frame emit pipeline writes the PNGs of
the synchronous loop, in order.
"""
import dataclasses
import http.client
import pathlib
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from ai_path_tracer_denoiser_tpu.utils import preview as jax_preview
from ai_path_tracer_denoiser_tpu_torch.utils import preview
from ai_path_tracer_denoiser_tpu_torch.utils.imageio import read_png

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
MODEL = str(REPO / "artifacts" / "denoiser_multiscene.npz")


def read_part(port, timeout=20):
    """The first part of ``/stream``: (content type, bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert resp.status == 200
        assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
        return _part(resp)
    finally:
        conn.close()


def _part(resp):
    assert b"--frame" in resp.fp.readline()
    ctype = resp.fp.readline().split(b":")[1].strip().decode()
    clen = int(resp.fp.readline().split(b":")[1])
    resp.fp.readline()
    return ctype, resp.fp.read(clen)


def _frame(seed=0, h=24, w=40):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    frame[:4] = 0.5 / 255.0                       # the rounding's halfway point
    return frame


@pytest.mark.parametrize("branch", ["jpeg", "png"])
def test_served_bytes_equal_the_jax_servers(branch, monkeypatch):
    if branch == "png":
        monkeypatch.setitem(sys.modules, "PIL", None)    # PIL's import fails
    frame = _frame()
    parts = []
    for module in (jax_preview, preview):
        server = module.PreviewServer(port=0)
        try:
            server.push(frame)
            parts.append(read_part(server.port))
            page = urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=10)
            assert page.status == 200 and page.read() == jax_preview._PAGE
        finally:
            server.close()
    assert parts[0] == parts[1]
    mime, data = parts[1]
    quantised = (np.clip(frame, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if branch == "png":
        from ai_path_tracer_denoiser_tpu_torch.utils.imageio import encode_png
        assert mime == "image/png" and data == encode_png(quantised)
    else:
        assert mime == "image/jpeg" and data[:2] == b"\xff\xd8"
    assert preview._encode(quantised) == parts[1]


def test_push_takes_uint8_as_it_is_and_keeps_only_the_newest(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    server = preview.PreviewServer(port=0)
    try:
        first = np.full((8, 8, 3), 7, np.uint8)
        newest = np.full((8, 8, 3), 200, np.uint8)
        server.push(first)
        server.push(newest)
        _, data = read_part(server.port)
        from ai_path_tracer_denoiser_tpu_torch.utils.imageio import encode_png
        assert data == encode_png(newest)
    finally:
        server.close()


def test_camera_endpoint_accumulates_overwrites_and_ignores():
    server = preview.PreviewServer(port=0)
    try:
        assert server._httpd.server_address[0] == "127.0.0.1"       # loopback
        base = f"http://127.0.0.1:{server.port}"
        for q in ("dphi=0.1", "dphi=0.2&theta=1.5", "zoom=9&junk=1&phi=abc",
                  "dzoom=-0.5&dtheta=x"):
            assert urllib.request.urlopen(f"{base}/camera?{q}", timeout=5).status == 204
        cam = server.pop_camera()
        assert abs(cam["dphi"] - 0.3) < 1e-9 and cam["theta"] == 1.5
        assert cam["zoom"] == 9.0 and cam["dzoom"] == -0.5
        assert set(cam) == {"dphi", "theta", "zoom", "dzoom"}
        assert server.pop_camera() == {}
    finally:
        server.close()


def free_port():
    """A loopback port that was free a moment ago (``--serve 0`` means off)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_interactive(argv, camera_query=None):
    """Run ``interactive`` with ``argv`` (which holds ``--serve``): a viewer
    joins ``/stream`` before the first frame is made (and, with
    ``camera_query``, sends ``/camera?...`` first), and reads one part.
    Returns (records, (mime, bytes) of the part, arrays pushed)."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import main
    joined, got = threading.Event(), {}
    pushed = []
    orig_pop, orig_push = preview.PreviewServer.pop_camera, preview.PreviewServer.push

    def viewer(port):
        if camera_query:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/camera?{camera_query}",
                                   timeout=10).read()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        joined.set()
        got["part"] = _part(resp)
        conn.close()

    def pop_camera(self):
        if not joined.is_set():
            thread = threading.Thread(target=viewer, args=(self.port,), daemon=True)
            thread.start()
            got["thread"] = thread
            assert joined.wait(30)
        return orig_pop(self)

    def push(self, frame):
        pushed.append(np.array(frame))
        return orig_push(self, frame)

    preview.PreviewServer.pop_camera, preview.PreviewServer.push = pop_camera, push
    try:
        records = main(argv)
    finally:
        preview.PreviewServer.pop_camera, preview.PreviewServer.push = orig_pop, orig_push
    got["thread"].join(30)
    assert not got["thread"].is_alive()
    return records, got["part"], pushed


def test_interactive_serve_streams_an_emitted_frame(tmp_path, monkeypatch):
    """``--serve PORT`` at 32x32, 2 frames, the viewer turning the camera:
    the served part is an emitted frame, the camera moved."""
    from ai_path_tracer_denoiser_tpu_torch.scene import camera
    phis = []
    orig = camera.orbit_camera
    monkeypatch.setattr(camera, "orbit_camera",
                        lambda cam, phi, theta, zoom: phis.append(phi) or orig(cam, phi, theta,
                                                                               zoom))
    argv = ["interactive", "scenes/cornell_box.txt", "--device", "cpu", "--res", "32",
            "--frames", "2", "--dphi", "0.05", "--model", MODEL, "--save-arrays",
            "--out-dir", str(tmp_path), "--serve", str(free_port()),
            "--serve-host", "127.0.0.1"]
    records, (mime, data), pushed = serve_interactive(argv, camera_query="dphi=0.5")
    assert [r["frame"] for r in records] == [0, 1] and all(r["finite"] for r in records)
    assert len(pushed) == 2
    emitted = [np.clip(np.load(r["path"][:-4] + "_denoised.npy"), 0, 1) for r in records]
    for a, b in zip(pushed, emitted):
        np.testing.assert_array_equal(a, b)
    encoded = [preview._encode((e * 255.0 + 0.5).astype(np.uint8)) for e in emitted]
    assert (mime, data) in encoded
    base = phis[0] - 0.5                      # the viewer's dphi reached frame 0
    assert len(phis) == 2 and abs(phis[1] - (base + 0.55)) < 1e-9
    assert records[0]["emitted_s"] < records[1]["emitted_s"]


def test_emit_pipeline_writes_the_synchronous_loops_frames(tmp_path):
    """The one-frame pipeline against the loop written out synchronously:
    render, denoise, write, frame by frame; equal PNGs in the same order."""
    from ai_path_tracer_denoiser_tpu_torch.app.cli import _load_scene_scaled, main
    from ai_path_tracer_denoiser_tpu_torch.models import (init_hidden, load_model,
                                                          model_options_from_meta,
                                                          prepare_inference)
    from ai_path_tracer_denoiser_tpu_torch.models.inference import apply_frame_fast_padded
    from ai_path_tracer_denoiser_tpu_torch.render import render_gbuffer_frame
    from ai_path_tracer_denoiser_tpu_torch.scene.camera import (orbit_camera,
                                                                orbit_params_from_camera)
    from ai_path_tracer_denoiser_tpu_torch.utils.imageio import save_png_scaled
    records = main(["interactive", "scenes/cornell_box.txt", "--device", "cpu", "--res", "40",
                    "--frames", "3", "--dphi", "0.1", "--model", MODEL,
                    "--out-dir", str(tmp_path / "pipe")])
    assert [r["frame"] for r in records] == [0, 1, 2]
    assert [r["emitted_s"] for r in records] == sorted(r["emitted_s"] for r in records)
    scene = _load_scene_scaled("scenes/cornell_box.txt", "cpu", 40)
    params, bn, meta = load_model(MODEL, device="cpu")
    mopts = model_options_from_meta(meta)
    folded = prepare_inference(params, bn, mopts)
    hidden = init_hidden(1, 64, 64, mopts, dtype=torch.bfloat16)
    phi, theta, zoom = orbit_params_from_camera(scene.camera)
    (tmp_path / "sync").mkdir()
    for frame, rec in enumerate(records):
        if frame:
            phi += 0.1
        fscene = dataclasses.replace(scene, camera=orbit_camera(scene.camera, phi, theta, zoom))
        _, gbuffer, _ = render_gbuffer_frame(fscene)
        y, hidden = apply_frame_fast_padded(folded, gbuffer.permute(1, 2, 0)[None], hidden,
                                            mopts)
        want = save_png_scaled(str(tmp_path / "sync" / f"frame_{frame:04d}"),
                               y[0].clamp(0, 1).numpy())
        assert rec["path"].endswith(f"frame_{frame:04d}.png")
        np.testing.assert_array_equal(read_png(rec["path"]), read_png(want))
        assert open(rec["path"], "rb").read() == open(want, "rb").read()


def test_a_viewer_waiting_for_the_first_frame_does_not_spin():
    """A ``/stream`` viewer that joins before any push waits on the
    condition: the process spends well under the wall time on the CPU."""
    import time
    server = preview.PreviewServer(port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        cpu0, wall0 = time.process_time(), time.perf_counter()
        time.sleep(0.6)
        cpu, wall = time.process_time() - cpu0, time.perf_counter() - wall0
        assert cpu < 0.3 * wall, (cpu, wall)
        server.push(np.zeros((4, 4, 3), np.float32))
        assert _part(resp)[1]
        conn.close()
    finally:
        server.close()
