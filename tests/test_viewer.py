"""Viewer stack: snapshot Viewer + incremental LiveViewer (Viewer::Run /
FrameDrawer::DrawFrame parity, /root/reference/src/Viewer.cc:159)."""
import os

import numpy as np
import jax.numpy as jnp

from geoflowslam.state import map_state as M


def _mini_map():
    ms = M.create(4, 32, 64)
    uv = jnp.linspace(10, 100, 32)[:, None] * jnp.ones((1, 2))
    desc = jnp.ones((32, 8), jnp.uint32)
    ms = M.insert_keyframe(ms, jnp.int32(0), jnp.eye(3), jnp.zeros(3),
                           jnp.zeros(3), jnp.zeros(6), jnp.float32(0.0),
                           uv, jnp.zeros(32, jnp.int32), jnp.zeros(32),
                           desc, jnp.full((32,), 2.0), jnp.ones(32, bool),
                           jnp.arange(32, dtype=jnp.int32), jnp.int32(-1))
    pts = jnp.stack([jnp.linspace(-1, 1, 32), jnp.zeros(32),
                     jnp.full((32,), 3.0)], axis=1)
    ms = M.add_map_points(ms, jnp.arange(32, dtype=jnp.int32), pts, desc,
                          jnp.zeros((32, 3)), jnp.zeros(32),
                          jnp.full((32,), 100.0), jnp.int32(0),
                          jnp.ones(32, bool))
    return ms


def test_live_viewer_incremental(tmp_path):
    from geoflowslam.viewer.viewer import LiveViewer
    ms = _mini_map()
    v = LiveViewer(str(tmp_path))
    gray = np.random.default_rng(0).uniform(0, 255, (48, 64))
    uv = np.random.default_rng(1).uniform(0, 48, (32, 2))
    for i in range(3):
        p = v.update(ms, np.eye(3), np.array([0.1 * i, 0, 0]),
                     gray=gray, feat_uv=uv,
                     feat_valid=np.ones(32, bool),
                     obs_mp=np.arange(32) - 16)
        assert os.path.exists(p)
    assert v.n == 3
    gif = v.finish()
    assert gif is not None and os.path.getsize(gif) > 0


def test_snapshot_viewer(tmp_path):
    from geoflowslam.viewer.viewer import Viewer
    ms = _mini_map()
    v = Viewer(str(tmp_path))
    p1 = v.draw_map(ms, cur_rot=np.eye(3), cur_t=np.zeros(3))
    assert os.path.exists(p1) and os.path.getsize(p1) > 0


def test_interactive_html_export(tmp_path):
    """map.html: self-contained interactive 3D view (the Pangolin viewer's
    pan/rotate role, headless). Must embed the map content + the renderer
    with no external resources."""
    from geoflowslam.viewer.html_export import export_html
    ms = _mini_map()
    traj = [(float(i), np.eye(4)) for i in range(5)]
    p = export_html(ms, traj, np.eye(3), np.zeros(3),
                    path=str(tmp_path / "map.html"))
    html = open(p).read()
    assert "<canvas" in html and "addEventListener" in html
    assert '"points":' in html and '"keyframes":' in html
    assert html.count("[-1.0,") + html.count("[-1,") >= 1   # map data present
    assert "http://" not in html and "https://" not in html  # no deps
