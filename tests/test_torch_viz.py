"""Parity: the port's viewer (`viz/`) against the JAX package's, on the CPU.

- `export_html` from a port `MapState` converted from the JAX one (the
  state of `test_html_viewer.py`) writes the JAX file byte for byte, with
  and without the live-refresh header;
- the live rewrite happens at the same keyframe counts, read from the
  tracker's host-side count;
- frame overlays equal the JAX ones; the viewer writes its frame and map
  PNGs (matplotlib and Pillow are installed here), and the map PNG is the
  JAX one byte for byte;
- `host_fields` fetches each field with its dtype, values unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu.viz import frame_drawer as jfd
from orbslam_mapsave_tpu.viz import html_viewer as jhv
from orbslam_mapsave_tpu.viz import map_drawer as jmd
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.viz import frame_drawer as tfd
from orbslam_mapsave_tpu_torch.viz import html_viewer as thv
from orbslam_mapsave_tpu_torch.viz import map_drawer as tmd
from orbslam_mapsave_tpu_torch.viz.viewer import Viewer, tracked_twc


@pytest.fixture(scope="module")
def states():
    st = jms.empty_map(8, 256, 32)
    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.3]
    st = st._replace(
        pt_valid=st.pt_valid.at[:50].set(True),
        pt_pos=st.pt_pos.at[:50].set(jnp.asarray(rng.random((50, 3)))),
        pt_obs_kf=st.pt_obs_kf.at[:20, 0].set(1).at[:5, 1].set(2),
        kf_valid=st.kf_valid.at[:3].set(True),
        kf_pose=st.kf_pose.at[1].set(jnp.asarray(pose)),
        covis=st.covis.at[0, 1].set(120).at[1, 0].set(120).at[1, 2].set(30).at[2, 1].set(30),
        kf_parent=st.kf_parent.at[1].set(0).at[2].set(1),
    )
    return st, interop.map_state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()})


@pytest.mark.parametrize("live", [None, 2.0])
def test_export_html_byte_identical(states, tmp_path, live):
    js, ts = states
    kw = dict(trajectory=np.stack([np.eye(4)] * 5), current_pose_cw=np.eye(4),
              live_refresh=live, gen=3)
    a = jhv.export_html(js, tmp_path / "j.html", **kw).read_bytes()
    b = thv.export_html(ts, tmp_path / "t.html", **kw).read_bytes()
    assert a == b
    s = b.decode()
    assert "__DATA__" not in s and '"covis_strong": [[0, 1, 120]]' in s
    assert ('http-equiv="refresh"' in s) == bool(live)


def test_host_fields_keep_dtypes(states):
    _, ts = states
    h = tmd.host_fields(ts, ("pt_valid", "pt_pos", "covis", "kf_parent"))
    for k, v in h.items():
        ref = getattr(ts, k).numpy()
        assert v.dtype == ref.dtype and v.shape == ref.shape, k
        np.testing.assert_array_equal(v, ref)


class _Tracker:
    def __init__(self, trajectory):
        self.n_kf = 1
        self.trajectory = trajectory


class _System:
    def __init__(self, state, trajectory=()):
        self.map = state
        self.tracker = _Tracker(list(trajectory))
        self.tracking_state = 2
        self.n_keyframes = 3
        self.n_points = 50


def test_live_rewrite_counts_host_keyframes(states, tmp_path):
    """As `test_html_viewer.test_live_html_rewrites`: no rewrite at one
    keyframe, one at three, with the keyframe count read from the
    tracker (no device read); the page equals the JAX viewer's at the same
    counts."""
    from orbslam_mapsave_tpu.viz.viewer import Viewer as JViewer

    js, ts = states
    sys_ = _System(ts)
    out = tmp_path / "live.html"
    v = Viewer(sys_, out_dir=tmp_path / "v", every_n=10**9, live_html=out, live_every_kfs=2)

    class JSystem:
        map = js
        n_keyframes = 1

    jv = JViewer(JSystem, out_dir=tmp_path / "jv", every_n=10**9,
                 live_html=tmp_path / "jlive.html", live_every_kfs=2)
    frame = type("F", (), {"kp_xy": np.zeros((1, 2)), "valid": np.zeros(1, bool)})
    gens = []
    for n_kf in (1, 1, 3, 4, 5):
        sys_.tracker.n_kf = JSystem.n_keyframes = n_kf
        v.update(np.zeros((4, 4)), frame, None)
        jv.update(np.zeros((4, 4)), frame, None)
        gens.append((v._live_gen, jv._live_gen))
    assert gens == [(0, 0), (0, 0), (1, 1), (1, 1), (2, 2)]
    assert out.read_bytes() == (tmp_path / "jlive.html").read_bytes()
    assert '"gen": 2' in out.read_text()


def test_viewer_pngs(states, tmp_path):
    """Every `every_n`-th frame writes a frame overlay and a map PNG, from
    torch tensors (a frame's keypoints, the current pose); the overlay is
    the JAX drawer's and the map PNG the JAX drawer's file."""
    pytest.importorskip("PIL")
    from PIL import Image

    js, ts = states
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 255, (48, 64)).astype(np.uint8)
    xy = rng.uniform(0, 64, (30, 2)).astype(np.float32)
    valid = rng.random(30) > 0.3
    frame = type("F", (), {"kp_xy": torch.from_numpy(xy), "valid": torch.from_numpy(valid)})
    pose = torch.eye(4)
    v = Viewer(_System(ts, [(0.0, np.eye(4), False), (0.1, np.eye(4), True)]),
               out_dir=tmp_path / "v", every_n=2)
    for _ in range(4):
        v.update(gray, frame, pose)
    names = sorted(p.name for p in (tmp_path / "v").iterdir())
    assert names == ["frame_000002.png", "frame_000004.png", "map_000002.png",
                     "map_000004.png"]
    img = np.asarray(Image.open(tmp_path / "v" / "frame_000002.png"))
    ref = jfd.draw_frame(gray, xy, valid, state=2, n_kfs=3, n_points=50)
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(tfd.draw_frame(gray, xy, valid, state=2, n_kfs=3,
                                                 n_points=50), ref)
    jmd.save_map_png(js, str(tmp_path / "j.png"), current_pose_cw=np.eye(4, dtype=np.float32))
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "v" / "map_000004.png").read_bytes()
    assert tracked_twc(v.system.tracker.trajectory).shape == (1, 4, 4)
    assert tracked_twc([]) is None
    html = v.export_html(tmp_path / "view.html").read_text()
    assert '"traj": [[0.0, 0.0, 0.0]]' in html
