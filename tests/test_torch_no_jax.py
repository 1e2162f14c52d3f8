"""The port never reaches for jax or the JAX package: in a fresh process
where both are unimportable, import every module of
orbslam_mapsave_tpu_torch and track one RGB-D frame on the CPU, without a
vocabulary and with a small trained one and loop closing on, then save that
map and relocalize one frame against it in reuse mode, and track a few
monocular frames through the two-view bootstrap, and one stereo pair, run
the human-pose tracker on a port PoseNet and write one HTML map view; and
no source line of the port or of chip_smoke.py imports either."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["orbslam_mapsave_tpu"] = None
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(2)
import orbslam_mapsave_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from orbslam_mapsave_tpu_torch import config
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.pipeline import system
W, H = 320, 240
K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])
gray, depth = synthetic.BoxRoom(seed=5).render(K, synthetic.orbit_trajectory(2)[0], W, H)
cfg = config.SystemConfig()
cfg.camera = config.CameraConfig(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                                 width=W, height=H, bf=16.0, th_depth=50.0)
cfg.orb = config.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 8, 4096
slam = system.SLAMSystem(cfg, system.Sensor.RGBD, enable_mapping=False, device="cpu")
pose = slam.track_rgbd(gray.astype(np.uint8), depth, 0.0)
assert pose.shape == (4, 4) and slam.n_keyframes == 1 and slam.n_points > 300
from orbslam_mapsave_tpu_torch.vocab import vocabulary
fr = slam.builder.build(gray.astype(np.uint8), 0.0, depth)
voc = vocabulary.train(fr.desc[fr.valid].numpy(), k=4, L=2, seed=1)
slam = system.SLAMSystem(cfg, system.Sensor.RGBD, vocabulary=voc, enable_loop_closing=True,
                         device="cpu")
pose = slam.track_rgbd(gray.astype(np.uint8), depth, 0.0)
store = slam.loop_closer.bow_store
assert pose.shape == (4, 4) and slam.n_keyframes == 1 and float(store.weight[0].sum()) > 0.99
slam.shutdown()
import tempfile, pathlib
path = pathlib.Path(tempfile.mkdtemp()) / "map.npz"
slam.save_map(path)
slam = system.SLAMSystem(cfg, system.Sensor.RGBD, vocabulary=voc, reuse_map_path=str(path),
                         device="cpu")
slam.track_rgbd(gray.astype(np.uint8), depth, 0.0)
assert slam.localization_only and slam.tracking_state == 2 and slam.n_keyframes == 1
mono = system.SLAMSystem(cfg, system.Sensor.MONOCULAR, vocabulary=voc, device="cpu")
for i in range(3):
    T = np.eye(4)
    T[0, 3] = 0.08 * i
    g = synthetic.BoxRoom(seed=9).render(K, T, W, H)[0].astype(np.uint8)
    mono.track_monocular(g, i / 30.0)
lost = [l for _, _, l in mono.tracker.trajectory]
assert lost[0] and not any(lost[1:]) and mono.n_keyframes >= 2 and mono.n_points > 100
assert not mono.loop_closer.fix_scale
st = system.SLAMSystem(cfg, system.Sensor.STEREO, enable_mapping=False, device="cpu")
T = np.eye(4)
T[0, 3] = 0.08
right = synthetic.BoxRoom(seed=5).render(K, synthetic.orbit_trajectory(2)[0] @ T, W, H)[0]
st.track_stereo(gray.astype(np.uint8), right.astype(np.uint8), 0.0)
assert st.n_keyframes == 1 and st.n_points > 100
from orbslam_mapsave_tpu_torch.apps import human_pose
from orbslam_mapsave_tpu_torch.models import pose_net, pose_synth
from orbslam_mapsave_tpu_torch.viz import html_viewer
net = pose_net.init_params(pose_net.PoseNet(8), torch.Generator().manual_seed(0))
det = human_pose.OpDetector(backbone=pose_net.make_backbone(net), fx=100.0, fy=100.0,
                            cx=48.0, cy=48.0)
img, _ = pose_synth.render_stick_figure(np.random.default_rng(0), 96, 96)
assert det.run_frame(img, np.full((96, 96), 2.0, np.float32)).shape == (96, 96)
assert np.isfinite(det.joints_3d).all()
page = html_viewer.export_html(slam.map, pathlib.Path(tempfile.mkdtemp()) / "v.html")
assert "__DATA__" not in page.read_text()
assert not any(m == "jax" or m.startswith(("jax.", "orbslam_mapsave_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", len(names), slam.n_points)
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


def test_sources_name_no_jax():
    """Neither the port package nor chip_smoke.py nor the long-run tool it
    imports (both run on the card, where jax is not installed) imports jax
    or the JAX package."""
    pkg = ROOT / "orbslam_mapsave_tpu_torch"
    for f in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py",
              ROOT / "tools" / "scale_endurance_torch.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), f
            assert not s.startswith(("import orbslam_mapsave_tpu.",
                                     "from orbslam_mapsave_tpu.",
                                     "from orbslam_mapsave_tpu import")), f


TOOL_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["orbslam_mapsave_tpu"] = None
sys.path.insert(0, "tools")
import numpy as np
import torch
torch.set_num_threads(2)
import scale_endurance_torch as tool
wl = tool.SCALE
gt = wl.poses(2)
frames = tool.render(wl, gt, workers=1)
slam = tool.make_system(wl, None, "cpu")
assert (slam.cfg.max_keyframes, slam.cfg.max_points, slam.cfg.max_keypoints) == (
    1536, 262144, 1024)
res = tool.drive(slam, frames, gt)
assert res["frames"] == 2 and res["lost_frames"] == [] and res["keyframes_live"] == 1
assert not any(m == "jax" or m.startswith(("jax.", "orbslam_mapsave_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_long_run_tool_runs_without_jax():
    """tools/scale_endurance_torch.py builds the reference-scale system and
    drives two frames through it with jax and the JAX package unimportable."""
    res = subprocess.run([sys.executable, "-c", TOOL_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
