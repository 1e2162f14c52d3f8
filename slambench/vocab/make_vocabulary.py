"""Train the deployments' vocabulary once and write it in the fork's
binary format (`vocabulary.save_binary`), so that no run trains one.

    python3 slambench/vocab/make_vocabulary.py [--device cpu]

k = 10, L = 4, seed 1 over the ORB descriptors that the port's own
FrameBuilder (the RGB-D configuration's camera and ORB settings) extracts
from every 12th frame of the room-loop episode at start angle 0. Only the
frame builder runs, so the map is made at a token size.
"""

import argparse
import json
import sys
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import numpy as np  # noqa: E402

import episode  # noqa: E402
import harness  # noqa: E402

STEP = 12
CONFIG = "rgbd-1280x720-orb2000"
OUT = HERE / "room-1280x720-k10-L4.bin"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "room-loop.json").read_text())
    tr, room_cfg, cam = traffic["trajectory"], traffic["room"], cfg["camera"]
    poses = episode.circle_trajectory(tr["frames"], radius=tr["radius"], revs=tr["revs"],
                                      height_bob=tr["height_bob"], start=0.0)
    room = episode.BoxRoom(room_cfg["half_size"], room_cfg["tex_size"], room_cfg["seed"])
    idx = np.arange(0, tr["frames"], STEP)
    frames = episode.render_frames(room, episode.intrinsics(cam), poses[idx], cam["width"],
                                   cam["height"], args.device, cam["depth_map_factor"], chunk=2)
    sc = harness.system_config(cfg)
    sc.max_keyframes, sc.max_points = 4, 1024
    slam = system_mod.SLAMSystem(sc, system_mod.Sensor.RGBD, enable_mapping=False,
                                 device=args.device)
    descs = []
    for (g, d), i in zip(frames, idx):
        fr = slam.builder.build(g, float(i) / cam["fps"], d)
        descs.append(fr.desc[fr.valid].cpu().numpy())
    voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
    vocabulary.save_binary(OUT, voc)
    print(f"{OUT.name}: {voc.n_words} words, {OUT.stat().st_size} bytes, "
          f"from {sum(len(d) for d in descs)} descriptors of {len(idx)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
