"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — compiles the pose-LM kernel (csrc/pose_lm.cu) with nvcc and
              prints ptxas's report; any register spill fails.
3. kernel   — the kernel against its plain PyTorch version on the card at
              M = 2048, 900, 1024 edges and B = 1, 4 problems: pose max-abs
              <= 1e-4, identical inlier sets and counts (a flip is accepted
              only within 1e-4 relative of its chi2 gate, and printed), two
              runs bit-identical; all-invalid and all-behind edge sets return
              the input pose. Then CUDA-event timings (median of 50) at
              M = 2048, B = 1 and 4: one synchronous call of the wrapper
              (its one launch), the kernel alone (replays of a CUDA graph
              of launches), the plain version (B = 1), per-LM-iteration
              microseconds as (t(n_iters=10) - t(n_iters=5)) / 20 at M = 2048
              and M = 128, and the share of an iteration that grows with M.
              Then the monocular path's problem, M = 2048 with every edge
              mono (ur = -1), and the stereo path's, every edge given its
              right-image u (1,927 of them on the image, ur >= 0, the rest
              mono): pose <= 1e-4 from the plain version, no inlier flip,
              timed and bounded alike.
4. slice    — the benchmark sequence (bench.py: 640x480, 2000 ORB features,
              circle_trajectory(240, radius=0.55, revs=1.30) in a
              BoxRoom(2.0, seed=11), u8 image + f16 depth) through
              SLAMSystem RGB-D tracking only (enable_mapping=False) at
              max_keypoints=2048, max_keyframes=64, max_points=32768: no
              frame lost, keyframe count within 20% of the JAX package's
              CPU run, keyframe ATE within 1 cm of it, and exactly one
              pose-LM launch per pose optimization (>= 2 per tracked frame).
5. mapping  — the same sequence through SLAMSystem(cfg, RGBD) with its
              default local mapping (the bench with BENCH_NO_LOOP=1): no
              frame lost, keyframes within 20% and keyframe ATE within 1 cm
              of the JAX CPU run with mapping, no BA lane dropped, one
              pose-LM launch per pose optimization; frames/s, p50/p99 ms per
              frame and p50/p99 ms per mapping step (host clock, synced).
6. map step — one mapping step from a state captured in phase 5, run twice
              on the card (bit-identical) and once on the CPU: poses and
              points within 1e-3, the same kf_valid, live points within
              0.5%; the differences are printed.
7. loop     — bench.py's headline workload: SLAMSystem with a vocabulary
              trained from the sequence (bench.py:88-107) and loop closing
              on; one full untimed pass, flush_gba(), reset(), then the
              timed pass, as a user runs it: no frame lost, the JAX CPU
              run's loop count, keyframes within 20%, keyframe ATE within
              1 cm, one pose-LM launch per pose optimization, every loop's
              global-BA job applied, no BA lane dropped; frames/s,
              p50/p99/max ms per frame. Then reset() and one more untimed
              pass with each loop stage wrapped from here (ms, host clock,
              synced) and the first loop correction's inputs kept; it must
              close the same loops.
8. loop replay — the first loop correction from its captured inputs
              (correction, essential graph, one global-BA iteration) twice
              on the card (bit-identical) and once on the CPU: poses and
              points within 1e-3, equal kf_valid and loop edges. Then the
              essential graph on the corrected map with the pose-graph
              solver's early exit and with its full 20-iteration loop:
              every map field bit-equal (dense route). Then the
              essential graph's solve on its live edges from perturbed
              start poses (the loop closer's own solve returns its input):
              twice on the card (bit-identical), once on the CPU, Sim3
              poses within 1e-4 and moved by more than that.
    mono    — tools/bench_mono.py's workload: SLAMSystem(cfg, MONOCULAR)
              over the u8 images of the sequence (max_keyframes=96) with
              phase 7's vocabulary and loop closing on (Sim3 with a free
              scale); untimed over the first 24 frames, reset(), one timed
              pass: the bootstrap on the JAX CPU run's frame, its lost
              frames, keyframes within 20%, Sim3-aligned keyframe ATE within
              1 cm, its loop count, every loop's global-BA job applied, no
              BA lane dropped, one pose-LM launch per pose optimization;
              frames/s, p50/p99/max ms, the bootstrap's initializer and GBA
              ms and the loop stages' ms (synced inside the timed pass).
    stereo  — the stereo workload: SLAMSystem(cfg, STEREO) at SystemConfig's
              default capacities (512 keyframes, 65,536 points, 2,048
              keypoints, what `run_slam --sensor stereo` runs) over the u8
              images of the sequence with right images rendered from each
              pose moved 0.08 m along the camera x axis (bf = 41.6, the
              bench camera's), phase 7's vocabulary and loop closing on;
              untimed over 24 frames, reset(), one timed pass: lost frames
              no more than the JAX CPU run's, keyframes within 20%, kf ATE
              within 1 cm, its loop count, every loop's global-BA job
              applied and none aborted, no BA lane dropped, one pose-LM
              launch per pose optimization, and at least one loop whose
              essential graph ran the CG solver and whose job ran pcg_dual
              (the routes past K = 384 and past a 2 GiB one-hot); frames/s,
              p50/p99/max ms and the loop stages' ms (synced). The first
              loop's essential graph again with the solver's early exit
              and with its full loop: every map field bit-equal (CG).
9. kidnap   — lost and found in the headline configuration: SLAMSystem with
              phase 7's vocabulary over frames 0-149, 3 blank frames (zero
              image and depth), then the images of frames 100-239 with
              timestamps that continue the clock: LOST on the blanks,
              relocalization (BoW candidates, batched EPnP RANSAC, one
              pose-LM launch of B = candidates per LM step) on the resumed
              frames, printed beside the JAX CPU run's frame; keyframes
              within 20% and keyframe ATE within 1 cm of the JAX CPU run;
              at least the JAX CPU run's loops (one-sided: the port's own
              vocabulary may close more), each loop's global-BA job applied.
              Each attempt and its stages are timed (synced) and its
              candidates and inliers printed; pose-LM launches at B > 1 and
              B = 1 are counted.
10. reuse   — the map of phase 7's timed pass, saved there with its BoW
              rows (`save_map`), loaded by SLAMSystem(cfg, RGBD,
              vocabulary, reuse_map_path=...): it starts LOST in
              localization-only mode, uses the persisted rows without a
              rebuild, and runs the 240 frames: the first relocalized frame
              as the JAX CPU run's, localized frames within 10% of it, their
              ATE within 1 cm of it, keyframes and points exactly those of
              the loaded map; frames/s, p50/p99 ms, save and load ms, file
              MB. A second load from a file without BoW rows rebuilds rows
              equal to the persisted ones. One relocalization batch's
              pose-LM launch (the run's first at B > 1), and the same batch
              padded to B = 5 as the JAX relocalizer pads it, against the
              plain version per candidate (pose 1e-4, inlier flips only at a
              gate), timed as one synchronous call and as CUDA-graph device
              time; each candidate's kernel and plain-f32 poses against the
              plain version in float64 are printed, with how far plain f32
              lands from float64 over 12 shuffled edge orders.
    cli     — the other entry points on the card: `SLAMSystem.load_map` on
              a system that has mapped 30 frames (continues LOST in
              localization-only mode, relocalizes, leaves the loaded map as
              it is), and `apps/run_slam.py --save-map`, then `--reuse-map`,
              on a TUM copy of 60 bench frames (needs Pillow to read PNGs),
              `--sensor mono` on the same images, and `--sensor stereo` on a
              KITTI-layout copy of them.
    apps    — the application layer on the card, after `cli` and on its TUM
              copy: PoseNet trained from the stick-figure renderer
              (96x96, width 32, 220 steps of 16) to a mean joint error
              under 8 px; PoseNet at full width (64) on the reference's
              176x320 input, the card's forward against the CPU's (same
              weights and dtypes: heatmaps 0.05, joints 0.5 px, confidence
              1e-2) and timed (CUDA events, median of 50); the gait chain on
              the trained backbone (OpDetector: Kalman, 3D lift at 2 m within
              0.3 m, the mask over the hip, finite gait angles) and the UDP
              robot's command sent and received over 127.0.0.1; human-masked
              ORB on a 640x480 bench frame (no valid keypoint inside the mask
              at its level's resize, every keypoint the unmasked build also
              has keeps its descriptor); `run_slam` without and with
              `--viewer-dir --html-view --html-live 5` (>= 55 of 60 frames
              tracked, the map embedded in the page, the live page rewritten,
              one pose-LM launch per pose optimization, the PNGs where
              matplotlib and Pillow import); `bin_vocabulary --train` on the
              card and .bin -> .txt -> .bin; `NativeTUMDataset` against
              `TUMDataset`; `change_calibration` after 20 frames, the next 20
              tracked; ArUco where cv2.aruco imports.
    endurance — tools/endurance.py's long run (after `apps`): 1,200 frames of
              circle_trajectory(1200, radius=0.55, revs=2.6) in the bench room
              at 640x480, 2,000 features, max_keyframes 256 and max_points
              49,152 (the point allocator crosses the 0.9 compaction trigger
              inside the run), phase 7's vocabulary and loop closing on; rendered in
              a pool of processes, untimed over 24 frames, reset(), one timed
              pass through tools/scale_endurance_torch.drive: lost frames no
              more than the JAX CPU run's, keyframes within 20%, kf ATE within
              1 cm, at least its loops, a point and a keyframe compaction
              wherever it has one, every loop's global-BA job applied (or
              aborted by a newer loop), 0 BA lanes dropped, one pose-LM launch
              per pose optimization, and every live keyframe's BoW row equal
              to the row rebuilt from its descriptors; frames/s, p50/p99/max
              ms, ms per compaction, escalations, peak device memory.
    scale   — tools/scale_endurance.py's reference scale: the first
              SCALE_FRAMES frames of its 8,000-frame Lissajous sweep at
              320x240, 1,000 features, max_keyframes 1,536, max_points
              262,144, max_keypoints 1,024, with its own vocabulary (every
              60th frame of the sweep, trained on the card's FrameBuilder)
              and loop closing on: lost frames no more than the JAX CPU
              run's at the same frames, live and allocated keyframes within
              20%, kf ATE within 1 cm, one pose-LM launch per pose
              optimization, every essential graph on CG and every global-BA
              job on pcg_dual; loops, escalations and dropped lanes printed
              beside JAX's; ms per mapping step beside phase 5's.
    parallel — the JAX package's parallel/ on torch.distributed (after
              `scale`), its ranks started as `python3 chip_smoke.py
              --parallel-rank ...` (never through main()), each killed past
              PARALLEL_TIMEOUT_S: (a) one NCCL rank on cuda:0 runs the
              distributed GBA (parallel/dist_gba.distributed_full_ba, 10 LM
              iterations) on phase 7's saved map (K_cap 64 / P_cap 32,768)
              and on the scale phase's final map (K_cap 1,536 / P_cap
              262,144), on the loop map with its slots interleaved across
              both halves of each capacity (`relaid_map`, PARALLEL_RELAID:
              at world 2 every rank's keyframe and point blocks hold live
              rows, printed per rank and required) and the one-process
              solve of each (global_ba's "pcg" route, the same PCG; its
              one-hot takes 26 GB at the scale caps; the re-laid map's
              solve, its slots mapped back, within the bounds of the loop
              map's); (b) PARALLEL_WORLD gloo ranks,
              all on cuda:0 (NCCL takes one rank per card), run the same
              solves and dist_ba (20 LM iterations) on phase 5's captured
              local-BA window: replicated results bit-equal across ranks,
              the loop map bit-equal to one rank's, and every solve within
              PAR_POSE_TOL (poses), PAR_PX_TOL (each live observation's
              predicted pixel) and PAR_COST_RTOL (cost) of one rank's and of
              the one-process solve, 3D point differences printed; controls
              under the same measures, each of which must fail a bound: the
              input with no solve, and the world-2 solves over a mesh that
              zeroes rank 0's psum terms or its all-gather blocks, and on
              the re-laid map rank 1's psum terms; ms per LM
              iteration; (c) the same ranks each run the
              live system through the loop slice (one pass from a fresh
              system) and the kidnap run with phase 7's vocabulary, handed
              over as a file: GBAJob's multi-rank branch (counted) at the
              loop, the relocalizer's sharded query (counted) while lost,
              pose-LM launches on every rank; the ranks agree on every
              decision and on kf ATE, and match the JAX run on as many
              virtual devices (JAX_CPU_MULTI): the loop at its frames, the
              kidnap run relocalized on its frame, kidnap loops at least
              its, keyframes within 20%, kf ATE within 1 cm; frames/s per
              rank (two ranks share the card and the host). With 2 or 4
              cards visible, (b)-(c) run once more over NCCL, one card per
              rank (not run on one card).
11. profile — a torch.profiler trace of 10 pose-LM calls shows 10 device
              kernels, all pose_lm_kernel; then one mapping step from the
              phase-6 state, the loop stages of the phase-8 correction
              (Sim3 chain, correction, essential graph with the solver's
              early exit and with its full loop, one GBA iteration)
              and one relocalization attempt of phase 10: device kernels,
              host reads (stream syncs) and top device operations (last: a
              profile slows later launches).

The last lines are the loop, mono, stereo, endurance and scale
summaries, every phase's essential graphs as [route, LM iterations] (1:
the solver's early exit fired), the parallel summary,
a JSON record of the kernels
(`launches` from the loop slice, `launches_by_path` each slice's,
`launches_batched` the B > 1 launches of the kidnap, reuse, endurance and
scale runs), the
card's `nvidia-smi` name/power line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# JAX package, CPU, same sequence and configuration, no vocabulary, measured
# once by tools/jax_cpu_bench_reference.py (see PERF.md): 240 frames, none
# lost. Tracking only (enable_mapping=False):
JAX_CPU_KEYFRAMES = 23
JAX_CPU_KF_ATE_M = 0.023118204057347373
# with local mapping (the default; bench.py with BENCH_NO_LOOP=1), 0 BA
# lanes dropped:
JAX_CPU_MAPPING_KEYFRAMES = 23
JAX_CPU_MAPPING_KF_ATE_M = 0.04588471254948784
# bench.py's headline configuration (a vocabulary trained from the
# sequence, loop closing on), with the tracker's outcomes read every frame
# as the port reads them (`--loop`, fetch_every = 1): 0 lost, 1 loop (query
# keyframe at frame 217, match at frame 37, 962 Sim3 inliers), 26,168
# points. At the JAX default cadence (16 frames) the same loop closes with
# 961 inliers, 23 keyframes, kf ATE 0.008217 m.
JAX_CPU_LOOP_N_WORDS = 9640
JAX_CPU_LOOP_KEYFRAMES = 23
JAX_CPU_LOOP_KF_ATE_M = 0.008675051457092587
JAX_CPU_LOOP_EVENTS = [(217, 37)]  # (query, match) keyframes' frame ids
# the kidnap sequence (`--kidnap`, outcomes read every frame): 22
# keyframes, 27,091 points, kf ATE 0.023986 m, no loop; frames 150-218
# tracked as lost: relocalized on frame 153 (the first resumed frame) and on
# every frame after it up to 218, where the JAX tracker's reference keyframe,
# left stale by a relocalization, is seen again (ROADMAP queue 3)
JAX_CPU_KIDNAP_KEYFRAMES = 22
JAX_CPU_KIDNAP_KF_ATE_M = 0.023985717061088794
JAX_CPU_KIDNAP_RELOC_FRAME = 153
JAX_CPU_KIDNAP_LOOPS = 0
# map reuse (`--reuse`): the headline run's map (23 keyframes, 26,168
# points, 4,227,757 bytes) reloaded; relocalized on frame 0, 72 frames
# localized (1-72), lost from frame 73 on (the same stale reference
# keyframe), ATE of the localized frames 0.023735 m
JAX_CPU_REUSE_FIRST_RELOC = 0
JAX_CPU_REUSE_LOCALIZED = 72
JAX_CPU_REUSE_ATE_M = 0.023734994481243745
# tools/bench_mono.py's workload (`--mono`): the same 240 frames, the u8
# image alone, SLAMSystem(cfg, MONOCULAR) with max_keyframes=96, bench.py's
# vocabulary and loop closing on (Sim3 with a free scale), one pass from a
# fresh system, outcomes read every frame: bootstrapped on frame 2 (frames 0
# and 1 lost), 46 keyframes, 21,336 points, Sim3-aligned kf ATE 0.002926 m,
# 1 loop (query frame 158, match frame 3, 397 inliers), its global-BA job
# applied, none aborted, 0 BA lanes dropped
JAX_CPU_MONO_BOOTSTRAP_FRAME = 2
JAX_CPU_MONO_LOST_FRAMES = [0, 1]
JAX_CPU_MONO_KEYFRAMES = 46
JAX_CPU_MONO_KF_ATE_SIM3_M = 0.0029256094468043227
JAX_CPU_MONO_EVENTS = [(158, 3)]  # (query, match) keyframes' frame ids
MONO_MAX_KEYFRAMES = 96  # tools/bench_mono.py: mono culls harder
# the stereo workload (`--stereo --default-caps`): the u8 images of the
# sequence as left images, right images rendered from each pose moved
# STEREO_BASELINE along the camera x axis (bf = 520 x 0.08 = 41.6, the bench
# camera's), SLAMSystem(cfg, STEREO) at SystemConfig's default capacities
# (512 keyframes, 65,536 points, 2,048 keypoints), bench.py's vocabulary and
# loop closing on, one pass from a fresh system: no frame lost, 26
# keyframes, 24,886 points, kf ATE 0.036113 m, 1 loop (query frame 217,
# match frame 35, 1,176 inliers) whose essential graph ran the CG solver and
# whose global-BA job ran pcg_dual and was applied, none aborted, 0 BA
# lanes dropped
STEREO_BASELINE = 0.08
JAX_CPU_STEREO_LOST_FRAMES: list = []
JAX_CPU_STEREO_KEYFRAMES = 26
JAX_CPU_STEREO_KF_ATE_M = 0.0361134798947246
JAX_CPU_STEREO_EVENTS = [(217, 35)]  # (query, match) keyframes' frame ids
STEREO_CAPS = (512, 65536, 2048)  # SystemConfig's defaults: keyframes, points, keypoints
# tools/endurance.py's workload on the JAX package, CPU, one pass from a
# fresh system, outcomes read every frame
# (`tools/jax_cpu_bench_reference.py --endurance`): 1,200 frames, none lost,
# 42 keyframes (42 slots allocated), 38,583 points, kf ATE 0.008057 m (per
# 1,000 frames 0.007888, 0.005589), 2 loops (frames 506 / 40, 1,589
# inliers; 843 / 397, 1,267), both global-BA jobs applied (dense), 3 point
# compactions and no keyframe compaction (the keyframe allocator peaks at 42
# of 256 slots), 2 BA escalations, 0 lanes dropped; the vocabulary 9,640
# words
JAX_CPU_ENDURANCE = dict(
    lost_frames=[], keyframes_live=42, kf_alloc_watermark=42, kf_ate_m=0.008057152337335442,
    loops=2, events=[(506, 40), (843, 397)], gba_applied=2, gba_aborted=0,
    point_compactions=3, keyframe_compactions=0, ba_escalations=2, ba_lanes_dropped=0)
# the first SCALE_FRAMES frames of tools/scale_endurance.py's 8,000-frame
# sweep on the JAX package, CPU, outcomes read every frame
# (`tools/jax_cpu_bench_reference.py --scale --frames 1700`): lost on frames
# 183-1,172 (the camera turns to walls past ThDepth's 2.4 m and the 8
# keyframes stop gaining points; relocalized on frame 1,173) and 1,445-1,494,
# 86 keyframe slots allocated, 40 keyframes live, 15,346 points, kf ATE
# 0.053994 m (frames 0-999: 0.035428, 1,000-1,699: 0.051074), no loop, no
# compaction, 61 BA escalations, 0 lanes dropped; the vocabulary 9,991
# words. The first 600 frames alone (`--frames 600`): lost from 183 on, 8
# keyframes, kf ATE 0.035765 m.
SCALE_FRAMES = 1700
JAX_CPU_SCALE = dict(
    lost_frames=list(range(183, 1173)) + list(range(1445, 1495)), keyframes_live=40,
    kf_alloc_watermark=86, kf_ate_m=0.05399423403513277, loops=0, ba_escalations=61,
    ba_lanes_dropped=0, gba_solvers=[], essential_solvers=[], n_words=9991)
# the loop slice and the kidnap run on the JAX package with N virtual CPU
# devices, so that its GBAJob runs parallel/dist_gba.distributed_full_ba and
# its relocalizer the sharded query of parallel/dist_reloc; the parallel
# phase's ranks are held to the run of their world size. N = 2:
# `JAX_PLATFORMS=cpu python tools/jax_cpu_bench_reference.py --loop
# --devices 2`: gba_solvers ["multi-device"], 1 loop (frames 217 / 37, 962
# inliers), its job applied, 23 keyframes, 26,168 points, 0 lost, kf ATE
# 0.009237 m (one device: 0.008675 m); `... --kidnap --devices 2`:
# relocalized on frame 153, lost on frames 150-219 (one device: 150-218:
# the sharded query's candidates are not the single-device detector's), 22
# keyframes, 25,053 points, no loop, kf ATE 0.023583 m. N = 4 (`--loop
# --devices 4`, `--kidnap --devices 4`): every number as at N = 2
_JAX_CPU_2_4 = dict(loop_events=[(217, 37)], loop_keyframes=23,
                    loop_kf_ate_m=0.009236682218804098, kidnap_reloc_frame=153,
                    kidnap_keyframes=22, kidnap_kf_ate_m=0.02358268285668361, kidnap_loops=0)
JAX_CPU_MULTI = {2: _JAX_CPU_2_4, 4: _JAX_CPU_2_4}
PARALLEL_WORLD = 2  # ranks of the parallel phase's gloo launch, sharing the card
PARALLEL_TIMEOUT_S = 600  # a launch of ranks is killed past this
PARALLEL_GBA_ITERS = 10  # GBAJob's LM iterations
PARALLEL_BA_ITERS = 20  # dist_ba on the local-BA window: converged iterates
PARALLEL_RELAID = "loop_relaid"  # the loop map, slots interleaved (`relaid_map`)
# the distributed GBA / BA at n ranks against 1 rank, and against the
# one-process solve of the same map by global_ba's "pcg" route (the same
# Schur-diagonal PCG, its camera sums over the point-major lanes where the
# distributed one sums over the camera-major ones, as JAX's does): the
# poses, each live observation's predicted pixel and the cost. 3D points
# are printed, not held: a point seen from two nearby keyframes slides
# along its ray at no cost, and on the scale map (lost stretches, weakly
# joined segments) a segment's cameras and points move together. Each
# bound lies between the sound solves' largest gap and the smallest gap of
# a broken solve that only that measure catches (H100, PERF.md section 6):
# sound at most 4.08e-3 in pose (scale map), 0.0368 px, 3.8e-5 in cost;
# the input with no solve 6.0e-3 in pose (the window), 0.233 px and
# 6.2e-4 in cost (the scale map); rank 0's psum terms zeroed leaves the
# loop map's steps as they were, 0.77 off in cost
PAR_POSE_TOL, PAR_PX_TOL, PAR_COST_RTOL = 5e-3, 0.1, 1.5e-4
RENDER_WORKERS = 8  # processes that render the long runs' frames
KIDNAP_AT, KIDNAP_BLANKS, KIDNAP_RESUME = 150, 3, 100
MAP_STEP_CAPTURE = 10  # the mapping step whose input phase 6 replays
N_FRAMES = 240
WARMUP_FRAMES = 24  # untimed frames before each slice; reach a third keyframe
W, H = 640, 480
POSE_TOL = 1e-4  # kernel vs plain: f32 sums in another order
GATE_REL = 1e-4  # an inlier may flip only this close (relative) to its gate
ESSENTIAL_TOL = 1e-4  # essential-graph Sim3 poses, card vs CPU
ESSENTIAL_SEED = 5  # the start poses of the essential-graph check
PERM_ORDERS = 12  # shuffled edge orders of the plain f32 version per batched problem

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
N_SM = 132
# FLOP per edge of csrc/pose_lm.cu, (mono, stereo), counted from its source
# without the products of the Jacobians' zero entries (Ju[1], Jv[0], Jur[1],
# and all of Jur on a mono edge); a division or square root counts one. The
# residual (camera point 18, 1/z 1, projection 6 + uR 2, errors 2 + 1, chi2
# 4 / 6) is what a pass needs of an edge it reads; an inlier's system terms
# add the Jacobians (17 / 22), 21 H entries (80 / 110) and 6 g entries
# (26 / 36), and its cost one add. Left out, so the count stays a lower
# bound: the Huber weight (<= 4 per edge over its gate, rounds 0-1) and the
# 6x6 solve (~600 per iteration, < 1%).
FLOP_RESIDUAL = (31, 36)
FLOP_SYSTEM = (123, 168)
FLOP_COST = 1
BYTES_PER_EDGE = 12 + 8 + 4 + 4 + 1 + 1  # pt_w uv ur inv_sigma2 valid in, inlier out
BYTES_PER_PROBLEM = 64 + 64 + 4  # pose in, pose and count out


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {smi}")
    return smi


def _ptxas_report(lib: Path) -> str:
    text = lib.with_suffix(".ptxas.txt").read_text()
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
    if not spills or any(spills):
        raise AssertionError(f"ptxas reports spills (or no report):\n{text}")
    return text


def phase_build():
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

    t0 = time.perf_counter()
    path = pose_opt_cuda.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    log("[build] ptxas: " + _ptxas_report(path).strip().replace("\n", "\n[build] ptxas: "))


def _time_ms(fn, n=50) -> float:
    """Median of n synchronous calls, each between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _time_kernel_ms(fn, n=50, per=5) -> float:
    """Device time of one launch: median over n replays of a CUDA graph
    that holds `per` calls, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per):
            fn()
    times = []
    for _ in range(n + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times[3:])


def _per_iter_us(kern) -> float:
    """Microseconds per LM iteration: (t(n_iters=10) - t(n_iters=5)) / 20,
    20 being the 4 rounds x 5 iterations between the two."""
    return 1e3 * (_time_kernel_ms(lambda: kern(10)) - _time_kernel_ms(lambda: kern(5))) / 20


def _check_inliers(cam, pose_k, inl_k, n_k, pose_r, inl_r, obs1) -> int:
    """Inlier sets must be equal, except an edge whose raw chi2 lies within
    GATE_REL (relative) of its gate at either pose; returns the flips."""
    from orbslam_mapsave_tpu_torch.optim import lm, pose_opt

    if int(n_k) != int(inl_k.sum()):
        raise AssertionError(f"kernel count {int(n_k)} != mask sum {int(inl_k.sum())}")
    flips = torch.nonzero(inl_k != inl_r).flatten()
    for e in flips.tolist():
        gate = lm.CHI2_STEREO if float(obs1.ur[e]) >= 0 else lm.CHI2_MONO
        margins = [float(pose_opt._residuals(cam, p, obs1)[3][e]) / gate - 1.0
                   for p in (pose_k, pose_r)]
        log(f"[kernel] inlier flip at edge {e}: chi2/gate - 1 = {margins[0]:.3g} "
            f"(kernel pose), {margins[1]:.3g} (plain pose)")
        if min(abs(m) for m in margins) > GATE_REL:
            raise AssertionError(f"inlier flip at edge {e} is not at its gate")
    return len(flips)


def _round_inliers(pose0, obs1, cam=None) -> list[torch.Tensor]:
    """Each round's inlier set in a run of the plain version on one
    problem, which the kernel matches: the valid edges in round 0, then the
    reclassification that opens each later round."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt
    from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM

    cam = cam or CAM
    sets = [obs1.valid]
    reclassify = pose_opt._reclassify

    def recorded(*args):
        sets.append(reclassify(*args))
        return sets[-1]

    pose_opt._reclassify = recorded
    try:
        pose_opt.pose_optimization_ref(cam, pose0, obs1)
    finally:
        pose_opt._reclassify = reclassify
    return sets[:-1]  # the last reclassification is the output pass


def _flops(pose0, obs1, n_iters=10, cam=None) -> int:
    """The FLOPs one problem's call needs on its data: every pass reads the
    residual of the edges it needs (all valid edges when it reclassifies,
    else the round's inliers) and adds the inliers' system terms."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt
    from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM

    cam = cam or CAM
    stereo = obs1.ur >= 0

    def count(mask, per):
        return per[0] * int((mask & ~stereo).sum()) + per[1] * int((mask & stereo).sum())

    behind = pose_opt._residuals(cam, pose0, obs1)[5]  # round 0 takes them as inliers
    flops = count(obs1.valid, FLOP_RESIDUAL)  # the output pass
    for inl in _round_inliers(pose0, obs1, cam):
        system = count(inl & ~behind, FLOP_SYSTEM) + FLOP_COST * int(inl.sum())
        flops += count(obs1.valid, FLOP_RESIDUAL) + system  # the round's first pass
        flops += n_iters * (count(inl, FLOP_RESIDUAL) + system)
    return flops


def _bound_ms(pose0, obs, cam=None) -> tuple[float, str, float, int]:
    """(least time on the whole card, what bounds it, least time on one SM,
    FLOPs) for one call on these inputs; a problem runs on one SM, so the
    one-SM time is the largest problem's."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt

    B, M = obs.valid.shape
    flops = [_flops(pose0[b], pose_opt.PoseObs(*[x[b] for x in obs]), cam=cam)
             for b in range(B)]
    t_ops = sum(flops) / PEAK_F32
    t_bytes = (B * M * BYTES_PER_EDGE + B * BYTES_PER_PROBLEM) / PEAK_BYTES
    sm_ms = 1e3 * max(flops) / (PEAK_F32 / N_SM)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            sm_ms, sum(flops))


def _cuda_kernels_per_call(fn, calls=10) -> list[str]:
    """Names of the device kernels a profile records while fn runs `calls`
    times. The calls sit between two marker kernels (fills), after warm-up
    calls inside the same profile: the first launches after the profiler
    starts can go unrecorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.ones(1, device="cuda")
        for _ in range(calls):
            fn()
        torch.ones(1, device="cuda")
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    marks = [i for i, n in enumerate(names) if "pose_lm_kernel" not in n]
    if len(marks) < 2:
        raise AssertionError(f"profile lost its marker kernels: {names}")
    return names[marks[-2] + 1:marks[-1]]


def phase_kernel(dev) -> dict:
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    worst, flips = 0.0, 0
    for M in (2048, 900, 1024):
        for B in (1, 4):
            probs = [make_problem(M, seed=7 + b) for b in range(B)]
            obs = batch_obs(probs, dev)
            pose0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
            p1, i1, n1 = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            p2, i2, n2 = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            torch.cuda.synchronize()
            if not (torch.equal(p1, p2) and torch.equal(i1, i2) and torch.equal(n1, n2)):
                raise AssertionError(f"kernel not bit-repeatable at M={M} B={B}")
            for b in range(B):
                obs1 = pose_opt.PoseObs(*[x[b] for x in obs])
                pr, ir, nr = pose_opt.pose_optimization_ref(CAM, pose0[b], obs1)
                err = (p1[b] - pr).abs().max().item()
                worst = max(worst, err)
                if not err <= POSE_TOL:
                    raise AssertionError(f"kernel != plain at M={M} B={B} b={b}: "
                                         f"pose err {err:.3g}")
                flips += _check_inliers(CAM, p1[b], i1[b], n1[b], pr, ir, obs1)
            log(f"[kernel] M={M} B={B}: ok (inliers {n1.tolist()})")
    for case in ("all_invalid", "all_behind"):
        p = make_problem(1024, seed=3)
        if case == "all_invalid":
            p["valid"][:] = False
        else:
            p["pt_w"][:, 2] *= -1.0
        pose0 = torch.eye(4, device=dev)[None].contiguous()
        pose, inl, n = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, batch_obs([p], dev))
        if not (torch.equal(pose, pose0) and int(n[0]) == 0 and not bool(inl.any())):
            raise AssertionError(f"{case}: the input pose must come back unchanged")
        log(f"[kernel] {case}: input pose returned, 0 inliers")

    # the main path's shape: one problem of M = max_keypoints; B = 4 as
    # relocalization would batch candidates
    eye = torch.eye(4, device=dev)
    res = {}
    for B in (1, 4):
        obs = batch_obs([make_problem(2048, seed=7 + b) for b in range(B)], dev)
        pose0 = eye.expand(B, 4, 4).contiguous()

        def kern(n_iters=10, o=obs):
            return pose_opt_cuda.pose_optimization_cuda(CAM, pose0, o, n_iters=n_iters)

        # ms: one synchronous call between two events (host and launch
        # inside, as PR 1's `ms`); graph_ms: device time of one launch
        r = dict(ms=_time_ms(kern), graph_ms=_time_kernel_ms(kern))
        for M in (2048, 128):
            o = pose_opt.PoseObs(*[x[:, :M].contiguous() for x in obs])
            r[f"per_iter_us_M{M}"] = _per_iter_us(lambda n, o=o: kern(n, o))
        r["edge_pass_share"] = 1.0 - r["per_iter_us_M128"] / r["per_iter_us_M2048"]
        r["bound_ms"], r["bound_by"], r["sm_bound_ms"], r["flops"] = _bound_ms(pose0, obs)
        if B == 1:
            obs1 = pose_opt.PoseObs(*[x[0] for x in obs])
            r["plain_ms"] = _time_ms(lambda: pose_opt.pose_optimization_ref(CAM, eye, obs1))
        res[B] = r
        log(f"[timing] M=2048 B={B} (CUDA events, median of 50): " + json.dumps(r))
    # the monocular path's problem (every edge mono, ur = -1) and the
    # stereo path's (every edge given its right-image u), M = 2048
    for name, share in (("mono", 0.0), ("stereo", 1.0)):
        res[name] = _single_problem(dev, name, share)
        worst = max(worst, res[name]["max_abs_err"])
    log(f"[kernel] max |pose err| {worst:.3g}, inlier flips at the gate: {flips}")
    return dict(max_abs_err=worst, flips=flips, timing=res)


def _single_problem(dev, name: str, stereo: float) -> dict:
    """One M = 2048 problem whose edges are stereo with share `stereo`:
    the kernel against the plain version (pose within POSE_TOL, no inlier
    flip), one synchronous call, the kernel alone, the plain version and
    the bound from the FLOPs this problem needs."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    eye = torch.eye(4, device=dev)
    obs = batch_obs([make_problem(2048, seed=7, stereo=stereo)], dev)
    pose0 = eye[None].contiguous()
    obs1 = pose_opt.PoseObs(*[x[0] for x in obs])

    def kern():
        return pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)

    pk, ik, nk = kern()
    pr, ir, _ = pose_opt.pose_optimization_ref(CAM, eye, obs1)
    err = (pk[0] - pr).abs().max().item()
    flips = _check_inliers(CAM, pk[0], ik[0], nk[0], pr, ir, obs1)
    if not err <= POSE_TOL or flips:
        raise AssertionError(f"all-{name} problem: kernel != plain, pose err {err:.3g}, "
                             f"{flips} inlier flips")
    r = dict(max_abs_err=err, flips=flips, inliers=int(nk[0]),
             stereo_edges=int((obs1.ur >= 0).sum()), ms=_time_ms(kern),
             graph_ms=_time_kernel_ms(kern),
             plain_ms=_time_ms(lambda: pose_opt.pose_optimization_ref(CAM, eye, obs1)))
    r["bound_ms"], r["bound_by"], r["sm_bound_ms"], r["flops"] = _bound_ms(pose0, obs)
    log(f"[timing] M=2048 B=1, every edge {name} (CUDA events, median of 50): "
        + json.dumps(r))
    return r


def phase_profile(dev):
    """One device kernel per call, and no other, in a torch.profiler trace.
    Runs last: after a profile, every launch of the process costs the host
    more (the profiler's CUPTI hooks stay), which would skew the timings."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    for B in (1, 4):
        obs = batch_obs([make_problem(2048, seed=7 + b) for b in range(B)], dev)
        pose0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
        names = _cuda_kernels_per_call(
            lambda: pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs))
        if len(names) != 10:
            raise AssertionError(f"10 calls ran {len(names)} device kernels "
                                 f"{sorted(set(names))}, not 10 x pose_lm_kernel")
        log(f"[profile] B={B}: 10 calls ran 10 device kernels, all pose_lm_kernel")


def bench_sequence():
    """The benchmark sequence (bench.py): ground-truth Twc poses and
    (u8 image, f16 depth) frames."""
    lr = _long_runs()
    t0 = time.perf_counter()
    poses = lr.bench_poses()
    # the endurance workload's camera, image size and room are the bench's
    frames = lr.render(lr.ENDURANCE, poses, RENDER_WORKERS)
    log(f"[slice] rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s "
        f"({RENDER_WORKERS} processes)")
    return poses, frames


def _bench_system(dev, enable_mapping: bool, vocabulary=None, reuse_map_path=None,
                  mono: bool = False, stereo: bool = False):
    """bench.py's camera and ORB settings; RGB-D at bench.py's capacities,
    monocular with MONO_MAX_KEYFRAMES, stereo at SystemConfig's default
    capacities."""
    from orbslam_mapsave_tpu_torch import config as cfg_mod
    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod

    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
    if not stereo:
        cfg.max_keypoints = 2048
        cfg.max_keyframes = MONO_MAX_KEYFRAMES if mono else 64
        cfg.max_points = 32768
    sensor = (system_mod.Sensor.MONOCULAR if mono else
              system_mod.Sensor.STEREO if stereo else system_mod.Sensor.RGBD)
    return system_mod.SLAMSystem(cfg, sensor, vocabulary=vocabulary,
                                 enable_mapping=enable_mapping, device=dev,
                                 reuse_map_path=reuse_map_path)


def _run_slice(slam, seq, name: str, on_start=None, warmup: int = WARMUP_FRAMES) -> dict:
    """Warm up over `warmup` frames, flush, reset, then drive the whole
    sequence through the system with the pose-LM launch counter zeroed (and
    on_start called) just before; one device sync per frame, and the
    pending loop-closing work flushed at the end (inside the wall time, as
    bench.py). Returns the run's numbers."""
    from orbslam_mapsave_tpu_torch.io import trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda

    poses, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    # warm-up, then the measured run. WARMUP_FRAMES reach the third keyframe,
    # so with mapping the warm-up runs one local BA: the cuBLAS/cuSOLVER
    # handles, the first 384x384 Cholesky and the allocator's first blocks
    # for the BA tables all fall outside the timed run
    for i in range(warmup):
        slam.track_rgbd(*frames[i], stamps[i])
    slam.flush_gba()
    warmup_keyframes = slam.n_keyframes
    slam.reset()
    torch.cuda.synchronize()

    # count the pose optimizations the tracker asks for, beside the launches
    calls = 0
    dispatch = pose_opt.pose_optimization

    def counted(*args):
        nonlocal calls
        calls += 1
        return dispatch(*args)

    pose_opt.pose_optimization = counted
    if on_start is not None:
        on_start()
    pose_opt_cuda.reset_launches()
    frame_ms = np.empty(N_FRAMES)
    try:
        t_start = time.perf_counter()
        for i in range(N_FRAMES):
            t1 = time.perf_counter()
            pose = slam.track_rgbd(*frames[i], stamps[i])
            torch.cuda.synchronize()
            frame_ms[i] = 1e3 * (time.perf_counter() - t1)
            if pose.shape != (4, 4) or not np.isfinite(pose).all():
                raise AssertionError(f"frame {i}: bad pose {pose}")
        slam.flush_gba()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    finally:
        pose_opt.pose_optimization = dispatch
    launches = pose_opt_cuda.launches

    traj = slam.tracker.trajectory
    lost = [i for i, (_, _, l) in enumerate(traj) if l]
    ts, est = slam.keyframe_trajectory()
    kf_ate = traj_io.ate_rmse(stamps, poses, ts, np.linalg.inv(est))
    tracked = N_FRAMES - 1 - len(lost)  # frame 0 initializes the map
    res = dict(frames=N_FRAMES, fps=N_FRAMES / wall,
               p50_ms=float(np.percentile(frame_ms, 50)),
               p99_ms=float(np.percentile(frame_ms, 99)), max_ms=float(frame_ms.max()),
               keyframes=slam.n_keyframes, points=slam.n_points, kf_ate_m=kf_ate,
               lost=len(lost), pose_optimizations=calls, launches=launches,
               ba_lanes_dropped=slam.tracker.ba_lanes_dropped,
               ba_escalations=slam.tracker.ba_escalations,
               warmup_keyframes=warmup_keyframes)
    log(f"[{name}] " + json.dumps(res))
    if lost:
        raise AssertionError(f"frames lost: {lost}")
    if launches != calls or calls < 2 * tracked:
        raise AssertionError(f"{launches} pose-LM launches for {calls} pose "
                             f"optimizations in {tracked} tracked frames")
    return res


def _check_quality(res: dict, keyframes: int, kf_ate: float):
    if abs(res["keyframes"] - keyframes) > 0.2 * keyframes:
        raise AssertionError(f"{res['keyframes']} keyframes vs JAX CPU {keyframes}")
    if not res["kf_ate_m"] <= kf_ate + 0.01:
        raise AssertionError(f"kf ATE {res['kf_ate_m']:.4f} m vs JAX CPU {kf_ate:.4f} m")


def phase_slice(dev, seq) -> dict:
    res = _run_slice(_bench_system(dev, enable_mapping=False), seq, "slice")
    _check_quality(res, JAX_CPU_KEYFRAMES, JAX_CPU_KF_ATE_M)
    return res


def phase_mapping(dev, seq) -> tuple[dict, object, tuple]:
    """The mapping slice; also times every mapping step (synced before and
    after) and keeps the input of the MAP_STEP_CAPTURE-th for phase 6."""
    slam = _bench_system(dev, enable_mapping=True)
    mapper = slam.mapper
    step = mapper._map_step
    times, captured = [], []

    def timed(state, kf_slot, recent_start, abort):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, kf_slot, recent_start, abort)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if len(times) == MAP_STEP_CAPTURE:
            captured.append((type(state)(*[x.clone() for x in state]), kf_slot,
                             recent_start, abort))
        return out

    mapper._map_step = timed
    try:
        res = _run_slice(slam, seq, "mapping", on_start=times.clear)
    finally:
        del mapper._map_step
    res.update(map_steps=len(times), map_step_p50_ms=float(np.percentile(times, 50)),
               map_step_p99_ms=float(np.percentile(times, 99)),
               map_step_ms_total=float(np.sum(times)))
    _check_quality(res, JAX_CPU_MAPPING_KEYFRAMES, JAX_CPU_MAPPING_KF_ATE_M)
    if res["warmup_keyframes"] < 3:  # else the first BA's cold start is timed
        raise AssertionError(f"the warm-up made {res['warmup_keyframes']} keyframes, "
                             "so it ran no local BA")
    if res["ba_lanes_dropped"] != 0:
        raise AssertionError(f"BA dropped {res['ba_lanes_dropped']} observation lanes")
    if not captured:
        raise AssertionError(f"only {len(times)} mapping steps ran")
    log("[mapping] " + json.dumps({k: res[k] for k in (
        "map_steps", "map_step_p50_ms", "map_step_p99_ms", "map_step_ms_total")}))
    return res, mapper, captured[0]


@contextlib.contextmanager
def _patched(patches: list):
    """Set each (object, attribute, value) of `patches` for the duration of
    the block; a method patched on an instance is dropped afterwards, any
    other attribute restored."""
    saved = [(obj, name, getattr(obj, name), name in vars(obj)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value, own in saved:
            if own:  # a module's, class's or namespace's attribute
                setattr(obj, name, value)
            else:  # a method: drop the instance attribute that shadows it
                delattr(obj, name)


def _synced(fn, label: str, into: list):
    """fn with a device sync before and after, appending (label, host-clock
    ms) to `into` at each call."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        into.append((label, 1e3 * (time.perf_counter() - t0)))
        return out

    return run


def _kept(fn, into: list):
    """fn(state, *args), keeping its first call's arguments in `into` (the
    map cloned)."""
    def run(state, *a):
        if not into:
            into.append((type(state)(*[x.clone() for x in state]), *a))
        return fn(state, *a)

    return run


ESSENTIAL_SOLVES: dict = {}  # phase: [[route, LM iterations], ...] of each essential graph


def _current_phase() -> str:
    """The innermost `phase_*` (or `_rank_*`) function on the stack."""
    f = sys._getframe()
    while f is not None:
        name = f.f_code.co_name
        if name.startswith(("phase_", "_rank_")):
            return name.removeprefix("phase_").lstrip("_")
        f = f.f_back
    return "other"


def _record_essential_solves() -> None:
    """Wrap pose_graph.optimize_pose_graph for the rest of the process: the
    route and the LM iterations of every solve go into ESSENTIAL_SOLVES
    under the phase that ran it (1 iteration: the solver's early exit
    fired; 20: it did not). A phase's own wrappers wrap this one."""
    from orbslam_mapsave_tpu_torch.optim import pose_graph

    solve = pose_graph.optimize_pose_graph

    def recorded(prob, *a, **k):
        pose_graph.reset_iterations()
        out = solve(prob, *a, **k)
        ESSENTIAL_SOLVES.setdefault(_current_phase(), []).append(
            [k.get("solver", "dense"), pose_graph.iterations])
        return out

    pose_graph.optimize_pose_graph = recorded


def _essential_exit_vs_full(lc, state, kf: int, mkf: int, label: str) -> dict:
    """`LoopCloser._essential` on a corrected map twice: as it runs (the
    pose-graph solver's early exit) and with the solver's full loop
    (`pose_graph._optimize_pose_graph_full`) in its place. Every map field
    must be bit-equal and the full loop must run 20 LM iterations. Each run
    is synced and host-timed, its route and LM iterations recorded."""
    from orbslam_mapsave_tpu_torch.optim import pose_graph

    res, outs = {}, []
    for name, solve in (("exit", pose_graph.optimize_pose_graph),
                        ("full_loop", pose_graph._optimize_pose_graph_full)):
        seen = []

        def recorded(prob, *a, solve=solve, seen=seen, **k):
            pose_graph.reset_iterations()
            out = solve(prob, *a, **k)
            seen.append((k.get("solver", "dense"), pose_graph.iterations))
            return out

        with _patched([(pose_graph, "optimize_pose_graph", recorded)]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(lc._essential(state, kf, mkf))
            torch.cuda.synchronize()
        res[name] = dict(ms=1e3 * (time.perf_counter() - t0), route=seen[0][0],
                         iterations=seen[0][1])
    res["fields_differing"] = [k for k, a, b in zip(outs[0]._fields, *outs)
                               if not torch.equal(a, b)]
    log(f"[{label}] essential graph, early exit vs full loop (synced): " + json.dumps(res))
    if res["fields_differing"]:
        raise AssertionError(f"[{label}] the early exit's map differs from the full loop's "
                             f"in {res['fields_differing']}")
    if res["full_loop"]["iterations"] != 20:
        raise AssertionError(f"[{label}] the full loop ran {res['full_loop']['iterations']} "
                             "LM iterations")
    return res


def _map_step_stages(mapper, captured) -> dict:
    """Host-clock ms of each stage of one replayed mapping step (a device
    sync before and after each), and the LM iterations its BA ran."""
    from orbslam_mapsave_tpu_torch.pipeline import local_mapping as lm
    from orbslam_mapsave_tpu_torch.utils import metrics

    timed: list = []
    targets = [(lm, "recent_point_culling", "recent culling"),
               (mapper.tri, "batched", "triangulation"),
               (mapper.tri, "finalize_idx", "new-point descriptors + normals"),
               (lm, "fuse_into_keyframe", "fuse neighbours -> keyframe"),
               (mapper, "_reverse_fuse", "fuse keyframe -> 3 neighbours"),
               (lm.ms, "update_connections", "covisibility updates"),
               (mapper, "_ba", "local BA"),
               (lm, "keyframe_culling", "keyframe culling")]
    patches = [(obj, name, _synced(getattr(obj, name), label, timed))
               for obj, name, label in targets]
    metrics.reset()
    metrics.enable()  # one `mapping.ba_graph_replays` count per LM iteration
    try:
        with _patched(patches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mapper._map_step(*captured)
            torch.cuda.synchronize()
            total = 1e3 * (time.perf_counter() - t0)
    finally:
        metrics.disable()
    iters = metrics.summary()["counters"].get("mapping.ba_graph_replays", 0)
    metrics.reset()
    ms_: dict = {}
    for label, t in timed:
        ms_[label] = ms_.get(label, 0.0) + t
    ms_["rest"] = total - sum(ms_.values())
    return dict(total_ms=total, stages_ms=ms_, lm_iterations=iters)


def phase_map_step(mapper, captured) -> dict:
    """Replay one captured mapping step twice on the card (bit-identical)
    and once on the CPU (poses, points within 1e-3; same kf_valid; live
    points within 0.5%)."""
    state, kf_slot, recent_start, abort = captured
    outs = [mapper._map_step(state, kf_slot, recent_start, abort) for _ in range(2)]
    torch.cuda.synchronize()
    (a, da, ea), (b, db, eb) = outs
    same = [k for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    if same or (da, ea) != (db, eb):
        raise AssertionError(f"map step not bit-repeatable on the card: {same}")
    cpu_state = type(state)(*[x.cpu() for x in state])
    t0 = time.perf_counter()
    c, dc, ec = mapper._map_step(cpu_state, kf_slot, recent_start, abort)
    cpu_s = time.perf_counter() - t0
    a = type(a)(*[x.cpu() for x in a])
    both = a.pt_valid & c.pt_valid
    diff = dict(
        kf_slot=kf_slot, n_kf=int(a.kf_valid.sum()),
        pose_max_abs=float((a.kf_pose - c.kf_pose).abs().max()),
        point_max_abs=float((a.pt_pos - c.pt_pos)[both].abs().max()),
        live_points_card=int(a.pt_valid.sum()), live_points_cpu=int(c.pt_valid.sum()),
        kf_valid_equal=bool(torch.equal(a.kf_valid, c.kf_valid)),
        fwd_rows_equal=float((a.kf_kp_point == c.kf_kp_point).float().mean()),
        ba=(da, ea), ba_cpu=(dc, ec), cpu_s=cpu_s)
    log("[map step] card x2 bit-identical; card vs CPU: " + json.dumps(diff))
    log("[map step] stages on the card (host clock, synced): "
        + json.dumps(_map_step_stages(mapper, captured)))
    if not diff["kf_valid_equal"]:
        raise AssertionError("kf_valid differs between card and CPU")
    if not (diff["pose_max_abs"] <= 1e-3 and diff["point_max_abs"] <= 1e-3):
        raise AssertionError("card and CPU map steps differ by more than 1e-3")
    n_a, n_c = diff["live_points_card"], diff["live_points_cpu"]
    if abs(n_a - n_c) > 0.005 * n_c:
        raise AssertionError(f"live points {n_a} (card) vs {n_c} (CPU)")
    return diff


def train_vocabulary(slam, seq):
    """bench.py's vocabulary (`bench.py:88-107`): the descriptors of frames
    0, 12, ..., 228 from the system's own FrameBuilder, k = 10, L = 4,
    seed 1."""
    lr = _long_runs()
    t0 = time.perf_counter()
    _, frames = seq
    voc = lr.train_vocabulary(slam.builder, [
        (*frames[i], 1000.0 + i / 30.0) for i in range(0, N_FRAMES, lr.BENCH_VOC_STEP)])
    log(f"[loop] vocabulary: {voc.n_words} words (JAX, CPU: {JAX_CPU_LOOP_N_WORDS}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return voc


def _stage_summary(stage_ms: list) -> dict:
    out: dict = {}
    for name, ms_ in stage_ms:
        out.setdefault(name, []).append(round(ms_, 3))
    return out


def _loop_events(slam) -> list:
    fid = slam.map.kf_frame_id.cpu().numpy()
    return [(int(fid[e.query_kf]), int(fid[e.match_kf])) for e in slam.loop_closer.events]


def _loop_stage_pass(slam, seq) -> tuple[dict, dict]:
    """Another, untimed pass of the loop slice (after reset()) with each
    loop stage wrapped from here: a device sync before and after it and its
    host-clock ms recorded; the inputs of the first loop correction are kept
    for the replay. The timed pass runs none of this. Returns (ms per stage
    call, captured correction inputs)."""
    from orbslam_mapsave_tpu_torch.optim import global_ba
    from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod
    from orbslam_mapsave_tpu_torch.pipeline import loop_closing

    lc = slam.loop_closer
    timed, captured = [], []
    correct_loop = lc._correct_loop

    def capture(state, kf, match_kf, S, matched_pt, loop_pts):
        if not captured:
            captured.append(dict(state=type(state)(*[x.clone() for x in state]), kf=kf,
                                 match_kf=match_kf, S=S, matched_pt=matched_pt,
                                 loop_pts=loop_pts))
        return correct_loop(state, kf, match_kf, S, matched_pt, loop_pts)

    stages = [(lc, "compute_bow", "bow"), (loop_closing, "_detect_device", "detect"),
              (lc, "_sim3_chain", "sim3 lane"), (lc, "_correct", "correct"),
              (lc, "_essential", "essential"), (global_ba, "gba_init", "gba_init"),
              (global_ba, "gba_iterate", "gba_iter"), (gba_mod, "_apply_device", "gba_apply")]
    patches = [(obj, name, _synced(getattr(obj, name), label, timed))
               for obj, name, label in stages]
    _, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    slam.reset()
    with _patched(patches + [(lc, "_correct_loop", capture)]):
        for i in range(N_FRAMES):
            slam.track_rgbd(*frames[i], stamps[i])
        slam.flush_gba()
    if not captured:
        raise AssertionError("the stage pass closed no loop")
    return _stage_summary(timed), captured[0]


def phase_loop(dev, seq, map_path: Path) -> tuple[dict, object, dict]:
    """bench.py's headline workload: SLAMSystem with a vocabulary and loop
    closing on. One full untimed pass, flush_gba(), reset() (bench.py:141-146),
    then the timed pass, as a user runs it, whose map is saved to map_path
    (for phase 10). Then one more pass, untimed, times every loop stage and
    keeps the first loop correction's inputs."""
    voc = train_vocabulary(_bench_system(dev, True), seq)
    slam = _bench_system(dev, True, vocabulary=voc)
    lc = slam.loop_closer
    res = _run_slice(slam, seq, "loop", warmup=N_FRAMES)
    t0 = time.perf_counter()
    slam.save_map(map_path)
    res["save_ms"] = 1e3 * (time.perf_counter() - t0)
    events = _loop_events(slam)
    res.update(loops=len(lc.events), events=events,
               inliers=[e.n_inliers for e in lc.events], gba_applied=lc.gba_applied,
               gba_aborted=lc.gba_aborted, n_words=voc.n_words)
    log(f"[loop] events (query, match frame ids): {events}, JAX CPU: {JAX_CPU_LOOP_EVENTS}; "
        f"inliers {res['inliers']}; GBA jobs applied {lc.gba_applied}, aborted "
        f"{lc.gba_aborted}")
    _check_quality(res, JAX_CPU_LOOP_KEYFRAMES, JAX_CPU_LOOP_KF_ATE_M)
    if res["loops"] != len(JAX_CPU_LOOP_EVENTS):
        raise AssertionError(f"{res['loops']} loops vs JAX CPU {len(JAX_CPU_LOOP_EVENTS)}")
    if lc.gba_applied != res["loops"] or lc.gba_aborted:
        raise AssertionError(f"GBA jobs: {lc.gba_applied} applied, {lc.gba_aborted} aborted "
                             f"for {res['loops']} loops")
    if res["ba_lanes_dropped"] != 0:
        raise AssertionError(f"BA dropped {res['ba_lanes_dropped']} observation lanes")
    stages, cap = _loop_stage_pass(slam, seq)
    log("[loop] stage ms of the untimed stage pass (host clock, synced): "
        + json.dumps(stages))
    if _loop_events(slam) != events:
        raise AssertionError(f"the stage pass closed loops {_loop_events(slam)}, "
                             f"the timed pass {events}")
    res["stages_ms"] = stages
    return res, lc, cap


def _correction_inputs(cap: dict, dev) -> tuple:
    """(map, query slot, match slot, (S, matched points, loop points)) of a
    captured loop correction, copied to dev."""
    st = type(cap["state"])(*[x.to(dev).clone() for x in cap["state"]])
    return st, cap["kf"], cap["match_kf"], tuple(
        cap[k].to(dev) for k in ("S", "matched_pt", "loop_pts"))


def _loop_replay(lc, cap: dict, dev) -> tuple:
    """The first loop correction from its captured inputs on dev: the
    correction, the essential graph and one global-BA iteration from the
    corrected map. Returns (map after the correction, map after the
    essential graph, GBA poses, GBA points)."""
    from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod

    st, kf, mkf, args = _correction_inputs(cap, dev)
    corrected = lc._correct(st, kf, mkf, *args)
    st = lc._essential(corrected, kf, mkf)
    job = gba_mod.GBAJob(st, lc.cam, lc._t(dev)[1], n_iters=1)
    job.pump(1)
    return corrected, st, job._carry[0], job._carry[1]


def _live_edges(prob):
    """The pose-graph problem with its dead edge lanes cut out."""
    live = prob.edge_valid
    return prob._replace(**{k: getattr(prob, k)[live] for k in (
        "edge_i", "edge_j", "edge_meas", "edge_valid", "edge_weight")})


def _essential_solve(corrected, kf: int, mkf: int) -> dict:
    """The essential graph's solve at the bench's shapes, on a problem that
    makes it work. In the loop closer the solve returns its input: every
    measurement is taken from the poses it starts at, and an edge whose
    residual is the identity (a dead lane (0, 0) among them) has a NaN
    Jacobian that zeroes every step (kept for parity; the solver's early
    exit stops there after one linearization).
    Here the captured correction's graph keeps its live edges and their
    measurements, and every free keyframe starts from its corrected pose
    moved by a small Sim3 drawn from ESSENTIAL_SEED, so the 20 iterations
    (a 7K x 7K Cholesky each) must carry the keyframes back. Run twice on
    the card (bit-identical) and once on the CPU: Sim3 poses within
    ESSENTIAL_TOL, and moved by more than that."""
    from orbslam_mapsave_tpu_torch.geometry import se3
    from orbslam_mapsave_tpu_torch.optim import pose_graph
    from orbslam_mapsave_tpu_torch.pipeline import loop_closing

    prob = _live_edges(loop_closing.essential_graph_problem(corrected, kf, mkf))
    K = prob.S_init.shape[0]
    rng = np.random.default_rng(ESSENTIAL_SEED)
    xi = np.concatenate([rng.normal(scale=0.01, size=(K, 6)),
                         rng.normal(scale=0.002, size=(K, 1))], 1).astype(np.float32)
    xi[mkf] = 0.0  # the fixed keyframe
    prob = prob._replace(S_init=se3.sim3_exp(torch.from_numpy(xi).to(prob.S_init.device))
                         @ prob.S_init)
    t0 = time.perf_counter()
    outs = [pose_graph.optimize_pose_graph(prob, n_iters=20)[0] for _ in range(2)]
    torch.cuda.synchronize()
    card_s = (time.perf_counter() - t0) / 2
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("essential-graph solve not bit-repeatable on the card")
    t0 = time.perf_counter()
    S_cpu, _ = pose_graph.optimize_pose_graph(
        type(prob)(*[x.cpu() for x in prob]), n_iters=20)
    cpu_s = time.perf_counter() - t0
    live = prob.valid.cpu()
    S_card, S0 = outs[0].cpu(), prob.S_init.cpu()
    res = dict(edges=int(prob.edge_valid.shape[0]), keyframes=int(live.sum()),
               card_vs_cpu_max_abs=float((S_card - S_cpu)[live].abs().max()),
               moved_max_abs=float((S_card - S0)[live].abs().max()),
               to_corrected_max_abs=float((S_card - corrected.kf_pose.cpu())[live].abs().max()),
               card_s=card_s, cpu_s=cpu_s)
    log("[loop replay] essential graph on its live edges: " + json.dumps(res))
    if not res["card_vs_cpu_max_abs"] <= ESSENTIAL_TOL:
        raise AssertionError(f"essential-graph solve: card and CPU differ by "
                             f"{res['card_vs_cpu_max_abs']:.3g} > {ESSENTIAL_TOL}")
    if not res["moved_max_abs"] > ESSENTIAL_TOL:
        raise AssertionError("the essential-graph solve on the live edges moved no pose")
    return res


def phase_loop_replay(lc, cap: dict) -> dict:
    """The replay twice on the card (bit-identical) and once on the CPU:
    poses and points within 1e-3, equal kf_valid and loop edges; then the
    essential graph on the corrected map with the solver's early exit and
    with its full loop, bit-equal (`_essential_exit_vs_full`, dense route,
    bench caps), and the essential graph's solve on its live edges
    (`_essential_solve`)."""
    dev = torch.device("cuda", 0)
    outs = [_loop_replay(lc, cap, dev) for _ in range(2)]
    torch.cuda.synchronize()
    (ca, a, pa, xa), (cb, b, pb, xb) = outs
    differ = [k for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    differ += [k for k, x, y in zip(ca._fields, ca, cb) if not torch.equal(x, y)]
    if differ or not (torch.equal(pa, pb) and torch.equal(xa, xb)):
        raise AssertionError(f"loop replay not bit-repeatable on the card: {differ}")
    # what the essential graph changed on the card (a dead edge lane makes
    # the JAX solver, and so the port, return its input)
    live_kf, live_pt = a.kf_valid, a.pt_valid
    essential_change = dict(
        pose_max_abs=float((a.kf_pose - ca.kf_pose)[live_kf].abs().max()),
        point_max_abs=float((a.pt_pos - ca.pt_pos)[live_pt].abs().max()))
    t0 = time.perf_counter()
    _, c, pc, xc = _loop_replay(lc, cap, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    a = type(a)(*[x.cpu() for x in a])
    pa, xa = pa.cpu(), xa.cpu()
    both = a.pt_valid & c.pt_valid
    diff = dict(
        query_kf=cap["kf"], match_kf=cap["match_kf"], n_kf=int(a.kf_valid.sum()),
        pose_max_abs=float((a.kf_pose - c.kf_pose).abs().max()),
        point_max_abs=float((a.pt_pos - c.pt_pos)[both].abs().max()),
        gba_pose_max_abs=float((pa - pc).abs().max()),
        gba_point_max_abs=float((xa - xc)[both].abs().max()),
        live_points_card=int(a.pt_valid.sum()), live_points_cpu=int(c.pt_valid.sum()),
        kf_valid_equal=bool(torch.equal(a.kf_valid, c.kf_valid)),
        loop_edges_equal=bool(torch.equal(a.kf_loop_edges, c.kf_loop_edges)), cpu_s=cpu_s,
        essential_change_on_card=essential_change)
    log("[loop replay] card x2 bit-identical; card vs CPU: " + json.dumps(diff))
    if not (diff["kf_valid_equal"] and diff["loop_edges_equal"]):
        raise AssertionError("kf_valid or the loop edges differ between card and CPU")
    if max(diff[k] for k in ("pose_max_abs", "point_max_abs", "gba_pose_max_abs",
                             "gba_point_max_abs")) > 1e-3:
        raise AssertionError("card and CPU loop replays differ by more than 1e-3")
    diff["essential_exit_vs_full"] = _essential_exit_vs_full(
        lc, ca, cap["kf"], cap["match_kf"], "loop replay")
    if diff["essential_exit_vs_full"]["exit"]["route"] != "dense":
        raise AssertionError("the loop replay's essential graph did not run the dense route")
    diff["essential_live_edges"] = _essential_solve(ca, cap["kf"], cap["match_kf"])
    return diff


def phase_mono(dev, seq, voc) -> dict:
    """tools/bench_mono.py's workload on the card: SLAMSystem(cfg,
    MONOCULAR) over the u8 images of the bench sequence with the loop
    phase's vocabulary and loop closing on (free-scale Sim3). Untimed over
    WARMUP_FRAMES frames (the bootstrap, a few keyframes and mapping
    passes), reset(), then one timed 240-frame pass, one device sync per
    frame. The bootstrap's initializer and GBA and the loop stages are
    wrapped (synced) inside the timed pass; their ms are printed apart."""
    from orbslam_mapsave_tpu_torch.io import trajectory as traj_io
    from orbslam_mapsave_tpu_torch.ops import initializer
    from orbslam_mapsave_tpu_torch.optim import global_ba, pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod

    poses, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    slam = _bench_system(dev, True, vocabulary=voc, mono=True)
    lc = slam.loop_closer
    if lc.fix_scale:
        raise AssertionError("the monocular loop closer must leave the Sim3 scale free")
    for i in range(WARMUP_FRAMES):
        slam.track_monocular(frames[i][0], stamps[i])
    slam.flush_gba()
    warmup_keyframes = slam.n_keyframes
    slam.reset()
    torch.cuda.synchronize()

    calls, timed = 0, []
    dispatch = pose_opt.pose_optimization

    def counted(*args):
        nonlocal calls
        calls += 1
        return dispatch(*args)

    stages = [(initializer, "initialize_two_view", "bootstrap initializer"),
              (global_ba, "full_bundle_adjustment", "bootstrap GBA"),
              (lc, "_sim3_chain", "sim3 lane"), (lc, "_correct", "correct"),
              (lc, "_essential", "essential"), (global_ba, "gba_init", "gba_init"),
              (global_ba, "gba_iterate", "gba_iter"), (gba_mod, "_apply_device", "gba_apply")]
    patches = [(obj, name, _synced(getattr(obj, name), label, timed))
               for obj, name, label in stages]
    frame_ms = np.empty(N_FRAMES)
    with _patched(patches + [(pose_opt, "pose_optimization", counted)]):
        pose_opt_cuda.reset_launches()
        t_start = time.perf_counter()
        for i in range(N_FRAMES):
            t1 = time.perf_counter()
            pose = slam.track_monocular(frames[i][0], stamps[i])
            torch.cuda.synchronize()
            frame_ms[i] = 1e3 * (time.perf_counter() - t1)
            if pose.shape != (4, 4) or not np.isfinite(pose).all():
                raise AssertionError(f"frame {i}: bad pose {pose}")
        slam.flush_gba()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = pose_opt_cuda.launches

    traj = slam.tracker.trajectory
    lost = [i for i, (_, _, l) in enumerate(traj) if l]
    boot = next((i for i, (_, _, l) in enumerate(traj) if not l), None)
    ts, est = slam.keyframe_trajectory()
    kf_ate = traj_io.ate_rmse(stamps, poses, ts, np.linalg.inv(est), with_scale=True)
    events = _loop_events(slam)
    map_dropped, _ = slam.mapper.ba_lane_stats()
    loop_frame = (int(np.argmax(frame_ms)), float(frame_ms.max()))
    res = dict(frames=N_FRAMES, fps=N_FRAMES / wall,
               p50_ms=float(np.percentile(frame_ms, 50)),
               p99_ms=float(np.percentile(frame_ms, 99)), max_ms=float(frame_ms.max()),
               slowest_frame=loop_frame[0], bootstrap_frame=boot, lost_frames=lost,
               keyframes=slam.n_keyframes, points=slam.n_points, kf_ate_sim3_m=kf_ate,
               loops=len(events), events=events, inliers=[e.n_inliers for e in lc.events],
               gba_applied=lc.gba_applied, gba_aborted=lc.gba_aborted,
               ba_lanes_dropped=slam.tracker.ba_lanes_dropped + map_dropped,
               pose_optimizations=calls, launches=launches,
               warmup_keyframes=warmup_keyframes,
               jax_cpu=dict(bootstrap_frame=JAX_CPU_MONO_BOOTSTRAP_FRAME,
                            lost_frames=JAX_CPU_MONO_LOST_FRAMES,
                            keyframes=JAX_CPU_MONO_KEYFRAMES,
                            kf_ate_sim3_m=JAX_CPU_MONO_KF_ATE_SIM3_M,
                            events=JAX_CPU_MONO_EVENTS),
               stages_ms=_stage_summary(timed))
    log("[mono] " + json.dumps({k: v for k, v in res.items() if k != "stages_ms"}))
    log("[mono] stage ms (host clock, synced; the bootstrap's and the loop's): "
        + json.dumps(res["stages_ms"]))
    if boot != JAX_CPU_MONO_BOOTSTRAP_FRAME:
        raise AssertionError(f"bootstrapped on frame {boot}, JAX CPU "
                             f"{JAX_CPU_MONO_BOOTSTRAP_FRAME}")
    if lost != JAX_CPU_MONO_LOST_FRAMES:
        raise AssertionError(f"lost frames {lost}, JAX CPU {JAX_CPU_MONO_LOST_FRAMES}")
    if abs(res["keyframes"] - JAX_CPU_MONO_KEYFRAMES) > 0.2 * JAX_CPU_MONO_KEYFRAMES:
        raise AssertionError(f"{res['keyframes']} keyframes vs JAX CPU {JAX_CPU_MONO_KEYFRAMES}")
    if not kf_ate <= JAX_CPU_MONO_KF_ATE_SIM3_M + 0.01:
        raise AssertionError(f"Sim3 kf ATE {kf_ate:.4f} m vs JAX CPU "
                             f"{JAX_CPU_MONO_KF_ATE_SIM3_M:.4f} m")
    if res["loops"] != len(JAX_CPU_MONO_EVENTS):
        raise AssertionError(f"{res['loops']} loops vs JAX CPU {len(JAX_CPU_MONO_EVENTS)}")
    if lc.gba_applied != res["loops"] or lc.gba_aborted:
        raise AssertionError(f"GBA jobs: {lc.gba_applied} applied, {lc.gba_aborted} aborted "
                             f"for {res['loops']} loops")
    if res["ba_lanes_dropped"] != 0:
        raise AssertionError(f"BA dropped {res['ba_lanes_dropped']} observation lanes")
    if launches != calls or calls < 2 * (N_FRAMES - len(lost) - 1):
        raise AssertionError(f"{launches} pose-LM launches for {calls} pose optimizations")
    return res


def right_twc(Twc: np.ndarray) -> np.ndarray:
    """The stereo rig's right camera: Twc moved STEREO_BASELINE along its own
    x axis (`io/synthetic.write_stereo_sequence`)."""
    out = Twc.copy()
    out[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([STEREO_BASELINE, 0.0, 0.0])
    return out


def stereo_right_images(seq) -> list:
    """u8 right images of the bench trajectory, rendered in the bench room."""
    lr = _long_runs()
    t0 = time.perf_counter()
    poses, _ = seq
    out = [g for g, _ in lr.render(lr.ENDURANCE, np.stack([right_twc(T) for T in poses]),
                                   RENDER_WORKERS)]
    log(f"[stereo] rendered {len(out)} right images in {time.perf_counter() - t0:.1f} s")
    return out


def phase_stereo(dev, seq, voc) -> dict:
    """The stereo workload on the card: SLAMSystem(cfg, STEREO) at
    SystemConfig's default capacities over the bench sequence's u8 images
    and right images rendered STEREO_BASELINE to the right, with the loop
    phase's vocabulary and loop closing on. Untimed over WARMUP_FRAMES
    frames, reset(), one timed 240-frame pass, one device sync per frame.
    The loop stages are wrapped (synced) inside the timed pass, each
    essential graph's and global-BA job's solver recorded. Held one-sided
    to the JAX CPU run: lost frames no more, keyframes within 20%, kf ATE
    within 1 cm, its loop count, every loop's job applied and none
    aborted, no BA lane dropped, one pose-LM launch per pose optimization,
    and at least one CG essential graph and one applied pcg_dual job. The
    first loop's essential graph is then run again on its captured input
    with the solver's early exit and with its full loop, bit-equal
    (`_essential_exit_vs_full`, CG route, default capacities)."""
    from orbslam_mapsave_tpu_torch.io import trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import global_ba, pose_graph, pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod

    poses, frames = seq
    rights = stereo_right_images(seq)
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    slam = _bench_system(dev, True, vocabulary=voc, stereo=True)
    caps = (slam.cfg.max_keyframes, slam.cfg.max_points, slam.cfg.max_keypoints)
    if caps != STEREO_CAPS or slam.tracker.cfg.motion_th != 7.0:
        raise AssertionError(f"stereo system at caps {caps}, motion_th "
                             f"{slam.tracker.cfg.motion_th}")
    lc = slam.loop_closer
    for i in range(WARMUP_FRAMES):
        slam.track_stereo(frames[i][0], rights[i], stamps[i])
    slam.flush_gba()
    warmup_keyframes = slam.n_keyframes
    slam.reset()
    torch.cuda.synchronize()

    calls, timed, essential_solvers, gba_solvers = 0, [], [], []
    essential_iterations, essential_in = [], []
    dispatch = pose_opt.pose_optimization
    solve_graph = pose_graph.optimize_pose_graph
    job_init = gba_mod.GBAJob.__init__

    def counted(*args):
        nonlocal calls
        calls += 1
        return dispatch(*args)

    def recorded_graph(prob, *a, **k):
        essential_solvers.append(k.get("solver", "dense"))
        pose_graph.reset_iterations()
        out = solve_graph(prob, *a, **k)
        essential_iterations.append(pose_graph.iterations)
        return out

    def recorded_job(job, *a, **k):
        job_init(job, *a, **k)
        gba_solvers.append(job._solver)

    stages = [(lc, "_sim3_chain", "sim3 lane"), (lc, "_correct", "correct"),
              (lc, "_essential", "essential"), (global_ba, "gba_init", "gba_init"),
              (global_ba, "gba_iterate", "gba_iter"), (gba_mod, "_apply_device", "gba_apply")]
    patches = [(obj, name, _synced(getattr(obj, name), label, timed))
               for obj, name, label in stages]
    patches[2] = (lc, "_essential", _kept(patches[2][2], essential_in))
    patches += [(pose_opt, "pose_optimization", counted),
                (pose_graph, "optimize_pose_graph", recorded_graph),
                (gba_mod.GBAJob, "__init__", recorded_job)]
    frame_ms = np.empty(N_FRAMES)
    with _patched(patches):
        pose_opt_cuda.reset_launches()
        t_start = time.perf_counter()
        for i in range(N_FRAMES):
            t1 = time.perf_counter()
            pose = slam.track_stereo(frames[i][0], rights[i], stamps[i])
            torch.cuda.synchronize()
            frame_ms[i] = 1e3 * (time.perf_counter() - t1)
            if pose.shape != (4, 4) or not np.isfinite(pose).all():
                raise AssertionError(f"frame {i}: bad pose {pose}")
        slam.flush_gba()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = pose_opt_cuda.launches

    lost = [i for i, (_, _, l) in enumerate(slam.tracker.trajectory) if l]
    ts, est = slam.keyframe_trajectory()
    kf_ate = traj_io.ate_rmse(stamps, poses, ts, np.linalg.inv(est))
    events = _loop_events(slam)
    map_dropped, _ = slam.mapper.ba_lane_stats()
    res = dict(frames=N_FRAMES, caps=list(caps), fps=N_FRAMES / wall,
               p50_ms=float(np.percentile(frame_ms, 50)),
               p99_ms=float(np.percentile(frame_ms, 99)), max_ms=float(frame_ms.max()),
               slowest_frame=int(np.argmax(frame_ms)), lost_frames=lost,
               keyframes=slam.n_keyframes, points=slam.n_points, kf_ate_m=kf_ate,
               loops=len(events), events=events, inliers=[e.n_inliers for e in lc.events],
               gba_applied=lc.gba_applied, gba_aborted=lc.gba_aborted,
               essential_solvers=essential_solvers, essential_iterations=essential_iterations,
               gba_solvers=gba_solvers,
               ba_lanes_dropped=slam.tracker.ba_lanes_dropped + map_dropped,
               pose_optimizations=calls, launches=launches,
               warmup_keyframes=warmup_keyframes,
               jax_cpu=dict(lost_frames=JAX_CPU_STEREO_LOST_FRAMES,
                            keyframes=JAX_CPU_STEREO_KEYFRAMES,
                            kf_ate_m=JAX_CPU_STEREO_KF_ATE_M, events=JAX_CPU_STEREO_EVENTS),
               stages_ms=_stage_summary(timed))
    log("[stereo] " + json.dumps({k: v for k, v in res.items() if k != "stages_ms"}))
    log("[stereo] loop stage ms (host clock, synced; essential: "
        f"{essential_solvers}, LM iterations {essential_iterations}, GBA jobs: "
        f"{gba_solvers}): " + json.dumps(res["stages_ms"]))
    if len(lost) > len(JAX_CPU_STEREO_LOST_FRAMES):
        raise AssertionError(f"lost frames {lost}, JAX CPU {JAX_CPU_STEREO_LOST_FRAMES}")
    _check_quality(res, JAX_CPU_STEREO_KEYFRAMES, JAX_CPU_STEREO_KF_ATE_M)
    if res["loops"] != len(JAX_CPU_STEREO_EVENTS):
        raise AssertionError(f"{res['loops']} loops vs JAX CPU {len(JAX_CPU_STEREO_EVENTS)}")
    if lc.gba_applied != res["loops"] or lc.gba_aborted:
        raise AssertionError(f"GBA jobs: {lc.gba_applied} applied, {lc.gba_aborted} aborted "
                             f"for {res['loops']} loops")
    if "cg" not in essential_solvers or "pcg_dual" not in gba_solvers or not lc.gba_applied:
        raise AssertionError(f"no loop ran the CG essential graph and an applied pcg_dual "
                             f"job: essential {essential_solvers}, GBA {gba_solvers}")
    if res["ba_lanes_dropped"] != 0:
        raise AssertionError(f"BA dropped {res['ba_lanes_dropped']} observation lanes")
    if launches != calls or calls < 2 * (N_FRAMES - len(lost) - 1):
        raise AssertionError(f"{launches} pose-LM launches for {calls} pose optimizations")
    res["essential_exit_vs_full"] = _essential_exit_vs_full(lc, *essential_in[0], "stereo")
    if res["essential_exit_vs_full"]["exit"]["route"] != "cg":
        raise AssertionError("the stereo loop's essential graph did not run the CG route")
    return res


def _kidnap_sequence(seq):
    """(frames, ground-truth index per frame or None for a blank): frames
    0..KIDNAP_AT-1, KIDNAP_BLANKS blank frames, then KIDNAP_RESUME.."""
    _, frames = seq
    order = (list(range(KIDNAP_AT)) + [None] * KIDNAP_BLANKS
             + list(range(KIDNAP_RESUME, N_FRAMES)))
    blank = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    return [frames[i] if i is not None else blank for i in order], order


def _attempts_summary(attempts: list) -> dict:
    ms_ = [a["ms"] for a in attempts]
    return dict(attempts=len(attempts), accepted=sum(a["accepted"] for a in attempts),
                ms_p50=float(np.percentile(ms_, 50)) if ms_ else None,
                ms_max=float(max(ms_)) if ms_ else None,
                lm_steps=[a["lm_steps"] for a in attempts])


def _recording_relocalizer(rel, attempts: list, stage_ms: list) -> list:
    """Patches (for `_patched`) that time each relocalization attempt and its
    stages (device sync before and after each) and keep each attempt's
    candidates and inliers."""
    from orbslam_mapsave_tpu_torch.pipeline import relocalization

    batch, relocalize = rel.batch, rel.relocalize

    def recorded_batch(state, frame, cands, *a, **k):
        r = batch(state, frame, cands, *a, **k)
        attempts.append(dict(cands=list(cands), matches=r.n_matches.tolist(),
                             ransac=r.ransac_inliers.tolist(), n_opt=r.n_opt.tolist(),
                             lm_steps=r.lm_steps))
        return r

    def timed_attempt(*a):
        n = len(attempts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = relocalize(*a)
        torch.cuda.synchronize()
        ms_ = 1e3 * (time.perf_counter() - t0)
        if len(attempts) > n:  # a batch ran (there were candidates)
            attempts[-1].update(ms=ms_, accepted=out is not None)
        stage_ms.append(("attempt", ms_))
        return out

    # descriptor matching is what an attempt's time leaves after these
    return [(rel, "batch", recorded_batch), (rel, "relocalize", timed_attempt),
            (rel, "candidates", _synced(rel.candidates, "candidates", stage_ms)),
            (relocalization.epnp, "ransac_pnp",
             _synced(relocalization.epnp.ransac_pnp, "ransac", stage_ms)),
            (rel, "_opt_pose", _synced(rel._opt_pose, "pose LM (batched)", stage_ms)),
            (rel, "_re_search", _synced(rel._re_search, "re-search", stage_ms))]


def phase_kidnap(dev, seq, voc) -> dict:
    """Lost and found in the headline configuration: frames 0-149, 3 blank
    frames, then frames 100-239 with the clock running on, through
    `SLAMSystem.track_rgbd` with the loop phase's vocabulary. Every
    relocalization attempt is timed (synced) with its stages."""
    from orbslam_mapsave_tpu_torch.io import trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import tracking

    poses, _ = seq
    frames, order = _kidnap_sequence(seq)
    stamps = 1000.0 + np.arange(len(order)) / 30.0
    slam = _bench_system(dev, True, vocabulary=voc)
    attempts, stage_ms, states = [], [], []
    with _patched(_recording_relocalizer(slam.tracker.relocalizer, attempts, stage_ms)):
        pose_opt_cuda.reset_launches()
        t0 = time.perf_counter()
        for j, fr in enumerate(frames):
            slam.track_rgbd(*fr, stamps[j])
            states.append(slam.tracking_state)
        slam.flush_gba()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, batched = pose_opt_cuda.launches, pose_opt_cuda.launches_batched
    shown = [j for j, i in enumerate(order) if i is not None]
    ts, est = slam.keyframe_trajectory()
    kf_ate = traj_io.ate_rmse(stamps[shown], poses[[order[j] for j in shown]], ts,
                              np.linalg.inv(est))
    lost = [j for j, (_, _, l) in enumerate(slam.tracker.trajectory) if l]
    after = KIDNAP_AT + KIDNAP_BLANKS
    reloc = next((j for j in range(after, len(order)) if states[j] == tracking.OK), None)
    res = dict(frames=len(order), seconds=wall, lost_frames=len(lost),
               lost_first=lost[:1], lost_last=lost[-1:], reloc_frame=reloc,
               jax_cpu_reloc_frame=JAX_CPU_KIDNAP_RELOC_FRAME, keyframes=slam.n_keyframes,
               points=slam.n_points, kf_ate_m=kf_ate, loops=len(slam.loop_closer.events),
               launches=launches, launches_batched=batched, launches_b1=launches - batched,
               **_attempts_summary(attempts), stages_ms=_stage_summary(stage_ms))
    log("[kidnap] " + json.dumps({k: v for k, v in res.items() if k != "stages_ms"}))
    log("[kidnap] relocalization stages, ms per call (host clock, synced): "
        + json.dumps({k: [float(np.median(v)), len(v)] for k, v in res["stages_ms"].items()}))
    log("[kidnap] attempts (frame-ordered; candidates, each candidate's final "
        "inliers, ms): " + json.dumps([(len(a["cands"]), a["n_opt"], round(a["ms"], 1))
                                       for a in attempts]))
    for a in attempts[:3]:
        log("[kidnap] attempt: " + json.dumps(a))
    if reloc != JAX_CPU_KIDNAP_RELOC_FRAME:
        log(f"[kidnap] relocalized on frame {reloc}, the JAX CPU run on "
            f"{JAX_CPU_KIDNAP_RELOC_FRAME}")
    if not all(j in lost for j in range(KIDNAP_AT, after)):
        raise AssertionError(f"blank frames {KIDNAP_AT}..{after - 1} not all lost: {lost[:10]}")
    if reloc is None:
        raise AssertionError("never relocalized after the blank frames")
    if not batched:
        raise AssertionError("relocalization made no pose-LM launch with B > 1")
    _check_quality(res, JAX_CPU_KIDNAP_KEYFRAMES, JAX_CPU_KIDNAP_KF_ATE_M)
    # one-sided: the port's own vocabulary (trained on its frames) differs
    # from the JAX run's where ORB rounding ties change a training
    # descriptor, and this run's loop decisions follow the vocabulary;
    # handed the JAX vocabulary, the port closes no loop here either
    # (tools/jax_cpu_bench_reference.py --kidnap --port --jax-vocabulary)
    lc = slam.loop_closer
    res["events"] = _loop_events(slam)
    log(f"[kidnap] loops {res['loops']} {res['events']}, JAX CPU {JAX_CPU_KIDNAP_LOOPS}; "
        f"GBA jobs applied {lc.gba_applied}, aborted {lc.gba_aborted}")
    if res["loops"] < JAX_CPU_KIDNAP_LOOPS:
        raise AssertionError(f"{res['loops']} loops vs JAX CPU {JAX_CPU_KIDNAP_LOOPS}")
    if lc.gba_applied != res["loops"] or lc.gba_aborted:
        raise AssertionError(f"GBA jobs: {lc.gba_applied} applied, {lc.gba_aborted} aborted "
                             f"for {res['loops']} loops")
    return res


def _rows_equal(a, b, atol: float) -> bool:
    return bool(torch.equal(a.word, b.word)
                and (a.weight - b.weight).abs().max().item() <= atol)


def _check_batched_launch(cap: tuple) -> dict:
    """The captured relocalization batch (pose0 (B,4,4), PoseObs (B,M)):
    the kernel twice (bit-identical) against the plain version per
    candidate, and timed at its real B and M; then the same batch padded
    to B = 5 with copies of its first problem, the shape the JAX
    relocalizer always runs (`relocalization.py:220-226`), checked and
    timed alike (`B5`)."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda

    cam, pose0, obs = cap
    obs = pose_opt.PoseObs(*[x.contiguous() for x in obs])
    res = {}
    for key, idx in (("real", list(range(obs.valid.shape[0]))),
                     ("B5", list(range(obs.valid.shape[0])) + [0] * (5 - obs.valid.shape[0]))):
        p0 = pose0[idx].contiguous()
        ob = pose_opt.PoseObs(*[x[idx].contiguous() for x in obs])
        B, M = ob.valid.shape

        def kern(p0=p0, ob=ob):
            return pose_opt_cuda.pose_optimization_cuda(cam, p0, ob)

        a, b = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"batched launch ({key}) not bit-repeatable")
        errs, flips, vs64 = [], [], []
        for c in range(B):
            obs1 = pose_opt.PoseObs(*[x[c] for x in ob])
            pr, ir, _ = pose_opt.pose_optimization_ref(cam, p0[c], obs1)
            errs.append((a[0][c] - pr).abs().max().item())
            flips.append(_check_inliers(cam, a[0][c], a[1][c], a[2][c], pr, ir, obs1))
            if key == "real":
                # the plain version in float64 on the same problem: which of
                # the kernel and plain f32 is off when they disagree; and
                # plain f32 over PERM_ORDERS shuffled edge orders: how far
                # the summation order alone moves f32 on this problem
                p64, _, _ = pose_opt.pose_optimization_ref(
                    cam, p0[c].double(),
                    pose_opt.PoseObs(*[x.double() if x.is_floating_point() else x
                                       for x in obs1]))
                gen = torch.Generator(device=obs1.valid.device).manual_seed(c)
                spread = []
                for _ in range(PERM_ORDERS):
                    perm = torch.randperm(M, generator=gen, device=obs1.valid.device)
                    pp, _, _ = pose_opt.pose_optimization_ref(
                        cam, p0[c], pose_opt.PoseObs(*[x[perm] for x in obs1]))
                    spread.append((pp.double() - p64).abs().max().item())
                vs64.append(dict(kernel=(a[0][c].double() - p64).abs().max().item(),
                                 plain_f32=(pr.double() - p64).abs().max().item(),
                                 plain_f32_orders_max=max(spread),
                                 plain_f32_orders_median=float(np.median(spread))))
        bound_ms, bound_by, sm_ms, flops = _bound_ms(p0, ob, cam)
        res[key] = dict(B=B, M=M, inliers=a[2].tolist(), max_abs_err=errs, flips=flips,
                        ms=_time_ms(kern), graph_ms=_time_kernel_ms(kern), bound_ms=bound_ms,
                        bound_by=bound_by, sm_bound_ms=sm_ms, flops=flops)
        if vs64:
            res[key]["err_vs_f64"] = vs64
        log(f"[reuse] batched pose-LM launch ({key}) vs plain: " + json.dumps(res[key]))
        if not max(errs) <= POSE_TOL:
            raise AssertionError(f"batched kernel ({key}) != plain: pose err {max(errs):.3g}")
    return dict(res["real"], B5=res["B5"])


def phase_reuse(dev, seq, voc, map_path: Path, save_ms: float) -> dict:
    """Map reuse: the loop phase's saved map loaded with
    `SLAMSystem(..., reuse_map_path=...)` and localized against over the
    240 frames (one device sync per frame); then a load from a copy without
    BoW rows, and the first batched pose-LM launch held to the plain
    version and timed."""
    from orbslam_mapsave_tpu_torch.io import mapio
    from orbslam_mapsave_tpu_torch.io import trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import loop_closing, tracking

    poses, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    rebuilds = []
    rebuild = loop_closing.LoopCloser.rebuild_store

    def counted(self, state):
        rebuilds.append(1)
        return rebuild(self, state)

    with _patched([(loop_closing.LoopCloser, "rebuild_store", counted)]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam = _bench_system(dev, True, vocabulary=voc, reuse_map_path=str(map_path))
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        if not slam.localization_only or slam.tracking_state != tracking.LOST:
            raise AssertionError("a loaded map must start LOST in localization-only mode")
        if rebuilds:
            raise AssertionError("the persisted BoW rows were rebuilt")
        persisted = mapio.load_bow_store(map_path, voc.n_words, dev)
        if not _rows_equal(slam.loop_closer.bow_store, persisted, 0.0):
            raise AssertionError("the loaded BoW rows differ from the file's")
        n_kf0, n_pt0, slots0 = slam.n_keyframes, slam.n_points, int(slam.map.n_pt)

        captured, attempt = [], []
        batched = pose_opt.pose_optimization_batched
        rel = slam.tracker.relocalizer
        batch = rel.batch

        def capture(cam, pose0, obs):
            if not captured and pose0.shape[0] > 1:
                captured.append((cam, pose0.clone(), pose_opt.PoseObs(*[x.clone() for x in obs])))
            return batched(cam, pose0, obs)

        def keep_attempt(state, frame, cands, frame_id):
            # the first attempt over several candidates, for the profile phase
            # (a MapState is never written in place: keeping it is free)
            if not attempt and len(cands) > 1:
                attempt.append((state, frame, list(cands), frame_id))
            return batch(state, frame, cands, frame_id)

        states, frame_ms = [], np.empty(N_FRAMES)
        with _patched([(pose_opt, "pose_optimization_batched", capture),
                       (rel, "batch", keep_attempt)]):
            pose_opt_cuda.reset_launches()
            t_start = time.perf_counter()
            for i in range(N_FRAMES):
                t1 = time.perf_counter()
                slam.track_rgbd(*frames[i], stamps[i])
                torch.cuda.synchronize()
                frame_ms[i] = 1e3 * (time.perf_counter() - t1)
                states.append(slam.tracking_state)
            wall = time.perf_counter() - t_start
            launches, launches_b = pose_opt_cuda.launches, pose_opt_cuda.launches_batched

        # the same map saved without BoW rows: the load rebuilds them
        bare = map_path.with_name("map_without_bow.npz")
        mapio.save_map(bare, mapio.load_map(map_path, dev), ts_epoch=mapio.read_ts_epoch(map_path))
        again = _bench_system(dev, True, vocabulary=voc, reuse_map_path=str(bare))
        if len(rebuilds) != 1 or not _rows_equal(again.loop_closer.bow_store, persisted, 1e-6):
            raise AssertionError("a load without BoW rows must rebuild the persisted rows")
    traj = slam.tracker.trajectory
    ok = [i for i, (_, _, l) in enumerate(traj) if not l]
    est = np.linalg.inv(np.asarray([traj[i][1] for i in ok])) if ok else np.zeros((0, 4, 4))
    first = next((i for i, st in enumerate(states) if st == tracking.OK), None)
    res = dict(frames=N_FRAMES, fps=N_FRAMES / wall, p50_ms=float(np.percentile(frame_ms, 50)),
               p99_ms=float(np.percentile(frame_ms, 99)), max_ms=float(frame_ms.max()),
               first_reloc_frame=first, localized_frames=len(ok),
               lost_first=[i for i, (_, _, l) in enumerate(traj) if l and i > 0][:1],
               ate_localized_m=traj_io.ate_rmse(stamps, poses, stamps[ok], est),
               keyframes=slam.n_keyframes, points=slam.n_points, n_pt_slots=int(slam.map.n_pt),
               loaded=(n_kf0, n_pt0, slots0), launches=launches, launches_batched=launches_b,
               launches_b1=launches - launches_b, save_ms=save_ms, load_ms=load_ms,
               file_mb=map_path.stat().st_size / 1e6,
               jax_cpu=dict(first_reloc_frame=JAX_CPU_REUSE_FIRST_RELOC,
                            localized_frames=JAX_CPU_REUSE_LOCALIZED,
                            ate_localized_m=JAX_CPU_REUSE_ATE_M))
    log("[reuse] " + json.dumps(res))
    if first != JAX_CPU_REUSE_FIRST_RELOC:
        raise AssertionError(f"first relocalized frame {first}, JAX CPU "
                             f"{JAX_CPU_REUSE_FIRST_RELOC}")
    if len(ok) < 0.9 * JAX_CPU_REUSE_LOCALIZED:
        raise AssertionError(f"{len(ok)} frames localized, JAX CPU {JAX_CPU_REUSE_LOCALIZED}")
    if not res["ate_localized_m"] <= JAX_CPU_REUSE_ATE_M + 0.01:
        raise AssertionError(f"localized ATE {res['ate_localized_m']:.4f} m vs JAX CPU "
                             f"{JAX_CPU_REUSE_ATE_M:.4f} m")
    if (slam.n_keyframes, slam.n_points, int(slam.map.n_pt)) != (n_kf0, n_pt0, slots0):
        raise AssertionError("localization-only mode changed the map's keyframes or points")
    if not captured:
        raise AssertionError("no relocalization ran a batched pose LM")
    res["batched_launch"] = _check_batched_launch(captured[0])
    if not attempt:
        raise AssertionError("no relocalization attempt had several candidates")
    res["attempt"] = (rel, attempt[0])
    return res


CLI_FRAMES = 60  # frames of the bench trajectory the run_slam check writes


def _camera_yaml(path: Path):
    """bench.py's camera and ORB settings in the reference's yaml format."""
    keys = {"Camera.fx": 520.0, "Camera.fy": 520.0, "Camera.cx": W / 2, "Camera.cy": H / 2,
            "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
            "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0,
            "Camera.bf": 520.0 * 0.08, "ThDepth": 50.0, "DepthMapFactor": 5000.0,
            "ORBextractor.nFeatures": 2000, "ORBextractor.scaleFactor": 1.5,
            "ORBextractor.nLevels": 4, "ORBextractor.iniThFAST": 20,
            "ORBextractor.minThFAST": 7}
    path.write_text("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in keys.items()))


def phase_cli(dev, seq, voc, map_path: Path, tmp: Path) -> dict:
    """The remaining entry points on the card. `SLAMSystem.load_map`: a
    system that has mapped frames 0-29 loads phase 7's map, continues LOST
    in localization-only mode, relocalizes and tracks frames 0-29 without
    changing the loaded map. `apps/run_slam.py` (default device: the card):
    `--save-map` over a TUM copy of the bench trajectory's first CLI_FRAMES
    frames (PNG files, the bench room), then `--reuse-map` on it: starts
    LOST in localization-only mode, relocalizes, the map unchanged; then
    `--sensor mono` on the same images: bootstraps and tracks; then
    `--sensor stereo` on a KITTI-layout copy of the same frames (left and
    right images, STEREO_BASELINE apart): tracks at least 50 of them. The
    dataset reader needs Pillow; a machine without it runs the first part
    only and says so."""
    import importlib.util

    from orbslam_mapsave_tpu_torch.apps import run_slam
    from orbslam_mapsave_tpu_torch.io import mapio, synthetic
    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod
    from orbslam_mapsave_tpu_torch.pipeline import tracking
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    poses, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    slam = _bench_system(dev, True, vocabulary=voc)
    for i in range(30):
        slam.track_rgbd(*frames[i], stamps[i])
    slam.load_map(map_path)
    loaded = mapio.map_summary(slam.map)
    if not (slam.localization_only and slam.tracking_state == tracking.LOST):
        raise AssertionError("load_map must continue LOST in localization-only mode")
    states = []
    for i in range(30):
        slam.track_rgbd(*frames[i], stamps[i])
        states.append(slam.tracking_state)
    res = dict(load_map=dict(first_reloc_frame=states.index(tracking.OK)
                             if tracking.OK in states else None,
                             ok_frames=states.count(tracking.OK), loaded=loaded))
    if res["load_map"]["first_reloc_frame"] is None or mapio.map_summary(slam.map) != loaded:
        raise AssertionError(f"load_map: {res}")

    if importlib.util.find_spec("PIL") is None:
        res["run_slam"] = "not run: this machine has no Pillow, which the dataset reader needs"
        log("[cli] " + json.dumps(res))
        return res
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    data = synthetic.write_tum_sequence(tmp / "tum", K, poses[:CLI_FRAMES], width=W, height=H,
                                        seed=11)
    kitti = synthetic.write_stereo_sequence(tmp / "kitti", K, poses[:CLI_FRAMES], width=W,
                                            height=H, baseline=STEREO_BASELINE, seed=11)
    _camera_yaml(tmp / "cam.yaml")
    vocabulary.save_binary(tmp / "voc.bin", voc)
    base = ["--dataset", str(data), "--camera-yaml", str(tmp / "cam.yaml"),
            "--vocabulary", str(tmp / "voc.bin")]
    systems = []
    init = system_mod.SLAMSystem.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        systems.append((self, self.localization_only, self.tracking_state))

    cli_map = tmp / "cli_map.npz"
    with _patched([(system_mod.SLAMSystem, "__init__", keep)]):
        t0 = time.perf_counter()
        run_slam.main(base + ["--out", str(tmp / "a.txt"), "--kf-out", str(tmp / "ak.txt"),
                              "--save-map", str(cli_map)])
        t1 = time.perf_counter()
        run_slam.main(base + ["--out", str(tmp / "b.txt"), "--kf-out", str(tmp / "bk.txt"),
                              "--reuse-map", str(cli_map)])
        t2 = time.perf_counter()
        run_slam.main(base + ["--sensor", "mono", "--out", str(tmp / "m.txt"),
                              "--kf-out", str(tmp / "mk.txt")])
        t3 = time.perf_counter()
        run_slam.main(["--dataset", str(kitti), "--camera-yaml", str(tmp / "cam.yaml"),
                       "--vocabulary", str(tmp / "voc.bin"), "--sensor", "stereo",
                       "--out", str(tmp / "s.txt"), "--kf-out", str(tmp / "sk.txt")])
        t4 = time.perf_counter()
    (first, _, _), (reuse, loc_only, state0), (mono, _, _), (st, _, _) = systems
    lost = [lost for _, _, lost in reuse.tracker.trajectory]
    res["run_slam"] = dict(device=str(first.device), slam_s=t1 - t0, reuse_s=t2 - t1,
                           keyframes=first.n_keyframes, points=first.n_points,
                           reuse_started=(loc_only, state0),
                           localized_frames=lost.count(False), frames=len(lost),
                           saved=mapio.map_summary(mapio.load_map(cli_map)),
                           after_reuse=mapio.map_summary(reuse.map))
    mono_lost = [lost for _, _, lost in mono.tracker.trajectory]
    res["run_slam_mono"] = dict(device=str(mono.device), sensor=mono.sensor.name,
                                seconds=t3 - t2, keyframes=mono.n_keyframes,
                                points=mono.n_points, tracked_frames=mono_lost.count(False),
                                frames=len(mono_lost))
    st_lost = [lost for _, _, lost in st.tracker.trajectory]
    res["run_slam_stereo"] = dict(device=str(st.device), sensor=st.sensor.name,
                                  seconds=t4 - t3, keyframes=st.n_keyframes,
                                  points=st.n_points, tracked_frames=st_lost.count(False),
                                  frames=len(st_lost))
    log("[cli] " + json.dumps(res))
    r = res["run_slam"]
    if first.device.type != "cuda" or not loc_only or state0 != tracking.LOST:
        raise AssertionError("run_slam must run on the card and reuse must start LOST")
    if r["localized_frames"] < 1 or r["after_reuse"] != r["saved"]:
        raise AssertionError(f"run_slam --reuse-map: {r}")
    m = res["run_slam_mono"]
    if mono.device.type != "cuda" or m["keyframes"] < 2 or m["tracked_frames"] < CLI_FRAMES // 2:
        raise AssertionError(f"run_slam --sensor mono: {m}")
    m = res["run_slam_stereo"]
    if st.device.type != "cuda" or m["frames"] != CLI_FRAMES or m["tracked_frames"] < 50:
        raise AssertionError(f"run_slam --sensor stereo: {m}")
    return res


APPS_TRAIN = dict(height=96, width=96, steps=220, batch=16, net_width=32, seed=0)
APPS_JOINT_ERR_PX = 8.0  # mean joint error of the trained net (tests/test_pose_net.py)
POSE_NET_INPUT = (176, 320)  # the reference's OpenPose netInputSize 320x176
POSE_NET_HM_TOL = 0.05  # card vs CPU forward (bf16 convs), tests/test_torch_pose_net.py
POSE_NET_JOINT_TOL = 0.5
POSE_NET_CONF_TOL = 1e-2
APPS_MIN_TRACKED = 55  # of CLI_FRAMES, run_slam with the viewer
CALIB_FRAMES = 20  # frames tracked before and after change_calibration


def _level_masked(spec, mask: np.ndarray, xy: np.ndarray, octave: np.ndarray) -> np.ndarray:
    """Whether each keypoint's level pixel lies in the masked (zero) region
    of the mask resized to its level as orb.extract resizes it."""
    from orbslam_mapsave_tpu_torch.ops import orb

    out = np.zeros(len(xy), bool)
    for lvl, ls in enumerate(spec.levels):
        m = orb.resize_mask_nearest(torch.from_numpy(mask), ls.height, ls.width).numpy()
        on = octave == lvl
        lx = np.round(xy[on, 0] / ls.scale).astype(int)
        ly = np.round(xy[on, 1] / ls.scale).astype(int)
        out[on] = m[ly, lx] <= 0
    return out


def _apps_pose_net(dev) -> tuple[dict, object]:
    """PoseNet trained on the card as tests/test_pose_net.py trains it, and
    the full-width net (64) at the reference's input size, card against CPU."""
    from orbslam_mapsave_tpu_torch.models import pose_net, pose_synth

    render_s = 0.0
    render = pose_net.render_batch

    def timed_render(*a):  # the host's share: the stick figures of each batch
        nonlocal render_s
        t = time.perf_counter()
        out = render(*a)
        render_s += time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _patched([(pose_net, "render_batch", timed_render)]):
        net = pose_net.train_on_synthetic(**APPS_TRAIN, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    imgs, joints = pose_synth.render_batch(np.random.default_rng(123), 8, 96, 96)
    errs = [np.linalg.norm(pose_net.infer(net, torch.from_numpy(imgs[i]).to(dev)).cpu().numpy()
                           [:, :2] - joints[i], axis=-1) for i in range(8)]
    res = dict(train_s=train_s, train_render_s=render_s, train_steps=APPS_TRAIN["steps"],
               mean_joint_err_px=float(np.mean(errs)))

    h, w = POSE_NET_INPUT
    full = pose_net.init_params(pose_net.PoseNet(64), torch.Generator().manual_seed(0))
    img, _ = pose_synth.render_stick_figure(np.random.default_rng(5), h, w)
    gray = torch.from_numpy(img)
    with torch.no_grad():
        hm_cpu = full(gray[None, None] / 255.0)[0]
        kp_cpu = pose_net.decode_heatmaps(hm_cpu)
        full = full.to(dev)
        gray_d = gray.to(dev)
        hm_dev = full(gray_d[None, None] / 255.0)[0].cpu()
        kp_dev = pose_net.infer(full, gray_d).cpu()
    res.update(full_width=64, input=[h, w],
               full_hm_max_abs=float((hm_dev - hm_cpu).abs().max()),
               full_joint_max_px=float((kp_dev[:, :2] - kp_cpu[:, :2]).abs().max()),
               full_conf_max_abs=float((kp_dev[:, 2] - kp_cpu[:, 2]).abs().max()),
               full_forward_ms=_time_ms(lambda: pose_net.infer(full, gray_d)))
    log("[apps] pose net: " + json.dumps(res))
    if not res["mean_joint_err_px"] < APPS_JOINT_ERR_PX:
        raise AssertionError(f"trained PoseNet: mean joint error {res['mean_joint_err_px']} px")
    if (res["full_hm_max_abs"] > POSE_NET_HM_TOL or res["full_joint_max_px"] > POSE_NET_JOINT_TOL
            or res["full_conf_max_abs"] > POSE_NET_CONF_TOL):
        raise AssertionError(f"PoseNet(64) card forward vs CPU: {res}")
    return res, net


def _apps_gait(net) -> dict:
    """The gait chain on the trained backbone (tests/test_pose_net.py): the
    OpDetector's Kalman filters, its 3D lift at 2 m and mask; then the UDP
    robot sends the hip joint's command over 127.0.0.1 and receives it."""
    import socket

    from orbslam_mapsave_tpu_torch import config as cfg_mod
    from orbslam_mapsave_tpu_torch.apps import human_pose, udp_robot
    from orbslam_mapsave_tpu_torch.models import pose_net, pose_synth

    det = human_pose.OpDetector(backbone=pose_net.make_backbone(net), fx=100.0, fy=100.0,
                                cx=48.0, cy=48.0, mask_radius=8)
    img, _ = pose_synth.render_stick_figure(np.random.default_rng(7), 96, 96)
    depth = np.full((96, 96), 2.0, np.float32)
    mask = None
    for _ in range(3):  # let the Kalman filters settle
        mask = det.run_frame(img, depth)
    if mask is None:
        raise AssertionError("OpDetector found no person")
    hip = det.joints_3d[human_pose.HIP_C]
    hy, hx = int(det.joints_2d[human_pose.HIP_C, 1]), int(det.joints_2d[human_pose.HIP_C, 0])
    angles = det.gait_angles()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    robot = udp_robot.UDPRobot(cfg_mod.UDPConfig(ip_client="127.0.0.1", port_in=port,
                                                 port_out=port, send_interval_ms=10,
                                                 receiver_interval_ms=50))
    robot.update_hip(hip)
    robot.start()
    try:
        t0 = time.time()
        while not robot.control_command and time.time() - t0 < 10:
            time.sleep(0.01)
    finally:
        robot.stop()
    res = dict(hip_xyz=[float(v) for v in hip], hip_masked=bool(mask[hy, hx] == 0.0),
               gait_angles=angles, udp_sent=robot.current_command(),
               udp_received=robot.control_command[:3])
    log("[apps] gait chain: " + json.dumps(res))
    if not abs(hip[2] - 2.0) < 0.3:
        raise AssertionError(f"hip joint depth {hip[2]} m, not within 0.3 m of 2 m")
    if not res["hip_masked"] or not all(np.isfinite(v) for v in angles.values()):
        raise AssertionError(f"gait chain: {res}")
    if not robot.control_command or robot.control_command[0] != res["udp_sent"]:
        raise AssertionError(f"UDP command not received: {res}")
    return res


def _apps_masked_orb(dev, seq) -> dict:
    """Human-masked ORB at full size: the mask OpDetector.render_mask draws
    around a 640x480 stick figure's joints, FrameBuilder.build on a bench
    frame on the card with and without it."""
    from orbslam_mapsave_tpu_torch.apps import human_pose
    from orbslam_mapsave_tpu_torch.geometry import projection
    from orbslam_mapsave_tpu_torch.models import pose_synth
    from orbslam_mapsave_tpu_torch.ops import orb
    from orbslam_mapsave_tpu_torch.pipeline import frame

    _, joints = pose_synth.render_stick_figure(np.random.default_rng(11), H, W)
    det = human_pose.OpDetector()
    det.joints_2d = joints.astype(np.float64)
    det.joints_conf = np.ones(human_pose.N_JOINTS)
    mask = det.render_mask((H, W))
    cam = projection.Camera.create(520.0, 520.0, W / 2, H / 2, bf=520.0 * 0.08, width=W,
                                   height=H)
    spec = orb.ORBSpec.create(H, W, n_features=2000, max_kp=2048)
    builder = frame.FrameBuilder(cam, spec, dev)
    image, depth = seq[1][10]
    out = []
    for m in (None, mask):
        fr = builder.build(image, 0.0, depth, m)
        v = fr.valid.cpu().numpy()
        xy, octv = fr.kp_xy_raw.cpu().numpy()[v], fr.kp_octave.cpu().numpy()[v]
        out.append((xy, octv, fr.desc.cpu().numpy()[v]))
    (xy0, oc0, d0), (xy1, oc1, d1) = out
    inside0 = _level_masked(spec, mask, xy0, oc0)
    inside1 = _level_masked(spec, mask, xy1, oc1)
    plain = {(float(x), float(y), int(o)): bytes(d) for (x, y), o, d in zip(xy0, oc0, d0)}
    kept = [(plain[k], bytes(d)) for k, d in
            zip(((float(x), float(y), int(o)) for (x, y), o in zip(xy1, oc1)), d1) if k in plain]
    res = dict(mask_share=float((mask == 0).mean()), keypoints_unmasked=len(xy0),
               keypoints_masked=len(xy1), removed_by_mask=int(inside0.sum()),
               inside_after=int(inside1.sum()), kept_outside=len(kept),
               kept_descriptor_changed=sum(a != b for a, b in kept))
    log("[apps] masked ORB: " + json.dumps(res))
    if res["inside_after"] or res["removed_by_mask"] == 0:
        raise AssertionError(f"human-masked ORB: {res}")
    if res["kept_descriptor_changed"] or not kept:
        raise AssertionError(f"keypoints outside the mask changed descriptors: {res}")
    return res


def _apps_run_slam(tmp: Path, base: list) -> dict:
    """run_slam over the TUM copy on the card without, then with, the
    viewer flags: frames tracked, the HTML view, the live page rewrites,
    the PNG snapshots, one pose-LM launch per pose optimization."""
    import importlib.util

    from orbslam_mapsave_tpu_torch.apps import run_slam
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod
    from orbslam_mapsave_tpu_torch.viz import html_viewer, viewer as viewer_mod

    systems, viewers, writes = [], [], []
    calls = 0
    dispatch, export = pose_opt.pose_optimization, html_viewer.export_html
    init, vinit = system_mod.SLAMSystem.__init__, viewer_mod.Viewer.__init__

    def counted(*args):
        nonlocal calls
        calls += 1
        return dispatch(*args)

    def keep(self, *a, **k):
        init(self, *a, **k)
        systems.append(self)

    def keep_viewer(self, *a, **k):
        vinit(self, *a, **k)
        viewers.append(self)

    def recorded(state, path, **k):
        writes.append(bool(k.get("live_refresh")))
        return export(state, path, **k)

    # the PNG snapshots need matplotlib and Pillow (host libraries, as in JAX)
    missing = [m for m in ("matplotlib", "PIL") if importlib.util.find_spec(m) is None]
    have_png = not missing
    if missing:
        log(f"[apps] viewer PNGs not written or checked: this machine lacks {missing}; "
            "run_slam runs with --html-view and --html-live only")
    flags = ["--html-view", str(tmp / "v.html"), "--html-live", "5"]
    if have_png:
        flags += ["--viewer-dir", str(tmp / "viewer")]
    with _patched([(system_mod.SLAMSystem, "__init__", keep),
                   (viewer_mod.Viewer, "__init__", keep_viewer),
                   (html_viewer, "export_html", recorded)]):
        t0 = time.perf_counter()
        run_slam.main(base + ["--out", str(tmp / "nv.txt"), "--kf-out", str(tmp / "nvk.txt")])
        t1 = time.perf_counter()
        pose_opt_cuda.reset_launches()
        with _patched([(pose_opt, "pose_optimization", counted)]):
            run_slam.main(base + ["--out", str(tmp / "v.txt"), "--kf-out", str(tmp / "vk.txt"),
                                  *flags])
        launches = pose_opt_cuda.launches
        t2 = time.perf_counter()
    slam, viewer = systems[-1], viewers[-1]
    lost = [lost for _, _, lost in slam.tracker.trajectory]
    page = (tmp / "v.html").read_text()
    pngs = sorted(p.name for p in (tmp / "viewer").iterdir()) if (tmp / "viewer").is_dir() else []
    res = dict(device=str(slam.device), frames=len(lost), tracked_frames=lost.count(False),
               keyframes=slam.n_keyframes, seconds_without_viewer=t1 - t0,
               seconds_with_viewer=t2 - t1, fps_without_viewer=CLI_FRAMES / (t1 - t0),
               fps_with_viewer=CLI_FRAMES / (t2 - t1), live_rewrites=writes.count(True),
               live_gen=viewer._live_gen, html_bytes=len(page), pngs=len(pngs),
               pose_optimizations=calls, launches=launches)
    log("[apps] run_slam with the viewer: " + json.dumps(res))
    if slam.device.type != "cuda" or res["tracked_frames"] < APPS_MIN_TRACKED:
        raise AssertionError(f"run_slam with the viewer: {res}")
    if "__DATA__" in page or '"pts": [[' not in page or res["live_rewrites"] < 1:
        raise AssertionError(f"the HTML view: {res}")
    if launches != calls or calls < 2 * (res["tracked_frames"] - 1):
        raise AssertionError(f"{launches} pose-LM launches for {calls} pose optimizations")
    if have_png and (len(pngs) != 2 * (CLI_FRAMES // 10)
                     or not any(n.startswith("map_") for n in pngs)):
        raise AssertionError(f"viewer PNGs: {pngs}")
    return res


def _apps_host_tools(dev, tmp: Path, data: Path) -> dict:
    """bin_vocabulary --train on the card, .bin -> .txt -> .bin (the text
    format's 6 decimals plus the float32 rounding of a weight up to ~10:
    weights within 1e-6); the native TUM loader against the Python one."""
    from orbslam_mapsave_tpu_torch.apps import bin_vocabulary
    from orbslam_mapsave_tpu_torch.io import dataset, native_loader
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    voc = bin_vocabulary.main(["--train", str(data), str(tmp / "apps_voc.bin"),
                               "--device", str(dev)])
    bin_vocabulary.main([str(tmp / "apps_voc.bin"), str(tmp / "apps_voc.txt")])
    bin_vocabulary.main([str(tmp / "apps_voc.txt"), str(tmp / "apps_voc2.bin")])
    back = vocabulary.load(tmp / "apps_voc2.bin")
    same = all(np.array_equal(getattr(voc, f), getattr(back, f))
               for f in ("parent", "children", "desc", "word_id"))
    w_err = float(np.abs(voc.weight - back.weight).max())
    res = dict(n_words=voc.n_words, n_words_back=back.n_words, tables_equal=same,
               weight_max_err=w_err)
    if back.n_words != voc.n_words or not same or w_err > 1e-6:
        raise AssertionError(f"bin_vocabulary round trip: {res}")
    if not native_loader.available():
        log("[apps] host tools: " + json.dumps(res))
        log("[apps] NativeTUMDataset not checked: native/liborbtpu_io.so does not load on "
            "this host and cannot be built (g++, libpng and zlib are needed)")
        return res
    py = dataset.TUMDataset(data)
    nat = native_loader.NativeTUMDataset(data)
    frames_ok = len(nat) == len(py)
    for i in (0, 5, len(py) - 1):
        t_py, g_py, d_py = py[i]
        t_nat, g_nat, d_nat = nat[i]
        frames_ok &= (abs(t_py - t_nat) < 1e-9 and np.allclose(g_nat, g_py, rtol=0, atol=1.0)
                      and np.allclose(d_nat, d_py, rtol=0, atol=1e-4))
    res.update(native_library=Path(native_loader.get_lib()._name).name,
               native_frames=len(nat), native_equal=bool(frames_ok))
    log("[apps] host tools: " + json.dumps(res))
    if not frames_ok:
        raise AssertionError(f"NativeTUMDataset differs from TUMDataset: {res}")
    return res


def _apps_calibration(dev, seq, tmp: Path) -> dict:
    """change_calibration after CALIB_FRAMES tracked frames, to a camera
    yaml written from the bench camera: the next CALIB_FRAMES frames track."""
    from orbslam_mapsave_tpu_torch.pipeline import tracking

    _, frames = seq
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    slam = _bench_system(dev, True)
    for i in range(CALIB_FRAMES):
        slam.track_rgbd(*frames[i], stamps[i])
    _camera_yaml(tmp / "apps_cam.yaml")
    slam.change_calibration(tmp / "apps_cam.yaml")
    states = []
    for i in range(CALIB_FRAMES, 2 * CALIB_FRAMES):
        slam.track_rgbd(*frames[i], stamps[i])
        states.append(slam.tracking_state)
    res = dict(cam=[float(slam.cam.fx), float(slam.cam.cx), float(slam.cam.bf)],
               th_depth=slam.tracker.cfg.th_depth, frames_after=len(states),
               lost_after=sum(s != tracking.OK for s in states), keyframes=slam.n_keyframes)
    log("[apps] change_calibration: " + json.dumps(res))
    if res["lost_after"] or slam.tracker.builder is not slam.builder:
        raise AssertionError(f"change_calibration: {res}")
    return res


def _apps_aruco(seq) -> dict:
    """A marker from cv2.aruco pasted into a bench frame is detected with a
    finite pose; without cv2.aruco the detector is a no-op, as in JAX."""
    from orbslam_mapsave_tpu_torch.apps import aruco

    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    det = aruco.ArucoDetector(K=K)
    if not det.available:
        log("[apps] ArUco: cv2.aruco is not installed here; the detector is a no-op, as in JAX")
        return dict(available=False)
    import cv2

    img = seq[1][0][0].copy()
    img[180:300, 260:380] = cv2.aruco.generateImageMarker(
        cv2.aruco.getPredefinedDictionary(det.cfg.dictionary_id), 7, 120)
    r = det.detect(img)
    res = dict(available=True, ids=[] if r.ids is None else r.ids.ravel().tolist(),
               tvec=None if r.tvecs is None else r.tvecs[0].tolist())
    log("[apps] ArUco: " + json.dumps(res))
    if res["ids"] != [7] or not np.isfinite(r.tvecs).all():
        raise AssertionError(f"ArUco: {res}")
    return res


def phase_apps(dev, seq, tmp: Path) -> dict:
    """The application layer on the card (after `cli`, on its TUM copy):
    PoseNet trained and run at full width, the gait chain and the UDP
    robot, human-masked ORB, run_slam with the viewer, bin_vocabulary, the
    native loader, change_calibration and ArUco."""
    t0 = time.perf_counter()
    res, net = _apps_pose_net(dev)
    res = dict(pose_net=res, gait=_apps_gait(net), masked_orb=_apps_masked_orb(dev, seq))
    data = tmp / "tum"
    if data.is_dir():
        base = ["--dataset", str(data), "--camera-yaml", str(tmp / "cam.yaml"),
                "--vocabulary", str(tmp / "voc.bin")]
        res["run_slam"] = _apps_run_slam(tmp, base)
        res["host_tools"] = _apps_host_tools(dev, tmp, data)
    else:
        log("[apps] run_slam, bin_vocabulary and the native loader not run: the cli phase "
            "wrote no TUM copy (no Pillow)")
    res["calibration"] = _apps_calibration(dev, seq, tmp)
    res["aruco"] = _apps_aruco(seq)
    log(f"[apps] phase passed in {time.perf_counter() - t0:.1f} s")
    return res




def _long_runs():
    """tools/scale_endurance_torch.py: the long runs' sequences, systems
    and drive loop."""
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import scale_endurance_torch

    return scale_endurance_torch


@contextlib.contextmanager
def _counted_pose_opt():
    """Count the pose optimizations asked for (the tracker's, and the
    relocalizer's batches over its candidates) and the pose-LM launches made
    meanwhile (counters zeroed on entry). Yields a dict that holds `calls`,
    `batched_calls`, `launches` and `launches_batched` once the block ends."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda

    out = dict(calls=0, batched_calls=0)
    single, batched = pose_opt.pose_optimization, pose_opt.pose_optimization_batched

    def counted(*args):
        out["calls"] += 1
        return single(*args)

    def counted_batch(*args):
        out["batched_calls"] += 1
        return batched(*args)

    with _patched([(pose_opt, "pose_optimization", counted),
                   (pose_opt, "pose_optimization_batched", counted_batch)]):
        pose_opt_cuda.reset_launches()
        yield out
        out.update(launches=pose_opt_cuda.launches,
                   launches_batched=pose_opt_cuda.launches_batched)


def _long_run(dev, wl, voc, name: str, frames: int | None = None) -> tuple[dict, object]:
    """Render the workload's first `frames` frames in a process pool, warm
    up over WARMUP_FRAMES untimed, reset(), then one timed pass through
    SLAMSystem.track_rgbd with the pose-LM launches counted. Returns (the
    run's numbers without the per-frame ms, the system)."""
    lr = _long_runs()
    t0 = time.perf_counter()
    gt = wl.poses(frames)
    seq = lr.render(wl, gt, RENDER_WORKERS)
    render_s = time.perf_counter() - t0
    slam = lr.make_system(wl, voc, dev)
    lr.warm_up(slam, seq, WARMUP_FRAMES)
    with _counted_pose_opt() as pc:
        res = lr.drive(slam, seq, gt)
    frame_ms = res.pop("frame_ms")
    tracked = len(frame_ms) - 1 - len(res["lost_frames"])
    res.update(render_s=render_s, pose_optimizations=pc["calls"],
               relocalization_batches=pc["batched_calls"], launches=pc["launches"],
               launches_batched=pc["launches_batched"])
    if (pc["launches"] != pc["calls"] + pc["batched_calls"] or pc["calls"] < 2 * tracked):
        raise AssertionError(f"[{name}] {pc['launches']} pose-LM launches for {pc['calls']} "
                             f"pose optimizations and {pc['batched_calls']} relocalization "
                             f"batches in {tracked} tracked frames")
    return res, slam


def _vs(res: dict, ref: dict, keys) -> dict:
    """{key: [port, JAX CPU]}, lost frames as their stretches."""
    st = _long_runs().stretches
    return {k: [st(res[k]), st(ref[k])] if k == "lost_frames" else [res[k], ref[k]]
            for k in keys}


def _loggable(res: dict) -> dict:
    """The run's numbers with the lost frames left out (their stretches
    stay)."""
    return {k: v for k, v in res.items() if k != "lost_frames"}


def phase_endurance(dev, voc) -> dict:
    """tools/endurance.py's long run through the port: 1,200 frames at
    640x480 (circle_trajectory(1200, radius=0.55, revs=2.6), BoxRoom(2.0,
    seed=11)), 2,000 features, max_keyframes 256 and max_points 49,152 so
    the point allocator crosses the 0.9 compaction trigger, phase 7's vocabulary
    and loop closing on. Held to the JAX CPU run: lost frames no more,
    keyframes within 20%, kf ATE within 1 cm, at least its loops, at least
    one point and one keyframe compaction where it has them, every loop's
    global-BA job applied (or aborted by a newer loop), 0 BA lanes dropped,
    one pose-LM launch per pose optimization, and every live keyframe's BoW
    row equal to the row rebuilt from its descriptors."""
    lr = _long_runs()
    ref = JAX_CPU_ENDURANCE
    res, slam = _long_run(dev, lr.ENDURANCE, voc, "endurance")
    res["bow_rows_checked"], res["bow_rows_differing"] = lr.bow_rows_match_rebuild(slam)
    ms_c = res["compaction_ms"]
    res["ms_per_compaction"] = float(np.mean(ms_c)) if ms_c else None
    log("[endurance] " + json.dumps(_loggable(res)))
    log("[endurance] port vs JAX CPU: " + json.dumps(_vs(res, ref, (
        "lost_frames", "keyframes_live", "kf_ate_m", "loops", "point_compactions",
        "keyframe_compactions", "ba_escalations", "ba_lanes_dropped"))))
    if len(res["lost_frames"]) > len(ref["lost_frames"]):
        raise AssertionError(f"lost frames {res['lost_frames']}, JAX CPU {ref['lost_frames']}")
    _check_quality(dict(keyframes=res["keyframes_live"], kf_ate_m=res["kf_ate_m"]),
                   ref["keyframes_live"], ref["kf_ate_m"])
    if res["loops"] < ref["loops"]:
        raise AssertionError(f"{res['loops']} loops vs JAX CPU {ref['loops']}")
    for kind in ("point_compactions", "keyframe_compactions"):
        if ref[kind] and not res[kind]:
            raise AssertionError(f"no {kind.replace('_', ' ')[:-1]}; JAX CPU made {ref[kind]}")
    applied, aborted = res["gba_applied"], res["gba_aborted"]
    if applied + aborted != res["loops"] or (res["loops"] and aborted >= res["loops"]):
        raise AssertionError(f"GBA jobs: {applied} applied, {aborted} aborted for "
                             f"{res['loops']} loops")
    if res["ba_lanes_dropped"] != 0:
        raise AssertionError(f"BA dropped {res['ba_lanes_dropped']} observation lanes")
    if res["bow_rows_differing"]:
        raise AssertionError(f"{res['bow_rows_differing']} of {res['bow_rows_checked']} live "
                             "keyframes' BoW rows differ from a rebuild")
    return res


def phase_scale(dev, map_step_ms: tuple) -> tuple[dict, object]:
    """The reference scale (tools/scale_endurance.py's configuration) for
    the first SCALE_FRAMES frames of its 8,000-frame sweep: 320x240, 1,000
    features, max_keyframes 1,536, max_points 262,144, max_keypoints 1,024,
    its own vocabulary (every 60th frame of the sweep) and loop closing on.
    Held to the JAX CPU run at the same frames: lost frames no more, live
    and allocated keyframes within 20%, kf ATE within 1 cm, one pose-LM
    launch per pose optimization; every essential graph on the CG solver and
    every global-BA job on pcg_dual. Loops, escalations and dropped lanes
    are printed beside JAX's (the port reproduces JAX's O_BA truncation);
    the mapping-step ms beside the bench caps' of phase 5 (`map_step_ms`)."""
    lr = _long_runs()
    ref = JAX_CPU_SCALE
    t0 = time.perf_counter()
    voc_frames = lr.vocabulary_frames(lr.SCALE, RENDER_WORKERS)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc = lr.train_vocabulary(lr.make_system(lr.SCALE, None, dev).builder, voc_frames)
    log(f"[scale] vocabulary: {voc.n_words} words (JAX, CPU: {ref['n_words']}); "
        f"{len(voc_frames)} frames rendered in {render_s:.1f} s, trained in "
        f"{time.perf_counter() - t0:.1f} s")
    res, slam = _long_run(dev, lr.SCALE, voc, "scale", SCALE_FRAMES)
    res.update(n_words=voc.n_words, bench_map_step_p50_ms=map_step_ms[0],
               bench_map_step_p99_ms=map_step_ms[1])
    log("[scale] " + json.dumps(_loggable(res)))
    log("[scale] port vs JAX CPU: " + json.dumps(_vs(res, ref, (
        "lost_frames", "keyframes_live", "kf_alloc_watermark", "kf_ate_m", "loops",
        "ba_escalations", "ba_lanes_dropped", "gba_solvers", "essential_solvers"))))
    log(f"[scale] essential graphs: routes {res['essential_solvers']}, LM iterations "
        f"{res['essential_iterations']} (1: the solver's early exit fired)")
    log(f"[scale] ms per mapping step p50 {res['map_step_p50_ms']:.1f} / p99 "
        f"{res['map_step_p99_ms']:.1f} at K_cap 1536 / P_cap 262144, beside "
        f"{map_step_ms[0]:.1f} / {map_step_ms[1]:.1f} at the bench caps (phase 5)")
    if len(res["lost_frames"]) > len(ref["lost_frames"]):
        raise AssertionError(f"lost frames {res['lost_frames']}, JAX CPU {ref['lost_frames']}")
    for k in ("keyframes_live", "kf_alloc_watermark"):
        if abs(res[k] - ref[k]) > 0.2 * ref[k]:
            raise AssertionError(f"{k} {res[k]} vs JAX CPU {ref[k]}")
    if not res["kf_ate_m"] <= ref["kf_ate_m"] + 0.01:
        raise AssertionError(f"kf ATE {res['kf_ate_m']:.4f} m vs JAX CPU {ref['kf_ate_m']:.4f} m")
    if set(res["essential_solvers"]) - {"cg"} or set(res["gba_solvers"]) - {"pcg_dual"}:
        raise AssertionError(f"essential graphs {res['essential_solvers']}, GBA jobs "
                             f"{res['gba_solvers']}: expected cg and pcg_dual")
    return res, slam


def _capture_ba_window(mapper, captured) -> object:
    """The local-BA window (BAProblem) of the captured mapping step: the
    step replayed with local_bundle_adjustment recording its problem."""
    from orbslam_mapsave_tpu_torch.optim import local_ba

    probs, solve = [], local_ba.local_bundle_adjustment

    def recorded(cam, prob, *a, **k):
        probs.append(prob)
        return solve(cam, prob, *a, **k)

    with _patched([(local_ba, "local_bundle_adjustment", recorded)]):
        mapper._map_step(*captured)
    if not probs:
        raise AssertionError("the captured mapping step ran no local BA")
    return probs[0]


def _interleaved(n: int) -> np.ndarray:
    """new_of_old of n slots interleaved across their two halves: slot s of
    the first half goes to 2s, slot s of the second to 2(s - n/2) + 1."""
    old = np.arange(n)
    return np.where(old < n // 2, 2 * old, 2 * (old - n // 2) + 1)


def relaid_map(state):
    """The map with its keyframe and point slots interleaved
    (`_interleaved`) and every holder of a slot id renumbered: the parent,
    loop edges, covisibility, the points' reference, first and observing
    keyframes, the keypoints' points; the watermarks follow their slots.
    The same map on other slots: a map that fills the front of its
    capacities puts live rows into both halves of each. Slot 0 (the
    keyframe that the global BA holds fixed) stays."""
    dev = state.kf_pose.device
    kf_new, pt_new = (torch.as_tensor(_interleaved(n), device=dev)
                      for n in (state.kf_capacity, state.pt_capacity))
    ko, po = torch.argsort(kf_new), torch.argsort(pt_new)  # old slot of each new one

    def renumber(ids, new_of_old):
        return torch.where(ids >= 0, new_of_old[torch.clamp(ids, min=0).long()].to(ids.dtype),
                           ids)

    f = {k: x[ko] if k.startswith("kf_") else x[po] if k.startswith("pt_") else x
         for k, x in state._asdict().items()}
    f["covis"] = state.covis[ko][:, ko]
    for k in ("kf_parent", "kf_loop_edges", "pt_ref_kf", "pt_first_kf", "pt_obs_kf"):
        f[k] = renumber(f[k], kf_new)
    f["kf_kp_point"] = renumber(f["kf_kp_point"], pt_new)
    for k, new_of_old in (("n_kf", kf_new), ("n_pt", pt_new)):
        n = int(f[k])
        f[k] = torch.tensor(int(new_of_old[:n].max()) + 1 if n else 0, dtype=f[k].dtype,
                            device=dev)
    return type(state)(**f)


def _live_rows_per_rank(state, world: int) -> list:
    """[live keyframes, live points] in each rank's blocks at `world` ranks
    (rows [r n / world, (r + 1) n / world) of each capacity)."""
    kv, pv = state.kf_valid.cpu(), state.pt_valid.cpu()
    bk, bp = kv.shape[0] // world, pv.shape[0] // world
    return [[int(kv[r * bk:(r + 1) * bk].sum()), int(pv[r * bp:(r + 1) * bp].sum())]
            for r in range(world)]


def parallel_inputs(tmp: Path, seq, voc, maps: dict, window, cam) -> Path:
    """Write what the ranks read into tmp/parallel: the maps
    ({name: (MapState, Camera, inv_level_sigma2, one-process solver)}),
    the local-BA window, the bench sequence and the vocabulary."""
    from orbslam_mapsave_tpu_torch.io import mapio
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    d = tmp / "parallel"
    d.mkdir(exist_ok=True)
    meta = {"maps": {}, "cam": list(cam)}
    for name, (state, mcam, isig, solver) in maps.items():
        mapio.save_map(d / f"{name}_map.npz", state)
        meta["maps"][name] = dict(cam=list(mcam), isig=torch.as_tensor(isig).tolist(),
                                  solver=solver,
                                  live_rows=_live_rows_per_rank(state, PARALLEL_WORLD))
    np.savez(d / "window.npz", **{k: v.cpu().numpy() for k, v in window._asdict().items()})
    poses, frames = seq
    np.savez(d / "seq.npz", poses=poses, gray=np.stack([f[0] for f in frames]),
             depth=np.stack([f[1] for f in frames]))
    vocabulary.save_binary(d / "voc.bin", voc)
    (d / "inputs.json").write_text(json.dumps(meta))
    return d


def _launch_ranks(d: Path, world: int, backend: str, devices: list[str], tasks: list[str],
                  tag: str) -> list[dict]:
    """Start `world` ranks of this script (`--parallel-rank`), each with the
    env triplet on a free port of 127.0.0.1, the backend and its device;
    wait for all of them (killed past PARALLEL_TIMEOUT_S). Returns each
    rank's results; any rank's failure raises with its output's tail."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(r))
            logf = open(d / f"{tag}_rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(d),
                 tag, backend, devices[r], ",".join(tasks)],
                env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
        t0 = time.perf_counter()
        for p, _ in procs:
            p.wait(timeout=max(1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    for r in range(world):
        text = (d / f"{tag}_rank{r}.log").read_text()
        keep = text[-6000:] if r in failed else "\n".join(
            ln for ln in text.splitlines() if ln.startswith(("[parallel]", "[gloo")))
        log(f"[parallel] {tag} rank {r} of {world} (exit {procs[r][0].returncode}):\n{keep}")
    if failed:
        raise AssertionError(f"{tag}: ranks {failed} of {world} failed")
    out = []
    for r in range(world):
        res = json.loads((d / f"{tag}_rank{r}.json").read_text())
        res["arrays"] = dict(np.load(d / f"{tag}_rank{r}.npz"))
        out.append(res)
    return out


def _gaps(got: dict, ref: dict, name: str, ref_name: str) -> dict:
    """`name`'s solve in got against `ref_name`'s in ref: max |difference|
    of the poses (or cameras), of each live observation's predicted pixel
    and of the points, and the cost's relative difference."""
    def gap(k):
        a, b = got[f"{name}_{k}"].astype(np.float64), ref[f"{ref_name}_{k}"]
        return float(np.max(np.abs(a - b))) if a.size else 0.0

    cost, ref_cost = float(got[f"{name}_cost"]), float(ref[f"{ref_name}_cost"])
    return dict(pose=gap("poses"), px=gap("px"), pts_m=gap("pts"),
                cost=abs(cost - ref_cost) / max(abs(ref_cost), 1e-12))


def _past_bounds(gaps: dict) -> dict:
    return {k: [gaps[k], t] for k, t in (("pose", PAR_POSE_TOL), ("px", PAR_PX_TOL),
                                         ("cost", PAR_COST_RTOL)) if not gaps[k] <= t}


def _vs_solution(got: dict, ref: dict, name: str, ref_name: str, label: str,
                 exact: bool = False) -> dict:
    """The gaps (`_gaps`) logged, then held to PAR_POSE_TOL / PAR_PX_TOL /
    PAR_COST_RTOL (the points' 3D difference is not held), or with `exact`
    every gap, the points' too, to 0."""
    out = _gaps(got, ref, name, ref_name)
    log(f"[parallel] {label}: " + json.dumps(out))
    if exact and any(out.values()):
        raise AssertionError(f"{label}: not bit-equal {out}")
    bad = _past_bounds(out)
    if bad:
        raise AssertionError(f"{label}: past the tolerance {bad}")
    return out


def _control(got: dict, ref: dict, name: str, ref_name: str, label: str) -> dict:
    """A broken solve under the same measures as `_vs_solution`, logged;
    `run_parallel` fails if it is within every bound (the bounds could not
    tell it from a sound solve)."""
    out = _gaps(got, ref, name, ref_name)
    log(f"[parallel] control, {label}: " + json.dumps(out)
        + f"; past the bounds on {sorted(_past_bounds(out))}")
    return out


def _lane_px(cam, poses, pts, lane_cam, live) -> torch.Tensor:
    """Each live lane's predicted pixel (n, 2): its point projected by its
    camera's pose."""
    T = poses[torch.clamp(lane_cam, min=0).long()]
    pc = torch.sum(T[..., :3, :3] * pts[:, None, None, :], dim=-1) + T[..., :3, 3]
    uv = torch.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                      cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], dim=-1)
    return uv[live]


def _ranks_equal(ranks: list[dict], keys) -> None:
    """Replicated results: bit-equal on every rank."""
    for r, res in enumerate(ranks[1:], 1):
        for k in keys:
            if not np.array_equal(res["arrays"][k], ranks[0]["arrays"][k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's")


def _check_live(ranks: list[dict], ref: dict) -> dict:
    """Step (c): the ranks agree with each other on every decision, took
    the multi-rank branches, and match `ref`, the JAX run on as many
    devices (JAX_CPU_MULTI)."""
    keys = ("loop_events", "loop_inliers", "loop_keyframes", "loop_kf_frames", "loop_kf_ate_m",
            "kidnap_reloc_frame", "kidnap_lost_frames", "kidnap_keyframes", "kidnap_kf_ate_m",
            "kidnap_loops")
    for r, res in enumerate(ranks[1:], 1):
        differ = [k for k in keys if res[k] != ranks[0][k]]
        if differ:
            raise AssertionError(f"rank {r} differs from rank 0 on {differ}: "
                                 + json.dumps({k: [res[k], ranks[0][k]] for k in differ}))
    got = ranks[0]
    for res in ranks:
        if res["loop_gba_multi_rank"] < 1 or res["loop_gba_applied"] != res["loop_loops"]:
            raise AssertionError(f"rank {res['rank']}: {res['loop_gba_multi_rank']} multi-rank "
                                 f"GBA jobs, {res['loop_gba_applied']} applied for "
                                 f"{res['loop_loops']} loops")
        if res["kidnap_sharded_queries"] < 1:
            raise AssertionError(f"rank {res['rank']}: the relocalizer ran no sharded query")
        if res["kidnap_launches"] < 1:
            raise AssertionError(f"rank {res['rank']}: no pose-LM launch in the kidnap run")
    if [tuple(e) for e in got["loop_events"]] != ref["loop_events"]:
        raise AssertionError(f"loops at {got['loop_events']}, JAX {ref['loop_events']}")
    _check_quality(dict(keyframes=got["loop_keyframes"], kf_ate_m=got["loop_kf_ate_m"]),
                   ref["loop_keyframes"], ref["loop_kf_ate_m"])
    if got["kidnap_reloc_frame"] != ref["kidnap_reloc_frame"]:
        raise AssertionError(f"kidnap relocalized on frame {got['kidnap_reloc_frame']}, JAX "
                             f"on {ref['kidnap_reloc_frame']}")
    if got["kidnap_loops"] < ref["kidnap_loops"]:
        raise AssertionError(f"{got['kidnap_loops']} kidnap loops, JAX {ref['kidnap_loops']}")
    _check_quality(dict(keyframes=got["kidnap_keyframes"], kf_ate_m=got["kidnap_kf_ate_m"]),
                   ref["kidnap_keyframes"], ref["kidnap_kf_ate_m"])
    return {k: got[k] for k in keys}


def run_parallel(d: Path, world: int, backend: str, devices: list[str], live: bool) -> dict:
    """Steps (a)-(c) of the parallel phase over the inputs in d: one NCCL
    rank on devices[0] (the distributed GBA on each map and the one-process
    solve of the same map), then `world` ranks on `backend` (the same
    solves and dist_ba on the local-BA window, equal to one rank's; with
    `live`, the loop slice and the kidnap run of the live system on every
    rank). Returns the phase's numbers."""
    meta = json.loads((d / "inputs.json").read_text())
    for name, m in meta["maps"].items():
        log(f"[parallel] {name} map: [live keyframes, live points] in each of "
            f"{PARALLEL_WORLD} ranks' blocks: {m['live_rows']}")
    relaid = meta["maps"].get(PARALLEL_RELAID)
    if relaid and not all(n > 0 for rows in relaid["live_rows"] for n in rows):
        raise AssertionError(f"{PARALLEL_RELAID}: a rank's block holds no live row: "
                             f"{relaid['live_rows']}")
    one = _launch_ranks(d, 1, "nccl", devices[:1], ["solve", "reference"], "world1")[0]
    a1 = one["arrays"]
    res = {"world1": {k: v for k, v in one.items() if k != "arrays"}, "vs_one_process": {},
           "controls": {}}
    for name, m in meta["maps"].items():
        res["vs_one_process"][name] = _vs_solution(
            a1, a1, name, "ref_" + name,
            f"{name} map, world 1 (nccl) vs the one-process {m['solver']} solve")
        res["controls"]["nosolve_" + name] = _control(
            a1, a1, "nosolve_" + name, "ref_" + name,
            f"{name} map with no solve vs the one-process {m['solver']} solve")
    res["controls"]["nosolve_window"] = _control(
        a1, a1, "nosolve_window", "window", "the window with no solve vs world 1's solve")
    if relaid:  # the same problem on other slots: its solve mapped back
        kf_new = _interleaved(a1["ref_loop_poses"].shape[0])
        cost = float(a1["ref_loop_cost"])
        gaps = dict(pose=float(np.max(np.abs(a1[f"ref_{PARALLEL_RELAID}_poses"][kf_new]
                                             - a1["ref_loop_poses"]))),
                    cost=abs(float(a1[f"ref_{PARALLEL_RELAID}_cost"]) - cost)
                    / max(abs(cost), 1e-12))
        log(f"[parallel] {PARALLEL_RELAID} vs loop map, one-process solves, slots mapped "
            "back: " + json.dumps(gaps))
        if not (gaps["pose"] <= PAR_POSE_TOL and gaps["cost"] <= PAR_COST_RTOL):
            raise AssertionError(f"{PARALLEL_RELAID}'s solve is not the loop map's: {gaps}")
        res["relaid_vs_loop"] = gaps
    tasks = ["solve", "control"] + (["live"] if live else [])
    ranks = _launch_ranks(d, world, backend, devices, tasks, f"world{world}")
    keys = [f"{n}_{f}" for n in meta["maps"] for f in ("poses", "pts", "px", "cost")]
    _ranks_equal(ranks, keys + ["window_poses", "window_pts", "window_cost"])
    an = ranks[0]["arrays"]
    # the loop map's point blocks split where its sums' trees do: bit-equal
    res["vs_world1"] = {
        name: _vs_solution(an, a1, name, name, f"{name}, world {world} ({backend}) vs world 1",
                           exact=name == "loop")
        for name in list(meta["maps"]) + ["window"]}
    for name in list(meta["maps"]) + ["window"]:
        for c, what in (("droppsum", "psum terms"), ("dropgather", "all-gather blocks")):
            res["controls"][f"{c}_{name}"] = _control(
                an, a1, f"{c}_{name}", name,
                f"{name}, world {world} ({backend}) with rank 0's {what} zeroed vs world 1")
    if relaid:
        res["controls"][f"droppsum1_{PARALLEL_RELAID}"] = _control(
            an, a1, f"droppsum1_{PARALLEL_RELAID}", PARALLEL_RELAID,
            f"{PARALLEL_RELAID}, world {world} ({backend}) with rank 1's psum terms zeroed "
            "vs world 1")
    res[f"world{world}"] = [{k: v for k, v in r.items() if k != "arrays"} for r in ranks]
    if live:
        if world not in JAX_CPU_MULTI:
            raise AssertionError(f"no JAX run on {world} devices to hold {world} ranks to")
        res["live"] = _check_live(ranks, JAX_CPU_MULTI[world])
        log("[parallel] live system, rank 0 (the ranks agree): " + json.dumps(res["live"]))
    blind = {k: v for k, v in res["controls"].items() if not _past_bounds(v)}
    if blind:
        raise AssertionError(f"controls within every bound: {blind}")
    return res


def phase_parallel(d: Path) -> dict:
    """The distributed solvers and the live system's multi-rank branches
    on the card: (a) one NCCL rank, (b)-(c) PARALLEL_WORLD gloo ranks on
    cuda:0 (NCCL takes one rank per card)."""
    t0 = time.perf_counter()
    res = run_parallel(d, PARALLEL_WORLD, "gloo", ["cuda:0"] * PARALLEL_WORLD, live=True)
    # with more cards, the largest world that a JAX run is held for once
    # more over NCCL, one card per rank
    n = max((w for w in JAX_CPU_MULTI if w <= torch.cuda.device_count()), default=1)
    if n > 1:
        res["nccl_cards"] = run_parallel(d, n, "nccl", [f"cuda:{r}" for r in range(n)],
                                         live=True)
    res["seconds"] = time.perf_counter() - t0
    w1 = res["world1"]
    log("[parallel] ms per LM iteration (table build included; device sync), world 1 nccl: "
        + json.dumps({k: w1[k] for k in w1 if k.endswith("ms_per_iter")}))
    for r in res[f"world{PARALLEL_WORLD}"]:
        log(f"[parallel] world {PARALLEL_WORLD} gloo rank {r['rank']} on {r['device']}: "
            + json.dumps({k: r[k] for k in r if k.endswith(("ms_per_iter", "fps"))})
            + "; essential graphs [route, LM iterations]: "
            + json.dumps(r.get("essential_solves")))
    log(f"[parallel] phase took {res['seconds']:.1f} s")
    return res


def _rank_solves(task: set, mesh, d: Path, meta: dict, dev, out: dict, arrays: dict):
    """A rank's solves: the distributed GBA on each saved map, with the
    one-process solve ("reference", one rank) beside it, and dist_ba on the
    local-BA window. The controls, each under the same name with a prefix:
    "nosolve_" (with "reference"), the input map or window through 0 LM
    iterations; with "control", the same solves over a broken mesh that
    zeroes rank 0's term of every psum ("droppsum_") or rank 0's block of
    every all-gather ("dropgather_"), and on PARALLEL_RELAID rank 1's term
    of every psum ("droppsum1_"). On the loop and scale maps and the window
    rank 0 holds the live keyframes (the first slots); on PARALLEL_RELAID
    every rank's blocks hold live rows."""
    from orbslam_mapsave_tpu_torch.geometry import projection
    from orbslam_mapsave_tpu_torch.io import mapio
    from orbslam_mapsave_tpu_torch.optim import global_ba, local_ba
    from orbslam_mapsave_tpu_torch.parallel import dist_ba, dist_gba
    from orbslam_mapsave_tpu_torch.parallel import mesh as pmesh

    class DropPsum(pmesh.Mesh):
        def psum(self, x):
            return super().psum(torch.zeros_like(x) if self.rank == 0 else x)

    class DropGather(pmesh.Mesh):
        def all_gather(self, x):
            return super().all_gather(torch.zeros_like(x) if self.rank == 0 else x)

    class DropPsum1(pmesh.Mesh):
        def psum(self, x):
            return super().psum(torch.zeros_like(x) if self.rank == 1 else x)

    controls = {}  # prefix: (mesh, whether it iterates)
    if "reference" in task:
        controls["nosolve"] = (mesh, False)
    if "control" in task:
        for c, cls in (("droppsum", DropPsum), ("dropgather", DropGather),
                       ("droppsum1", DropPsum1)):
            controls[c] = (cls(mesh.size, mesh.rank, mesh.device, mesh.grouped), True)
    for i, (name, m) in enumerate(meta["maps"].items()):
        state = mapio.load_map(d / f"{name}_map.npz", dev)
        cam = projection.Camera(*m["cam"])
        isig = torch.tensor(m["isig"], dtype=torch.float32, device=dev)
        if i == 0:  # untimed: the communicator's and the solver's first calls
            dist_gba.distributed_full_ba(cam, state, isig, mesh, n_iters=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, pts, cost = dist_gba.distributed_full_ba(cam, state, isig, mesh,
                                                        n_iters=PARALLEL_GBA_ITERS)
        torch.cuda.synchronize()
        out[f"{name}_ms_per_iter"] = 1e3 * (time.perf_counter() - t0) / PARALLEL_GBA_ITERS
        tb = global_ba.build_tables(state, isig)
        arrays.update({f"{name}_poses": poses, f"{name}_pts": pts, f"{name}_cost": cost,
                       f"{name}_px": _lane_px(cam, poses, pts, tb.po_cam, tb.po_valid)})
        for c, (cmesh, solve) in controls.items():
            if c == "droppsum1" and name != PARALLEL_RELAID:
                continue
            cp, cx, cc = dist_gba.distributed_full_ba(
                cam, state, isig, cmesh, n_iters=PARALLEL_GBA_ITERS if solve else 0)
            arrays.update({f"{c}_{name}_poses": cp, f"{c}_{name}_pts": cx,
                           f"{c}_{name}_cost": cc,
                           f"{c}_{name}_px": _lane_px(cam, cp, cx, tb.po_cam, tb.po_valid)})
        if "reference" in task:
            t0 = time.perf_counter()
            rp, rx, rc = global_ba.full_bundle_adjustment(
                cam, state, isig, n_iters=PARALLEL_GBA_ITERS, solver=m["solver"])
            torch.cuda.synchronize()
            out[f"ref_{name}_ms_per_iter"] = (1e3 * (time.perf_counter() - t0)
                                              / PARALLEL_GBA_ITERS)
            arrays.update({f"ref_{name}_poses": rp, f"ref_{name}_pts": rx,
                           f"ref_{name}_cost": rc,
                           f"ref_{name}_px": _lane_px(cam, rp, rx, tb.po_cam, tb.po_valid)})
        log(f"[parallel] {name} map (K_cap {state.kf_capacity}, P_cap {state.pt_capacity}, "
            f"{int(state.n_kf)} / {int(state.n_pt)} allocated): cost {float(cost):.6g}, "
            f"{out[f'{name}_ms_per_iter']:.1f} ms per LM iteration")
        del state
    w = np.load(d / "window.npz")
    prob = local_ba.BAProblem(**{k: torch.from_numpy(w[k]).to(dev) for k in w.files})
    cam = projection.Camera(*meta["cam"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = dist_ba.make_distributed_ba(cam, mesh, n_iters=PARALLEL_BA_ITERS)(
        dist_ba.shard_problem(prob, mesh))
    torch.cuda.synchronize()
    out["window_ms_per_iter"] = 1e3 * (time.perf_counter() - t0) / PARALLEL_BA_ITERS
    out["window_shape"] = list(prob.obs_cam.shape) + [prob.cam_pose.shape[0]]
    struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    arrays.update(window_poses=r.cam_pose, window_pts=r.pt_pos, window_cost=r.chi2,
                  window_px=_lane_px(cam, r.cam_pose, r.pt_pos, prob.obs_cam, struct))
    for c, (cmesh, solve) in controls.items():
        if c == "droppsum1":
            continue
        r = dist_ba.make_distributed_ba(cam, cmesh, n_iters=PARALLEL_BA_ITERS if solve else 0)(
            dist_ba.shard_problem(prob, cmesh))
        arrays.update({f"{c}_window_poses": r.cam_pose, f"{c}_window_pts": r.pt_pos,
                       f"{c}_window_cost": r.chi2,
                       f"{c}_window_px": _lane_px(cam, r.cam_pose, r.pt_pos, prob.obs_cam,
                                                  struct)})


def _rank_live(d: Path, dev, out: dict):
    """A rank's live system: the loop slice from a fresh system (one pass)
    and the kidnap run, with the GBA jobs' distributed solves and the
    relocalizer's sharded queries counted."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
    from orbslam_mapsave_tpu_torch.parallel import dist_gba, dist_reloc
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    z = np.load(d / "seq.npz")
    seq = (z["poses"], list(zip(z["gray"], z["depth"])))
    voc = vocabulary.load_binary(d / "voc.bin")
    count = {"gba": 0, "reloc": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            count[key] += 1
            return fn(*a, **k)
        return wrapper

    with _patched([(dist_gba, "distributed_full_ba",
                    counted("gba", dist_gba.distributed_full_ba)),
                   (dist_reloc, "shard_store", counted("reloc", dist_reloc.shard_store))]):
        slam = _bench_system(dev, True, vocabulary=voc)
        lres = _run_slice(slam, seq, "parallel loop", warmup=0)
        lc = slam.loop_closer
        fid = slam.map.kf_frame_id.cpu().numpy()
        out.update(loop_fps=lres["fps"], loop_events=_loop_events(slam),
                   loop_inliers=[e.n_inliers for e in lc.events], loop_loops=len(lc.events),
                   loop_keyframes=lres["keyframes"], loop_kf_ate_m=lres["kf_ate_m"],
                   loop_kf_frames=fid[slam.map.kf_valid.cpu().numpy()].tolist(),
                   loop_gba_applied=lc.gba_applied, loop_gba_multi_rank=count["gba"])
        del slam, lc
        pose_opt_cuda.reset_launches()
        kres = phase_kidnap(dev, seq, voc)
        out.update(kidnap_fps=kres["frames"] / kres["seconds"],
                   kidnap_reloc_frame=kres["reloc_frame"],
                   kidnap_lost_frames=kres["lost_frames"], kidnap_keyframes=kres["keyframes"],
                   kidnap_kf_ate_m=kres["kf_ate_m"], kidnap_loops=kres["loops"],
                   kidnap_launches=kres["launches"], kidnap_sharded_queries=count["reloc"])


def parallel_rank(d: Path, tag: str, backend: str, device: str, tasks: str) -> int:
    """One rank of the parallel phase (a process of its own, started by
    `_launch_ranks` with the env triplet): joins the process group and
    runs its tasks ("solve", "reference", "live"); writes
    d/{tag}_rank{r}.json and .npz."""
    import os

    from orbslam_mapsave_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device)
    world = int(os.environ["NUM_PROCESSES"])
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    if not pmesh.initialize_distributed(dev, backend=backend):
        raise RuntimeError("COORDINATOR_ADDRESS is not set")
    mesh = pmesh.make_mesh(device=dev)
    task = set(tasks.split(","))
    meta = json.loads((d / "inputs.json").read_text())
    _record_essential_solves()
    out = dict(rank=mesh.rank, world=mesh.size, backend=backend, device=str(dev),
               card=torch.cuda.get_device_name(dev))
    arrays: dict = {}
    _rank_solves(task, mesh, d, meta, dev, out, arrays)
    if "live" in task:
        _rank_live(d, dev, out)
        out["essential_solves"] = ESSENTIAL_SOLVES
    np.savez(d / f"{tag}_rank{mesh.rank}.npz",
             **{k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in arrays.items()})
    (d / f"{tag}_rank{mesh.rank}.json").write_text(json.dumps(out))
    log("[parallel] rank done: " + json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def _profile_ranges(ranges: list) -> dict:
    """Each (name, fn) of `ranges` once unprofiled-range, then once inside a
    record_function range of its name, all in one torch.profiler session;
    per range: device kernels, host reads (stream syncs), copies, device
    and wall ms, busy share and the top device operations."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in ranges:
            fn()
            torch.cuda.synchronize()
        for name, fn in ranges:
            with record_function(name):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    out = {}
    for name, _ in ranges:
        span = next(e for e in events if e.name == name).time_range

        def inside(e, span=span):
            return e.time_range.start >= span.start and e.time_range.end <= span.end

        dev = [e for e in events if e.device_type == DeviceType.CUDA and inside(e)
               and e.name != name]  # the range itself shows on the device too
        kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
        cpu = [e for e in events if e.device_type == DeviceType.CPU and inside(e)]
        by_name: dict[str, list[float]] = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        device_us = sum(sum(v) for v in by_name.values())
        out[name] = dict(
            kernels=len(kernels),
            launch_api_calls=sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                                 for e in cpu),
            # a read of a value syncs its stream; torch.cuda.synchronize() at
            # the range's end is a device sync, not counted
            host_reads=sum(e.name == "cudaStreamSynchronize" for e in cpu),
            copies=len(dev) - len(kernels), device_ms=device_us / 1e3,
            wall_ms=span.elapsed_us() / 1e3, device_busy_share=device_us / span.elapsed_us(),
            top=sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12])
    return out


def _log_profile(label: str, res: dict):
    log(f"[profile] {label}: " + json.dumps({k: v for k, v in res.items() if k != "top"}))
    log(f"[profile] top device operations of {label} (us total, calls, name):")
    for name, ts in res["top"]:
        log(f"[profile]   {sum(ts):10.1f} {len(ts):5d}  {name[:110]}")


def phase_profile_map_step(mapper, captured) -> dict:
    """One mapping step under torch.profiler: device kernels, host reads
    and the top device operations."""
    res = _profile_ranges([("map_step", lambda: mapper._map_step(*captured))])["map_step"]
    _log_profile("one mapping step", res)
    return res


def phase_profile_loop(lc, cap: dict, dev) -> dict:
    """The loop stages of the first loop correction under torch.profiler:
    the Sim3 chain of the closing pair (on the correction's input map),
    the correction, the essential graph (as it runs, and with the solver's
    full loop in place of its early exit) and one global-BA iteration."""
    from orbslam_mapsave_tpu_torch.optim import pose_graph
    from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod

    st, kf, mkf, args = _correction_inputs(cap, dev)
    corrected = lc._correct(st, kf, mkf, *args)
    ess = lc._essential(corrected, kf, mkf)
    job = gba_mod.GBAJob(ess, lc.cam, lc._t(dev)[1], n_iters=1)

    def sim3():
        gen = torch.Generator(device=dev)
        gen.manual_seed(kf)
        lc._sim3_chain(st, kf, mkf, generator=gen)

    def gba_iteration():
        gba_mod.global_ba.gba_iterate(lc.cam, job._tb, *job._carry)

    def essential_full_loop():
        with _patched([(pose_graph, "optimize_pose_graph",
                        pose_graph._optimize_pose_graph_full)]):
            lc._essential(corrected, kf, mkf)

    res = _profile_ranges([("sim3 chain", sim3),
                           ("correction", lambda: lc._correct(st, kf, mkf, *args)),
                           ("essential graph", lambda: lc._essential(corrected, kf, mkf)),
                           ("essential graph, full loop", essential_full_loop),
                           ("gba iteration", gba_iteration)])
    for name, r in res.items():
        _log_profile(f"loop stage '{name}'", r)
    return {k: {kk: vv for kk, vv in v.items() if kk != "top"} for k, v in res.items()}


def phase_profile_reloc(reuse: dict) -> dict:
    """One relocalization attempt of the reuse run (its first over several
    candidates) under torch.profiler: device kernels, host reads and the
    top device operations."""
    rel, (state, frame, cands, frame_id) = reuse["attempt"]
    res = _profile_ranges([("relocalization attempt",
                            lambda: rel.batch(state, frame, cands, frame_id))])
    res = res["relocalization attempt"]
    _log_profile(f"one relocalization attempt over {len(cands)} candidates", res)
    return res


def main() -> int:
    try:
        smi = phase_device()
        _record_essential_solves()
        dev = torch.device("cuda", 0)
        phase_build()
        kres = phase_kernel(dev)
        seq = bench_sequence()
        phase_slice(dev, seq)
        mres, mapper, captured = phase_mapping(dev, seq)
        phase_map_step(mapper, captured)
        with tempfile.TemporaryDirectory() as tmp:
            map_path = Path(tmp) / "map.npz"
            lres, lc, lcap = phase_loop(dev, seq, map_path)
            phase_loop_replay(lc, lcap)
            mono = phase_mono(dev, seq, lc.voc)
            st = phase_stereo(dev, seq, lc.voc)
            kid = phase_kidnap(dev, seq, lc.voc)
            reu = phase_reuse(dev, seq, lc.voc, map_path, lres["save_ms"])
            phase_cli(dev, seq, lc.voc, map_path, Path(tmp))
            apps = phase_apps(dev, seq, Path(tmp))
            endu = phase_endurance(dev, lc.voc)
            scale, sslam = phase_scale(dev, (mres["map_step_p50_ms"], mres["map_step_p99_ms"]))
            from orbslam_mapsave_tpu_torch.io import mapio

            pdir = parallel_inputs(Path(tmp), seq, lc.voc, {
                "loop": (mapio.load_map(map_path, dev), lc.cam, lc._t(dev)[1], "pcg"),
                PARALLEL_RELAID: (relaid_map(mapio.load_map(map_path, dev)), lc.cam,
                                  lc._t(dev)[1], "pcg"),
                "scale": (sslam.map, sslam.cam, sslam.builder.inv_level_sigma2, "pcg")},
                _capture_ba_window(mapper, captured), lc.cam)
            del sslam
            par = phase_parallel(pdir)
        phase_profile(dev)
        phase_profile_map_step(mapper, captured)
        phase_profile_loop(lc, lcap, dev)
        phase_profile_reloc(reu)
    except Exception as e:  # every phase failure ends here, with no result
        import traceback

        traceback.print_exc()
        log(f"[chip_smoke] FAILED: {type(e).__name__}: {e}")
        return 1
    t1 = kres["timing"][1]
    log("[chip_smoke] loop slice: " + json.dumps({k: lres[k] for k in (
        "fps", "p50_ms", "p99_ms", "max_ms", "loops", "events", "keyframes", "points",
        "kf_ate_m", "lost", "launches", "pose_optimizations", "gba_applied",
        "ba_lanes_dropped", "n_words")}))
    log("[chip_smoke] mono slice: " + json.dumps({k: mono[k] for k in (
        "fps", "p50_ms", "p99_ms", "max_ms", "bootstrap_frame", "loops", "events",
        "keyframes", "points", "kf_ate_sim3_m", "launches", "pose_optimizations",
        "gba_applied", "ba_lanes_dropped")}))
    log("[chip_smoke] stereo slice: " + json.dumps({k: st[k] for k in (
        "fps", "p50_ms", "p99_ms", "max_ms", "lost_frames", "loops", "events", "keyframes",
        "points", "kf_ate_m", "launches", "pose_optimizations", "gba_applied",
        "essential_solvers", "gba_solvers", "ba_lanes_dropped")}))
    endu, scale = _loggable(endu), _loggable(scale)
    log("[chip_smoke] endurance: " + json.dumps({k: endu[k] for k in (
        "fps", "p50_ms", "p99_ms", "max_ms", "loops", "events", "keyframes_live", "points_live",
        "kf_ate_m", "lost_stretches", "point_compactions", "keyframe_compactions",
        "ms_per_compaction", "ba_escalations", "ba_lanes_dropped", "peak_memory_bytes")}))
    log("[chip_smoke] scale: " + json.dumps({k: scale[k] for k in (
        "frames", "fps", "p50_ms", "p99_ms", "max_ms", "loops", "keyframes_live",
        "kf_alloc_watermark", "points_live", "kf_ate_m", "lost_stretches", "map_step_p50_ms",
        "map_step_p99_ms", "ba_escalations", "ba_lanes_dropped", "peak_memory_bytes")}))
    log("[chip_smoke] essential graphs per phase, [route, LM iterations] (1: the solver's "
        "early exit fired, 20: it did not): " + json.dumps(ESSENTIAL_SOLVES))
    log("[chip_smoke] parallel: " + json.dumps({
        "seconds": par["seconds"], "vs_one_process": par["vs_one_process"],
        "relaid_vs_loop": par.get("relaid_vs_loop"),
        "vs_world1": par["vs_world1"], "controls": par["controls"], "live": par["live"],
        "nccl_cards": {k: par["nccl_cards"][k] for k in ("vs_world1", "controls", "live")}
        if "nccl_cards" in par else None,
        "world1": {k: v for k, v in par["world1"].items() if k.endswith("ms_per_iter")},
        "ranks": [{k: v for k, v in r.items() if k.endswith(("ms_per_iter", "fps", "device",
                                                              "backend", "launches"))}
                  for r in par[f"world{PARALLEL_WORLD}"]]}))
    print(json.dumps({"kernels": [{
        "name": "pose_lm",
        "route": "cuda",
        "source": "orbslam_mapsave_tpu_torch/csrc/pose_lm.cu",
        "replaces": "orbslam_mapsave_tpu/optim/pose_opt_pallas.py:139",
        "launches": lres["launches"],
        "max_abs_err": kres["max_abs_err"],
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": None,
        "graph_ms": t1["graph_ms"],
        "per_iter_us": t1["per_iter_us_M2048"],
        "edge_pass_share": t1["edge_pass_share"],
        "sm_bound_ms": t1["sm_bound_ms"],
        "launches_batched": (kid["launches_batched"] + reu["launches_batched"]
                             + endu["launches_batched"] + scale["launches_batched"]),
        "launches_by_path": {"loop": lres["launches"], "mono": mono["launches"],
                             "kidnap": kid["launches"], "reuse": reu["launches"],
                             "stereo": st["launches"],
                             "apps": apps.get("run_slam", {}).get("launches"),
                             "endurance": endu["launches"], "scale": scale["launches"],
                             "parallel_kidnap_ranks": [r["kidnap_launches"] for r in
                                                       par[f"world{PARALLEL_WORLD}"]]},
        "batched_B": reu["batched_launch"]["B"],
        "batched_ms": reu["batched_launch"]["ms"],
        "batched_graph_ms": reu["batched_launch"]["graph_ms"],
        "batched_bound_ms": reu["batched_launch"]["bound_ms"],
        "batched_max_abs_err": max(reu["batched_launch"]["max_abs_err"]),
        "batched5_ms": reu["batched_launch"]["B5"]["ms"],
        "batched5_graph_ms": reu["batched_launch"]["B5"]["graph_ms"],
        "batched5_bound_ms": reu["batched_launch"]["B5"]["bound_ms"],
        "batched_err_vs_f64": reu["batched_launch"]["err_vs_f64"],
        "mono_problem_ms": kres["timing"]["mono"]["ms"],
        "mono_problem_graph_ms": kres["timing"]["mono"]["graph_ms"],
        "mono_problem_plain_ms": kres["timing"]["mono"]["plain_ms"],
        "mono_problem_bound_ms": kres["timing"]["mono"]["bound_ms"],
        "mono_problem_max_abs_err": kres["timing"]["mono"]["max_abs_err"],
        "stereo_problem_ms": kres["timing"]["stereo"]["ms"],
        "stereo_problem_graph_ms": kres["timing"]["stereo"]["graph_ms"],
        "stereo_problem_plain_ms": kres["timing"]["stereo"]["plain_ms"],
        "stereo_problem_bound_ms": kres["timing"]["stereo"]["bound_ms"],
        "stereo_problem_max_abs_err": kres["timing"]["stereo"]["max_abs_err"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of the parallel phase
        sys.exit(parallel_rank(Path(sys.argv[2]), *sys.argv[3:7]))
    sys.exit(main())
