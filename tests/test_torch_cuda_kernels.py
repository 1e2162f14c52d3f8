"""The pose-LM CUDA kernel against its plain PyTorch version, on the card;
and the card runs of PoseNet's forward and of a human-masked frame build
against the same calls on the CPU.

Needs an NVIDIA GPU with nvcc (the kernel is built from csrc/pose_lm.cu at
first use); skipped elsewhere. On the card:
    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
`chip_smoke.py` runs the same comparison at the slice's shapes.
"""

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                          make_problem)

pytestmark = pytest.mark.cuda

TOL_POSE = 1e-4  # f32 sums in another order (block tree vs torch einsum)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _plain(obs, pose0, b):
    return pose_opt.pose_optimization_ref(
        CAM, pose0[b], pose_opt.PoseObs(*[x[b] for x in obs]))


def _eye(dev, B=1):
    return torch.eye(4, device=dev).expand(B, 4, 4).contiguous()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("M", [900, 1024, 2048])
def test_kernel_matches_plain(dev, M, B):
    probs = [make_problem(M, seed=7 + b) for b in range(B)]
    obs = batch_obs(probs, dev)
    pose0 = _eye(dev, B)
    pose_k, inl_k, n_k = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    pose_k2, inl_k2, _ = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    torch.cuda.synchronize()
    assert torch.equal(pose_k, pose_k2) and torch.equal(inl_k, inl_k2)
    for b in range(B):
        p_ref, inl_ref, n_ref = _plain(obs, pose0, b)
        err = (pose_k[b] - p_ref).abs().max().item()
        assert err <= TOL_POSE, (M, B, b, err)
        assert torch.equal(inl_k[b], inl_ref)
        assert int(n_k[b]) == int(n_ref)
        assert np.abs(pose_k[b].cpu().numpy() - probs[b]["T_true"]).max() < 5e-3


@pytest.mark.parametrize("B", [1, 4])
def test_kernel_matches_plain_all_mono(dev, B):
    """Every edge mono (ur = -1), as on a monocular frame: no stereo row in
    any residual or system term."""
    probs = [make_problem(2048, seed=7 + b, stereo=0.0) for b in range(B)]
    assert all((p["ur"] < 0).all() for p in probs)
    obs = batch_obs(probs, dev)
    pose0 = _eye(dev, B)
    pose_k, inl_k, n_k = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    for b in range(B):
        p_ref, inl_ref, n_ref = _plain(obs, pose0, b)
        assert (pose_k[b] - p_ref).abs().max().item() <= TOL_POSE
        assert torch.equal(inl_k[b], inl_ref) and int(n_k[b]) == int(n_ref)
        assert np.abs(pose_k[b].cpu().numpy() - probs[b]["T_true"]).max() < 5e-3


@pytest.mark.parametrize("B", [1, 4])
def test_kernel_matches_plain_all_stereo(dev, B):
    """Every edge given its right-image coordinate, as on a stereo frame:
    the third residual row and its system terms on each edge whose ur lies
    on the image (ur >= 0, ~94% here; the rest fall off its left edge and
    count as mono, as in the reference)."""
    probs = [make_problem(2048, seed=7 + b, stereo=1.0) for b in range(B)]
    assert all((p["ur"] >= 0).mean() > 0.9 for p in probs)
    obs = batch_obs(probs, dev)
    pose0 = _eye(dev, B)
    pose_k, inl_k, n_k = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    for b in range(B):
        p_ref, inl_ref, n_ref = _plain(obs, pose0, b)
        assert (pose_k[b] - p_ref).abs().max().item() <= TOL_POSE
        assert torch.equal(inl_k[b], inl_ref) and int(n_k[b]) == int(n_ref)
        assert np.abs(pose_k[b].cpu().numpy() - probs[b]["T_true"]).max() < 5e-3


def test_all_invalid_returns_input_pose(dev):
    p = make_problem(1024, seed=3)
    p["valid"][:] = False
    obs = batch_obs([p], dev)
    pose0 = _eye(dev)
    pose, inl, n = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    assert torch.equal(pose, pose0)
    assert int(n[0]) == 0 and not bool(inl.any())


def test_all_behind_returns_input_pose(dev):
    p = make_problem(1024, seed=3)
    p["pt_w"][:, 2] *= -1.0  # every point behind the camera: H = 0
    obs = batch_obs([p], dev)
    pose0 = _eye(dev)
    pose, inl, n = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    assert torch.equal(pose, pose0)
    assert int(n[0]) == 0 and not bool(inl.any())


def test_dispatcher_launches_kernel(dev):
    obs = batch_obs([make_problem(2048)], dev)
    pose_opt_cuda.reset_launches()
    pose, inl, n = pose_opt.pose_optimization(
        CAM, torch.eye(4, device=dev), pose_opt.PoseObs(*[x[0] for x in obs]))
    torch.cuda.synchronize()
    assert pose_opt_cuda.launches == 1
    assert pose.shape == (4, 4) and inl.shape == (2048,) and int(n) > 1500


def test_wrapper_takes_poseobs_in_place(dev):
    """PoseObs straight from the caller (bool valid); a non-contiguous view
    gives exactly what its contiguous copy gives."""
    obs = batch_obs([make_problem(1024, seed=5 + b) for b in range(2)], dev)
    assert obs.valid.dtype == torch.bool
    pose0 = _eye(dev, 2)
    ref = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
    strided = pose_opt.PoseObs(
        pt_w=obs.pt_w.transpose(1, 2).contiguous().transpose(1, 2),
        uv=torch.cat([obs.uv, obs.uv], -1)[..., :2],
        ur=torch.stack([obs.ur, obs.ur], -1)[..., 0],
        inv_sigma2=torch.stack([obs.inv_sigma2] * 3, 1)[:, 1],
        valid=torch.stack([obs.valid, obs.valid], -1)[..., 1])
    assert not any(t.is_contiguous() for t in strided)
    got = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, strided)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_pose_is_orthonormal(dev):
    obs = batch_obs([make_problem(2048, seed=11 + b) for b in range(4)], dev)
    pose, _, _ = pose_opt_cuda.pose_optimization_cuda(CAM, _eye(dev, 4), obs)
    R = pose[:, :3, :3]
    eye3 = torch.eye(3, device=dev)
    assert (R.transpose(1, 2) @ R - eye3).abs().max().item() <= 1e-6
    assert torch.equal(pose[:, 3], torch.tensor([0.0, 0, 0, 1], device=dev).expand(4, 4))


def test_count_equals_inlier_sum(dev):
    obs = batch_obs([make_problem(900, seed=s) for s in (1, 2, 3)], dev)
    _, inl, n = pose_opt_cuda.pose_optimization_cuda(CAM, _eye(dev, 3), obs)
    assert n.dtype == torch.int32
    assert torch.equal(n, inl.sum(-1).to(torch.int32))


def test_wrapper_rejects_bad_inputs(dev):
    obs = batch_obs([make_problem(64)], dev)
    pose0 = _eye(dev)
    with pytest.raises(ValueError):  # not on the card
        pose_opt_cuda.pose_optimization_cuda(
            CAM, pose0.cpu(), pose_opt.PoseObs(*[x.cpu() for x in obs]))
    with pytest.raises(TypeError):  # float64 points
        pose_opt_cuda.pose_optimization_cuda(
            CAM, pose0, obs._replace(pt_w=obs.pt_w.double()))
    with pytest.raises(TypeError):  # float valid mask
        pose_opt_cuda.pose_optimization_cuda(
            CAM, pose0, obs._replace(valid=obs.valid.float()))
    with pytest.raises(ValueError):  # batch of poses != batch of edges
        pose_opt_cuda.pose_optimization_cuda(CAM, _eye(dev, 2), obs)


def test_batched_dispatcher_one_launch(dev):
    """`pose_optimization_batched` on the card: relocalization's candidate
    batch (B = 5, M = 2048) is ONE launch, counted as batched, and each
    problem matches the plain version."""
    obs = batch_obs([make_problem(2048, seed=30 + b) for b in range(5)], dev)
    pose0 = _eye(dev, 5)
    pose_opt_cuda.reset_launches()
    pose, inl, n = pose_opt.pose_optimization_batched(CAM, pose0, obs)
    torch.cuda.synchronize()
    assert (pose_opt_cuda.launches, pose_opt_cuda.launches_batched) == (1, 1)
    for b in range(5):
        p_ref, inl_ref, n_ref = _plain(obs, pose0, b)
        assert (pose[b] - p_ref).abs().max().item() <= TOL_POSE
        assert torch.equal(inl[b], inl_ref) and int(n[b]) == int(n_ref)


def test_posenet_card_forward_matches_cpu(dev):
    """PoseNet at full width (64) on the reference's 176x320 input: the
    card's forward against the CPU's, same weights, same dtypes (bf16 convs
    in both): the tolerances of `test_torch_pose_net.py`."""
    from orbslam_mapsave_tpu_torch.models import pose_net

    net = pose_net.init_params(pose_net.PoseNet(64), torch.Generator().manual_seed(0))
    img = torch.rand(176, 320, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        h_cpu = net(img[None, None] / 255.0)[0]
        k_cpu = pose_net.decode_heatmaps(h_cpu)
        net_gpu = net.to(dev)
        h_gpu = net_gpu(img.to(dev)[None, None] / 255.0)[0].cpu()
        k_gpu = pose_net.infer(net_gpu, img.to(dev)).cpu()
    assert h_gpu.dtype == torch.float32 and h_gpu.shape == (25, 44, 80)
    assert (h_gpu - h_cpu).abs().max().item() <= 0.05
    assert (k_gpu[:, :2] - k_cpu[:, :2]).abs().max().item() <= 0.5
    assert (k_gpu[:, 2] - k_cpu[:, 2]).abs().max().item() <= 1e-2


def test_masked_build_card_matches_cpu(dev):
    """FrameBuilder.build with a human mask on a 640x480 bench frame, card
    against CPU: no valid keypoint inside the mask at its level's resize on
    either, and the same keypoints and descriptors but for pyramid rounding
    ties (>= 99%)."""
    from orbslam_mapsave_tpu_torch.geometry import projection
    from orbslam_mapsave_tpu_torch.io import synthetic
    from orbslam_mapsave_tpu_torch.ops import orb
    from orbslam_mapsave_tpu_torch.pipeline import frame

    W, H = 640, 480
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1]])
    g, d = synthetic.BoxRoom(2.0, seed=11).render(K, synthetic.circle_trajectory(240)[10], W, H)
    img = np.clip(g, 0, 255).astype(np.uint8)
    mask = np.ones((H, W), np.float32)
    mask[100:400, 250:397] = 0.0
    cam = projection.Camera.create(520.0, 520.0, W / 2, H / 2, bf=41.6, width=W, height=H)
    spec = orb.ORBSpec.create(H, W, n_features=2000)
    out = []
    for device in ("cpu", dev):
        fr = frame.FrameBuilder(cam, spec, device).build(img, 0.0, d.astype(np.float16), mask)
        v = fr.valid.cpu().numpy()
        xy, octv = fr.kp_xy_raw.cpu().numpy(), fr.kp_octave.cpu().numpy()
        for lvl, ls in enumerate(spec.levels):
            m = orb.resize_mask_nearest(torch.from_numpy(mask), ls.height, ls.width).numpy()
            on = v & (octv == lvl)
            lx = np.round(xy[on, 0] / ls.scale).astype(int)
            ly = np.round(xy[on, 1] / ls.scale).astype(int)
            assert (m[ly, lx] > 0).all(), (str(device), lvl)
        keys = {(float(a), float(b), int(o)): bytes(ds) for (a, b), o, ds in
                zip(xy[v], octv[v], fr.desc.cpu().numpy()[v])}
        out.append(keys)
    common = out[0].keys() & out[1].keys()
    assert len(common) >= 0.99 * max(len(out[0]), len(out[1]))
    assert np.mean([out[0][k] == out[1][k] for k in common]) >= 0.99
