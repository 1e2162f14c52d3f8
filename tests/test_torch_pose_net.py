"""Parity: the port's PoseNet (`models/pose_net.py`) against the JAX
package's flax PoseNet on the CPU, from the same flax-initialized weights
(converted with `interop.pose_net_params_from_flax`).

Tolerances, and the gaps measured when they were set:
- forward heatmaps: max-abs <= 0.05 (measured 0.022 at width 32 on 96x96,
  0.0077 at width 16 on 50x70; heatmaps reach ~2.5). Both run the
  ConvBlock and context convolutions in bfloat16: XLA's CPU convolution and
  oneDNN's accumulate in other orders and XLA may keep excess precision,
  so bf16 outputs round apart by an ulp here and there. With every
  convolution in float32 the two nets agree within 6e-6 (the structure,
  padding and layout are the same);
- decoded joints within 0.5 px (measured 0.17 and 0.04), confidences
  within 1e-2 (measured 0.0025 and 0.0009);
- `gaussian_targets` on the same inputs: 1e-5; `decode_heatmaps`: 1e-5
  plus 2 float32 ulps of the pixel coordinate;
- one Adam step on one batch: the loss within 1e-3 relative; see
  `test_one_adam_step` for the parameters;
- weight files: exact, in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orbslam_mapsave_tpu.models import pose_net as jpn
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.models import pose_net as tpn
from orbslam_mapsave_tpu_torch.models import pose_synth

torch.set_num_threads(2)
HM_TOL = 0.05
JOINT_TOL = 0.5
CONF_TOL = 1e-2
CASES = [(96, 96, 32), (50, 70, 16)]


def _flat(params) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _pair(h, w, width, seed=0):
    net, params = jpn.init_params(jax.random.PRNGKey(seed), h, w, width)
    tnet = tpn.PoseNet(width)
    tnet.load_state_dict(interop.pose_net_params_from_flax(_flat(params)))
    return net, params, tnet


@pytest.fixture(scope="module", params=CASES, ids=["96x96-w32", "50x70-w16"])
def fwd(request):
    h, w, width = request.param
    net, params, tnet = _pair(h, w, width)
    img = np.random.default_rng(1).uniform(0, 255, (h, w)).astype(np.float32)
    hj = np.asarray(jax.jit(net.apply)(params, jnp.asarray(img / 255.0)[None, :, :, None]))[0]
    kj = np.asarray(jpn._infer(net, params, jnp.asarray(img)))
    with torch.no_grad():
        ht = tnet(torch.from_numpy(img / 255.0).float()[None, None])[0].numpy()
    kt = tpn.infer(tnet, torch.from_numpy(img)).numpy()
    return dict(hj=hj, ht=ht, kj=kj, kt=kt, shape=(h, w))


def test_forward_heatmaps(fwd):
    h, w = fwd["shape"]
    hj, ht = fwd["hj"], fwd["ht"].transpose(1, 2, 0)
    # "SAME" padding rounds up: ceil(ceil(h / 2) / 2)
    assert hj.shape == ht.shape == (-(-(-(-h // 2)) // 2), -(-(-(-w // 2)) // 2), 25)
    assert fwd["ht"].dtype == np.float32
    assert np.abs(hj - ht).max() <= HM_TOL, np.abs(hj - ht).max()


def test_forward_decoded_joints(fwd):
    kj, kt = fwd["kj"], fwd["kt"]
    assert kt.shape == (25, 3)
    assert np.abs(kj[:, :2] - kt[:, :2]).max() <= JOINT_TOL
    assert np.abs(kj[:, 2] - kt[:, 2]).max() <= CONF_TOL


def test_same_pads_match_lax():
    from jax import lax

    for size in (96, 95, 50, 25, 70, 35, 176, 320, 88, 160, 7):
        for k, s, d in ((3, 2, 1), (3, 1, 1), (3, 1, 2), (1, 1, 1)):
            ref = lax.padtype_to_pads((size,), ((k - 1) * d + 1,), (s,), "SAME")[0]
            assert tpn.same_pads(size, k, s, d) == tuple(ref), (size, k, s, d)


def test_gaussian_targets_and_decode():
    rng = np.random.default_rng(3)
    joints = rng.uniform(0, 96, (2, 25, 2)).astype(np.float32)
    gj = np.asarray(jpn.gaussian_targets(jnp.asarray(joints), 24, 20))
    gt = tpn.gaussian_targets(torch.from_numpy(joints), 24, 20).numpy()
    assert np.abs(gj - gt.transpose(0, 2, 3, 1)).max() <= 1e-5
    hm = rng.normal(0, 1.5, (24, 20, 25)).astype(np.float32)
    dj = np.asarray(jpn.decode_heatmaps(jnp.asarray(hm)))
    dt = tpn.decode_heatmaps(torch.from_numpy(hm.transpose(2, 0, 1).copy())).numpy()
    # pixel coordinates up to ~80: 1e-5 plus 2 float32 ulps there (measured
    # 1.5e-5 = 2 ulps at 57 px, from the softmax sums' order)
    np.testing.assert_allclose(dt, dj, rtol=2.5e-7, atol=1e-5)


def test_one_adam_step():
    """The flax init, one batch of `render_batch`, one optax.adam(2e-3)
    step against one `tpn.train_step` with `tpn.adam(2e-3)`. The first
    Adam step moves each weight by lr * g / (|g| + eps): +-lr wherever |g|
    dwarfs eps, whatever g's size, so a gradient whose bf16 rounding flips
    its sign moves the weight the other way. Measured: the loss 9.6e-7
    apart (relative), 99.86% of the 45,257 weights within 1e-6 of JAX's, 55
    of the rest 2 lr apart (sign flips). Held: the loss within 1e-3
    relative, every weight within 2 lr + 1e-6, >= 99% within 1e-6."""
    h = w = 64
    lr = 2e-3
    net, params, tnet = _pair(h, w, 16, seed=2)
    imgs, joints = pose_synth.render_batch(np.random.default_rng(0), 4, h, w)
    opt = optax.adam(lr)

    def loss_fn(p):
        hm = net.apply(p, jnp.asarray(imgs)[..., None] / 255.0)
        tgt = jpn.gaussian_targets(jnp.asarray(joints), hm.shape[1], hm.shape[2])
        return jnp.mean((jax.nn.sigmoid(hm * 4.0) - tgt) ** 2) * 100.0

    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    upd, _ = opt.update(g, opt.init(params))
    after_j = interop.pose_net_params_from_flax(_flat(optax.apply_updates(params, upd)))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    loss_t = tpn.train_step(tnet, tpn.adam(tnet, lr), torch.from_numpy(imgs),
                            torch.from_numpy(joints))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    diffs = np.concatenate([(tnet.state_dict()[k] - after_j[k]).abs().reshape(-1).numpy()
                            for k in after_j])
    moved = np.concatenate([(tnet.state_dict()[k] - before[k]).abs().reshape(-1).numpy()
                            for k in after_j])
    assert moved.max() <= lr + 1e-6 and moved.max() > 0.5 * lr
    assert diffs.max() <= 2 * lr + 1e-6
    assert (diffs <= 1e-6).mean() >= 0.99, (diffs <= 1e-6).mean()


def test_weight_files_load_in_both_packages(tmp_path):
    """A file `save_params` writes in either package loads in the other with
    the same weights, and the port's forward of it is unchanged."""
    net, params, tnet = _pair(96, 96, 16, seed=4)
    jpn.save_params(tmp_path / "j.npz", params, 96, 96, 16)
    tnet2, hw = tpn.load_params(tmp_path / "j.npz", device="cpu")
    assert hw == (96, 96) and tnet2.width == 16
    for k, v in tnet.state_dict().items():
        assert torch.equal(tnet2.state_dict()[k], v), k
    tpn.save_params(tmp_path / "t.npz", tnet2, 96, 96)
    _, params2, hw2 = jpn.load_params(tmp_path / "t.npz")
    assert hw2 == (96, 96)
    f1, f2 = _flat(params), _flat(params2)
    assert f1.keys() == f2.keys()
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k])
    x = torch.rand(1, 1, 96, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(tnet(x), tnet2(x))
    assert tpn.make_pretrained_backbone(tmp_path / "absent.npz", device="cpu") is None
    kp = tpn.make_pretrained_backbone(tmp_path / "t.npz", device="cpu")(
        np.zeros((96, 96), np.uint8))
    assert isinstance(kp, np.ndarray) and kp.shape == (25, 3)


def test_init_follows_flax_initializers():
    """LeCun-normal kernels truncated at 2 sigma (so the std of a wide
    kernel is sqrt(1 / fan_in)), zero biases, unit GroupNorm scales."""
    net = tpn.init_params(tpn.PoseNet(32), torch.Generator().manual_seed(0))
    w = net.blocks[3].conv.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert float(net.head.bias.abs().max()) == 0.0
    assert torch.equal(net.blocks[0].norm.weight, torch.ones(32))
    a = tpn.init_params(tpn.PoseNet(16), torch.Generator().manual_seed(7)).state_dict()
    b = tpn.init_params(tpn.PoseNet(16), torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
