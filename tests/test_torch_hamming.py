"""Parity: the port's Hamming primitives against the JAX package. Distances
are exact integers, so every result must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.ops import hamming as jh
from orbslam_mapsave_tpu_torch.ops import hamming as th

torch.set_num_threads(2)


def _descs(seed, na=300, nb=200):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (na, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    # near-duplicates so that best/second-best and ties are exercised
    b[:100] = a[:100] ^ (rng.random((100, 32)) < 0.05).astype(np.uint8)
    b[100:110] = b[90:100]
    return a, b


def test_unpack_pack_and_hamming_matrix():
    a, b = _descs(0)
    np.testing.assert_array_equal(np.asarray(jh.unpack_bits(jnp.asarray(a))),
                                  th.unpack_bits(torch.from_numpy(a)).numpy())
    bits = th.unpack_bits(torch.from_numpy(a))
    np.testing.assert_array_equal(th.pack_bits(bits).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b))),
        th.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jh.hamming_vec(jnp.asarray(a[:200]), jnp.asarray(b))),
        th.hamming_vec(torch.from_numpy(a[:200]), torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("masks", ["none", "valid_b", "extra", "both"])
def test_masked_best2(masks):
    a, b = _descs(1)
    rng = np.random.default_rng(2)
    d = np.array(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    vb = rng.random(b.shape[0]) < 0.8 if masks in ("valid_b", "both") else None
    ex = rng.random(d.shape) < 0.3 if masks in ("extra", "both") else None
    ja = jh.masked_best2(jnp.asarray(d), None if vb is None else jnp.asarray(vb),
                         None if ex is None else jnp.asarray(ex))
    ta = th.masked_best2(torch.from_numpy(d),
                         None if vb is None else torch.from_numpy(vb),
                         None if ex is None else torch.from_numpy(ex))
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_mutual_best():
    a, b = _descs(3)
    rng = np.random.default_rng(4)
    d = np.array(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    va, vb = rng.random(a.shape[0]) < 0.9, rng.random(b.shape[0]) < 0.9
    ja = jh.mutual_best(jnp.asarray(d), jnp.asarray(va), jnp.asarray(vb))
    ta = th.mutual_best(torch.from_numpy(d), torch.from_numpy(va),
                        torch.from_numpy(vb))
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_rotation_consistency_mask(seed):
    rng = np.random.default_rng(seed)
    n = 500
    ang_a = rng.uniform(0, 360, n).astype(np.float32)
    # a dominant rotation plus spread, and some exact bin edges
    rot = np.where(rng.random(n) < 0.7, 12.0, rng.uniform(0, 360, n))
    ang_b = np.mod(ang_a - rot, 360).astype(np.float32)
    ang_b[:20] = np.mod(ang_a[:20] - 15.0, 360)  # rot/30 = 0.5: round-half-even
    ok = rng.random(n) < 0.85
    np.testing.assert_array_equal(
        np.asarray(jh.rotation_consistency_mask(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(ok))),
        th.rotation_consistency_mask(torch.from_numpy(ang_a),
                                     torch.from_numpy(ang_b),
                                     torch.from_numpy(ok)).numpy())
