import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.utils import se3


def rand_xi(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.randn(6).astype(np.float32) * scale)


def test_so3_exp_identity():
    R = se3.so3_exp(jnp.zeros(3))
    np.testing.assert_allclose(R, np.eye(3), atol=1e-6)


def test_so3_exp_quarter_turn():
    R = se3.so3_exp(jnp.array([0.0, 0.0, np.pi / 2], dtype=jnp.float32))
    expected = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    np.testing.assert_allclose(R, expected, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_se3_exp_log_roundtrip(seed):
    xi = rand_xi(seed, 0.5)
    T = se3.se3_exp(xi)
    xi2 = se3.se3_log(T)
    np.testing.assert_allclose(xi, xi2, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_se3_exp_small_angle(seed):
    xi = rand_xi(seed, 1e-6)
    T = se3.se3_exp(xi)
    # near identity: T ~ I + hat-form
    np.testing.assert_allclose(T[:3, 3], xi[:3], atol=1e-8)
    assert np.all(np.isfinite(np.asarray(T)))


def test_se3_exp_is_rigid():
    T = se3.se3_exp(rand_xi(7))
    R = np.asarray(T[:3, :3])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_mat_inverse():
    T = se3.se3_exp(rand_xi(11))
    np.testing.assert_allclose(se3.mat_inverse(T) @ T, np.eye(4), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quat_roundtrip(seed):
    T = se3.se3_exp(rand_xi(seed))
    R = T[:3, :3]
    q = se3.rot_to_quat(R)
    R2 = se3.quat_to_rot(q)
    np.testing.assert_allclose(R, R2, atol=1e-5)
    np.testing.assert_allclose(jnp.linalg.norm(q), 1.0, atol=1e-5)


def test_exp_grad_finite():
    g = jax.grad(lambda xi: jnp.sum(se3.se3_exp(xi)))(jnp.zeros(6))
    assert np.all(np.isfinite(np.asarray(g)))


def test_transform_points():
    T = se3.se3_exp(rand_xi(3))
    pts = jnp.asarray(np.random.RandomState(0).randn(10, 3).astype(np.float32))
    out = se3.transform_points(T, pts)
    expected = pts @ np.asarray(T[:3, :3]).T + np.asarray(T[:3, 3])
    np.testing.assert_allclose(out, expected, atol=1e-5)
