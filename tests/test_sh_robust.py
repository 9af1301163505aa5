import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgradientsdf.utils import robust, sh


def test_sh1_basis():
    n = jnp.array([0.1, -0.2, 0.3])
    b = sh.sh_basis(n, 1)
    np.testing.assert_allclose(b, [1.0, 0.1, -0.2, 0.3], atol=1e-6)


def test_sh2_basis():
    n = jnp.array([0.1, -0.2, 0.3])
    b = sh.sh_basis(n, 2)
    expected = [
        1.0, 0.1, -0.2, 0.3,
        0.1 * -0.2, 0.1 * 0.3, -0.2 * 0.3,
        0.1 ** 2 - 0.2 ** 2, 0.1 ** 2 - 0.3 ** 2,
    ]
    np.testing.assert_allclose(b, expected, atol=1e-6)


@pytest.mark.parametrize("order", [1, 2])
def test_dsh_matches_autodiff(order):
    n = jnp.array([0.3, -0.5, 0.8])
    J = jax.jacfwd(lambda v: sh.sh_basis(v, order))(n)  # [B,3]
    np.testing.assert_allclose(sh.dsh_dn(n, order), J.T, atol=1e-5)


@pytest.mark.parametrize(
    "loss", [robust.L2, robust.CAUCHY, robust.HUBER, robust.TUKEY, robust.TRUNC_L2]
)
def test_weight_and_loss_shapes(loss):
    r = jnp.linspace(-2, 2, 11)
    w = robust.irls_weight(r, loss, 0.5)
    v = robust.loss_value(r, loss, 0.5)
    assert w.shape == r.shape and v.shape == r.shape
    assert np.all(np.asarray(w) >= 0)
    assert np.all(np.isfinite(np.asarray(v)))


def test_cauchy_matches_reference_formula():
    r = jnp.array([0.1, -0.4, 1.0])
    lam = 0.2
    np.testing.assert_allclose(
        robust.irls_weight(r, robust.CAUCHY, lam), 1.0 / (1.0 + (r / lam) ** 2), atol=1e-6
    )
    np.testing.assert_allclose(
        robust.loss_value(r, robust.CAUCHY, lam), np.log(1.0 + (np.asarray(r) / lam) ** 2), atol=1e-6
    )


def test_irls_weight_consistency():
    """IRLS fixed point: w(r) ~= rho'(r)/r for smooth losses (Cauchy: up to
    the lambda^2/... scale the reference folds into the weight)."""
    lam = 0.5
    r = jnp.array([0.3])
    # huber inside quadratic region: w=1, rho=r^2/2, rho'/r = 1
    np.testing.assert_allclose(robust.irls_weight(r, robust.HUBER, lam), 1.0)
    # huber outside: w=lam/|r|, rho' = lam*sign(r)
    r2 = jnp.array([2.0])
    np.testing.assert_allclose(robust.irls_weight(r2, robust.HUBER, lam), lam / 2.0)


def test_loss_from_name():
    assert robust.loss_from_name("tukey") == robust.TUKEY
    assert robust.loss_from_name("trunc_l2") == robust.TRUNC_L2
    with pytest.raises(ValueError):
        robust.loss_from_name("nope")
