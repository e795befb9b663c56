"""The port's S^3 samplers ("kepler", "newton" and their dispatch) against
the JAX package's ops/sampler.py and the oracle's literal do-while.

Mirrors tests/test_sampler.py's newton and kepler cases. w must match
JAX's within 1e-6 absolute: kepler everywhere, newton for v in [0.001,
0.999]. Toward v = 0 or 1 the CDF's slope goes to 0 and newton's one-sided
finite difference (step 3e-4) amplifies the ulp differences of the two
libraries' acos into w (up to 4e-5 at v = 1e-6): there the port is held to
the oracle's bound instead (2 * SMALL_FLOAT, test_oracle.py), as JAX is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from oracle import frag as ofrag

from fourd_ray_tracing_tpu.ops import sampler as jsampler

from fourd_ray_tracing_tpu_torch.ops import sampler as tsampler

W_ATOL = 1e-6
SMALL = 3e-4


def both(name, v, **kw):
    """(port, JAX) of sampler function ``name`` at float32 ``v``."""
    out = getattr(tsampler, name)(torch.from_numpy(v), **kw).numpy()
    ref = np.asarray(getattr(jsampler, name)(jnp.asarray(v), **kw))
    return out, ref


def test_volume_by_w_matches_jax():
    w = np.linspace(-1.0, 1.0, 1001, dtype=np.float32)
    out, ref = both("volume_by_w", w)
    assert np.abs(out - ref).max() <= W_ATOL
    assert abs(out[0]) < 1e-5 and abs(out[-1] - 1.0) < 1e-5
    assert (np.diff(out) >= -1e-6).all()


def test_newton_matches_jax_and_inverts_the_cdf():
    v = np.linspace(0.001, 0.999, 997, dtype=np.float32)
    out, ref = both("w_by_volume_newton", v)
    assert np.abs(out - ref).max() <= W_ATOL
    v_back = tsampler.volume_by_w(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(v_back, v, atol=5e-4)


def test_newton_at_the_ends_within_the_oracles_bound():
    v = np.concatenate([np.linspace(0.0, 0.001, 200), np.linspace(0.999, 0.999999, 200)])
    out, ref = both("w_by_volume_newton", v.astype(np.float32))
    assert np.abs(out - ref).max() < 2 * SMALL


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("lo,hi,n", [(0.0, 0.999999, 4001), (1e-6, 1 - 1e-6, 9973)])
def test_kepler_matches_jax(lo, hi, n, iters):
    out, ref = both("w_by_volume_kepler", np.linspace(lo, hi, n, dtype=np.float32), iters=iters)
    assert np.abs(out - ref).max() <= W_ATOL


def test_kepler_matches_newton_and_inverts_the_cdf_tightly():
    v = torch.from_numpy(np.linspace(0.0, 0.999999, 4001, dtype=np.float32))
    w_newton = tsampler.w_by_volume_newton(v).numpy()
    w_kepler = tsampler.w_by_volume_kepler(v).numpy()
    assert np.abs(w_kepler - w_newton).max() < 5e-4
    v = np.linspace(1e-6, 1 - 1e-6, 9973, dtype=np.float32)
    v_back = tsampler.volume_by_w(tsampler.w_by_volume_kepler(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(v_back, v, atol=2e-5)


def test_newton_sampler_vs_oracle():
    """The oracle's literal do-while (test_oracle.py's bound: an ulp of a
    transcendental may flip one trip count)."""
    v = np.linspace(0.001, 0.999, 199, dtype=np.float32)
    got = tsampler.w_by_volume_newton(torch.from_numpy(v)).numpy()
    want = np.array([ofrag.w_by_volume(np.float32(x)) for x in v], np.float32)
    assert np.abs(got - want).max() < 2 * SMALL


def test_newton_is_a_do_while_per_lane():
    """Every lane takes at least one step and stops at its own first
    |dw| < SMALL_FLOAT, whatever the other lanes do: a batch is bitwise
    its lanes alone; a cap of one step is the first step's formula."""
    v = torch.from_numpy(np.array([0.5, 0.001, 0.3, 0.999, 0.75], np.float32))
    batch = tsampler.w_by_volume_newton(v)
    for k in range(v.numel()):
        assert torch.equal(tsampler.w_by_volume_newton(v[k:k + 1]), batch[k:k + 1])
    one = tsampler.w_by_volume_newton(v, max_iters=1)
    zero = torch.zeros_like(v)
    df = tsampler.volume_by_w(zero + tsampler.SMALL_FLOAT) - tsampler.volume_by_w(zero)
    step = zero - torch.tensor(tsampler.SMALL_FLOAT) / df * (tsampler.volume_by_w(zero) - v)
    assert torch.equal(one, step)
    assert batch[0] == 0.0  # v = 1/2: the first step is 0, so the loop stops there


@pytest.mark.parametrize("method", ["kepler", "newton"])
def test_directions_match_jax(method, rng_np):
    """direction_from_uniforms: kepler within 1e-6 of JAX everywhere;
    newton (exact sin and cos of 2 pi u_fi) within 1e-5 where u_w lies in
    [0.001, 0.999] (its w within 1e-6 there grows by up to |w| / r in the
    hat-box radius r = sqrt(1 - w^2)); unit vectors."""
    u = rng_np.random((3, 4000)).astype(np.float32)
    out = tsampler.direction_from_uniforms(*map(torch.from_numpy, u), method=method)
    ref = jsampler.direction_from_uniforms(*map(jnp.asarray, u), method=method)
    inner = (u[0] >= 0.001) & (u[0] <= 0.999)
    for a, b in zip(out, ref):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff[inner].max() <= (10 * W_ATOL if method == "newton" else W_ATOL)
        assert diff.max() < 2 * SMALL
    vecs = np.stack([c.numpy() for c in out], axis=-1)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("method", ["kepler", "newton"])
def test_w_marginal_distribution(method, rng_np):
    """KS test of the w marginal against the density (2/pi) sqrt(1 - w^2)."""
    u = torch.from_numpy(rng_np.random(20000).astype(np.float32))
    w = (tsampler.w_by_volume_kepler(u) if method == "kepler"
         else tsampler.w_by_volume_newton(u)).numpy()
    cdf = lambda x: (x * np.sqrt(1 - x**2) - np.arccos(x)) / np.pi + 1  # noqa: E731
    assert stats.kstest(w, cdf).pvalue > 0.01
