"""The port's Dichotomized-Gaussian fit and sampler and ``ar1_filter``
against the JAX package's on the same numpy inputs (mirror of
``tests/test_dg.py``).

Bounds:
- Phi2 against JAX's float64 quadrature: 1e-12 absolute (the same 64-node
  rule in both; the sums run in another order), against scipy 1e-8 as
  ``test_dg.py`` holds JAX's;
- the fitted correlation matrix against ``_solve_pair_correlations``: 1e-9
  absolute (60 bisection trips leave a bracket of 2e-18; a pair whose
  ``|f|`` freezes under 1e-10 at another trip would move by more, and
  none does on these inputs);
- ``gauss_mean`` against ``jax.scipy.special.ndtri`` in float64: 1e-12;
- ``DichotGauss.sample`` on the same ``eps``: equal element for element
  (0/1 outputs; the float32 products may round differently only within
  1e-6 of the threshold, and no element of these seeded draws sits there);
- ``ar1_filter``: 1e-5 absolute on calcium of at most ~7 (measured 1.4e-6
  at 20,000 frames: the port's scan and ``lax.associative_scan`` combine in
  different trees), exact for T <= 2.
Each bound fails on a planted fault (the last tests of each section).
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

from calciumgan_tpu.ops import dg as jdg
from calciumgan_tpu.ops.oasis import ar1_filter as _jax_ar1_filter
from calciumgan_tpu_torch.ops import dg
from calciumgan_tpu_torch.ops.oasis import ar1_filter

torch.set_num_threads(1)

# jitted: its scan dispatches hundreds of small operations otherwise
jax_ar1_filter = jax.jit(_jax_ar1_filter, static_argnums=(1, 2))

CDF_TOL = 1e-12
FIT_TOL = 1e-9
AR_TOL = 1e-5


def _scipy_bivar_cdf(h, k, rho):
    cov = np.array([[1.0, rho], [rho, 1.0]])
    return st.multivariate_normal(mean=[0.0, 0.0], cov=cov).cdf([h, k])


# ---------------------------------------------------------------------------
# bivariate CDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,k,rho", [
    (0.0, 0.0, 0.5), (0.3, -0.7, 0.2), (-1.2, 0.4, 0.9),
    (1.0, 1.0, -0.6), (0.5, 0.5, 0.0), (-0.3, -0.3, -0.95),
])
def test_bivar_gauss_cdf_matches_scipy(h, k, rho):
    ours = dg.bivar_gauss_cdf(h, k, rho)
    assert ours.dtype == torch.float64
    assert float(ours) == pytest.approx(_scipy_bivar_cdf(h, k, rho), abs=1e-8)


def test_bivar_gauss_cdf_matches_jax_and_is_float64():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(40, 7))
    k = rng.normal(size=(40, 7))
    rho = rng.uniform(-0.99999, 0.99999, size=(40, 1))
    ours = dg.bivar_gauss_cdf(h, k, rho)
    assert ours.dtype == torch.float64 and ours.shape == (40, 7)
    # float32 inputs are widened, not computed in float32
    assert dg.bivar_gauss_cdf(torch.tensor(0.3), torch.tensor(-0.7),
                              torch.tensor(0.2)).dtype == torch.float64
    with jax.enable_x64(True):
        theirs = np.asarray(jdg.bivar_gauss_cdf(h, k, rho))
    assert theirs.dtype == np.float64
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=CDF_TOL)
    # planted fault: a 32-node rule is outside the bound
    nodes, weights = np.polynomial.legendre.leggauss(32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dg, "_GL_NODES", nodes)
        mp.setattr(dg, "_GL_WEIGHTS", weights)
        coarse = dg.bivar_gauss_cdf(h, k, rho).numpy()
    assert np.abs(coarse - theirs).max() > 10 * CDF_TOL


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def test_tril_indices_order_equals_jax():
    for n in (2, 6, 13):
        iu, ju = torch.tril_indices(n, n, -1)
        ji, jj = jnp.tril_indices(n, -1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jj))


def _binary(rng, timebins, trials, n=6):
    """Correlated binary data with one uncorrelated pair."""
    probs = np.array([0.2, 0.5, 0.35, 0.1, 0.6, 0.3])[:n]
    shared = rng.uniform(size=(timebins, trials, 1))
    own = rng.uniform(size=(timebins, trials, n))
    u = np.where(rng.uniform(size=(timebins, trials, n)) < 0.4, shared, own)
    return (u < probs).astype(np.float64)


def _fit_inputs(rng, timebins, trials):
    spikes = _binary(rng, timebins, trials)
    opt = dg.DGOptimise(spikes)
    covar = (opt.data_tvar_covariance if timebins > 1
             else opt.data_tfix_covariance).copy()
    # a pair with |Sigma| <= 1e-10 (set to 0 by the last rule) and a pair
    # no latent correlation can reach (f(lo) f(hi) > tol: 0 by the third)
    covar[3, 1] = covar[1, 3] = 5e-11
    covar[4, 2] = covar[2, 4] = 0.9
    return (np.atleast_2d(opt.gauss_mean), spikes.mean(1).mean(0), covar)


@pytest.mark.parametrize("timebins,trials", [(1, 4000), (40, 120)])
def test_pair_correlations_match_jax(timebins, trials):
    gm, dm, covar = _fit_inputs(np.random.default_rng(timebins), timebins,
                                trials)
    ours = dg._solve_pair_correlations(gm, dm, covar, device="cpu")
    assert ours.dtype == torch.float64
    with jax.enable_x64(True):
        theirs = np.asarray(jdg._solve_pair_correlations(
            jnp.asarray(gm), jnp.asarray(dm), jnp.asarray(covar)))
    ours = ours.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FIT_TOL)
    assert ours[3, 1] == 0.0 and ours[4, 2] == 0.0
    assert np.abs(ours[np.tril_indices(6, -1)]).max() > 0.05
    np.testing.assert_array_equal(np.diag(ours), 1.0)
    np.testing.assert_array_equal(ours, ours.T)


def test_pair_correlation_edge_rules_in_order():
    # f(lo) within tol of 0: the root is the bracket's low end
    gm = np.zeros((1, 2))
    dm = np.array([0.5, 0.5])
    with jax.enable_x64(True):
        f_lo = float(jdg.bivar_gauss_cdf(0.0, 0.0, -0.99999)) - 0.25
    covar = np.array([[0.25, f_lo], [f_lo, 0.25]])
    ours = dg._solve_pair_correlations(gm, dm, covar, device="cpu").numpy()
    with jax.enable_x64(True):
        theirs = np.asarray(jdg._solve_pair_correlations(
            jnp.asarray(gm), jnp.asarray(dm), jnp.asarray(covar)))
    assert ours[1, 0] == theirs[1, 0] == -0.99999


def test_fit_bound_fails_on_fewer_trips():
    # planted fault: 25 trips leave a bracket of 6e-8, outside the bound
    gm, dm, covar = _fit_inputs(np.random.default_rng(1), 1, 4000)
    full = dg._solve_pair_correlations(gm, dm, covar, device="cpu")
    short = dg._solve_pair_correlations(gm, dm, covar, maxiters=25,
                                        device="cpu")
    assert float((full - short).abs().max()) > 2 * FIT_TOL


def test_get_gauss_correlation_matches_jax():
    spikes = _binary(np.random.default_rng(5), 1, 3000)
    ours = dg.DGOptimise(spikes).get_gauss_correlation(device="cpu")
    theirs = jdg.DGOptimise(spikes).get_gauss_correlation()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FIT_TOL)


def test_gauss_mean_with_silent_and_saturated_neurons():
    rng = np.random.default_rng(2)
    spikes = (rng.uniform(size=(4, 300, 4)) < 0.3).astype(np.float64)
    spikes[..., 0] = 0.0   # never fires: clamped to 1e-4
    spikes[..., 3] = 1.0   # always fires: clamped to 1 - 1e-4
    ours = dg.DGOptimise(spikes).gauss_mean
    theirs = jdg.DGOptimise(spikes).gauss_mean
    assert ours.dtype == np.float64 and ours.shape == (4, 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        ours, st.norm.ppf(np.clip(spikes.mean(1), 1e-4, 1 - 1e-4)),
        atol=1e-9)
    assert np.isfinite(ours).all()
    with pytest.raises(ValueError, match="between 0 and 1"):
        dg.DGOptimise(spikes * 2.0).gauss_mean


@pytest.mark.parametrize("shape", [(1, 400, 3), (50, 8, 3)])
def test_covariance_forms_equal_jax(shape):
    spikes = (np.random.default_rng(3).uniform(size=shape) < 0.4).astype(
        np.float64)
    ours, theirs = dg.DGOptimise(spikes), jdg.DGOptimise(spikes)
    np.testing.assert_array_equal(ours.data_tfix_covariance,
                                  theirs.data_tfix_covariance)
    np.testing.assert_array_equal(ours.data_tvar_covariance,
                                  theirs.data_tvar_covariance)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_heaviside():
    x = np.array([-1.0, 0.0, 1e-9, 2.0])
    out = dg.heaviside(x)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jdg.heaviside(x)))
    np.testing.assert_array_equal(dg.heaviside(x, 1.0).numpy(),
                                  [0.0, 0.0, 0.0, 1.0])


def _jax_sample_with(sampler, eps, **kw):
    """The JAX sampler on given normals (its ``jax.random.normal`` call
    stands in for the draw)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype: jnp.asarray(eps, dtype))
        return np.asarray(sampler.sample(jax.random.PRNGKey(0), **kw))


def test_sample_equals_jax_on_the_same_eps():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(5, 4)) * 0.5
    A = rng.normal(size=(4, 4))
    corr = jdg.cov_to_corr(A @ A.T + 4 * np.eye(4))
    eps = rng.standard_normal((300, 5, 4)).astype(np.float32)
    ours = dg.DichotGauss(4, mean=mean, corr=corr).sample(
        eps=torch.from_numpy(eps))
    theirs = _jax_sample_with(jdg.DichotGauss(4, mean=mean, corr=corr), eps,
                              repeats=300)
    assert ours.dtype == torch.float32 and ours.shape == (5, 300, 4)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert 0.2 < float(ours.mean()) < 0.8
    # planted fault: the untransposed Cholesky factor flips elements
    wrong = dg.DichotGauss(4, mean=mean, corr=corr)
    wrong._chol = wrong._chol.T.copy()
    assert (wrong.sample(eps=torch.from_numpy(eps)).numpy() != theirs).any()
    with pytest.raises(ValueError, match="eps of shape"):
        dg.DichotGauss(4, mean=mean, corr=corr).sample(
            eps=torch.zeros(300, 4, 4))


def test_sample_with_non_pd_corr_and_make_pd_equals_jax():
    corr = np.array([[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]])
    with pytest.warns(dg.WarningDG):
        ours = dg.DichotGauss(3, corr=corr, make_pd=True)
    with pytest.warns(jdg.WarningDG):
        theirs = jdg.DichotGauss(3, corr=corr, make_pd=True)
    assert ours.projected
    np.testing.assert_array_equal(ours.corr, theirs.corr)
    eps = np.random.default_rng(6).standard_normal((100, 1, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        ours.sample(eps=torch.from_numpy(eps)).numpy(),
        _jax_sample_with(theirs, eps, repeats=100))
    # without make_pd the port refuses as the JAX package does
    for module in (dg, jdg):
        with pytest.warns(module.WarningDG), pytest.raises(
                NotImplementedError):
            module.DichotGauss(3).sample(
                **({"eps": torch.from_numpy(eps)} if module is dg else {}),
                corr=corr)


def test_silent_neuron_sends_the_sampler_through_higham():
    # a neuron that never fires: a zero row in the fixed-rate covariance
    rng = np.random.default_rng(7)
    spikes = (rng.uniform(size=(1, 500, 4)) < 0.4).astype(np.float64)
    spikes[..., 2] = 0.0
    opt = dg.DGOptimise(spikes)
    covar = opt.data_tfix_covariance
    assert not dg.is_positive_definite(covar)
    with pytest.warns(dg.WarningDG):
        ours = dg.DichotGauss(4, mean=opt.gauss_mean, corr=covar,
                              make_pd=True)
    with pytest.warns(jdg.WarningDG):
        theirs = jdg.DichotGauss(4, mean=jdg.DGOptimise(spikes).gauss_mean,
                                 corr=covar, make_pd=True)
    assert ours.projected
    np.testing.assert_array_equal(ours.corr, theirs.corr)
    eps = rng.standard_normal((200, 1, 4)).astype(np.float32)
    out = ours.sample(eps=torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(out, _jax_sample_with(theirs, eps,
                                                        repeats=200))


def test_sample_pins_full_float32_whatever_the_tf32_switch(monkeypatch):
    seen = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: (
        seen.append(torch.backends.cuda.matmul.allow_tf32), real(a, b))[1])
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dg.DichotGauss(2).sample(eps=torch.zeros(3, 1, 2))
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def test_sampler_moments():
    mean = np.array([[0.5, -0.5]])
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])
    sampler = dg.DichotGauss(2, mean=mean, corr=corr)
    gen = torch.Generator().manual_seed(0)
    out = sampler.sample(gen, repeats=200_000).numpy()
    assert out.shape == (1, 200_000, 2)
    # P(spike) = Phi(mean)
    np.testing.assert_allclose(out.mean(1)[0], st.norm.cdf(mean[0]),
                               atol=5e-3)
    # joint firing probability = Phi2(mean_i, mean_j; rho)
    joint = (out[0, :, 0] * out[0, :, 1]).mean()
    assert joint == pytest.approx(
        _scipy_bivar_cdf(mean[0, 0], mean[0, 1], 0.4), abs=5e-3)
    # the same generator state gives the same draw; no generator seeds
    # from numpy's global state, on the device asked for
    again = sampler.sample(torch.Generator().manual_seed(0),
                           repeats=200_000).numpy()
    np.testing.assert_array_equal(out, again)
    np.random.seed(3)
    a = sampler.sample(repeats=50, device="cpu")
    np.random.seed(3)
    np.testing.assert_array_equal(a.numpy(),
                                  sampler.sample(repeats=50, device="cpu"))


def test_fit_roundtrip():
    """Sample from a known DG, refit, recover mean & correlation."""
    mean = np.array([[0.3, -0.2, 0.1]])
    corr = np.eye(3)
    corr[0, 1] = corr[1, 0] = 0.35
    corr[1, 2] = corr[2, 1] = -0.25
    sampler = dg.DichotGauss(3, mean=mean, corr=corr)
    spikes = sampler.sample(torch.Generator().manual_seed(42),
                            repeats=200_000).numpy().astype(np.float64)
    opt = dg.DGOptimise(spikes)
    np.testing.assert_allclose(opt.gauss_mean[0], mean[0], atol=2e-2)
    fit = opt.get_gauss_correlation(device="cpu")
    np.testing.assert_allclose(fit, corr, atol=3e-2)
    assert opt.gauss_corr is fit


def test_seeded_normals_streams():
    a = dg.SeededNormals(5, ("x", "y"), "cpu")
    b = dg.SeededNormals(5, ("x", "y"), "cpu")
    x1, y1 = a.normal("x", (4, 3)), a.normal("y", (4, 3))
    assert x1.dtype == torch.float32 and not torch.equal(x1, y1)
    # the streams are independent of the order they are read in
    torch.testing.assert_close(b.normal("y", (4, 3)), y1, rtol=0, atol=0)
    torch.testing.assert_close(b.normal("x", (4, 3)), x1, rtol=0, atol=0)
    assert not torch.equal(a.normal("x", (4, 3)), x1)  # a stream goes on
    assert not torch.equal(dg.SeededNormals(6, ("x",), "cpu").normal(
        "x", (4, 3)), x1)


# ---------------------------------------------------------------------------
# ar1_filter
# ---------------------------------------------------------------------------

def _spikes(shape, seed=0, rate=0.1):
    return (np.random.default_rng(seed).random(shape) < rate).astype(
        np.float32)


_AR_CASES = [(g, T) for g in ((0.95,), 0.9, (1.2, -0.3))
             for T in (1, 2, 3, 500)
             if not (T < 2 and g == (1.2, -0.3))]  # AR(2) reads two samples


@pytest.mark.parametrize("g,T", _AR_CASES)
def test_ar1_filter_matches_jax(g, T):
    s = _spikes((4, 3, T), seed=T)
    ours = ar1_filter(torch.from_numpy(s), g)
    theirs = np.asarray(jax_ar1_filter(jnp.asarray(s), g))
    assert ours.dtype == torch.float32 and ours.shape == s.shape
    if T <= 2:
        np.testing.assert_array_equal(ours.numpy(), s)  # passed through
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=AR_TOL)


@pytest.mark.parametrize("dtype", [np.int8, np.bool_, np.int64])
def test_ar1_filter_casts_integer_and_bool_input(dtype):
    s = _spikes((3, 200), seed=1).astype(dtype)
    ours = ar1_filter(torch.from_numpy(s))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jax_ar1_filter(jnp.asarray(s))), rtol=0,
        atol=AR_TOL)
    assert float(ours.max()) > 1.5  # the decay was not truncated to 0
    # a numpy array is taken as a CPU tensor
    torch.testing.assert_close(ar1_filter(s), ours, rtol=0, atol=0)


def test_ar1_filter_honours_axis():
    s = _spikes((300, 5), seed=2)
    for g in ((0.95,), (1.2, -0.3)):
        ours = ar1_filter(torch.from_numpy(s), g, axis=0)
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jax_ar1_filter(jnp.asarray(s), g, 0)),
            rtol=0, atol=AR_TOL)
        torch.testing.assert_close(
            ours, ar1_filter(torch.from_numpy(s.T.copy()), g).T, rtol=0,
            atol=0)


def test_ar1_filter_at_20000_frames_against_jax_and_a_float64_loop():
    s = _spikes((6, 20000), seed=3)
    ours = ar1_filter(torch.from_numpy(s)).numpy()
    theirs = np.asarray(jax_ar1_filter(jnp.asarray(s)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=AR_TOL)
    loop = s.astype(np.float64)
    for t in range(2, s.shape[1]):
        loop[:, t] = s[:, t] + 0.95 * loop[:, t - 1]
    np.testing.assert_allclose(ours, loop, rtol=0, atol=AR_TOL)
    # planted fault: a recurrence that starts at t = 1 (no g*s[0] taken
    # from s[1]) is outside the bound
    from calciumgan_tpu_torch.ops.spike_metrics import first_order_recurrence
    x = torch.from_numpy(s)
    _, wrong = first_order_recurrence(torch.full_like(x, 0.95), x)
    assert np.abs(wrong.numpy() - theirs).max() > 100 * AR_TOL
