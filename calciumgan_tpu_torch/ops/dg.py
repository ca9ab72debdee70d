"""Dichotomized Gaussian (DG) spike model (counterpart of
``calciumgan_tpu/ops/dg.py``).

- :class:`DichotGauss` samples correlated binary populations as one tensor
  program (Cholesky on the host, one batched float32 product on the device,
  threshold) instead of a scipy ``rvs`` call per timebin;
- :class:`DGOptimise` fits the latent Gaussian: inverse-normal means, the
  time-varying and fixed-rate covariance estimators, and
  ``get_gauss_correlation``, which solves every neuron pair's latent
  correlation at once in a fixed-trip bisection
  (:func:`_solve_pair_correlations`);
- the bivariate normal CDF is a 64-node Gauss-Legendre quadrature of
  ``Phi2(h, k, rho) = Phi(h) Phi(k) + (1/2pi) int_0^rho exp(-(h^2 - 2rhk +
  k^2) / (2(1-r^2))) / sqrt(1-r^2) dr`` (Drezner & Wesolowsky's identity),
  broadcast over its inputs;
- :class:`Higham`, the nearest-correlation-matrix projection (Higham 2002),
  and the small matrix helpers are numpy float64 on the host, copied from
  the JAX package: they run once per fit on a small matrix and need
  eigendecompositions at full precision.

PyTorch has no global float64 switch, so the fit creates every tensor as
float64 explicitly. None of this is a kernel port: the JAX package computes
it in XLA (``jnp``, ``lax.fori_loop``), outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch


class WarningDG(UserWarning):
    pass


def heaviside(x, center: float = 0.0) -> torch.Tensor:
    """1 where x > center else 0, float32."""
    return (torch.as_tensor(x) > center).to(torch.float32)


def cov_to_corr(cov: np.ndarray) -> np.ndarray:
    std = np.sqrt(np.diag(cov))
    return cov / (np.outer(std, std) + 1e-8)


def make_symmetric(M: np.ndarray) -> np.ndarray:
    if np.any(M != M.T):
        M = M.copy()
        tril = np.tril_indices(len(M), -1)
        M[tril] = M[tril[1], tril[0]].flatten()
    return M


# ---------------------------------------------------------------------------
# Higham nearest-correlation projection (host, float64)
# ---------------------------------------------------------------------------

class Higham:
    """Iterative alternating projection to the nearest correlation matrix
    (copy of the JAX package's ``Higham``)."""

    def __init__(self, maxiters: float = 1e5, tol: float = 1e-10):
        self.maxiters = maxiters
        self.tol = tol

    @staticmethod
    def projection_S(M):
        eigval, eigvec = np.linalg.eigh(M)
        eigval = np.maximum(eigval, 0.0)
        return (eigvec * eigval) @ eigvec.T

    @staticmethod
    def projection_U(M):
        out = M.copy()
        np.fill_diagonal(out, 1.0)
        return out

    @staticmethod
    def _relative_change(new: np.ndarray, old: np.ndarray) -> float:
        """max-row-sum (l_inf-induced) norm of the difference, relative to
        the new iterate."""
        return float(np.max(np.abs(new - old).sum(1))
                     / np.max(np.abs(new).sum(1)))

    def higham_correction(self, M: np.ndarray) -> np.ndarray:
        """Higham (2002): alternate projections onto the PSD cone and the
        unit-diagonal affine set, with a Dykstra correction term carried
        across iterations so the sequence converges to the nearest
        correlation matrix rather than just a feasible point. Stops when the
        PSD iterate, the unit-diagonal iterate, and their gap all move less
        than ``tol``."""
        psd = unit_diag = np.asarray(M, np.float64)
        correction = np.zeros_like(psd)
        for _ in range(int(self.maxiters)):
            shifted = unit_diag - correction
            new_psd = self.projection_S(shifted)
            correction = new_psd - shifted
            new_unit = self.projection_U(new_psd)
            done = max(
                self._relative_change(new_psd, psd),
                self._relative_change(new_unit, unit_diag),
                self._relative_change(new_unit, new_psd)) <= self.tol
            psd, unit_diag = new_psd, new_unit
            if done:
                break
        else:
            warnings.warn(
                f"Higham projection stopped at the {int(self.maxiters)}"
                f"-iteration cap before the change fell under {self.tol}.",
                WarningDG)
        # the unit-diagonal projection can re-introduce tiny negative
        # eigenvalues; clamp them and renormalise back to a correlation
        eigvals, eigvec = np.linalg.eigh(unit_diag)
        if eigvals.min() < 0:
            warnings.warn(
                "projected matrix has negative eigenvalues; clamping "
                "spectrum to reach positive definiteness.", WarningDG)
            eigvals = np.where(eigvals < 0, 1e-6, eigvals)
            unit_diag = (eigvec * eigvals) @ eigvec.T
            unit_diag = cov_to_corr(unit_diag)
            unit_diag = 0.5 * (unit_diag + unit_diag.T)
        return np.real(unit_diag)


def is_positive_definite(M: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(M)
        return True
    except np.linalg.LinAlgError:
        return False


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_float32_matmul():
    """float32 products in full float32 on a CUDA device while the context
    lasts, whatever the caller's TF32 switch says."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    if allowed:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if allowed:
            torch.backends.cuda.matmul.allow_tf32 = True


class DichotGauss:
    """Binary population sampler: z ~ N(mean, corr) per timebin, thresholded
    at 0. Output shape (timebins, repeats, neurons)."""

    def __init__(self, num_neur: int, mean=None, corr=None,
                 make_pd: bool = False, **kwargs):
        self.num_neur = num_neur
        self.make_pd = make_pd
        self.higham = Higham(**kwargs)
        self.projected = False  # whether a matrix went through Higham
        if mean is None:
            mean = np.zeros((1, num_neur))
        if corr is None:
            corr = np.eye(num_neur)
            self.make_pd = False
        if self.make_pd:
            corr = self.do_higham_correction(make_symmetric(np.asarray(corr)))
        self.mean = np.asarray(mean, np.float64)
        self.corr = np.asarray(corr, np.float64)
        self._chol = np.linalg.cholesky(self.corr)

    def do_higham_correction(self, M: np.ndarray) -> np.ndarray:
        if not is_positive_definite(M):
            if not self.make_pd:
                warnings.warn(
                    "correlation matrix is not positive definite; construct "
                    "with make_pd=True to project it onto the nearest "
                    "correlation matrix.", WarningDG)
                raise NotImplementedError
            warnings.warn("correlation matrix is not positive definite; "
                          "applying the Higham projection.", WarningDG)
            M = self.higham.higham_correction(M)
            self.projected = True
        return M

    def sample(self, generator: torch.Generator | None = None, mean=None,
               corr=None, repeats: int = 1, eps: torch.Tensor | None = None,
               device=None) -> torch.Tensor:
        """One batched device computation: (repeats, timebins, N) standard
        normals -> correlate via Cholesky -> + mean -> threshold ->
        transpose to (timebins, repeats, neurons), float32.

        The normals are drawn from ``generator`` on the device it lives on;
        ``eps`` gives them instead (where it lies; its leading axis is
        ``repeats``), for a caller that brings its own draws; with neither, a generator on ``device``
        (default ``cuda``) is seeded from numpy's global state. The product
        decides a threshold at 0, so it is a full float32 product whatever
        the caller's TF32 switch."""
        mean = self.mean if mean is None else np.asarray(mean)
        if corr is not None:
            corr = self.do_higham_correction(np.asarray(corr))
            chol = np.linalg.cholesky(corr)
        else:
            chol = self._chol
        timebins = mean.shape[0]
        if eps is not None:
            repeats = eps.shape[0]
        shape = (repeats, timebins, self.num_neur)
        if eps is None:
            if generator is None:
                generator = torch.Generator(
                    device="cuda" if device is None else device).manual_seed(
                        int(np.random.randint(0, 2**31 - 1)))
            eps = torch.randn(shape, generator=generator,
                              device=generator.device, dtype=torch.float32)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps of shape {tuple(eps.shape)}, expected "
                             f"{shape}")
        eps = eps.to(torch.float32)
        chol_t = torch.as_tensor(np.ascontiguousarray(chol.T), device=eps.device
                                 ).to(torch.float32)
        with _full_float32_matmul():
            z = torch.matmul(eps, chol_t)
        z = z + torch.as_tensor(mean, device=eps.device).to(torch.float32)[None]
        return heaviside(z.transpose(0, 1))


class SeededNormals:
    """The standard-normal draws of a data generator: one ``torch.Generator``
    on ``device`` per named stream, all seeded from ``seed`` (in place of
    the keys the JAX package splits from its seed). ``normal(stream,
    shape)`` continues that stream. A test passes an object with the same
    method that returns the JAX package's draws instead: threefry and
    Philox never draw the same numbers."""

    def __init__(self, seed: int, streams, device):
        self.device = torch.device(device)
        state = np.random.SeedSequence(int(seed)).generate_state(
            len(streams), np.uint64)
        self._generators = {
            name: torch.Generator(device=self.device).manual_seed(
                int(word >> np.uint64(1)))
            for name, word in zip(streams, state)}

    def normal(self, stream: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._generators[stream],
                           device=self.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# bivariate normal CDF (Gauss-Legendre quadrature, broadcast)
# ---------------------------------------------------------------------------

_GL_ORDER = 64
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_GL_ORDER)


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float64)


def bivar_gauss_cdf(h, k, rho, device=None) -> torch.Tensor:
    """Phi2(h, k; rho) for standard bivariate normals, broadcast over the
    inputs, float64 throughout (on ``device``, or where tensors lie)."""
    h, k, rho = torch.broadcast_tensors(_f64(h, device), _f64(k, device),
                                        _f64(rho, device))
    # integrate r from 0 to rho
    nodes = _f64(_GL_NODES, h.device)          # on [-1, 1]
    weights = _f64(_GL_WEIGHTS, h.device)
    r = 0.5 * rho[..., None] * (nodes + 1.0)
    scale = 0.5 * rho[..., None]
    one_m_r2 = 1.0 - r * r
    integrand = torch.exp(
        -(h[..., None] ** 2 - 2.0 * r * h[..., None] * k[..., None]
          + k[..., None] ** 2) / (2.0 * one_m_r2)) / torch.sqrt(one_m_r2)
    integral = torch.sum(weights * integrand * scale, dim=-1)
    return (torch.special.ndtr(h) * torch.special.ndtr(k)
            + integral / (2.0 * np.pi))


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def _solve_pair_correlations(gauss_means, data_means, data_covar,
                             maxiters: int = 60, tol: float = 1e-10,
                             device=None) -> torch.Tensor:
    """Latent correlation for every neuron pair at once, float64 on
    ``device``.

    For each pair (i, j): root of
        f(rho) = mean_t Phi2(mu_i(t), mu_j(t); rho) - r_i r_j - Sigma_ij
    by bisection on [-0.99999, 0.99999] with the reference's edge cases:
    |f(lo)| < tol -> lo, |f(hi)| < tol -> hi, f(lo) f(hi) > tol -> 0, and
    pairs with |Sigma_ij| <= 1e-10 get 0. One fixed-trip loop over the
    P = N(N-1)/2 pairs, in the order of ``tril_indices(N, -1)``.
    """
    gauss_means = _f64(gauss_means, device)
    data_means = _f64(data_means, device)
    data_covar = _f64(data_covar, device)
    device = gauss_means.device
    N = gauss_means.shape[-1]
    iu, ju = torch.tril_indices(N, N, -1, device=device)

    mu_i = gauss_means[..., iu].T      # (P, timebins)
    mu_j = gauss_means[..., ju].T
    r_ij = data_means[iu] * data_means[ju]
    cov_ij = data_covar[iu, ju]

    def f(rho):                        # rho: (P,)
        cdf = bivar_gauss_cdf(mu_i, mu_j, rho[:, None]).mean(-1)
        return cdf - r_ij - cov_ij

    lo0 = torch.full_like(cov_ij, -0.99999)
    hi0 = torch.full_like(cov_ij, 0.99999)
    f0, f1 = f(lo0), f(hi0)

    # seeded with the first midpoint's bracket already applied, so the
    # first trip does not evaluate f at the same midpoint again
    mid0 = 0.5 * (lo0 + hi0)
    fm0 = f(mid0)
    lo = torch.where(fm0 < 0, mid0, lo0)
    hi = torch.where(fm0 > 0, mid0, hi0)
    root, fr = mid0, fm0
    for _ in range(maxiters):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        hi = torch.where(fm > 0, mid, hi)
        lo = torch.where(fm < 0, mid, lo)
        # the latest midpoint is tracked until |f| <= tol, then frozen
        done = fr.abs() <= tol
        root = torch.where(done, root, mid)
        fr = torch.where(done, fr, fm)

    zero = torch.zeros_like(root)
    root = torch.where(f0.abs() < tol, lo0, root)
    root = torch.where(f1.abs() < tol, hi0, root)
    root = torch.where(f0 * f1 > tol, zero, root)
    root = torch.where(cov_ij.abs() <= 1e-10, zero, root)

    corr = torch.eye(N, dtype=torch.float64, device=device)
    corr[iu, ju] = root
    corr[ju, iu] = root
    return corr


class DGOptimise:
    """Fit DG parameters to binary data of shape (timebins, trials,
    neurons)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float64)
        self.timebins, self.trials, self.num_neur = data.shape
        self.data = data

    @property
    def gauss_mean(self) -> np.ndarray:
        """Inverse normal CDF of the per-(timebin, neuron) firing
        probability, clamped away from {0, 1}; float64."""
        mean = self.data.mean(1)
        if np.any(mean < 0) or np.any(mean > 1):
            raise ValueError("Mean should have value between 0 and 1.")
        mean = np.where(mean == 0.0, mean + 1e-4, mean)
        mean = np.where(mean == 1.0, mean - 1e-4, mean)
        return torch.special.ndtri(
            torch.from_numpy(np.ascontiguousarray(mean, np.float64))).numpy()

    @property
    def data_tvar_covariance(self) -> np.ndarray:
        """Across-neuron covariance for time-varying rates."""
        data = self.data
        data_norm = data - data.mean(0)                 # (T, R, N)
        # per-trial (N, N) covariance over time, averaged across trials
        tot = np.einsum("tri,trj->rij", data_norm, data_norm)
        return tot.mean(0) / self.timebins

    @property
    def data_tfix_covariance(self) -> np.ndarray:
        """Across-neuron covariance for fixed rates."""
        data_norm = (self.data - self.data.mean(1, keepdims=True)).reshape(
            -1, self.num_neur)
        return data_norm.T @ data_norm / (self.timebins * self.trials)

    def get_gauss_correlation(self, set_attr: bool = True, device="cuda",
                              **kwargs) -> np.ndarray:
        """The fitted latent correlation matrix (host float64); the
        bisection runs on ``device``."""
        data_mean = self.data.mean(1).mean(0)
        gauss_mean = np.atleast_2d(self.gauss_mean)
        data_covar = (self.data_tvar_covariance if self.timebins > 1
                      else self.data_tfix_covariance)
        # float64: the bisection honours the reference's 1e-10 tolerance
        corr = _solve_pair_correlations(
            gauss_mean, data_mean, data_covar, device=device,
            **kwargs).cpu().numpy()
        if set_attr:
            self.gauss_corr = corr
        return corr
