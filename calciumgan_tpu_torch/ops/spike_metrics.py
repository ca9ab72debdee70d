"""Spike-train statistics on tensors (counterpart of
``calciumgan_tpu/ops/spike_metrics.py``).

The reference wraps Elephant + Neo on the host, per train, across a process
pool (``gan/utils/spike_metrics.py:6-61``). Here, as in the JAX package,
the five statistics are closed-form tensor programs over binary (train,
time) matrices on the fixed 24 Hz frame grid:

- mean firing rate: spike count / duration,
- binned correlation / covariance: 500 ms bins (12 frames at 24 Hz, the
  ragged tail dropped as ``elephant.conversion.BinnedSpikeTrain`` does),
  then corrcoef / cov (ddof=1) over the bin counts,
- van Rossum distance: inner products under the exponential kernel
  ``K[a, b] = rho^|a-b|``, applied as two first-order recurrences (a
  log-depth scan, :func:`first_order_recurrence`) instead of a (T, T)
  product; one non-coincident spike costs 1 (tau = 1 s),
- Victor-Purpura distance: the edit-distance DP over padded spike-time
  rows, one DP row per step for all pairs at once (q = 1/s),
- histogram KL divergence: 30 right-closed equal-width bins over the joint
  range, zeros -> 1e-10 (the reference's ``pandas.cut`` recipe,
  ``compute_metrics.py:82-112``).

Every function takes float32 data (tensors, or arrays that are moved to
``device``) and computes where its tensors lie. The public functions take
one set (the full pairwise result; leading dims are batch dims) or two sets
(the real x fake cross block, the reference's "concatenate and slice").
None of this is a kernel port: the JAX package computes these statistics
in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

FRAMERATE = 24  # Hz, reference summary_helper.py:66, spike_helper.py:8


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, (list, tuple)) and x and torch.is_tensor(x[0]):
        x = torch.stack(list(x))
    return torch.as_tensor(x, device=device).to(torch.float32)


# ---------------------------------------------------------------------------
# firing rate
# ---------------------------------------------------------------------------

def mean_firing_rate(spikes, framerate: int = FRAMERATE,
                     device=None) -> torch.Tensor:
    """(..., T) binary -> (...,) rate in Hz."""
    spikes = _f32(spikes, device)
    duration = torch.tensor(spikes.shape[-1] / framerate,
                            dtype=torch.float32, device=spikes.device)
    return spikes.sum(dim=-1) / duration


# ---------------------------------------------------------------------------
# binned correlation / covariance
# ---------------------------------------------------------------------------

def bin_spike_counts(spikes, framerate: int = FRAMERATE,
                     binsize: float = 0.5, device=None) -> torch.Tensor:
    """(..., T) -> (..., B) counts in ``binsize``-second bins; the ragged
    tail beyond B*binsize is dropped (BinnedSpikeTrain semantics)."""
    spikes = _f32(spikes, device)
    frames_per_bin = int(round(binsize * framerate))
    n_bins = spikes.shape[-1] // frames_per_bin
    trimmed = spikes[..., :n_bins * frames_per_bin]
    return trimmed.reshape(spikes.shape[:-1] + (n_bins, frames_per_bin)).sum(
        dim=-1)


def _cov(m: torch.Tensor) -> torch.Tensor:
    """``np.cov`` of (..., variables, observations), ddof 1."""
    x = m - m.mean(dim=-1, keepdim=True)
    return (x @ x.transpose(-1, -2)) / (m.shape[-1] - 1)


def _corrcoef(m: torch.Tensor) -> torch.Tensor:
    c = _cov(m)
    d = torch.sqrt(torch.diagonal(c, dim1=-2, dim2=-1))
    # a zero-variance row is exactly zero after centring: 0 / 0 = NaN over
    # its whole row and column
    return c / (d[..., :, None] * d[..., None, :])


def _pair_or_cross(fn, spikes1, spikes2, device):
    if spikes2 is None:
        return fn(_f32(spikes1, device))
    s1, s2 = _f32(spikes1, device), _f32(spikes2, device)
    full = fn(torch.cat([s1, s2], dim=0))
    # reference slice: result[len(s1):, :len(s2)] (spike_metrics.py:23,37)
    return full[len(s1):, :len(s2)]


def correlation_coefficients(spikes1, spikes2=None,
                             framerate: int = FRAMERATE,
                             binsize: float = 0.5,
                             device=None) -> torch.Tensor:
    """Pearson correlation of 500 ms bin counts; rows with zero variance
    yield NaN (filtered downstream with remove_nan, as in the reference)."""
    return _pair_or_cross(
        lambda s: _corrcoef(bin_spike_counts(s, framerate, binsize)),
        spikes1, spikes2, device)


def covariance(spikes1, spikes2=None, framerate: int = FRAMERATE,
               binsize: float = 0.5, device=None) -> torch.Tensor:
    return _pair_or_cross(
        lambda s: _cov(bin_spike_counts(s, framerate, binsize)),
        spikes1, spikes2, device)


# ---------------------------------------------------------------------------
# van Rossum distance
# ---------------------------------------------------------------------------

def first_order_recurrence(a: torch.Tensor, b: torch.Tensor, axis: int = -1,
                           reverse: bool = False):
    """Solve ``c[t] = a[t] * c[t-1] + b[t]`` (``c`` before the first element
    is 0; time flipped when ``reverse``) along ``axis`` as a log-depth scan
    over the composition of the affine maps ``x -> x*a + b``: step ``d``
    composes every element with the one ``d`` places before it (counterpart
    of ``first_order_recurrence`` in ``calciumgan_tpu/ops/oasis.py``, which
    uses ``lax.associative_scan``). Returns ``(a_prod, c)``.

    Only products of the ``a`` actually met are formed, never their
    inverses: a ``cumsum`` of ``b * rho^-t`` would overflow float32 past
    about 2,100 frames at 24 Hz."""
    a = torch.movedim(a, axis, -1)
    b = torch.movedim(b, axis, -1)
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    d = 1
    while d < b.shape[-1]:
        b = torch.cat([b[..., :d], b[..., d:] + a[..., d:] * b[..., :-d]],
                      dim=-1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    if reverse:
        a, b = a.flip(-1), b.flip(-1)
    return torch.movedim(a, -1, axis), torch.movedim(b, -1, axis)


def _apply_decay_kernel(y: torch.Tensor, rho: float) -> torch.Tensor:
    """``(K @ y^T)^T`` for ``K[a, b] = rho^|a-b|`` without the (T, T)
    kernel: K = F + F^T - I with F the causal decay, so ``(K y)_t = fwd_t +
    bwd_t - y_t`` with fwd/bwd the recurrences ``fwd_t = y_t + rho *
    fwd_{t-1}`` forwards and backwards."""
    decay = torch.full_like(y, rho)
    _, fwd = first_order_recurrence(decay, y)
    _, bwd = first_order_recurrence(decay, y, reverse=True)
    return fwd + bwd - y


def van_rossum_distance(spikes1, spikes2=None, tau: float = 1.0,
                        framerate: int = FRAMERATE,
                        device=None) -> torch.Tensor:
    """Pairwise van Rossum distances.

    ``D(u, v)^2 = u^T K u + v^T K v - 2 u^T K v`` with ``K[a, b] =
    exp(-|a - b| / (framerate * tau))`` over the frame grid. For identical
    trains ``D^2`` cancels to rounding noise, clamped at 0."""
    x = _f32(spikes1 if spikes2 is None else spikes2, device)  # rows: fake
    rho = float(np.exp(-1.0 / (framerate * tau)))
    xK = _apply_decay_kernel(x, rho)
    self_x = (xK * x).sum(dim=-1)                # diag(x K x^T)
    if spikes2 is None:
        y, self_y = x, self_x
    else:
        y = _f32(spikes1, device)
        self_y = (_apply_decay_kernel(y, rho) * y).sum(dim=-1)
    cross = xK @ y.transpose(-1, -2)
    d2 = self_x[..., :, None] + self_y[..., None, :] - 2.0 * cross
    return torch.sqrt(torch.clamp(d2, min=0.0))


# ---------------------------------------------------------------------------
# Victor-Purpura distance
# ---------------------------------------------------------------------------

def _spike_times_padded(spikes: np.ndarray, framerate: int, bucket: int = 1,
                        device=None):
    """Binary (N, T) -> (times (N, M) float32 padded with +inf, counts (N,)).

    M is the GLOBAL max spike count, so one dense train inflates the
    O(M^2) DP for every pair (spiking data is sparse and uniform).
    ``bucket`` rounds M up to a multiple (the batch form uses 32, as the JAX
    package does to bound its count of compiled programs)."""
    spikes = np.asarray(spikes)
    counts = spikes.astype(bool).sum(axis=-1)
    M = max(1, int(counts.max()) if counts.size else 1)
    M = -(-M // bucket) * bucket
    times = np.full((spikes.shape[0], M), np.inf, np.float32)
    for i, row in enumerate(spikes):
        t = np.nonzero(row)[0] / framerate
        times[i, :len(t)] = t
    return (torch.as_tensor(times, device=device),
            torch.as_tensor(counts.astype(np.int64), device=device))


def _vp_matrix(tx, nx, ty, ny, q: float) -> torch.Tensor:
    """VP edit distances between every row of ``tx`` (..., Nx, M) and every
    row of ``ty`` (..., Ny, M), padded spike times with counts ``nx``,
    ``ny`` -> (..., Nx, Ny).

    The DP table is built one row (one spike of ``u``) at a time for all
    pairs at once. Within a row, ``row[k] = min(prev[k] + 1, row[k-1] + 1,
    prev[k-1] + move_k)`` is a min-plus prefix: with ``a_k = min(prev[k] +
    1, prev[k-1] + move_k)`` and ``a_0 = prev[0] + 1``, ``row[k] = k +
    cummin(a_k - k)``."""
    M = ty.shape[-1]
    k = torch.arange(M + 1, dtype=torch.float32, device=tx.device)
    lead = torch.broadcast_shapes(tx.shape[:-2], ty.shape[:-2])
    prev = k.expand(lead + (tx.shape[-2], ty.shape[-2], M + 1)).clone()
    valid_v = (torch.arange(M, device=tx.device) < ny[..., None])
    valid_v = valid_v[..., None, :, :]                  # (..., 1, Ny, M)
    tv = ty[..., None, :, :]
    inf = torch.tensor(float("inf"), device=tx.device)
    for i in range(tx.shape[-1]):
        t_ui = tx[..., :, i][..., :, None, None]        # (..., Nx, 1, 1)
        valid_u = (i < nx)[..., :, None, None]
        move = torch.where(valid_u & valid_v, q * (t_ui - tv).abs(), inf)
        a = torch.cat([prev[..., :1] + 1.0,
                       torch.minimum(prev[..., 1:] + 1.0,
                                     prev[..., :-1] + move)], dim=-1)
        row = k + torch.cummin(a - k, dim=-1).values
        prev = torch.where(valid_u, row, prev)
    index = ny[..., None, :, None].expand(prev.shape[:-1] + (1,))
    return prev.gather(-1, index)[..., 0]


def victor_purpura_distance(spikes1, spikes2=None, q: float = 1.0,
                            framerate: int = FRAMERATE,
                            device=None) -> torch.Tensor:
    """Pairwise Victor-Purpura distances (cost ``q`` per second of shift)."""
    s1 = _host(spikes1)
    if spikes2 is None:
        t, n = _spike_times_padded(s1, framerate, device=device)
        return _vp_matrix(t, n, t, n, q)
    s2 = _host(spikes2)
    t, n = _spike_times_padded(np.concatenate([s1, s2], axis=0), framerate,
                               device=device)
    full = _vp_matrix(t, n, t, n, q)
    return full[len(s1):, :len(s2)]


def victor_purpura_distance_batch(spikes, q: float = 1.0,
                                  framerate: int = FRAMERATE,
                                  device=None) -> torch.Tensor:
    """Trial-batched pairwise VP: (B, N, T) binary spikes -> (B, N, N)
    matrices in one tensor program. Spike-count padding is per call
    (bucketed to 32), so a dense outlier only inflates its own chunk."""
    spikes = _host(spikes)
    B, N, T = spikes.shape
    t, n = _spike_times_padded(spikes.reshape(B * N, T), framerate,
                               bucket=32, device=device)
    t, n = t.reshape(B, N, -1), n.reshape(B, N)
    return _vp_matrix(t, n, t, n, q)


def _host(spikes) -> np.ndarray:
    if torch.is_tensor(spikes):
        return spikes.cpu().numpy()
    return np.asarray(spikes)


# ---------------------------------------------------------------------------
# histogram KL divergence
# ---------------------------------------------------------------------------

def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sum(p * log(p / q)) with zero entries replaced by 1e-10
    (reference ``compute_metrics.py:82-86``)."""
    tiny = torch.tensor(1e-10, dtype=p.dtype, device=p.device)
    p = torch.where(p == 0, tiny, p)
    q = torch.where(q == 0, tiny, q)
    return torch.sum(p * torch.log(p / q))


def histogram_counts(real, fake, num_bins: int = 30, device=None):
    """The two histograms of :func:`histogram_kl`: float32 counts per bin
    of ``real`` and of ``fake``.

    Firing rates and bin counts are discrete, so values sit exactly on bin
    edges, where one ulp in an edge moves a count: the edges are built in
    float32 in the JAX package's order of operations, ``lo + (span *
    arange) / num_bins``, then ``edges[0] -= 0.001 * span``."""
    real = _f32(real, device).ravel()
    fake = _f32(fake, device).ravel()
    both = torch.cat([real, fake])
    lo, hi = both.min(), both.max()
    span = torch.where(hi > lo, hi - lo, torch.ones_like(lo))
    steps = torch.arange(num_bins + 1, dtype=torch.float32,
                         device=both.device)
    edges = lo + (span * steps) / num_bins
    edges[0] = edges[0] + (-0.001) * span

    def counts(x):
        # right-closed bins: count of edges[i] < x <= edges[i+1]
        idx = torch.searchsorted(edges, x, right=False) - 1
        idx = idx.clamp(0, num_bins - 1)
        return torch.zeros(num_bins, dtype=torch.float32,
                           device=x.device).index_add_(
                               0, idx, torch.ones_like(x))

    return counts(real), counts(fake)


def histogram_kl(real, fake, num_bins: int = 30,
                 device=None) -> torch.Tensor:
    """30-bin histogram KL(real || fake) over the joint range: the
    reference's ``pandas.cut`` recipe (right-closed equal-width bins with
    the left edge extended 0.1% so the minimum lands in bin 0,
    ``compute_metrics.py:89-112``)."""
    real_counts, fake_counts = histogram_counts(real, fake, num_bins, device)
    # each histogram sums to its set's size, exactly
    return kl_divergence(real_counts / real_counts.sum(),
                         fake_counts / fake_counts.sum())


def _size(x) -> int:
    return x.numel() if torch.is_tensor(x) else int(np.size(x))


def pairs_kl_divergence(pairs, device=None) -> np.ndarray:
    """[(real, fake), ...] -> per-pair KL (``compute_metrics.py:89-112``);
    NaN for pairs where either side is empty (e.g. all-NaN correlations of
    silent trains filtered by remove_nan)."""
    out = np.full(len(pairs), np.nan, np.float32)
    for i, (r, f) in enumerate(pairs):
        if _size(r) and _size(f):
            out[i] = float(histogram_kl(r, f, device=device))
    return out
