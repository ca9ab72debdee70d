"""The port's spike statistics against the JAX package's on the same binary
matrices (seeded with numpy), on the CPU.

Bounds: firing rates and bin counts are exact; correlation and covariance
agree to 1e-5 with equal NaN masks (a silent or constant train gives NaN
over its row and column in both); van Rossum to 1e-3 on ``d**2`` (float32
sums of a few hundred, and ``d**2`` cancels to rounding noise for equal
trains, so ``d`` itself is compared only away from 0); Victor-Purpura to
1e-4; the KL histograms count for count, the KL to 1e-5 relative. The
literals of ``tests/test_elephant_parity.py`` are run against the port.
Each bound is shown to catch a fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calciumgan_tpu.ops import oasis as jax_oasis
from calciumgan_tpu.ops import spike_metrics as jax_sm
from calciumgan_tpu_torch.ops import spike_metrics as sm

torch.set_num_threads(1)

SHAPES = [(6, 960), (102, 2048), (5, 2400)]


def trains(shape, seed, rate=0.05, constant=True):
    """Binary trains; row 1 is silent and, with ``constant`` and enough
    rows, row 2 fires in every frame (zero variance in both cases)."""
    rng = np.random.default_rng(seed)
    out = (rng.random(shape) < rate).astype(np.float32)
    out[1] = 0.0
    if constant and shape[0] > 5:
        out[2] = 1.0
    return out


def train(T, frames):
    out = np.zeros(T, np.float32)
    out[list(frames)] = 1.0
    return out


# ---- firing rate, bins ------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_firing_rate_and_bins_equal_jax_exactly(shape):
    a = trains(shape, 0)
    np.testing.assert_array_equal(sm.mean_firing_rate(a).numpy(),
                                  np.asarray(jax_sm.mean_firing_rate(a)))
    ours = sm.bin_spike_counts(a).numpy()
    np.testing.assert_array_equal(ours,
                                  np.asarray(jax_sm.bin_spike_counts(a)))
    assert ours.shape == (shape[0], shape[1] // 12)
    # a 13-frame bin would be caught: the counts differ
    assert not np.array_equal(
        ours[:, :70], sm.bin_spike_counts(a, binsize=13 / 24).numpy()[:, :70])
    # batch dims lead
    np.testing.assert_array_equal(
        sm.mean_firing_rate(a.reshape(1, *shape)).numpy()[0],
        sm.mean_firing_rate(a).numpy())


# ---- correlation, covariance ------------------------------------------------

@pytest.mark.parametrize("two_sets", [False, True], ids=["one", "cross"])
@pytest.mark.parametrize("name", ["correlation_coefficients", "covariance"])
@pytest.mark.parametrize("shape", SHAPES)
def test_correlation_and_covariance_equal_jax(shape, name, two_sets):
    args = (trains(shape, 1),) + ((trains(shape, 2, 0.08),) * two_sets)
    ours = getattr(sm, name)(*args).numpy()
    theirs = np.asarray(getattr(jax_sm, name)(*args))
    assert ours.shape == theirs.shape == (shape[0], shape[0])
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    if name == "correlation_coefficients":
        assert np.isnan(ours[1]).all() and np.isnan(ours[:, 1]).all()
        assert np.isfinite(ours[0, 3])
    else:
        assert np.isfinite(ours).all()
        # ddof 0 instead of 1 is outside the bound
        B = shape[1] // 12
        assert np.abs(ours * (B - 1) / B - theirs).max() > 1e-5


def test_correlation_batch_form_equals_per_trial():
    x = np.stack([trains((6, 960), s) for s in (3, 4, 5)])
    batch = sm.correlation_coefficients(x).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            batch[i], sm.correlation_coefficients(x[i]).numpy())


# ---- van Rossum -------------------------------------------------------------

@pytest.mark.parametrize("two_sets", [False, True], ids=["one", "cross"])
@pytest.mark.parametrize("shape", SHAPES)
def test_van_rossum_equals_jax(shape, two_sets):
    # (no train that fires in every frame: its d**2 of 4e4 has float32
    # steps of 4e-3)
    args = (trains(shape, 6, constant=False),) + (
        (trains(shape, 7, 0.08, constant=False),) * two_sets)
    ours = sm.van_rossum_distance(*args).numpy()
    theirs = np.asarray(jax_sm.van_rossum_distance(*args))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours ** 2, theirs ** 2, rtol=0, atol=1e-3)
    away = theirs > 1.0
    np.testing.assert_allclose(ours[away], theirs[away], rtol=0, atol=1e-4)
    # another time constant is far outside the bound
    other = sm.van_rossum_distance(*args, tau=1.1).numpy()
    assert np.abs(other ** 2 - theirs ** 2).max() > 1e-1


def test_first_order_recurrence_equals_jax_past_the_overflow_length():
    # 2,400 frames: rho**-t overflows float32 from t = 2,130 on at 24 Hz,
    # which is what a cumsum of b * rho**-t would have to form
    rho = float(np.exp(-1.0 / 24))
    assert not np.isfinite(np.float32(rho) ** np.float32(-2200))
    rng = np.random.default_rng(8)
    b = rng.random((3, 2400)).astype(np.float32)
    a = (0.9 + 0.1 * rng.random((3, 2400))).astype(np.float32)
    for reverse in (False, True):
        ours_a, ours_c = sm.first_order_recurrence(
            torch.from_numpy(a), torch.from_numpy(b), reverse=reverse)
        theirs_a, theirs_c = jax_oasis.first_order_recurrence(
            jnp.asarray(a), jnp.asarray(b), reverse=reverse)
        np.testing.assert_allclose(ours_c.numpy(), np.asarray(theirs_c),
                                   rtol=1e-5)
        np.testing.assert_allclose(ours_a.numpy(), np.asarray(theirs_a),
                                   rtol=1e-4, atol=1e-30)
    # the plain loop, along another axis
    c = np.zeros(3)
    for t in range(50):
        c = a[:, t].astype(np.float64) * c + b[:, t]
    _, ours = sm.first_order_recurrence(torch.from_numpy(a.T.copy()),
                                        torch.from_numpy(b.T.copy()), axis=0)
    np.testing.assert_allclose(ours.numpy()[49], c, rtol=1e-5)


# ---- Victor-Purpura ---------------------------------------------------------

def vp_trains(seed):
    """Sparse trains with an empty one and one dense outlier."""
    out = trains((6, 480), seed, 0.04)
    out[1] = 0.0
    out[2] = (np.random.default_rng(seed + 50).random(480) < 0.4)
    return out


@pytest.mark.parametrize("two_sets", [False, True], ids=["one", "cross"])
def test_victor_purpura_equals_jax(two_sets):
    args = (vp_trains(9),) + ((vp_trains(10)[:4],) * two_sets)
    ours = sm.victor_purpura_distance(*args).numpy()
    theirs = np.asarray(jax_sm.victor_purpura_distance(*args))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    if not two_sets:
        counts = args[0].sum(-1)
        np.testing.assert_allclose(ours[1], counts, atol=1e-4)  # vs empty
        assert counts[2] > 150  # the dense outlier pads every row
        np.testing.assert_allclose(np.diag(ours), 0.0, atol=1e-6)
    # another shift cost is outside the bound
    other = sm.victor_purpura_distance(*args, q=1.5).numpy()
    assert np.abs(other - theirs).max() > 1e-2


def test_victor_purpura_batch_equals_per_trial_and_jax():
    batch = np.stack([vp_trains(11), vp_trains(12)[::-1].copy()])
    ours = sm.victor_purpura_distance_batch(batch).numpy()
    assert ours.shape == (2, 6, 6)
    np.testing.assert_allclose(
        ours, np.asarray(jax_sm.victor_purpura_distance_batch(batch)),
        rtol=0, atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(
            ours[i], sm.victor_purpura_distance(batch[i]).numpy(), rtol=0,
            atol=1e-4)
    t, n = sm._spike_times_padded(batch.reshape(12, -1), 24, bucket=32)
    assert t.shape[1] % 32 == 0 and int(n.max()) <= t.shape[1]
    assert np.isinf(t.numpy()[1]).all()  # the empty train is all padding


# ---- histogram KL -----------------------------------------------------------

def jax_histogram_counts(real, fake, num_bins=30):
    """``pdf`` of the JAX ``histogram_kl`` before its division."""
    real = jnp.asarray(real, jnp.float32).ravel()
    fake = jnp.asarray(fake, jnp.float32).ravel()
    both = jnp.concatenate([real, fake])
    lo, hi = jnp.min(both), jnp.max(both)
    span = jnp.where(hi > lo, hi - lo, 1.0)
    edges = lo + span * jnp.arange(num_bins + 1) / num_bins
    edges = edges.at[0].add(-0.001 * span)

    def counts(x):
        idx = jnp.clip(jnp.searchsorted(edges, x, side="left") - 1, 0,
                       num_bins - 1)
        return jnp.zeros(num_bins, jnp.float32).at[idx].add(1.0)

    return np.asarray(counts(real)), np.asarray(counts(fake))


def discrete(seed, n):
    """Values on a grid, as firing rates and bin counts are: many of them
    sit exactly on a bin edge."""
    rng = np.random.default_rng(seed)
    step = np.float32(rng.choice([1.0, 0.28125, 24 / 2048, 1 / 3]))
    return rng.integers(0, int(rng.integers(5, 61)), n).astype(
        np.float32) * step


@pytest.mark.parametrize("seed", range(12))
def test_histogram_counts_and_kl_equal_jax(seed):
    real, fake = discrete(seed, 200), discrete(seed + 100, 150)
    ours = [c.numpy() for c in sm.histogram_counts(real, fake)]
    theirs = jax_histogram_counts(real, fake)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].sum() == 200 and ours[1].sum() == 150
    np.testing.assert_allclose(float(sm.histogram_kl(real, fake)),
                               float(jax_sm.histogram_kl(real, fake)),
                               rtol=1e-5)


def test_histogram_value_on_an_edge_and_degenerate_range():
    # 0..30 over 30 bins: every value but the least is a bin's right edge
    values = np.arange(31, dtype=np.float32)
    counts, _ = sm.histogram_counts(values, values[::-1].copy())
    np.testing.assert_array_equal(counts.numpy(), [2.0] + [1.0] * 29)
    np.testing.assert_array_equal(counts.numpy(),
                                  jax_histogram_counts(values, values)[0])
    # left-closed bins would move every edge value up one bin
    assert float(sm.histogram_kl(values, values)) == 0.0
    # hi == lo: the span falls back to 1 and everything lands in bin 0
    same = np.full(7, 2.5, np.float32)
    counts, _ = sm.histogram_counts(same, same)
    np.testing.assert_array_equal(counts.numpy(), [7.0] + [0.0] * 29)
    np.testing.assert_allclose(float(sm.histogram_kl(same, same)),
                               float(jax_sm.histogram_kl(same, same)))
    # one value moved by one bin is outside the KL bound
    moved = discrete(0, 200)
    fake = discrete(100, 150)
    base = float(sm.histogram_kl(moved, fake))
    moved[np.argmax(moved)] *= 0.9
    assert abs(float(sm.histogram_kl(moved, fake)) - base) > 1e-5 * base


def test_kl_and_pairs_equal_jax():
    rng = np.random.default_rng(13)
    p = rng.random(30).astype(np.float32)
    q = rng.random(30).astype(np.float32)
    p[3] = q[5] = 0.0
    p, q = p / p.sum(), q / q.sum()
    np.testing.assert_allclose(
        float(sm.kl_divergence(torch.from_numpy(p), torch.from_numpy(q))),
        float(jax_sm.kl_divergence(jnp.asarray(p), jnp.asarray(q))),
        rtol=1e-5)
    pairs = [(discrete(s, 40), discrete(s + 7, 30)) for s in range(3)]
    pairs.append((np.zeros(0, np.float32), discrete(1, 5)))
    ours, theirs = sm.pairs_kl_divergence(pairs), \
        jax_sm.pairs_kl_divergence(pairs)
    assert np.isnan(ours[3]) and np.isnan(theirs[3])
    np.testing.assert_allclose(ours[:3], theirs[:3], rtol=1e-5)


# ---- the literals of tests/test_elephant_parity.py --------------------------

def test_elephant_firing_rate_and_binning_literals():
    rate = float(sm.mean_firing_rate(train(240, [0, 10, 100])[None])[0])
    np.testing.assert_allclose(rate, 0.3, rtol=1e-6)  # 3 / 10 s
    rate = float(sm.mean_firing_rate(train(240, [0, 10, 239])[None])[0])
    np.testing.assert_allclose(rate, 0.3, rtol=1e-6)
    counts = sm.bin_spike_counts(train(30, [0, 11, 12, 25])[None])[0]
    np.testing.assert_array_equal(counts.numpy(), [2, 1])


def test_elephant_correlation_and_covariance_literals():
    pair = np.stack([train(30, [0, 11, 12]), train(30, [3, 13, 14, 15])])
    np.testing.assert_allclose(sm.correlation_coefficients(pair).numpy(),
                               [[1.0, -1.0], [-1.0, 1.0]], atol=1e-6)
    np.testing.assert_allclose(sm.covariance(pair).numpy(),
                               [[0.5, -1.0], [-1.0, 2.0]], atol=1e-6)


@pytest.mark.parametrize("u,v,T,tau,expected,atol", [
    ([0], [], 48, 1.0, 1.0, 1e-6),
    ([0], [24], 72, 1.0, float(np.sqrt(2.0 - 2.0 * np.exp(-1.0))), 1e-6),
    ([0, 20], [10], 48, 1e-4, float(np.sqrt(3.0)), 1e-4),
    ([3, 17, 40], [3, 17, 40], 48, 1.0, 0.0, 1e-4),
])
def test_elephant_van_rossum_literals(u, v, T, tau, expected, atol):
    pair = np.stack([train(T, u), train(T, v)])
    d = float(sm.van_rossum_distance(pair, tau=tau)[0, 1])
    np.testing.assert_allclose(d, expected, atol=atol)


def test_elephant_victor_purpura_literals():
    T = 96  # 4 s
    batch = np.stack([train(T, [0]), train(T, [12]), train(T, []),
                      train(T, [60]), train(T, [0, 24])])
    d = sm.victor_purpura_distance(batch).numpy()
    np.testing.assert_allclose(d[0, 1:], [0.5, 1.0, 2.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-6)


def test_elephant_cross_block_slice_pattern():
    rng = np.random.default_rng(1234)
    real = (rng.random((3, 48)) < 0.1).astype(np.float32)
    fake = (rng.random((3, 48)) < 0.1).astype(np.float32)
    full = sm.van_rossum_distance(np.concatenate([real, fake])).numpy()
    cross = sm.van_rossum_distance(real, fake).numpy()
    np.testing.assert_allclose(cross, full[len(real):, :len(fake)],
                               atol=1e-5)
