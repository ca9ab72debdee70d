"""The exact float64 redo of flagged OASIS traces on the card.

``oasis_cuda.oasis_exact_f64`` (the CUDA kernel ``oasis_exact_f64_kernel``
for a CUDA tensor, its plain PyTorch twin ``oasis_exact_f64_torch`` for a
CPU one) must give the spikes of the C++ ``cg_deconvolve_batch``
(``oasis._exact_spikes_host``) bit for bit: no tolerance. The CPU tests hold
the twin and the host table of ``g^l`` to it; the tests marked ``card``
hold the kernel and the dispatch to it on an NVIDIA GPU and skip without
one. This file imports no JAX, so that on the card it runs alone:
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_oasis_exact.py -q``.
"""

import collections
import ctypes

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch.ops import golden
from calciumgan_tpu_torch.ops import oasis as dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
from calciumgan_tpu_torch.utils import tracing

G, S_MIN, THRESHOLD = 0.95, 0.55, 0.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def band_edge(rng, n: int, T: int) -> np.ndarray:
    """Rows whose every frame sits within a few float32 ulps of the
    decision ``y[t+1] >= g*y[t] + s_min`` against the frame before, and
    drops to a fresh start every 16 frames: the float32 machine flags them
    as borderline (redo bit 2)."""
    y = np.empty((n, T), np.float32)
    for i in range(n):
        for t in range(T):
            if t % 16 == 0:
                y[i, t] = rng.uniform(0.0, 2.0)
                continue
            x = np.float32(G * np.float64(y[i, t - 1]) + S_MIN)
            for _ in range(rng.integers(3)):
                x = np.nextafter(x, np.float32(rng.choice([-1, 1]) * 1e9))
            y[i, t] = x
    return y


def case(name: str, T: int) -> np.ndarray:
    rng = np.random.default_rng([17, T, len(name)])
    if name == "random":
        return (3.0 * rng.random((12, T))).astype(np.float32)
    if name == "spiky":
        return golden.synth_ar1_traces(rng, 12, T).astype(np.float32)
    if name == "mixed":
        return np.concatenate([golden.synth_ar1_traces(rng, 4, T),
                               rng.random((4, T))]).astype(np.float32)
    if name == "ramp":  # increments 0.6 > s_min: T pools, no merge
        return (0.6 * np.arange(T, dtype=np.float32))[None].repeat(2, 0)
    if name == "constant":
        return np.array([1.0, -1.0, 5.5, 0.55], np.float32)[:, None].repeat(
            T, 1)
    if name == "zero":
        return np.stack([np.zeros(T, np.float32), -np.zeros(T, np.float32)])
    if name == "band_edge":
        return band_edge(rng, 6, T)
    raise ValueError(name)


CASES = [("random", 200), ("spiky", 300), ("ramp", 257), ("constant", 100),
         ("zero", 100), ("band_edge", 256), ("random", 1), ("random", 2),
         ("random", 3), ("mixed", 2048)]
IDS = [f"{name}-{T}" for name, T in CASES]


def exact_host(y: np.ndarray) -> np.ndarray:
    return dispatch._exact_spikes_host(y, G, S_MIN, THRESHOLD)


def cxx_oasis(row: np.ndarray):
    """``(c, s)`` of one trace by the host library's ``cg_oasis_ar1``."""
    fn = dispatch.host_library().lib.cg_oasis_ar1
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_double] * 3 \
        + [ctypes.c_void_p] * 2
    fn.restype = None
    y = np.ascontiguousarray(row, np.float64)
    c, s = np.empty_like(y), np.empty_like(y)
    fn(y.ctypes.data, len(y), G, 0.0, S_MIN, c.ctypes.data, s.ctypes.data)
    return c, s


@pytest.mark.parametrize("name,T", CASES, ids=IDS)
def test_twin_equals_the_host_cxx(name, T):
    # every float64 bit of c and s, and so the spikes
    y = case(name, T)
    c, s = oasis_cuda.oasis_exact_f64_torch(torch.from_numpy(y), G, S_MIN)
    assert c.dtype == s.dtype == torch.float64 and s.shape == y.shape
    for i, row in enumerate(y):
        c_ref, s_ref = cxx_oasis(row)
        assert c[i].numpy().tobytes() == c_ref.tobytes()
        assert s[i].numpy().tobytes() == s_ref.tobytes()
    np.testing.assert_array_equal((s.numpy() > THRESHOLD).astype(np.int8),
                                  exact_host(y))


def test_band_edge_rows_are_flagged_borderline():
    # what the case is for: the float32 machine cannot decide these rows
    y = case("band_edge", 256)
    _, _, redo = oasis_torch.oasis_ar1_torch(
        torch.from_numpy(y), g=G, s_min=S_MIN, depth=64,
        merge_attempts=dispatch._MERGE_BUDGET,
        flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD))
    assert ((redo.numpy() & 4) != 0).all()


def test_ramp_needs_a_pool_a_frame():
    # the ramp's spikes say every frame opened a pool: s = 0.6*t - g*0.6*(t-1)
    y = case("ramp", 257)
    np.testing.assert_array_equal(exact_host(y)[:, 1:], 1)


@pytest.mark.parametrize("g,T", [(0.95, 2048), (0.9, 16_384), (0.5, 3)])
def test_the_pow_table_is_numpy_g_to_the_k(g, T):
    # numpy's scalar power is libm's pow; its vectorised power may take
    # another pow (SVML on AVX-512 hosts), which is why the table exists
    table = oasis_cuda.pow_table(g, T, "cpu")
    assert table.dtype == torch.float64 and table.shape == (T + 1,)
    expect = np.array([np.float64(g) ** k for k in range(T + 1)])
    np.testing.assert_array_equal(table.numpy(), expect)
    assert oasis_cuda.pow_table(g, T, "cpu") is table  # kept per (g, T)


def test_cpu_entry_writes_its_rows_of_a_time_major_tensor():
    y = case("mixed", 200)
    spikes = torch.full((200, len(y)), 7, dtype=torch.int8).t()  # (n, T)
    rows = torch.tensor([0, 3, 5], dtype=torch.int64)
    oasis_cuda.oasis_exact_f64(torch.from_numpy(y), rows, spikes, G, S_MIN,
                               THRESHOLD)
    np.testing.assert_array_equal(spikes.numpy()[[0, 3, 5]],
                                  exact_host(y[[0, 3, 5]]))
    assert (spikes.numpy()[[1, 2, 4, 6, 7]] == 7).all()
    assert not oasis_cuda.launches["oasis_exact_f64/device"]


@pytest.mark.parametrize("T", [256, 4100])
def test_cpu_tensors_keep_the_host_redo(monkeypatch, T):
    # a CPU tensor's flagged rows go to the C++ kernel on the host, never
    # to the float64 twin, and launch no redo on the card
    monkeypatch.setattr(dispatch, "_BORDERLINE_TOL", 1.0)  # flag them all
    seen, card_calls = [], []
    real = dispatch._exact_spikes_host

    def spy(rows, *args):
        seen.append(len(rows))
        return real(rows, *args)

    monkeypatch.setattr(dispatch, "_exact_spikes_host", spy)
    monkeypatch.setattr(oasis_cuda, "oasis_exact_f64",
                        lambda *a, **k: card_calls.append(a))
    y = case("mixed", T)
    before = collections.Counter(oasis_cuda.launches)
    spikes = dispatch.deconvolve_signals_host(torch.from_numpy(y))
    assert seen == [len(y)] and not card_calls
    assert (oasis_cuda.launches - before)["oasis_exact_f64/device"] == 0
    np.testing.assert_array_equal(spikes, real(y, G, S_MIN, THRESHOLD))


# ---- on the card --------------------------------------------------------


def card_redo(y: np.ndarray, rows=None) -> np.ndarray:
    """The kernel's spikes of ``y[rows]`` (every row by default), written
    into a zeroed time-major int8 tensor as serving's is."""
    signals = torch.from_numpy(y).cuda()
    rows = np.arange(len(y)) if rows is None else np.asarray(rows)
    spikes = torch.zeros((y.shape[1], len(y)), dtype=torch.int8,
                         device="cuda").t()
    oasis_cuda.oasis_exact_f64(signals, torch.from_numpy(rows).cuda(),
                               spikes, G, S_MIN, THRESHOLD)
    torch.cuda.synchronize()
    return spikes.cpu().numpy()[rows]


@pytest.mark.card
@pytest.mark.parametrize("name,T", CASES, ids=IDS)
def test_kernel_equals_the_host_cxx(card, name, T):
    y = case(name, T)
    before = oasis_cuda.launches["oasis_exact_f64/device"]
    np.testing.assert_array_equal(card_redo(y), exact_host(y))
    assert oasis_cuda.launches["oasis_exact_f64/device"] == before + 1


@pytest.mark.card
def test_kernel_across_chunks_of_the_scratch(card, monkeypatch):
    y = case("mixed", 2048)
    y = np.concatenate([y, case("band_edge", 2048), y[::-1]])
    monkeypatch.setattr(oasis_cuda, "_EXACT_SCRATCH_BYTES",
                        oasis_cuda._EXACT_SLOT_BYTES * 2048 * 3)  # 3 rows
    rows = [0, 2, 3, 5, 6, 7, 9, 10, 13, 14, 15, 19]
    before = oasis_cuda.launches["oasis_exact_f64/device"]
    np.testing.assert_array_equal(card_redo(y, rows), exact_host(y[rows]))
    assert oasis_cuda.launches["oasis_exact_f64/device"] == before + 4


def served_traces(cell: str, batches: int = 1) -> np.ndarray:
    """``(n * C, T)`` traces of the benchmark's served model of ``cell``:
    its seeded weights and one batch of its mix, as ``h100bench`` serves
    them."""
    from calciumgan_tpu_torch import generate
    from h100bench import program, registry
    from h100bench.loops.generate import served_weights

    spec = registry.cell(cell)
    cfg, mix = spec["config_data"], spec["traffic_data"]
    gen_w = served_weights(cfg, torch.device("cuda"))
    config = program.port_config(cfg, mix, 2 ** 33 + 17)
    payload = next(generate.generate(
        config, program.generator_variables(gen_w),
        num_samples=mix["batch_size"], batch_size=mix["batch_size"],
        seed=2 ** 33 + 19, device="cuda"))
    signals = payload["signals"]  # (n, T, C)
    return np.ascontiguousarray(signals.transpose(0, 2, 1)).reshape(
        -1, signals.shape[1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sl2048-generate", "sl16384-generate"])
def test_kernel_on_the_served_models_flagged_rows(card, cell):
    y = served_traces(cell)
    T = y.shape[1]
    long = T > dispatch._PALLAS_MAX_T
    entry = oasis_cuda.oasis_ar1_long if long else oasis_cuda.oasis_ar1
    ladder = dispatch._long_ladder(T) if long else dispatch._DEPTH_LADDER
    _, _, redo = entry(torch.from_numpy(y).cuda(), g=G, lam=0.0,
                       s_min=S_MIN, depth=ladder[0],
                       merge_attempts=dispatch._MERGE_BUDGET, precise=long,
                       flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD, long))
    rows = np.nonzero(redo.cpu().numpy())[0]
    assert rows.size > 0.01 * len(y)  # the served model flags many rows
    np.testing.assert_array_equal(card_redo(y, rows), exact_host(y[rows]))


@pytest.mark.card
@pytest.mark.parametrize("T", [2048, 16_384])
def test_dispatch_card_redo_equals_host_redo(card, monkeypatch, T):
    rng = np.random.default_rng(T)
    y = np.concatenate([golden.synth_ar1_traces(rng, 300, T),
                        rng.random((40, T))]).astype(np.float32)
    signals = torch.from_numpy(y).cuda()
    before = collections.Counter(tracing.totals)
    launched = collections.Counter(oasis_cuda.launches)
    on_card = dispatch.deconvolve_signals_host(signals)
    totals = tracing.totals - before
    assert totals["oasis/flagged"] > 0
    # one launch a chunk of rows; a chunk holds 26,214 rows at 2048 frames
    # and 3,276 at 16,384, more than this batch flags
    assert (oasis_cuda.launches - launched)["oasis_exact_f64/device"] == 1

    def host_redo(signals, rows, spikes, g, s_min, threshold):
        idx = rows.cpu().numpy()
        exact = dispatch._exact_spikes_host(signals.cpu().numpy()[idx], g,
                                            s_min, threshold)
        spikes[rows] = torch.from_numpy(exact).to(spikes.device)

    monkeypatch.setattr(oasis_cuda, "oasis_exact_f64", host_redo)
    on_host = dispatch.deconvolve_signals_host(signals)
    assert on_card.dtype == on_host.dtype == np.int8
    np.testing.assert_array_equal(on_card, on_host)
    np.testing.assert_array_equal(on_card, exact_host(y))
