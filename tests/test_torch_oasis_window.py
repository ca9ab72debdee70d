"""The OASIS kernel's ring storages on the card.

A ring that does not fit whole in shared memory, or whose launch would not
fit in one wave of whole rings, lives in device memory behind a window of
its top stack positions in shared memory (``oasis_cuda.launch_plan``). The
kernel must still equal its plain twin (``oasis_torch.oasis_ar1_torch``,
run on the same card) bit for bit: ``c``, ``s`` and the redo word on every
lane, overflowed lanes included, on both machines, however often the
window slides; and so must the whole ring the plan keeps for small
launches of deep rings. The window is taken for these tests' small batches
by planning for a card with no SMs to spare (the ``windows`` fixture).
Each lane's ``moves`` (the ring slots moved between its window and its
ring) is checked where it is known exactly. The tests marked ``card`` skip
without an NVIDIA GPU. This file imports no JAX, so that on the card it
runs alone: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_oasis_window.py -q``.
"""

import collections

import numpy as np
import pytest
import torch

from calciumgan_tpu_torch.ops import golden
from calciumgan_tpu_torch.ops import oasis as dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch
from calciumgan_tpu_torch.utils import tracing
from test_torch_oasis_exact import served_traces

G, S_MIN, THRESHOLD = 0.95, 0.55, 0.5
K = dispatch._MERGE_BUDGET


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def own_launch_counts(monkeypatch):
    # this file's launches (the dispatch's redo among them) stay its own:
    # other files on the card read the process's counts
    monkeypatch.setattr(oasis_cuda, "launches", collections.Counter())


@pytest.fixture
def windows(monkeypatch):
    # plan as for a card whose SMs are all taken: no launch fits in one
    # wave of whole rings, so every ring deeper than WINDOW takes the window
    monkeypatch.setattr(oasis_cuda, "sm_count", lambda device: 0)


def climb_and_fall(T: int, up: int, down: int) -> np.ndarray:
    """Rises by a pool a frame for ``up`` frames, then falls for ``down``
    (each frame's pool and two below it merge: a pool fewer a frame, redo
    bit 1), over and over: the stack climbs past the window's top and
    falls back through its bottom, where every merge writes the window's
    top slot back and fills the slot below it."""
    period = np.concatenate([0.6 * np.arange(up), -40.0 * np.ones(down)])
    return np.resize(period, T).astype(np.float32)


def traces(T: int, W: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng([seed, T, W])
    ramp = 0.6 * np.arange(T, dtype=np.float32)  # a pool a frame: overflows
    return np.concatenate([
        golden.synth_ar1_traces(rng, 20, T),
        3.0 * rng.random((6, T)),
        ramp[None], -ramp[None],
        climb_and_fall(T, 3 * W, 2 * W)[None],
        climb_and_fall(T, W + 5, W + 3)[None],
        climb_and_fall(T, W // 2, W // 4)[None],
        np.zeros((1, T)),  # one pool
    ]).astype(np.float32)


def kernel_and_twin(y: np.ndarray, D: int, precise: bool, **kw):
    """The kernel (``moves`` too) and the twin on the card, same args."""
    signals = torch.from_numpy(y).cuda()
    args = dict(g=G, lam=0.0, s_min=S_MIN, depth=D, merge_attempts=K,
                flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD, precise),
                precise=precise)
    args.update(kw)
    moves = torch.full((len(y),), -1, dtype=torch.int32, device="cuda")
    found = oasis_cuda.oasis_ar1(signals, moves=moves, **args)
    expected = oasis_torch.oasis_ar1_torch(signals, **args)
    return found, expected, moves.cpu().numpy()


def assert_bit_for_bit(found, expected):
    for a, b in zip(found, expected):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_entry_reports_no_moves():
    # the plain version keeps whole rings: nothing moves
    y = torch.from_numpy(traces(300, 64))
    moves = torch.full((len(y),), -1, dtype=torch.int32)
    oasis_cuda.oasis_ar1(y, g=G, s_min=S_MIN, depth=160, moves=moves)
    assert moves.tolist() == [0] * len(y)


@pytest.mark.card
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D", [160, 256, 384, 768, 1536])
def test_windowed_kernel_equals_the_twin(card, windows, D, precise):
    W = oasis_cuda.WINDOW
    y = traces(2048, W, D)
    before = collections.Counter(oasis_cuda.launches)
    found, expected, moves = kernel_and_twin(y, D, precise)
    assert_bit_for_bit(found, expected)
    assert list(oasis_cuda.launches - before) == [
        ("oasis_ar1_precise" if precise else "oasis_ar1") + "/window"]
    redo = found[2].cpu().numpy()
    assert redo[26] & 1 and redo[28] & 2  # the ramp overflows; a fall
    # a push a frame: the window slides up once a frame from the
    # frame whose pool lies past its top (it starts 3 below position 0)
    assert moves[26] == 2048 - W + 3
    # a falling ramp and a zero trace keep one pool: the stack never
    # leaves the window
    assert moves[27] == moves[31] == 0
    assert (moves[28:31] > 0).all()  # climbs and falls


@pytest.mark.card
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D", [160, 384, 512, 600])
def test_whole_ring_kernel_equals_the_twin(card, D, precise):
    # a few warps of deep rings: one wave of whole rings holds them
    y = traces(2048, oasis_cuda.WINDOW, D)
    before = collections.Counter(oasis_cuda.launches)
    found, expected, moves = kernel_and_twin(y, D, precise)
    assert_bit_for_bit(found, expected)
    assert list(oasis_cuda.launches - before) == [
        ("oasis_ar1_precise" if precise else "oasis_ar1") + "/shared"]
    assert found[2].cpu().numpy()[26] & 1  # the ramp overflows
    assert (moves == 0).all()


@pytest.mark.card
@pytest.mark.parametrize("D", [384, 768])
def test_windowed_kernel_on_the_served_model(card, monkeypatch, D):
    y = served_traces("sl16384-generate")  # 16,320 x 16,384
    signals = torch.from_numpy(y).cuda()
    moves = torch.empty(len(y), dtype=torch.int32, device="cuda")
    kw = dict(g=G, lam=0.0, s_min=S_MIN, depth=D, merge_attempts=K,
              precise=True, flag_tol=dispatch._flag_tol(S_MIN, THRESHOLD,
                                                        True))
    before = collections.Counter(oasis_cuda.launches)
    _, _, redo = oasis_cuda.oasis_ar1(signals, moves=moves, **kw)
    assert list(oasis_cuda.launches - before) == [
        "oasis_ar1_long_precise/window"]
    redo, moved = redo.cpu().numpy(), moves.cpu().numpy()
    # the twin's time is set by frames: the lanes that moved most, some
    # that overflowed, and a spread of the rest
    rng = np.random.default_rng(D)
    rows = np.unique(np.concatenate([
        np.argsort(moved)[-24:], np.nonzero(redo & 1)[0][:16],
        rng.choice(len(y), 24, replace=False)]))
    # the rows alone would fit one wave of whole rings: held to the window
    monkeypatch.setattr(oasis_cuda, "sm_count", lambda device: 0)
    found, expected, sub_moves = kernel_and_twin(y[rows], D, True)
    assert_bit_for_bit(found, expected)
    np.testing.assert_array_equal(sub_moves, moved[rows])
    assert moved.max() > 0
    # the window engages on a few frames in a hundred at most
    assert moved.sum() < 0.05 * y.size


@pytest.mark.card
def test_dispatch_counts_the_window_moves(card, windows):
    y = traces(2048, oasis_cuda.WINDOW)
    signals = torch.from_numpy(y).cuda()
    moves = torch.empty(len(y), dtype=torch.int32, device="cuda")
    oasis_cuda.oasis_ar1(signals, g=G, lam=0.0, s_min=S_MIN, depth=256,
                         merge_attempts=K, flag_tol=dispatch._flag_tol(
                             S_MIN, THRESHOLD), moves=moves)
    before = collections.Counter(tracing.totals)
    dispatch.deconvolve_signals_host(signals, depth=256)
    counted = tracing.totals - before
    assert counted["oasis/window_moves"] == int(moves.sum()) > 0
    # a whole ring moves nothing
    before = collections.Counter(tracing.totals)
    dispatch.deconvolve_signals_host(signals, depth=64)
    assert tracing.totals["oasis/window_moves"] == before[
        "oasis/window_moves"]
