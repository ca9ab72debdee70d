"""Where the OASIS kernel keeps each trace's ring of pool slots, on the CPU.

``oasis_cuda.launch_plan(D, precise, B, sms)`` keeps a ring whole in shared
memory (one warp of traces per block) wherever it is no deeper than
``WINDOW`` slots, or fits in a block and the launch's blocks are all
resident at once on the card's SMs; any other ring lives in a device-memory
scratch behind a window of ``WINDOW`` stack positions in shared memory.
The kernel itself runs only on the card; its arithmetic is held to the
plain twin by the twin's parity tests and, on the card, by
``tests/test_torch_oasis_window.py`` and ``chip_smoke.py``. Here: every
rung of both depth ladders gets a plan the card accepts for the launches
that reach it, the whole ring is taken exactly where one wave of it holds
the launch, the wrapper's scratch follows the plan, and the C entry points
take the arguments the wrapper declares.
"""

import os
import re

import pytest
import torch

from calciumgan_tpu_torch.ops import oasis as oasis_dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_BYTES_PER_SLOT = 12  # three float32 fields, both machines
SMS = 132  # an H100 SXM's SMs


def _rungs():
    cases = [(2048, d) for d in oasis_dispatch._DEPTH_LADDER]
    for T in (2048, 20000, 40000):
        cases += [(T, d) for d in oasis_dispatch._long_ladder(T)]
    return cases


def _resident_whole_rings(D: int) -> int:
    # one-warp blocks of whole rings resident at once on the card
    per_block = RING_BYTES_PER_SLOT * D * 32 + oasis_cuda.BLOCK_RESERVED_BYTES
    return SMS * (oasis_cuda.SM_SHARED_BYTES // per_block)


# a recording (102 neurons), a served batch at 16,384 frames, at 2048
@pytest.mark.parametrize("B", [102, 16_320, 104_448])
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("T,depth", _rungs())
def test_plan_of_every_rung(T, depth, precise, B):
    D = oasis_torch.stack_depth(T, depth)
    plan = oasis_cuda.launch_plan(D, precise, B, SMS)
    assert plan.lanes == 32
    assert plan.shared_bytes <= oasis_cuda.SHARED_BYTES_MAX
    assert plan.shared_bytes == RING_BYTES_PER_SLOT * plan.window * plan.lanes
    whole = plan.storage == "shared"
    fits = RING_BYTES_PER_SLOT * D * 32 <= oasis_cuda.SHARED_BYTES_MAX
    one_wave = fits and -(-B // 32) <= _resident_whole_rings(D)
    assert whole == (D <= oasis_cuda.WINDOW or one_wave)
    if whole:
        assert plan.window == D
    else:
        # a power of two under D, so the window never holds two positions
        # of one ring slot
        W = plan.window
        assert plan.storage == "window"
        assert W == oasis_cuda.WINDOW and 4 <= W < D and W & (W - 1) == 0
    scratch = oasis_cuda.ring_scratch(plan, D, B, "cpu")
    assert scratch.dtype == torch.float32
    assert tuple(scratch.shape) == ((0,) if whole else (3, D, B))


def test_first_rungs_of_both_paths_take_shared_memory():
    # serving's first rung at 2048 frames (D 64) keeps its whole ring there
    # for any batch; a whole recording's (102 x 20,000, D 512) and a
    # 2048-trace batch of them too, one block an SM in one wave. A served
    # batch at 16,384 frames (16,320 traces) would take four waves of
    # whole rings at D 384: it takes the window, of the same bytes at
    # every depth
    for B in (1, 102, 16_320, 104_448):
        assert oasis_cuda.launch_plan(64, False, B, SMS) == (
            oasis_cuda.LaunchPlan("shared", 32, 64, 24_576))
    first_long = oasis_dispatch._long_ladder(20000)[0]
    assert first_long == 512
    for B in (102, 2048):
        assert oasis_cuda.launch_plan(first_long, True, B, SMS) == (
            oasis_cuda.LaunchPlan("shared", 32, 512, 196_608))
    window = oasis_cuda.launch_plan(384, True, 16_320, SMS)
    assert window == oasis_cuda.LaunchPlan("window", 32, 64, 24_576)
    for D in (160, 256, 384, 768, 1024, 1536, 2048):
        assert oasis_cuda.launch_plan(D, True, 104_448, SMS) == window
        assert oasis_cuda.launch_plan(D, False, 104_448, SMS) == window
    largest = max(d for d in range(8, 4096, 8) if oasis_cuda.launch_plan(
        d, True, 1, SMS).storage == "shared")
    assert largest == 600


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D", [8, 16, 24, 56, 64])
def test_shallow_rings_keep_the_whole_ring_plan(D, precise):
    # the plan of every ring of up to 64 slots, byte for byte, whatever
    # the launch and the card
    for B, sms in ((5, SMS), (10 ** 6, SMS), (5, 0)):
        plan = oasis_cuda.launch_plan(D, precise, B, sms)
        assert plan == oasis_cuda.LaunchPlan("shared", 32, D, 12 * D * 32)
        assert oasis_cuda.ring_scratch(plan, D, B, "cpu").numel() == 0


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D", [72, 160, 256, 384, 512, 768, 1536, 2048])
def test_window_plan_fits_and_takes_the_device_ring(D, precise):
    # more traces than one wave of whole rings holds, at every depth
    B = 2 * 32 * _resident_whole_rings(D) + 37
    plan = oasis_cuda.launch_plan(D, precise, B, SMS)
    assert plan.storage == "window"
    assert plan.lanes % 32 == 0 and 0 < plan.lanes <= 1024
    # the window's bytes a block: within what one block may opt into, and
    # at most a quarter of it, so four warps' windows share an SM
    assert plan.shared_bytes == 12 * plan.window * plan.lanes
    assert 4 * 12 * plan.window * 32 <= oasis_cuda.SHARED_BYTES_MAX
    assert plan.shared_bytes <= oasis_cuda.SHARED_BYTES_MAX
    scratch = oasis_cuda.ring_scratch(plan, D, B, "cpu")
    assert scratch.dtype == torch.float32 and tuple(scratch.shape) == (3, D, B)


@pytest.mark.parametrize("D", [384, 768])
def test_served_traces_at_16384_frames_take_one_wave(D):
    # sl16384-generate's 16,320 traces at both of its rungs: every block
    # resident at once on the card's 132 SMs, where a whole ring of D 384
    # left room for one block an SM (four waves)
    plan = oasis_cuda.launch_plan(D, True, 16_320, SMS)
    assert plan.storage == "window"
    blocks = -(-16_320 // plan.lanes)
    per_sm = oasis_cuda.SM_SHARED_BYTES // (
        plan.shared_bytes + oasis_cuda.BLOCK_RESERVED_BYTES)
    assert blocks <= SMS * per_sm
    assert -(-16_320 // 32) > _resident_whole_rings(384)


# on each side of the line: the most traces one wave of whole rings holds
# (1, 2 or 3 one-warp blocks an SM), and a trace more
@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D,blocks_per_sm", [
    (65, 8), (160, 3), (256, 2), (384, 1), (512, 1), (600, 1)])
def test_whole_ring_wherever_one_wave_holds_the_launch(D, blocks_per_sm,
                                                       precise):
    most = 32 * SMS * blocks_per_sm
    assert _resident_whole_rings(D) == SMS * blocks_per_sm
    for B in (1, 102, most - 31, most):
        plan = oasis_cuda.launch_plan(D, precise, B, SMS)
        assert plan == oasis_cuda.LaunchPlan("shared", 32, D, 12 * D * 32)
    for B in (most + 1, most + 32, 4 * most):
        assert oasis_cuda.launch_plan(D, precise, B, SMS).storage == "window"
    # a card with fewer SMs holds fewer traces in one wave
    assert oasis_cuda.launch_plan(D, precise, most, SMS // 2).storage == (
        "window")


@pytest.mark.parametrize("D", [606, 768, 4096])
def test_rings_past_a_block_take_the_window(D):
    # a whole ring past 232,448 B cannot launch, even for one trace
    assert oasis_cuda.launch_plan(D, True, 1, SMS).storage == "window"


_C_TYPES = {"const float*": "p", "float*": "p", "int*": "p", "void*": "p",
            "int": "i", "float": "f"}


def _c_signature(name: str) -> list:
    with open(os.path.join(ROOT, "calciumgan_tpu_torch", "csrc",
                           "oasis_ar1.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")] for p in params]


@pytest.mark.parametrize("name,argtypes", [
    ("oasis_ar1_launch", oasis_cuda._CLASSIC_ARGTYPES),
    ("oasis_ar1_precise_launch", oasis_cuda._PRECISE_ARGTYPES)])
def test_c_entry_points_match_the_declared_argtypes(name, argtypes):
    import ctypes
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert _c_signature(name) == [kinds[a] for a in argtypes]
