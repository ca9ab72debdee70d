"""Where the OASIS kernel keeps each trace's ring of pool slots, on the CPU.

``oasis_cuda.launch_plan(D, precise)`` picks shared memory (one warp of
traces per block) wherever that fits and device memory elsewhere. The
kernel itself runs only on the card; its arithmetic is held to the plain
twin by the twin's parity tests and, on the card, by ``chip_smoke.py``.
Here: every rung of both depth ladders gets a plan the card accepts, the
shared storage is taken exactly where 32 lanes fit, the wrapper's scratch
follows the plan, and the C entry points take the arguments the wrapper
declares.
"""

import os
import re

import pytest
import torch

from calciumgan_tpu_torch.ops import oasis as oasis_dispatch
from calciumgan_tpu_torch.ops import oasis_cuda, oasis_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_BYTES_PER_SLOT = 12  # three float32 fields, both machines


def _rungs():
    cases = [(2048, d) for d in oasis_dispatch._DEPTH_LADDER]
    for T in (2048, 20000, 40000):
        cases += [(T, d) for d in oasis_dispatch._long_ladder(T)]
    return cases


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("T,depth", _rungs())
def test_plan_of_every_rung(T, depth, precise):
    D = oasis_torch.stack_depth(T, depth)
    plan = oasis_cuda.launch_plan(D, precise)
    assert plan.lanes % 32 == 0 and 0 < plan.lanes <= 1024
    assert plan.shared_bytes <= oasis_cuda.SHARED_BYTES_MAX
    fits = 32 * RING_BYTES_PER_SLOT * D <= oasis_cuda.SHARED_BYTES_MAX
    assert plan.storage == ("shared" if fits else "device")
    if fits:
        assert plan.lanes == 32
        assert plan.shared_bytes == RING_BYTES_PER_SLOT * D * plan.lanes
    else:
        assert plan.shared_bytes == 0
    B = 102
    scratch = oasis_cuda.ring_scratch(plan, D, B, "cpu")
    assert scratch.dtype == torch.float32
    assert tuple(scratch.shape) == ((0,) if fits else (3, D, B))


def test_first_rungs_of_both_paths_take_shared_memory():
    # serving's first rung (sl2048, D 64) and a whole recording's (20,000
    # frames, D 512); D 1024 and 2048 keep the device-memory ring
    assert oasis_cuda.launch_plan(64, False).storage == "shared"
    assert oasis_cuda.launch_plan(
        oasis_dispatch._long_ladder(20000)[0], True).storage == "shared"
    assert oasis_cuda.launch_plan(512, True).shared_bytes == 196_608
    for D in (1024, 2048):
        assert oasis_cuda.launch_plan(D, True).storage == "device"
    largest = max(d for d in range(8, 4096, 8) if oasis_cuda.launch_plan(
        d, True).storage == "shared")
    assert largest == 600  # 32 lanes x 12 B x 605 slots is the limit


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
