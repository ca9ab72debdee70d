"""The OASIS kernel's source run on the host: windows against whole rings.

``csrc/oasis_ar1.cu`` is compiled here with ``g++`` under stand-ins for
CUDA's built-ins (each block's threads run one after another: the kernel's
lanes are independent and it has no barrier), so that the state machine of
a windowed ring runs on the CPU. Its window must give what the whole ring
in shared memory gives, bit for bit (``c``, ``s`` and the redo word on
every lane, overflowed lanes included) on both machines, for windows far
smaller than the ring and rings only a slot deeper than the window; each
lane's moves must be those of the window's rule. The host's ``expf`` is not
the card's, so this says nothing of the kernel against its plain twin: the
card tests (``test_torch_oasis_window.py``) do.
"""

import ctypes
import math
import re
import subprocess

import numpy as np
import pytest

from calciumgan_tpu_torch.kernels import build
from calciumgan_tpu_torch.ops import golden, oasis_cuda, oasis_torch

# what the source takes from CUDA, for one thread at a time on the host
STAND_INS = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
struct Dim { int x; };
static Dim blockIdx, blockDim, threadIdx;
static float* ring_smem;
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct __nv_bfloat16 { float f; };
inline __nv_bfloat16 __float2bfloat16_rn(float x) {  // nearest even
  uint32_t u;
  memcpy(&u, &x, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&x, &u, 4);
  return {x};
}
inline float __bfloat162float(__nv_bfloat16 x) { return x.f; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
template <typename K, typename... A>
void launch_on_host(K kernel, int blocks, int lanes, int shared_bytes,
                    cudaStream_t, A... args) {
  std::vector<float> shared(shared_bytes / 4 + 1);
  blockDim.x = lanes;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    ring_smem = shared.data();
    for (int t = 0; t < lanes; ++t) {
      threadIdx.x = t;
      kernel(args...);
    }
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    src = (build.CSRC / "oasis_ar1.cu").read_text()
    src = re.sub(r"#include <cuda\w*\.h>\n", "", src)
    src = src.replace("extern __shared__ float ring_smem[];", "")
    # kernel<<<grid, block, shared, stream>>>(args) -> a loop over threads
    src, launches = re.subn(r"(\w+(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\(",
                            r"launch_on_host(\1, \2, ", src)
    assert launches == 2
    path = tmp_path_factory.mktemp("host") / "oasis_ar1_host.cc"
    path.write_text(STAND_INS + src)
    out = path.with_suffix(".so")
    subprocess.run([build.gxx(), "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(out), str(path)],
                   check=True, capture_output=True)
    built = ctypes.CDLL(str(out))
    for name, argtypes in (("oasis_ar1_launch", oasis_cuda._CLASSIC_ARGTYPES),
                           ("oasis_ar1_precise_launch",
                            oasis_cuda._PRECISE_ARGTYPES)):
        getattr(built, name).argtypes = argtypes
        getattr(built, name).restype = ctypes.c_int
    return built


def run(lib, y, D, window, lanes, precise, K=2, s_min=0.55, g=0.95,
        shared_bytes=None):
    """The launch on ``(B, T)`` traces: ``(err, c, s, redo, moves)``."""
    B, T = y.shape
    yy = np.ascontiguousarray(y.T, np.float32)
    c, s = np.zeros((T, B), np.float32), np.zeros((T, B), np.float32)
    redo, moves = np.zeros(B, np.int32), np.full(B, -1, np.int32)
    stacks = np.full(3 * D * B, np.nan, np.float32)  # never read unwritten
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    args = [yy.ctypes.data, c.ctypes.data, s.ctypes.data, redo.ctypes.data,
            moves.ctypes.data, stacks.ctypes.data, T, B, D, f32(g),
            f32(math.log(g)), f32(s_min), K, f32(1e-5)]
    fn = lib.oasis_ar1_launch
    if precise:
        fn = lib.oasis_ar1_precise_launch
        args += oasis_torch.precise_constants(g)
    if shared_bytes is None:
        shared_bytes = 12 * window * lanes
    err = fn(*args, window, lanes, shared_bytes, None)
    return err, c.T, s.T, redo, moves


def climb_and_fall(T, up, down):
    period = np.concatenate([0.6 * np.arange(up), -40.0 * np.ones(down)])
    return np.resize(period, T)


def traces(T, W, seed):
    rng = np.random.default_rng([seed, T, W])
    ramp = 0.6 * np.arange(T)
    return np.concatenate([
        golden.synth_ar1_traces(rng, 6, T), 3.0 * rng.random((3, T)),
        ramp[None], -ramp[None], climb_and_fall(T, 3 * W, 2 * W)[None],
        climb_and_fall(T, W + 5, W + 3)[None],
        climb_and_fall(T, W // 2, W // 4)[None],
        np.zeros((1, T))]).astype(np.float32)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("D,W", [(160, 64), (384, 64), (72, 64), (128, 64),
                                 (256, 128), (16, 8), (8, 4)])
def test_window_equals_the_whole_ring(lib, D, W, precise):
    y = traces(600, W, D)
    err, *whole, whole_moves = run(lib, y, D, D, 32, precise)
    assert err == 0 and (whole_moves == 0).all()
    err, *windowed, moves = run(lib, y, D, W, 64, precise)
    assert err == 0
    for a, b in zip(windowed, whole):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    redo = windowed[2]
    assert redo[9] & 1  # the ramp overflows every ring here
    # a pool a frame: the window slides once a frame from the first pool
    # past its top, which starts 3 below position 0
    assert moves[9] == 600 - W + 3
    if W >= 8:  # one pool, pushed to position 1 and merged, under its top
        assert moves[10] == moves[-1] == 0
    assert (moves[11:14] > 0).all()


@pytest.mark.parametrize("window,lanes,shared_bytes", [
    (48, 64, 12 * 48 * 64),    # not a power of two
    (2, 64, 12 * 2 * 64),      # under 4
    (256, 64, 12 * 256 * 64),  # deeper than the ring
    (64, 48, 12 * 64 * 48),    # not whole warps
    (64, 64, 12 * 64 * 32)])   # not the window's bytes
def test_launch_refuses_a_plan_it_cannot_run(lib, window, lanes,
                                              shared_bytes):
    y = traces(300, 64, 0)
    err = run(lib, y, 160, window, lanes, False,
              shared_bytes=shared_bytes)[0]
    assert err == 1  # cudaErrorInvalidValue
