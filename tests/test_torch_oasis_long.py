"""Whole-recording OASIS in the port vs the JAX package.

The port's long entry (``oasis_cuda.oasis_ar1_long``; on a CPU tensor its
plain PyTorch twin ``oasis_torch.oasis_ar1_long_torch``) and the precise
stack machine run against the Pallas kernels in interpret mode on the same
numpy inputs, as ``tests/test_oasis_pallas.py:107-203`` runs them: ``c`` and
``s`` within atol 1e-4 (float32 pools against float32 pools and the f64
golden, as in ``tests/test_torch_oasis.py``) and equal redo bitmasks. XLA on
the CPU contracts multiply-adds and rounds ``exp`` differently from torch's
CPU kernels by an ulp, which can only move a decision that lies inside the
band; none of the cases here has one at the band's edge, so the bitmasks
are equal. The dispatch's long route and the CLI must give the f64
golden's spikes exactly. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""

import os
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from calciumgan_tpu.ops import oasis as jax_oasis
from calciumgan_tpu.ops import oasis_ref
from calciumgan_tpu.ops.oasis_pallas import (oasis_ar1_pallas,
                                             oasis_ar1_pallas_long)
from calciumgan_tpu_torch.dataset import spike_train_inference as port_cli
from calciumgan_tpu_torch.ops import oasis as oasis_dispatch
from calciumgan_tpu_torch.ops import oasis_cuda

torch.set_num_threads(1)

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_traces(rng, n=8, T=256, g=0.95, rate=0.02, sn=0.3):
    spikes = (rng.random((n, T)) < rate).astype(np.float64)
    c = np.zeros_like(spikes)
    for t in range(T):
        c[:, t] = spikes[:, t] + (g * c[:, t - 1] if t > 0 else 0.0)
    return c + sn * rng.standard_normal((n, T))


def port(fn, y, **kw):
    out = fn(torch.from_numpy(np.asarray(y, np.float32)), **kw)
    return tuple(t.numpy() for t in out)


def jax_out(fn, y, **kw):
    return tuple(map(np.asarray, fn(y, interpret=True, **kw)))


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("s_min,lam", [(0.55, 0.0), (0.0, 0.0), (0.0, 1.0)])
def test_long_matches_pallas_long_and_golden(rng, s_min, lam, precise):
    # 300 frames: the JAX kernel walks four 64-frame chunks and a partial
    # fifth; the port walks the whole trace
    y = synth_traces(rng, n=6, T=300)
    kw = dict(g=0.95, lam=lam, s_min=s_min, depth=64, precise=precise)
    c_j, s_j, redo_j = jax_out(oasis_ar1_pallas_long, y, chunk=64, **kw)
    c, s, redo = port(oasis_cuda.oasis_ar1_long, y, **kw)
    np.testing.assert_array_equal(redo, redo_j)
    assert not redo.any()
    np.testing.assert_allclose(c, c_j, atol=ATOL)
    np.testing.assert_allclose(s, s_j, atol=ATOL)
    for i in range(len(y)):
        c_ref, s_ref = oasis_ref.oasis_ar1(y[i], g=0.95, lam=lam, s_min=s_min)
        np.testing.assert_allclose(c[i], c_ref, atol=ATOL)
        np.testing.assert_allclose(s[i], s_ref, atol=ATOL)


def test_long_matches_short(rng):
    # the same machine and order: the long entry equals the whole-trace one
    y = synth_traces(rng, n=9, T=256)
    c0, s0, r0 = port(oasis_cuda.oasis_ar1, y, g=0.95, s_min=0.55)
    c1, s1, r1 = port(oasis_cuda.oasis_ar1_long, y, g=0.95, s_min=0.55,
                      depth=96)
    _, s_j, r_j = jax_out(oasis_ar1_pallas, y, g=0.95, s_min=0.55)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(r1, r_j)
    np.testing.assert_allclose(c1, c0, atol=1e-5)
    np.testing.assert_allclose(s1, s0, atol=1e-5)
    np.testing.assert_allclose(s1, s_j, atol=ATOL)


@pytest.mark.parametrize("precise", [False, True])
def test_long_redo_bit0_on_stack_overflow(precise):
    # a monotone ramp at s_min=0 keeps every pool: pool count = T > depth
    ramp = np.linspace(0.0, 10.0, 160)[None].repeat(3, 0)
    kw = dict(s_min=0.0, depth=16, precise=precise)
    _, _, redo_j = jax_out(oasis_ar1_pallas_long, ramp, chunk=64, **kw)
    _, _, redo = port(oasis_cuda.oasis_ar1_long, ramp, **kw)
    np.testing.assert_array_equal(redo, redo_j)
    assert (redo & 1).all()


def test_precise_band_edge_cases():
    # tests/test_oasis_pallas.py:107-130: a 1e-5 margin lies outside the
    # precise band and resolves unflagged, the f64 way; a 1e-8 margin lies
    # inside it and sets bit 2
    g, s_min, a = 0.95, 0.55, 2.0
    y = np.zeros((1, 64), np.float32)
    y[0, 0] = a
    kw = dict(g=g, s_min=s_min, flag_tol=1e-6, precise=True)
    for margin, bit2 in ((1e-5, False), (1e-8, True)):
        y[0, 1] = np.float32(g * a + s_min + margin)
        _, s_j, redo_j = jax_out(oasis_ar1_pallas, y, **kw)
        _, s, redo = port(oasis_cuda.oasis_ar1, y, **kw)
        np.testing.assert_array_equal(redo, redo_j)
        assert bool(redo[0] & 4) == bit2
        if not bit2:
            assert redo[0] == 0
            _, s_ref = oasis_ref.oasis_ar1(y[0].astype(np.float64), g=g,
                                           s_min=s_min)
            np.testing.assert_array_equal(s[0] > 0.5, s_ref > 0.5)
            np.testing.assert_allclose(s, s_j, atol=ATOL)


def test_precise_flagged_bits_match_on_dense_traces(rng):
    # the precise counterpart of test_torch_oasis.py's dense case: a shallow
    # stack and a starved budget set bits 0 and 1; a 1e-4 band (the
    # production 1.5e-6 band meets no decision on so small a corpus) sets
    # bit 2; the ring carries v_lo slot for slot like the rolled stack
    y = np.concatenate([synth_traces(rng, n=20, T=128, rate=0.02),
                        synth_traces(rng, n=20, T=128, rate=0.3)])
    seen = 0
    for K in (1, 2):
        kw = dict(s_min=0.55, depth=24, merge_attempts=K, flag_tol=1e-4,
                  precise=True)
        c_j, _, redo_j = jax_out(oasis_ar1_pallas, y, **kw)
        c, _, redo = port(oasis_cuda.oasis_ar1, y, **kw)
        np.testing.assert_array_equal(redo, redo_j)
        ok = redo == 0
        np.testing.assert_allclose(c[ok], c_j[ok], atol=ATOL)
        seen |= np.bitwise_or.reduce(redo)
    assert seen == 7 and (redo == 0).any()


def test_long_route_walks_the_long_ladder(rng, monkeypatch):
    """The dispatch's long route, driven through the plain twin at a small
    T: the precise machine with the 1.5e-6 band, one rung deeper while more
    than 10% of the traces overflow, flagged traces redone in f64."""
    calls = []
    real = oasis_cuda.oasis_ar1

    def spy(signals, **kw):
        calls.append(kw)
        return real(signals, **kw)

    monkeypatch.setattr(oasis_cuda, "oasis_ar1", spy)
    T = 300
    ladder = oasis_dispatch._long_ladder(T)
    assert ladder == (256, 300)
    # increments of 0.6 > s_min never merge: 300 pools overflow 256 rows
    ramp = (0.6 * np.arange(T, dtype=np.float32))[None]
    spiky = synth_traces(rng, n=9, T=T).astype(np.float32)
    for y, depths in ((np.concatenate([ramp.repeat(2, 0), spiky[:4]]),
                       [256, 300]),                  # 2/6 traces overflow
                      (np.concatenate([ramp, spiky]), [256])):  # 1/10
        calls.clear()
        spikes = oasis_dispatch._ladder_spikes(
            torch.from_numpy(y), ladder, True, 0.95, 0.55, 0.5)
        assert [kw["depth"] for kw in calls] == depths
        assert all(kw["precise"] and kw["flag_tol"] == 1.5e-6
                   and kw["merge_attempts"] == 2 for kw in calls)
        golden = oasis_ref.deconvolve_signals_ref(y.astype(np.float64))
        np.testing.assert_array_equal(spikes, golden.astype(np.int8))


@pytest.mark.parametrize("T", [4097, 8000, 20000, 10 ** 5, 10 ** 6])
def test_long_ladder_and_band_equal_jax(T):
    assert oasis_dispatch._long_ladder(T) == jax_oasis._long_ladder(T)
    for s_min in (0.0, 0.55):
        for precise in (False, True):
            assert (oasis_dispatch._flag_tol(s_min, 0.5, precise=precise)
                    == jax_oasis._flag_tol(s_min, 0.5, precise=precise))


def write_recording(path, rng, T):
    spikes = (rng.uniform(size=(5, T)) < 0.05).astype(np.float32)
    sig = np.zeros_like(spikes)
    for t in range(1, T):
        sig[:, t] = 0.95 * sig[:, t - 1] + spikes[:, t]
    sig += 0.1 * rng.normal(size=sig.shape).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"signals": sig.astype(np.float32)}, f)


def read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_jax_cli(argv, monkeypatch):
    # tests/test_dataset_clis.py:14-16
    script = "dataset/spike_train_inference.py"
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, script), run_name="__main__")


@pytest.mark.parametrize("T", [800, 4500])
def test_cli_matches_jax_cli(rng, tmp_path, monkeypatch, T):
    # 800 frames: the twin's ladder and the host redo; 4500: the exact host
    # kernel, as the JAX package runs long traces off the TPU
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    write_recording(str(ours / "rec.pkl"), rng, T)
    shutil.copytree(ours, theirs)
    port_cli.main(["--input_dir", str(ours), "--device", "cpu"])
    run_jax_cli(["--input_dir", str(theirs)], monkeypatch)
    data = read(ours / "rec.pkl")
    assert data["oasis"].dtype == np.float32
    assert data["oasis"].shape == data["signals"].shape
    assert set(np.unique(data["oasis"])) <= {0.0, 1.0}
    np.testing.assert_array_equal(data["oasis"],
                                  read(theirs / "rec.pkl")["oasis"])

    # an existing key is kept without --overwrite and replaced with it
    for d in (ours, theirs):
        data = read(d / "rec.pkl")
        data["oasis"] = np.full_like(data["oasis"], 7.0)
        with open(d / "rec.pkl", "wb") as f:
            pickle.dump(data, f)
    port_cli.main(["--input_dir", str(ours), "--device", "cpu"])
    run_jax_cli(["--input_dir", str(theirs)], monkeypatch)
    assert (read(ours / "rec.pkl")["oasis"] == 7.0).all()
    assert (read(theirs / "rec.pkl")["oasis"] == 7.0).all()
    port_cli.main(["--input_dir", str(ours), "--device", "cpu",
                   "--overwrite"])
    run_jax_cli(["--input_dir", str(theirs), "--overwrite"], monkeypatch)
    np.testing.assert_array_equal(read(ours / "rec.pkl")["oasis"],
                                  read(theirs / "rec.pkl")["oasis"])
    assert set(np.unique(read(ours / "rec.pkl")["oasis"])) <= {0.0, 1.0}

    port_cli.main(["--input_dir", str(ours), "--device", "cpu", "--clean"])
    run_jax_cli(["--input_dir", str(theirs), "--clean"], monkeypatch)
    assert "oasis" not in read(ours / "rec.pkl")
    assert "oasis" not in read(theirs / "rec.pkl")


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch):
    write_recording(str(tmp_path / "rec.pkl"), np.random.default_rng(0), 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--input_dir", str(tmp_path)])
    assert "oasis" not in read(tmp_path / "rec.pkl")
