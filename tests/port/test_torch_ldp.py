"""PyTorch port, Low-Delay-P predictor chain: `hevc_tpu_torch.pipeline.ldp`
on the CPU against the JAX `hevc_tpu.pipeline.ldp` on the same
numpy-seeded frames.

`pre_encode` (integer search, quarter-pel sweep, MC, residue) is int32
and must be equal, tolerance 0: residue planes and MVs. The HCPM of
`LDPPipeline.run` with the shipped ETH-LSTM agrees within atol 1e-5 in
float32, with equal split gates."""

import functools
import gc
import os

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.models import hcpm as j_hcpm
from hevc_tpu.pipeline import ldp as j_ldp
from hevc_tpu_torch.core.yuv import Frame
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.models import hcpm as t_hcpm
from hevc_tpu_torch.pipeline import ldp as t_ldp

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_lstm_qp30~35.npz")


def _shipped():
    with np.load(NPZ) as z:
        return {k: z[k] for k in z.files}


def _sequence(w, h, n, seed, flat=False):
    """n frames: a synth frame moved by np.roll each step (luma and
    chroma), with small noise; `flat` paints a flat 64x64 region whose
    every search candidate ties."""
    base = synth_frame(w, h, seed=seed)
    rng = np.random.RandomState(seed)
    frames = [base]
    for i in range(1, n):
        prev = frames[-1]
        y = np.roll(prev.y, (1 + i % 2, -2), axis=(0, 1)).astype(np.int32)
        y = np.clip(y + rng.randint(-3, 4, y.shape), 0, 255).astype(np.uint8)
        cb = np.roll(prev.cb, (1, -1), axis=(0, 1))
        cr = np.roll(prev.cr, (0, -1), axis=(0, 1))
        frames.append(Frame(y, cb, cr))
    if flat:
        for f in frames:
            f.y[:64, :64] = 100
    return frames


@functools.lru_cache(maxsize=None)
def _j_pre_encode(w, h):
    """The JAX pre-encode compiled once per frame size."""
    return jax.jit(functools.partial(j_ldp.pre_encode, pad_w=w, pad_h=h))


def _planes(frame):
    return [np.asarray(p, np.int32) for p in (frame.y, frame.cb, frame.cr)]


@pytest.mark.parametrize("w,h,kind", [
    (128, 64, "moving"), (128, 128, "roll"), (96, 80, "moving"),
    (128, 64, "flat")])
def test_pre_encode_matches_jax(w, h, kind):
    """128x128 is the np.roll translation of tests/test_inter_ldp.py:80;
    96x80 leaves partial CTUs on the right and at the bottom."""
    if kind == "roll":
        f0 = synth_frame(w, h, seed=5)
        f1 = Frame(np.roll(f0.y, (2, -3), axis=(0, 1)), f0.cb, f0.cr)
    else:
        f0, f1 = _sequence(w, h, 2, seed=w + h, flat=kind == "flat")
    cur, ref = _planes(f1), _planes(f0)
    args = (cur[0], ref[0], cur[1], ref[1], cur[2], ref[2])
    got = t_ldp.pre_encode(*(torch.from_numpy(a) for a in args),
                           pad_w=w, pad_h=h)
    want = _j_pre_encode(w, h)(*args)
    for name, g, x in zip(("resi_y", "resi_cb", "resi_cr", "mv_q"), got,
                          want):
        x = np.asarray(x)
        assert g.shape == x.shape and g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    if kind == "roll":
        assert tuple(got[3].numpy()[2] // 4) == (3, -2)
    if kind == "flat":           # CTU 0 is flat in both: all candidates tie
        assert tuple(got[3].numpy()[0]) == (-35, -35)


def test_pipeline_run_matches_jax():
    """Four frames through LDPPipeline.run with the shipped ETH-LSTM, a
    flat 64x64 region in each: residue planes and MVs equal, HCPM within
    atol 1e-5, split gates equal, state carried from step to step."""
    w, h = 128, 128
    frames = _sequence(w, h, 4, seed=21, flat=True)
    params = _shipped()
    got = t_ldp.LDPPipeline(EncoderConfig(w, h, qp=32), lstm_params=params,
                            device="cpu").run(frames)
    ref = j_ldp.LDPPipeline(j_headers.EncoderConfig(w, h, qp=32),
                            lstm_params=params)
    ref._pre = _j_pre_encode(w, h)   # the same program, compiled once here
    want = ref.run([JFrame(f.y, f.cb, f.cr) for f in frames])
    assert [r["poc"] for r in got] == [0, 1, 2, 3]
    assert set(got[0]) == {"poc"}
    for g, x in zip(got[1:], want[1:]):
        assert set(g) == set(x)
        for k in ("resi_y", "resi_cb", "resi_cr", "mv_q"):
            assert isinstance(g[k], np.ndarray)
            np.testing.assert_array_equal(g[k], np.asarray(x[k]), err_msg=k)
        assert g["hcpm"].shape == (4, 21) and g["hcpm"].dtype == np.float32
        np.testing.assert_allclose(g["hcpm"], np.asarray(x["hcpm"]),
                                   atol=1e-5, rtol=0)
        for a, b in zip(t_hcpm.split_gates(torch.from_numpy(g["hcpm"]),
                                           t_hcpm.DEFAULT_LDP),
                        j_hcpm.split_gates(np.asarray(x["hcpm"]),
                                           j_hcpm.DEFAULT_LDP)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1]["resi_y"].shape == (h, w)
    assert got[1]["resi_cb"].shape == (h // 2, w // 2)
    assert not np.allclose(got[2]["hcpm"], got[3]["hcpm"])


def test_predictor_state_and_reset():
    cfg = EncoderConfig(128, 64, qp=32)
    pred = t_ldp.LDPPredictor(cfg, _shipped(), device="cpu")
    assert pred.state.shape == (2, 2, 448) and not pred.state.any()
    resi = torch.full((2, 64, 64), 128, dtype=torch.int32)
    resi[1, :, 16:32] = 200
    p1 = pred.step(resi, 1)
    assert pred.state.any()
    p2 = pred.step(resi, 1)
    assert not torch.equal(p1, p2)
    pred.reset()
    assert pred.state.shape == (2, 2, 448) and not pred.state.any()
    assert torch.equal(pred.step(resi, 1), p1)
    assert pred.thr == t_hcpm.DEFAULT_LDP


@pytest.mark.parametrize("pad_w,pad_h,size", [(192, 128, 64), (96, 80, 64),
                                              (48, 40, 32)])
def test_tiles_to_plane_matches_jax(pad_w, pad_h, size):
    rng = np.random.RandomState(pad_w)
    n = -(-pad_w // size) * -(-pad_h // size)
    tiles = rng.randint(0, 256, (n, size, size)).astype(np.int32)
    want = j_ldp.tiles_to_plane(tiles, pad_w, pad_h, size)
    np.testing.assert_array_equal(
        t_ldp.tiles_to_plane(torch.from_numpy(tiles), pad_w, pad_h, size),
        want)
    np.testing.assert_array_equal(
        t_ldp.tiles_to_plane(tiles, pad_w, pad_h, size), want)


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_ldp.LDPPipeline(EncoderConfig(128, 64))


def test_p_frame_stages_and_run_agree():
    """`LDPPipeline.p_frame` names its stages in order as each ends, and
    gives what `run` gives for the same frames."""
    cfg = EncoderConfig(width=128, height=64, qp=32)
    frames = _sequence(128, 64, 2, seed=12)
    want = t_ldp.LDPPipeline(cfg, lstm_params=_shipped(),
                             device="cpu").run(frames)[1]
    pipe = t_ldp.LDPPipeline(cfg, lstm_params=_shipped(), device="cpu")
    names = []
    ry, rcb, rcr, mv, probs = pipe.p_frame(
        pipe._to_device(frames[1]), pipe._to_device(frames[0]), 1,
        stage_done=names.append)
    assert names == ["integer_search", "quarter_refine", "mc_residue",
                     "lstm_step"]
    for k, got, size in (("resi_y", ry, 64), ("resi_cb", rcb, 32),
                         ("resi_cr", rcr, 32)):
        w, h = want[k].shape[::-1]
        np.testing.assert_array_equal(t_ldp.tiles_to_plane(got, w, h, size),
                                      want[k])
    np.testing.assert_array_equal(mv.numpy(), want["mv_q"])
    np.testing.assert_array_equal(probs.numpy(), want["hcpm"])

# --------------------- the port's twins of tests/test_inter_ldp.py:68-118

def test_pre_encode_static_scene_zero_residue():
    cfg = EncoderConfig(width=128, height=64, qp=32)
    f = synth_frame(128, 64, seed=4)
    out = t_ldp.LDPPipeline(cfg, device="cpu").run([f, f])
    assert "resi_y" not in out[0]          # first frame: no pre-encode
    r = out[1]["resi_y"]
    assert r.shape == (64, 128)
    assert np.all(r == 128)                # identical frames -> zero residue
    assert np.all(out[1]["mv_q"] == 0)


def test_pre_encode_translation():
    cfg = EncoderConfig(width=128, height=128, qp=32)
    f0 = synth_frame(128, 128, seed=5)
    y1 = np.roll(f0.y, (2, -3), axis=(0, 1))  # dy=+2, dx=-3
    f1 = Frame(y1, f0.cb, f0.cr)
    out = t_ldp.LDPPipeline(cfg, device="cpu").run([f0, f1])
    mv = out[1]["mv_q"]
    # np.roll(+2 rows, -3 cols): cur[y][x] = prev[y-2][x+3] -> mv (+3, -2);
    # check a CTU whose matched window stays inside the frame.
    assert tuple(mv[2] // 4) == (3, -2), mv


def test_ldp_predictor_chain():
    cfg = EncoderConfig(width=128, height=64, qp=32)
    pipe = t_ldp.LDPPipeline(cfg, lstm_params=_shipped(), device="cpu")
    frames = [synth_frame(128, 64, seed=s) for s in range(3)]
    out = pipe.run(frames)
    assert "hcpm" in out[1] and "hcpm" in out[2]
    assert out[1]["hcpm"].shape == (2, 21)
    # state carried: same residue would give different probs at step 2
    assert not np.allclose(out[1]["hcpm"], out[2]["hcpm"])
