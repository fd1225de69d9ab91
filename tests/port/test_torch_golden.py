"""PyTorch port, the golden All-Intra encoder (`pipeline/golden`: host
NumPy, no device code): `GoldenEncoder.encode_frame` equals the JAX
package's in every decision, plane of levels and reconstruction (SATD mode
choice, fixed modes, NxN CUs, frames that are not whole CTUs),
`encode_sequence` gives the same bytes, and `AIEncoder(recon_backend=
"golden")` gives the `"auto"` backend's stream and refuses the filters and
a rate controller, whose effects the reference's golden backend skips."""

import os

import numpy as np
import pytest

from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.pipeline import golden as j_golden
from hevc_tpu_torch.core.yuv import Frame, pad_frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.pipeline import bench_hooks, golden as t_golden
from hevc_tpu_torch.pipeline.ai import AIEncoder
from hevc_tpu_torch.pipeline.ratectrl import RateController

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


def _padded(w, h, seed):
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    f = synth_frame(w, h, seed=seed)
    return cfg, pad_frame(Frame(f.y, f.cb, f.cr), cfg.pad_width,
                          cfg.pad_height)


@pytest.mark.parametrize("w,h,modes", [(128, 64, "satd"), (96, 80, "satd"),
                                       (128, 64, "fixed"), (96, 80, "nxn"),
                                       (192, 128, "nxn")])
def test_encode_frame_equals_jax(w, h, modes):
    cfg, pf = _padded(w, h, seed=w + h)
    d8, m8, m4, nxn = bench_hooks.random_legal_decisions(
        cfg.pad_width, cfg.pad_height, seed=w * h)
    kw = {"satd": {}, "fixed": dict(modes8=m8),
          "nxn": dict(modes8=m8, modes4=m4, nxn8=nxn)}[modes]
    if modes == "nxn":
        assert nxn.any()
    got_d, got_r = t_golden.GoldenEncoder(cfg).encode_frame(pf, d8, **kw)
    want_d, want_r = j_golden.GoldenEncoder(
        j_headers.EncoderConfig(w, h, qp=32)).encode_frame(
            JFrame(pf.y, pf.cb, pf.cr), d8, **kw)
    assert set(got_d) == set(want_d)
    for k in want_d:
        np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(got_r, p), getattr(want_r, p))
    assert np.any(got_d["coef_y"]) and np.any(got_d["coef_cb"])
    if modes == "satd":         # the SATD choice picks more than one mode
        assert len(np.unique(got_d["modes8"])) > 3


def test_encode_sequence_equals_jax():
    w, h = 96, 80
    frames = [synth_frame(w, h, seed=s) for s in (1, 2)]
    cfg_t = t_headers.EncoderConfig(w, h, qp=30)
    cfg_j = j_headers.EncoderConfig(w, h, qp=30)

    def depth8_fn(i, pf):
        return bench_hooks.random_legal_decisions(cfg_t.pad_width,
                                                  cfg_t.pad_height, i)[0]

    got, got_r = t_golden.encode_sequence(
        [Frame(f.y, f.cb, f.cr) for f in frames], cfg_t, depth8_fn)
    want, want_r = j_golden.encode_sequence(frames, cfg_j, depth8_fn)
    assert got == want
    for a, b in zip(got_r, want_r):
        np.testing.assert_array_equal(a.y, b.y)


@pytest.fixture(scope="module")
def cnn():
    return t_cnn.load_npz(NPZ, device="cpu")


def test_golden_backend_equals_auto(cnn):
    frames = [Frame(f.y, f.cb, f.cr)
              for f in (synth_frame(128, 64, seed=s) for s in (3, 4))]
    cfg = t_headers.EncoderConfig(128, 64, qp=32)
    auto = AIEncoder(cfg, cnn=cnn, device="cpu").encode(frames)
    gold = AIEncoder(cfg, cnn=cnn, device="cpu",
                     recon_backend="golden").encode(frames)
    assert gold[0] == auto[0]
    for a, b in zip(gold[1], auto[1]):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.cr, b.cr)


@pytest.mark.parametrize("what", ["deblock", "sao", "rate_control", "qp",
                                  "backend"])
def test_golden_backend_refusals(cnn, what):
    if what in ("deblock", "sao"):
        cfg = t_headers.EncoderConfig(64, 64, qp=32, **{what: True})
        with pytest.raises(NotImplementedError, match="golden"):
            AIEncoder(cfg, cnn=cnn, device="cpu", recon_backend="golden")
        return
    cfg = t_headers.EncoderConfig(64, 64, qp=32)
    if what == "backend":
        with pytest.raises(ValueError, match="recon_backend"):
            AIEncoder(cfg, device="cpu", recon_backend="tpu")
        return
    enc = AIEncoder(cfg, cnn=cnn, device="cpu", recon_backend="golden")
    f = synth_frame(64, 64, seed=1)
    f = Frame(f.y, f.cb, f.cr)
    if what == "rate_control":
        rc = RateController(100_000, 30, 64, 64, n_frames=1, init_qp=32)
        with pytest.raises(NotImplementedError, match="cfg.qp"):
            enc.encode([f], rate_control=rc)
    else:
        d8, m8 = enc.decide_frame(f.y, 30, f.cb, f.cr)
        with pytest.raises(NotImplementedError, match="cfg.qp"):
            enc.reconstruct(f, d8, m8, qp=30)
