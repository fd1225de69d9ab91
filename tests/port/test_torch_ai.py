"""PyTorch port, the slice as a whole: `hevc_tpu_torch` AIEncoder.encode
on the CPU against the JAX AIEncoder (golden NumPy reconstruction
backend, held equal to the device reconstruction by the JAX package's own
tests) with the shipped ETH-CNN weights: byte-identical Annex-B streams,
equal reconstructions, and the port's stream decodes in the HM reference
decoder with matching MD5 SEI."""

import gc
import os

import jax
import numpy as np
import pytest

from hevc_tpu.core.yuv import read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.pipeline.ai import AIEncoder as JAIEncoder
from hevc_tpu.train.train_cnn import load_params
from hevc_tpu_torch.core.yuv import Frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.ops import intra_mm as t_mm
from hevc_tpu_torch.pipeline.ai import AIEncoder as TAIEncoder

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Drop the XLA programs this module compiled once it is done: the
    test process is shared with the rest of the suite and memory is tight."""
    yield
    jax.clear_caches()
    gc.collect()


NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


def _encode_both(w, h, qp, n_frames=2, **kw):
    frames = [synth_frame(w, h, seed=10 * w + s) for s in range(n_frames)]
    tenc = TAIEncoder(t_headers.EncoderConfig(w, h, qp=qp),
                      cnn=t_cnn.load_npz(NPZ, device="cpu"), device="cpu",
                      **kw)
    t_out = tenc.encode([Frame(f.y, f.cb, f.cr) for f in frames])
    jenc = JAIEncoder(j_headers.EncoderConfig(w, h, qp=qp),
                      cnn_params=load_params(NPZ), recon_backend="golden",
                      **kw)
    j_out = jenc.encode(frames)
    return frames, t_out, j_out


@pytest.mark.parametrize("w,h,max_depth_exit", [(64, 64, False),
                                                (128, 64, False),
                                                (128, 64, True)])
def test_encode_byte_identical_to_jax(w, h, max_depth_exit, tmp_path):
    launches = t_mm.launches
    frames, (ts, tr, tstats), (js, jr, _) = _encode_both(
        w, h, 32, max_depth_exit=max_depth_exit)
    assert t_mm.launches == launches       # CPU run: plain SATD, no kernel
    assert ts == js
    assert len(tr) == len(jr) == 2
    for a, b in zip(tr, jr):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    assert set(tstats) == {"decide_s", "recon_s", "entropy_s"}

    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: stream equality checked, "
                    "decode not")
    rc, log, rec_path = hm.decode_bytes(ts, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    dec = read_yuv420(rec_path, w, h)
    assert len(dec) == 2
    for d, r in zip(dec, tr):
        np.testing.assert_array_equal(d.y, r.y)
        np.testing.assert_array_equal(d.cb, r.cb)
        np.testing.assert_array_equal(d.cr, r.cr)


def test_decisions_equal_without_cnn():
    """Ungated full search incl. chroma and NxN: the four decision maps
    of both packages are equal at 96x80 (forced boundary splits)."""
    w, h = 96, 80
    f = synth_frame(w, h, seed=3)
    from hevc_tpu.core.yuv import pad_frame
    jcfg = j_headers.EncoderConfig(w, h, qp=27)
    pf = pad_frame(f, jcfg.pad_width, jcfg.pad_height)
    want = JAIEncoder(jcfg).decide_frame_full(pf.y, None, pf.cb, pf.cr)
    got = TAIEncoder(t_headers.EncoderConfig(w, h, qp=27),
                     device="cpu").decide_frame_full(pf.y, None, pf.cb, pf.cr)
    for g, wv in zip(got, want):
        assert g.dtype == wv.dtype
        np.testing.assert_array_equal(g, wv)


def test_unported_options_raise():
    """Per-CTU QP is the one option still refused (the filters are held
    to the JAX package by tests/port/test_torch_ai_filters.py)."""
    with pytest.raises(NotImplementedError):
        TAIEncoder(t_headers.EncoderConfig(64, 64, cu_qp_delta=True),
                   device="cpu")
