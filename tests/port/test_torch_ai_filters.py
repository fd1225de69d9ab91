"""PyTorch port, the All-Intra encoder with its in-loop filters and
picture-level rate control: `hevc_tpu_torch` AIEncoder.encode on the CPU
with deblocking, SAO or both, and with a RateController, against a JAX
reference assembled from the JAX pieces in the order of the JAX
AIEncoder (hevc_tpu/pipeline/ai.py:160-181, 220-228): decide_frame_full,
GoldenEncoder.encode_frame, deblock.deblock_frame, sao.estimate_frame /
apply_frame, entropy_encode_slice with the SAO parameters, pic_hashes.
The JAX AIEncoder cannot be the reference itself: its "golden" backend
returns before the filters (ai.py:201-203) and codes at cfg.qp whatever
the rate controller picked. Streams must be byte-identical, recons and
per-picture QPs equal, and HM must decode the port's stream with no
MD5 mismatch to the recon."""

import dataclasses
import gc
import os

import jax
import numpy as np
import pytest

from hevc_tpu.core.yuv import crop_frame, pad_frame, read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.ops import deblock as j_dbk
from hevc_tpu.ops import sao as j_sao
from hevc_tpu.pipeline import golden as j_golden
from hevc_tpu.pipeline import ratectrl as j_rc
from hevc_tpu.pipeline.ai import AIEncoder as JAIEncoder
from hevc_tpu.pipeline.ai import entropy_encode_slice as j_entropy
from hevc_tpu.train.train_cnn import load_params
from hevc_tpu_torch.core.yuv import Frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.pipeline import ratectrl as t_rc
from hevc_tpu_torch.pipeline.ai import AIEncoder as TAIEncoder

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")
W, H = 128, 64


@pytest.fixture(scope="module")
def jax_decider():
    """One JAX AIEncoder for the module's decisions (its compiled search
    programs are shared by every test); dropped with them at the end."""
    yield JAIEncoder(j_headers.EncoderConfig(W, H), cnn_params=load_params(NPZ))
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def port_cnn():
    return t_cnn.load_npz(NPZ, device="cpu")


def _frames(n, w=W, h=H):
    return [synth_frame(w, h, seed=70 + s) for s in range(n)]


def _jax_reference(decider, cfg, frames, rate_control=None):
    """The JAX AIEncoder.encode with a filtering, QP-following golden
    reconstruction: (stream, cropped recons, per-picture QPs)."""
    chunks = [j_headers.write_vps(cfg), j_headers.write_sps(cfg),
              j_headers.write_pps(cfg)]
    recons, qps = [], []
    for frame in frames:
        pf = pad_frame(frame, cfg.pad_width, cfg.pad_height)
        qp = rate_control.pre_frame() if rate_control else cfg.qp
        qps.append(qp)
        depth8, modes8, modes4, nxn8 = decider.decide_frame_full(
            pf.y, qp, pf.cb, pf.cr)
        gold = j_golden.GoldenEncoder(dataclasses.replace(cfg, qp=qp))
        decisions, rec = gold.encode_frame(pf, depth8, modes8, modes4=modes4,
                                           nxn8=nxn8)
        y, cb, cr = rec.y, rec.cb, rec.cr
        if cfg.deblock:
            y, cb, cr = j_dbk.deblock_frame(y, cb, cr, depth8, qp)
        if cfg.sao:
            params = j_sao.estimate_frame(pf.y, pf.cb, pf.cr, y, cb, cr, qp)
            y, cb, cr = j_sao.apply_frame(y, cb, cr, params)
            decisions["sao"] = params
        rec = type(rec)(*(np.asarray(p).astype(np.uint8) for p in (y, cb, cr)))
        chunks.append(j_entropy(cfg, decisions, qp=qp))
        if rate_control:
            rate_control.post_frame(8 * len(chunks[-1]))
        tid, hs = j_golden.pic_hashes(rec, cfg.hash_type)
        chunks.append(j_headers.write_hash_sei(*hs, hash_type=tid))
        recons.append(crop_frame(rec, cfg.width, cfg.height))
    return b"".join(chunks), recons, qps


def _hm_decodes_to(stream, recons, w, h, tmp_path):
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: streams compared, decode not")
    rc, log, rec_path = hm.decode_bytes(stream, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    dec = read_yuv420(rec_path, w, h)
    assert len(dec) == len(recons)
    for d, r in zip(dec, recons):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p))


def _check_equal(port, ref):
    (ts, tr, tstats), (js, jr, _) = port, ref
    assert ts == js
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    assert set(tstats) == {"decide_s", "recon_s", "entropy_s"}


@pytest.mark.parametrize("deblock,sao", [(True, False), (False, True),
                                         (True, True)])
def test_filtered_stream_byte_identical_to_jax(deblock, sao, jax_decider,
                                               port_cnn, tmp_path):
    frames = _frames(2)
    kw = dict(qp=32, deblock=deblock, sao=sao)
    enc = TAIEncoder(t_headers.EncoderConfig(W, H, **kw), cnn=port_cnn,
                     device="cpu")
    port = enc.encode([Frame(f.y, f.cb, f.cr) for f in frames])
    js, jr, jqps = _jax_reference(jax_decider,
                                  j_headers.EncoderConfig(W, H, **kw), frames)
    _check_equal(port, (js, jr, None))
    assert enc.frame_qps == jqps == [32, 32]
    _hm_decodes_to(port[0], port[1], W, H, tmp_path)


def test_rate_controlled_stream_byte_identical_to_jax(jax_decider, port_cnn,
                                                      tmp_path):
    """Three frames under a RateController whose target moves the QP:
    the same per-picture QPs, bytes and recons on both sides."""
    frames = _frames(3)
    rc_kw = dict(target_bps=60_000, fps=30, width=W, height=H, n_frames=3,
                 init_qp=32)
    kw = dict(qp=32, deblock=True, sao=True)
    enc = TAIEncoder(t_headers.EncoderConfig(W, H, **kw), cnn=port_cnn,
                     device="cpu")
    port = enc.encode([Frame(f.y, f.cb, f.cr) for f in frames],
                      rate_control=t_rc.RateController(**rc_kw))
    js, jr, jqps = _jax_reference(jax_decider,
                                  j_headers.EncoderConfig(W, H, **kw), frames,
                                  j_rc.RateController(**rc_kw))
    assert enc.frame_qps == jqps
    assert len(set(jqps)) >= 2, jqps
    _check_equal(port, (js, jr, None))
    _hm_decodes_to(port[0], port[1], W, H, tmp_path)


def test_filters_on_half_chroma_blocks(port_cnn, tmp_path):
    """A padded height of 72 gives 36 chroma rows, 4.5 chroma 8-blocks
    (1080p gives 540): the port pads the chroma planes for the deblocking
    filter, which the JAX deblock_frame does not take. HM is the oracle."""
    w, h = 128, 72
    frames = _frames(2, w, h)
    enc = TAIEncoder(t_headers.EncoderConfig(w, h, qp=37, deblock=True,
                                             sao=True),
                     cnn=port_cnn, device="cpu")
    stream, recons, _ = enc.encode([Frame(f.y, f.cb, f.cr) for f in frames])
    _hm_decodes_to(stream, recons, w, h, tmp_path)
