"""PyTorch port, the frame-batched All-Intra path: `FrameParallelAI` on the
CPU gives the stream of the port's `AIEncoder`, which is the stream of the
JAX `AIEncoder` (golden NumPy reconstruction backend; the JAX package's
own tests hold its `FrameParallelAI` equal to that); chunking, decide
sub-batches and max-depth buckets change no byte; the batched search
equals per-frame searches field by field."""

import gc
import os

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.pipeline.ai import AIEncoder as JAIEncoder
from hevc_tpu.train.train_cnn import load_params
from hevc_tpu_torch.core.yuv import Frame, pad_frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.parallel import frames as t_frames
from hevc_tpu_torch.parallel.frames import FrameParallelAI
from hevc_tpu_torch.pipeline import recon_kernel, search as t_search
from hevc_tpu_torch.pipeline.ai import AIEncoder as TAIEncoder

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def cnn():
    return t_cnn.load_npz(NPZ, device="cpu")


def _frames(w, h, n, flat=()):
    """Seeded frames; those listed in `flat` are uniform grey, which the
    trained predictor never splits."""
    out = []
    for s in range(n):
        f = synth_frame(w, h, seed=7 * w + s)
        if s in flat:
            f = Frame(np.full_like(f.y, 120), np.full_like(f.cb, 128),
                      np.full_like(f.cr, 128))
        out.append(Frame(f.y, f.cb, f.cr))
    return out


@pytest.mark.parametrize("w,h", [(64, 64), (128, 64)])
def test_stream_equals_aiencoder_and_jax(cnn, w, h):
    frames = _frames(w, h, 2)
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    launches = recon_kernel.launches
    penc = FrameParallelAI(cfg, cnn=cnn, device="cpu")
    pstream, stats = penc.encode(frames)
    assert recon_kernel.launches == launches    # CPU run: the plain version
    assert set(stats) == {"device_s", "transfer_s", "entropy_s"}
    tstream, _, _ = TAIEncoder(cfg, cnn=cnn, device="cpu").encode(frames)
    assert pstream == tstream
    jstream, _, _ = JAIEncoder(j_headers.EncoderConfig(w, h, qp=32),
                               cnn_params=load_params(NPZ),
                               recon_backend="golden").encode(frames)
    assert pstream == jstream


def test_chunks_sub_batches_and_buckets_change_no_byte(cnn):
    w, h = 128, 64
    frames = _frames(w, h, 4, flat=(1,))
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    base = FrameParallelAI(cfg, cnn=cnn, device="cpu")
    want, _ = base.encode(frames)
    # the flat frame lands in a shallower max-depth bucket of its own
    assert len({md for md, _ in base.decide_batches}) > 1
    assert sum(n for _, n in base.decide_batches) == 4
    got, _ = base.encode(frames, chunk=2)            # pipelined groups
    assert got == want
    ragged = FrameParallelAI(cfg, cnn=cnn, decide_chunk=3,
                             bucket_max_depth=False, device="cpu")
    got, _ = ragged.encode(frames)                   # sub-batches of 3 + 1
    assert ragged.decide_batches == [(3, 3), (3, 1)]
    assert got == want
    # a seeded, untrained predictor: bucketed == unbucketed
    torch.manual_seed(5)
    rnd = t_cnn.EthCnn()
    a, _ = FrameParallelAI(cfg, cnn=rnd, device="cpu").encode(frames[:2])
    b, _ = FrameParallelAI(cfg, cnn=rnd, bucket_max_depth=False,
                           device="cpu").encode(frames[:2])
    assert a == b
    # no predictor at all: the ungated search, with and without the SEI
    c, _ = FrameParallelAI(cfg, device="cpu").encode(frames[:1],
                                                     with_hash_sei=False)
    d, _, _ = TAIEncoder(cfg, device="cpu").encode(frames[:1],
                                                   with_hash_sei=False)
    assert c == d


def test_need_recon_false_skips_the_recon_copy(cnn):
    w, h = 96, 80
    frames = _frames(w, h, 2)
    enc = FrameParallelAI(t_headers.EncoderConfig(w, h, qp=32), cnn=cnn,
                          device="cpu")
    chunks, recons, device_s = enc.encode_batch(frames)
    assert device_s >= 0.0 and set(enc.last_stats) == {
        "device_s", "transfer_s", "entropy_s"}
    assert recons[0].y.shape == (80, 96) and recons[0].y.dtype == np.uint8
    chunks2, recons2, _ = enc.encode_batch(frames, need_recon=False)
    assert recons2 == [None, None]
    assert chunks2 == chunks


def test_batched_search_equals_per_frame_search(cnn):
    w, h = 96, 80
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    pfs = [pad_frame(f, cfg.pad_width, cfg.pad_height)
           for f in _frames(w, h, 3, flat=(2,))]
    enc = FrameParallelAI(cfg, cnn=cnn, device="cpu")
    ys, cbs, crs = (torch.as_tensor(np.stack([getattr(p, k) for p in pfs]))
                    for k in ("y", "cb", "cr"))
    probs = enc._cnn_probs(ys)
    kw = dict(pad_w=cfg.pad_width, pad_h=cfg.pad_height, n_ctu_x=cfg.ctus_x,
              qp=32, thr_up=enc.thr.up, thr_down=enc.thr.down)
    for extra in (dict(), dict(max_depth=2), dict(nxn=False)):
        got = t_search.search_frame(ys, enc._origins, hcpm_probs=probs,
                                    cb_plane=cbs, cr_plane=crs, **kw, **extra)
        for f in range(3):
            one = t_search.search_frame(ys[f], enc._origins,
                                        hcpm_probs=probs[f], cb_plane=cbs[f],
                                        cr_plane=crs[f], **kw, **extra)
            for name in one._fields:
                assert torch.equal(getattr(got, name)[f], getattr(one, name)), \
                    (name, f, extra)
    # no predictor, no chroma
    got = t_search.search_frame(ys, enc._origins, **kw)
    one = t_search.search_frame(ys[1], enc._origins, **kw)
    for name in one._fields:
        assert torch.equal(getattr(got, name)[1], getattr(one, name)), name


@pytest.mark.parametrize("what", ["mesh", "tu", "chain_ldp", "deblock",
                                  "unknown_backend"])
def test_unported_options_raise(what):
    cfg = t_headers.EncoderConfig(64, 64)
    if what == "mesh":
        with pytest.raises(NotImplementedError):
            FrameParallelAI(cfg, mesh=object(), device="cpu")
    elif what == "tu":
        # the TU backend is ported; it refuses the filters as "auto" does
        assert FrameParallelAI(cfg, recon_backend="tu",
                               device="cpu").recon_backend == "tu"
        with pytest.raises(NotImplementedError, match="signals the filters"):
            FrameParallelAI(t_headers.EncoderConfig(64, 64, deblock=True),
                            recon_backend="tu", device="cpu")
    elif what == "chain_ldp":
        with pytest.raises(NotImplementedError):
            t_frames.ChainParallelLDP(cfg)
    elif what == "deblock":
        for kw in (dict(deblock=True), dict(sao=True)):
            with pytest.raises(NotImplementedError,
                               match="signals the filters"):
                FrameParallelAI(t_headers.EncoderConfig(64, 64, **kw),
                                device="cpu")
    else:
        with pytest.raises(ValueError):
            FrameParallelAI(cfg, recon_backend="xla", device="cpu")
