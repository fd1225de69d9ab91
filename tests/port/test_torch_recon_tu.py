"""PyTorch port, the TU-wavefront reconstruction (`pipeline/recon_tu`,
plain PyTorch; the reference's is plain XLA): `build_schedule` equals the
JAX one array for array; `reconstruct_tu` equals the JAX `GoldenEncoder`
(the JAX package's own parity oracle for this backend) in every
reconstruction and level plane; `AIEncoder(recon_backend="tu")` and
`FrameParallelAI(recon_backend="tu")` give the `"auto"` stream at
`nxn=False` and the JAX golden backend's stream, keep the filters and a
rate controller's QPs, code RDOQ whatever `cfg.rdoq` says (the
reference's trait), and HM decodes their stream."""

import dataclasses
import gc
import os

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import Frame as JFrame, read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.pipeline import golden as j_golden, recon_tu as j_recon_tu
from hevc_tpu.pipeline.ai import AIEncoder as JAIEncoder
from hevc_tpu.train.train_cnn import load_params
from hevc_tpu_torch.core.yuv import Frame, pad_frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.parallel.frames import FrameParallelAI
from hevc_tpu_torch.pipeline import bench_hooks, recon, recon_tu
from hevc_tpu_torch.pipeline.ai import AIEncoder
from hevc_tpu_torch.pipeline.ratectrl import RateController

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("w,h,seed", [(64, 64, 0), (96, 80, 1),
                                      (192, 128, 2), (320, 200, 3)])
def test_build_schedule_equals_jax(w, h, seed):
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    d8 = bench_hooks.random_legal_decisions(cfg.pad_width, cfg.pad_height,
                                            seed)[0]
    got, n_got = recon_tu.build_schedule(d8)
    want, n_want = j_recon_tu.build_schedule(d8)
    assert n_got == n_want and n_got % 16 == 0
    assert recon_tu._leaf_tus(d8) == j_recon_tu._leaf_tus(d8)
    for s8 in (1, 2, 4):
        for a, b in zip(got[s8], want[s8]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        cap = got[s8][0].shape[1]
        assert cap & (cap - 1) == 0          # a power of two


@pytest.mark.parametrize("w,h", [(192, 128), (96, 80)])
def test_reconstruct_tu_equals_jax_golden(w, h):
    cfg = t_headers.EncoderConfig(w, h, qp=27)
    f = synth_frame(w, h, seed=w)
    pf = pad_frame(Frame(f.y, f.cb, f.cr), cfg.pad_width, cfg.pad_height)
    d8, m8, _, _ = bench_hooks.random_legal_decisions(
        cfg.pad_width, cfg.pad_height, seed=h)
    assert set(np.unique(d8)) == {0, 1, 2, 3} or (w, h) == (96, 80)
    planes = recon_tu.reconstruct_tu(pf.y, pf.cb, pf.cr, d8, m8, qp=27,
                                     pad_w=cfg.pad_width,
                                     pad_h=cfg.pad_height, device="cpu")
    dec, rec = j_golden.GoldenEncoder(
        j_headers.EncoderConfig(w, h, qp=27)).encode_frame(
            JFrame(pf.y, pf.cb, pf.cr), d8, m8)
    for name, want in (("recon_y", rec.y), ("recon_cb", rec.cb),
                       ("recon_cr", rec.cr), ("coef_y", dec["coef_y"]),
                       ("coef_cb", dec["coef_cb"]),
                       ("coef_cr", dec["coef_cr"])):
        got = getattr(planes, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert planes.recon_y.dtype == torch.uint8
    assert np.any(dec["coef_cr"])


@pytest.fixture(scope="module")
def cnn():
    return t_cnn.load_npz(NPZ, device="cpu")


@pytest.fixture(scope="module")
def streams(cnn):
    """2 frames at 128x64 through the port's AIEncoder ("auto" at
    nxn=False, "tu" from a config with NxN on) and 4 through
    FrameParallelAI (both backends), plus the JAX golden backend's
    stream."""
    w, h = 128, 64
    frames = [Frame(f.y, f.cb, f.cr)
              for f in (synth_frame(w, h, seed=40 + s) for s in range(4))]
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    cfg0 = dataclasses.replace(cfg, nxn=False)
    tu_enc = AIEncoder(cfg, cnn=cnn, device="cpu", recon_backend="tu")
    out = dict(frames=frames, tu_cfg=tu_enc.cfg,
               auto=AIEncoder(cfg0, cnn=cnn, device="cpu").encode(frames[:2]),
               tu=tu_enc.encode(frames[:2]))
    batches = recon.batches
    fp = FrameParallelAI(cfg, cnn=cnn, device="cpu", recon_backend="tu",
                         decide_chunk=1)
    out["fp_tu"] = fp.encode(frames, chunk=3)[0]
    out["fp_tu_batches"] = recon.batches - batches
    out["fp_decide_batches"] = fp.decide_batches
    out["fp_auto"] = FrameParallelAI(cfg0, cnn=cnn, device="cpu").encode(
        frames, chunk=3)[0]
    jcfg = j_headers.EncoderConfig(w, h, qp=32, nxn=False)
    out["jax"] = JAIEncoder(jcfg, cnn_params=load_params(NPZ),
                            recon_backend="golden").encode(frames[:2])[0]
    return out


def test_tu_backend_streams_equal_auto_and_jax(streams):
    assert streams["tu_cfg"].nxn is False
    assert streams["tu"][0] == streams["auto"][0] == streams["jax"]
    for a, b in zip(streams["tu"][1], streams["auto"][1]):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    assert streams["fp_tu"] == streams["fp_auto"]
    assert streams["fp_tu_batches"] == 0     # not through the plain recon
    assert [n for _, n in streams["fp_decide_batches"]] == [1, 1, 1, 1]


def test_tu_backend_stream_decodes_in_hm(streams, tmp_path):
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing")
    rc, log, rec_path = hm.decode_bytes(streams["fp_tu"], str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    dec = read_yuv420(rec_path, 128, 64)
    assert len(dec) == 4
    for d, r in zip(dec, streams["tu"][1]):
        np.testing.assert_array_equal(d.y, r.y)
        np.testing.assert_array_equal(d.cb, r.cb)


@pytest.mark.parametrize("case", ["filters", "rate_control", "rdoq_off"])
def test_tu_backend_options(cnn, streams, case):
    frames = streams["frames"][:2]
    kw = {"filters": dict(deblock=True, sao=True), "rate_control": {},
          "rdoq_off": dict(rdoq=False)}[case]
    cfg = t_headers.EncoderConfig(128, 64, qp=32, nxn=False, **kw)
    auto_cfg = cfg if case != "rdoq_off" else dataclasses.replace(
        cfg, rdoq=True)            # the TU backend codes RDOQ regardless

    def run(backend, c):
        enc = AIEncoder(c, cnn=cnn, device="cpu", recon_backend=backend)
        rc = (RateController(60_000, 30, 128, 64, n_frames=2, init_qp=29)
              if case == "rate_control" else None)
        return enc.encode(frames, rate_control=rc)[0], enc.frame_qps

    got, got_qps = run("tu", cfg)
    want, want_qps = run("auto", auto_cfg)
    assert got == want and got_qps == want_qps
    if case == "rate_control":
        assert got_qps[0] == 29 and got != streams["auto"][0]
