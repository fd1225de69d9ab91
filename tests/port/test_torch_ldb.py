"""PyTorch port, low-delay B: `LDPEncoder(cfg, slice_mode="B")` in the
CU-tree encoder, on the CPU against the JAX package on the same
numpy-seeded inputs, and against HM.

Low-delay B codes the decisions of the P path as B slices: both reference
lists hold the same pictures and every PU is uni-L0. In a B slice the zero
merge candidates are bi-predictive (H.265 8.5.3.2.5), so a PU whose
motion only such a candidate gives is coded by AMVP instead; the
reference's B coder matches it to the P slice's uni-L0 zero candidate,
which HM reads as a bi-predictive PU (ROADMAP Queue 3). The JAX side of
these tests therefore codes its B slices with its Python coder
(`PSliceEncoder(slice_type="B")`) and `b_slice_merge_candidates` in place
of `hevc_tpu.entropy.motion.merge_candidates`, and with that one rule
replaced the bytes must be equal (tolerance 0). The checks compose so
that no JAX rectangular-PU program is compiled: whole square-PU streams
against the JAX encoder; with rectangular PUs, two references and the
filters, the B reconstructions equal the port's own P ones and every B
slice equals the JAX header and Python B coder on the port's decisions."""

import numpy as np
import pytest

from hevc_tpu import native as j_native
from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.entropy import motion as j_motion
from hevc_tpu.entropy.slice_enc_p import PSliceEncoder
from hevc_tpu.pipeline import pframe as j_pframe
from hevc_tpu_torch.core.yuv import read_yuv420
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.evaltools import hm
from hevc_tpu_torch.pipeline import bench_hooks
from hevc_tpu_torch.pipeline import pframe as t_pframe

from tests.port.test_torch_psearch import (GOP_QPS, _j_idr_encoder,
                                           _j_search, _lstm_params,
                                           _release_compiled_programs,  # noqa: F401
                                           _stream_frames)
from tests.port.torch_threads import one_torch_thread  # noqa: F401

W, H = 128, 64


def b_slice_merge_candidates(field, x0, y0, size, n_active_refs=1,
                             max_cands=5, w=None, h=None, part_mode=0,
                             part_idx=0):
    """The merge candidate list of a B slice (8.5.3.2.2-5) over a uni-L0
    motion field, in the signature of the JAX `merge_candidates`: the
    spatial candidates as in a P slice, then the zero candidates, which in
    a B slice are bi-predictive, here (0, 0, refIdxL0, refIdxL1) so that
    no uni-L0 motion equals them. No neighbour carries L1 motion, so no
    combined bi-predictive candidate (8.5.3.2.4) arises."""
    w = size if w is None else w
    h = size if h is None else h
    at = j_motion._pu_aware_at(field, field.zmap[y0 >> 2, x0 >> 2], x0, y0,
                               size, part_mode, part_idx)
    a1 = None if (part_idx, part_mode) == (1, 2) else at(x0 - 1, y0 + h - 1)
    b1 = None if (part_idx, part_mode) == (1, 1) else at(x0 + w - 1, y0 - 1)
    b0, a0 = at(x0 + w, y0 - 1), at(x0 - 1, y0 + h)
    cands = [a1] if a1 is not None else []
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4:
        b2 = at(x0 - 1, y0 - 1)
        if b2 is not None and b2 != a1 and b2 != b1:
            cands.append(b2)
    zero_idx = 0
    while len(cands) < max_cands:
        r = zero_idx if zero_idx < n_active_refs else 0
        cands.append((0, 0, r, r))
        zero_idx += 1
    return cands[:max_cands]


def _python_b_coder(monkeypatch):
    """The JAX encoder's B slices through its Python coder with the B
    slice's merge list."""
    def no_native(*a, **k):
        raise NotImplementedError("the Python B coder")

    monkeypatch.setattr(j_native, "encode_slice_data_p", no_native)
    monkeypatch.setattr(j_motion, "merge_candidates",
                        b_slice_merge_candidates)


def _assert_frames_equal(a, b):
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                      err_msg=p)


def _record_slices(enc):
    """Wrap enc._p_slice_nal: keep each P/B slice's coder inputs and NAL."""
    seen, nal = [], enc._p_slice_nal

    def wrapped(bw, *a, **k):
        out = nal(bw, *a, **k)
        seen.append((a, k, out))
        return out

    enc._p_slice_nal = wrapped
    return seen


def _j_slice(jcfg, slice_type, args, kw):
    """The JAX header and Python coder of one P/B slice on the port's
    decisions (`_p_slice_nal`'s arguments)."""
    depth8, mvq8, cy, ccb, ccr, qp, sao = args
    n, poc = kw["n_refs"], kw["poc"]
    start = (j_headers.start_b_slice if slice_type == "B"
             else j_headers.start_p_slice)
    bw = start(jcfg, qp, poc, n)
    if sao is not None:
        sao = type(sao)(*(np.asarray(x) for x in sao))
    intra8 = kw["intra8"]
    PSliceEncoder(jcfg, qp, slice_type=slice_type, n_refs=n,
                  poc=poc).encode(
        bw, depth8, mvq8, cy, ccb, ccr, sao=sao, ref8=kw["ref8"],
        intra8=None if intra8 is None else np.asarray(intra8, bool),
        imode8=kw["imode8"], part8=kw["part8"])
    return j_headers.finish_p_slice_nal(bw)


def test_ldb_stream_matches_jax(monkeypatch):
    """IDR + 3 B-frames at 128x64, one reference, square PUs, filters
    off: the stream, the reconstructions and the frame QPs equal the JAX
    `LDPEncoder(cfg, slice_mode="B", rect_pu=False)`'s (golden IDR
    backend, the search program shared with test_torch_psearch), its B
    slices coded with the B slice's merge list. The reference's own B
    coder gives another stream here: the flat corner's zero motion is a
    zero candidate's."""
    frames = _stream_frames(W, H)
    enc = t_pframe.LDPEncoder(EncoderConfig(W, H, qp=32), tree="full",
                              rect_pu=False, slice_mode="B", device="cpu")
    ts, tr = enc.encode(frames)
    jenc = j_pframe.LDPEncoder(j_headers.EncoderConfig(W, H, qp=32),
                               tree="full", rect_pu=False, slice_mode="B")
    jenc.intra = _j_idr_encoder(W, H)
    assert jenc._qp_set() == GOP_QPS
    jenc._p_jit[(GOP_QPS, False, 3, False)] = _j_search(W, H)
    jframes = [JFrame(f.y, f.cb, f.cr) for f in frames]
    j_uni_zero, _ = jenc.encode(jframes)
    _python_b_coder(monkeypatch)
    js, jr = jenc.encode(jframes)
    assert j_uni_zero != js
    assert enc.frame_qps == jenc.frame_qps == [32, 35, 34, 35]
    assert ts == js
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        _assert_frames_equal(a, b)


@pytest.fixture(scope="module")
def rect_b():
    """Three 128x64 shear frames through the default `LDPEncoder(cfg)`
    (rectangular PUs, ETH-LSTM) with two references and deblocking and
    SAO on, as P and as B slices; each keeps its slices' coder inputs."""
    frames = bench_hooks.synth_shear(3, W, H)
    cfg = EncoderConfig(W, H, qp=32, num_refs=2, deblock=True, sao=True)
    lstm = _lstm_params()
    out = {}
    for mode in ("P", "B"):
        enc = t_pframe.LDPEncoder(cfg, lstm_params=lstm, slice_mode=mode,
                                  device="cpu")
        slices = _record_slices(enc)
        stream, recons = enc.encode(frames)      # two values, as the app
        out[mode] = (enc, stream, recons, slices)
    return frames, cfg, out


def test_ldb_recons_equal_ldp(rect_b):
    """The B path searches and reconstructs as the P path: the same
    recons and QPs, another stream (B slice syntax and contexts), the
    rectangular PUs and a second reference in use, and the timings on
    `last_stats`."""
    frames, _, out = rect_b
    (penc, ps, pr, pslices), (benc, bs, br, bslices) = out["P"], out["B"]
    assert len(br) == len(pr) == len(frames)
    for a, b in zip(br, pr):
        _assert_frames_equal(a, b)
    assert benc.frame_qps == penc.frame_qps
    assert bs != ps
    assert set(benc.last_stats) == {"decide_s", "recon_s", "entropy_s"}
    kw = [k for _, k, _ in bslices]
    assert [k["n_refs"] for k in kw] == [1, 2]
    assert any(k["part8"] is not None and k["part8"].any() for k in kw)


def test_ldb_slices_match_jax_coder(rect_b):
    """Every B slice NAL equals the JAX `start_b_slice` header plus the
    JAX Python `PSliceEncoder(slice_type="B")` fed the port's decisions
    under the B slice's merge list, and every P slice the JAX P header
    and coder under the P list."""
    _, cfg, out = rect_b
    jcfg = j_headers.EncoderConfig(W, H, qp=32, num_refs=2, deblock=True,
                                   sao=True, pad_align=64)
    for args, kw, nal in out["P"][3]:
        assert _j_slice(jcfg, "P", args, kw) == nal
    with pytest.MonkeyPatch().context() as m:
        m.setattr(j_motion, "merge_candidates", b_slice_merge_candidates)
        for args, kw, nal in out["B"][3]:
            assert _j_slice(jcfg, "B", args, kw) == nal


def test_ldb_stream_decodes_in_hm(rect_b, tmp_path):
    """HM decodes the filtered, rectangular, two-reference B stream with
    matching MD5, B slices at POC 1-2, into the encoder's recons."""
    frames, _, out = rect_b
    _, stream, recons, _ = out["B"]
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: stream made, decode not")
    rc, log, rec_path = hm.decode_bytes(stream, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    assert log.count("B-SLICE") == len(frames) - 1, log
    dec = read_yuv420(rec_path, W, H)
    assert len(dec) == len(frames)
    for d, r in zip(dec, recons):
        _assert_frames_equal(d, r)


def test_flat_tree_refuses_b():
    with pytest.raises(NotImplementedError, match="flat"):
        t_pframe.LDPEncoder(EncoderConfig(W, H, qp=32), tree="flat",
                            slice_mode="B", device="cpu")
    with pytest.raises(ValueError, match="slice_mode"):
        t_pframe.LDPEncoder(EncoderConfig(W, H, qp=32), slice_mode="I",
                            device="cpu")
