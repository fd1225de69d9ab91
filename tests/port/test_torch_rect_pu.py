"""PyTorch port, the JAX encoder's default Low-Delay-P operating point:
`p_search_frame(rect_pu=True)` (2NxN and Nx2N PUs) against several
reference pictures, and `LDPEncoder(cfg)` at its defaults (`tree="full"`,
`rect_pu=True`) with `cfg.num_refs` 2 or 4 and under a picture-level
`RateController`, on the CPU against the JAX package on the same
numpy-seeded inputs.

Every output compared is an integer or a byte string, so the tolerance is
0. The content is the port's `bench_hooks.synth_shear`: bands moving in
opposite directions (rectangular PUs) and a texture that alternates from
frame to frame (references other than the newest). The JAX search runs
as the JAX encoder runs it: `jax.jit` of `p_search_frame` with a traced
frame QP and a static `qp_set`. Each such program takes minutes to
compile on the CPU, so the file builds two, one per test function, and
makes every check of that function on it."""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.core.yuv import read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.ops import deblock as j_dbk
from hevc_tpu.pipeline import ai as j_ai
from hevc_tpu.pipeline import pframe as j_pframe
from hevc_tpu.pipeline import psearch as j_psearch
from hevc_tpu.pipeline import ratectrl as j_rc
from hevc_tpu.pipeline import search as j_search
from hevc_tpu_torch.core.yuv import pad_frame
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.models import hcpm as t_hcpm
from hevc_tpu_torch.pipeline import bench_hooks
from hevc_tpu_torch.pipeline import pframe as t_pframe
from hevc_tpu_torch.pipeline import psearch as t_psearch
from hevc_tpu_torch.pipeline import ratectrl as t_rc

from tests.port.test_torch_deblock import normative_edge_masks
from tests.port.torch_threads import one_torch_thread  # noqa: F401

LSTM = "models/eth_lstm_qp30~35.npz"
W = H = 128
GOP_QPS = (32, 33, 34, 35)          # QP 32 with the GOP-4 offsets
# every QP a RateController starting at 32 can reach in four pictures
# (it moves at most 3 a picture): the JAX encoder's `extra_qps`, so that
# one compiled search serves the GOP QPs and the controller's
RC_QPS = tuple(range(23, 42))
QP_SET = tuple(sorted(set(GOP_QPS) | set(RC_QPS)))
LDP_THR = (t_hcpm.DEFAULT_LDP.up, t_hcpm.DEFAULT_LDP.down)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _j_search(thr, qp_set):
    """`jax.jit(p_search_frame)` with the static arguments the JAX
    `LDPEncoder._search_fn` gives it at its defaults (rectangular PUs,
    RDOQ on, max_depth 3)."""
    kw = dict(pad_w=W, pad_h=H, use_rdoq=True, max_depth=3, rect_pu=True,
              qp_set=qp_set)
    if thr is not None:
        kw.update(thr_up=thr[0], thr_down=thr[1])
    return jax.jit(functools.partial(j_psearch.p_search_frame, **kw))


def _planes(f):
    return [np.asarray(p, np.int32) for p in (f.y, f.cb, f.cr)]


def _search_both(program, n_refs, qp, hcpm=None, thr=None):
    """The port's and the JAX search of shear frame 3 against frames 2,
    1, ... (`n_refs` of them, all active): every field of PSearchResult
    equal (dtype, shape, values). Returns the port's result."""
    frames = bench_hooks.synth_shear(4, W, H)
    cur = _planes(frames[3])
    ref = [np.stack(p) for p in zip(*(_planes(frames[2 - r])
                                      for r in range(n_refs)))]
    org = j_search.ctu_grid(W, H)
    want = program(*cur, *ref, jnp.asarray(org), qp=jnp.int32(qp),
                   hcpm_probs=None if hcpm is None else jnp.asarray(hcpm),
                   n_active_refs=jnp.int32(n_refs))
    kw = {} if thr is None else dict(thr_up=thr[0], thr_down=thr[1])
    got = t_psearch.p_search_frame(
        *(torch.from_numpy(p) for p in cur + ref), torch.from_numpy(org),
        qp=qp, pad_w=W, pad_h=H, n_active_refs=n_refs,
        hcpm_probs=None if hcpm is None else torch.from_numpy(hcpm), **kw)
    assert got._fields == want._fields + ("mode8",)
    for name, x in zip(want._fields, want):
        g, x = getattr(got, name).numpy(), np.asarray(x)
        assert g.shape == x.shape, name
        assert g.dtype == x.dtype, name
        np.testing.assert_array_equal(g, x, err_msg=name)
    return got


def _assert_rect(results, older_refs=True):
    """Both rectangular shapes were chosen, each counted as AMVP in
    mode8, and (with several references) a reference other than the
    newest."""
    part8 = np.stack([r.part8.numpy() for r in results])
    mode8 = np.stack([r.mode8.numpy() for r in results])
    assert (part8 == 1).any() and (part8 == 2).any()
    assert (mode8[part8 > 0] == t_psearch.AMVP).all()
    assert not (np.stack([r.intra8.numpy() for r in results])
                & (part8 > 0)).any()
    if older_refs:
        assert any((r.ref8 > 0).any() for r in results)


def test_rect_search_matches_jax():
    """Ungated, one reference: the port's search equals the JAX one in
    every field, and rectangular PUs of both shapes were chosen."""
    res = _search_both(_j_search(None, GOP_QPS), 1, 35)
    _assert_rect([res], older_refs=False)
    assert (res.depth8 > 0).any() and (res.mv8 % 4 != 0).any()


def _lstm_params():
    with np.load(LSTM) as z:
        return {k: z[k] for k in z.files}


def _capture_searches(enc):
    """Wrap enc.finish_p_frame to keep each P-frame's search result."""
    seen = []
    finish = enc.finish_p_frame

    def wrapped(pf, cur, res, *a, **k):
        seen.append(res)
        return finish(pf, cur, res, *a, **k)

    enc.finish_p_frame = wrapped
    return seen


def _jax_encoder(program, lstm):
    """The JAX `LDPEncoder(cfg)` at its defaults, `num_refs=2`, with the
    golden IDR backend and the given search program for its key."""
    jenc = j_pframe.LDPEncoder(
        j_headers.EncoderConfig(W, H, qp=32, num_refs=2), lstm_params=lstm)
    jenc.intra = j_ai.AIEncoder(j_headers.EncoderConfig(W, H, qp=32))
    jenc.intra.recon_backend = "golden"
    jenc.extra_qps = RC_QPS
    assert jenc._qp_set() == QP_SET
    jenc._p_jit[(QP_SET, True, 3, False)] = program
    return jenc


def _rc(mod, n):
    # a target well below what QP 32 gives: the QP climbs
    return mod.RateController(40_000, 30, W, H, n_frames=n, init_qp=32)


def test_rect_streams_match_jax():
    """One JAX search program, LSTM-gated with two references: the search
    with seeded HCPMs; then IDR + 3 P-frames of the shear clip through
    the port's `LDPEncoder(cfg, tree="full")` at its default
    `rect_pu=True` with the shipped ETH-LSTM (filters off), against the
    JAX `LDPEncoder(cfg)` with the golden IDR backend: streams,
    reconstructions and frame QPs equal, at the GOP QPs and under a
    picture-level RateController whose QPs leave the GOP set."""
    program = _j_search(LDP_THR, QP_SET)
    hcpm = np.random.RandomState(4).uniform(0, 1, (4, 21)).astype(np.float32)
    res = _search_both(program, 2, 34, hcpm=hcpm, thr=LDP_THR)
    _assert_rect([res])

    frames = bench_hooks.synth_shear(4, W, H)
    lstm = _lstm_params()
    cfg = EncoderConfig(W, H, qp=32, num_refs=2)
    jenc = _jax_encoder(program, lstm)
    for rate_control in (False, True):
        enc = t_pframe.LDPEncoder(cfg, lstm_params=lstm, tree="full",
                                  device="cpu")
        assert enc.rect_pu
        seen = _capture_searches(enc)
        ts, tr = enc.encode(frames, rate_control=_rc(t_rc, 4)
                            if rate_control else None)
        js, jr = jenc.encode([JFrame(f.y, f.cb, f.cr) for f in frames],
                             rate_control=_rc(j_rc, 4)
                             if rate_control else None)
        assert enc.frame_qps == jenc.frame_qps
        if rate_control:
            assert len(set(enc.frame_qps) - set(GOP_QPS)) >= 2
        else:
            assert enc.frame_qps == [32, 35, 34, 35]
        assert ts == js
        assert len(tr) == len(jr) == 4
        for a, b in zip(tr, jr):
            for p in ("y", "cb", "cr"):
                np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                              err_msg=p)
        assert len(seen) == 3
        _assert_rect(seen)


def test_rect_filtered_p_frames_match_jax_finish(monkeypatch):
    """Deblocking and SAO on: the port's `finish_p_frame` of two P-frames
    searched with rectangular PUs against two references, against the
    JAX `finish_p_frame` given the same search result (so `part8` reaches
    the deblocking, PU edges included) with the normative TU edges of
    rectangular CUs (`normative_edge_masks`): reconstruction planes and
    NAL bytes equal; the filters changed the picture."""
    frames = bench_hooks.synth_shear(4, W, H)
    cfg = EncoderConfig(W, H, qp=32, num_refs=2, deblock=True, sao=True)
    enc = t_pframe.LDPEncoder(cfg, tree="full", device="cpu")
    plain = t_pframe.LDPEncoder(EncoderConfig(W, H, qp=32, num_refs=2),
                                tree="full", device="cpu")
    jenc = j_pframe.LDPEncoder(j_headers.EncoderConfig(
        W, H, qp=32, num_refs=2, deblock=True, sao=True))
    results = []
    for poc in (2, 3):
        qp = enc._frame_qp(poc)
        pf = pad_frame(frames[poc], W, H)
        cur = enc._upload(pf)
        refs = [enc._upload(pad_frame(frames[poc - 1 - r], W, H))
                for r in range(2)]
        res = t_psearch.p_search_frame(
            *cur, *(torch.stack([r[c] for r in refs]) for c in range(3)),
            enc._origins, qp=qp, pad_w=W, pad_h=H, n_active_refs=2)
        results.append(res)
        rec, ref, chunk = enc.finish_p_frame(pf, cur, res, poc, qp, 2)
        fields = j_psearch.PSearchResult._fields
        jres = j_psearch.PSearchResult(*(getattr(res, k).numpy()
                                         for k in fields))
        with monkeypatch.context() as m:
            m.setattr(j_dbk, "edge_masks", normative_edge_masks)
            jrec, jchunk = jenc.finish_p_frame(
                JFrame(pf.y, pf.cb, pf.cr), jres, poc, qp, 2)
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(jrec, p),
                                          err_msg=p)
        assert chunk == jchunk
        for p, r in zip((rec.y, rec.cb, rec.cr), ref):
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(r.numpy(), p)
        unfiltered, _, _ = plain.finish_p_frame(pf, cur, res, poc, qp, 2)
        assert not np.array_equal(unfiltered.y, rec.y)
    _assert_rect(results)


def test_rect_multiref_stream_decodes_in_hm(tmp_path):
    """Five 128x128 shear frames through the port's `LDPEncoder(cfg)` at
    its defaults with `num_refs=4` (the reference cfg's value), the
    shipped ETH-LSTM, deblocking and SAO: HM decodes the stream with
    matching MD5 SEI, its last P slice lists four references, and the
    decoded pictures equal the encoder's reconstructions."""
    frames = bench_hooks.synth_shear(5, W, H)
    cfg = EncoderConfig(W, H, qp=32, num_refs=4, deblock=True, sao=True)
    enc = t_pframe.LDPEncoder(cfg, lstm_params=_lstm_params(), device="cpu")
    seen = _capture_searches(enc)
    stream, recons = enc.encode(frames)
    _assert_rect(seen)
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: stream made, decode not")
    rc, log, rec_path = hm.decode_bytes(stream, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    assert "[L0 3 2 1 0 ]" in log, log
    dec = read_yuv420(rec_path, W, H)
    assert len(dec) == 5
    for d, r in zip(dec, recons):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p),
                                          err_msg=p)
