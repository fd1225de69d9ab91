"""PyTorch port, the flat-tree Low-Delay-P encoder:
`hevc_tpu_torch.pipeline.pframe` and `native.encode_slice_data_p` on the
CPU against the JAX `hevc_tpu.pipeline.pframe` and `hevc_tpu.native` on
the same numpy-seeded inputs. Every output here is an integer, so the
tolerance is 0: levels, reconstructions, MVs, slice bytes and streams are
equal. The port's filtered stream also decodes in the HM reference
decoder with matching MD5 SEI."""

import functools
import gc

import jax
import numpy as np
import pytest
import torch

from hevc_tpu import native as j_native
from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.core.yuv import pad_frame as j_pad_frame
from hevc_tpu.core.yuv import read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.pipeline import pframe as j_pframe
from hevc_tpu_torch import native as t_native
from hevc_tpu_torch.core.yuv import Frame, pad_frame
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.ops.sao import SaoParams
from hevc_tpu_torch.pipeline import pframe as t_pframe
from hevc_tpu_torch.pipeline import psearch as t_psearch

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


@functools.lru_cache(maxsize=None)
def _j_p_frame(pad_w, pad_h, qp):
    """The JAX flat P-frame program, compiled once per size and QP (the
    key of `LDPEncoder._search_fn` for tree='flat')."""
    return jax.jit(functools.partial(j_pframe.encode_p_frame_device, qp=qp,
                                     pad_w=pad_w, pad_h=pad_h))


def _j_encoder(cfg):
    """The JAX flat LDPEncoder with the golden IDR backend, its P-frame
    programs taken from `_j_p_frame`."""
    enc = j_pframe.LDPEncoder(cfg, tree="flat")
    enc.intra.recon_backend = "golden"
    for qp in {enc._frame_qp(poc) for poc in range(1, 5)}:
        enc._p_jit[("flat", qp)] = _j_p_frame(enc.cfg.pad_width,
                                              enc.cfg.pad_height, qp)
    return enc


def _sequence(w, h, n, seed):
    """n frames: a synth frame moved by np.roll each step, with small
    noise; a quarter-sample shift (3:1 blend of two rolls) gives odd
    quarter-pel MVs, and a flat 64x64 corner makes CTU 0 tie."""
    rng = np.random.RandomState(seed)
    frames = [synth_frame(w, h, seed=seed)]
    for i in range(1, n):
        prev = frames[-1]
        a = np.roll(prev.y, (-1, 3 - 2 * (i % 2)), axis=(0, 1))
        b = np.roll(a, (0, 1), axis=(0, 1))
        y = (3 * a.astype(np.int32) + b + 2) // 4 + rng.randint(-2, 3, a.shape)
        frames.append(Frame(np.clip(y, 0, 255).astype(np.uint8),
                            np.roll(prev.cb, (-1, 1), axis=(0, 1)),
                            np.roll(prev.cr, (0, 1), axis=(0, 1))))
    for f in frames:
        f.y[:64, :64] = 100
        f.cb[:32, :32] = 90
        f.cr[:32, :32] = 140
    return frames


def _jframes(frames):
    return [JFrame(f.y, f.cb, f.cr) for f in frames]


def _planes(frame):
    return [np.asarray(p, np.int32) for p in (frame.y, frame.cb, frame.cr)]


def _assert_frames_equal(a, b):
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                      err_msg=p)


# ------------------------------------- the flat tree's residual transform

@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("rdoq", [True, False])
@pytest.mark.parametrize("size,tu,is_luma", [(64, 32, True),
                                             (32, 16, False)])
def test_tile_tu_transform_matches_jax(size, tu, is_luma, rdoq, qp):
    """`psearch._tu_transform` at the flat tree's lambda of the QP given
    against the JAX `pframe._tile_tu_transform`."""
    rng = np.random.RandomState(size + qp + rdoq)
    tiles = (rng.laplace(0, 12.0, (2, size, size))
             + 20 * np.sin(np.arange(size) / 5.0)[None, :, None])
    tiles = np.clip(np.round(tiles), -255, 255).astype(np.int32)
    got = t_psearch._tu_transform(torch.from_numpy(tiles), qp, tu,
                                  t_pframe._qp_lambda(qp), rdoq,
                                  is_luma=is_luma)
    want = jax.jit(functools.partial(j_pframe._tile_tu_transform, qp=qp,
                                     tu=tu, rdoq=rdoq,
                                     is_luma=is_luma))(tiles)
    for name, g, x in zip(("levels", "recon_resi"), got, want):
        x = np.asarray(x)
        assert g.shape == x.shape == (2, size, size), name
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    assert got[0].abs().sum() > 0 and (got[0] == 0).any()


# -------------------------------------------------- encode_p_frame_device

@pytest.mark.parametrize("w,h,qp", [(128, 64, 35), (96, 80, 30)])
def test_encode_p_frame_device_matches_jax(w, h, qp):
    """96x80 is padded to 128x128 (whole CTUs, as LDPEncoder pads), so
    its last CTU row and column hold edge-padded samples."""
    cfg = EncoderConfig(w, h, qp=qp, pad_align=64)
    pw, ph = cfg.pad_width, cfg.pad_height
    f0, f1 = _sequence(w, h, 2, seed=w + h)
    cur = _planes(pad_frame(f1, pw, ph))
    ref = _planes(pad_frame(f0, pw, ph))
    stages = []
    got = t_pframe.encode_p_frame_device(
        *(torch.from_numpy(a) for a in cur + ref), qp=qp, pad_w=pw, pad_h=ph,
        stage_done=stages.append)
    assert stages == ["integer_search", "quarter_refine",
                      "motion_compensation", "transform"]
    want = _j_p_frame(pw, ph, qp)(*cur, *ref)
    names = ("lvl_y", "lvl_cb", "lvl_cr", "rec_y", "rec_cb", "rec_cr", "mv_q")
    dtypes = (torch.int16,) * 3 + (torch.uint8,) * 3 + (torch.int32,)
    for name, g, x, dt in zip(names, got, want, dtypes):
        x = np.asarray(x)
        assert g.dtype == dt and g.shape == x.shape, name
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    mv = got[6].numpy()
    assert tuple(mv[0]) == (-35, -35)       # the flat CTU: every tie
    assert (mv[1:] < 0).any() and (mv[1:] % 2 == 1).any(), mv
    assert got[0].abs().sum() > 0


# -------------------------------------------------- encode_slice_data_p

def _p_maps(seed, W, H, n_refs=1, intra=False, rect=False):
    """Valid P decision maps: a random quadtree per CTU (every CU's cells
    agree), per PU a random MV (and refIdx below n_refs), optionally
    intra CUs with a mode and rectangular PUs, plus sparse levels."""
    rng = np.random.RandomState(seed)
    H8, W8 = H // 8, W // 8
    m = dict(depth8=np.zeros((H8, W8), np.int32),
             mvq8=np.zeros((H8, W8, 2), np.int32),
             ref8=np.zeros((H8, W8), np.int32),
             intra8=np.zeros((H8, W8), bool),
             imode8=np.ones((H8, W8), np.int32),
             part8=np.zeros((H8, W8), np.int32))

    def pu(x, y, w, h):
        s8 = slice(y // 8, (y + h) // 8), slice(x // 8, (x + w) // 8)
        m["mvq8"][s8] = rng.randint(-24, 25, 2)
        m["ref8"][s8] = rng.randint(0, n_refs)

    def cu(x, y, size, depth):
        if depth < 3 and rng.rand() < 0.5:
            h = size // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                cu(x + dx, y + dy, h, depth + 1)
            return
        s8 = slice(y // 8, (y + size) // 8), slice(x // 8, (x + size) // 8)
        m["depth8"][s8] = depth
        part = rng.randint(0, 3) if rect and size > 8 else 0
        if intra and rng.rand() < 0.3:
            m["intra8"][s8] = True
            m["imode8"][s8] = rng.randint(0, 35)
        elif part == 0:
            pu(x, y, size, size)
        else:
            m["part8"][s8] = part
            h = size // 2
            if part == 1:
                pu(x, y, size, h)
                pu(x, y + h, size, h)
            else:
                pu(x, y, h, size)
                pu(x + h, y, h, size)

    for cy in range(H // 64):
        for cx in range(W // 64):
            cu(cx * 64, cy * 64, 64, 0)

    def coef(h, w, p, r):
        return (rng.randint(-r, r + 1, (h, w))
                * (rng.rand(h, w) < p)).astype(np.int32)

    levels = (coef(H, W, 0.1, 4), coef(H // 2, W // 2, 0.08, 3),
              coef(H // 2, W // 2, 0.05, 3))
    return m, levels


def _rand_sao(rng, n_ctu):
    return SaoParams(
        type_idx=rng.randint(0, 3, (3, n_ctu)).astype(np.int32),
        eo_class=rng.randint(0, 4, (3, n_ctu)).astype(np.int32),
        band_pos=rng.randint(0, 29, (3, n_ctu)).astype(np.int32),
        offsets=np.stack([rng.randint(0, 8, (3, n_ctu, 2)),
                          -rng.randint(0, 8, (3, n_ctu, 2))],
                         -1).reshape(3, n_ctu, 4).astype(np.int32))


_P_CASES = {
    "plain": dict(),
    "is_b": dict(is_b=True),
    "ref8": dict(n_refs=2, poc=3),
    "sao": dict(sao=True),
    "intra8": dict(intra=True),
    "part8": dict(rect=True),
    "qp_map": dict(qp_map=True),
}


@pytest.mark.parametrize("case", list(_P_CASES))
def test_encode_slice_data_p_matches_jax(case):
    W, H, qp = 192, 128, 30
    opt = _P_CASES[case]
    n_refs = opt.get("n_refs", 1)
    m, levels = _p_maps(len(case), W, H, n_refs=n_refs,
                        intra=opt.get("intra", False),
                        rect=opt.get("rect", False))
    kw = {}
    if case == "is_b":
        kw.update(is_b=True)
    if case == "ref8":
        kw.update(ref8=m["ref8"], n_refs=n_refs, poc=opt["poc"])
        assert m["ref8"].any()
    if case == "sao":
        kw.update(sao=_rand_sao(np.random.RandomState(3), 6))
    if case == "intra8":
        kw.update(intra8=m["intra8"], imode8=m["imode8"])
        assert m["intra8"].any() and not m["intra8"].all()
    if case == "part8":
        kw.update(part8=m["part8"])
        assert (m["part8"] == 1).any() and (m["part8"] == 2).any()
    if case == "qp_map":
        kw.update(qp_map=np.array([[34, 26, 30], [30, 38, 31]], np.int32))
    args = (m["depth8"], m["mvq8"], *levels, W, H, qp)
    got = t_native.encode_slice_data_p(*args, **kw)
    assert got == j_native.encode_slice_data_p(*args, **kw)
    if kw:                       # the option reaches the coder
        assert got != t_native.encode_slice_data_p(*args)


def test_encode_slice_data_p_refuses_qp_map_with_intra():
    m, levels = _p_maps(1, 128, 64, intra=True)
    args = (m["depth8"], m["mvq8"], *levels, 128, 64, 30)
    kw = dict(intra8=m["intra8"], imode8=m["imode8"],
              qp_map=np.full((1, 2), 30, np.int32))
    for native in (t_native, j_native):
        with pytest.raises(NotImplementedError):
            native.encode_slice_data_p(*args, **kw)


# ------------------------------------------------------------ LDPEncoder

def test_flat_stream_byte_identical_to_jax():
    """IDR + 3 P-frames at the GOP QPs 32, 35, 34, 35, filters off: the
    stream, the reconstructions and the frame QPs equal the JAX
    LDPEncoder(tree='flat')'s with the golden IDR backend."""
    w, h = 128, 64
    frames = _sequence(w, h, 4, seed=3)
    enc = t_pframe.LDPEncoder(EncoderConfig(w, h, qp=32), tree="flat",
                              device="cpu")
    ts, tr = enc.encode(frames)
    stats = enc.last_stats
    jenc = _j_encoder(j_headers.EncoderConfig(w, h, qp=32))
    js, jr = jenc.encode(_jframes(frames))
    assert enc.frame_qps == jenc.frame_qps == [32, 35, 34, 35]
    assert ts == js
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        _assert_frames_equal(a, b)
        assert a.y.shape == (h, w)
    assert set(stats) == {"decide_s", "recon_s", "entropy_s"}


def test_filtered_p_frames_match_jax_encode_flat():
    """Deblocking and SAO on: `_encode_flat` of two P-frames against the
    JAX `_encode_flat` on the same reference Frame: reconstruction planes
    and NAL bytes equal, the device reference equal to the host
    reconstruction, and the filters changed the luma reconstruction
    (chroma is deblocked only next to intra CUs, and there are none)."""
    w, h = 128, 64
    frames = _sequence(w, h, 3, seed=8)
    cfg = EncoderConfig(w, h, qp=32, deblock=True, sao=True)
    enc = t_pframe.LDPEncoder(cfg, tree="flat", device="cpu")
    plain = t_pframe.LDPEncoder(EncoderConfig(w, h, qp=32), tree="flat",
                                device="cpu")
    jenc = _j_encoder(j_headers.EncoderConfig(w, h, qp=32, deblock=True,
                                              sao=True))
    pw, ph = enc.cfg.pad_width, enc.cfg.pad_height
    prev = pad_frame(frames[0], pw, ph)
    for poc in (1, 2):
        qp = enc._frame_qp(poc)
        pf = pad_frame(frames[poc], pw, ph)
        rec, ref, chunk = enc._encode_flat(pf, enc._upload(prev), poc, qp)
        jrec, jchunk = jenc._encode_flat(j_pad_frame(_jframes([frames[poc]])[0],
                                                     pw, ph),
                                         JFrame(prev.y, prev.cb, prev.cr),
                                         poc, qp)
        _assert_frames_equal(rec, jrec)
        assert chunk == jchunk
        for p, r in zip((rec.y, rec.cb, rec.cr), ref):
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(r.numpy(), p)
        unfiltered, _, _ = plain._encode_flat(pf, plain._upload(prev), poc,
                                              qp)
        assert not np.array_equal(unfiltered.y, rec.y)
        prev = rec


def test_filtered_stream_decodes_in_hm(tmp_path):
    w, h = 128, 64
    frames = _sequence(w, h, 4, seed=5)
    cfg = EncoderConfig(w, h, qp=32, deblock=True, sao=True)
    stream, recons = t_pframe.LDPEncoder(cfg, tree="flat",
                                         device="cpu").encode(frames)
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: stream made, decode not")
    rc, log, rec_path = hm.decode_bytes(stream, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    dec = read_yuv420(rec_path, w, h)
    assert len(dec) == 4
    for d, r in zip(dec, recons):
        _assert_frames_equal(d, r)


@pytest.mark.parametrize("kw", [dict(tree="full", cu_qp_delta=True),
                                dict(tree="flat", slice_mode="B"),
                                dict(tree="flat", cu_qp_delta=True)])
def test_unported_options_raise(kw):
    kw = dict(kw)
    cfg = EncoderConfig(128, 64, cu_qp_delta=kw.pop("cu_qp_delta", False))
    with pytest.raises(NotImplementedError):
        t_pframe.LDPEncoder(cfg, device="cpu", **kw)


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_pframe.LDPEncoder(EncoderConfig(128, 64), tree="flat")


def test_gop_qps_and_padding():
    enc = t_pframe.LDPEncoder(EncoderConfig(416, 240, qp=49), tree="flat",
                              device="cpu")
    assert (enc.cfg.pad_width, enc.cfg.pad_height) == (448, 256)
    assert enc.intra.cfg is enc.cfg
    assert [enc._frame_qp(p) for p in range(6)] == [49, 51, 51, 51, 50, 51]
    flat = t_pframe.LDPEncoder(EncoderConfig(416, 240, qp=30), tree="flat",
                               use_gop_qp=False, device="cpu")
    assert {flat._frame_qp(p) for p in range(6)} == {30}


def test_flat_slice_data_independent_of_poc():
    """The flat tree passes no POC to the coder, so it codes every frame
    with poc=1 and ref_pocs=[0], as the reference does: with one
    reference the slice data do not depend on the POC."""
    rng = np.random.RandomState(2)
    W, H = 192, 128
    mvq8 = np.repeat(np.repeat(rng.randint(-30, 31, (2, 3, 2)), 8, 0), 8,
                     1).astype(np.int32)
    _, levels = _p_maps(2, W, H)
    args = (np.zeros((H // 8, W // 8), np.int32), mvq8, *levels, W, H, 32)
    want = t_native.encode_slice_data_p(*args)
    for poc in (2, 5, 300):
        assert t_native.encode_slice_data_p(*args, poc=poc) == want
