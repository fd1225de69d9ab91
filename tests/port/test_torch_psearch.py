"""PyTorch port, the CU-tree P search and the full-tree Low-Delay-P
encoder: `hevc_tpu_torch.pipeline.psearch`, `intra_p`, the NumPy TU coder
of `golden` and the NumPy intra twins of `ops.intra`, and
`LDPEncoder(tree="full", rect_pu=False)`, on the CPU against the JAX
package on the same numpy-seeded inputs.

Every output compared is an integer or a float32 bit pattern, so the
tolerance is 0. The JAX search runs as the JAX encoder runs it: `jax.jit`
of `p_search_frame` with a traced frame QP and a static `qp_set`. Each
JAX program costs tens of seconds to compile, so each test function holds
one program and makes every check on it."""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.core import zorder as j_zorder
from hevc_tpu.core.yuv import Frame as JFrame
from hevc_tpu.core.yuv import read_yuv420
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.evaltools import hm
from hevc_tpu.models import hcpm as j_hcpm
from hevc_tpu.ops import intra as j_intra
from hevc_tpu.pipeline import ai as j_ai
from hevc_tpu.pipeline import golden as j_golden
from hevc_tpu.pipeline import intra_p as j_intra_p
from hevc_tpu.pipeline import pframe as j_pframe
from hevc_tpu.pipeline import psearch as j_psearch
from hevc_tpu.pipeline import search as j_search
from hevc_tpu_torch.core import zorder as t_zorder
from hevc_tpu_torch.core.yuv import pad_frame
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.models import hcpm as t_hcpm
from hevc_tpu_torch.ops import intra as t_intra
from hevc_tpu_torch.pipeline import golden as t_golden
from hevc_tpu_torch.pipeline import intra_p as t_intra_p
from hevc_tpu_torch.pipeline import pframe as t_pframe
from hevc_tpu_torch.pipeline import psearch as t_psearch
from hevc_tpu_torch.pipeline import search as t_search

from tests.port.test_torch_pframe import _p_maps, _sequence
from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

LSTM = "models/eth_lstm_qp30~35.npz"
GOP_QPS = (32, 33, 34, 35)          # QP 32 with the GOP-4 offsets
LDP_THR = ((0.6, 0.7, 0.8), (0.4, 0.3, 0.2))


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _j_search(pad_w, pad_h, thr=None, max_depth=3, intra_in_p=True):
    """`jax.jit(p_search_frame)` with the static arguments the JAX
    `LDPEncoder._search_fn` gives it (square PUs, RDOQ on, the GOP QPs):
    one program per distinct set of arguments, however they are passed."""
    return _j_search_program(pad_w, pad_h, thr, max_depth, intra_in_p)


@functools.lru_cache(maxsize=None)
def _j_search_program(pad_w, pad_h, thr, max_depth, intra_in_p):
    kw = dict(pad_w=pad_w, pad_h=pad_h, use_rdoq=True, max_depth=max_depth,
              rect_pu=False, qp_set=GOP_QPS)
    if not intra_in_p:
        kw.update(intra_in_p=False)
    if thr is not None:
        kw.update(thr_up=thr[0], thr_down=thr[1])
    return jax.jit(functools.partial(j_psearch.p_search_frame, **kw))


def _search_inputs(w, h, seed):
    """A reference frame and a current frame: the reference moved by a
    quarter-sample blend with small noise (merge candidates agree over
    the moving area), a 32x32 noise patch (splits) and a flat bright
    32x32 block that is not in the reference (intra)."""
    rng = np.random.RandomState(seed)
    f0 = synth_frame(w, h, seed=seed)
    a = np.roll(f0.y, (1, 2), axis=(0, 1)).astype(np.int32)
    b = np.roll(a, (0, 1), axis=(0, 1))
    y = (3 * a + b + 2) // 4 + rng.randint(-2, 3, a.shape)
    cur = [np.clip(y, 0, 255).astype(np.int32),
           np.roll(f0.cb, (0, 1), (0, 1)).astype(np.int32),
           np.roll(f0.cr, (0, 1), (0, 1)).astype(np.int32)]
    cur[0][8:40, w - 58:w - 26] = rng.randint(0, 256, (32, 32))
    cur[0][32:64, 0:32] = 200
    ref = [p.astype(np.int32) for p in (f0.y, f0.cb, f0.cr)]
    return cur, ref


def _hcpm(B, seed):
    """Seeded HCPMs spread across the LDP thresholds."""
    return np.random.RandomState(seed).uniform(0, 1, (B, 21)
                                                ).astype(np.float32)


def _run_both(w, h, qp, *, thr=None, hcpm=None, max_depth=3,
              intra_in_p=True, seed=1):
    """The port's and the JAX search on `_search_inputs`; asserts every
    field of PSearchResult equal (dtype, shape, values) and returns the
    port's result with its CU mode map."""
    cur, ref = _search_inputs(w, h, seed)
    org = j_search.ctu_grid(w, h)
    want = _j_search(w, h, thr, max_depth, intra_in_p)(
        *cur, *(p[None] for p in ref), jnp.asarray(org), qp=jnp.int32(qp),
        hcpm_probs=None if hcpm is None else jnp.asarray(hcpm),
        n_active_refs=jnp.int32(1))
    kw = {} if thr is None else dict(thr_up=thr[0], thr_down=thr[1])
    got = t_psearch.p_search_frame(
        *(torch.from_numpy(p) for p in cur),
        *(torch.from_numpy(p)[None] for p in ref), torch.from_numpy(org),
        qp=qp, pad_w=w, pad_h=h, max_depth=max_depth, intra_in_p=intra_in_p,
        rect_pu=False, hcpm_probs=None if hcpm is None
        else torch.from_numpy(hcpm), **kw)
    assert got._fields == want._fields + ("mode8",)
    for name, x in zip(want._fields, want):
        g, x = getattr(got, name).numpy(), np.asarray(x)
        assert g.shape == x.shape, name
        assert g.dtype == x.dtype, name
        np.testing.assert_array_equal(g, x, err_msg=name)
    return got, got.mode8.numpy()


def _assert_exercised(res, mode8, *, split=True, intra=True):
    """The content took the branches the case claims: merge or skip, a
    split, an intra CU (or none where intra-in-P is off)."""
    assert np.isin(mode8, (t_psearch.MERGE, t_psearch.SKIP)).any()
    assert (mode8 == t_psearch.AMVP).any()
    d8 = res.depth8.numpy()
    if split:
        assert (d8 > 0).any() and (d8 < 3).any()
    assert bool(res.intra8.any()) == intra
    assert np.array_equal(mode8 == t_psearch.INTRA, res.intra8.numpy())
    assert (res.mv8.numpy() % 4 != 0).any()          # fractional MVs


# ------------------------------------------------------ p_search_frame

_SEARCH_CASES = {
    # intra-in-P off: the search alone, ungated
    "no_intra": dict(w=128, h=64, qp=35, intra_in_p=False),
    # gated by seeded HCPMs, every CU level below 32x32 cut off
    "gated_max_depth_1": dict(w=128, h=64, qp=34, thr=LDP_THR, max_depth=1,
                              gated=True),
    # one CTU column, three rows: the neighbour grid's edges differ; the
    # gates change the tree against the ungated search
    "tall": dict(w=64, h=192, qp=33, thr=LDP_THR, gated=True,
                 gates_change_tree=True),
}


@pytest.mark.parametrize("case", list(_SEARCH_CASES))
def test_p_search_frame_matches_jax(case):
    c = dict(_SEARCH_CASES[case])
    w, h = c.pop("w"), c.pop("h")
    B = (w // 64) * (h // 64)
    hcpm = _hcpm(B, seed=B) if c.pop("gated", False) else None
    gates_change_tree = c.pop("gates_change_tree", False)
    qp = c.pop("qp")
    res, mode8 = _run_both(w, h, qp, hcpm=hcpm, **c)
    d8 = res.depth8.numpy()
    _assert_exercised(res, mode8, split=case != "gated_max_depth_1",
                      intra=c.get("intra_in_p", True))
    if case == "gated_max_depth_1":
        assert d8.max() <= 1 and (d8 == 1).any() and (d8 == 0).any()
    if gates_change_tree:
        cur, ref = _search_inputs(w, h, 1)
        ungated = t_psearch.p_search_frame(
            *(torch.from_numpy(p) for p in cur),
            *(torch.from_numpy(p)[None] for p in ref),
            torch.from_numpy(j_search.ctu_grid(w, h)), qp=qp, pad_w=w,
            pad_h=h, max_depth=c.get("max_depth", 3), rect_pu=False)
        assert not np.array_equal(ungated.depth8.numpy(), d8)


# ------------------------------------------------- LDPEncoder(tree="full")

def _stream_frames(w, h):
    """IDR + 3 P-frames: `_sequence`'s motion, plus a noise patch that
    appears in frame 2 and moves in frame 3."""
    frames = _sequence(w, h, 4, seed=3)
    rng = np.random.RandomState(5)
    frames[2].y[8:40, 70:102] = rng.randint(0, 256, (32, 32))
    frames[3].y[8:40, 70:102] = np.roll(frames[2].y[8:40, 70:102], 1, 1)
    frames[3].y[44:60, 4:20] = 230
    return frames


@functools.lru_cache(maxsize=None)
def _j_idr_encoder(w, h):
    """The JAX IDR encoder (golden backend, filters off) that every JAX
    `LDPEncoder` of this module shares, so that its program is compiled
    once per process."""
    enc = j_ai.AIEncoder(j_headers.EncoderConfig(w, h, qp=32))
    enc.recon_backend = "golden"
    return enc


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


@pytest.mark.parametrize("gating", ["ungated", "lstm"])
def test_full_tree_stream_matches_jax(gating):
    """One JAX search program per case: the search on `_search_inputs`
    at a GOP QP (seeded HCPMs at the LDP thresholds for the gated
    program), then IDR + 3 P-frames through `LDPEncoder(tree="full",
    rect_pu=False)` (filters off; the LSTM case with the shipped
    ETH-LSTM): the stream, the reconstructions and the frame QPs equal
    the JAX encoder's with the golden IDR backend and the same program."""
    w, h = 128, 64
    gated = gating == "lstm"
    thr = LDP_THR if gated else None
    res, mode8 = _run_both(w, h, 35, thr=thr,
                           hcpm=_hcpm(2, seed=11) if gated else None)
    _assert_exercised(res, mode8)

    frames = _stream_frames(w, h)
    kw = dict(lstm_params=_lstm_params()) if gated else {}
    enc = t_pframe.LDPEncoder(EncoderConfig(w, h, qp=32), tree="full",
                              rect_pu=False, device="cpu", **kw)
    seen = _capture_searches(enc)
    ts, tr = enc.encode(frames)
    stats = enc.last_stats
    jenc = j_pframe.LDPEncoder(j_headers.EncoderConfig(w, h, qp=32),
                               tree="full", rect_pu=False, **kw)
    jenc.intra = _j_idr_encoder(w, h)
    assert jenc._qp_set() == GOP_QPS
    jenc._p_jit[(GOP_QPS, gated, 3, False)] = _j_search(w, h, thr)
    js, jr = jenc.encode([JFrame(f.y, f.cb, f.cr) for f in frames])
    assert enc.frame_qps == jenc.frame_qps == [32, 35, 34, 35]
    assert ts == js
    assert len(tr) == len(jr) == 4
    for a, b in zip(tr, jr):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                          err_msg=p)
    assert set(stats) == {"decide_s", "recon_s", "entropy_s"}
    assert len(seen) == 3
    assert any(r.intra8.any() for r in seen)
    assert any((r.depth8 > 0).any() for r in seen)
    assert any(np.isin(r.mode8.numpy(), (t_psearch.MERGE, t_psearch.SKIP)
                       ).any() for r in seen)


def test_filtered_p_frames_match_jax_finish():
    """Deblocking and SAO on: the port's `finish_p_frame` of two searched
    P-frames (intra CUs re-coded on the host, then filtered) against the
    JAX `finish_p_frame` given the same search result: reconstruction
    planes and NAL bytes equal; the filters changed luma and chroma."""
    w, h = 128, 64
    frames = _stream_frames(w, h)
    cfg = EncoderConfig(w, h, qp=32, deblock=True, sao=True)
    enc = t_pframe.LDPEncoder(cfg, tree="full", rect_pu=False, device="cpu")
    plain = t_pframe.LDPEncoder(EncoderConfig(w, h, qp=32), tree="full",
                                rect_pu=False, device="cpu")
    jenc = j_pframe.LDPEncoder(
        j_headers.EncoderConfig(w, h, qp=32, deblock=True, sao=True),
        tree="full", rect_pu=False)
    prev = pad_frame(frames[1], w, h)
    n_intra = 0
    for poc in (2, 3):
        qp = enc._frame_qp(poc)
        pf = pad_frame(frames[poc], w, h)
        cur = enc._upload(pf)
        res = t_psearch.p_search_frame(
            *cur, *(p[None] for p in enc._upload(prev)), enc._origins,
            qp=qp, pad_w=w, pad_h=h, rect_pu=False)
        n_intra += int(res.intra8.sum())
        rec, ref, chunk = enc.finish_p_frame(pf, cur, res, poc, qp, 1)
        jres = j_psearch.PSearchResult(*(getattr(res, k).numpy()
                                         for k in j_psearch.PSearchResult._fields))
        jrec, jchunk = jenc.finish_p_frame(
            JFrame(pf.y, pf.cb, pf.cr), jres, poc, qp, 1)
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(rec, p), getattr(jrec, p),
                                          err_msg=p)
        assert chunk == jchunk
        for p, r in zip((rec.y, rec.cb, rec.cr), ref):
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(r.numpy(), p)
        unfiltered, _, _ = plain.finish_p_frame(pf, cur, res, poc, qp, 1)
        assert not np.array_equal(unfiltered.y, rec.y)
        assert not np.array_equal(unfiltered.cb, rec.cb)
        prev = rec
    assert n_intra > 0


def test_max_depth_exit_narrows_the_search():
    """max_depth_exit with thresholds that close every split gate: each
    P-frame's search stops at depth 0 (the forced-split floor at 128x64),
    the SATD kernel's plain version never runs for it, and the stream
    equals the one the full-depth search gives under the same gates."""
    from hevc_tpu_torch.ops import intra_mm
    w, h = 128, 64
    frames = _stream_frames(w, h)
    closed = t_hcpm.Thresholds(up=(1.1,) * 3, down=(1.0,) * 3)
    out = {}
    for exit_ in (False, True):
        enc = t_pframe.LDPEncoder(
            EncoderConfig(w, h, qp=32), lstm_params=_lstm_params(),
            thresholds=closed, tree="full", rect_pu=False,
            max_depth_exit=exit_, device="cpu")
        seen = _capture_searches(enc)
        calls = []
        plain = intra_mm.satd_all_modes_plain

        def counted(*a, **k):
            calls.append(a[3])
            return plain(*a, **k)

        intra_mm.satd_all_modes_plain = counted
        try:
            out[exit_] = enc.encode(frames)[0]
        finally:
            intra_mm.satd_all_modes_plain = plain
        assert all((r.depth8 == 0).all() for r in seen)
        # the IDR's node sizes 16, 8, 4, then 16 and 8 per P-frame unless
        # the search stops at depth 0
        assert calls == [16, 8, 4] + ([] if exit_ else [16, 8] * 3)
    assert out[True] == out[False]


def test_full_tree_stream_decodes_in_hm(tmp_path):
    """Four 128x64 frames through the LSTM-gated full tree with
    deblocking and SAO: HM decodes the stream with matching MD5 SEI and
    the decoded pictures equal the encoder's reconstructions."""
    w, h = 128, 64
    frames = _stream_frames(w, h)
    cfg = EncoderConfig(w, h, qp=32, deblock=True, sao=True)
    enc = t_pframe.LDPEncoder(cfg, lstm_params=_lstm_params(), tree="full",
                              rect_pu=False, device="cpu")
    seen = _capture_searches(enc)
    stream, recons = enc.encode(frames)
    assert any(r.intra8.any() for r in seen)
    if not hm.decoder_available():
        pytest.skip("HM decoder binary missing: stream made, decode not")
    rc, log, rec_path = hm.decode_bytes(stream, str(tmp_path))
    assert rc == 0, log
    assert "mismatch" not in log.lower(), log
    dec = read_yuv420(rec_path, w, h)
    assert len(dec) == 4
    for d, r in zip(dec, recons):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p),
                                          err_msg=p)


# --------------------------------------------------- float32 rate terms

_J_LAMBDA = jax.jit(lambda qp: (
    0.57 * jnp.exp2((jnp.asarray(qp, jnp.float32) - 12.0) / 3.0),
    jnp.exp2((jnp.asarray(qp, jnp.float32)
              - jnp.asarray(j_psearch.quant.chroma_qp(qp), jnp.float32))
             / 3.0)))


@pytest.mark.parametrize("qp", range(52))
def test_frame_lambda_bits_match_jax(qp):
    """lambda, sqrt(lambda) and the chroma distortion weight: the bits
    the JAX search computes from a traced QP (`psearch.py:208-210`,
    `:630-631`)."""
    lam, dist_w = (np.asarray(v) for v in _J_LAMBDA(jnp.int32(qp)))
    got = t_psearch.frame_lambda(qp)
    assert all(v.dtype == np.float32 for v in got)
    assert got[0].view(np.int32) == lam.view(np.int32)
    assert got[1] == np.sqrt(lam)
    assert got[2].view(np.int32) == dist_w.view(np.int32)


def test_mvd_bits_and_rate_table_match_jax():
    """The MVD rate over every MV difference the +-8 search can give
    (both components, both signs), and the rate table over its domain
    (the reference's `2 log2(k + 1) + 1`, which its compiled program
    fuses into one multiply-add)."""
    r = np.arange(-35, 36)
    mv = np.stack(np.meshgrid(r, r), -1).reshape(-1, 2).astype(np.int32)
    for pred in ((0, 0), (35, -35), (-13, 7)):
        p = np.broadcast_to(np.asarray(pred, np.int32), mv.shape)
        want = np.asarray(jax.jit(j_psearch._mvd_bits)(mv, p))
        got = t_psearch._mvd_bits(torch.from_numpy(mv),
                                  torch.from_numpy(p.copy())).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    tab = t_psearch._rate_table(torch.device("cpu")).numpy()
    assert tab.shape == (8 * t_psearch.RADIUS + 7,) == (71,)
    want = np.asarray(jax.jit(lambda k: 2.0 * jnp.log2(k + 1.0) + 1.0)(
        np.arange(71, dtype=np.float32)))
    np.testing.assert_array_equal(tab.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_gate_max_depth_matches_jax(seed):
    """The port's one `search.gate_max_depth` (AIEncoder and LDPEncoder
    both call it) against the JAX `pframe._gate_max_depth`: seeded HCPMs,
    scaled so that the deepest open gate varies with the seed; 128x64 and
    a 1080p-like padded size (forced-split floor 0)."""
    rng = np.random.RandomState(seed)
    probs = (rng.uniform(0, 1, (6, 21)) * (0.2 + 0.16 * seed)
             ).astype(np.float32)
    for thr in (t_hcpm.DEFAULT_LDP, t_hcpm.Thresholds(up=(0.5,) * 3,
                                                      down=(0.1, 0.2, 0.3))):
        jthr = j_hcpm.Thresholds(up=thr.up, down=thr.down)
        for pw, ph in ((128, 64), (1920, 1088)):
            got = t_search.gate_max_depth(torch.from_numpy(probs), thr, pw,
                                          ph)
            want = j_pframe._gate_max_depth(jnp.asarray(probs), jthr, pw, ph)
            assert got == want


# ------------------------------------------- host TU coder, intra twins

@pytest.mark.parametrize("component", ["luma", "chroma"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_np_twins_match_jax(n, component):
    """substitute_refs_np, filter_refs_np and predict_np of every mode on
    seeded references with seeded availability (none, some, all)."""
    rng = np.random.RandomState(n + len(component))
    r = rng.randint(0, 256, (6, 4 * n + 1)).astype(np.int32)
    avail = rng.rand(6, 4 * n + 1) < 0.6
    avail[0] = False
    avail[1] = True
    sub = t_intra.substitute_refs_np(r, avail)
    np.testing.assert_array_equal(sub, j_intra.substitute_refs_np(r, avail))
    filt = t_intra.filter_refs_np(sub)
    np.testing.assert_array_equal(filt, j_intra.filter_refs_np(sub))
    for mode in range(35):
        for refs in (sub, filt):
            got = t_intra.predict_np(refs, mode, n, component=component)
            want = j_intra.predict_np(refs, mode, n, component=component)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=str(mode))


@pytest.mark.parametrize("rdoq", [True, False])
@pytest.mark.parametrize("component", ["luma", "chroma"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_code_tu_matches_jax(n, component, rdoq):
    """`golden._code_tu` at several positions of a 128x64 (chroma 64x32)
    frame, every mode: the levels and the reconstruction written in
    place equal the JAX coder's."""
    rng = np.random.RandomState(n + 2 * rdoq + len(component))
    luma = component == "luma"
    pw, ph = (128, 64) if luma else (64, 32)
    kw = dict(component=component, pad_w=pw, pad_h=ph, rdoq=rdoq,
              scale=1 if luma else 2)
    orig = rng.randint(0, 256, (ph, pw)).astype(np.int32)
    orig = (orig + np.roll(orig, 1, 1) + np.roll(orig, 1, 0)) // 3
    zmap = t_zorder.frame_zmap(128, 64)
    np.testing.assert_array_equal(zmap, j_zorder.frame_zmap(128, 64))
    for mode in range(35):
        x0 = (mode * n) % (pw - n + 1) // n * n
        y0 = (mode * 3 * n) % (ph - n + 1) // n * n
        qp = 22 + mode % 16
        rec0 = rng.randint(0, 256, (ph, pw)).astype(np.int32)
        rec = [rec0.copy(), rec0.copy()]
        coef = [np.zeros((ph, pw), np.int32), np.zeros((ph, pw), np.int32)]
        t_golden._code_tu(orig, rec[0], coef[0], zmap, x0, y0, n, mode, qp,
                          **kw)
        j_golden._code_tu(orig, rec[1], coef[1], zmap, x0, y0, n, mode, qp,
                          **kw)
        np.testing.assert_array_equal(rec[0], rec[1], err_msg=str(mode))
        np.testing.assert_array_equal(coef[0], coef[1], err_msg=str(mode))
    assert coef[0].any()


@pytest.mark.parametrize("rdoq", [True, False])
def test_patch_intra_cus_matches_jax(rdoq):
    """`intra_p.patch_intra_cus` on a 128x64 frame with seeded quadtrees,
    intra CUs of every size and modes: the patched reconstruction and
    level planes equal the JAX pass's."""
    W, H, qp = 128, 64, 32
    m, levels = _p_maps(7, W, H, intra=True)
    assert m["intra8"].any() and not m["intra8"].all()
    f = synth_frame(W, H, seed=7)
    rng = np.random.RandomState(7)
    rec0 = [np.clip(p.astype(np.int32) + rng.randint(-9, 10, p.shape), 0, 255)
            for p in (f.y, f.cb, f.cr)]
    out = []
    for mod in (t_intra_p, j_intra_p):
        rec = [p.copy() for p in rec0]
        coef = [lv.copy() for lv in levels]
        mod.patch_intra_cus(f.y, f.cb, f.cr, *rec, *coef, m["depth8"],
                            m["intra8"], m["imode8"], qp, W, H, rdoq=rdoq)
        out.append(rec + coef)
    for name, a, b in zip(("rec_y", "rec_cb", "rec_cr", "coef_y", "coef_cb",
                           "coef_cr"), *out):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not np.array_equal(out[0][0], rec0[0])


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw", [
    dict(slice_mode="B", num_refs=2, cu_qp_delta=True),
    dict(cu_qp_delta=True),
    dict(rect_pu=False, slice_mode="B", cu_qp_delta=True),
    dict(rect_pu=False, cu_qp_delta=True)])
def test_full_tree_refusals(kw):
    kw = dict(kw)
    cfg = EncoderConfig(128, 64, num_refs=kw.pop("num_refs", 1),
                        cu_qp_delta=kw.pop("cu_qp_delta", False))
    with pytest.raises(NotImplementedError, match="M11"):
        t_pframe.LDPEncoder(cfg, tree="full", device="cpu", **kw)


@pytest.mark.parametrize("tree", ["full", "flat"])
def test_lcu_rate_control_refused(tree):
    """An LCU-level controller (it has `pre_frame_lcu`) needs a per-CTU
    QP: `encode` raises, naming M11, before it codes a picture."""
    from hevc_tpu_torch.pipeline.ratectrl import LCURateController
    enc = t_pframe.LDPEncoder(EncoderConfig(128, 64), tree=tree,
                              device="cpu")
    rc = LCURateController(60_000, 30, 128, 64, n_frames=2, init_qp=32)
    with pytest.raises(NotImplementedError, match="M11"):
        enc.encode(_stream_frames(128, 64)[:2], rate_control=rc)
    assert not hasattr(enc, "frame_qps")


def test_p_search_frame_refusals():
    cur, ref = _search_inputs(128, 64, 1)
    args = ([torch.from_numpy(p) for p in cur]
            + [torch.from_numpy(p)[None] for p in ref]
            + [torch.from_numpy(j_search.ctu_grid(128, 64))])
    with pytest.raises(NotImplementedError, match="M11"):
        t_psearch.p_search_frame(*args, qp=np.array([30, 34]), pad_w=128,
                                 pad_h=64, rect_pu=False)


def test_full_tree_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_pframe.LDPEncoder(EncoderConfig(128, 64), tree="full",
                            rect_pu=False)
