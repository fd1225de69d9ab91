"""PyTorch port, host-side copies: the copied core / entropy / native
modules give the same bytes and arrays as the originals, and nothing in
the port imports jax or the JAX package."""

import ast
import os

import numpy as np
import pytest

import hevc_tpu.core.yuv as j_yuv
import hevc_tpu.core.zorder as j_zorder
import hevc_tpu.entropy.headers as j_headers
import hevc_tpu.entropy.scan as j_scan
import hevc_tpu.native as j_native
import hevc_tpu.pipeline.golden as j_golden
import hevc_tpu.pipeline.ratectrl as j_ratectrl
from hevc_tpu.entropy.slice_enc import SliceEncoder as JSliceEncoder
import hevc_tpu_torch.core.yuv as t_yuv
import hevc_tpu_torch.core.zorder as t_zorder
import hevc_tpu_torch.entropy.headers as t_headers
import hevc_tpu_torch.entropy.scan as t_scan
import hevc_tpu_torch.native as t_native
import hevc_tpu_torch.pipeline.golden as t_golden
import hevc_tpu_torch.pipeline.ratectrl as t_ratectrl
from hevc_tpu_torch.ops.sao import SaoParams
from hevc_tpu_torch.entropy.slice_enc import SliceEncoder as TSliceEncoder

from tests.test_e2e_bitstream import legalize_depth, synth_frame

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
W, H, QP = 128, 64, 30


def _decisions(seed=4):
    """Seeded decisions with NxN CUs and sparse coefficients."""
    rng = np.random.RandomState(seed)
    d8 = legalize_depth(rng.randint(0, 4, (H // 8, W // 8)).astype(np.int32))
    m8 = rng.randint(0, 35, (H // 8, W // 8)).astype(np.int32)
    m4 = np.repeat(np.repeat(m8, 2, 0), 2, 1)
    nxn = (d8 == 3) & (rng.rand(H // 8, W // 8) < 0.4)
    for yy, xx in zip(*np.nonzero(nxn)):
        m4[2 * yy:2 * yy + 2, 2 * xx:2 * xx + 2] = rng.randint(0, 35, (2, 2))
    m8 = m4[::2, ::2].copy()

    def coef(h, w):
        return (rng.laplace(0, 2.0, (h, w))
                * (rng.rand(h, w) < 0.15)).astype(np.int32)

    return dict(depth8=d8, modes8=m8, modes4=m4, nxn8=nxn,
                coef_y=coef(H, W), coef_cb=coef(H // 2, W // 2),
                coef_cr=coef(H // 2, W // 2))


def _python_slice(headers, encoder_cls, d):
    cfg = headers.EncoderConfig(W, H, qp=QP)
    bw = headers.start_idr_slice(cfg, QP)
    encoder_cls(cfg, QP).encode(bw, d["depth8"], d["modes8"], d["coef_y"],
                                d["coef_cb"], d["coef_cr"],
                                modes4=d["modes4"], nxn8=d["nxn8"])
    return headers.finish_slice_nal(bw)


def _check_headers():
    for kw in (dict(width=W, height=H, qp=QP), dict(width=96, height=80),
               dict(width=1920, height=1080, qp=32)):
        a, b = t_headers.EncoderConfig(**kw), j_headers.EncoderConfig(**kw)
        assert (a.pad_width, a.pad_height, a.ctus_x, a.ctus_y) == \
            (b.pad_width, b.pad_height, b.ctus_x, b.ctus_y)
        for fn in ("write_vps", "write_sps", "write_pps"):
            assert getattr(t_headers, fn)(a) == getattr(j_headers, fn)(b)
        assert t_headers.start_idr_slice(a, 31).get_bytes() == \
            j_headers.start_idr_slice(b, 31).get_bytes()


def _check_python_cabac():
    d = _decisions()
    assert _python_slice(t_headers, TSliceEncoder, d) == \
        _python_slice(j_headers, JSliceEncoder, d)


def _check_native_cabac():
    d = _decisions(seed=9)
    args = (d["depth8"], d["modes8"], d["coef_y"], d["coef_cb"],
            d["coef_cr"], W, H, QP)
    kw = dict(modes4=d["modes4"], nxn8=d["nxn8"])
    got = t_native.encode_slice_data(*args, **kw)
    assert got == j_native.encode_slice_data(*args, **kw)
    # ... and the port's native coder equals the port's Python coder
    cfg = t_headers.EncoderConfig(W, H, qp=QP)
    bw = t_headers.start_idr_slice(cfg, QP)
    from hevc_tpu_torch.entropy.bitstream import NAL_IDR_W_RADL, nal_unit
    assert nal_unit(NAL_IDR_W_RADL, bw.get_bytes() + got) == \
        _python_slice(t_headers, TSliceEncoder, d)
    assert os.path.dirname(t_native._SO).endswith(
        os.path.join("hevc_tpu_torch", "build"))


def _check_native_cabac_sao():
    """One SaoParams with all three types, merge candidates (equal
    neighbours) and signed offsets: the same slice bytes from both native
    coders, and a different stream than without SAO."""
    d = _decisions(seed=5)
    B = (W // 64) * (H // 64)
    rng = np.random.RandomState(6)
    t = np.array([[2, 2], [1, 0]], np.int32)
    sao = SaoParams(
        type_idx=np.concatenate([t, t[1:]]),
        eo_class=rng.randint(0, 4, (3, B)).astype(np.int32),
        band_pos=rng.randint(0, 32, (3, B)).astype(np.int32),
        offsets=np.stack([np.tile([[3, 1, -1, -4]], (B, 1)),
                          rng.randint(-7, 8, (B, 4)),
                          rng.randint(-7, 8, (B, 4))]).astype(np.int32))
    args = (d["depth8"], d["modes8"], d["coef_y"], d["coef_cb"],
            d["coef_cr"], W, H, QP)
    kw = dict(modes4=d["modes4"], nxn8=d["nxn8"])
    got = t_native.encode_slice_data(*args, **kw, sao=sao)
    assert got == j_native.encode_slice_data(*args, **kw, sao=sao)
    assert got != t_native.encode_slice_data(*args, **kw)


def _check_ratectrl():
    """Both controllers give the same QPs over one sequence of bit counts
    (the picture level and the per-CTU map of LCURateController)."""
    kw = dict(target_bps=2_000_000, fps=30, width=416, height=240,
              n_frames=8, init_qp=30)
    bits = [90_000, 40_000, 120_000, 70_000, 20_000, 150_000, 60_000,
            80_000]
    mad = np.random.RandomState(3).rand(28) * 20
    for cls in ("RateController", "LCURateController"):
        a, b = getattr(t_ratectrl, cls)(**kw), getattr(j_ratectrl, cls)(**kw)
        qps = []
        for n in bits:
            qa, qb = a.pre_frame(), b.pre_frame()
            assert qa == qb
            qps.append(qa)
            if cls == "LCURateController":
                np.testing.assert_array_equal(a.pre_frame_lcu(mad, qa),
                                              b.pre_frame_lcu(mad, qb))
            a.post_frame(n)
            b.post_frame(n)
            assert (a.alpha, a.beta) == (b.alpha, b.beta)
        assert len(set(qps)) >= 3, qps
    assert t_ratectrl.lambda_to_qp(57.0) == j_ratectrl.lambda_to_qp(57.0)
    assert t_ratectrl.qp_to_lambda(31) == j_ratectrl.qp_to_lambda(31)


def _check_hash_sei():
    f = synth_frame(W, H, seed=2)
    for ht in ("md5", "crc", "checksum"):
        tid, hs = t_golden.pic_hashes(f, ht)
        jid, jhs = j_golden.pic_hashes(f, ht)
        assert (tid, hs) == (jid, jhs)
        assert t_headers.write_hash_sei(*hs, hash_type=tid) == \
            j_headers.write_hash_sei(*jhs, hash_type=jid)


def _check_yuv(tmp_path):
    f = synth_frame(96, 80, seed=1)
    tf = t_yuv.Frame(f.y, f.cb, f.cr)
    a, b = t_yuv.pad_frame(tf, 128, 128), j_yuv.pad_frame(f, 128, 128)
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p))
    np.testing.assert_array_equal(t_yuv.extract_ctus(a.y),
                                  j_yuv.extract_ctus(b.y))
    c = t_yuv.crop_frame(a, 96, 80)
    np.testing.assert_array_equal(c.y, f.y)
    assert t_yuv.psnr(a.y, a.y[::-1]) == j_yuv.psnr(b.y, b.y[::-1])
    path = str(tmp_path / "x.yuv")
    t_yuv.write_yuv420(path, [tf])
    np.testing.assert_array_equal(j_yuv.read_yuv420(path, 96, 80)[0].cr, f.cr)
    np.testing.assert_array_equal(t_yuv.read_yuv420(path, 96, 80)[0].y, f.y)


def _check_zorder_scan():
    np.testing.assert_array_equal(t_zorder.frame_zmap(96, 80),
                                  j_zorder.frame_zmap(96, 80))
    plane = np.arange(96 * 80, dtype=np.int32).reshape(80, 96) % 251
    zmap = t_zorder.frame_zmap(96, 80)
    for (x0, y0, n) in ((0, 0, 8), (64, 16, 16), (32, 64, 4)):
        np.testing.assert_array_equal(t_zorder.gather_refs(plane, x0, y0, n),
                                      j_zorder.gather_refs(plane, x0, y0, n))
        np.testing.assert_array_equal(
            t_zorder.avail_mask(x0, y0, n, 96, 80, zmap),
            j_zorder.avail_mask(x0, y0, n, 96, 80, zmap))
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(
            t_scan.grouped_scan(t_scan.SCAN_DIAG, n),
            j_scan.grouped_scan(j_scan.SCAN_DIAG, n))
    np.testing.assert_array_equal(t_scan.GROUP_IDX, j_scan.GROUP_IDX)


@pytest.mark.parametrize("what", ["headers", "python_cabac", "native_cabac",
                                  "native_cabac_sao", "ratectrl", "hash_sei",
                                  "yuv", "zorder_scan"])
def test_copied_module_matches_original(what, tmp_path):
    check = globals()["_check_" + what]
    check(tmp_path) if what == "yuv" else check()


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "bench_torch.py"),
           os.path.join(ROOT, "tools", "profile_torch_ai.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "hevc_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 25
    banned = ("jax", "hevc_tpu", "flax", "optax")
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
        # and no import by string
        with open(path) as f:
            text = f.read()
        assert "import_module(" not in text and "__import__(" not in text, path
