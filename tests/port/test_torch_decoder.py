"""PyTorch port, the decoder: `hevc_tpu_torch.decoder` (NAL and header
parsing, the I and P/B slice parsers, the reconstruction, the filters,
`decode_annexb`) on the CPU against the JAX decoder and against the
port encoder's reconstructions, on streams the port encodes from
numpy-seeded frames: All-Intra with NxN CUs, All-Intra with deblocking
and SAO, Low-Delay-P with rectangular PUs, two references and the
filters, and low-delay B with rectangular PUs and two references.

Every output compared is an integer, so the tolerance is 0. The JAX
decoder deblocks rectangular CUs as the JAX encoder does, one inner TU
edge short of HM (ROADMAP Queue 3), so its pictures are compared only on
the streams without filtered rectangular CUs; the port's decoder is held
to its encoder's HM-verified reconstructions everywhere."""

import functools

import numpy as np
import pytest

from hevc_tpu.decoder import decode_annexb as j_decode_annexb
from hevc_tpu.decoder import headers_dec as j_hd
from hevc_tpu.decoder import nal as j_nal
from hevc_tpu.decoder import slice_dec as j_sd
from hevc_tpu_torch.decoder import decode_annexb
from hevc_tpu_torch.decoder import headers_dec as t_hd
from hevc_tpu_torch.decoder import nal as t_nal
from hevc_tpu_torch.decoder import slice_dec as t_sd
from hevc_tpu_torch.entropy.headers import EncoderConfig
from hevc_tpu_torch.pipeline import bench_hooks
from hevc_tpu_torch.pipeline.ai import AIEncoder
from hevc_tpu_torch.pipeline.pframe import LDPEncoder

from tests.port.test_torch_psearch import _lstm_params
from tests.port.torch_threads import one_torch_thread  # noqa: F401
from tests.test_e2e_bitstream import synth_frame

STREAMS = ["ai_nxn", "ai_filtered", "ldp_rect_filtered", "ldb_rect"]
#: streams whose pictures the JAX decoder reconstructs as HM does, one
#: intra and one inter (its filters' programs cost half a minute more)
JAX_RECON_OK = ["ai_nxn", "ldb_rect"]


def _oriented_4x4(seed):
    """A 64x64 frame whose upper half is 4x4 blocks of horizontal or
    vertical stripes, at random: 8x8 CUs whose four 4x4 PUs want
    different modes (intra NxN)."""
    rng = np.random.RandomState(seed)
    f = synth_frame(64, 64, seed=seed)
    stripes = np.tile(np.array([40, 200, 40, 200], np.uint8)[:, None], (1, 4))
    for by in range(0, 32, 4):
        for bx in range(0, 64, 4):
            f.y[by:by + 4, bx:bx + 4] = (stripes if rng.rand() < 0.5
                                         else stripes.T)
    return f


@functools.lru_cache(maxsize=None)
def _stream(name):
    """(stream, recons, encoder) of one named test stream."""
    if name.startswith("ai"):
        filt = name == "ai_filtered"
        cfg = EncoderConfig(64, 64, qp=37 if filt else 32, deblock=filt,
                            sao=filt)
        frames = ([_oriented_4x4(s) for s in (3, 4)] if not filt
                  else [synth_frame(64, 64, seed=s) for s in (3, 4)])
        enc = AIEncoder(cfg, device="cpu")
        stream, recons, _ = enc.encode(frames)
        return stream, recons, enc
    filt = name == "ldp_rect_filtered"
    cfg = EncoderConfig(128, 64, qp=32, num_refs=2, deblock=filt, sao=filt)
    enc = LDPEncoder(cfg, lstm_params=_lstm_params(),
                     slice_mode="P" if filt else "B", device="cpu")
    stream, recons = enc.encode(bench_hooks.synth_shear(3, 128, 64))
    return stream, recons, enc


def _assert_equal_fields(a, b, where):
    """Dicts or dataclasses of arrays, SaoParams, ints: equal field by
    field (dtype-independent values, tolerance 0)."""
    a = a if isinstance(a, dict) else vars(a)
    b = b if isinstance(b, dict) else vars(b)
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = a[k], b[k]
        if x is None or y is None:
            assert x is None and y is None, (where, k)
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            assert x._fields == y._fields
            for f in x._fields:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                              err_msg=f"{where} {k}.{f}")
        elif isinstance(x, np.ndarray):
            assert x.shape == y.shape, (where, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{where} {k}")
        else:
            assert x == y, (where, k)


def _parse_both(stream):
    """Each NAL through both parsers; each slice through both slice
    decoders with the arguments `decode_annexb` gives them. Returns the
    number of slices of each type and the port's decoded slices."""
    jn, tn = j_nal.split_annexb(stream), t_nal.split_annexb(stream)
    assert jn == tn
    sps = pps = None
    poc, kinds, slices = 0, {}, []
    for nu in tn:
        if nu.nal_type == 33:
            sps, jsps = t_hd.parse_sps(nu.rbsp), j_hd.parse_sps(nu.rbsp)
            _assert_equal_fields(sps, jsps, "sps")
        elif nu.nal_type == 34:
            pps, jpps = t_hd.parse_pps(nu.rbsp), j_hd.parse_pps(nu.rbsp)
            _assert_equal_fields(pps, jpps, "pps")
        elif nu.nal_type in (39, 40):
            assert t_hd.parse_hash_sei(nu.rbsp) == j_hd.parse_hash_sei(
                nu.rbsp)
        elif nu.nal_type in (1, 19, 20):
            idr = nu.nal_type != 1
            sh = t_hd.parse_slice_header(nu.rbsp, sps, pps, idr)
            _assert_equal_fields(sh, j_hd.parse_slice_header(
                nu.rbsp, jsps, jpps, idr), "header")
            poc = 0 if idr else poc + 1
            sao_on = sps.sao and (sh.sao_luma or sh.sao_chroma)
            if sh.slice_type == 2:
                args = (sh.qp, sao_on)
                got = t_sd.ISliceDecoder(sps, *args).decode(sh.data)
                want = j_sd.ISliceDecoder(jsps, *args).decode(sh.data)
            else:
                kw = dict(is_b=sh.slice_type == 0, n_refs=sh.n_active_refs,
                          poc=poc, ref_pocs=[poc - d for d in
                                             sh.ref_deltas])
                got = t_sd.PSliceDecoder(sps, sh.qp, sao_on,
                                         **kw).decode(sh.data)
                want = j_sd.PSliceDecoder(jsps, sh.qp, sao_on,
                                          **kw).decode(sh.data)
            _assert_equal_fields(got, want, f"slice poc {poc}")
            kinds[sh.slice_type] = kinds.get(sh.slice_type, 0) + 1
            slices.append(got)
    return kinds, slices


@pytest.mark.parametrize("name", STREAMS)
def test_parsers_match_jax(name):
    """NAL split, SPS, PPS, slice headers, hash SEI and every slice's
    decision maps (depth, modes, NxN, MVs, refIdx, PU partition, intra
    CUs, coefficient levels, SAO parameters) equal the JAX decoder's."""
    stream, recons, enc = _stream(name)
    kinds, slices = _parse_both(stream)
    n = len(recons)
    if name.startswith("ai"):
        assert kinds == {2: n}
        assert any(d["nxn8"].any() for d in slices) == (name == "ai_nxn")
        assert all(d["sao"] is not None for d in slices) == enc.cfg.sao
    else:
        assert kinds == {2: 1, (0 if name == "ldb_rect" else 1): n - 1}
        assert any(d["part8"].any() for d in slices[1:])
        assert any((d["ref8"] > 0).any() for d in slices[1:])


@pytest.mark.parametrize("name", STREAMS)
def test_decode_equals_encoder_recons(name):
    """`decode_annexb(device="cpu")`: every MD5 hash OK, the cropped
    pictures equal the encoder's reconstructions, the padded ones have
    the coded size; the streams take NxN, rectangular PUs, a second
    reference and (filtered) SAO."""
    stream, recons, enc = _stream(name)
    res = decode_annexb(stream, device="cpu")
    assert res.hash_ok == [True] * len(recons)
    assert res.all_hashes_ok
    for d, r in zip(res.frames, recons):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p), getattr(r, p),
                                          err_msg=p)
    cfg = enc.cfg
    assert res.recons[0].y.shape == (cfg.pad_height, cfg.pad_width)
    assert (res.sps.width, res.sps.height) == (cfg.width, cfg.height)


@pytest.mark.parametrize("name", JAX_RECON_OK)
def test_decoded_pictures_match_jax_decoder(name):
    """On the streams without filtered rectangular CUs the JAX decoder's
    padded pictures and hash verdicts equal the port's."""
    stream, _, _ = _stream(name)
    got, want = decode_annexb(stream, device="cpu"), j_decode_annexb(stream)
    assert got.hash_ok == want.hash_ok
    for d, r in zip(got.recons, want.recons):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, p),
                                          np.asarray(getattr(r, p)),
                                          err_msg=p)


def test_decode_detects_corruption():
    """A flipped hash byte is reported as a hash mismatch, as the JAX
    decoder reports it; a decoder with no device named takes the card,
    and raises where there is none."""
    stream, _, _ = _stream("ai_nxn")
    idx = stream.rfind(bytes([132]))
    assert idx > 0
    bad = bytearray(stream)
    bad[idx + 3] ^= 0xFF
    res = decode_annexb(bytes(bad), device="cpu")
    assert res.hash_ok == [True, False]
    assert not res.all_hashes_ok
    assert j_decode_annexb(bytes(bad)).hash_ok == res.hash_ok
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decode_annexb(stream)


def test_bi_predictive_merge_raises():
    """A B-slice PU that selects a zero merge candidate is bi-predictive
    (8.5.3.2.5): outside the uni-L0 toolset, the parser raises instead
    of decoding it as L0."""
    dec = t_sd.PSliceDecoder(t_hd.Sps(pad_width=64, pad_height=64), 32,
                             False, is_b=True)
    with pytest.raises(NotImplementedError, match="bi-predictive"):
        dec._merge_motion([(0, 0, 0, 0)] * 5, 0)
    assert dec._merge_motion([(4, -1, 0)] + [(0, 0, 0, 0)] * 4, 0) == \
        (4, -1, 0)
