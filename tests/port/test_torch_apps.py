"""PyTorch port, the command-line surface: the HM-cfg loader
(`hevc_tpu_torch.core.config`), the encoder and decoder apps
(`hevc_tpu_torch.apps.encoder` / `.decoder`, `main(argv, device="cpu")`)
and the App/utils tools (`hevc_tpu_torch.apps.utils`), on the CPU
against the JAX package and against the library calls the apps make, on
cfg files, YUV files and vectors the tests write from numpy seeds.

Every output compared is an integer, a string or a byte string, so the
tolerance is 0."""

import contextlib
import dataclasses

import numpy as np
import pytest

from hevc_tpu.apps import utils as j_utils
from hevc_tpu.core import config as j_config
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu_torch.apps import decoder as t_decoder_app
from hevc_tpu_torch.apps import encoder as t_encoder_app
from hevc_tpu_torch.apps import utils as t_utils
from hevc_tpu_torch.core import config as t_config
from hevc_tpu_torch.core.yuv import read_yuv420, write_yuv420
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.pipeline import bench_hooks
from hevc_tpu_torch.pipeline.ai import AIEncoder
from hevc_tpu_torch.pipeline.pframe import LDPEncoder

from tests.port.test_torch_psearch import LSTM, _lstm_params
from tests.port.torch_threads import one_torch_thread  # noqa: F401
from tests.test_app_utils import VECTORS

SOURCE = """InputFile : {yuv}  # the source
InputBitDepth : 8
InputChromaFormat : 420
FrameRate : 30
FrameSkip : 0
SourceWidth : {w}
SourceHeight : {h}
FramesToBeEncoded : {n}
Level : 4.1
"""
COMMON = """BitstreamFile : {out}.bin
ReconFile : {out}.rec.yuv
MaxCUWidth : 64
MaxCUHeight : 64
MaxPartitionDepth : 4
QP : 32
RDOQ : 1
LoopFilterDisable : {lf}
SAO : {sao}
"""
AI = "IntraPeriod : 1\nGOPSize : 1\n"
LDP = """IntraPeriod : -1
GOPSize : 4
Frame1 : P 1 3 0.4624 0 0 0 2 4 -1 -5 -9 -13 0
Frame2 : P 2 2 0.4624 0 0 0 2 4 -1 -2 -6 -10 1 -1 5 1 1 1 0 1
Frame3 : P 3 3 0.4624 0 0 0 2 4 -1 -3 -7 -11 1 -1 5 0 1 1 1 1
Frame4 : P 4 1 0.578 0 0 0 2 4 -1 -4 -8 -12 1 -1 5 0 1 1 1 1
"""
LDB = LDP.replace(" P ", " B ").replace(" 2 4 ", " 4 4 ")


def _write_cfgs(tmp_path, mode_text, w, h, n, lf=0, sao=1, frames=None):
    """A source cfg over a YUV file of `frames`, and a mode cfg; returns
    the two paths and the output stem."""
    yuv, out = tmp_path / "src.yuv", tmp_path / "out"
    if frames is not None:
        write_yuv420(str(yuv), frames)
    src, mode = tmp_path / "src.cfg", tmp_path / "mode.cfg"
    src.write_text(SOURCE.format(yuv=yuv, w=w, h=h, n=n))
    mode.write_text(COMMON.format(out=out, lf=lf, sao=sao) + mode_text)
    return [str(src), str(mode)], str(out)


@pytest.mark.parametrize("mode", ["ai", "ldp", "ldb"])
def test_load_encoder_config_matches_jax(mode, tmp_path):
    """`load_encoder_config` on stacked AI / LDP / LDB cfg files and with
    overrides: the same EncoderConfig fields and RunSettings as the JAX
    loader, and the mode taken from IntraPeriod and the GOP rows."""
    text = {"ai": AI, "ldp": LDP, "ldb": LDB}[mode]
    paths, _ = _write_cfgs(tmp_path, text + "Unknown : 7\n", 416, 240, 20,
                           lf=1, sao=0)
    for overrides in (None, {"QP": "27", "FramesToBeEncoded": "3"}):
        cfg, run = t_config.load_encoder_config(paths, overrides)
        jcfg, jrun = j_config.load_encoder_config(paths, overrides)
        assert isinstance(cfg, t_headers.EncoderConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    assert run.mode == mode and run.unknown == {"Unknown": "7"}
    assert cfg.qp == 27 and run.frames_to_encode == 3
    assert cfg.num_refs == {"ai": 1, "ldp": 2, "ldb": 4}[mode]
    assert not cfg.deblock and not cfg.sao
    text = "A : 1 # c\nB: x y z\n# A : 9\nA : 2\n"
    assert t_config.parse_hm_cfg_text(text) == \
        j_config.parse_hm_cfg_text(text) == {"A": "2", "B": "x y z"}
    with pytest.raises(ValueError, match="SourceWidth"):
        t_config.load_encoder_config([paths[1]])


def _run_encoder_app(tmp_path, capsys, mode_text, frames, extra=()):
    h, w = frames[0].y.shape
    paths, out = _write_cfgs(tmp_path, mode_text, w, h, len(frames),
                             frames=frames)
    argv = [a for p in paths for a in ("-c", p)] + list(extra)
    assert t_encoder_app.main(argv, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    with open(out + ".bin", "rb") as f:
        stream = f.read()
    return stream, read_yuv420(out + ".rec.yuv", w, h), lines, paths, out


def _assert_log(lines, types, qps):
    assert [ln[:30] for ln in lines[:-1]] == [
        f"POC {poc:4d} ( {t}-SLICE, QP {q:2d} ) [Y "[:30]
        for poc, (t, q) in enumerate(zip(types, qps))]
    assert lines[-1].startswith(f"SUMMARY: {len(types)} frames, ")


def _assert_frames_equal(a, b):
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(a, p), getattr(b, p),
                                      err_msg=p)


def test_encoder_app_ai(tmp_path, capsys):
    """AI mode, 64x64, two frames, deblocking and SAO: the app writes the
    bytes and the recon file of `AIEncoder(cfg).encode`, and logs two I
    slices at QP 32."""
    frames = bench_hooks.synth_structured(2, 7, 64, 64)
    stream, recons, lines, paths, _ = _run_encoder_app(tmp_path, capsys,
                                                       AI, frames)
    cfg, _ = t_config.load_encoder_config(paths)
    want, want_recons, _ = AIEncoder(cfg, device="cpu").encode(frames)
    assert stream == want
    for a, b in zip(recons, want_recons):
        _assert_frames_equal(a, b)
    _assert_log(lines, "II", [32, 32])


@pytest.fixture(scope="module")
def ldb_app(tmp_path_factory):
    """LDB mode, 128x64, three shear frames, GOP 4 of B pictures, four
    references, deblocking and SAO, the shipped ETH-LSTM."""
    tmp = tmp_path_factory.mktemp("ldb")
    frames = bench_hooks.synth_shear(3, 128, 64)
    paths, out = _write_cfgs(tmp, LDB, 128, 64, len(frames), frames=frames)
    log = tmp / "log.txt"    # the app's log: a module fixture has no capsys
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = t_encoder_app.main([a for p in paths for a in ("-c", p)]
                                + ["--lstm", LSTM], device="cpu")
    assert rc == 0
    with open(out + ".bin", "rb") as f:
        stream = f.read()
    return (frames, stream, read_yuv420(out + ".rec.yuv", 128, 64),
            log.read_text().splitlines(), paths, out)


def test_encoder_app_ldb(ldb_app):
    """The app's LDB stream and recon file are those of
    `LDPEncoder(cfg, lstm_params=..., slice_mode="B").encode`, with the
    cfg's GOP QPs, and its log names B slices."""
    frames, stream, recons, lines, paths, _ = ldb_app
    cfg, run = t_config.load_encoder_config(paths)
    assert run.mode == "ldb" and cfg.num_refs == 4
    enc = LDPEncoder(cfg, lstm_params=_lstm_params(), slice_mode="B",
                     device="cpu")
    want, want_recons = enc.encode(frames)
    assert stream == want
    for a, b in zip(recons, want_recons):
        _assert_frames_equal(a, b)
    _assert_log(lines, "IBB", [32, 35, 34])


def test_decoder_app(ldb_app, tmp_path, capsys):
    """The decoder app on the LDB stream: exit 0, one OK line per
    picture, the output YUV equal to the encoder's recons; on a stream
    with a flipped hash byte, exit 1."""
    frames, stream, recons, _, _, out = ldb_app
    rec = str(tmp_path / "dec.yuv")
    assert t_decoder_app.main(["-b", out + ".bin", "-o", rec],
                              device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.endswith("hash (OK)") for ln in lines[:-1]] == [True] * 3
    assert lines[-1].startswith("decoded 3 pictures in ")
    for a, b in zip(read_yuv420(rec, 128, 64), recons):
        _assert_frames_equal(a, b)
    bad = bytearray(stream)
    idx = stream.rfind(bytes([132]))
    bad[idx + 3] ^= 0xFF
    (tmp_path / "bad.bin").write_bytes(bytes(bad))
    assert t_decoder_app.main(["-b", str(tmp_path / "bad.bin")],
                              device="cpu") == 1


@pytest.mark.parametrize("expected,data", VECTORS)
def test_annexb_stats_match_jax(expected, data):
    """annexBbytecount's self-test vectors: the same per-NAL statistics
    as the JAX tool and the reference's expected values."""
    got = t_utils.split_annexb(data)
    want = j_utils.split_annexb(data)
    assert [(dataclasses.asdict(s), p) for s, p in got] == \
        [(dataclasses.asdict(s), p) for s, p in want]
    st = got[0][0]
    assert (st.leading_zero_8bits, st.zero_byte, st.start_code_prefix,
            st.nal_bytes, st.trailing_zero_8bits) == expected


def test_app_utils_match_jax(tmp_path):
    """The byte count of a real stream, the bit-depth conversion both
    ways, the per-GOP bitrates of an encoder log and the lambda-modifier
    search: equal to the JAX tools' results."""
    cfg = t_headers.EncoderConfig(64, 64, qp=32)
    jcfg = j_headers.EncoderConfig(64, 64, qp=32)
    stream = (t_headers.write_vps(cfg) + t_headers.write_sps(cfg)
              + t_headers.write_pps(cfg) + b"\x00\x00\x01\x26\x01\x12\x34")
    assert stream[:-7] == (j_headers.write_vps(jcfg) + j_headers.write_sps(
        jcfg) + j_headers.write_pps(jcfg))
    got, want = t_utils.annexb_bytecount(stream), \
        j_utils.annexb_bytecount(stream)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}

    w, h = 16, 8
    rng = np.random.RandomState(0)
    src = tmp_path / "in.yuv"
    src.write_bytes(rng.randint(0, 256, w * h * 3 // 2, np.uint8).tobytes())
    for lib, tag in ((t_utils, "t"), (j_utils, "j")):
        mid, out = tmp_path / f"{tag}10.yuv", tmp_path / f"{tag}8.yuv"
        assert lib.convert_bitdepth(str(src), str(mid), w, h, 8, 10) == 1
        assert lib.convert_bitdepth(str(mid), str(out), w, h, 10, 8) == 1
    for name in ("10.yuv", "8.yuv"):
        assert (tmp_path / f"t{name}").read_bytes() == \
            (tmp_path / f"j{name}").read_bytes()
    assert (tmp_path / "t8.yuv").read_bytes() == src.read_bytes()

    log = "\n".join(
        f"POC {p:4d} TId: 0 ( B-SLICE, QP 32 ) {1000 + 37 * p} bits"
        for p in range(1, 13))
    assert t_utils.extract_bitrates(log, gop_size=4, fps=30.0) == \
        j_utils.extract_bitrates(log, gop_size=4, fps=30.0)

    base = np.array([100.0, 80.0, 60.0, 40.0])
    targets = [55.0, 50.0, 45.0, 40.0]
    got = t_utils.guess_lambda_modifiers(lambda m: base / np.asarray(m),
                                         targets, tolerance=0.02)
    want = j_utils.guess_lambda_modifiers(lambda m: base / np.asarray(m),
                                          targets, tolerance=0.02)
    np.testing.assert_array_equal(got, want)
