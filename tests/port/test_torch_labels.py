"""PyTorch port, `train/labels`: the HM configuration texts equal the JAX
package's; `extract_labels_hm` gives the JAX function's labels (the same
HM binary); `extract_labels_own` is the port's ungated `decide_frame` at
16x16; `parse_info_index` and `read_shipped_labels` read a written dump as
the JAX ones do."""

import os

import numpy as np
import pytest

from hevc_tpu.evaltools import hm
from hevc_tpu.train import labels as j_labels
from hevc_tpu_torch.core.yuv import Frame, pad_frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.pipeline.ai import AIEncoder
from hevc_tpu_torch.train import labels as t_labels

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fn", ["hm_intra_cfg", "hm_ldp_cfg"])
@pytest.mark.parametrize("args", [(1920, 1080, 32, 2), (64, 64, 22, 1),
                                  (416, 240, 37, 4)])
def test_hm_cfg_text_equals_jax(fn, args):
    got = getattr(t_labels, fn)(*args)
    assert got == getattr(j_labels, fn)(*args)
    assert f"SourceWidth: {args[0]}" in got and f"QP: {args[2]}" in got


def test_extract_labels_hm_equals_jax(tmp_path):
    if not os.path.exists(hm.ENCODER):
        pytest.skip("HM encoder binary missing")
    frames = [synth_frame(64, 64, seed=7), synth_frame(64, 64, seed=8)]
    got = t_labels.extract_labels_hm(
        [Frame(f.y, f.cb, f.cr) for f in frames], 32, 64, 64)
    os.makedirs(tmp_path / "j")
    want = j_labels.extract_labels_hm(frames, 32, 64, 64,
                                      workdir=str(tmp_path / "j"))
    assert got.shape == want.shape == (2, 4, 4)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 3


@pytest.mark.parametrize("w,h", [(128, 96), (96, 80)])
def test_extract_labels_own_is_decide_frame(w, h):
    frames = [Frame(f.y, f.cb, f.cr)
              for f in (synth_frame(w, h, seed=s) for s in (1, 2))]
    lab = t_labels.extract_labels_own(frames, 32, w, h, device="cpu")
    assert lab.shape == (2, -(-h // 16), -(-w // 16))
    assert lab.dtype == np.uint8 and lab.max() <= 3
    cfg = t_headers.EncoderConfig(w, h, qp=32)
    enc = AIEncoder(cfg, device="cpu")
    for f, got in zip(frames, lab):
        pf = pad_frame(f, cfg.pad_width, cfg.pad_height)
        d8, _ = enc.decide_frame(pf.y, 32, pf.cb, pf.cr)
        np.testing.assert_array_equal(got, d8[::2, ::2])
    assert len(np.unique(lab)) > 1


def test_label_dump_round_trip(tmp_path):
    """A dump in the reference's layout (named by its size, and with an
    Index file) reads back as written, through both packages."""
    rng = np.random.RandomState(3)
    w, h, n = 200, 120, 3                  # 8-padded 200x120: 12 x 7 units
    lab = rng.randint(0, 4, (n, 7, 12)).astype(np.uint8)
    cu = str(tmp_path / f"Info_seq_{w}x{h}_32_CUDepth.dat")
    lab.tofile(cu)
    got, idx = t_labels.read_shipped_labels(cu)
    want, jidx = j_labels.read_shipped_labels(cu)
    assert idx is None and jidx is None
    np.testing.assert_array_equal(got, lab)
    np.testing.assert_array_equal(want, lab)

    index = cu.replace("_CUDepth.dat", "_Index.dat")
    with open(index, "w") as f:
        for poc in range(n):
            f.write(f"{poc} {w} {h} {32 + poc} /data/seq.yuv\n")
        f.write("\n")
    got, idx = t_labels.read_shipped_labels(cu)
    _, jidx = j_labels.read_shipped_labels(cu)
    np.testing.assert_array_equal(got, lab)
    for a, b in zip(idx, jidx):
        np.testing.assert_array_equal(a, b)
    assert idx[1:3] == (w, h) and idx[4] == "/data/seq.yuv"
    np.testing.assert_array_equal(idx[3], [32, 33, 34])
    for a, b in zip(t_labels.parse_info_index(index),
                    j_labels.parse_info_index(index)):
        np.testing.assert_array_equal(a, b)

    lab[:, :, :5].tofile(cu)                # 7 x 5 units: not whole frames
    with pytest.raises(ValueError, match="multiple"):
        t_labels.read_shipped_labels(cu)
