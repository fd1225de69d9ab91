"""PyTorch port, `evaltools/bdrate`: `bd_rate` and `weighted_psnr` equal
the JAX package's; `encode_hm` gives the JAX function's bits and PSNR
(the same HM binary); `compare` sweeps four QPs through the port's
`AIEncoder` (its bits are those streams' lengths) and HM, and returns a
finite BD-rate."""

import os

import numpy as np
import pytest

from hevc_tpu.evaltools import bdrate as j_bdrate, hm
from hevc_tpu_torch.core.yuv import Frame
from hevc_tpu_torch.entropy import headers as t_headers
from hevc_tpu_torch.evaltools import bdrate as t_bdrate
from hevc_tpu_torch.models import eth_cnn as t_cnn
from hevc_tpu_torch.pipeline.ai import AIEncoder

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bd_rate_and_weighted_psnr_equal_jax(seed):
    rng = np.random.RandomState(seed)
    psnr_a = np.sort(rng.uniform(30, 42, 4))
    rate_a = np.sort(rng.uniform(1e5, 2e6, 4))
    psnr_b = psnr_a + rng.uniform(-0.8, 0.8, 4)
    rate_b = rate_a * rng.uniform(0.8, 1.3, 4)
    got = t_bdrate.bd_rate(rate_a, psnr_a, rate_b, psnr_b)
    assert got == j_bdrate.bd_rate(rate_a, psnr_a, rate_b, psnr_b)
    assert np.isfinite(got)
    assert abs(t_bdrate.bd_rate(rate_a, psnr_a, rate_a, psnr_a)) < 1e-9
    y, cb, cr = rng.uniform(30, 45, (3, 5))
    np.testing.assert_array_equal(t_bdrate.weighted_psnr(y, cb, cr),
                                  j_bdrate.weighted_psnr(y, cb, cr))
    with pytest.raises(ValueError, match="overlap"):
        t_bdrate.bd_rate(rate_a, psnr_a, rate_b, psnr_a + 20)


def _frames(n=2):
    return [synth_frame(64, 64, seed=20 + s) for s in range(n)]


def test_encode_hm_equals_jax():
    if not os.path.exists(hm.ENCODER):
        pytest.skip("HM encoder binary missing")
    frames = _frames()
    bits, ps, secs = t_bdrate.encode_hm(
        [Frame(f.y, f.cb, f.cr) for f in frames], 64, 64, 27)
    jbits, jps, _ = j_bdrate.encode_hm(frames, 64, 64, 27)
    assert (bits, ps) == (jbits, jps)
    assert bits > 0 and 30 < ps < 60 and secs > 0


@pytest.fixture(scope="module")
def cnn():
    return t_cnn.load_npz(NPZ, device="cpu")


def test_compare_sweeps_port_and_hm(cnn):
    if not os.path.exists(hm.ENCODER):
        pytest.skip("HM encoder binary missing")
    frames = [Frame(f.y, f.cb, f.cr) for f in _frames()]
    qps = (22, 27, 32, 37)
    out = t_bdrate.compare(frames, 64, 64, qps, cnn=cnn, device="cpu")
    assert out["qps"] == list(qps)
    for qp, bits in zip(qps, out["ours"]["bits"]):
        cfg = t_headers.EncoderConfig(64, 64, qp=qp, deblock=True)
        stream = AIEncoder(cfg, cnn=cnn, device="cpu").encode(
            frames, with_hash_sei=False)[0]
        assert bits == 8 * len(stream)
    assert out["ours"]["bits"] == sorted(out["ours"]["bits"], reverse=True)
    assert out["hm"]["bits"] == sorted(out["hm"]["bits"], reverse=True)
    assert np.isfinite(out["bd_rate_vs_hm"])
    assert out["speedup_vs_hm"] > 0
    assert len(out["hm"]["psnr"]) == 4
