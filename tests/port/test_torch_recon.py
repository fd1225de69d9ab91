"""PyTorch port, wavefront reconstruction: `encode_frame_planes_plain` (CPU
tensors) against the sequential NumPy golden encoder on seeded decisions
with mixed depths, forced boundary splits and NxN CUs. All six planes
(three reconstructions, three coefficient planes) must be equal."""

import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import pad_frame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.pipeline import golden, recon as j_recon
from hevc_tpu_torch.pipeline import bench_hooks, recon as t_recon

from tests.test_e2e_bitstream import legalize_depth, synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


def _decisions(pad_w, pad_h, seed):
    """Legal depth map (incl. the depth floor forced where a CTU crosses
    the frame edge), per-CU modes, NxN flags with per-PU modes: the
    port's generator, held legal by the reference's `legalize_depth`."""
    d8, m8, m4, nxn = bench_hooks.random_legal_decisions(pad_w, pad_h, seed)
    h8, w8 = d8.shape
    full = np.zeros((-(-h8 // 8) * 8, -(-w8 // 8) * 8), np.int32)
    full[:h8, :w8] = d8
    np.testing.assert_array_equal(legalize_depth(full)[:h8, :w8], d8)
    return d8, m8, m4, nxn


@pytest.mark.parametrize("rdoq", [True, False])
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("w,h", [(128, 64), (96, 80)])
def test_encode_frame_planes_equals_golden(w, h, qp, rdoq):
    cfg = j_headers.EncoderConfig(width=w, height=h, qp=qp, rdoq=rdoq)
    pf = pad_frame(synth_frame(w, h, seed=w + qp), cfg.pad_width,
                   cfg.pad_height)
    d8, m8, m4, nxn = _decisions(cfg.pad_width, cfg.pad_height, seed=h + qp)
    assert nxn.any() and len(np.unique(d8)) >= 3, np.unique(d8)
    t_recon.batches = 0
    planes = t_recon.encode_frame_planes_plain(
        pf.y, pf.cb, pf.cr, d8, m4, nxn, qp=qp, pad_w=cfg.pad_width,
        pad_h=cfg.pad_height, rdoq=rdoq, device="cpu")
    assert t_recon.batches > 0
    dec, grec = golden.GoldenEncoder(cfg).encode_frame(pf, d8, m8,
                                                       modes4=m4, nxn8=nxn)
    assert planes.recon_y.dtype == torch.uint8
    assert planes.coef_y.dtype == torch.int16
    for name, want in (("recon_y", grec.y), ("recon_cb", grec.cb),
                       ("recon_cr", grec.cr), ("coef_y", dec["coef_y"]),
                       ("coef_cb", dec["coef_cb"]),
                       ("coef_cr", dec["coef_cr"])):
        np.testing.assert_array_equal(getattr(planes, name).numpy(), want,
                                      name)
    assert np.abs(dec["coef_y"]).sum() > 0


def test_schedule_tables():
    """node_table and the wavefront lanes are the reference's; every leaf
    TB of a CTU appears once in the step table, after the TBs it reads."""
    np.testing.assert_array_equal(t_recon.node_table(), j_recon.node_table())
    cxs, cys, act = j_recon._diag_lanes(5, 3)
    lanes = t_recon._diag_lanes(5, 3)
    assert len(lanes) == cxs.shape[0]
    for d, row in enumerate(lanes):
        want = [(int(x), int(y)) for x, y, a in zip(cxs[d], cys[d], act[d])
                if a]
        assert list(row) == want
    d8, _, _, nxn = _decisions(64, 64, seed=5)
    lu, ch = t_recon._ctu_steps(d8.astype(np.int8).tobytes(),
                                nxn.astype(np.bool_).tobytes())
    for tus, size in ((lu, 64), (ch, 32)):
        cover = np.zeros((size, size), np.int32)
        level = np.zeros((size + 1, 2 * size + 1), np.int32)
        for (x, y, n, dst, mx, my, lv) in tus:
            cover[y:y + n, x:x + n] += 1
            # left column + corner + top row already coded at lower levels
            left = level[y:y + 1 + 2 * n, x][:size + 1 - y]
            top = level[y, x:x + 1 + 2 * n]
            assert lv > max(left.max(), top.max())
            level[y + 1:y + 1 + n, x + 1:x + 1 + n] = lv
        assert (cover == 1).all()
