"""BD-rate (Bjontegaard delta) computation + encoder comparison harness.

Implements the standard cubic-fit BD-rate metric over 4 rate/PSNR points
and drives side-by-side encodes of the port's AI encoder (`AIEncoder`:
ETH-CNN, the SATD kernel, the reconstruction kernel on the card) vs the
HM-16.5 reference encoder (the north-star quality metric: BD-rate vs HM
at QP 22/27/32/37).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import numpy as np


def bd_rate(rate_a, psnr_a, rate_b, psnr_b) -> float:
    """BD-rate of B vs A in percent (negative = B needs fewer bits)."""
    la, lb = np.log(rate_a), np.log(rate_b)
    pa = np.polyfit(psnr_a, la, 3)
    pb = np.polyfit(psnr_b, lb, 3)
    lo = max(min(psnr_a), min(psnr_b))
    hi = min(max(psnr_a), max(psnr_b))
    if hi <= lo:
        raise ValueError("PSNR ranges do not overlap")
    ia = np.polyint(pa)
    ib = np.polyint(pb)
    va = np.polyval(ia, hi) - np.polyval(ia, lo)
    vb = np.polyval(ib, hi) - np.polyval(ib, lo)
    avg_diff = (vb - va) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100)


def weighted_psnr(psnr_y, psnr_cb, psnr_cr):
    """HM-style 6:1:1 combined PSNR."""
    return (6 * psnr_y + psnr_cb + psnr_cr) / 8.0


def encode_ours(frames, width, height, qp, cnn=None, thresholds=None,
                deblock=True, device=None):
    """Encode with the port's AI pipeline; returns (bits, psnr_y, seconds).
    cnn: an `eth_cnn.EthCnn` or None (ungated search); device=None means
    the card (raises without one)."""
    from ..core.yuv import psnr
    from ..entropy import headers
    from ..pipeline.ai import AIEncoder

    cfg = headers.EncoderConfig(width=width, height=height, qp=qp,
                                deblock=deblock)
    enc = AIEncoder(cfg, cnn=cnn, thresholds=thresholds, device=device)
    t0 = time.perf_counter()
    stream, recons, _ = enc.encode(frames, with_hash_sei=False)
    dt = time.perf_counter() - t0
    ps = np.mean([psnr(r.y[:height, :width], f.y)
                  for r, f in zip(recons, frames)])
    return len(stream) * 8, float(ps), dt


def encode_hm(frames, width, height, qp, timeout=7200):
    """Encode with the HM reference encoder; returns (bits, psnr_y, s)."""
    from ..core.yuv import psnr, read_yuv420, write_yuv420
    from ..evaltools.hm import ENCODER
    from ..train.labels import hm_intra_cfg

    with tempfile.TemporaryDirectory() as td:
        write_yuv420(os.path.join(td, "in.yuv"), frames)
        with open(os.path.join(td, "enc.cfg"), "w") as f:
            f.write(hm_intra_cfg(width, height, qp, len(frames)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [ENCODER, "-c", "enc.cfg", "-i", "in.yuv", "-b", "str.bin",
             "-o", "rec.yuv"],
            cwd=td, capture_output=True, text=True, timeout=timeout)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"HM encoder failed:\n{proc.stderr}")
        bits = os.path.getsize(os.path.join(td, "str.bin")) * 8
        recs = read_yuv420(os.path.join(td, "rec.yuv"), width, height)
        ps = np.mean([psnr(r.y, f.y) for r, f in zip(recs, frames)])
    return bits, float(ps), dt


def compare(frames, width, height, qps=(22, 27, 32, 37), cnn=None,
            thresholds=None, run_hm=True, device=None):
    """Rate/PSNR sweep of the port (and HM); returns dict incl. BD-rate.
    One set of CNN weights serves every QP, as in the reference."""
    ours = {"bits": [], "psnr": [], "time": []}
    hm_r = {"bits": [], "psnr": [], "time": []}
    for qp in qps:
        b, p, t = encode_ours(frames, width, height, qp, cnn, thresholds,
                              device=device)
        ours["bits"].append(b)
        ours["psnr"].append(p)
        ours["time"].append(t)
        if run_hm:
            b, p, t = encode_hm(frames, width, height, qp)
            hm_r["bits"].append(b)
            hm_r["psnr"].append(p)
            hm_r["time"].append(t)
    out = {"qps": list(qps), "ours": ours}
    if run_hm:
        out["hm"] = hm_r
        out["bd_rate_vs_hm"] = bd_rate(hm_r["bits"], hm_r["psnr"],
                                       ours["bits"], ours["psnr"])
        out["speedup_vs_hm"] = float(np.sum(hm_r["time"])
                                     / np.sum(ours["time"]))
    return out
