"""CLI encoder app — the TAppEncoder equivalent.

Drop-in for the reference's invocation pattern
(`TAppEncoderStatic -c encoder_yuv_source.cfg -c encoder_intra_main.cfg`,
RUN_AI.sh / RUN_LDP.sh):

    python -m hevc_tpu_torch.apps.encoder -c src.cfg -c encoder_intra_main.cfg \
        [--thr Thr_info.txt] [--cnn ckpt.npz] [--lstm ckpt.npz] [-o str.bin]

Reads stacked HM cfg files (core/config.py), pumps YUV frames, runs the
AI, LDP or LDB pipeline (chosen from IntraPeriod/GOPSize and the GOP
rows' slice types like HM) on the card, writes the Annex-B bitstream +
reconstructed YUV, and prints per-POC PSNR lines plus a summary — the
reference encoder's log surface (TEncGOP.cpp:1948-2064 '[ET]' lines).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import resolve_device


def main(argv=None, device=None):
    """Run the encoder CLI. device=None means the card; with no card
    that raises (pass device="cpu" to encode on the CPU)."""
    ap = argparse.ArgumentParser(description="hevc_tpu_torch encoder")
    ap.add_argument("-c", "--config", action="append", default=[],
                    help="HM cfg file (stackable, later overrides)")
    ap.add_argument("-i", "--input", help="override InputFile")
    ap.add_argument("-o", "--bitstream", help="override BitstreamFile")
    ap.add_argument("-r", "--recon", help="override ReconFile")
    ap.add_argument("-f", "--frames", type=int, help="override frames")
    ap.add_argument("-q", "--qp", type=int, help="override QP")
    ap.add_argument("--thr", help="Thr_info.txt threshold file")
    ap.add_argument("--cnn", help="ETH-CNN checkpoint (npz) for AI gating")
    ap.add_argument("--lstm", help="ETH-LSTM checkpoint (npz), LDP gating")
    ap.add_argument("--no-hash", action="store_true",
                    help="omit MD5 picture-hash SEI")
    args = ap.parse_args(argv)

    from ..core.config import load_encoder_config
    from ..core.yuv import psnr, read_yuv420, write_yuv420

    device = resolve_device(device)
    overrides = {}
    if args.input:
        overrides["InputFile"] = args.input
    if args.bitstream:
        overrides["BitstreamFile"] = args.bitstream
    if args.recon:
        overrides["ReconFile"] = args.recon
    if args.frames is not None:
        overrides["FramesToBeEncoded"] = str(args.frames)
    if args.qp is not None:
        overrides["QP"] = str(args.qp)
    cfg, run = load_encoder_config(args.config, overrides)

    thresholds = None
    if args.thr:
        from ..models import hcpm
        order = "ldp" if run.mode in ("ldp", "ldb") else "ai"
        with open(args.thr) as f:
            thresholds = hcpm.parse_thresholds(f.read(), order=order)

    frames = read_yuv420(run.input_file, cfg.width, cfg.height,
                         n_frames=run.frame_skip + run.frames_to_encode)
    frames = frames[run.frame_skip:]
    if len(frames) < run.frames_to_encode:
        print(f"warning: input has only {len(frames)} frames",
              file=sys.stderr)

    rc = None
    if run.rc_target_bps > 0:
        from ..pipeline.ratectrl import RateController
        rc = RateController(run.rc_target_bps, run.frame_rate,
                            cfg.width, cfg.height,
                            n_frames=run.frames_to_encode,
                            init_qp=cfg.qp)

    t0 = time.perf_counter()
    if run.mode == "ai":
        from ..models import eth_cnn
        from ..pipeline.ai import AIEncoder
        cnn = eth_cnn.load_npz(args.cnn, device=device) if args.cnn else None
        enc = AIEncoder(cfg, cnn=cnn, thresholds=thresholds, device=device)
        stream, recons, _ = enc.encode(frames,
                                       with_hash_sei=not args.no_hash,
                                       rate_control=rc)
    else:
        from ..pipeline.pframe import LDPEncoder
        lstm = None
        if args.lstm:
            with np.load(args.lstm) as z:
                lstm = {k: z[k] for k in z.files}
        enc = LDPEncoder(cfg, lstm_params=lstm, thresholds=thresholds,
                         slice_mode="B" if run.mode == "ldb" else "P",
                         device=device)
        stream, recons = enc.encode(frames,
                                    with_hash_sei=not args.no_hash,
                                    rate_control=rc)
    wall = time.perf_counter() - t0

    with open(run.bitstream_file, "wb") as f:
        f.write(stream)
    if run.recon_file:
        write_yuv420(run.recon_file, recons)

    tot_bits = 8 * len(stream)
    frame_qps = getattr(enc, "frame_qps", None) or [cfg.qp] * len(frames)
    for poc, (f, r) in enumerate(zip(frames, recons)):
        st = ("I" if (poc == 0 or run.mode == "ai")
              else "B" if run.mode == "ldb" else "P")
        print(f"POC {poc:4d} ( {st}-SLICE, QP {frame_qps[poc]:2d} ) "
              f"[Y {psnr(f.y, r.y):7.4f} dB  U {psnr(f.cb, r.cb):7.4f} dB"
              f"  V {psnr(f.cr, r.cr):7.4f} dB]")
    kbps = tot_bits * run.frame_rate / max(len(frames), 1) / 1000.0
    avg_y = float(np.mean([psnr(f.y, r.y)
                           for f, r in zip(frames, recons)]))
    print(f"SUMMARY: {len(frames)} frames, {tot_bits} bits, "
          f"{kbps:.4f} kbps, Y-PSNR {avg_y:.4f} dB, "
          f"total time {wall:.3f} s ({len(frames) / wall:.3f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
