#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: All-Intra 1080p encode throughput.

    python3 bench_torch.py [--frames 48] [--chunk 24] [--decide-chunk 4]

Prints `hevc_tpu_torch.pipeline.bench_hooks.bench_encode_1080p()` as one
JSON line (metric `ai_encode_1080p`, frames/s on one GPU, with
device_s / transfer_s / entropy_s and the kernels' launch counts, and
`vs_baseline` = frames/s x HM's seconds per frame from the port's cache
`hevc_tpu_torch/pipeline/hm_baseline.json`). It runs on a CUDA device and
fails without one, or without that cache: there is no fallback metric.
"""

import argparse
import json
import sys

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=24)
    ap.add_argument("--decide-chunk", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_torch: needs a CUDA device")
    from hevc_tpu_torch.pipeline import bench_hooks
    print(json.dumps(bench_hooks.bench_encode_1080p(
        n_frames=args.frames, chunk=args.chunk,
        decide_chunk=args.decide_chunk)), flush=True)


if __name__ == "__main__":
    main()
