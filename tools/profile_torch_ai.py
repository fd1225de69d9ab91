#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's All-Intra encoders goes.

    python3 tools/profile_torch_ai.py [--frames 2] [--bench-frames 48]
                                      [--out FILE.json]

Runs on one CUDA device (no CPU fallback), with the shipped ETH-CNN at
QP 32 on synthetic 1080p frames, and prints JSON lines (with `--out` also
one JSON file):

- `frames`: `--frames` frames one at a time through `AIEncoder.encode`:
  `decide_s / recon_s / entropy_s`, the kernels' launches;
- `recon_frame_tu_step_us`: the time of one TU step of the reconstruction
  kernel by component and TU size (`bench_hooks.recon_tu_step_us`: a
  64x1024 frame, 16 CTUs that depend on each other, of uniform depth;
  total time over 16 x TUs per CTU, the launch and the CTU's set-up
  included);
- `recon_frame_1080p`: the kernel at frame batches of 1, 8 and 24 on the
  encoder's own decisions (luma planes alone, chroma planes alone, all
  three as the encoder launches them: 62 launches per batch), its
  roofline bound from this run's decisions, and the dependency floor of
  the wavefront schedule: over the 62 diagonals, the slowest CTU's chain
  of TU steps at the step times measured above (luma and chroma in one
  launch, and the older schedule of separate launches beside it);
- `decide_1080p_trace`, `filters_1080p_trace`, `frames_batch8_trace`: the
  decide stage of one frame, the in-loop filter stage of one frame
  (deblocking, SAO statistics, host decision and apply on the
  reconstruction kernel's planes, as `AIEncoder` runs them with
  `deblock=True, sao=True`), and `FrameParallelAI.encode_batch` of 8
  frames, under `torch.profiler`: device kernels, device-busy time, idle
  share of the untraced wall time, the ten kernels with the most device
  time;
- `bench_encode_1080p`: `bench_hooks.bench_encode_1080p` at
  `--bench-frames` frames, chunk 24, decide_chunk 4.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

PEAK_BYTES_S = 3.35e12          # H100 SXM device memory
PEAK_INT_OPS_S = 33.5e12        # int32 instructions outside the tensor cores


def trace(fn):
    """Time fn() without the profiler (host clock around a synchronise),
    then run it once more under the profiler for the device side: kernel
    rows only (the operator rows repeat their kernels' device time). The
    idle share is 1 - device-busy time / the untraced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    wall_traced = time.perf_counter() - t0
    rows = []
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, int(e.count), dev_us / 1e6))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    return {"wall_s": wall, "wall_s_traced": wall_traced,
            "device_kernels": sum(r[1] for r in rows),
            "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "top": [{"name": k[:80], "count": c, "device_s": s}
                    for k, c, s in rows[:10]]}


def time_ms(fn, reps=5):
    """Mean milliseconds of fn() (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dependency_floor_ms(depth8, nxn8, tu_us):
    """The wavefront schedule's floor for one frame: for every diagonal
    d = x + 2y the slowest chain of TU steps of its CTUs, summed over the
    diagonals. `ms`: Y, Cb and Cr share each launch, so a diagonal takes
    the longer of its luma and chroma chains (Cb and Cr are alike);
    `ms_luma_then_chroma`: the schedule of separate luma and chroma
    launches, luma's floor plus chroma's."""
    h8, w8 = depth8.shape
    ny, nx = -(-h8 // 8), -(-w8 // 8)
    d = np.full((ny * 8, nx * 8), -1, np.int64)
    d[:h8, :w8] = depth8
    q = np.zeros((ny * 8, nx * 8), bool)
    q[:h8, :w8] = nxn8
    per_ctu = lambda m: m.reshape(ny, 8, nx, 8).sum((1, 3))
    shallow = per_ctu((d == 0) | (d == 1)) / 16
    mid = per_ctu(d == 2) / 4
    deep, deep_nxn = per_ctu((d == 3) & ~q), per_ctu((d == 3) & q)
    luma = (shallow * tu_us["luma"]["32"] + mid * tu_us["luma"]["16"]
            + deep * tu_us["luma"]["8"] + 4 * deep_nxn * tu_us["luma"]["4"])
    chroma = (shallow * tu_us["chroma"]["16"] + mid * tu_us["chroma"]["8"]
              + (deep + deep_nxn) * tu_us["chroma"]["4"])
    cy, cx = np.mgrid[0:ny, 0:nx]
    diag = cx + 2 * cy
    per_diag = lambda c: np.array([c[diag == k].max()
                                   for k in range(nx + 2 * (ny - 1))])
    y_d, c_d = per_diag(luma), per_diag(chroma)
    return {"ms": float(np.maximum(y_d, c_d).sum()) / 1e3,
            "ms_luma_then_chroma": float(y_d.sum() + c_d.sum()) / 1e3,
            "luma_ms": float(y_d.sum()) / 1e3,
            "chroma_ms": float(c_d.sum()) / 1e3,
            "diagonals_set_by_chroma": int((c_d > y_d).sum()),
            "chain_tu_steps_luma": float(per_diag(shallow + mid + deep
                                                  + 4 * deep_nxn).sum()),
            "chain_tu_steps_chroma": float(per_diag(shallow + mid + deep
                                                    + deep_nxn).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--bench-frames", type=int, default=48)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_ai: needs a CUDA device")

    from hevc_tpu_torch.core.yuv import pad_frame
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.models import eth_cnn
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.parallel.frames import FrameParallelAI
    from hevc_tpu_torch.pipeline import bench_hooks, recon, recon_kernel
    from hevc_tpu_torch.pipeline.ai import AIEncoder

    device = torch.device("cuda")
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "torch": torch.__version__, "frames": []}

    def say(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    print(json.dumps({"card": out["card"]}), flush=True)
    cnn = eth_cnn.load_npz(bench_hooks.WEIGHTS_QP32)
    frames = bench_hooks.synth_1080p_structured(n_frames=24)
    cfg = EncoderConfig(1920, 1080, qp=32)
    enc = AIEncoder(cfg, cnn=cnn)
    for i, f in enumerate(frames[:args.frames]):
        intra_mm.launches = recon_kernel.launches = recon.batches = 0
        t0 = time.perf_counter()
        stream, _, stats = enc.encode([f])
        rec = {"frame": i, "wall_s": time.perf_counter() - t0,
               "bytes": len(stream), "satd35_launches": intra_mm.launches,
               "recon_frame_launches": recon_kernel.launches,
               "plain_recon_batches": recon.batches, **stats}
        out["frames"].append(rec)
        print(json.dumps(rec), flush=True)

    # the reconstruction kernel: TU step times, batches of 1 / 8 / 24
    tu_us = bench_hooks.recon_tu_step_us(device)
    say("recon_frame_tu_step_us", tu_us)
    pfs = [pad_frame(f, cfg.pad_width, cfg.pad_height) for f in frames]
    dec = [enc.decide_frame_full(p.y, None, p.cb, p.cr) for p in pfs]
    stack = lambda xs: torch.as_tensor(np.stack(xs)).to(device)
    full = (stack([p.y for p in pfs]), stack([p.cb for p in pfs]),
            stack([p.cr for p in pfs]), stack([d[0] for d in dec]),
            stack([d[2] for d in dec]), stack([d[3] for d in dec]))
    k2 = {"dependency_floor_frame0": dependency_floor_ms(dec[0][0], dec[0][3],
                                                         tu_us)}
    for F in (1, 8, 24):
        a = tuple(t[:F].contiguous() for t in full)
        r = {}
        for key, comps in (("luma_ms", ("luma",)), ("chroma_ms", ("chroma",)),
                           ("ms", ("luma", "chroma"))):
            r[key] = time_ms(lambda: recon_kernel.encode_frame_planes_cuda(
                *a, qp=32, pad_w=cfg.pad_width, pad_h=cfg.pad_height,
                components=comps))
        nbytes, ops = bench_hooks.recon_work(a[3].cpu().numpy(),
                                             a[5].cpu().numpy())
        r.update(ms_per_frame=r["ms"] / F,
                 bound_bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                 bound_operations_ms=ops / PEAK_INT_OPS_S * 1e3)
        k2[f"F{F}"] = r
    say("recon_frame_1080p", k2)

    # decide stage of one 1080p frame (warm), traced
    say("decide_1080p_trace", trace(
        lambda: enc.decide_frame_full(pfs[0].y, None, pfs[0].cb, pfs[0].cr)))

    # the in-loop filter stage of frame 0 (warm), traced
    from hevc_tpu_torch.ops import deblock, sao
    planes = recon.encode_frame_planes_batched(
        *(t[:1] for t in full), qp=32, pad_w=cfg.pad_width,
        pad_h=cfg.pad_height)
    rec0 = [p[0] for p in planes[:3]]
    orig0 = [t[0] for t in full[:3]]

    def filters():
        y, cb, cr = deblock.deblock_frame(*rec0, full[3][0], 32)
        sao.apply_frame(y, cb, cr, sao.estimate_frame(*orig0, y, cb, cr, 32))

    filters()
    say("filters_1080p_trace", trace(filters))

    # one 8-frame batch of the frame-batched encoder, traced
    penc = FrameParallelAI(cfg, cnn=cnn, decide_chunk=4)
    penc.encode_batch(frames[:8])                                   # warm
    tr = trace(lambda: penc.encode_batch(frames[:8]))
    say("frames_batch8_trace", {**tr, "last_stats": penc.last_stats,
                                "decide_batches": penc.decide_batches})

    say("bench_encode_1080p", bench_hooks.bench_encode_1080p(
        n_frames=args.bench_frames, chunk=24, decide_chunk=4))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
