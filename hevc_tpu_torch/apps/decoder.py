"""CLI decoder app — the TAppDecoder equivalent.

Mirrors the reference decoder's invocation and log surface
(HM TAppDecoder/decmain.cpp:50, TAppDecTop::decode):

    python -m hevc_tpu_torch.apps.decoder -b str.bin [-o rec.yuv]

Decodes the Annex-B bitstream with the port's decoder
(hevc_tpu_torch/decoder/) on the card, verifies any decoded-picture-hash
SEI (MD5/CRC/checksum), writes the cropped reconstruction, prints one
line per picture, and exits non-zero on a hash mismatch — the contract
of HM's `TAppDecoderStatic` smoke flow.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device=None):
    """Run the decoder CLI. device=None means the card; with no card
    that raises (pass device="cpu" to decode on the CPU)."""
    ap = argparse.ArgumentParser(description="hevc_tpu_torch decoder")
    ap.add_argument("-b", "--bitstream", required=True,
                    help="input Annex-B bitstream")
    ap.add_argument("-o", "--recon", help="output YUV420 recon file")
    args = ap.parse_args(argv)

    from ..core.yuv import write_yuv420
    from ..decoder import top

    t0 = time.time()
    res = top.decode_file(args.bitstream, device=device)
    dt = time.time() - t0

    status = {True: "(OK)", False: "(***ERROR*** hash mismatch)",
              None: "(unk)"}
    for poc, ok in enumerate(res.hash_ok):
        f = res.frames[poc]
        print(f"POC {poc:4d} [{'I' if poc == 0 else 'P/B'}] "
              f"{f.width}x{f.height} hash {status[ok]}")
    if args.recon and res.frames:
        write_yuv420(args.recon, res.frames)
    n = len(res.frames)
    print(f"decoded {n} pictures in {dt:.3f} s "
          f"({n / dt if dt > 0 else 0.0:.2f} fps)")
    if not res.all_hashes_ok:
        print("decoded picture hash FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
