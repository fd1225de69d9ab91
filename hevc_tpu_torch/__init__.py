"""hevc_tpu_torch — the PyTorch/CUDA port of the HEVC encoder framework.

Same sub-package layout and the same function and class names as the JAX
package it was ported from; plain tensor code is PyTorch, and every
hand-written accelerator kernel of the original is a CUDA kernel written
for Hopper (`csrc/`), built at first use into `build/`.

Subpackages
-----------
core      : YUV frames, CTU tiling, z-order helpers (host, NumPy)
entropy   : CABAC engine, context models, syntax coding, NAL/Annex-B (host)
native    : C++ slice-data CABAC coder, loaded with ctypes
ops       : integer DCT/DST, quant, RDOQ, intra prediction, SATD, bit model,
            in-loop filters (deblocking, SAO), inter MC and motion search
models    : ETH-CNN, ETH-LSTM, HCPM gating
pipeline  : the All-Intra encoder (search, reconstruction, AIEncoder with
            the golden and TU-wavefront backends), the HM baselines,
            picture-level rate control, the Low-Delay-P predictor chain
            (pre-encode residue -> ETH-LSTM HCPM, LDPPipeline) and the
            low-delay encoder (LDPEncoder: flat tree, or the CU-tree P
            search of psearch with the host intra re-code of intra_p; P or
            low-delay B slices)
decoder   : the standalone decoder (host parsing, reconstruction and
            filters through the encoder's ops)
apps      : the TAppEncoder / TAppDecoder command lines (HM cfg files,
            core/config) and the App/utils tools
evaltools : the HM reference decoder and encoder as oracles, and the
            BD-rate harness against HM
train     : CU-depth labels (own search and HM) and the HM cfg texts
csrc      : CUDA sources of the kernels

The float RD costs and the CNN probabilities feed hard comparisons, so
TF32 is switched off for matrix products and convolutions.
"""

import os

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: where the kernels' and the native coder's shared libraries are built
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def resolve_device(device=None) -> torch.device:
    """`None` means the card: there is no CPU fallback. A caller that
    wants the CPU (the tests) says so explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hevc_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
