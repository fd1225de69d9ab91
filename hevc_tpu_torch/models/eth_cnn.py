"""ETH-CNN: Early-Terminated Hierarchical CNN for CU-partition prediction.

Predicts, for each 64x64 CTU, the 21-probability HCPM (hierarchical CU
partition map): 1 split prob at 64->32, 4 at 32->16, 16 at 16->8.

Design (inference only in this port):
  * Non-overlapping k x k convs are lowered to space-to-depth + one matmul
    per layer, a single [B*cells, k*k*Cin] x [k*k*Cin, Cout] contraction;
    the weights are stored in that matmul form, as the shipped
    checkpoints have them.
  * The hierarchical "early termination" is compute-all + mask. Two
    granularities:
      - 'ctu'   (default): each sample gates its own level 2/3 outputs.
      - 'batch': one gate for the whole batch.
  * float32 throughout, TF32 off: the HCPM threshold comparisons want
    stable probabilities.

Input normalization: luma x/255, qp/51.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# Level channel widths: (fc1, fc2, out) per decision level.
LEVEL_SPECS = {
    "l64": (64, 48, 1),
    "l32": (128, 96, 4),
    "l16": (256, 192, 16),
}
CONV_CHANNELS = (16, 24, 32)        # conv1/2/3 filters
CONV_KERNELS = (4, 2, 2)            # non-overlapping kernel sizes
FEAT_DIM = 2688                     # concat of conv2+conv3 features, all 3 branches
# Per-branch input resolutions after avg-pool: L(16x16) gates 64-level texture,
# M(32x32), S(64x64).
BRANCH_SIZES = {"L": 16, "M": 32, "S": 64}

LEAKY_SLOPE = 0.2


def param_shapes() -> Dict[str, tuple]:
    """Name -> shape of every parameter (the checkpoint layout):
      conv{1,2,3}_{S,M,L}_{w,b}: w [k*k*Cin, Cout], b [Cout] (matmul form)
      {lvl}_fc{1,2,3}_{w,b}: fc1 [2688, d1], fc2 [d1+1, d2] (qp concat),
        fc3 [d2+1, out]."""
    shapes = {}
    for br in ("S", "M", "L"):
        cin = 1
        for li, (k, cout) in enumerate(zip(CONV_KERNELS, CONV_CHANNELS), 1):
            shapes[f"conv{li}_{br}_w"] = (k * k * cin, cout)
            shapes[f"conv{li}_{br}_b"] = (cout,)
            cin = cout
    for lvl, (d1, d2, dout) in LEVEL_SPECS.items():
        shapes[f"{lvl}_fc1_w"] = (FEAT_DIM, d1)
        shapes[f"{lvl}_fc1_b"] = (d1,)
        shapes[f"{lvl}_fc2_w"] = (d1 + 1, d2)
        shapes[f"{lvl}_fc2_b"] = (d2,)
        shapes[f"{lvl}_fc3_w"] = (d2 + 1, dout)
        shapes[f"{lvl}_fc3_b"] = (dout,)
    return shapes


def _leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def _avg_pool(x, k):
    """Non-overlapping k x k average pool over [B,H,W]."""
    b, h, w = x.shape
    return x.reshape(b, h // k, k, w // k, k).mean(dim=(2, 4))


def _remove_local_mean(x, win=16):
    """Subtract the mean of each non-overlapping win x win window."""
    b, h, w = x.shape
    xw = x.reshape(b, h // win, win, w // win, win)
    mean = xw.mean(dim=(2, 4), keepdim=True)
    return (xw - mean).reshape(b, h, w)


def _space_to_depth(x, k):
    """[B,H,W,C] -> [B, H/k, W/k, k*k*C] gathering each k x k cell."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // k, k, w // k, k, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, H/k, W/k, k, k, C
    return x.reshape(b, h // k, w // k, k * k * c)


def _branch_features(params, x, br):
    """The 3-layer non-overlapping conv stack of one branch, with the
    parameters `conv{1,2,3}_{br}_{w,b}` of `params` (ETH-CNN's, or the
    residue CNN of ETH-LSTM). Returns (conv2_flat, conv3_flat) with
    row-major [H,W,C] flattening."""
    h = x[..., None]  # [B,H,W,1]
    feats = []
    for li, k in enumerate(CONV_KERNELS, start=1):
        cells = _space_to_depth(h, k)  # [B,H/k,W/k,k*k*Cin]
        h = _leaky(cells @ params[f"conv{li}_{br}_w"]
                   + params[f"conv{li}_{br}_b"])
        if li >= 2:
            feats.append(h.reshape(h.shape[0], -1))
    return feats[0], feats[1]


def _load_params(model, params, shapes, what, device):
    """Copy a name -> array dict into `model.params` (float32), raising on
    a missing name or a wrong shape; the model goes to `device` (None
    means the card) in eval mode."""
    from .. import resolve_device
    missing = sorted(set(shapes) - set(params))
    if missing:
        raise KeyError(f"{what} parameters missing: {missing}")
    with torch.no_grad():
        for name, shape in shapes.items():
            a = np.asarray(params[name], np.float32)
            if a.shape != shape:
                raise ValueError(f"{name}: expected {shape}, got {a.shape}")
            model.params[name].copy_(torch.from_numpy(a.copy()))
    return model.to(resolve_device(device)).eval()


class EthCnn(nn.Module):
    """ETH-CNN with its parameters under the checkpoint's own names."""

    def __init__(self):
        super().__init__()
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.zeros(shape), requires_grad=False)
            for name, shape in param_shapes().items()})

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], device=None):
        """Build from a name -> array dict (keys conv{1,2,3}_{S,M,L}_{w,b},
        l{64,32,16}_fc{1,2,3}_{w,b}). device=None means the card."""
        return _load_params(cls(), params, param_shapes(), "ETH-CNN", device)

    def _head(self, lvl, feat, qp):
        """One per-level FC head: fc1 -> [qp] -> fc2 -> [qp] -> fc3 logits.
        QP (already qp/51) is concatenated before fc2 and fc3."""
        p = self.params
        h = _leaky(feat @ p[f"{lvl}_fc1_w"] + p[f"{lvl}_fc1_b"])
        h = torch.cat([h, qp[:, None]], dim=1)
        h = _leaky(h @ p[f"{lvl}_fc2_w"] + p[f"{lvl}_fc2_b"])
        h = torch.cat([h, qp[:, None]], dim=1)
        return h @ p[f"{lvl}_fc3_w"] + p[f"{lvl}_fc3_b"]

    @torch.no_grad()
    def forward(self, luma, qp, *, thr_l1=0.5, thr_l2=0.5, early_exit="ctu"):
        """luma: [B, 64, 64] uint8 or float CTU patches (0..255 scale);
        qp: [B] QP values (0..51 scale); thr_l1/thr_l2: early-termination
        lower thresholds; early_exit: 'ctu' | 'batch' | 'none'.

        Returns [B, 21] float32 probabilities [p64 (1), p32 (4), p16 (16)],
        each row-major over the CTU's sub-CU grid — the HCPM ordering."""
        x = luma.to(torch.float32) * (1.0 / 255.0)
        qpn = qp.to(torch.float32) * (1.0 / 51.0)

        branch_in = {
            "L": _remove_local_mean(_avg_pool(x, 4), 16),
            "M": _remove_local_mean(_avg_pool(x, 2), 16),
            "S": _remove_local_mean(x, 16),
        }
        c2, c3 = {}, {}
        for br in ("S", "M", "L"):
            c2[br], c3[br] = _branch_features(self.params, branch_in[br], br)
        # concat order: [conv3_S, conv3_M, conv3_L, conv2_S, conv2_M, conv2_L]
        feat = torch.cat([c3["S"], c3["M"], c3["L"],
                          c2["S"], c2["M"], c2["L"]], dim=1)

        p64 = torch.sigmoid(self._head("l64", feat, qpn))
        p32 = torch.sigmoid(self._head("l32", feat, qpn))
        p16 = torch.sigmoid(self._head("l16", feat, qpn))

        if early_exit == "ctu":
            g32 = (p64 > thr_l1).any(dim=1, keepdim=True)
            p32 = torch.where(g32, p32, torch.zeros_like(p32))
            g16 = (p32 > thr_l2).any(dim=1, keepdim=True)
            p16 = torch.where(g16, p16, torch.zeros_like(p16))
        elif early_exit == "batch":
            g32 = (p64 > thr_l1).any()
            p32 = torch.where(g32, p32, torch.zeros_like(p32))
            g16 = (p32 > thr_l2).any()
            p16 = torch.where(g16, p16, torch.zeros_like(p16))
        elif early_exit != "none":
            raise ValueError(f"unknown early_exit mode {early_exit!r}")

        return torch.cat([p64, p32, p16], dim=1)


def apply(model: EthCnn, luma, qp, *, thr_l1=0.5, thr_l2=0.5,
          early_exit="ctu"):
    """ETH-CNN forward pass (function form, as the JAX package names it)."""
    return model(luma, qp, thr_l1=thr_l1, thr_l2=thr_l2,
                 early_exit=early_exit)


# ---------------------------------------------------------------------------
# Weights carried across: the shipped checkpoints are plain NumPy .npz
# files of the parameter dict above.
# ---------------------------------------------------------------------------

def load_npz(path, device=None) -> EthCnn:
    """Read an ETH-CNN checkpoint (models/eth_cnn_qp*.npz)."""
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    return EthCnn.from_numpy(params, device=device)


#: the QP bands of the checkpoints (reference video_to_cu_depth.py:126-133
#: QP-banded model selection); the shipped `models/eth_{cnn,lstm}_{band}
#: .npz` files are named by them
QP_BANDS = {
    "qp20~25": range(20, 25),
    "qp25~30": range(25, 30),
    "qp30~35": range(30, 35),
    "qp35~40": range(35, 52),
}


def band_for_qp(qp: int) -> str:
    """QP-banded model selection: the checkpoint band trained for `qp`."""
    if qp < 25:
        return "qp20~25"
    if qp < 30:
        return "qp25~30"
    if qp < 35:
        return "qp30~35"
    return "qp35~40"
