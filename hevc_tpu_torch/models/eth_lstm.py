"""ETH-CNN + ETH-LSTM for Low-Delay-P CU-partition prediction.

A residue-frame CNN (same 3-branch topology as ETH-CNN but on inter
residue, input scaling (x-128)/255*10, FC1-only per level -> 448-d
feature vector) feeding three single-layer LSTMs (hidden 64/128/256,
forget bias 1.0, cell clip 5.0) that carry temporal state across frames;
per-step FC heads with external features qp/51*0.18 + one-hot
frame-in-GOP(4) emit the 21-probability HCPM.

Behavioral reference: HM-16.5_Test_LDP/bin/net_CNN_LSTM_one_step.py
(:140-323) and resi_to_cu_depth_LDP.py (:103-144). The reference
round-trips LSTM state through state.dat each frame; here state is a
resident device tensor [B, 2, 448] (c and h, levels concatenated)
carried across frame steps.

Inference only in this port (float32, TF32 off, as set at the package's
import); `apply_sequence` is the stepwise rollout without early exit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from . import eth_cnn

HIDDEN = {"l64": 64, "l32": 128, "l16": 256}
HEAD_D2 = {"l64": 48, "l32": 96, "l16": 192}
HEAD_OUT = {"l64": 1, "l32": 4, "l16": 16}
VEC_SLICES = {"l64": (0, 64), "l32": (64, 192), "l16": (192, 448)}
STATE_DIM = 448  # 64 + 128 + 256
GOP_LENGTH = 4
CELL_CLIP = 5.0
FORGET_BIAS = 1.0


def param_shapes() -> Dict[str, tuple]:
    """Name -> shape of every parameter (the checkpoint layout of
    models/eth_lstm_qp*.npz):
      conv{1,2,3}_{S,M,L}_{w,b}: the ETH-CNN conv stack (matmul form)
      {lvl}_fc1_{w,b}: [2688, h]; {lvl}_lstm_{w,b}: [2h, 4h], gate order
        (i, g, f, o) over concat([x, h]);
      {lvl}_fc2_{w,b}: [h + 5, d2]; {lvl}_fc3_{w,b}: [d2 + 5, out]
        (the 5 external features concatenated before each)."""
    shapes = {k: v for k, v in eth_cnn.param_shapes().items()
              if k.startswith("conv")}
    efs = GOP_LENGTH + 1
    for lvl, h in HIDDEN.items():
        d2, dout = HEAD_D2[lvl], HEAD_OUT[lvl]
        shapes[f"{lvl}_fc1_w"] = (eth_cnn.FEAT_DIM, h)
        shapes[f"{lvl}_fc1_b"] = (h,)
        shapes[f"{lvl}_lstm_w"] = (2 * h, 4 * h)
        shapes[f"{lvl}_lstm_b"] = (4 * h,)
        shapes[f"{lvl}_fc2_w"] = (h + efs, d2)
        shapes[f"{lvl}_fc2_b"] = (d2,)
        shapes[f"{lvl}_fc3_w"] = (d2 + efs, dout)
        shapes[f"{lvl}_fc3_b"] = (dout,)
    return shapes


class EthLstm(nn.Module):
    """ETH-LSTM's parameters under the checkpoint's own names; the model
    runs through the module functions `step` and `apply_sequence`."""

    def __init__(self):
        super().__init__()
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.zeros(shape), requires_grad=False)
            for name, shape in param_shapes().items()})

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], device=None):
        """Build from a name -> array dict (the JAX package's parameter
        dict, or an .npz checkpoint). device=None means the card."""
        return eth_cnn._load_params(cls(), params, param_shapes(), "ETH-LSTM",
                                    device)


def load_npz(path, device=None) -> EthLstm:
    """Read an ETH-LSTM checkpoint (models/eth_lstm_qp*.npz)."""
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    return EthLstm.from_numpy(params, device=device)


def zero_state(batch: int, dtype=torch.float32, device=None):
    """[B, 2, 448]: (c, h) per sample, levels concatenated 64|128|256."""
    from .. import resolve_device
    return torch.zeros((batch, 2, STATE_DIM), dtype=dtype,
                       device=resolve_device(device))


def resi_features(model: EthLstm, resi):
    """Residue CNN: [B, 64, 64] (u8-range, 128-centered) -> [B, 448]."""
    p = model.params
    x = (resi.to(torch.float32) - 128.0) / 255.0 * 10.0
    branch_in = {
        "L": eth_cnn._remove_local_mean(eth_cnn._avg_pool(x, 4), 16),
        "M": eth_cnn._remove_local_mean(eth_cnn._avg_pool(x, 2), 16),
        "S": eth_cnn._remove_local_mean(x, 16),
    }
    c2, c3 = {}, {}
    for br in ("S", "M", "L"):
        c2[br], c3[br] = eth_cnn._branch_features(p, branch_in[br], br)
    feat = torch.cat([c3["S"], c3["M"], c3["L"],
                      c2["S"], c2["M"], c2["L"]], dim=1)
    return torch.cat([eth_cnn._leaky(feat @ p[f"{lvl}_fc1_w"]
                                     + p[f"{lvl}_fc1_b"])
                      for lvl in ("l64", "l32", "l16")], dim=1)


def _lstm_cell(model: EthLstm, lvl, x, c, h):
    """TF-contrib-LSTMCell semantics: gates (i, g, f, o), forget bias 1,
    cell clip 5."""
    p = model.params
    z = torch.cat([x, h], dim=1) @ p[f"{lvl}_lstm_w"] + p[f"{lvl}_lstm_b"]
    i, g, f, o = torch.chunk(z, 4, dim=1)
    c_new = (torch.sigmoid(f + FORGET_BIAS) * c
             + torch.sigmoid(i) * torch.tanh(g))
    c_new = c_new.clamp(-CELL_CLIP, CELL_CLIP)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return c_new, h_new


def _head(model: EthLstm, lvl, h, efs):
    p = model.params
    x = torch.cat([h, efs], dim=1)
    d2 = eth_cnn._leaky(x @ p[f"{lvl}_fc2_w"] + p[f"{lvl}_fc2_b"])
    d2 = torch.cat([d2, efs], dim=1)
    return torch.sigmoid(d2 @ p[f"{lvl}_fc3_w"] + p[f"{lvl}_fc3_b"])


def _split_state(state):
    out = {}
    off = 0
    for lvl in ("l64", "l32", "l16"):
        h = HIDDEN[lvl]
        out[lvl] = (state[:, 0, off:off + h], state[:, 1, off:off + h])
        off += h
    return out


@torch.no_grad()
def step(model: EthLstm, resi, qp, frame_in_gop, state, *, thr_l1=0.5,
         thr_l2=0.5, early_exit="ctu"):
    """One LDP prediction step (one frame's CTU batch).

    resi: [B, 64, 64] residue patches (u8-range, 128-centered);
    qp: [B]; frame_in_gop: [B] int (POC % 4); state: [B, 2, 448];
    early_exit: 'ctu' | 'batch' | 'none'.
    Returns (probs [B, 21], new_state [B, 2, 448]).
    """
    vec = resi_features(model, resi)
    efs = torch.cat([
        (qp.to(torch.float32) / 51.0 * 0.18)[:, None],
        nn.functional.one_hot(frame_in_gop.long(), GOP_LENGTH).to(
            torch.float32)], dim=1)

    st = _split_state(state)
    probs = {}
    new_c, new_h = [], []
    for lvl in ("l64", "l32", "l16"):
        lo, hi = VEC_SLICES[lvl]
        c, h = st[lvl]
        c2, h2 = _lstm_cell(model, lvl, vec[:, lo:hi], c, h)
        probs[lvl] = _head(model, lvl, h2, efs)
        new_c.append(c2)
        new_h.append(h2)

    p64, p32, p16 = probs["l64"], probs["l32"], probs["l16"]
    if early_exit == "ctu":
        g32 = (p64 > thr_l1).any(dim=1, keepdim=True)
        p32 = torch.where(g32, p32, torch.zeros_like(p32))
        g16 = (p32 > thr_l2).any(dim=1, keepdim=True)
        p16 = torch.where(g16, p16, torch.zeros_like(p16))
    elif early_exit == "batch":
        p32 = torch.where((p64 > thr_l1).any(), p32, torch.zeros_like(p32))
        p16 = torch.where((p32 > thr_l2).any(), p16, torch.zeros_like(p16))
    elif early_exit != "none":
        raise ValueError(f"unknown early_exit mode {early_exit!r}")

    new_state = torch.stack([torch.cat(new_c, 1), torch.cat(new_h, 1)],
                            dim=1)
    return torch.cat([p64, p32, p16], dim=1), new_state


def apply_sequence(model: EthLstm, resi_seq, qp_seq, fig_seq, state0=None):
    """Multi-step rollout: step() over T frames with the state carried.

    resi_seq: [T, B, 64, 64]; qp_seq, fig_seq: [T, B].
    Returns probs [T, B, 21] (no early exit — every level computed)."""
    state = (zero_state(resi_seq.shape[1], device=resi_seq.device)
             if state0 is None else state0)
    probs = []
    for resi, qp, fig in zip(resi_seq, qp_seq, fig_seq):
        p, state = step(model, resi, qp, fig, state, early_exit="none")
        probs.append(p)
    return torch.stack(probs)
