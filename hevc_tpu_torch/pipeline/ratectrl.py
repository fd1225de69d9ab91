"""Picture-level R-lambda rate control (N13).

Behavioral counterpart: HM TEncRateCtrl.cpp (1402 LoC) — the R-lambda
model of Li et al. adopted by HM: per picture,

    lambda = alpha * bpp ^ beta,     QP = 4.2005 ln(lambda) + 13.7122

with multiplicative model updates after each picture
(TEncRCPic::updateAfterPicture :1001) and a sliding bit budget
(remaining bits spread over remaining frames, smoothed). The reference
ships with rate control *off* (encoder_intra_main.cfg RateControl: 0);
this implementation provides the component for target-bitrate runs.

Design: pure host-side control state (no torch); the per-frame QP it
emits is handed to the search, the reconstruction and the filters of the
next picture (`pipeline/ai.AIEncoder.encode(rate_control=...)`).
"""

from __future__ import annotations

import math

ALPHA_MIN, ALPHA_MAX = 0.05, 500.0
BETA_MIN, BETA_MAX = -3.0, -0.1


def lambda_to_qp(lam: float) -> int:
    return int(round(4.2005 * math.log(lam) + 13.7122))


def qp_to_lambda(qp: float) -> float:
    return math.exp((qp - 13.7122) / 4.2005)


class RateController:
    """Frame-level R-lambda controller for a fixed-fps sequence."""

    def __init__(self, target_bps: float, fps: float, width: int,
                 height: int, n_frames: int, init_qp: int = 32,
                 min_qp: int = 0, max_qp: int = 51):
        self.pixels = width * height
        self.fps = fps
        self.n_frames = n_frames
        self.target_bits_total = target_bps * n_frames / fps
        self.bits_left = self.target_bits_total
        self.frames_left = n_frames
        self.min_qp, self.max_qp = min_qp, max_qp
        # R-lambda model state (HM inits alpha=3.2003, beta=-1.367 for
        # inter; intra uses a SATD-driven variant — one shared model here,
        # the update steers it per sequence)
        self.alpha = 3.2003
        self.beta = -1.367
        # update-rate schedule by sequence target bpp
        # (TEncRateCtrl.cpp:94-118)
        bpp = (self.target_bits_total / n_frames) / self.pixels
        if bpp < 0.03:
            self.alpha_update, self.beta_update = 0.01, 0.005
        elif bpp < 0.08:
            self.alpha_update, self.beta_update = 0.05, 0.025
        elif bpp < 0.2:
            self.alpha_update, self.beta_update = 0.1, 0.05
        elif bpp < 0.5:
            self.alpha_update, self.beta_update = 0.2, 0.1
        else:
            self.alpha_update, self.beta_update = 0.4, 0.2
        # calibrate alpha so the first picture starts at init_qp
        self.alpha = qp_to_lambda(init_qp) / max(bpp, 1e-6) ** self.beta
        self.alpha = min(max(self.alpha, ALPHA_MIN), ALPHA_MAX)
        self.last_qp = init_qp
        self.last_lambda = None

    def pre_frame(self) -> int:
        """Target QP for the next picture."""
        target_bits = max(self.bits_left / max(self.frames_left, 1),
                          0.01 * self.pixels)
        bpp = target_bits / self.pixels
        lam = self.alpha * (bpp ** self.beta)
        lam = min(max(lam, qp_to_lambda(self.min_qp)),
                  qp_to_lambda(self.max_qp))
        if self.last_lambda is not None:
            # HM clips lambda swing to ~2x(+/-1 QP step of 3) per picture
            lam = min(max(lam, self.last_lambda * 2 ** (-3.0 / 3.0)),
                      self.last_lambda * 2 ** (3.0 / 3.0))
        qp = lambda_to_qp(lam)
        qp = min(max(qp, self.last_qp - 3, self.min_qp),
                 self.last_qp + 3, self.max_qp)
        self._pending = (lam, qp)
        return qp

    def post_frame(self, actual_bits: int):
        """Model update with the picture's actual bits
        (TEncRCPic::updateAfterPicture semantics)."""
        lam_used, qp_used = self._pending
        self.bits_left -= actual_bits
        self.frames_left -= 1
        self.last_qp = qp_used
        self.last_lambda = lam_used

        bpp = actual_bits / self.pixels
        if bpp < 0.0001 or lam_used < 0.01:
            self.alpha *= 1.0 - self.alpha_update / 2.0
            self.beta *= 1.0 - self.beta_update / 2.0
        else:
            cal_lambda = self.alpha * (bpp ** self.beta)
            if cal_lambda > 0.01:
                err = math.log(lam_used) - math.log(cal_lambda)
                self.alpha += self.alpha_update * err * self.alpha
                lnbpp = min(max(math.log(bpp), -5.0), -0.1)
                self.beta += self.beta_update * err * lnbpp
        self.alpha = min(max(self.alpha, ALPHA_MIN), ALPHA_MAX)
        self.beta = min(max(self.beta, BETA_MIN), BETA_MAX)


# Unused until per-CTU QP (cu_qp_delta) is ported: the port's encoders
# raise for EncoderConfig(cu_qp_delta=True), so nothing calls
# pre_frame_lcu yet.
class LCURateController(RateController):
    """LCU-level R-lambda rate control (TEncRateCtrl.cpp:1402 LCU path
    behavioral counterpart, batched over all LCUs of a picture).

    HM walks LCUs sequentially, allocating each LCU a share of the
    picture's remaining bits weighted by the co-located LCU's predicted
    MAD and re-deriving lambda/QP per LCU. Our encoder quantizes every
    CTU in one device program, so the allocation is computed for ALL
    LCUs up front from the forced-64x64 pre-encode residue MAD (the
    same complexity signal, available before the search):

        target_i = pic_target * MAD_i / sum(MAD)        (getLCUTargetBpp)
        lambda_i = alpha * bpp_i ^ beta                  (R-lambda)
        qp_i     = clip(4.2005 ln lambda_i + 13.7122,
                        pic_qp - 2, pic_qp + 2)          (HM LCU clip)

    The signalled per-CTB QPs ride cu_qp_delta syntax (PPS
    diff_cu_qp_depth = 0); picture-level model updates are inherited
    from RateController.
    """

    #: per-LCU QP swing around the picture QP (HM g_RCLCUSmoothWindow
    #: era clip: +-2)
    LCU_QP_CLIP = 2
    #: picture-QP window around init_qp covered by one compiled search
    #: program (the qp_set of the traced-QP psearch tables)
    PIC_QP_WINDOW = 6

    @property
    def qp_window(self):
        base = self.init_qp if hasattr(self, "init_qp") else self.last_qp
        lo = max(self.min_qp, base - self.PIC_QP_WINDOW - self.LCU_QP_CLIP)
        hi = min(self.max_qp, base + self.PIC_QP_WINDOW + self.LCU_QP_CLIP)
        return tuple(range(lo, hi + 1))

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_qp = self.last_qp
        # keep the picture QP inside the compiled-table window
        self.min_qp = max(self.min_qp, self.init_qp - self.PIC_QP_WINDOW)
        self.max_qp = min(self.max_qp, self.init_qp + self.PIC_QP_WINDOW)

    def pre_frame_lcu(self, mad, pic_qp):
        """Per-LCU QP map for the next picture. mad: [B] float pre-encode
        residue MAD per CTU. Returns [B] int32 QPs (the picture's
        target bits distributed MAD-proportionally)."""
        import numpy as np
        mad = np.maximum(np.asarray(mad, np.float64), 1e-3)
        lam_pic, _ = self._pending
        target_bits = max(self.bits_left / max(self.frames_left, 1),
                          0.01 * self.pixels)
        pix_per_lcu = self.pixels / mad.shape[0]
        tgt = target_bits * mad / mad.sum()             # getLCUTargetBpp
        bpp = np.maximum(tgt / pix_per_lcu, 1e-6)
        lam = self.alpha * bpp ** self.beta
        # HM clips the LCU lambda to the picture lambda * 2^(+-2/3)
        lam = np.clip(lam, lam_pic * 2.0 ** (-2.0 / 3.0),
                      lam_pic * 2.0 ** (2.0 / 3.0))
        qp = np.round(4.2005 * np.log(lam) + 13.7122).astype(np.int32)
        qp = np.clip(qp, pic_qp - self.LCU_QP_CLIP,
                     pic_qp + self.LCU_QP_CLIP)
        return np.clip(qp, self.min_qp - self.LCU_QP_CLIP,
                       self.max_qp + self.LCU_QP_CLIP).astype(np.int32)
