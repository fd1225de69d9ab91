"""Training-side tools. Ported so far: the CU-depth labels and the HM
configuration texts (`labels`); the QP bands of the shipped checkpoints
live in `models/eth_cnn` (`QP_BANDS`, `band_for_qp`)."""
