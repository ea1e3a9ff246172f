"""Signal processing: mu-law codecs and the STFT regularizer."""

from audio_style_transfer_tpu_torch.signal.mu_law import (
    mu_law,
    mu_law_quantize,
    inv_mu_law,
    inv_mu_law_numpy,
    mu_law_numpy,
    safe_abs,
    safe_sign,
)
from audio_style_transfer_tpu_torch.signal.stft import stft, stft_l1, frame_signal
