from audio_style_transfer_tpu_torch.analysis.spectrogram import (
    plotstft,
    stft_np,
    logscale_spec,
)
from audio_style_transfer_tpu_torch.analysis.viz import (
    show_gram,
    show_our_gram,
    show_gatys_gram,
)
