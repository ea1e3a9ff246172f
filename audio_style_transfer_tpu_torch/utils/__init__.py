from audio_style_transfer_tpu_torch.utils.audio_io import (
    load_audio,
    read_wav,
    write_wav,
    resample,
)
from audio_style_transfer_tpu_torch.utils.paths import crt_t_fol, gt_s_path
