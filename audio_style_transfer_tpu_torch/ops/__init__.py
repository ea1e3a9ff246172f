from audio_style_transfer_tpu_torch.ops.conv import (
    conv1d,
    pool1d,
    shift_right,
    condition,
)
