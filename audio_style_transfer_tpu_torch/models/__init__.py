from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    WaveNetAEConfig,
    init_params,
    encoder_features,
    encoder_extracts,
    decode_logits,
    forward,
)
