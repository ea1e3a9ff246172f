from audio_style_transfer_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    Trainer,
    learning_rate,
)
