from audio_style_transfer_tpu_torch.generate.fastgen import (
    encode,
    synthesize,
    load_batch,
    save_batch,
)
