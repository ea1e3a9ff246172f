from audio_style_transfer_tpu_torch.data.tfrecord import (
    read_tfrecord,
    write_tfrecord,
    parse_example,
    build_example,
)
from audio_style_transfer_tpu_torch.data.nsynth import NSynthDataset
