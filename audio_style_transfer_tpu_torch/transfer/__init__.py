from audio_style_transfer_tpu_torch.transfer.grams import (
    content_embeds,
    style_gram,
    select_style_layers,
    l2_normalize,
)
from audio_style_transfer_tpu_torch.transfer.lbfgs import (
    LBFGSOptions,
    LBFGSResult,
    lbfgs_minimize,
)
from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
