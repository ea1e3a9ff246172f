"""Baseline spectral conv-autoencoder (counterpart of
audio_style_transfer_tpu/models/baseline_ae.py; reference nsynth/baseline
models/ae.py and ae_configs/nfft_1024.py).

An 11-layer strided conv encoder over (log-mag, dphase) spectrograms, a
pitch-conditioned transposed-conv decoder, and the frequency-weighted
magnitude / phase MSE loss, as an ``nn.Module``:

* the public functions take and return JAX's [B, H, W, C] layout; inside,
  tensors are NCHW (a permuted view of NHWC, which PyTorch's convs take as
  channels-last);
* each conv keeps JAX's SAME padding. A strided conv pads
  ``(total // 2, total - total // 2)`` explicitly (asymmetric for k=5 s=2 and
  k=4 s=1; ``padding="same"`` refuses a stride). The transposed conv is
  ``lax.conv_transpose(transpose_kernel=False)``: a correlation over the
  stride-dilated input with XLA's pads (:func:`_conv_transpose_padding`), the
  kernel not flipped. ``F.conv_transpose2d`` reaches it with the kernel
  flipped in both spatial axes (held that way, [Cin, Cout, kh, kw]) and its
  output cropped by ``(k - 1 - pad_a, k - 1 - pad_b)``;
* batch norm is JAX's: the batch's mean and biased variance in training,
  the running statistics in eval; decay 0.999, eps 1e-3. The running
  statistics are buffers, updated by hand in training (``F.batch_norm``'s own
  update would take the unbiased variance);
* the convs are cuDNN's (XLA ops in JAX, outside any Pallas kernel), run in
  full float32: TF32 off around every forward and backward (:func:`f32_convs`).

The weights a checkpoint of the JAX package holds cross over through
``ckpt/convert.py::baseline_params_from_numpy``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BaselineHParams:
    """reference ae.py:38-64 defaults + nfft_1024.py:25-31 overrides."""

    batch_size: int = 8
    learning_rate: float = 1e-4
    adam_beta: float = 0.5
    num_latent: int = 1984
    n_fft: int = 1024
    hop_length: int = 256
    mask: bool = True
    log_mag: bool = True
    re_im: bool = False
    dphase: bool = True
    mag_only: bool = True
    pad: bool = True
    raw_audio: bool = False
    samples_per_second: int = 16000
    num_samples: int = 64000
    cost_phase_mask: bool = False
    phase_loss_coeff: float = 1.0
    fw_loss_coeff: float = 10.0
    fw_loss_cutoff: int = 4000
    n_pitches: int = 128
    pitch_embedding_dim: int = 128
    # layer specs: ((kh, kw), (sh, sw), channels). Defaults are the
    # nfft_1024 geometry; tests use shallow variants.
    encoder_spec: tuple = None  # type: ignore[assignment]
    decoder_spec: tuple = None  # type: ignore[assignment]

    @property
    def enc_layers(self):
        return self.encoder_spec or ENCODER_LAYERS

    @property
    def dec_layers(self):
        return self.decoder_spec or DECODER_LAYERS


# (kernel hw, stride hw, channels) per encoder layer: nfft_1024.py:48-118
ENCODER_LAYERS = [
    ((5, 5), (2, 2), 128),
    ((4, 4), (2, 2), 128),
    ((4, 4), (2, 2), 128),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 512),
    ((4, 4), (2, 2), 512),
    ((4, 4), (2, 1), 512),
    ((1, 1), (1, 1), 1024),
]

# decoder mirror: nfft_1024.py:150-229
DECODER_LAYERS = [
    ((1, 1), (1, 1), 1024),
    ((4, 4), (2, 2), 512),
    ((4, 4), (2, 2), 512),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 256),
    ((4, 4), (2, 2), 128),
    ((4, 4), (2, 2), 128),
    ((5, 5), (2, 2), 128),
    ((5, 5), (2, 1), 128),
]

BN_DECAY = 0.999
BN_EPS = 1e-3


@contextlib.contextmanager
def f32_convs():
    """cuDNN convs in full float32 inside the block (PyTorch lets them use
    TF32 by default, which keeps about three decimal digits); restored after."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


def leaky_relu(x: torch.Tensor, leak: float = 0.1) -> torch.Tensor:
    """max(x, leak x) for 0 <= leak < 1 (reference nsynth/utils.py:825-835),
    one elementwise pass."""
    return F.leaky_relu(x, leak)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of a strided conv along one axis."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_transpose_padding(k: int, s: int) -> tuple[int, int]:
    """XLA's pads for ``lax.conv_transpose(padding="SAME")`` along one axis
    (jax._src.lax.convolution._conv_transpose_padding)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with an OIHW kernel (JAX ``_conv2d``)."""
    kh, kw = w.shape[2:]
    (ta, tb), (la, lb) = (_same_pads(x.shape[2], kh, stride[0]),
                          _same_pads(x.shape[3], kw, stride[1]))
    if ta or tb or la or lb:
        x = F.pad(x, (la, lb, ta, tb))
    return F.conv2d(x, w, stride=tuple(stride))


def _conv2d_transpose(x: torch.Tensor, w_t: torch.Tensor, stride) -> torch.Tensor:
    """JAX ``_conv2d_transpose`` of NCHW ``x``; ``w_t`` is the HWIO kernel
    flipped in both spatial axes, laid out [Cin, Cout, kh, kw]. The output is
    ``F.conv_transpose2d``'s full output cropped per axis by
    ``(k - 1 - pad_a, k - 1 - pad_b)``: the symmetric part through its
    ``padding``, the rest by a slice."""
    crops = [(k - 1 - a, k - 1 - b) for k, (a, b) in
             ((k, _conv_transpose_padding(k, s)) for k, s in zip(w_t.shape[2:], stride))]
    (ha, hb), (wa, wb) = crops
    y = F.conv_transpose2d(x, w_t, stride=tuple(stride), padding=(min(ha, hb), min(wa, wb)))
    h0, h1 = ha - min(ha, hb), hb - min(ha, hb)
    w0, w1 = wa - min(wa, wb), wb - min(wa, wb)
    if h0 or h1 or w0 or w1:
        y = y[:, :, h0 : y.shape[2] - h1, w0 : y.shape[3] - w1]
    return y


def _xavier(gen: torch.Generator, shape, fan: int) -> torch.Tensor:
    """Glorot uniform (slim's default in the reference's arg scope):
    U(-l, l), l = sqrt(6 / (kh kw cin + kh kw cout)) = sqrt(6 / fan)."""
    limit = math.sqrt(6.0 / fan)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


class BNConv(nn.Module):
    """conv (or transposed conv) + bias, JAX's batch norm, leaky relu. The
    parameters keep the JAX layer's names: ``w`` (OIHW, or the flipped
    [Cin, Cout, kh, kw] of a transposed conv), ``b``, ``bn_scale``,
    ``bn_bias``; the buffers ``bn_mean``, ``bn_var``."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, stride, gen: torch.Generator,
                 transpose: bool = False, activate: bool = True):
        super().__init__()
        self.stride = tuple(stride)
        self.transpose = transpose
        self.activate = activate
        shape = (cin, cout, kh, kw) if transpose else (cout, cin, kh, kw)
        self.w = nn.Parameter(_xavier(gen, shape, kh * kw * (cin + cout)))
        self.b = nn.Parameter(torch.zeros(cout))
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("bn_mean", torch.zeros(cout))
        self.register_buffer("bn_var", torch.ones(cout))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        conv = _conv2d_transpose if self.transpose else _conv2d
        y = conv(x, self.w, self.stride) + self.b[:, None, None]
        if is_training:
            # The batch's statistics normalise (biased variance, as jnp.var);
            # the running ones move by JAX's update, outside the graph.
            with torch.no_grad():
                var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
                self.bn_mean.mul_(BN_DECAY).add_((1 - BN_DECAY) * mean)
                self.bn_var.mul_(BN_DECAY).add_((1 - BN_DECAY) * var)
        # torch.batch_norm, not F.batch_norm: the latter refuses one value
        # per channel (batch 1 at the 1 x 1 latent), which JAX normalises to
        # the BN bias.
        y = torch.batch_norm(y, self.bn_scale, self.bn_bias,
                             None if is_training else self.bn_mean,
                             None if is_training else self.bn_var,
                             is_training, 0.0, BN_EPS, torch.backends.cudnn.enabled)
        return leaky_relu(y) if self.activate else y


class BaselineAE(nn.Module):
    """The baseline AE (JAX ``init_baseline_params`` / ``encode`` /
    ``decode`` / ``pitch_embeddings``). The initial weights come from a
    ``torch.Generator`` seeded ``seed``: other numbers than JAX's
    ``PRNGKey(seed)``, so parity tests carry JAX's weights across."""

    def __init__(self, hparams: BaselineHParams | None = None, in_channels: int = 1,
                 seed: int = 0):
        super().__init__()
        hp = self.hparams = hparams or BaselineHParams()
        gen = torch.Generator().manual_seed(seed)
        self.encoder = nn.ModuleList()
        cin = in_channels
        for (kh, kw), stride, cout in hp.enc_layers:
            self.encoder.append(BNConv(kh, kw, cin, cout, stride, gen))
            cin = cout
        self.z_proj = BNConv(1, 1, cin, hp.num_latent, (1, 1), gen, activate=False)
        cin = hp.num_latent + hp.pitch_embedding_dim
        self.decoder = nn.ModuleList()
        for (kh, kw), stride, cout in hp.dec_layers:
            self.decoder.append(BNConv(kh, kw, cin, cout, stride, gen, transpose=True))
            cin = cout
        self.mag_out = nn.Module()
        self.mag_out.w = nn.Parameter(_xavier(gen, (in_channels, cin, 1, 1), cin + in_channels))
        self.mag_out.b = nn.Parameter(torch.zeros(in_channels))
        self.pitch_embedding = nn.Module()
        self.pitch_embedding.w = nn.Parameter(
            torch.randn((hp.n_pitches, hp.pitch_embedding_dim), generator=gen))

    def encode(self, x: torch.Tensor, is_training: bool = True) -> torch.Tensor:
        """Spectrogram [B, H, W, C] -> latent z [B, H / 512, W / 256, num_latent]
        (reference nfft_1024.py:34-127). In training, every BN layer's running
        statistics move."""
        with f32_convs():
            h = x.permute(0, 3, 1, 2)
            for layer in self.encoder:
                h = layer(h, is_training)
            return self.z_proj(h, is_training).permute(0, 2, 3, 1)

    def pitch_embeddings(self, pitch: torch.Tensor, timesteps: int = 1) -> torch.Tensor:
        """One-hot pitch -> linear embedding (reference nsynth/utils.py:662-691):
        the embedding's rows, [B, 1, timesteps, dim]."""
        emb = self.pitch_embedding.w[pitch.reshape(-1).long()][:, None, None, :]
        return emb.expand(-1, 1, timesteps, -1)

    def decode(self, z: torch.Tensor, pitch: torch.Tensor,
               is_training: bool = True) -> torch.Tensor:
        """Latent [B, h, w, num_latent] + pitch [B] -> spectrogram [B, H, W, C]
        in (0, 1) (nfft_1024.py:130-238)."""
        z_pitch = self.pitch_embeddings(pitch, timesteps=z.shape[2])
        z_pitch = z_pitch.expand(z.shape[0], z.shape[1], z.shape[2], -1)
        with f32_convs():
            h = torch.cat([z, z_pitch], dim=3).permute(0, 3, 1, 2)
            for layer in self.decoder:
                h = layer(h, is_training)
            y = _conv2d(h, self.mag_out.w, (1, 1)) + self.mag_out.b[:, None, None]
        return torch.sigmoid(y).permute(0, 2, 3, 1)


def frequency_weighted_cost_mask(peak: float = 10.0, hz_flat: float = 1000,
                                 sr: int = 16000, n_fft: int = 512) -> np.ndarray:
    """Low-frequency-weighted loss mask (reference nsynth/utils.py:639-656),
    float32 [1, n_fft // 2, 1]."""
    n = n_fft // 2
    fft_freqs = np.arange(1 + n_fft // 2) * sr / n_fft
    cutoff = int(np.where(fft_freqs >= hz_flat)[0][0])
    mask = np.concatenate([np.linspace(peak, 1.0, cutoff), np.ones(n - cutoff)])
    return mask[None, :, None].astype(np.float32)


def compute_mse_loss(x: torch.Tensor, xhat: torch.Tensor,
                     hparams: BaselineHParams | None = None) -> torch.Tensor:
    """Frequency-weighted magnitude + phase MSE (reference ae.py:73-111) of
    [B, H, W, C] spectrograms."""
    hparams = hparams or BaselineHParams()
    if hparams.raw_audio:
        return torch.mean((x - xhat) ** 2)
    m = x[..., 0] if hparams.cost_phase_mask else 1.0
    fm = torch.as_tensor(frequency_weighted_cost_mask(
        hparams.fw_loss_coeff, hz_flat=hparams.fw_loss_cutoff, n_fft=hparams.n_fft),
        device=x.device)
    mag_loss = torch.mean(fm * (x[..., 0] - xhat[..., 0]) ** 2)
    if hparams.mag_only:
        return mag_loss
    if hparams.dphase:
        phase_loss = torch.mean(fm * m * (x[..., 1] - xhat[..., 1]) ** 2)
    else:
        phase_loss = 1 - torch.mean(fm * m * torch.cos((x[..., 1] - xhat[..., 1]) * math.pi))
    return mag_loss + hparams.phase_loss_coeff * phase_loss


def make_optimizer(model: BaselineAE) -> torch.optim.Adam:
    """Adam(lr, beta1 = adam_beta) over the parameters (reference
    ae.py:114-160; JAX ``train_step_fn``: optax.adam, eps 1e-8 outside the
    root). The BN running statistics are buffers, outside the optimizer:
    JAX keeps them in the Adam pytree with zero gradients, which move them by
    exactly zero, so both leave them to the forward's update."""
    hp = model.hparams
    return torch.optim.Adam(model.parameters(), lr=hp.learning_rate,
                            betas=(hp.adam_beta, 0.999), eps=1e-8)


def train_step(model: BaselineAE, opt: torch.optim.Optimizer, spec: torch.Tensor,
               pitch: torch.Tensor) -> torch.Tensor:
    """One step (JAX ``train_step_fn``'s ``step``): encode and decode in
    training mode (the BN running statistics move), the loss, its gradients,
    Adam. Returns the loss before the update, as a 0-d tensor on the model's
    device (no host sync)."""
    hp = model.hparams
    opt.zero_grad(set_to_none=True)
    z = model.encode(spec, is_training=True)
    xhat = model.decode(z, pitch, is_training=True)
    loss = compute_mse_loss(spec, xhat, hp)
    with f32_convs():  # the convs' gradients run here, outside encode / decode
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_interpolations(model: BaselineAE, spec: torch.Tensor,
                        pitch: torch.Tensor) -> dict:
    """Latent interpolation + pitch-shift decodes in eval mode (reference
    ae.py:207-226)."""
    z = model.encode(spec, is_training=False)
    xhat = model.decode(z, pitch, is_training=False)
    z_shift = torch.cat([z[1:], z[:1]], 0)
    z_half = (z + z_shift) / 2.0
    return {
        "reconstruction": xhat,
        "linear_interp_half": model.decode(z_half, pitch, is_training=False),
        "pitch_plus_2": model.decode(z, torch.clamp(pitch + 2, 0, 127), is_training=False),
        "pitch_minus_2": model.decode(z, torch.clamp(pitch - 2, 0, 127), is_training=False),
    }
