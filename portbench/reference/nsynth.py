"""The NSynth WaveNet autoencoder in plain PyTorch (magenta
``nsynth/wavenet/h512_bo16.py``, arXiv:1704.01279).

Layout [B, T, C]; a conv weight is [F, Cin, Cout] under the TF scope names.
Encoder: a non-causal start conv, then ``ae_num_layers`` residual blocks
``x + W_res relu(conv3_d(relu x) + b_d) + b_res`` with dilations
2^(k mod ae_num_stages), a 1x1 bottleneck and average pooling by the hop.
Decoder: a causal start conv on the input shifted right by one, blocks of a
causal dilated conv plus the conditioning, a sigmoid x tanh gate, a residual
and a skip 1x1 conv, then relu, ``out1`` plus its conditioning, relu and the
logits. Every conv is ``torch.nn.functional.conv1d`` or a matrix product in
float32; ``q`` (``lowp``) is applied to each conv's input, weight and output.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.lowp import EXACT

GEOMETRY_KEYS = ("num_layers", "num_stages", "filter_length", "width", "skip_width",
                 "ae_num_layers", "ae_num_stages", "ae_filter_length", "ae_width",
                 "ae_hop_length", "ae_bottleneck_width", "quant_channels")


def layer_shapes(cfg: dict) -> dict[str, tuple[int, int, int]]:
    """Layer name -> (filter, in, out) of every conv of the autoencoder."""
    shapes = {"ae_startconv": (cfg["ae_filter_length"], 1, cfg["ae_width"])}
    for k in range(1, cfg["ae_num_layers"] + 1):
        shapes[f"ae_dilatedconv_{k}"] = (cfg["ae_filter_length"], cfg["ae_width"], cfg["ae_width"])
        shapes[f"ae_res_{k}"] = (1, cfg["ae_width"], cfg["ae_width"])
    shapes["ae_bottleneck"] = (1, cfg["ae_width"], cfg["ae_bottleneck_width"])
    w, s, bw = cfg["width"], cfg["skip_width"], cfg["ae_bottleneck_width"]
    shapes["startconv"] = (cfg["filter_length"], 1, w)
    shapes["skip_start"] = (1, w, s)
    for i in range(1, cfg["num_layers"] + 1):
        shapes[f"dilatedconv_{i}"] = (cfg["filter_length"], w, 2 * w)
        shapes[f"cond_map_{i}"] = (1, bw, 2 * w)
        shapes[f"res_{i}"] = (1, w, w)
        shapes[f"skip_{i}"] = (1, w, s)
    shapes["out1"] = (1, s, s)
    shapes["cond_map_out1"] = (1, bw, s)
    shapes["logits"] = (1, s, cfg["quant_channels"])
    return shapes


@contextlib.contextmanager
def float32_exact():
    """TF32 off for products and convolutions inside, restored after."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32, c.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = before


def mu_law_floor(audio: np.ndarray) -> np.ndarray:
    """The floor-quantizing mu-law of a waveform in [-1, 1], in float64:
    values in [-128, 128]."""
    a = np.asarray(audio, np.float64)
    return np.floor(np.sign(a) * np.log1p(255.0 * np.abs(a)) / np.log1p(255.0) * 128.0)


def mu_law(x: torch.Tensor) -> torch.Tensor:
    """The continuous mu-law of a waveform (no floor), values in [-128, 128]."""
    return torch.sign(x) * torch.log1p(255.0 * torch.abs(x)) / float(np.log1p(255.0)) * 128.0


def conv(x, layer: dict, *, dilation: int = 1, causal: bool, q=EXACT) -> torch.Tensor:
    """x [B, T, Cin] through a conv of weight [F, Cin, Cout] and bias [Cout]."""
    w, b = layer["w"].float(), layer["b"].float()
    x, w = q(x.float()), q(w)
    f = w.shape[0]
    if f == 1:
        y = x @ w[0]
    else:
        span = (f - 1) * dilation
        left = span if causal else span // 2
        xt = F.pad(x.transpose(1, 2), (left, span - left))
        y = F.conv1d(xt, w.permute(2, 1, 0), dilation=dilation).transpose(1, 2)
    return q(y + b)


def encoder(params, xq: torch.Tensor, cfg: dict, taps=(), q=EXACT, encoding: bool = False):
    """({layer: tap [B, T, C]} of the trunk layers in ``taps``, and with
    ``encoding`` the hop-pooled bottleneck [B, T / hop, bottleneck], else
    None) of a mu-law input [B, T]."""
    enc = conv((xq.float() / 128.0)[..., None], params["ae_startconv"], causal=False, q=q)
    out = {}
    for k in range(cfg["ae_num_layers"]):
        d = conv(torch.relu(enc), params[f"ae_dilatedconv_{k + 1}"],
                 dilation=2 ** (k % cfg["ae_num_stages"]), causal=False, q=q)
        enc = q(enc + conv(torch.relu(d), params[f"ae_res_{k + 1}"], causal=False, q=q))
        if k in taps:
            out[k] = enc
    if not encoding:
        return out, None
    z = conv(enc, params["ae_bottleneck"], causal=False, q=q)
    b, t, c = z.shape
    hop = cfg["ae_hop_length"]
    return out, z.reshape(b, t // hop, hop, c).mean(dim=2)


def _upsample(cond: torch.Tensor, hop: int) -> torch.Tensor:
    return cond.repeat_interleave(hop, dim=1)


def decoder_logits(params, xq: torch.Tensor, encoding: torch.Tensor, cfg: dict,
                   q=EXACT) -> torch.Tensor:
    """Teacher-forced logits [B, T, quant_channels] of a mu-law input [B, T]."""
    hop, w = cfg["ae_hop_length"], cfg["width"]
    x = (xq.float() / 128.0)[..., None]
    l = conv(F.pad(x, (0, 0, 1, 0))[:, :-1], params["startconv"], causal=True, q=q)
    s = conv(l, params["skip_start"], causal=True, q=q)
    for i in range(1, cfg["num_layers"] + 1):
        d = conv(l, params[f"dilatedconv_{i}"], dilation=2 ** ((i - 1) % cfg["num_stages"]),
                 causal=True, q=q)
        d = d + _upsample(conv(encoding, params[f"cond_map_{i}"], causal=True, q=q), hop)
        gate = torch.sigmoid(d[..., :w]) * torch.tanh(d[..., w:])
        l = l + conv(gate, params[f"res_{i}"], causal=True, q=q)
        s = s + conv(gate, params[f"skip_{i}"], causal=True, q=q)
    s = torch.relu(s)
    s = conv(s, params["out1"], causal=True, q=q)
    s = torch.relu(s + _upsample(conv(encoding, params["cond_map_out1"], causal=True, q=q), hop))
    return conv(s, params["logits"], causal=True, q=q)


def nll_sum(logits: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """The sum over rows of -log softmax(logits)[label], label = trunc(xq) +
    128 (every label of the benchmark's audio lies in [0, 256))."""
    q = logits.shape[-1]
    labels = torch.trunc(xq).long().reshape(-1) + 128
    logp = torch.log_softmax(logits.reshape(-1, q).float(), dim=-1)
    return -logp.gather(1, labels[:, None]).sum()
