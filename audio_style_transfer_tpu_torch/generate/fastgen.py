"""Autoregressive WaveNet synthesis (counterpart of
audio_style_transfer_tpu/generate/fastgen.py).

The JAX package runs the whole sample loop as one ``lax.scan``. Here one
decoder step is one Python function, ``_decoder_step``, written once: a CPU
tensor runs it eagerly step by step (the plain loop); a CUDA tensor captures
it, with the feedback and the bookkeeping of one sample, into one
``torch.cuda.CUDAGraph`` that is replayed once per sample. Nothing falls back:
a capture or replay that fails raises. ``eager=True`` runs the plain loop on
the card, for comparisons only.

State, as in JAX (reference utils.py:838-887, FIFO queues): each decoder
layer keeps the inputs of its last 2r steps in a ring of 2r slots; at step t
slot ``t mod 2r`` holds x[t-2r] and slot ``(t + r) mod 2r`` holds x[t-r]; both
are read, then slot ``t mod 2r`` is overwritten with x[t]. Here the 30 rings
(and the 1-channel ring of the start conv) live in one flat buffer, so one
gather reads every past tap of a step and one scatter pushes every layer's
input: the past taps do not depend on the step's own work. The step counter
``t`` is a device tensor that the step itself advances, and every index that
depends on it (the ring slots of all layers, computed together, the
conditioning frame ``t // hop``, the row of the chunk's noise) is computed
from it on the device: no Python int that changes from step to step reaches
a captured op.

Products. Two merges of JAX's products, each the same function up to the
order of an f32 sum:
  - a dilated conv's three tap products ``w[0] @ x[t-2r] + w[1] @ x[t-r] +
    w[2] @ x[t]`` are one ``[B, 3C] @ [3C, 2C]`` product (the weight
    [3, C, 2C] read as [3C, 2C]); JAX rounds each 512-term sum and adds the
    three, here one 1536-term sum is rounded once. The start conv (the same
    causal conv, one input channel) likewise;
  - ``res`` and ``skip`` read the same gate: one ``[B, C] @ [C, C + S]``
    product on their weights side by side; each output element is the same
    sum as before.
Everything else keeps JAX's order: ``(product + b) + cond``, ``l + (product +
b)``, ``s + (product + b)``.

Weight formats, the same function as JAX's on the CPU:
  - float32: f32 products (TF32 off on the card is the caller's setting);
  - bfloat16 (``dtype=torch.bfloat16``): JAX casts every parameter to bf16
    and keeps activations in f32, so ``x @ w`` is an f32 product of
    bf16-rounded weights plus the bf16 bias as f32. The weights stay bf16
    on the device; the step up-casts each weight to f32 before its product,
    inside the captured step, which costs bytes (written 4, read 4 for every
    2 stored) that a fused kernel would not;
  - int8 (``quantize="int8"``): ``quantize_params_int8``; a product rounds x
    to bf16 and multiplies it by the int8 weight with f32 sums, then scales
    each output channel (JAX ``_mm``, ``preferred_element_type=f32``). The
    weights stay ``torch.int8`` on the device and are up-cast per step, as
    bf16's are.

Sampling is the Gumbel-max form of ``jax.random.categorical``:
``argmax(logits - log(-log U))`` with U uniform in f32 (floored at the
smallest normal, as JAX's ``gumbel``). U is drawn outside the graph, one hop
of steps at a time ([hop, B, 256]), from an explicit ``torch.Generator``; the
step reads its row. The bits cannot equal ``jax.random``'s. The fed-back
input is ``mu_law(inv_mu_law(bin - 128)) / 128`` (continuous mu-law), zero at
t = 0; as a function of the bin it is read from a 256-entry table computed
once with the same functions.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    Params,
    WaveNetAEConfig,
    encoder_extracts,
)
from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law, mu_law
from audio_style_transfer_tpu_torch.utils.audio_io import (
    load_audio_mono,
    trim_for_encoding,
    write_wav,
)

_F32 = torch.float32
_BF16 = torch.bfloat16


def _device_of(params: Params) -> torch.device:
    return params["logits"]["b"].device


def _f32(a, device) -> torch.Tensor:
    """A tensor or array as an f32 tensor on ``device`` (arrays are copied)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_F32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


# --------------------------------------------------------------------- #
# Encoder inference (reference fastgen.py:86-113)
# --------------------------------------------------------------------- #


def encode(wav_data: np.ndarray, params: Params, sample_length: int = 64000,
           cfg: WaveNetAEConfig | None = None) -> np.ndarray:
    """[B, T] raw audio -> [B, T / hop, 16] encodings, on the device of the
    params. The encoder reads the continuous mu-law of the trimmed audio."""
    cfg = cfg or WaveNetAEConfig()
    if wav_data.ndim == 1:
        wav_data = wav_data[None, :]
    wav_data, sample_length = trim_for_encoding(wav_data, sample_length, cfg.ae_hop_length)
    x = mu_law(_f32(wav_data, _device_of(params)))
    return _encoding_only(params, x, cfg).cpu().numpy()


def _encoding_only(params: Params, x: torch.Tensor, cfg: WaveNetAEConfig) -> torch.Tensor:
    """Only the pooled encoding, from a gradient-free pass that keeps the
    bottleneck's tap and nothing else (``needed_taps=(31,)``; with the
    chained trunk that is one K1 launch per layer, 30 a call)."""
    with torch.no_grad():
        return encoder_extracts(params, x, cfg, needed_taps=(31,))[1]


# --------------------------------------------------------------------- #
# Weights
# --------------------------------------------------------------------- #


def quantize_params_int8(params: Params, min_size: int = 65536) -> Params:
    """Per-output-channel symmetric int8 quantization of the large weights.

    A weight of at least ``min_size`` elements becomes ``w_q`` (int8, round
    half to even, clipped to +-127) and ``w_scale`` (f32, the max |w| over
    the filter and input axes over 127, floored at 1e-12); its bias stays.
    Smaller tensors (biases, cond maps, the 1-channel start conv) stay as
    they are."""

    def q(entry):
        w = entry["w"]
        if w.numel() < min_size:
            return entry
        scale = w.abs().amax(dim=tuple(range(w.dim() - 1))) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"w_q": w_q, "w_scale": scale.to(_F32), "b": entry["b"]}

    return {name: q(entry) for name, entry in params.items()}


@dataclasses.dataclass
class _Linear:
    """``x @ w + b`` on [B, K] f32 activations, in the weight's format: w is
    [K, N] float32, bfloat16 or int8 (then with ``scale`` [N]); b is [N] f32."""

    w: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor | None = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale is not None:  # JAX _mm: bf16 operands, f32 sums, then the scale
            y = x.to(_BF16).to(_F32) @ self.w.to(_F32)
            return (y * self.scale).add_(self.b)
        return torch.addmm(self.b, x, self.w.to(_F32))


def _linear(entries: list[dict], k: int | None = None) -> _Linear:
    """One ``_Linear`` of the entries' weights side by side on the output
    axis (each [F, K, N_i]; tap ``k`` of each, or all taps stacked on the
    input axis when k is None)."""
    quantized = {"w_q" in e for e in entries}
    if len(quantized) != 1:
        raise ValueError("cannot merge an int8 weight with a plain one: quantize both or neither")
    key = "w_q" if quantized.pop() else "w"

    def mat(e):
        w = e[key]
        return w.reshape(-1, w.shape[-1]) if k is None else w[k]

    w = torch.cat([mat(e) for e in entries], dim=1) if len(entries) > 1 else mat(entries[0])
    b = torch.cat([e["b"].to(_F32) for e in entries])
    scale = torch.cat([e["w_scale"] for e in entries]) if key == "w_q" else None
    return _Linear(w.contiguous(), b, scale)


class _DecoderWeights:
    """The decoder's products in the step's layout (see the module note)."""

    def __init__(self, params: Params, cfg: WaveNetAEConfig):
        n = cfg.num_layers
        self.start = _linear([params["startconv"]])            # [3, C]
        self.skip_start = _linear([params["skip_start"]], 0)   # [C, S]
        self.dil = [_linear([params[f"dilatedconv_{i}"]]) for i in range(1, n + 1)]  # [3C, 2C]
        self.res_skip = [_linear([params[f"res_{i}"], params[f"skip_{i}"]], 0)
                         for i in range(1, n + 1)]              # [C, C + S]
        self.out1 = _linear([params["out1"]], 0)
        self.logits = _linear([params["logits"]], 0)


def decoder_weight_bytes(params: Params, cfg: WaveNetAEConfig | None = None) -> int:
    """Bytes of the weights, scales and biases one decoder step reads, in the
    format the step keeps them (the cond maps are projected once, outside the
    loop): the weight-streaming floor of a step is this over the memory rate."""
    w = _DecoderWeights(params, cfg or WaveNetAEConfig())
    lins = [w.start, w.skip_start, *w.dil, *w.res_skip, w.out1, w.logits]
    return sum(a.numel() * a.element_size() for lin in lins
               for a in (lin.w, lin.b, lin.scale) if a is not None)


def cond_bytes(cfg: WaveNetAEConfig, batch: int, frames: int) -> int:
    """Bytes of ``_precompute_cond``'s f32 output: (num_layers * 2 * width +
    skip_width) * 4 per frame and stream, 123 904 at the full geometry."""
    return (cfg.num_layers * 2 * cfg.width + cfg.skip_width) * 4 * batch * frames


def _precompute_cond(params: Params, cfg: WaveNetAEConfig,
                     encodings: torch.Tensor) -> torch.Tensor:
    """Every encoding frame through every cond_map layer, once, outside the
    sample loop: [F, B, num_layers * 2 * width + skip_width] f32, layer i's
    map in columns [i * 2W, (i + 1) * 2W), cond_map_out1's last. One product
    per layer on the same rows as JAX's list of arrays (the same numbers);
    frame-major so that a step reads its frame's row in one gather.

    Memory: ``cond_bytes`` = 123 904 B per frame and stream at the full
    geometry: 232 MB for one 60 s clip (1875 frames), 7.4 GB at B=32."""
    b, frames, z = encodings.shape
    names = [f"cond_map_{i}" for i in range(1, cfg.num_layers + 1)] + ["cond_map_out1"]
    cond = torch.empty((frames, b, cond_bytes(cfg, 1, 1) // 4), dtype=_F32,
                       device=encodings.device)
    rows = encodings.reshape(b * frames, z)
    col = 0
    for name in names:
        y = _linear([params[name]], 0)(rows)
        cond[:, :, col:col + y.shape[1]] = y.reshape(b, frames, -1).transpose(0, 1)
        col += y.shape[1]
    return cond


# --------------------------------------------------------------------- #
# Autoregressive decoder state and the one step
# --------------------------------------------------------------------- #


class _DecoderState:
    """Everything a step reads and writes, at fixed addresses (the graph
    replays against them). ``stage[i]`` is layer i's product input [B, 3, C]:
    x[t-2r], x[t-r], x[t]; ``stage0`` the start conv's [B, 3]; ``buf`` the
    layers' rings one after another, ``xbuf`` the start conv's ring of 2."""

    def __init__(self, cfg: WaveNetAEConfig, batch: int, device: torch.device):
        n, c = cfg.num_layers, cfg.width
        rates = [cfg.dilation(i) for i in range(n)]
        offs = np.concatenate([[0], np.cumsum([2 * r for r in rates])])
        # Ring slot of entry e at step t: (t + phase[e]) % two_r[e] + offs[e], for
        # [x[t-2r] of layers 0..n-1 | x[t-r] of layers 0..n-1 | start conv's two].
        def vec(a):
            return torch.tensor(np.asarray(a, np.int64), device=device)

        self.two_r = vec([2 * r for r in rates] * 2 + [2, 2])
        self.phase = vec([0] * n + rates + [0, 1])
        self.offs = vec(list(offs[:n]) * 2 + [0, 0])
        self.t = torch.zeros(1, dtype=torch.int64, device=device)
        self.buf = torch.zeros((int(offs[-1]), batch, c), dtype=_F32, device=device)
        self.xbuf = torch.zeros((2, batch), dtype=_F32, device=device)
        self.stage = torch.zeros((n, batch, 3, c), dtype=_F32, device=device)
        self.stage0 = torch.zeros((batch, 3), dtype=_F32, device=device)

    def reset(self) -> None:
        for a in (self.t, self.buf, self.xbuf, self.stage, self.stage0):
            a.zero_()


def _decoder_step(w: _DecoderWeights, st: _DecoderState, cond: torch.Tensor,
                  cfg: WaveNetAEConfig) -> torch.Tensor:
    """One incremental decoder step at step ``st.t`` on the input x[t] in
    ``st.stage0[:, 2]``: logits [B, 256]; every ring gets its x[t]. ``st.t``
    is not advanced here."""
    n, c = cfg.num_layers, cfg.width
    b = st.stage.shape[1]
    slots = torch.remainder(st.t + st.phase, st.two_r).add_(st.offs)
    taps = st.buf.index_select(0, slots[:2 * n])
    st.stage[:, :, :2].copy_(taps.view(2, n, b, c).permute(1, 2, 0, 3))
    st.stage0[:, :2].copy_(st.xbuf.index_select(0, slots[2 * n:]).t())
    row = cond.index_select(0, torch.div(st.t, cfg.ae_hop_length, rounding_mode="floor"))[0]

    l0 = w.start(st.stage0)
    st.stage[0, :, 2].copy_(l0)
    s = w.skip_start(l0)
    for i in range(n):
        d = w.dil[i](st.stage[i].view(b, 3 * c))
        d += row[:, 2 * c * i:2 * c * (i + 1)]
        gate = torch.sigmoid(d[:, :c]) * torch.tanh(d[:, c:])
        y = w.res_skip[i](gate)
        if i + 1 < n:  # the last layer's residual output feeds nothing
            torch.add(st.stage[i, :, 2], y[:, :c], out=st.stage[i + 1, :, 2])
        s += y[:, c:]
    s = w.out1(torch.relu(s))
    s += row[:, 2 * c * n:]
    logits = w.logits(torch.relu(s))

    st.buf.index_copy_(0, slots[:n], st.stage[:, :, 2])
    st.xbuf.index_copy_(0, slots[2 * n:2 * n + 1], st.stage0[:, 2][None])
    return logits


def _run_loop(step, total: int, chunk: int, refill, drain, state: _DecoderState,
              eager: bool) -> None:
    """``step()`` ``total`` times, ``refill(c0, n)`` before and ``drain(c0,
    n)`` after each chunk of ``n <= chunk`` steps. A CPU state runs the plain
    loop; a CUDA state replays one captured step unless ``eager``."""
    graph = None
    if state.t.device.type == "cuda" and not eager:
        graph = _capture(step, state)
    for c0 in range(0, total, chunk):
        n = min(chunk, total - c0)
        refill(c0, n)
        for _ in range(n):
            if graph is None:
                step()
            else:
                graph.replay()
        drain(c0, n)


def _capture(step, state: _DecoderState) -> torch.cuda.CUDAGraph:
    """``step`` captured into a CUDA graph: one eager warm-up on a side
    stream (it initialises the libraries' handles and moves the state),
    the state reset, then the capture (which runs nothing)."""
    dev = state.t.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    state.reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph


def incremental_logits(params: Params, x_quantized, encoding,
                       cfg: WaveNetAEConfig | None = None, eager: bool = False) -> torch.Tensor:
    """Teacher-forced incremental decode: the step, fed the known sequence
    shifted right by one (the decoder reads x[t-1] when predicting x[t]).
    Equals ``models.wavenet_ae.decode_logits`` up to the order of f32 sums:
    the oracle of the ring state. Runs on the params' device (graphed on a
    CUDA device unless ``eager``).

    x_quantized [B, T] in the quantized space, encoding [B, T / hop, z];
    returns logits [B, T, 256] f32."""
    cfg = cfg or WaveNetAEConfig()
    dev = _device_of(params)
    xq = _f32(x_quantized, dev)
    b, total = xq.shape
    x_in = F.pad(xq / 128.0, (1, 0))[:, :total].t().contiguous()  # [T, B]
    enc = _f32(encoding, dev)
    w, cond = _DecoderWeights(params, cfg), _precompute_cond(params, cfg, enc)
    st = _DecoderState(cfg, b, dev)
    chunk = cfg.ae_hop_length
    x_chunk = torch.zeros((chunk, b), dtype=_F32, device=dev)
    logits_chunk = torch.zeros((chunk, b, cfg.quant_channels), dtype=_F32, device=dev)
    out = torch.empty((b, total, cfg.quant_channels), dtype=_F32, device=dev)

    def step():
        k = torch.remainder(st.t, chunk)
        st.stage0[:, 2].copy_(x_chunk.index_select(0, k)[0])
        logits_chunk.index_copy_(0, k, _decoder_step(w, st, cond, cfg)[None])
        st.t += 1

    def refill(c0, n):
        x_chunk[:n].copy_(x_in[c0:c0 + n])

    def drain(c0, n):
        out[:, c0:c0 + n] = logits_chunk[:n].transpose(0, 1)

    _run_loop(step, total, chunk, refill, drain, st, eager)
    return out


def _feedback_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(audio, next input) of each of the 256 bins: ``inv_mu_law(bin - 128)``
    and ``mu_law(audio) / 128``, the functions of the JAX loop."""
    audio = inv_mu_law(torch.arange(256, dtype=_F32, device=device) - 128.0)
    return audio, mu_law(audio) / 128.0


def sample_loop(params: Params, encodings, generator: torch.Generator,
                cfg: WaveNetAEConfig | None = None, eager: bool = False) -> torch.Tensor:
    """Generate [B, F * hop] audio for [B, F, z] encodings on the params'
    device (the sample loop of the JAX ``synthesize_jit``). ``generator``, on
    the same device, draws U: one ``torch.rand([hop, B, 256])`` per hop, in
    order, floored at the smallest normal f32."""
    cfg = cfg or WaveNetAEConfig()
    dev = _device_of(params)
    enc = _f32(encodings, dev)
    b, frames, _ = enc.shape
    chunk = cfg.ae_hop_length
    total = frames * chunk
    w, cond = _DecoderWeights(params, cfg), _precompute_cond(params, cfg, enc)
    st = _DecoderState(cfg, b, dev)
    audio_table, x_table = _feedback_tables(dev)
    gumbel = torch.zeros((chunk, b, cfg.quant_channels), dtype=_F32, device=dev)
    audio_chunk = torch.zeros((chunk, b), dtype=_F32, device=dev)
    out = torch.empty((b, total), dtype=_F32, device=dev)
    tiny = torch.finfo(_F32).tiny

    def step():
        logits = _decoder_step(w, st, cond, cfg)
        k = torch.remainder(st.t, chunk)
        bins = torch.argmax(logits + gumbel.index_select(0, k)[0], dim=-1)
        audio_chunk.index_copy_(0, k, audio_table.index_select(0, bins)[None])
        st.stage0[:, 2].copy_(x_table.index_select(0, bins))
        st.t += 1

    def refill(c0, n):
        u = torch.rand(gumbel.shape, generator=generator, device=dev).clamp_(min=tiny)
        torch.neg(torch.log(torch.neg(torch.log(u))), out=gumbel)

    def drain(c0, n):
        out[:, c0:c0 + n] = audio_chunk[:n].t()

    _run_loop(step, total, chunk, refill, drain, st, eager)
    return out


def synthesize(
    encodings: np.ndarray,
    save_paths: list[str] | None = None,
    params: Params | None = None,
    cfg: WaveNetAEConfig | None = None,
    seed: int = 0,
    sr: int = 16000,
    dtype: torch.dtype | None = None,
    quantize: str | None = None,
) -> np.ndarray:
    """Host wrapper mirroring reference fastgen.synthesize:160-212: [B, F, z]
    encodings -> [B, F * hop] audio (numpy), written to ``save_paths`` when
    given. Runs on the params' device; the uniforms come from a generator on
    that device seeded with ``seed``.

    ``dtype=torch.bfloat16`` casts every parameter to bf16;
    ``quantize="int8"`` stores the large decoder matrices as int8 with one
    scale per output channel (``quantize_params_int8``); the two exclude each
    other, as in JAX."""
    if params is None:
        raise ValueError("synthesize requires params")
    if quantize is not None and dtype is not None:
        raise ValueError(
            f"dtype={dtype} and quantize={quantize!r} are mutually exclusive: "
            "int8 quantization fixes the storage format of the large decoder "
            "matrices itself (pass exactly one)")
    if quantize == "int8":
        params = quantize_params_int8(params)
    elif quantize is not None:
        raise ValueError(f"unsupported quantize={quantize!r} (use 'int8')")
    elif dtype is not None:
        params = {name: {k: v.to(dtype) for k, v in e.items()} for name, e in params.items()}
    gen = torch.Generator(device=_device_of(params)).manual_seed(int(seed))
    audio = sample_loop(params, encodings, gen, cfg).cpu().numpy()
    if save_paths:
        save_batch(audio, save_paths, sr=sr)
    return audio


# --------------------------------------------------------------------- #
# Batch file helpers (reference fastgen.py:116-157)
# --------------------------------------------------------------------- #


def load_batch(files: list[str], sample_length: int = 64000) -> np.ndarray:
    """Load and zero-pad a batch of .wav or .npy files."""
    batch_data = []
    max_length = 0
    is_npy = os.path.splitext(files[0])[1] == ".npy"
    for f in files:
        data = np.load(f) if is_npy else load_audio_mono(f, sample_length, sr=16000)
        batch_data.append(data)
        max_length = max(max_length, data.shape[0])
    for i, data in enumerate(batch_data):
        if data.shape[0] < max_length:
            if is_npy:
                padded = np.zeros([max_length, data.shape[1]], data.dtype)
                padded[: data.shape[0], :] = data
            else:
                padded = np.zeros([max_length], data.dtype)
                padded[: data.shape[0]] = data
            batch_data[i] = padded
    return np.stack(batch_data)


def save_batch(batch_audio: np.ndarray, batch_save_paths: list[str], sr: int = 16000):
    for audio, name in zip(batch_audio, batch_save_paths):
        write_wav(name, audio, sr=sr)
