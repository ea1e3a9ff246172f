"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel could take, each hand-written kernel's bytes and operations per
launch, and the model's operations per evaluation and per training step.

Operations count 2 per multiply-add. A launch's bound is the larger of its
bytes over the memory rate and its operations over the peak rate of the
inputs' type; bytes count each input read once and each output written once.
"""

from __future__ import annotations

from portbench.reference.transfer import style_taps

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype])


# --------------------------------------------------------------------------
# The hand-written kernels, per launch, as functions of the shapes.
# rows: time rows of the launch (batch x time); c: the trunk width.
# --------------------------------------------------------------------------

def _trunk(rows: int, c: int, dtype: str) -> tuple[float, float, float]:
    item = ITEMSIZE[dtype]
    act = rows * c * item          # one activation or cotangent array
    weights = 4 * c * c * item     # the dilated conv's 3 taps and the residual
    product = 2.0 * rows * c * c   # one [rows, c] x [c, c] product
    return act, weights, product


def k1(rows: int, c: int, dtype: str) -> tuple[float, float]:
    """K1, one trunk layer forward: x in, out and one mask byte per element
    out; the dilated conv (3 products) and the residual."""
    act, weights, product = _trunk(rows, c, dtype)
    return 2 * act + rows * c + weights, 4 * product


def k2(rows: int, c: int, dtype: str, tap: bool) -> tuple[float, float]:
    """K2, one trunk layer's waveform cotangent: dx in and out, the tap's
    cotangent where the layer emits one, two mask arrays; 4 products."""
    act, weights, product = _trunk(rows, c, dtype)
    return (3 if tap else 2) * act + 2 * rows * c + weights, 4 * product


def k5(rows: int, c: int, taps: int, dtype: str) -> tuple[float, float]:
    """K5 (with its reduce), the gram of ``taps`` taps: the taps in, the
    float32 gram out; one product per pair of the symmetric gram."""
    act = rows * c * ITEMSIZE[dtype]
    pairs = taps * (taps + 1) // 2
    return taps * act + taps * taps * c * 4, 2.0 * pairs * rows * c


def k6(rows: int, c: int, taps: int, dtype: str) -> tuple[float, float]:
    """K6, the gram's backward: the taps in, their cotangents out, h in."""
    act = rows * c * ITEMSIZE[dtype]
    return 2 * taps * act + taps * taps * c * 4, 2.0 * taps * taps * rows * c


def trunk_eval_bound_s(rows: int, cfg: dict, k1_launches: int, k2_launches: int) -> float:
    """The summed bounds of K1 and K2 launches of transfer evaluations at
    ``rows``: in each backward, the layers that emit a style tap (not the
    last, whose cotangent seeds the chain) read a tap cotangent."""
    dt, c, n = cfg["compute_dtype"], cfg["ae_width"], cfg["ae_num_layers"]
    style = set(style_taps(cfg)) | set(cfg["cont_lyr_ids"])
    tapped = len(style - {n - 1}) / n
    k2_mean = tapped * bound_s(*k2(rows, c, dt, True), dt) + \
        (1 - tapped) * bound_s(*k2(rows, c, dt, False), dt)
    return k1_launches * bound_s(*k1(rows, c, dt), dt) + k2_launches * k2_mean


def gram_eval_bound_s(rows: int, cfg: dict, k5_launches: int, k6_launches: int) -> float:
    """The summed bounds of K5 and K6 launches over the configuration's style
    taps (channel-wise grams; a Gatys configuration launches neither)."""
    dt, c, taps = cfg["compute_dtype"], cfg["ae_width"], len(style_taps(cfg))
    return (k5_launches * bound_s(*k5(rows, c, taps, dt), dt)
            + k6_launches * bound_s(*k6(rows, c, taps, dt), dt))


# --------------------------------------------------------------------------
# Model operations.
# --------------------------------------------------------------------------

def trunk_fwd_ops_per_row(cfg: dict) -> float:
    """One pass of the encoder trunk: per layer the dilated conv and the
    residual conv."""
    c = cfg["ae_width"]
    return 2.0 * (cfg["ae_filter_length"] * c + c) * c * cfg["ae_num_layers"]


def transfer_eval_ops(rows: int, cfg: dict) -> float:
    """Model operations of one loss + waveform-gradient evaluation: the
    trunk forward and its cotangent at the input (no weight gradient), and
    the gram of the style taps with its backward: channel-wise, one product
    per pair of the symmetric gram and all pairs back; Gatys, each tap's
    [C, rows] x [rows, C] product forward and one as large back. The start
    conv's 3 multiply-adds a row and the bottleneck, which the loss does
    not read, are left out."""
    taps, c = len(style_taps(cfg)), cfg["ae_width"]
    if cfg.get("gatys"):
        gram = 2 * (2.0 * taps * rows * c * c)
    else:
        gram = 2.0 * (taps * (taps + 1) // 2) * rows * c + 2.0 * taps * taps * rows * c
    return 2 * trunk_fwd_ops_per_row(cfg) * rows + gram


def _decoder_fwd_ops_per_row(cfg: dict) -> tuple[float, float]:
    """(one decoder block, the whole decoder) forward operations per row,
    the conditioning (at the hop rate) left out."""
    w, s, q, f = cfg["width"], cfg["skip_width"], cfg["quant_channels"], cfg["filter_length"]
    block = (f * w * 2 * w + w * w + w * s) * 2 * cfg["num_layers"]
    return block, block + (f * w + w * s + s * s + s * q) * 2


def _encoder_rest_ops_per_row(cfg: dict) -> float:
    return (cfg["ae_filter_length"] * cfg["ae_width"]
            + cfg["ae_width"] * cfg["ae_bottleneck_width"]) * 2


def train_model_ops(rows: int, cfg: dict) -> float:
    """Model operations of one training step: forward and backward (2x
    forward) of the decoder and the encoder, no recompute."""
    _, dec = _decoder_fwd_ops_per_row(cfg)
    return float(3 * dec + 3 * trunk_fwd_ops_per_row(cfg) + 3 * _encoder_rest_ops_per_row(cfg)) \
        * rows


def train_flops(rows: int, cfg: dict) -> float:
    """The operations one training step does (a copy of chip_smoke.py's
    train_flops): the decoder's forward, its remat re-forward of the blocks
    and its backward; the trunk's forward (K1), cotangent (K2), weight
    recompute forward and its backward."""
    block, dec = _decoder_fwd_ops_per_row(cfg)
    trunk = trunk_fwd_ops_per_row(cfg)
    return float(3 * dec + block + 5 * trunk + 3 * _encoder_rest_ops_per_row(cfg)) * rows


def decoder_products(rows: int, cfg: dict) -> list[tuple[int, int, int, int]]:
    """(M, K, N, count) of every matrix product the decoder (and the
    encoder's bottleneck) run in one bfloat16 training step with remat: each
    conv's forward (a block's twice: the remat re-forward), the gradient of
    its input where one flows, and of its weight. A conv of filter F is one
    product of its F shifted inputs side by side."""
    w, s, q, f = cfg["width"], cfg["skip_width"], cfg["quant_channels"], cfg["filter_length"]
    bw, frames = cfg["ae_bottleneck_width"], rows // cfg["ae_hop_length"]
    out = []

    def conv(m, fk, cin, cout, fwd=1, dx=True):
        out.append((m, fk * cin, cout, fwd))
        if dx:
            out.append((m, fk * cout, cin, 1))
        out.append((fk * cin, m, cout, 1))

    n = cfg["num_layers"]
    conv(rows, 1, w, s)                        # skip_start
    for i in range(1, n + 1):
        conv(rows, f, w, 2 * w, fwd=2)         # dilatedconv_i
        conv(frames, 1, bw, 2 * w, fwd=2)      # cond_map_i
        if i < n:                              # the last block's residual reaches no loss
            conv(rows, 1, w, w, fwd=2)
        else:
            out.append((rows, w, w, 2))
        conv(rows, 1, w, s, fwd=2)             # skip_i
    conv(rows, 1, s, s)                        # out1
    conv(frames, 1, bw, s)                     # cond_map_out1
    conv(rows, 1, s, q)                        # logits
    conv(rows, 1, cfg["ae_width"], bw)         # ae_bottleneck
    return out


def products_bound_s(products, dtype: str) -> float:
    """The summed bounds of bfloat16 products (M, K, N, count): A [M, K] and
    B [K, N] read, C [M, N] written."""
    item = ITEMSIZE[dtype]
    return sum(n_ * bound_s(item * (m * k + k * n + m * n), 2.0 * m * k * n, dtype)
               for m, k, n, n_ in products)
