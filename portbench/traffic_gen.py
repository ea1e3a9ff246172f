"""The one traffic generator: audio of fixed sizes drawn from the seed.

A mix (``traffic/<mix>.json``) gives the sizes and the number of distinct
items; the seed only moves pitches, rates and phases, so every seed does the
same amount of work. The shapes follow chip_smoke.py's ``synth_audio``
(content: an arpeggio of two partials; style: a drone of eight harmonics)
and ``train_batch`` (a few tones with noise, clipped below 1.0, whose label
256 the NLL cannot take).
"""

from __future__ import annotations

import numpy as np

SR = 16000


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


def arpeggio(rng: np.random.Generator, samples: int) -> np.ndarray:
    """Eight notes a cycle, a quarter of a second each, from a base pitch."""
    t = np.arange(samples) / SR
    base = rng.uniform(180.0, 280.0)
    rate = rng.uniform(3.0, 5.0)
    f = base * 2 ** (np.floor(t * rate) % 8 / 4.0)
    phase = rng.uniform(0.0, 2 * np.pi)
    x = 0.4 * np.sin(2 * np.pi * f * t + phase) + 0.2 * np.sin(2 * np.pi * 2 * f * t)
    return x.astype(np.float32)


def drone(rng: np.random.Generator, samples: int) -> np.ndarray:
    """Eight harmonics of a low pitch, each with its own phase."""
    t = np.arange(samples) / SR
    base = rng.uniform(90.0, 140.0)
    phases = rng.uniform(0.0, 2 * np.pi, 8)
    x = sum(0.25 / (k + 1) * np.sin(2 * np.pi * base * (k + 1) * t + phases[k])
            for k in range(8))
    return x.astype(np.float32)


def clip_pairs(seed: int, mix: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """``mix["distinct"]`` (content, style) pairs of the mix's lengths."""
    return [(arpeggio(rng_for(seed, i, 0), mix["content_samples"]),
             drone(rng_for(seed, i, 1), mix["style_samples"]))
            for i in range(mix["distinct"])]


def tone_batches(seed: int, mix: dict) -> np.ndarray:
    """[distinct, batch, samples] of rows of three tones with noise, each row
    decaying exponentially at a rate drawn in ``mix["decay_per_s"]`` (a
    struck note's envelope) and scaled by a gain drawn log-uniform in
    ``mix["row_gain"]`` (notes played at different velocities)."""
    n, b, t = mix["distinct"], mix["batch"], mix["samples"]
    rng = rng_for(seed, 0)
    time_s = np.arange(t) / SR
    f = 110.0 * 2 ** rng.uniform(0, 4, (n, b, 3, 1))
    amp = rng.uniform(0.1, 0.3, (n, b, 3, 1))
    ph = rng.uniform(0, 6, (n, b, 3, 1))
    x = (amp * np.sin(2 * np.pi * f * time_s + ph)).sum(axis=2)
    x += 0.02 * rng.standard_normal((n, b, t))
    x *= np.exp(-rng.uniform(*mix["decay_per_s"], (n, b, 1)) * time_s)
    x *= np.exp(rng.uniform(*np.log(mix["row_gain"]), (n, b, 1)))
    return np.clip(x, -0.99, 0.99).astype(np.float32)
