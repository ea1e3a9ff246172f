"""bfloat16 + zoom line search from the 1e-6 start: the JAX engine beside the
port, on the CPU, at full width.

The port's bfloat16 full-stack run (style taps 0..29, content tap 25, three
epochs from the engine's default start) ends either near loss 7 or near
1517 depending on the last bits of the gram, while float32 ends near 6.85
every time. This file measures whether the JAX engine, the reference, does
the same. Both engines run on the same weights (JAX ``init_params`` carried
across as numpy, as ckpt/convert.py's ``.npz`` holds them) and the same
synthetic clips, each building its targets as its CLI does:

  1. the JAX engine, ``compute_dtype="bfloat16"``, XLA path, CPU;
  2. the port, CPU, bfloat16, plain versions of the kernels;
  3. the port again with every gram entry scaled by 1 + 1e-6 of seeded
     noise, three draws;
  4. both engines once in float32, for the ratio;
  5. the JAX engine in bfloat16 again with every entry of its style target
     scaled by 1 + 1e-6 of seeded noise, two picks (last: each costs the JAX
     bfloat16 run's half hour).

It prints loss, content, style and evals per epoch of every run. As a script:

    python tests/test_torch_bf16_start.py [--t 16384] [--threads 8] [--only "JAX bfloat16"]
        [--weights jax|port]

(30 layers of 128 channels either way; ``--t`` is the window, a multiple of
4096; ``--only`` keeps the runs whose label contains the text; ``--weights
port`` carries the port's ``init_params(0)`` draw, the weights of
chip_smoke.py's runs, into JAX instead of the other way round. On the CPU the
JAX bfloat16 program takes minutes to compile and about 11 s per evaluation
at T=4096.) As a test it is marked ``slow`` and runs the port's rows of the
T=4096 table, asserting only that every run ends finite: the table is the
result, not a pass mark.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg  # noqa: E402
from audio_style_transfer_tpu.models.wavenet_ae import init_params  # noqa: E402
from audio_style_transfer_tpu.transfer import engine as jengine  # noqa: E402
from audio_style_transfer_tpu.transfer.grams import l2_normalize as jl2  # noqa: E402
from audio_style_transfer_tpu_torch.ckpt.convert import params_from_numpy  # noqa: E402
from audio_style_transfer_tpu_torch.models.wavenet_ae import (  # noqa: E402
    init_params as torch_init_params,
)
from audio_style_transfer_tpu_torch.ops import gram as tgram  # noqa: E402
from audio_style_transfer_tpu_torch.transfer import engine as tengine  # noqa: E402

SR = 16000
EPOCHS = 3


def synth_audio(seconds: float, kind: str) -> np.ndarray:
    """The synthetic clips of bench.py / chip_smoke.py."""
    t = np.arange(int(seconds * SR)) / SR
    if kind == "content":
        f = 220.0 * 2 ** (np.floor(t * 4) % 8 / 4.0)
        x = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 2 * f * t)
    else:
        x = sum(0.25 / (k + 1) * np.sin(2 * np.pi * 110 * (k + 1) * t + 0.1 * k)
                for k in range(8))
    return x.astype(np.float32)


def targets(engine, content, style):
    """(phi_c, phi) as ``engine.run`` builds them (--start 1.0)."""
    spec = engine.spec
    st = max(int(1.0 * SR - spec.late), 0)
    aud = content[st:st + spec.batch_size]
    phi_c = engine.get_embeds(aud)
    phi = engine.get_embeds(aud, is_content=False)
    phi = phi + engine.get_style_phi(style) - engine.get_style_phi(content)
    return phi_c, np.asarray(jl2(jnp.asarray(phi), axes=(1, 2)))


def run(label: str, engine, content, style, target_noise_seed=None) -> dict:
    t0 = time.time()
    phi_c, phi = targets(engine, content, style)
    if target_noise_seed is not None:
        noise = np.random.RandomState(target_noise_seed).randn(*phi.shape)
        phi = (phi * (1 + 1e-6 * noise)).astype(np.float32)
    res = engine.optimize(phi_c, phi, epochs=EPOCHS)
    done = int(res["epochs_done"])
    metrics = np.asarray(res["metrics"])[:done]
    evals = np.asarray(res["evals"])[:done]
    rows = "; ".join(f"evals {int(e)} loss {m[0]:.4f} content {m[1]:.4f} style {m[2]:.6f}"
                     for e, m in zip(evals, metrics))
    print(f"[{label}] {rows} ({time.time() - t0:.0f} s)", flush=True)
    return {"label": label, "final": float(metrics[-1, 0]), "evals": int(evals.sum()),
            "epochs_done": done}


def measure(t: int = 4096, threads: int = 4, only: str = "", weights: str = "jax") -> list:
    torch.set_num_threads(threads)
    kw = dict(stack=None, cont_lyr_ids=(25,), batch_size=t, epochs=EPOCHS,
              write_artifacts=False)
    if weights == "jax":
        pnp = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), JCfg()))
    else:
        pnp = {layer: {k: v.numpy() for k, v in entry.items()}
               for layer, entry in torch_init_params(0).items()}
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = params_from_numpy(pnp)
    content, style = synth_audio(3.0, "content"), synth_audio(3.0, "style")
    print(f"CPU (no card), {weights} init_params weights, 30 layers of 128, T={t}, style taps "
          f"0..29, content tap 25, "
          f"{EPOCHS} epochs of maxiter 100 from the 1e-6 start, zoom", flush=True)

    def jax_engine(dtype):
        return jengine.StyleTransfer(
            jengine.TransferSpec(compute_dtype=dtype, fused_encoder=False, **kw), jp, JCfg())

    def port_engine(dtype):
        return tengine.StyleTransfer(
            tengine.TransferSpec(compute_dtype=dtype, device="cpu", **kw), tp)

    plain = tgram.pair_gram_fwd
    gen = torch.Generator().manual_seed(0)

    def noisy(*taps):
        g = plain(*taps)
        return g * (1 + 1e-6 * torch.randn(g.shape, generator=gen))

    runs = [("JAX bfloat16", lambda: jax_engine("bfloat16"), plain),
            ("port bfloat16", lambda: port_engine("bfloat16"), plain)]
    runs += [(f"port bfloat16, gram x (1 + 1e-6 noise), draw {i}",
              lambda: port_engine("bfloat16"), noisy) for i in range(3)]
    runs += [("JAX float32", lambda: jax_engine("float32"), plain),
             ("port float32", lambda: port_engine("float32"), plain)]
    runs += [(f"JAX bfloat16, style target x (1 + 1e-6 noise), pick {i}",
              lambda: jax_engine("bfloat16"), plain) for i in range(2)]
    out = []
    for label, make_engine, gram_fwd in runs:
        if only not in label:
            continue
        tgram.pair_gram_fwd = gram_fwd
        seed = int(label[-1]) if "pick" in label else None
        try:
            out.append(run(label, make_engine(), content, style, target_noise_seed=seed))
        finally:
            tgram.pair_gram_fwd = plain
    f32 = {r["label"].split()[0]: r["final"] for r in out if "float32" in r["label"]}
    for r in out:
        if "bfloat16" in r["label"] and r["label"].split()[0] in f32:
            print(f"[{r['label']}] final loss / its float32 final loss = "
                  f"{r['final'] / f32[r['label'].split()[0]]:.4f}", flush=True)
    return out


@pytest.mark.slow
def test_bf16_start_table_is_finite():
    for r in measure(t=4096, threads=2, only="port"):
        assert np.isfinite(r["final"]) and r["epochs_done"] >= 1, r


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--t", type=int, default=16384)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--only", default="")
    ap.add_argument("--weights", choices=["jax", "port"], default="jax")
    args = ap.parse_args()
    measure(args.t, args.threads, args.only, args.weights)
