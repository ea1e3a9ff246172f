"""The port's spans (``utils/profiling.py::span``) on the CPU, and on the card.

Outside a ``torch.profiler`` capture a span never reaches
``record_function``. Inside one, L-BFGS opens one ``lbfgs.minimize`` per
call, one ``lbfgs.eval`` per evaluation and one ``lbfgs.host_read`` per read
of a device value, the transfer entry points one ``transfer.targets`` per clip
before its epochs, and training keeps its two named ranges. The card test
holds the host reads to be L-BFGS's only syncs with the device, and their
spans to the kernels' clock.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
from audio_style_transfer_tpu_torch.train.trainer import TrainConfig, Trainer
from audio_style_transfer_tpu_torch.transfer import lbfgs
from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
from audio_style_transfer_tpu_torch.transfer.longform import transfer_exact, transfer_longform
from audio_style_transfer_tpu_torch.utils import profiling
from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

GEOM = dict(ae_num_layers=6, ae_width=16)
W = 4096
SPEC = dict(stack=None, style_lyr_ids=(0, 1, 2, 3), cont_lyr_ids=(5,), batch_size=W, epochs=1,
            maxiter=2, early_stop_evals=0, write_artifacts=False)


def _captured(fn, tmp_path, activities=(ProfilerActivity.CPU,)):
    """(fn's result, the capture's Chrome-trace events)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    path = tmp_path / f"trace-{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def _spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _overlap(a, b):
    return a[0] < b[1] and b[0] < a[1]


def test_span_outside_a_capture_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no capture running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.span("lbfgs.eval"):
        pass
    # One shared object for every span: nothing is allocated.
    assert profiling.span("a") is profiling.span("b")


def _quartic(has_aux):
    """A convex objective of 64 unknowns, so every L-BFGS direction descends
    (no steepest-descent read)."""
    a = torch.linspace(0.5, 4.0, 64)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        f = torch.sum(a * (x - 1.0) ** 2) + 0.3 * torch.sum(x ** 4)
        (g,) = torch.autograd.grad(f, x)
        f = f.detach()
        return ((f, {"f": f}), g) if has_aux else (f, g)

    return value_and_grad


@pytest.mark.parametrize("has_aux", [False, True])
@pytest.mark.parametrize("line_search", ["zoom", "mt"])
def test_lbfgs_spans_count_its_evaluations_and_host_reads(tmp_path, line_search, has_aux):
    opts = lbfgs.LBFGSOptions(maxiter=12, line_search=line_search)
    fun, x0 = _quartic(has_aux), torch.zeros(64)
    res, events = _captured(lambda: lbfgs.lbfgs_minimize(fun, x0, opts, has_aux=has_aux),
                            tmp_path)
    (outer,) = _spans(events, "lbfgs.minimize")
    evals, reads = _spans(events, "lbfgs.eval"), _spans(events, "lbfgs.host_read")
    assert res.n_iters >= 2 and res.n_evals > res.n_iters
    assert len(evals) == res.n_evals
    # f after every evaluation and the slope after each line-search trial;
    # per iteration the first slope, s.y, y.y and the gtol check; the first
    # step's norm once.
    assert len(reads) == 2 * res.n_evals + 4 * res.n_iters
    assert all(_within(s, outer) for s in evals + reads)
    assert not any(_overlap(r, e) for r in reads for e in evals)
    # The spans change nothing: the same iterate as outside a capture.
    again = lbfgs.lbfgs_minimize(fun, x0, opts, has_aux=has_aux)
    assert torch.equal(res.x, again.x) and (res.n_evals, res.status) == (again.n_evals,
                                                                        again.status)


def _clip(length, seed, freq):
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(np.arange(length) * freq) + 0.05 * rng.randn(length)).astype(np.float32)


def _engine(**over):
    cfg = WaveNetAEConfig(**GEOM)
    return StyleTransfer(TransferSpec(device="cpu", **{**SPEC, **over}), init_params(0, cfg), cfg)


def _run_cli_engine(tmp_path):
    tmp_path.mkdir()
    for name, (seed, freq) in {"c": (0, 0.05), "s": (1, 0.11), "t": (2, 0.2)}.items():
        write_wav(str(tmp_path / f"{name}.wav"), _clip(3 * W, seed, freq), 16000)
    return _engine().run(str(tmp_path / "c.wav"), str(tmp_path / "s.wav"),
                         str(tmp_path / "t.wav"), start=0.0)


@pytest.mark.parametrize("entry", ["transfer_exact", "transfer_longform", "StyleTransfer.run"])
def test_a_clip_opens_one_targets_span_before_its_first_epoch(tmp_path, entry):
    content, style = _clip(W + 300, 0, 0.05), _clip(2 * W, 1, 0.11)
    run = {
        "transfer_exact": lambda: transfer_exact(_engine(), content, style, epochs=1),
        "transfer_longform": lambda: transfer_longform(_engine(), content, style, epochs=1),
        "StyleTransfer.run": lambda: _run_cli_engine(tmp_path / "wavs"),
    }[entry]
    _, events = _captured(run, tmp_path)
    (targets,) = _spans(events, "transfer.targets")
    epochs = _spans(events, "lbfgs.minimize")
    assert len(epochs) == 1 and targets[1] <= epochs[0][0]


def test_training_keeps_its_two_named_ranges(tmp_path):
    tiny = dict(num_layers=2, num_stages=2, width=8, skip_width=8, ae_num_layers=2,
                ae_num_stages=2, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
    tr = Trainer(TrainConfig(total_batch_size=2, sample_length=256, save_every_steps=0),
                 WaveNetAEConfig(**tiny), device="cpu")
    state = tr.init_state()
    wav = np.random.RandomState(0).uniform(-0.5, 0.5, (2, 256)).astype(np.float32)
    _, events = _captured(lambda: tr.step(state, wav), tmp_path)
    assert len(_spans(events, "adam and ema")) == 1
    assert len(_spans(events, "trunk weight recompute")) >= 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_reads_are_lbfgs_only_syncs_on_the_kernels_clock(cuda, tmp_path, monkeypatch):
    """One epoch of the exact path (bf16, full width, 8192 rows) under
    ``set_sync_debug_mode("error")``, lifted only inside ``lbfgs.host_read``:
    a sync anywhere else in L-BFGS or its evaluations raises. Then, in a
    capture, each host read ends no earlier than the last kernel launched
    before it (the read waits for the queue), within 50 us."""
    cfg = WaveNetAEConfig()
    engine = StyleTransfer(TransferSpec(device="cuda", stack=0, batch_size=W, epochs=1,
                                        maxiter=4, early_stop_evals=0,
                                        compute_dtype="bfloat16", write_artifacts=False),
                           init_params(0, cfg), cfg)
    content, style = _clip(2 * W, 0, 0.05), _clip(3 * W, 1, 0.11)
    transfer_exact(engine, content, style, epochs=1)  # builds and warms the kernels
    torch.cuda.synchronize()

    minimize, plain_span = lbfgs.lbfgs_minimize, lbfgs.span

    def strict_minimize(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return minimize(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    @contextlib.contextmanager
    def lifting_span(name):
        with plain_span(name):
            if name != "lbfgs.host_read":
                yield
                return
            torch.cuda.set_sync_debug_mode(0)
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("error")

    with monkeypatch.context() as m:
        m.setattr(lbfgs, "lbfgs_minimize", strict_minimize)
        m.setattr(lbfgs, "span", lifting_span)
        res = transfer_exact(engine, content, style, epochs=1)
    assert int(res.per_window["evals"][0]) >= 2 and np.isfinite(res.per_window["metrics"]).all()

    res, events = _captured(lambda: transfer_exact(engine, content, style, epochs=1), tmp_path,
                            (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in
              e.get("args", {})}
    kernels = sorted((launch[e["args"]["correlation"]], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and e.get("args", {}).get("correlation")
                     in launch)
    reads = _spans(events, "lbfgs.host_read")
    assert len(_spans(events, "lbfgs.eval")) == int(res.per_window["evals"][0])
    assert kernels and reads
    for r0, r1 in reads:
        before = [end for at, end in kernels if at < r0]
        if before:
            assert r1 >= before[-1] - 50.0, (r0, r1, before[-1])
