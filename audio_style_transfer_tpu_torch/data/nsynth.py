"""NSynth dataset pipeline (reference nsynth/reader.py:36-113; counterpart of
audio_style_transfer_tpu/data/nsynth.py, the same batches for the same seed).

Feature schema (reader.py:61-69): note_str (bytes), pitch[1], velocity[1],
audio[64000] float, qualities[10], instrument_source[1],
instrument_family[1].

The TF1 version used queue-runner threads + shuffle_batch; here the host
pipeline is a plain Python generator with a shuffle buffer (capacity
mirrors reader.py:96-98) feeding numpy batches, through the C++ reader of
csrc/ (data/native.py) where it builds, else the pure-Python reader.
Random cropping to the train length (6144, reference model.py:32) happens
on the host; everything after that is device work, the baseline AE's
specgram features included.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from audio_style_transfer_tpu_torch.data import native
from audio_style_transfer_tpu_torch.data.tfrecord import parse_example, read_tfrecord

FEATURES = (
    "note_str",
    "pitch",
    "velocity",
    "audio",
    "qualities",
    "instrument_source",
    "instrument_family",
)

AUDIO_LEN = 64000


class NSynthDataset:
    """TFRecord-backed NSynth dataset."""

    def __init__(
        self,
        tfrecord_path: str,
        is_training: bool = True,
        seed: int = 0,
        use_native: bool = True,
        reader_threads: int = 4,
    ):
        self.record_path = tfrecord_path
        self.is_training = is_training
        self.seed = seed
        self.use_native = use_native
        self.reader_threads = reader_threads
        # Which reader the last record stream used: "native" or "python".
        self.reader_used: str | None = None

    def _raw_records(self, repeat: bool) -> Iterator[bytes]:
        reader = None
        if self.use_native:
            try:
                if native.native_available():
                    reader = native.NativeTFRecordReader(
                        self.record_path,
                        num_threads=self.reader_threads,
                        repeat=repeat,
                    )
            except (OSError, RuntimeError):  # library/startup failure -> Python reader
                reader = None
        if reader is not None:
            self.reader_used = "native"
            # Deliberately NOT wrapped in the fallback try: a mid-stream
            # reader error must propagate; falling back would silently
            # restart from record 0 and duplicate already-yielded examples
            # (poisoning a non-repeat eval epoch).
            try:
                yield from reader
            finally:
                reader.close()
            return
        self.reader_used = "python"
        while True:
            yield from read_tfrecord(self.record_path)
            if not repeat:
                return

    def examples(self, repeat: bool | None = None) -> Iterator[dict]:
        """Yield parsed examples; repeats forever when training."""
        repeat = self.is_training if repeat is None else repeat
        for raw in self._raw_records(repeat):
            yield parse_example(raw)

    def get_wavenet_batch(
        self,
        batch_size: int,
        length: int = 64000,
        shuffle_buffer: int | None = None,
    ) -> Iterator[dict]:
        """Batches of {'wav': [B, length], 'pitch': [B], 'key': [B]}.

        Training: random crop + shuffle buffer (reader.py:89-98).
        Eval: fixed center crop (reader.py:100-109).
        """
        rng = np.random.RandomState(self.seed)
        if shuffle_buffer is None:
            shuffle_buffer = 200 * batch_size if self.is_training else 0

        def cropped():
            for ex in self.examples():
                wav = np.asarray(ex["audio"], np.float32)[:AUDIO_LEN]
                # Examples shorter than the crop are zero-padded; eval
                # centers on the ACTUAL length, not the 64000 nominal
                # (a shorter-than-nominal wav previously crashed the
                # random crop and ragged-stacked the eval batch).
                if len(wav) < length:
                    wav = np.pad(wav, (0, length - len(wav)))
                if self.is_training:
                    off = rng.randint(0, len(wav) - length + 1)
                else:
                    off = (len(wav) - length) // 2
                yield {
                    "wav": wav[off : off + length],
                    "pitch": np.int32(ex["pitch"][0]),
                    "key": bytes(ex["note_str"][0]) if ex.get("note_str") else b"",
                }

        stream = cropped()
        if shuffle_buffer:
            stream = _shuffled(stream, shuffle_buffer, rng)

        while True:
            batch = list(itertools.islice(stream, batch_size))
            if len(batch) < batch_size:
                return
            yield {
                "wav": np.stack([b["wav"] for b in batch]),
                "pitch": np.stack([b["pitch"] for b in batch]),
                "key": [b["key"] for b in batch],
            }

    def get_baseline_batch(self, hparams, device: torch.device | str = "cuda") -> Iterator[dict]:
        """Spectrogram batches for the baseline AE (reader.py:115-197):
        {'audio': [B, 64000], 'pitch': [B], 'spectrogram': [B, F, N, C],
        'key': [B]} as numpy, as JAX yields them.

        The specgram features (signal/specgram.py) are computed on ``device``
        for the whole batch at once, each clip normalised by its own maxima
        (JAX calls its jitted specgram clip by clip), then brought back to
        the host. With ``hparams.pad`` the time axis is zero-padded to a power
        of two and the Nyquist row dropped (reader.py:153-160): [B, 512, 256,
        1] at the nfft_1024 geometry.
        """
        from audio_style_transfer_tpu_torch.signal.specgram import specgram

        device = torch.device(device)
        for batch in self.get_wavenet_batch(hparams.batch_size, length=AUDIO_LEN):
            audio = batch["wav"]
            spec = specgram(
                torch.from_numpy(audio).to(device),
                n_fft=hparams.n_fft,
                hop_length=hparams.hop_length,
                mask=hparams.mask,
                log_mag=hparams.log_mag,
                re_im=hparams.re_im,
                dphase=hparams.dphase,
                mag_only=hparams.mag_only,
            )
            if getattr(hparams, "pad", True):
                t = spec.shape[2]
                num_padding = 2 ** int(np.ceil(np.log2(t))) - t
                spec = F.pad(spec, (0, 0, 0, num_padding))[:, : spec.shape[1] - 1]
            yield {
                "audio": audio,
                "pitch": batch["pitch"],
                "spectrogram": spec.cpu().numpy(),
                "key": batch["key"],
            }


def _shuffled(stream, capacity: int, rng: np.random.RandomState):
    buf = list(itertools.islice(stream, capacity))
    for item in stream:
        j = rng.randint(0, len(buf))
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf
