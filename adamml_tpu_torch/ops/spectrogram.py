"""Device-side log-power spectrogram (``adamml_tpu/ops/spectrogram.py``).

24 kHz mono, 1.28 s window, n_fft=511 (256 bins), periodic Hann of 10 ms
centred into n_fft, 5 ms hop, zero (not reflect) padding of n_fft//2 on
both sides, log(|S|^2 + 1e-6): a 256x256 (freq, time) image per segment.
The signal is framed with ``unfold`` and transformed with ``torch.fft.rfft``
(``torch.stft`` pads and windows differently). ``log_power_spectrogram_np``
is the float64 numpy twin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    resampling_rate: int = 24000
    audio_length: float = 1.28
    n_fft: int = 511
    window_ms: float = 10.0
    hop_ms: float = 5.0
    eps: float = 1e-6

    @property
    def num_samples(self) -> int:
        return int(round(self.resampling_rate * self.audio_length))

    @property
    def win_length(self) -> int:
        return int(round(self.window_ms * self.resampling_rate / 1e3))

    @property
    def hop_length(self) -> int:
        return int(round(self.hop_ms * self.resampling_rate / 1e3))

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def num_frames(self) -> int:
        padded = self.num_samples + 2 * (self.n_fft // 2)
        return 1 + (padded - self.n_fft) // self.hop_length


def _padded_window(cfg: SpectrogramConfig) -> np.ndarray:
    """Periodic Hann(win_length) (scipy's get_window('hann', fftbins=True),
    as librosa uses it) centred into an n_fft-long buffer, float32."""
    n = np.arange(cfg.win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.win_length)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    rpad = cfg.n_fft - cfg.win_length - lpad
    return np.pad(w, (lpad, rpad)).astype(np.float32)


def log_power_spectrogram(samples: torch.Tensor,
                          cfg: SpectrogramConfig) -> torch.Tensor:
    """samples: (..., num_samples) float -> (..., num_freqs, num_frames)
    float32, on the samples' device."""
    window = torch.from_numpy(_padded_window(cfg)).to(samples.device)
    half = cfg.n_fft // 2
    x = F.pad(samples.float(), (half, half))
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length) * window
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(power + cfg.eps).transpose(-1, -2)


def log_power_spectrogram_np(samples: np.ndarray,
                             cfg: SpectrogramConfig = SpectrogramConfig()
                             ) -> np.ndarray:
    """float64 numpy twin of ``log_power_spectrogram`` for one waveform."""
    window = _padded_window(cfg).astype(np.float64)
    half = cfg.n_fft // 2
    x = np.pad(samples.astype(np.float64), (half, half))
    starts = np.arange(cfg.num_frames) * cfg.hop_length
    idx = starts[:, None] + np.arange(cfg.n_fft)[None, :]
    frames = x[idx] * window
    spec = np.fft.rfft(frames, n=cfg.n_fft, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return np.log(power + cfg.eps).T.astype(np.float32)
