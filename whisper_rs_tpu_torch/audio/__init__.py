"""Audio frontend: constants, the plain log-mel spectrogram, and file input
(``io.load_audio``: WAV, FLAC through ``flac``, MP3 through ``mp3``)."""

from .constants import HOP_LENGTH, N_FFT, N_FRAMES, N_MELS, N_SAMPLES, SAMPLE_RATE
from .mel import hann_window, log_mel_spectrogram, mel_filterbank, pad_or_trim

__all__ = [
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES",
    "N_MELS",
    "N_SAMPLES",
    "SAMPLE_RATE",
    "hann_window",
    "log_mel_spectrogram",
    "mel_filterbank",
    "pad_or_trim",
]
