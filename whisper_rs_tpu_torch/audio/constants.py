"""Audio frontend constants (counterpart of ``whisper_rs_tpu/audio/constants.py``).

``N_MELS`` is the default (80); large-v3 uses 128.
"""

SAMPLE_RATE = 16_000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples per 30s chunk
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3_000 mel frames per chunk
N_FREQS = N_FFT // 2 + 1  # 201 one-sided rFFT bins
