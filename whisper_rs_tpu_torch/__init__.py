"""PyTorch/CUDA port of whisper-tpu: mel frontend, encoder, window decode
(greedy, sampled with JAX's threefry noise, and beam search), the text
layer, long-audio transcription with the temperature fallback ladder and
word timestamps, audio file input, the batch driver (``parallel``), the
serving engine (``serve``: continuous batching), the int8×int8 matmuls
(``WHISPER_INT8_MATMUL=1``), the command line (``cli``) and the evaluation
tools (``tools``), with hand-written Hopper kernels (``csrc/``) on the hot
path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no ``device`` they raise (``device.resolve_device``).
``DecodeTask``, ``TranscribeTask`` and ``ServingEngine`` run on the model's
device.
"""

from .decode.language import detect_language
from .decode.task import DecodeOutput, DecodeTask
from .ops.mel import log_mel_file
from .serve import RequestHandle, ServingEngine
from .tokenize import Task, Tokenizer
from .transcribe import TranscribeOutput, TranscribeTask

__all__ = [
    "DecodeOutput",
    "DecodeTask",
    "RequestHandle",
    "ServingEngine",
    "Task",
    "Tokenizer",
    "TranscribeOutput",
    "TranscribeTask",
    "detect_language",
    "log_mel_file",
]
