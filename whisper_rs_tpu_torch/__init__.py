"""PyTorch/CUDA port of whisper-tpu: mel frontend, encoder and window decode
(greedy and beam search), with hand-written Hopper kernels (``csrc/``) on
the hot path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no ``device`` they raise (``device.resolve_device``).
"""
