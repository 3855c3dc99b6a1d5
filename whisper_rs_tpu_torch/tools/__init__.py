"""Evaluation tools of the port (``python -m whisper_rs_tpu_torch.tools.<name>``):
``eval_wer`` (LibriSpeech WER through the batch driver) and
``validate_checkpoint`` (WER, the int8 ΔWER gates, word timings and
language ID in one JSON verdict)."""
