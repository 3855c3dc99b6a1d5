"""Multi-process start-up on ``torch.distributed`` (counterpart of
``whisper_rs_tpu/parallel/distributed.py``): one process per rank.

``initialize_multihost`` starts the default process group from its
arguments, or from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with one process it does
nothing.  The backend is NCCL for ranks on the card and gloo for the CPU,
unless the caller names one; it is never switched behind the caller's
back.  NCCL refuses two ranks on one device, so where the ranks on this
host outnumber its cards NCCL is refused with a message that names gloo,
which runs such ranks by staging their tensors through host memory
(``parallel/collectives.py``).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600  # the longest a collective waits for its peers


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    *,
    device=None,
) -> bool:
    """Start the default process group; returns whether one is running.

    ``coordinator_address`` is ``host:port`` (a TCP store on that host), or
    a URL ``init_method`` (``tcp://...``, ``file://...``); by default
    ``MASTER_ADDR:MASTER_PORT``.  ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``.  With one process (or none
    named) nothing starts.  ``backend`` defaults to ``default_backend
    (device)`` (``device`` default: ``cuda`` where present); NCCL with more
    ranks on this host (torchrun's ``LOCAL_WORLD_SIZE``, else all) than it
    has cards raises ``ValueError``.  A group already running is left as it
    is.  A collective waits TIMEOUT_S seconds at most."""
    if dist.is_initialized():
        return True
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if not num_processes or num_processes == 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and a process id")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl":
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        n_cards = torch.cuda.device_count()
        if n_local > n_cards:
            raise ValueError(
                f"NCCL takes one card a rank: {n_local} ranks on this host, {n_cards} cards; "
                'pass backend="gloo" (host-staged collectives) to share a card')
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=TIMEOUT_S))
    return True


def rank_device(device) -> torch.device:
    """This rank's device: for ``cuda``, card ``LOCAL_RANK`` modulo the cards
    of this host (ranks under gloo may share a card), made current; any
    other device as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device
