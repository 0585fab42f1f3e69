"""Switchboard packets (paper §III-A), as in ``repro.core.packet``.

An SB packet is 64 bytes: 4B flags, 4B destination, 52B data payload, 4B
reserved.  Inside the engines a packet is a flat vector of
``payload_words`` 32-bit words; this module provides the paper-layout view
(16 uint32 words: [flags, dest, data0..data12, reserved]) plus pack/unpack
helpers so host-side code speaks the paper's ``PySbPacket`` format.
"""
from __future__ import annotations

import numpy as np
import torch

# Paper layout: 64B packet = 16 x uint32 words.
SB_PACKET_WORDS = 16
FLAGS_WORD = 0
DEST_WORD = 1
DATA_WORDS = slice(2, 15)  # 13 words = 52 bytes
RESERVED_WORD = 15

# `last` flag: bit 0 of flags (mirrors switchboard's umi/sb `last`).
FLAG_LAST = np.uint32(1)


def make_packet(dest: int = 0, flags: int = 1, data: np.ndarray | None = None) -> np.ndarray:
    """Host-side constructor for a paper-layout SB packet (numpy uint32[16])."""
    pkt = np.zeros(SB_PACKET_WORDS, dtype=np.uint32)
    pkt[FLAGS_WORD] = np.uint32(flags)
    pkt[DEST_WORD] = np.uint32(dest)
    if data is not None:
        raw = np.asarray(data).tobytes()
        if len(raw) > 52:
            raise ValueError(f"SB packet payload is 52 bytes max, got {len(raw)}")
        buf = np.zeros(52, dtype=np.uint8)
        buf[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        pkt[DATA_WORDS] = buf.view(np.uint32)
    return pkt


def packet_data(pkt: np.ndarray, dtype=np.uint8, count: int | None = None) -> np.ndarray:
    """Extract the data payload of a paper-layout packet as ``dtype``."""
    pkt = np.asarray(pkt, dtype=np.uint32)
    raw = pkt[DATA_WORDS].tobytes()
    out = np.frombuffer(raw, dtype=dtype)
    return out[:count] if count is not None else out


def packet_dest(pkt) -> int:
    return int(np.asarray(pkt)[DEST_WORD])


def packet_flags(pkt) -> int:
    return int(np.asarray(pkt)[FLAGS_WORD])


def zeros_payload(payload_words: int, dtype=torch.float32, device=None):
    """Device-side empty payload vector (the engine's packet representation)."""
    return torch.zeros((payload_words,), dtype=dtype, device=device)
