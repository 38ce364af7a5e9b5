"""Reference front ``u8``: a station's own interleaved u8 I/Q at ``rf.fs``,
dequantized as the receiver's ingest does, ``(x - 128) / 128``, I the even
bytes and Q the odd.  The front of every configuration that names none.
It has no state and no precision of its own: the receiver rounds its
input to the reference's precision at the RF low-pass.
"""

from __future__ import annotations

import numpy as np


class Front:
    def __init__(self, config: dict, precision: str):
        pass

    def init(self, lanes: int):
        return None

    def step(self, state, raws: list, where: list):
        """``(state, i, q)`` of the lanes' raw blocks ``raws`` (each
        ``block_size`` u8); ``where``, each lane's ``(stream, block)``, is
        not needed."""
        iq = (np.stack(raws).astype(np.float64) - 128.0) / 128.0
        return state, iq[:, 0::2], iq[:, 1::2]
