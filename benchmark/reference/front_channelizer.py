"""Reference front ``channelizer``: one slot of a wideband capture at
``rf.fs``, for a configuration with a ``wideband`` block (``slots`` K,
``taps_per_branch``, ``offsets_hz``).

What a stream carries (``block_of``) is ``(capture, slot)``: the whole
capture's interleaved u8 I/Q for the block, K times ``block_size`` bytes
at K times ``rf.fs``, and the slot k that the stream decodes.  For each
lane the front

1. dequantizes the capture as ``(x - 128) / 128``, I the even bytes and Q
   the odd;
2. filters it at the wideband rate with the slot's band-pass
   ``h[n] * exp(2j pi k n / K)``, ``h`` a low-pass of ``K *
   taps_per_branch`` taps cut off at 0.45 of a slot (``golden.lowpass``:
   a Hann-windowed sinc, its own float64 design), and keeps every K-th
   sample, the first at the block's first sample;
3. mixes out the station's offset from its slot's centre at ``rf.fs``:
   ``exp(-2j pi offset (b n + m) / rf.fs)`` at sample m of block b, n
   samples a block, the phase worked out from ``(stream, block)`` in
   integers (the offsets are whole Hz), so nothing of it is carried.

Its memory is the last ``K * taps_per_branch - 1`` wideband samples,
under half a block, so a window item rebuilds it from blocks s - 2 and
s - 1 as it rebuilds the filters.  It imports nothing of the program.
``precision`` rounds the taps, the input and each stage's output (its real
and imaginary parts) as ``golden.to_precision`` does.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import golden

CUTOFF_OF_A_SLOT = 0.45


class Front:
    def __init__(self, config: dict, precision: str):
        wb = config["wideband"]
        self.k = int(wb["slots"])
        self.fs = float(config["rf"]["fs"])
        self.n = config["block_size"] // 2       # samples a block at rf.fs
        offsets = np.asarray(wb["offsets_hz"], np.float64)
        if offsets.shape != (self.k,) or np.any(offsets != np.round(offsets)):
            raise ValueError("offsets_hz: one whole number of Hz a slot")
        self.offsets = offsets.astype(np.int64)
        if self.fs != round(self.fs):
            raise ValueError("rf.fs: a whole number of Hz")
        taps = self.k * int(wb["taps_per_branch"])
        self.h = golden.lowpass(self.k * self.fs, CUTOFF_OF_A_SLOT * self.fs,
                                taps)
        self.precision = precision

    def _q(self, z: np.ndarray) -> np.ndarray:
        p = self.precision
        return golden.to_precision(z.real, p) + 1j * golden.to_precision(
            z.imag, p)

    def init(self, lanes: int) -> np.ndarray:
        return np.zeros((lanes, len(self.h) - 1), np.complex128)

    def band_pass(self, slot: int) -> np.ndarray:
        """Slot ``slot``'s complex band-pass at the wideband rate."""
        n = np.arange(len(self.h))
        return self._q(self.h * np.exp(2j * np.pi * ((slot * n) % self.k)
                                       / self.k))

    def step(self, state: np.ndarray, raws: list, where: list):
        """``(state, i, q)``: ``raws`` each lane's ``(capture, slot)``,
        ``where`` each lane's ``(stream, block)``."""
        k, n, taps = self.k, self.n, len(self.h)
        i_out = np.empty((len(raws), n))
        q_out = np.empty((len(raws), n))
        tails = np.empty_like(state)
        for lane, ((capture, slot), (_, block)) in enumerate(zip(raws,
                                                                 where)):
            iq = (np.asarray(capture).astype(np.float64) - 128.0) / 128.0
            if iq.shape != (2 * k * n,):
                raise ValueError(f"a capture block is {2 * k * n} bytes")
            x = self._q(iq[0::2] + 1j * iq[1::2])
            xe = np.concatenate([state[lane], x])
            h = self.band_pass(slot)
            # y[m] = sum_j h[j] x[K m - j], x[-j] from the tail
            y = np.zeros(n, np.complex128)
            for j in range(taps):
                start = taps - 1 - j
                y += h[j] * xe[start:start + k * n:k]
            y = self._q(y)
            # the phase in cycles, off * (b n + m) / fs reduced mod 1 in
            # integers
            idx = block * n + np.arange(n, dtype=np.int64)
            cycles = ((self.offsets[slot] * idx) % int(self.fs)) / self.fs
            y = self._q(y * self._q(np.exp(-2j * np.pi * cycles)))
            i_out[lane], q_out[lane] = y.real, y.imag
            tails[lane] = xe[-(taps - 1):]
        return tails, i_out, q_out
