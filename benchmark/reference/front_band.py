"""Reference front ``band``: one station of a dense band's wideband capture
at ``rf.fs``, for a configuration with a ``wideband`` block that puts
several stations a slot (``slots`` K, ``taps_per_branch``, and per station
``slots_of`` and ``offsets_hz``).  Plain PyTorch in float64.

What a stream carries (``block_of``) is ``(capture, station)``: the whole
capture's interleaved u8 I/Q for the block, K times ``block_size`` bytes
at K times ``rf.fs``, and the station j that the stream decodes.  For each
lane the front

1. dequantizes the capture as ``(x - 128) / 128``, I the even bytes and Q
   the odd;
2. filters it at the wideband rate with the band-pass of station j's slot
   k = ``slots_of[j]``, ``h[n] * exp(2j pi k n / K)``, ``h`` a low-pass of
   ``K * taps_per_branch`` taps cut off at 0.45 of a slot
   (``golden.lowpass``: a Hann-windowed sinc, its own float64 design), and
   keeps every K-th sample, the first at the block's first sample;
3. mixes out the station's offset from its slot's centre at ``rf.fs``:
   ``exp(-2j pi offset (b n + m) / rf.fs)`` at sample m of block b, n
   samples a block, the phase worked out from ``(stream, block)`` in
   integers (the offsets are whole Hz), so nothing of it is carried.

Its memory is the last ``K * taps_per_branch - 1`` wideband samples,
under half a block, so a window item rebuilds it from blocks s - 2 and
s - 1 as it rebuilds the filters.  It imports nothing of the program.
``precision`` rounds the taps, the input and each stage's output (its real
and imaginary parts) as ``golden.to_precision`` does: to float32, and for
"bfloat16" on from there to the nearest even bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import golden

CUTOFF_OF_A_SLOT = 0.45
F64 = torch.float64


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return x
    if precision == "float32":
        return x.to(torch.float32).to(F64)
    if precision != "bfloat16":
        raise ValueError(f"precision {precision!r}")
    return x.to(torch.float32).to(torch.bfloat16).to(F64)


class Front:
    def __init__(self, config: dict, precision: str):
        wb = config["wideband"]
        self.k = int(wb["slots"])
        self.t = int(wb["taps_per_branch"])
        self.fs = float(config["rf"]["fs"])
        self.n = config["block_size"] // 2       # samples a block at rf.fs
        if self.fs != round(self.fs):
            raise ValueError("rf.fs: a whole number of Hz")
        offsets = np.asarray(wb["offsets_hz"], np.float64)
        slots = np.asarray(wb["slots_of"], np.int64)
        if (offsets.shape != slots.shape or offsets.ndim != 1
                or np.any(offsets != np.round(offsets))
                or np.any((slots < 0) | (slots >= self.k))):
            raise ValueError("slots_of and offsets_hz: a slot in [0, K) and "
                             "a whole number of Hz a station")
        self.slots = slots.tolist()
        self.offsets = offsets.astype(np.int64).tolist()
        self.h = torch.as_tensor(golden.lowpass(
            self.k * self.fs, CUTOFF_OF_A_SLOT * self.fs, self.k * self.t),
            dtype=F64)
        self.precision = precision
        self._weights: dict = {}

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _round(x, self.precision)

    def init(self, lanes: int) -> torch.Tensor:
        """Each lane's last ``len(h) - 1`` samples, I and Q: zeros."""
        return torch.zeros((lanes, 2, len(self.h) - 1), dtype=F64)

    def band_pass(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Slot ``slot``'s complex band-pass at the wideband rate, ``h[n] *
        exp(2j pi slot n / K)``: its real and imaginary parts."""
        n = torch.arange(len(self.h), dtype=torch.int64)
        turn = 2 * np.pi * (((slot * n) % self.k).to(F64) / self.k)
        return (self._q(self.h * torch.cos(turn)),
                self._q(self.h * torch.sin(turn)))

    def _weight(self, slot: int) -> torch.Tensor:
        """The band-pass as the weight of a stride-1 cross-correlation over
        the K polyphase planes of the input (real form, ``_filter``)."""
        if slot not in self._weights:
            k, t = self.k, self.t
            h_re, h_im = self.band_pass(slot)
            # plane c, lag u meets tap K (t - u) - c
            idx = (k * (t - torch.arange(t + 1))[None, :]
                   - torch.arange(k)[:, None])
            ok = (idx >= 0) & (idx < k * t)
            idx = idx.clamp(0, k * t - 1)
            wr = torch.where(ok, h_re[idx], 0.0)
            wi = torch.where(ok, h_im[idx], 0.0)
            self._weights[slot] = torch.stack([torch.cat([wr, -wi]),
                                               torch.cat([wi, wr])])
        return self._weights[slot]

    def _filter(self, xe: torch.Tensor, slot: int) -> torch.Tensor:
        """(2, n): ``y[m] = sum_j h[j] xe[len(h) - 1 + K m - j]`` of the
        input and its tail ``xe`` (2, len(h) - 1 + K n), I and Q.  With one
        zero ahead of xe, plane c, row q is ``[0 | xe][K q + c]``; tap j =
        K a + r of output m meets plane (K - r) mod K at row m + t - a - (r
        > 0): a stride-1 cross-correlation of t + 1 lags over 2 K planes
        (I and Q)."""
        k, t, n = self.k, self.t, self.n
        z = torch.cat([xe.new_zeros((2, 1)), xe], dim=1)
        planes = z.reshape(2, n + t, k).transpose(1, 2).reshape(2 * k, n + t)
        return F.conv1d(planes[None], self._weight(slot))[0]

    def step(self, state: torch.Tensor, raws: list, where: list):
        """``(state, i, q)``: ``raws`` each lane's ``(capture, station)``,
        ``where`` each lane's ``(stream, block)``; ``i`` and ``q`` (lanes,
        n) float64 NumPy arrays, as the golden receiver takes them."""
        k, n, tail = self.k, self.n, len(self.h) - 1
        i_out = np.empty((len(raws), n))
        q_out = np.empty((len(raws), n))
        tails = torch.empty_like(state)
        m = torch.arange(n, dtype=torch.int64)
        for lane, ((capture, station), (_, block)) in enumerate(
                zip(raws, where)):
            raw = torch.as_tensor(np.asarray(capture))
            if raw.shape != (2 * k * n,):
                raise ValueError(f"a capture block is {2 * k * n} bytes")
            x = self._q((raw.to(F64) - 128.0) / 128.0).reshape(-1, 2).T
            xe = torch.cat([state[lane], x], dim=1)
            y = self._q(self._filter(xe, self.slots[station]))
            # the phase in cycles, off * (b n + m) / fs reduced mod 1 in
            # integers; then y * exp(-2j pi cycles)
            cycles = torch.remainder(self.offsets[station] * (block * n + m),
                                     int(self.fs)).to(F64) / self.fs
            c = self._q(torch.cos(2 * np.pi * cycles))
            s = self._q(-torch.sin(2 * np.pi * cycles))
            i_out[lane] = self._q(y[0] * c - y[1] * s).numpy()
            q_out[lane] = self._q(y[0] * s + y[1] * c).numpy()
            tails[lane] = xe[:, -tail:]
        return tails, i_out, q_out
