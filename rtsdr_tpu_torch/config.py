"""Mode/parameter tables for the FM receiver.

The reference hardcodes these per-thread (src/fm_radio.cpp:34-55 for the RF
front end, :152-180 for the audio path, :330-370 for RDS; Python model
constants at model/fmMonoBlock.py:22-32 and model/fmRDSblock.py:24-50).
Here they are frozen dataclasses so the whole receiver is configured by one
immutable object (own copy of ``rtsdr_tpu/config.py``, field for field; the
PyTorch port imports nothing of the JAX package).

All filters are designed at the rate at which they run.  This deliberately
fixes two reference C++ quirks (SURVEY.md §7): the C++ designs mode-1 stereo
band-pass filters at the wrong rate and runs the pilot PLL with a hardcoded
Fs=240k even at a 250 kS/s IF; the Python models (our fidelity target) use
consistent rates.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class RFConfig:
    """RF front end: LPF + decimate the raw IQ stream down to the IF rate.

    Mirrors reference src/fm_radio.cpp:34-42 (Fs by mode, Fc=100k, 151 taps,
    decim 10).
    """

    fs: float = 2.4e6
    fc: float = 100e3
    taps: int = 151
    decim: int = 10

    @property
    def if_fs(self) -> float:
        return self.fs / self.decim


@dataclasses.dataclass(frozen=True)
class MonoConfig:
    """Mono audio extraction from the demodulated FM signal.

    Mode 0: LPF 16 kHz + decimate by 5 (240 kS/s -> 48 kS/s).
    Mode 1: polyphase resample up 24 / down 125 (250 kS/s -> 48 kS/s),
    reference src/fm_radio.cpp:174-180.
    """

    fc: float = 16e3
    taps: int = 151
    up: int = 1
    down: int = 5


@dataclasses.dataclass(frozen=True)
class PLLConfig:
    """First-order PLL/NCO loop constants (reference model/fmPll.py:4-10)."""

    freq: float = 19e3
    nco_scale: float = 2.0
    phase_adjust: float = 0.0
    norm_bandwidth: float = 0.01
    cp: float = 2.666
    ci: float = 3.555

    @property
    def kp(self) -> float:
        return self.norm_bandwidth * self.cp

    @property
    def ki(self) -> float:
        return self.norm_bandwidth * self.norm_bandwidth * self.ci


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Stereo pilot recovery + DSB-SC channel extraction.

    Bands per reference model/fmMonoBlock.py:115,150 (pilot 18.5-19.5 kHz,
    channel 22-54 kHz); the recovered 19 kHz pilot is doubled by the NCO
    (nco_scale=2) to give the 38 kHz subcarrier.
    """

    pilot_lo: float = 18.5e3
    pilot_hi: float = 19.5e3
    chan_lo: float = 22e3
    chan_hi: float = 54e3
    taps: int = 151
    pll: PLLConfig = PLLConfig(freq=19e3, nco_scale=2.0, norm_bandwidth=0.01)
    # Golden-model NCO mixer view (time-aligned; see ops/pll.py
    # delay_output).  False shifts the NCO one sample early (diagnostic).
    nco_delay: bool = True


@dataclasses.dataclass(frozen=True)
class RDSConfig:
    """RDS path constants (reference model/fmRDSblock.py:36-50,88-123).

    57 kHz subcarrier recovered by squaring the 54-60 kHz band and locking a
    PLL at 114 kHz with nco_scale=0.5; baseband resampled x19/80 to 57 kS/s
    (24 samples/symbol at 2375 symbols/s), RRC matched filter, Manchester +
    differential decode, 26-bit frame sync against the RDS parity matrix.
    """

    extract_lo: float = 54e3
    extract_hi: float = 60e3
    squared_lo: float = 113.5e3
    squared_hi: float = 114.5e3
    taps: int = 151
    pll: PLLConfig = PLLConfig(
        freq=114e3,
        nco_scale=0.5,
        phase_adjust=math.pi / 3.3 - math.pi / 1.5,
        norm_bandwidth=0.001,
    )
    lpf_fc: float = 3e3
    up: int = 19
    down: int = 80
    # Anti-image LPF runs at if_fs*up; cutoff = symbol_rate*sps/2 = 28.5 kHz.
    anti_img_taps: int = 151
    rrc_fs: float = 57e3
    rrc_taps: int = 151
    rrc_beta: float = 0.90
    symbol_rate: float = 2375.0
    sps: int = 24  # samples per symbol at 57 kS/s


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Full receiver configuration for one run mode.

    ``block_size`` counts raw uint8 stdin bytes per processing block
    (reference src/fm_radio.cpp:23: 307200 = 153600 IQ pairs = 64 ms at
    2.4 MS/s).
    """

    mode: int
    rf: RFConfig
    mono: MonoConfig
    stereo: StereoConfig
    rds: RDSConfig | None
    block_size: int = 307200
    audio_scale: float = 16384.0  # int16 emit scale, src/fm_radio.cpp:297

    @property
    def iq_len(self) -> int:
        """IQ pairs per block."""
        return self.block_size // 2

    @property
    def if_len(self) -> int:
        """Samples per block at the IF rate (after the front-end decimator)."""
        assert self.iq_len % self.rf.decim == 0
        return self.iq_len // self.rf.decim

    @property
    def audio_len(self) -> int:
        """Audio samples per block (48 kS/s)."""
        n = self.if_len * self.mono.up
        assert n % self.mono.down == 0
        return n // self.mono.down

    @property
    def audio_fs(self) -> float:
        return self.rf.if_fs * self.mono.up / self.mono.down

    @cached_property
    def rds_len(self) -> int:
        """RDS samples per block at 57 kS/s."""
        assert self.rds is not None
        n = self.if_len * self.rds.up
        assert n % self.rds.down == 0
        return n // self.rds.down

    @property
    def max_symbols(self) -> int:
        """Fixed upper bound on RDS symbols per block (clock offset varies)."""
        return -(-self.rds_len // (self.rds.sps if self.rds else 24))


MODE0 = ReceiverConfig(
    mode=0,
    rf=RFConfig(fs=2.4e6),
    mono=MonoConfig(up=1, down=5),
    stereo=StereoConfig(),
    rds=RDSConfig(),
)

# Mode 1: RF 2.5 MS/s, fractional audio resampler up 24 / down 125; RDS is
# disabled (reference gates the RDS thread on mode==0, src/fm_radio.cpp:324).
# Block size is 320000 bytes (64 ms at 2.5 MS/s) so the IF block (16000)
# divides the 125-fold decimator exactly; the reference's 307200 does not.
MODE1 = ReceiverConfig(
    mode=1,
    rf=RFConfig(fs=2.5e6),
    mono=MonoConfig(up=24, down=125),
    stereo=StereoConfig(),
    rds=None,
    block_size=320000,
)

# Mode 1 with RDS enabled — beyond the reference, which gates its RDS
# thread on mode==0 (src/fm_radio.cpp:324) although nothing in the physics
# requires it: the 250 kS/s IF still contains the 57 kHz subcarrier and its
# 113.5-114.5 kHz squared image (both below the 125 kHz Nyquist), and
# 16000 * 57 / 250 = 3648 samples/block lands exactly on the 57 kS/s
# symbol grid (24 samples/symbol at 2375 baud, same as mode 0).  The
# anti-image filter scales its length with the 3x higher dilated rate
# (57 * 250k vs 19 * 240k) to keep the same transition width.
# phase_adjust retuned for the 250 kS/s IF: the squared-BPF group delay
# (75 IF samples) shifts the recovered carrier by a different fraction of
# a 114 kHz cycle than at 240 kS/s (34.200 vs 35.625 cycles), rotating the
# constellation ~-1.37 rad off the mode-0 value.  Value from the analytic
# tuner (tools/constellation.py optimal_phase_delta; I-axis concentration
# 0.038 -> 0.99996 on a synthetic station).
MODE1_RDS = dataclasses.replace(
    MODE1,
    rds=RDSConfig(up=57, down=250, anti_img_taps=453,
                  pll=PLLConfig(
                      freq=114e3,
                      nco_scale=0.5,
                      phase_adjust=-2.5163,
                      norm_bandwidth=0.001,
                  )),
)

MODES = {0: MODE0, 1: MODE1}
