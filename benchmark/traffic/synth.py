"""The benchmark's traffic generator: synthetic FM broadcast stations as
interleaved u8 I/Q, made from a seed and a traffic file.

A frozen copy of the port's station, RDS and noise synthesizers
(``rtsdr_tpu_torch/utils/signals.py``: the FM stereo multiplex, the RDS
encoder and pulse shaper; ``tools/torch_decode_campaign.py``: complex
noise at a carrier-to-noise ratio), with its own root-raised-cosine taps,
so that nothing the program changes can change the traffic.  The stations
are made with PyTorch on the run's device in float64, the RDS bits and
shapes in NumPy.

``make_ring(traffic, config, seed)`` gives the ring every driver loops:
``traffic["stations"]`` distinct stations, each ``traffic["ring_blocks"]``
blocks long, and the station and ring offset of every stream.
"""

from __future__ import annotations

import math

import numpy as np

# RDS CRC generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 and the offset words
# (IEC 62106)
RDS_CRC_POLY = 0b10110111001
RDS_OFFSET_WORDS = {"A": 0b0011111100, "B": 0b0110011000,
                    "C": 0b0101101000, "D": 0b0110110100,
                    "C'": 0b1101010000}
RDS_BITS_PER_S = 1187.5


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one seed: any integer seed (negative
    and wider than 64 bits included), ``stream`` keeps purposes apart."""
    words = [seed % (1 << 64) & 0xFFFFFFFF, (seed % (1 << 64)) >> 32]
    return np.random.default_rng(np.random.SeedSequence(words + list(stream)))


def rrc_taps(fs: float, num_taps: int, beta: float = 0.90,
             symbol_rate: float = 2375.0) -> np.ndarray:
    """Root-raised-cosine pulse (model/fmRRC.py:12-47, centre at
    ``k - num_taps / 2``)."""
    t_sym = 1.0 / symbol_rate
    h = np.empty(num_taps, dtype=np.float64)
    for k in range(num_taps):
        t = (k - num_taps / 2.0) / fs
        if t == 0.0:
            h[k] = 1.0 + beta * (4.0 / math.pi - 1.0)
        elif abs(abs(t) - t_sym / (4.0 * beta)) < 1e-18:
            h[k] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / math.pi) * math.sin(math.pi / (4.0 * beta))
                + (1.0 - 2.0 / math.pi) * math.cos(math.pi / (4.0 * beta)))
        else:
            num = (math.sin(math.pi * t * (1.0 - beta) / t_sym)
                   + 4.0 * beta * (t / t_sym)
                   * math.cos(math.pi * t * (1.0 + beta) / t_sym))
            den = math.pi * t * (1.0 - (4.0 * beta * t / t_sym) ** 2) / t_sym
            h[k] = num / den
    return h


def rds_crc10(info: int) -> int:
    """info(x) * x^10 mod g(x) over GF(2); info is 16 bits, MSB first."""
    r = info << 10
    for i in range(25, 9, -1):
        if (r >> i) & 1:
            r ^= RDS_CRC_POLY << (i - 10)
    return r & 0x3FF


def encode_rds_blocks(info_words) -> np.ndarray:
    """26-bit blocks [info(16) | crc ^ offset(10)], offsets A, B, C (C' in
    a version-B group), D."""
    names = ["A", "B", "C", "D"]
    bits = []
    version_b = False
    for n, info in enumerate(info_words):
        info = int(info) & 0xFFFF
        name = names[n % 4]
        if n % 4 == 1:
            version_b = bool((info >> 11) & 1)
        elif n % 4 == 2 and version_b:
            name = "C'"
        check = rds_crc10(info) ^ RDS_OFFSET_WORDS[name]
        bits.extend((info >> (15 - k)) & 1 for k in range(16))
        bits.extend((check >> (9 - k)) & 1 for k in range(10))
    return np.array(bits, dtype=np.int64)


def rds_baseband(bits, sps: int = 24) -> np.ndarray:
    """Differential encoding, Manchester symbols, RRC pulses at 57 kS/s."""
    tx = np.bitwise_xor.accumulate(np.asarray(bits, dtype=np.int64))
    symbols = np.empty(2 * len(tx))
    symbols[0::2] = 2.0 * tx - 1.0
    symbols[1::2] = -(2.0 * tx - 1.0)
    x = np.zeros(len(symbols) * sps)
    x[::sps] = symbols
    return np.convolve(x, rrc_taps(57e3, 151), mode="full")[: len(x)]


def station_words(n_groups: int, pi: int, ps: str, rt: str,
                  pty: int) -> list[int]:
    """Info words of ``n_groups`` groups: program service name (0A, two
    characters a group) and RadioText (2A, four characters a group), three
    0A groups to each 2A group, as stations air them."""
    ps = (ps + " " * 8)[:8]
    rt = (rt + " " * 64)[:64]
    words = []
    n_ps = n_rt = 0
    for g in range(n_groups):
        if g % 4 == 3:
            seg = n_rt % 16
            n_rt += 1
            b = (2 << 12) | (0 << 11) | (pty << 5) | seg
            c = (ord(rt[4 * seg]) << 8) | ord(rt[4 * seg + 1])
            d = (ord(rt[4 * seg + 2]) << 8) | ord(rt[4 * seg + 3])
        else:
            seg = n_ps % 4
            n_ps += 1
            b = (0 << 12) | (1 << 10) | (pty << 5) | (1 << 3) | seg
            c = (229 << 8) | 229         # AF filler codes
            d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        words.extend([pi, b, c, d])
    return words


def stations_iq(n_pairs: int, rf_fs: float, params: list[dict], seed: int,
                device="cpu"):
    """Interleaved u8 I/Q (stations, 2 * n_pairs) of the stations, made on
    ``device`` in float64 in a few whole-array calls: per station the
    stereo multiplex (mono tone, pilot, L-R tone on 38 kHz, RDS on 57 kHz;
    the pilot detuned by ``detune_hz`` with its harmonics), frequency
    modulated at 75 kHz deviation onto a unit carrier, complex noise at
    ``cnr_db`` (a ``torch.Generator`` on the device, seeded from ``seed``),
    then scaled by 100 around 128 and rounded."""
    import torch

    dev = torch.device(device)
    f64 = torch.float64

    def col(key):
        return torch.tensor([p[key] for p in params], dtype=f64,
                            device=dev)[:, None]
    t = torch.arange(n_pairs, dtype=f64, device=dev)[None, :] / rf_fs
    c1 = torch.cos(2 * math.pi * (19e3 + col("detune_hz")) * t
                   + col("pilot_phase"))
    c2 = 2 * c1 * c1 - 1                      # cos of twice the pilot
    c3 = c1 * (4 * c1 * c1 - 3)               # cos of three times
    waves = torch.tensor(np.stack([rds_baseband(encode_rds_blocks(
        p["words"])) for p in params]), dtype=f64, device=dev)
    # the RDS wave at 57 kS/s, interpolated linearly onto the RF grid
    pos = t[0] * 57e3
    i0 = pos.floor().long().clamp(max=waves.shape[1] - 2)
    frac = (pos - i0)[None, :]
    rds = waves[:, i0] * (1 - frac) + waves[:, i0 + 1] * frac
    m = (0.45 * torch.sin(2 * math.pi * col("mono_hz") * t) + 0.1 * c1
         + 0.45 * torch.sin(2 * math.pi * col("stereo_hz") * t) * c2
         + 0.25 * rds * c3)
    del c1, c2, c3, rds
    phase = torch.cumsum(m, -1) * (2 * math.pi * 75e3 / rf_fs)
    del m
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    sigma = 10.0 ** (-col("cnr_db") / 20.0) / math.sqrt(2.0)
    iq = torch.stack([torch.cos(phase), torch.sin(phase)], -1)   # (S, n, 2)
    del phase
    iq += sigma[..., None] * torch.randn(iq.shape, generator=gen,
                                         dtype=torch.float32, device=dev)
    u8 = (iq * 100.0 + 128.0).round_().clamp_(0, 255).to(torch.uint8)
    return u8.reshape(len(params), 2 * n_pairs)


def station_params(traffic: dict, seed: int) -> list[dict]:
    """Each distinct station's parameters, drawn from the seed within the
    traffic file's ranges."""
    rng = rng_for(seed, 1)
    lo, hi = traffic["cnr_db"]
    d = traffic["detune_hz"]
    out = []
    for k in range(traffic["stations"]):
        pi = int(rng.integers(0x1000, 0xFFFF))
        out.append({
            "pi": pi,
            "cnr_db": float(rng.uniform(lo, hi)),
            "detune_hz": float(rng.uniform(-d, d)),
            "pilot_phase": float(rng.uniform(0, 2 * np.pi)),
            "mono_hz": float(rng.uniform(300.0, 3000.0)),
            "stereo_hz": float(rng.uniform(300.0, 3000.0)),
            "ps": f"BENCH {k:02d}",
            "rt": f"station {k} pi {pi:04X} seed {seed} radiotext",
            "pty": int(rng.integers(1, 31)),
        })
    return out


def make_ring(traffic: dict, config: dict, seed: int, device="cpu"):
    """``(ring, stream_station, stream_offset, params, ring_dev)``: ``ring``
    (stations, ring_blocks, block_size) u8 on the host, ``ring_dev`` the
    same on ``device`` where it was made; stream c carries station
    ``stream_station[c]`` and at its b-th block the ring block
    ``(b + stream_offset[c]) % ring_blocks``."""
    bs = config["block_size"]
    n_blocks = traffic["ring_blocks"]
    n_pairs = n_blocks * bs // 2
    params = station_params(traffic, seed)
    bits_needed = n_blocks * bs / 2 / config["rf"]["fs"] * RDS_BITS_PER_S
    n_groups = int(bits_needed // 104) + 2
    for p in params:
        p["words"] = station_words(n_groups, p["pi"], p["ps"], p["rt"],
                                   p["pty"])
    ring_dev = stations_iq(n_pairs, config["rf"]["fs"], params, seed,
                           device).reshape(len(params), n_blocks, bs)
    ring = ring_dev.cpu().numpy()
    n = traffic["streams"]
    rng = rng_for(seed, 3)
    stream_station = np.arange(n) % len(params)
    stream_offset = rng.integers(0, n_blocks, n)
    return ring, stream_station, stream_offset, params, ring_dev


def stream_block(ring: np.ndarray, stream_station, stream_offset, c: int,
                 b: int) -> np.ndarray:
    """The raw block stream ``c`` carries at its block ``b``."""
    r = ring.shape[1]
    return ring[stream_station[c], (b + stream_offset[c]) % r]
