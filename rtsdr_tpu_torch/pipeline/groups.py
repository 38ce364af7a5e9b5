"""RDS group-payload decoding: PI / PTY / PS / RadioText from synced blocks.

The reference stops at printing syndrome names (src/fm_radio.cpp:649-696);
this layer assembles its 26-bit blocks into 4-block groups and decodes the
payloads a real radio shows.  Runs host-side over ``FrameOutputs`` — the
per-window 16-bit info words are computed on device by the frame layer
(pipeline/frame.py ``info_word``), so this is pure bookkeeping.

Group layout (RDS standard, IEC 62106):
  block A: PI code (station id)
  block B: group type (4) | version B0 | TP | PTY (5) | type-specific (5)
  0A/0B:   PS name segment address in B[1:0]; block D = 2 PS chars;
           B[4]=TA, B[3]=MS, B[2]=DI bit (segment 0 carries d3 .. 3
           carries d0)
  2A:      RadioText segment in B[3:0]; blocks C+D = 4 RT chars
  2B:      same, block D only (2 chars)
  0A:      block C = two alternative-frequency (AF) codes
  1A:      block D = Program Item Number (day/hour/minute)
  3A:      ODA announcement: B[4:0] = applied group, block D = AID
  4A:      clock time/date: 17-bit MJD + hour/minute + local offset
  8A:      TMC / ALERT-C (ISO 14819-1); single-group user messages AND
           multi-group messages (F=0, continuity index in B[2:0],
           label/value containers in the subsequent groups)
  10A:     Program Type Name segment in B[0]; blocks C+D = 4 PTYN chars
  14A:     EON: block D = PI(ON); variants 0-3 = PS(ON), 4 = AF(ON)
  14B:     EON immediate TA switching: TP(ON) B[4], TA(ON) B[3],
           PI(ON) in block D — a receiver retunes to the other network
           for the announcement when TA(ON) flips 0->1
  15A:     Long PS (RBDS / NRSC-4): 32-byte UTF-8 station name, 4 bytes
           per segment (C+D), segment address B[2:0]
  15B:     fast basic tuning: TA/MS/DI flags only (B repeated in D)
  RT+:     RadioText Plus tags (ODA 0x4BD7, RDS Forum R06/040_1) in
           whatever group a 3A announced — artist/title/etc. spans of
           the RadioText
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# RBDS (North America) program-type names — the reference hardware targets
# an RTL-SDR in Canada.  Index = PTY code 0..31.
PTY_NAMES = [
    "None", "News", "Information", "Sports", "Talk", "Rock", "Classic Rock",
    "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies", "Soft",
    "Nostalgia", "Jazz", "Classical", "R&B", "Soft R&B", "Language",
    "Religious Music", "Religious Talk", "Personality", "Public", "College",
    "Spanish Talk", "Spanish Music", "Hip-Hop", "", "", "Weather",
    "Emergency Test", "Emergency",
]

# European RDS program-type names (IEC 62106 annex F) — the same 5-bit
# codes mean different things on each side of the Atlantic; a receiver
# must pick the table by region, not by signal.
PTY_NAMES_RDS = [
    "None", "News", "Current Affairs", "Information", "Sport", "Education",
    "Drama", "Culture", "Science", "Varied", "Pop Music", "Rock Music",
    "Easy Listening", "Light Classical", "Serious Classical", "Other Music",
    "Weather", "Finance", "Children's Programmes", "Social Affairs",
    "Religion", "Phone-In", "Travel", "Leisure", "Jazz Music",
    "Country Music", "National Music", "Oldies Music", "Folk Music",
    "Documentary", "Alarm Test", "Alarm",
]

PTY_TABLES = {"rbds": PTY_NAMES, "rds": PTY_NAMES_RDS}


def pty_name(code: int, table: str = "rbds") -> str:
    names = PTY_TABLES[table]
    return names[code] if names[code] else str(code)

_OFFSET_A, _OFFSET_B, _OFFSET_C, _OFFSET_D = 1, 2, 3, 4  # syndrome ids
_OFFSET_CP = 5  # C' — block 3 of version-B groups (IEC 62106 offset table)


def mjd_to_date(mjd: int) -> tuple:
    """Modified Julian Day -> (year, month, day), IEC 62106 annex G."""
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    k = 1 if mp in (14, 15) else 0
    return 1900 + yp + k, mp - 1 - 12 * k, day


def decode_af_code(code: int) -> float | None:
    """AF code -> carrier MHz (VHF band only; None for fillers/markers)."""
    if 1 <= code <= 204:
        return round(87.5 + 0.1 * code, 1)
    return None


@dataclass(frozen=True)
class ClockTime:
    """Decoded 4A group: UTC date/time plus the local-time offset."""
    year: int
    month: int
    day: int
    hour: int
    minute: int
    offset_hours: float   # local time = UTC + offset_hours

    def __str__(self) -> str:
        sign = "+" if self.offset_hours >= 0 else "-"
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d} "
                f"{self.hour:02d}:{self.minute:02d} UTC"
                f"{sign}{abs(self.offset_hours):g}")


#  Registered Open Data Application IDs a tuner commonly meets (IEC 62106
#  annex; used only for display — unknown AIDs still register).
ODA_NAMES = {0xCD46: "RDS-TMC", 0x4BD7: "RadioText+", 0x6552: "eRT"}

#  RadioText Plus (RT+, AID 0x4BD7) content types a tuner displays
#  (RDS Forum R06/040_1 table; only the common ones named).
RTPLUS_CONTENT = {
    1: "ITEM.TITLE", 4: "ITEM.ARTIST", 2: "ITEM.ALBUM", 3: "ITEM.TRACK",
    9: "ITEM.YEAR", 12: "ITEM.BAND", 24: "INFO.DATE_TIME",
    31: "STATIONNAME.LONG", 32: "PROGRAMME.NOW", 33: "PROGRAMME.NEXT",
    39: "PROGRAMME.HOMEPAGE", 41: "PHONE.HOTLINE", 46: "EMAIL.HOTLINE",
    59: "PLACE",
}


@dataclass(frozen=True)
class ProgramItem:
    """Decoded 1A block D: scheduled start of the current program item."""
    day: int        # day of month, 0 = no PIN
    hour: int
    minute: int

    def __str__(self) -> str:
        return f"day {self.day} {self.hour:02d}:{self.minute:02d}"


@dataclass(frozen=True)
class TMCEvent:
    """ALERT-C user message (ISO 14819-1 §5.3/§5.4): 8A with X4=0.
    Single-group (F=1) messages carry only the base fields; multi-group
    (F=0) messages add the label/value containers of their subsequent
    groups in ``additional``."""
    event: int      # 11-bit event code
    location: int   # 16-bit location-table reference
    extent: int     # 0-7 locations affected beyond `location`
    direction: int  # 0 = positive, 1 = negative
    diversion: int  # traffic advised to divert (single-group only)
    duration: int   # 3-bit duration/persistence (single-group only)
    additional: tuple = ()   # ((label, value), ...) from multi-group data

    def __str__(self) -> str:
        extra = ""
        if self.additional:
            parts = []
            for lbl, val in self.additional:
                name = TMC_LABEL_NAMES.get(lbl, f"label{lbl}")
                parts.append(f"{name}={val}")
            extra = " [" + " ".join(parts) + "]"
        return (f"event {self.event} at loc {self.location} "
                f"ext {'-' if self.direction else '+'}{self.extent}"
                f"{' divert' if self.diversion else ''}{extra}")


#  ISO 14819-1 §5.5: value length (bits) per label in the multi-group
#  additional-data "label + value" stream.
TMC_LABEL_SIZES = {0: 3, 1: 3, 2: 5, 3: 5, 4: 5, 5: 8, 6: 8, 7: 8,
                   8: 8, 9: 11, 10: 16, 11: 16, 12: 16, 13: 16,
                   14: 0, 15: 0}
TMC_LABEL_NAMES = {0: "duration", 1: "control", 2: "length_km",
                   3: "speed_limit_5kmh", 4: "quantifier5",
                   5: "quantifier8", 6: "suppl_info", 7: "explicit_start",
                   8: "explicit_stop", 9: "add_event", 10: "detailed_loc",
                   11: "destination", 13: "cross_linkage",
                   14: "separator"}


@dataclass
class EONStation:
    """Enhanced Other Networks (14A): what this station broadcasts about
    a cross-referenced network."""
    ps: list = field(default_factory=lambda: [" "] * 8)
    af_mhz: set = field(default_factory=set)
    pty: int | None = None
    ta: int | None = None

    @property
    def ps_name(self) -> str:
        return "".join(self.ps)


@dataclass
class Group:
    pi: int
    group_type: int
    version: int          # 0 = A, 1 = B
    tp: int
    pty: int
    blocks: tuple         # (info_a, info_b, info_c, info_d)
    position: int         # global bit position of block A

    @property
    def name(self) -> str:
        return f"{self.group_type}{'B' if self.version else 'A'}"


@dataclass
class GroupDecoder:
    """Stateful assembler: feed per-block FrameOutputs (single channel),
    collect decoded groups and the accumulated PS / RadioText strings.

    ``pty_table``: 'rbds' (North America, the reference's region) or
    'rds' (Europe, IEC 62106 annex F) — same 5-bit codes, different
    meanings; region-selected, not signal-selected."""

    pty_table: str = "rbds"
    pi: int | None = None
    pty: int | None = None
    ps: list = field(default_factory=lambda: [" "] * 8)
    radiotext: list = field(default_factory=lambda: [" "] * 64)
    ptyn: list = field(default_factory=lambda: [" "] * 8)  # 10A
    af_mhz: set = field(default_factory=set)      # from 0A block C (VHF)
    af_lfmf_khz: set = field(default_factory=set)  # LF/MF AFs (after 250)
    af_declared: int | None = None                # "N AFs follow" marker
    clock: ClockTime | None = None                # latest 4A group
    ta: int | None = None                         # traffic announcement now
    ms: int | None = None                         # 1 = music, 0 = speech
    di: int = 0                                   # DI bits d3..d0 assembled
    _di_seen: int = 0                             # which DI bits arrived
    pin: ProgramItem | None = None                # latest 1A group
    oda: dict = field(default_factory=dict)       # group name -> AID (3A)
    tmc_events: list = field(default_factory=list)  # 8A user messages
    _tmc_multi: dict = field(default_factory=dict)  # CI -> partial multi-grp
    eon: dict = field(default_factory=dict)       # PI(ON) -> EONStation
    eon_ta_events: list = field(default_factory=list)  # 14B (PI_ON, TA_ON)
    long_ps_bytes: list = field(default_factory=lambda: [0] * 32)  # 15A
    rtplus: dict = field(default_factory=dict)    # RT+ content -> text
    rtplus_item_running: bool | None = None
    ert_bytes: list = field(default_factory=lambda: [0] * 128)  # eRT
    _ert_utf8: bool = True               # from the 3A message bits
    _rtplus_toggle: int | None = None
    _tmc_seen: set = field(default_factory=set)
    _af_lfmf_next: bool = False                   # code 250 seen: next
    #                                               code is an LF/MF number
    groups: list = field(default_factory=list)
    _window: list = field(default_factory=list)   # recent (pos, sid, info)
    _last_pos: int = -1                           # seam-duplicate guard

    def feed(self, frame_out) -> list:
        """Consume one block's FrameOutputs; returns groups completed."""
        n_w = int(frame_out.n_windows)
        sid = np.asarray(frame_out.syndrome_id)[:n_w]
        sync = np.asarray(frame_out.is_sync)[:n_w]
        pos = np.asarray(frame_out.positions)[:n_w]
        info = np.asarray(frame_out.info_word)[:n_w]
        new = []
        for w in np.nonzero(sync)[0]:
            p = int(pos[w])
            if p <= self._last_pos:   # seam window re-evaluated: skip dup
                continue
            self._last_pos = p
            self._window.append((p, int(sid[w]), int(info[w])))
            self._window = self._window[-8:]
            g = self._try_assemble()
            if g is not None:
                new.append(g)
        self.groups.extend(new)
        return new

    def _decode_flags(self, ib: int) -> None:
        """TA/MS/DI from a 0A/0B/15B block B.  The DI bit in the group
        with segment address s is d(3-s) — segment 3 carries d0, the
        mono/stereo flag (IEC 62106 §3.2.1.5)."""
        seg = ib & 0x3
        self.ta = (ib >> 4) & 1
        self.ms = (ib >> 3) & 1
        bit = 3 - seg
        self.di = (self.di & ~(1 << bit)) | (((ib >> 2) & 1) << bit)
        self._di_seen |= 1 << bit

    @property
    def alarm(self) -> bool:
        """PTY 31 = Alarm (IEC 62106 §3.2.1.2): interrupt normal
        programme handling — a real receiver unmutes and overrides
        source selection."""
        return self.pty == 31

    @property
    def di_stereo(self) -> bool | None:
        """Decoder-identification d0: True = transmission is stereo.
        None until segment 3 has aired."""
        if not self._di_seen & 1:
            return None
        return bool(self.di & 1)

    def _decode_af_pair(self, ic: int) -> None:
        """Two AF codes from a 0A block C.  Code 250 = 'an LF/MF frequency
        follows': the next code (possibly in the next group) is an LF/MF
        channel number, not a VHF carrier."""
        for code in ((ic >> 8) & 0xFF, ic & 0xFF):
            if self._af_lfmf_next:
                self._af_lfmf_next = False
                if 1 <= code <= 15:            # LF 153-279 kHz, 9 kHz grid
                    self.af_lfmf_khz.add(153 + 9 * (code - 1))
                elif 16 <= code <= 135:        # MF 531-1602 kHz
                    self.af_lfmf_khz.add(531 + 9 * (code - 16))
            elif code == 250:
                self._af_lfmf_next = True
            elif 225 <= code <= 249:
                self.af_declared = code - 224
            else:
                f = decode_af_code(code)
                if f is not None:
                    self.af_mhz.add(f)

    def _try_assemble(self):
        if len(self._window) < 4:
            return None
        (pa, sa, ia), (pb, sb, ib), (pc, sc, ic), (pd, sd, id_) = \
            self._window[-4:]
        if (sa, sb, sd) != (_OFFSET_A, _OFFSET_B, _OFFSET_D):
            return None
        # Block 3 carries offset C in version-A groups and C' in version-B
        # groups (IEC 62106 offset-word table) — the offset word and block
        # B's version bit are redundant by design, so a mismatch means a
        # corrupted (yet syndrome-passing) block: drop the group.  The
        # reference never matches C' at all (src/fm_radio.cpp:479-482),
        # which makes real 0B/2B/15B groups undecodable there.
        version = (ib >> 11) & 1
        if sc != (_OFFSET_CP if version else _OFFSET_C):
            return None
        if not (pb - pa == 26 and pc - pb == 26 and pd - pc == 26):
            return None
        # In version B, block 3 (C') repeats the PI code — a free
        # integrity check on top of the syndrome match.
        if version and ic != ia:
            return None
        g = Group(
            pi=ia,
            group_type=(ib >> 12) & 0xF,
            version=version,
            tp=(ib >> 10) & 1,
            pty=(ib >> 5) & 0x1F,
            blocks=(ia, ib, ic, id_),
            position=pa,
        )
        self.pi = g.pi
        self.pty = g.pty
        if g.group_type == 0:
            seg = ib & 0x3
            self._decode_flags(ib)
            self.ps[2 * seg] = chr((id_ >> 8) & 0xFF)
            self.ps[2 * seg + 1] = chr(id_ & 0xFF)
            if g.version == 0:           # 0A block C = two AF codes
                self._decode_af_pair(ic)
        elif g.group_type == 15 and g.version == 1:
            self._decode_flags(ib)       # 15B: fast TA/MS/DI, no PS chars
        elif g.group_type == 1 and g.version == 0:
            day = (id_ >> 11) & 0x1F
            if day:                      # day 0 = no program item running
                self.pin = ProgramItem(day, (id_ >> 6) & 0x1F, id_ & 0x3F)
        elif g.group_type == 3 and g.version == 0:
            agtc = ib & 0x1F             # applied group: type<<1 | version
            applied = f"{agtc >> 1}{'B' if agtc & 1 else 'A'}"
            self.oda[applied] = id_      # block D = Application ID
            if id_ == 0x6552:
                # eRT announcement message (block C) bit 0 selects the
                # text encoding: 1 = UTF-8, 0 = UCS-2 big-endian
                self._ert_utf8 = bool(ic & 1)
        elif (g.group_type == 8 and g.version == 0
              and self.oda.get("8A", 0xCD46) == 0xCD46):
            # ALERT-C (8A is TMC by convention unless a 3A announced a
            # different ODA for it), X4=0 user messages only.  F=1 =
            # single group (ISO 14819-1 §5.3); F=0 = multi-group
            # (§5.4): the first group (C[15]=1) carries the base
            # event/location, subsequent groups (C[15]=0) carry 28-bit
            # label/value containers, chained by the continuity index
            # in B[2:0] and counted down by GSI in C[13:12].  Repeats
            # dedupe via a seen-set (stations cycle their active
            # message set continuously), capped so a long run stays
            # bounded.
            if (ib >> 4) & 1 == 0:
                if (ib >> 3) & 1 == 1:          # single group
                    self._emit_tmc(TMCEvent(
                        event=ic & 0x7FF, location=id_,
                        extent=(ic >> 11) & 0x7,
                        direction=(ic >> 14) & 1,
                        diversion=(ic >> 15) & 1,
                        duration=ib & 0x7))
                else:                           # multi-group
                    self._tmc_multi_feed(ib & 0x7, ic, id_)
        elif g.group_type == 14 and g.version == 1:
            # 14B: EON immediate traffic switching — the other network
            # PI(ON) (block D) just started (TA(ON) 0->1) or finished
            # (1->0) a traffic announcement; a real receiver retunes for
            # its duration.  TP(ON)=B[4], TA(ON)=B[3] (IEC 62106
            # §3.2.1.8.4).  Block 3 is the PI repeat under C' (already
            # validated above).
            ta_on = (ib >> 3) & 1
            on = self.eon.setdefault(id_, EONStation())
            started = ta_on == 1 and on.ta != 1
            ended = ta_on == 0 and on.ta == 1
            if started or ended:
                self.eon_ta_events.append((id_, ta_on))
                del self.eon_ta_events[:-64]   # bounded history
            on.ta = ta_on
        elif g.group_type == 14 and g.version == 0:
            on = self.eon.setdefault(id_, EONStation())  # block D = PI(ON)
            variant = ib & 0xF
            if variant < 4:              # PS(ON) segments
                on.ps[2 * variant] = chr((ic >> 8) & 0xFF)
                on.ps[2 * variant + 1] = chr(ic & 0xFF)
            elif variant == 4:           # AF(ON) pair, method A
                for code in ((ic >> 8) & 0xFF, ic & 0xFF):
                    f = decode_af_code(code)
                    if f is not None:
                        on.af_mhz.add(f)
            elif variant == 13:          # PTY(ON) + TA(ON)
                on.pty = (ic >> 11) & 0x1F
                on.ta = ic & 1
        elif g.group_type == 4 and g.version == 0:
            mjd = ((ib & 0x3) << 15) | (ic >> 1)
            year, month, day = mjd_to_date(mjd)
            hour = ((ic & 1) << 4) | (id_ >> 12)
            minute = (id_ >> 6) & 0x3F
            half_hours = id_ & 0x1F
            offset = half_hours * (-0.5 if (id_ >> 5) & 1 else 0.5)
            self.clock = ClockTime(year, month, day, hour, minute, offset)
        elif g.group_type == 2 and g.version == 0:
            seg = ib & 0xF
            for k, ch in enumerate(((ic >> 8) & 0xFF, ic & 0xFF,
                                    (id_ >> 8) & 0xFF, id_ & 0xFF)):
                self.radiotext[4 * seg + k] = chr(ch)
        elif g.group_type == 2:
            seg = ib & 0xF
            self.radiotext[2 * seg] = chr((id_ >> 8) & 0xFF)
            self.radiotext[2 * seg + 1] = chr(id_ & 0xFF)
        elif g.group_type == 10 and g.version == 0:
            seg = ib & 0x1   # PTYN: 2 segments of 4 chars (C+D)
            for k, ch in enumerate(((ic >> 8) & 0xFF, ic & 0xFF,
                                    (id_ >> 8) & 0xFF, id_ & 0xFF)):
                self.ptyn[4 * seg + k] = chr(ch)
        elif g.group_type == 15 and g.version == 0:
            # 15A Long PS (RBDS / NRSC-4-B): 32 UTF-8 bytes, 8 segments
            # of 4 bytes (C+D), segment address in B[2:0]
            seg = ib & 0x7
            for k, byte in enumerate(((ic >> 8) & 0xFF, ic & 0xFF,
                                      (id_ >> 8) & 0xFF, id_ & 0xFF)):
                self.long_ps_bytes[4 * seg + k] = byte
        elif self.oda.get(g.name) == 0x4BD7:
            self._decode_rtplus(ib, ic, id_)   # RadioText Plus tags
        elif self.oda.get(g.name) == 0x6552:
            # eRT (enhanced RadioText): B[4:0] = segment, C+D = 4 bytes
            # of UTF-8 (the common encoding; a 3A message bit can select
            # UCS-2 — stored as raw bytes either way, decoded in ert_str)
            seg = ib & 0x1F
            for k, byte in enumerate(((ic >> 8) & 0xFF, ic & 0xFF,
                                      (id_ >> 8) & 0xFF, id_ & 0xFF)):
                self.ert_bytes[4 * seg + k] = byte
        return g

    def _emit_tmc(self, ev: TMCEvent) -> None:
        if ev not in self._tmc_seen and len(self.tmc_events) < 256:
            self._tmc_seen.add(ev)
            self.tmc_events.append(ev)

    def _tmc_multi_feed(self, ci: int, ic: int, id_: int) -> None:
        """One 8A multi-group message group (ISO 14819-1 §5.4).

        First group: C[15]=1, same C/D layout as single-group minus the
        diversion bit (D=location, C=direction/extent/event).  Subsequent
        groups: C[15]=0, C[14]=SG (1 only in the 2nd group), C[13:12]=GSI
        (remaining group count, 0 in the last), C[11:0]+D = 28 bits of
        label/value additional data.  Groups chain by the continuity
        index CI; an interrupted chain is simply overwritten when the CI
        reappears as a new first group."""
        if (ic >> 15) & 1:                       # first group
            self._tmc_multi[ci] = {
                "event": ic & 0x7FF, "location": id_,
                "extent": (ic >> 11) & 0x7, "direction": (ic >> 14) & 1,
                "bits": [], "nbits": 0}
            return
        m = self._tmc_multi.get(ci)
        if m is None:                            # missed the first group
            return
        gsi = (ic >> 12) & 0x3
        m["bits"].append((ic & 0xFFF) << 16 | id_)
        m["nbits"] += 28
        if gsi != 0:
            return
        # last group arrived: concatenate containers MSB-first and walk
        # the label(4) + value stream; an all-zero tail is padding
        # ("label 0, value 0" = duration 0, the defined filler)
        val = 0
        for b28 in m["bits"]:
            val = (val << 28) | b28
        nbits = m["nbits"]
        pairs = []
        pos = nbits
        while pos >= 4:
            lbl = (val >> (pos - 4)) & 0xF
            size = TMC_LABEL_SIZES[lbl]
            if pos - 4 < size:
                break
            v = (val >> (pos - 4 - size)) & ((1 << size) - 1) if size else 0
            pos -= 4 + size
            if lbl == 0 and v == 0:
                continue                         # filler
            pairs.append((lbl, v))
        del self._tmc_multi[ci]
        self._emit_tmc(TMCEvent(
            event=m["event"], location=m["location"], extent=m["extent"],
            direction=m["direction"], diversion=0, duration=0,
            additional=tuple(pairs)))

    @property
    def long_ps_str(self) -> str:
        """RBDS Long PS (15A): up to 32 UTF-8 bytes; trailing NUL/space
        fill stripped, partial segments stay printable."""
        raw = bytes(self.long_ps_bytes).rstrip(b"\x00 ")
        return raw.decode("utf-8", errors="replace").replace("\x00", "")

    def _decode_rtplus(self, ib: int, ic: int, id_: int) -> None:
        """RT+ (RDS Forum R06/040_1): two (content-type, start, length)
        tags per group, indexing into the CURRENT RadioText — texts
        refine as the RT buffer fills (tags repeat continuously)."""
        toggle = (ib >> 4) & 1
        if self._rtplus_toggle is not None and toggle != self._rtplus_toggle:
            self.rtplus.clear()                # new item started
        self._rtplus_toggle = toggle
        self.rtplus_item_running = bool((ib >> 3) & 1)
        tag1 = (((ib & 0x7) << 3) | (ic >> 13),
                (ic >> 7) & 0x3F, (ic >> 1) & 0x3F)
        tag2 = ((((ic & 1) << 5) | (id_ >> 11)),
                (id_ >> 5) & 0x3F, id_ & 0x1F)
        for t, s, ln in (tag1, tag2):
            if t == 0:                         # type 0 = dummy
                continue
            name = RTPLUS_CONTENT.get(t, f"TYPE_{t}")
            text = "".join(self.radiotext[s:s + ln + 1]).strip()
            if text:
                self.rtplus[name] = text

    @property
    def ps_name(self) -> str:
        return "".join(self.ps)

    @property
    def radiotext_str(self) -> str:
        return "".join(self.radiotext).rstrip()

    @property
    def ptyn_str(self) -> str:
        return "".join(self.ptyn).strip()

    @property
    def ert_str(self) -> str:
        """Enhanced RadioText, decoded per the announced encoding (3A
        message bit 0: UTF-8, else UCS-2 big-endian).  NULs from
        not-yet-received segments are dropped so partial texts stay
        printable."""
        raw = bytes(self.ert_bytes).rstrip(b"\x00")
        enc = "utf-8" if self._ert_utf8 else "utf-16-be"
        text = raw.decode(enc, errors="replace")
        return text.replace("\x00", "").rstrip()


def format_group(g: Group, pty_table: str = "rbds") -> str:
    return (f"Group {g.name} PI=0x{g.pi:04X} PTY={pty_name(g.pty, pty_table)} "
            f"TP={g.tp} at position {g.position}")
