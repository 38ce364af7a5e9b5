"""The port's own copy of the RDS group decoder decodes the schedules of
tests/test_groups.py exactly as ``rtsdr_tpu.pipeline.groups`` does: the
same ``Group``s, ``format_group`` strings and accumulated station data,
from the same frame outputs (host arrays, as the port's runners hand them
over)."""

import dataclasses
import inspect

import numpy as np
import pytest

from rtsdr_tpu.pipeline import groups as jgroups
from rtsdr_tpu_torch.pipeline import groups as tgroups
from rtsdr_tpu_torch.pipeline.frame import FrameOutputs

from test_groups import (
    _make_station_groups,
    _make_station_groups_b,
    _make_station_groups_r5,
)

W_MAX = 77


def _frame_blocks(words, drop=(), seed=0):
    """Perfect frame-layer outputs for a word schedule: one accepted sync
    every 26 bit positions (offsets cycling A, B, C or C', D), windows cut
    into blocks of W_MAX with the seam window repeated as the frame layer
    repeats it, a few chance false positives in between, and the syncs at
    the indices in ``drop`` missing (a group with a hole never assembles).
    """
    rng = np.random.default_rng(seed)
    n_pos = 26 * len(words)
    sid = np.zeros(n_pos, np.int32)
    info = rng.integers(0, 1 << 16, n_pos).astype(np.int32)
    sync = np.zeros(n_pos, bool)
    version_b = False
    for n, word in enumerate(words):
        k = n % 4
        if k == 1:
            version_b = bool((word >> 11) & 1)
        sid[26 * n] = 5 if (k == 2 and version_b) else k + 1
        info[26 * n] = word
        sync[26 * n] = n not in drop
    fp = np.zeros(n_pos, bool)
    fp_at = rng.choice(n_pos, n_pos // 200, replace=False)
    fp_at = fp_at[fp_at % 26 != 0]
    fp[fp_at] = True
    sid[fp_at] = rng.integers(1, 6, len(fp_at))
    blocks, base = [], 0
    while base < n_pos - 1:
        n_w = min(W_MAX, n_pos - base)
        pad = lambda a, fill=0: np.concatenate(
            [a[base:base + n_w], np.full(W_MAX - n_w, fill, a.dtype)])
        blocks.append(FrameOutputs(
            n_sym=np.int32(152), symbols_i=np.zeros(152, np.float32),
            symbols_q=np.zeros(152, np.float32), n_windows=np.int32(n_w),
            syndrome_id=pad(sid), is_sync=pad(sync), is_false_pos=pad(fp),
            positions=(base + np.arange(W_MAX)).astype(np.int32),
            is_resync=np.zeros(W_MAX, bool), info_word=pad(info),
            corrected=np.zeros(W_MAX, bool)))
        base += n_w - 1            # the last window is the next block's first
    return blocks


def _public_state(dec):
    out = {}
    for f in dataclasses.fields(dec):
        v = getattr(dec, f.name)
        if f.name == "groups":
            v = [dataclasses.astuple(g) for g in v]
        elif dataclasses.is_dataclass(v):
            v = dataclasses.astuple(v)
        elif isinstance(v, dict):
            v = {k: (dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                     else x) for k, x in v.items()}
        elif isinstance(v, (list, set)):
            v = type(v)(dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                        else x for x in v)
        out[f.name] = v
    for prop in ("ps_name", "radiotext_str", "ptyn_str", "long_ps_str",
                 "ert_str", "alarm", "di_stereo"):
        out[prop] = getattr(dec, prop)
    return out


SCHEDULES = {
    "version_a": (lambda: _make_station_groups(96), (), "rbds"),
    "version_a_rds_table": (lambda: _make_station_groups(40), (), "rds"),
    "version_b_cprime": (lambda: _make_station_groups_b(64), (), "rbds"),
    "round5_services": (lambda: _make_station_groups_r5(52), (), "rbds"),
    "with_holes": (lambda: _make_station_groups(64), (5, 42, 43, 130),
                   "rbds"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_decoder_copy_decodes_like_the_reference(name):
    make_words, drop, table = SCHEDULES[name]
    blocks = _frame_blocks(make_words(), drop, seed=len(name))
    t_dec = tgroups.GroupDecoder(pty_table=table)
    j_dec = jgroups.GroupDecoder(pty_table=table)
    n_groups = 0
    for fo in blocks:
        t_new, j_new = t_dec.feed(fo), j_dec.feed(fo)
        assert [dataclasses.astuple(g) for g in t_new] == \
            [dataclasses.astuple(g) for g in j_new]
        assert [tgroups.format_group(g, table) for g in t_new] == \
            [jgroups.format_group(g, table) for g in j_new]
        n_groups += len(t_new)
    assert n_groups >= 10 and t_dec.pi is not None
    assert _public_state(t_dec) == _public_state(j_dec)
    if name == "version_a":
        assert t_dec.ps_name == "TPU RDIO"
        assert t_dec.radiotext_str.strip() == "MXU RDIO"
    if name == "with_holes":
        assert len(t_dec.groups) < 64


def test_tables_and_helpers_equal():
    for const in ("PTY_NAMES", "PTY_NAMES_RDS", "ODA_NAMES", "RTPLUS_CONTENT",
                  "TMC_LABEL_SIZES", "TMC_LABEL_NAMES"):
        assert getattr(tgroups, const) == getattr(jgroups, const), const
    for code in range(256):
        assert tgroups.decode_af_code(code) == jgroups.decode_af_code(code)
    for mjd in (40587, 51544, 61270, 99999):
        assert tgroups.mjd_to_date(mjd) == jgroups.mjd_to_date(mjd)
    for code in range(32):
        for table in ("rbds", "rds"):
            assert tgroups.pty_name(code, table) == jgroups.pty_name(code,
                                                                     table)


def test_copy_is_the_same_source_but_for_its_imports():
    """The copy is the reference's code: the same syntax tree (docstrings
    included), apart from import statements; comments may be worded
    differently."""
    import ast

    def tree(module):
        t = ast.parse(inspect.getsource(module))
        t.body = [n for n in t.body
                  if not isinstance(n, (ast.Import, ast.ImportFrom))]
        return ast.dump(t)

    assert tree(tgroups) == tree(jgroups)
