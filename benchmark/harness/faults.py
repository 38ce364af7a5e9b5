"""Faults planted under a run's timed path, for the check that a broken
program comes out not correct (``benchmark/tests/test_bench_runs.py`` on
the CPU, ``benchmark/control.py --fault`` on the card).  ``install(kind)``
replaces the port's ``Receiver`` where the entry drivers build it by one
whose compiled step is broken after each call:

* ``state_unchanged``: the step returns its state as it got it;
* ``half_batch``: the second half of the streams' outputs are zeros (one
  stream: none);
* ``answer_altered``: L and R swapped;
* ``syndrome_altered``: every block's second syndrome id moved by one;
* ``rds_histories``: the RDS chain's filter histories (band-pass, squared
  band-pass, composed resampler, RRC) never advance, all else does;
* ``rds_rrc_history``: only the RRC's history never advances;
* ``rds_resampler_history``: only the composed resampler's history never
  advances.
"""

from __future__ import annotations

KINDS = ("state_unchanged", "half_batch", "answer_altered",
         "syndrome_altered", "rds_histories", "rds_rrc_history",
         "rds_resampler_history")
RDS_HISTORIES = {"rds_histories": ("extract_zi", "squared_zi", "resamp_zi",
                                   "rrc_zi"),
                 "rds_rrc_history": ("rrc_zi",),
                 "rds_resampler_history": ("resamp_zi",)}


def receiver_class(kind: str):
    """A ``Receiver`` whose compiled step has the fault ``kind``."""
    from rtsdr_tpu_torch.pipeline.receiver import Receiver
    from rtsdr_tpu_torch.utils.jit import flatten

    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r}")

    def kept(state):
        if kind == "state_unchanged":
            return flatten(state)[0]
        if kind in RDS_HISTORIES:
            return [getattr(state.rds, f) for f in RDS_HISTORIES[kind]]
        return []

    class Faulty(Receiver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner = self.step.borrowed

            def borrowed(state, raw):
                saved = [t.clone() for t in kept(state)]
                new, out = inner(state, raw)
                for t, s in zip(kept(new), saved):
                    t.copy_(s)
                if kind == "half_batch" and out.left.dim() > 1:
                    half = out.left.shape[0] // 2
                    for t in (out.left, out.right, out.rds.syndrome_id,
                              out.rds.symbols_i):
                        t[half:] = 0
                elif kind == "answer_altered":
                    left = out.left.clone()
                    out.left.copy_(out.right)
                    out.right.copy_(left)
                elif kind == "syndrome_altered":
                    sid = out.rds.syndrome_id
                    sid[..., 1] = (sid[..., 1] + 1) % 6
                return new, out
            self.step.borrowed = borrowed
    return Faulty


def install(kind: str, setattr_=setattr) -> None:
    """Put the faulty ``Receiver`` where the drivers import it from
    (``setattr_``: a test's ``monkeypatch.setattr``, which undoes it)."""
    import rtsdr_tpu_torch.io.stream as stream
    import rtsdr_tpu_torch.pipeline.receiver as receiver

    faulty = receiver_class(kind)
    for mod in (receiver, stream):
        setattr_(mod, "Receiver", faulty)
