"""State carried across: numpy trees <-> the port's state NamedTuples.

The system has no learned weights; what a running receiver holds is its
carried state.  A state exported from the JAX package (its
``ReceiverState``, ``WidebandState`` or ``ScanState`` mapped with
``np.asarray``: a nested NamedTuple / None tree of numpy arrays) becomes
the port's state of the same name field by field, dtype kept, and back — so
both packages can continue one stream from the same mid-stream state.
Matching is by field NAME, so the source tree may be any NamedTuple (or
mapping) with the same fields.
"""

from __future__ import annotations

import numpy as np
import torch

from rtsdr_tpu_torch.ops.pll import PLLState
from rtsdr_tpu_torch.pipeline.audio import AudioState
from rtsdr_tpu_torch.pipeline.frame import FrameState
from rtsdr_tpu_torch.pipeline.frontend import FrontendState
from rtsdr_tpu_torch.pipeline.rds import RDSState
from rtsdr_tpu_torch.pipeline.receiver import ReceiverState
from rtsdr_tpu_torch.pipeline.scan import ScanState
from rtsdr_tpu_torch.pipeline.wideband import WidebandState

_NESTED = {"frontend": FrontendState, "audio": AudioState, "pll": PLLState,
           "rds": RDSState, "frame": FrameState, "rx": ReceiverState,
           "fe": FrontendState}


def _fields(tree) -> dict:
    if hasattr(tree, "_asdict"):
        return tree._asdict()
    return dict(tree)


def _build(cls, tree, device):
    if tree is None:
        return None
    src = _fields(tree)
    missing = set(cls._fields) - set(src)
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {sorted(missing)}")
    out = {}
    for name in cls._fields:
        v = src[name]
        if v is None:
            out[name] = None
        elif name in _NESTED:
            out[name] = _build(_NESTED[name], v, device)
        else:
            out[name] = torch.as_tensor(np.array(v, copy=True)).to(device)
    return cls(**out)


def state_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays shaped like a ``ReceiverState``, a
    ``WidebandState`` or a ``ScanState`` -> the port's state of that kind
    on ``device`` (dtypes kept, data copied).  The kind is told by the
    tree's top-level field names."""
    names = set(_fields(tree))
    for cls in (WidebandState, ScanState, ReceiverState):
        if names == set(cls._fields):
            return _build(cls, tree, torch.device(device))
    raise ValueError(f"state_from_numpy: no state has fields {sorted(names)}")


def state_to_numpy(state):
    """The port's state tree -> the same NamedTuples holding numpy arrays."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return type(state)(*(state_to_numpy(v) for v in state))
