"""Auxiliary subsystems: observability, signal generators, checkpointing,
profiling, state conversion."""

from rtsdr_tpu_torch.utils.checkpoint import load_state, save_state  # noqa: F401
from rtsdr_tpu_torch.utils.logging import log_vector  # noqa: F401
from rtsdr_tpu_torch.utils.signals import (  # noqa: F401
    generate_sin,
    mix_sin,
    random_samples,
)
