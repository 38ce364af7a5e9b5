"""Auxiliary subsystems: signal generators, state conversion."""

from rtsdr_tpu_torch.utils.signals import (  # noqa: F401
    generate_sin,
    mix_sin,
    random_samples,
)
