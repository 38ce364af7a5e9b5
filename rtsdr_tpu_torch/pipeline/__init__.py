"""Streaming pipeline: one block-step ``step(state, raw_u8) -> (state,
outputs)`` over the front end and the mono/stereo audio chains."""

from rtsdr_tpu_torch.pipeline.receiver import (  # noqa: F401
    Receiver,
    ReceiverOutputs,
    ReceiverState,
)
