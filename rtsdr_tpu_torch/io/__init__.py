"""Host I/O: streaming runners, audio emit, wav artifacts."""

from rtsdr_tpu_torch.io.stream import StreamRunner  # noqa: F401
from rtsdr_tpu_torch.io.wav import write_wav  # noqa: F401
