"""DSP op library of the port.  Import the modules you need
(``from rtsdr_tpu_torch.ops import fir``).  The package itself exports only
the spectrum helpers ``dft`` and ``magnitude`` (``ops/fourier.py``, as
``rtsdr_tpu/ops/__init__.py`` does): that module imports ``torch`` alone,
so importing the package still never loads or builds a CUDA kernel."""

from rtsdr_tpu_torch.ops.fourier import dft, magnitude  # noqa: F401
