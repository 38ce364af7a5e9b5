"""DSP op library of the port.  Import the modules you need
(``from rtsdr_tpu_torch.ops import fir``); nothing is pulled in here, so
importing the package never loads or builds a CUDA kernel."""
