"""PyTorch/CUDA port of the MoDeST reproduction (the JAX package ``repro``
beside it is the reference this package is held against).

Same directory layout and public names as the reference, so the counterpart
of a module is found by path. The package imports ``torch``, ``numpy`` and
the standard library only.

Devices: every entry point takes ``device=None``, which means ``"cuda"``
and raises when no card is present. The CPU is used only when the caller
passes ``device="cpu"``. Nothing looks for a GPU and carries on without one.

Layouts are the reference's at every public function: NHWC images, HWIO
convolution weights, parameter leaves in sorted-key order, so an ``(N,)``
flat buffer means the same thing in both packages.

Numerics (stated once, set here): fp32 everywhere, with TF32 switched off
for both matrix products and cuDNN convolutions. cuDNN convolutions run
TF32 by default, which keeps about three decimal digits and would break
the fp32 tolerance tier the port is tested at.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from repro_torch.utils.device import resolve_device  # noqa: E402,F401
