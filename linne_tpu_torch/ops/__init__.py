"""Tensor ops of the batched analysis and synthesis paths.

Dtype policy: the float analysis runs in float64 on the CPU and on CUDA
alike. The TPU reference ran float32 on the chip only because its float64 is
emulated; the H100 has native IEEE float64, so one dtype serves both
devices and the card's bytes can be held to the CPU's.

TF32 stays off: the reference's matrix products run at full float32
precision (`Precision.HIGHEST`), and TF32 would change chosen coefficients
wherever a float32 product is taken.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ANALYSIS_DTYPE = torch.float64
