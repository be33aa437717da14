"""PyTorch/CUDA port of the p64tpu H.261 (p x 64) encoder.

The JAX package `p64tpu` is the reference: every module here mirrors the
module of the same name there and is tested against it bit for bit.  The
port imports `torch` and never `jax`; from `p64tpu` it imports only the
JAX-free modules (`spec`, `entropy.bitio`, `io.yuv`, `stats`,
`tools.golden_content`).

Exactness defaults, set once at import: the codec's arithmetic is integer,
and the few float products (the DCT's float64 matmuls) must not be rounded
by TF32 -- the Hopper analogue of the bf16 default-precision rounding that
once made the TPU motion search wrong.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
