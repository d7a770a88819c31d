"""lia_ral_tpu_torch — the PyTorch/CUDA port of lia_ral_tpu.

The JAX package ``lia_ral_tpu`` stays the reference; each module here
mirrors one module there and is tested against it on the same inputs.
The port imports torch and numpy only, never jax, flax or lia_ral_tpu.

Ported (every tool of the JAX package under ``tools``; among the
modules):

- ``gmm.model``        GmmDiag
- ``gmm.kernels``      EmStats, log-densities, posteriors, plain EM stats
- ``gmm.cuda_kernels`` the hand-written CUDA kernels K1 (EM stats) and K2
                       (per-utterance Baum-Welch stats), with their plain
                       PyTorch versions
- ``gmm.em``           UBM EM training
- ``gmm.map_adapt``    MAP / MLLR target adaptation
- ``gmm.scoring``      top-K GMM-UBM LLR scoring
- ``frontend``         CMVN, feature warping and mapping; energy VAD
- ``fa.stats``         Baum-Welch (N, F) stats
- ``fa.tv``            TotalVariability model, exact i-vector extraction
- ``backend.scoring``  cosine scoring; ``backend.eval`` EER / minDCF;
                       ``backend.norm`` z/t/zt/tz-norm
- ``backend.supervector``, ``backend.svm``
                       GMM supervectors and NAP; the C-SVC, its dual
                       solver a CUDA kernel of the port's own
- ``utils``            score, label, n-gram, expansion and token utilities
                       of the LIA_Utils tools
- ``convert``          JAX-package parameters (as numpy) <-> port state

Every function takes its device from its input tensors; the package never
picks one.  A CUDA tensor goes through the CUDA kernels (or the call
raises), a CPU tensor through the plain PyTorch versions.
"""

import torch as _torch

__version__ = "0.1.0"

# Numerics default: full-f32 matmuls, the counterpart of the JAX
# package's f32-grade matmul pin (lia_ral_tpu/__init__.py:54-58).  TF32
# keeps ~10 mantissa bits, which rounds GMM log-densities the way the
# TPU's single bf16 pass did and moves softmax occupancies by percents;
# parity with the reference's double-precision math needs f32.  Like the
# JAX pin this is process-global.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
