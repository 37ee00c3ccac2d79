"""neural_sp_tpu_torch — the PyTorch / CUDA port of neural_sp_tpu.

Imports torch and never jax. Module paths and class names follow the JAX
package (``neural_sp_tpu``), which stays the reference the port is tested
against. It serves ``Speech2TextSession.decode`` on the flagship
Conformer-LAS model and trains it (``Speech2Text.forward``,
``parallel.mesh.make_train_step``), with hand-written CUDA kernels for the
H100 under ``ops/kernels``.

Framework-wide special token ids (as ``neural_sp_tpu/__init__.py``):
    blank = 0, unk = 1, eos = sos = 2, pad = 3
"""

BLANK = 0
UNK = 1
EOS = 2
SOS = 2
PAD = 3

__version__ = "0.1.0"
