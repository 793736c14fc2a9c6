"""The plain reference decoder that decides a run's `correct`.

A frozen copy of mbe_tpu_torch's plain PyTorch forms (ECC, demodulation,
parameter decode and FSM, synthesis), with the three stages that the
program runs in hand-written kernels as their closed forms
(ops/plain.py), eager, float32 with TF32 off, and the codec tables from
the frozen tables.npz beside this file. It imports nothing of the
program. `runner.Runner` drives it over a tick sequence.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
