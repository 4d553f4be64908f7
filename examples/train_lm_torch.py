"""End-to-end LM training with the PyTorch port: the ~125M-parameter
``lm-100m``, a few hundred steps, with checkpointing + fault-tolerant
resume, on the card (``examples/train_lm.py`` drives the JAX reference the
same way).

Thin wrapper over the port's launcher, with the reference example's flags:

  PYTHONPATH=src python examples/train_lm_torch.py          # quick (25 steps)
  PYTHONPATH=src python examples/train_lm_torch.py --full   # few hundred steps
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # no card

Checkpoints go to ``build/lm100m_ckpt_torch`` in the checkout (a second run
resumes from them).
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--full", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
cmd = [sys.executable, "-m", "repro_torch.launch.train",
       "--arch", "lm-100m", "--steps", "300" if args.full else "25",
       "--batch", "8", "--seq", "256", "--n-micro", "2",
       "--ckpt-dir", os.path.join(root, "build", "lm100m_ckpt_torch"),
       "--save-every", "10", "--log-every", "5", "--device", args.device]
print("+", " ".join(cmd[1:]))
raise SystemExit(subprocess.call(cmd, env=env))
