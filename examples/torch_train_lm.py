"""Train a reduced LM on the synthetic Markov corpus with the resilient
loop — the twin of ``examples/train_lm.py`` on ``repro_torch``.

The full training substrate of the port: config -> train step ->
fault-tolerant loop (async checkpoints, straggler detection,
auto-resume) -> the loss falling on a learnable synthetic language, and
the roofline of one step.  Interrupt it (Ctrl-C) and run it again: it
resumes from the last checkpoint.  It runs ``repro_torch.launch.train``
in-process, on the card unless ``--device cpu`` is given::

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu
"""
import pathlib
import sys

from repro_torch.launch import train

CKPT = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "torch_train_example"


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv) or ["--steps", "200"]
    train.main(["--arch", "qwen2-0.5b", "--reduced", "--batch", "8",
                "--seq", "128", "--ckpt-dir", str(CKPT)] + args)


if __name__ == "__main__":
    main()
