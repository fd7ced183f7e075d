"""Batched LM serving: prefill + KV-cache decode loop — the twin of
``examples/serve_lm_decode.py`` on ``repro_torch``.

Runs ``repro_torch.launch.serve`` in-process on a reduced config (batch
4, prompt 32, 16 generated tokens; ``--arch`` default qwen2-0.5b), on
the card unless ``--device cpu`` is given::

    PYTHONPATH=src python examples/torch_serve_lm_decode.py --arch hymba-1.5b
    PYTHONPATH=src python examples/torch_serve_lm_decode.py --device cpu
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in args:
        args = ["--arch", "qwen2-0.5b"] + args
    serve.main(["--reduced", "--batch", "4", "--prompt-len", "32",
                "--gen", "16"] + args)


if __name__ == "__main__":
    main()
