"""``python -m x3tpu_torch``: the command-line interface
(:mod:`x3tpu_torch.cli`)."""

from x3tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
